"""Real-data dress rehearsal, the port of the repository's
``tools/dress_rehearsal.py``: write a dataset tree in the upstream
annotation layout, validate it, and drive the port's CLIs on it.

``build_tree`` writes what the upstream preprocessed release carries
(reference ``data/Human36M/Human36M.py:load_data``, ``data/MPII/MPII.py``):
per-subject ``annotations/Human36M_subject{N}_{data,camera,joint_3d}.json``
with world-space joints and a camera of its own per subject (a small
rotation and translation, so ``world2cam`` is exercised), a COCO-style
MPII ``annotations/train.json``, and JPEG frames under ``images/`` whose
rendered blobs sit where the loader will put the joints: each pose is
drawn in pixels, inverted to world millimetres, and the frame rendered
from the loader's own world -> camera -> (+Thorax) -> pixel replay. The
poses, cameras, file names and seeds are JAX's, so the annotation files
are JAX's; the frames are written by ``jpeg.encode`` on ``--device``
(quality 95 as ``cv2.imwrite``; on the CPU cv2 encodes, bitwise JAX's
files). ``validate`` runs the port's ``tools/validate_data.py`` on the
tree (H36M train and test, MPII train) and raises unless each passes;
``--run`` then drives ``python -m ihpr_tpu_torch.train`` and ``python -m
ihpr_tpu_torch.test --vis`` on it:

    python -m ihpr_tpu_torch.tools.dress_rehearsal --root /tmp/dress_tree          # build + validate
    python -m ihpr_tpu_torch.tools.dress_rehearsal --root /tmp/dress_tree --run    # + the CLIs on the card
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

from ihpr_tpu_torch.data import geometry, jpeg, skeletons
from ihpr_tpu_torch.data.datasets import H36M_ACTIONS, H36M_TEST_SUBJECTS, H36M_TRAIN_SUBJECTS, render_synthetic_image
from ihpr_tpu_torch.tools.synthetic_root import QUALITY, _write_json


def _write_frame(root: str, file_name: str, joint_img: np.ndarray, img_size: int, device) -> None:
    frame = render_synthetic_image(dict(joint_img=joint_img.astype(np.float32), img_shape=(img_size, img_size)))
    out_path = os.path.join(root, "images", file_name)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "wb") as f:
        f.write(jpeg.encode([frame], QUALITY, device)[0])


def _h36m_subject(root: str, subj: int, n_frames: int, img_size: int, rng, device) -> int:
    """One subject's three upstream annotation files and its JPEG frames.

    The poses are drawn as ``make_synthetic`` draws them (blob centres in
    pixels, depth coded off the mirror-invariant y), then inverted to world
    space, so that the tree carries what the upstream release carries:
    17-joint world-mm poses and the camera (R, t, f, c). The frame is
    rendered from the loader's own world -> camera -> Thorax -> pixel
    replay, so its pixels match what ``load_h36m`` reconstructs."""
    skel = skeletons.H36M
    f = np.array([1100.0, 1100.0], np.float32)
    c = np.array([img_size / 2.0, img_size / 2.0], np.float32)
    th = 0.05 * subj
    R = np.array([[np.cos(th), -np.sin(th), 0.0], [np.sin(th), np.cos(th), 0.0], [0.0, 0.0, 1.0]], np.float64)
    t = np.array([10.0 * subj, -5.0 * subj, 0.0], np.float64)
    root_z = 4000.0

    images, annotations = [], []
    joint_3d: dict = {}
    for i in range(n_frames):
        action_idx = 2 + (i % len(H36M_ACTIONS))
        center = rng.uniform(img_size * 0.35, img_size * 0.65, 2)
        xy = np.clip(center + rng.randn(17, 2) * rng.uniform(35, 70), 8, img_size - 8)
        # The loader makes depth relative to the pelvis's own z, so a coded
        # span of +-s becomes up to 2s: 700 / 2 keeps every joint inside the
        # +-1000 mm bbox_3d_shape volume.
        z_rel = ((xy[:, 1:2] / img_size) - 0.5) * 700.0
        px = np.concatenate([xy, z_rel + root_z], 1)
        jc17 = geometry.pixel2cam(px, f, c)
        jw17 = (jc17 - t) @ np.linalg.inv(R).T

        jc = geometry.world2cam(jw17.astype(np.float32), R.astype(np.float32), t.astype(np.float32))
        thorax = (jc[11] + jc[14]) * 0.5
        jc18 = np.concatenate([jc, thorax[None]], 0)
        jp18 = geometry.cam2pixel(jc18, f, c)
        joint_img = jp18.copy()
        joint_img[:, 2] = jc18[:, 2] - float(jc18[skel.root_idx, 2])

        file_name = f"s_{subj:02d}_act_{action_idx:02d}_{i:06d}.jpg"
        img_id = subj * 1000000 + i
        _write_frame(root, file_name, joint_img, img_size, device)
        images.append(dict(id=img_id, file_name=file_name, width=img_size, height=img_size, cam_idx=1,
                           frame_idx=i, action_idx=action_idx, subaction_idx=1,
                           action_name=H36M_ACTIONS[action_idx - 2]))
        x0, y0 = jp18[:, 0].min(), jp18[:, 1].min()
        w, h = jp18[:, 0].max() - x0, jp18[:, 1].max() - y0
        annotations.append(dict(id=img_id, image_id=img_id, bbox=[float(x0 - 0.1 * w), float(y0 - 0.1 * h),
                                                                   float(1.2 * w), float(1.2 * h)]))
        joint_3d.setdefault(str(action_idx), {}).setdefault("1", {})[str(i)] = jw17.astype(np.float64).tolist()

    base = os.path.join(root, "annotations", f"Human36M_subject{subj}_")
    _write_json(base + "data.json", dict(images=images, annotations=annotations))
    _write_json(base + "camera.json", {"1": dict(R=R.tolist(), t=t.tolist(), f=f.tolist(), c=c.tolist())})
    _write_json(base + "joint_3d.json", joint_3d)
    return n_frames


def _mpii_tree(root: str, n: int, img_size: int, rng, device) -> int:
    """COCO-format MPII ``train.json`` and its rendered 16-joint frames."""
    skel = skeletons.MPII
    images, annotations = [], []
    for i in range(n):
        center = rng.uniform(img_size * 0.35, img_size * 0.65, 2)
        xy = np.clip(center + rng.randn(skel.joint_num, 2) * rng.uniform(35, 70), 8, img_size - 8)
        joint_img = np.concatenate([xy, np.zeros((skel.joint_num, 1))], 1)
        file_name = f"mpii_{i:09d}.jpg"
        _write_frame(root, file_name, joint_img, img_size, device)
        images.append(dict(id=i, file_name=file_name, width=img_size, height=img_size))
        kpts = np.concatenate([xy, np.ones((skel.joint_num, 1))], 1)
        x0, y0 = xy[:, 0].min(), xy[:, 1].min()
        w, h = xy[:, 0].max() - x0, xy[:, 1].max() - y0
        annotations.append(dict(id=i, image_id=i, bbox=[float(x0 - 0.1 * w), float(y0 - 0.1 * h),
                                                         float(1.2 * w), float(1.2 * h)],
                                keypoints=kpts.ravel().tolist()))
    _write_json(os.path.join(root, "annotations", "train.json"), dict(images=images, annotations=annotations))
    return n


def build_tree(root: str, frames_train: int, frames_test: int, img_size: int, device="cuda") -> None:
    """The protocol-2 subjects' trees (``frames_train`` frames a train
    subject, ``frames_test`` a test subject) and ``max(frames_train // 2,
    64)`` MPII frames, from JAX's seed 7; frames encoded on ``device``."""
    rng = np.random.RandomState(7)
    total = 0
    for subj in H36M_TRAIN_SUBJECTS[2]:
        total += _h36m_subject(root, subj, frames_train, img_size, rng, device)
    for subj in H36M_TEST_SUBJECTS[2]:
        total += _h36m_subject(root, subj, frames_test, img_size, rng, device)
    total += _mpii_tree(root, max(frames_train // 2, 64), img_size, rng, device)
    print(f"dress_rehearsal: wrote {total} frames under {root}", flush=True)


def validate(root: str) -> None:
    """The port's validator on the tree: H36M train and test (protocol 2)
    and MPII train, 8 image files probed each. Raises AssertionError naming
    the first that fails."""
    from ihpr_tpu_torch.tools.validate_data import validate_h36m, validate_mpii

    for split in ("train", "test"):
        if validate_h36m(root, split, protocol=2, check_images=8).dump():
            raise AssertionError(f"validate_data FAILED for Human36M {split}")
    if validate_mpii(root, "train", check_images=8).dump():
        raise AssertionError("validate_data FAILED for MPII train")
    print("dress_rehearsal: validate_data OK (H36M train/test + MPII)", flush=True)


def run_clis(root: str, out_dir: str, steps: int, device="cuda") -> None:
    """``python -m ihpr_tpu_torch.train --config h36m3d_r50`` for ``steps``
    steps of one epoch, then ``python -m ihpr_tpu_torch.test --vis``, on the
    tree, each a child process that must exit 0."""
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    common = ["--config", "h36m3d_r50", "--data_root", root, "--num_workers", "8", "--output_dir", out_dir,
              "--device", device]
    for cmd in ([sys.executable, "-m", "ihpr_tpu_torch.train", *common, "--steps", str(steps), "--end_epoch", "1"],
                [sys.executable, "-m", "ihpr_tpu_torch.test", *common, "--vis"]):
        print("dress_rehearsal: RUN", " ".join(cmd), flush=True)
        subprocess.run(cmd, check=True, env=env, timeout=3600)
    print("dress_rehearsal: CLI train+test PASS on the materialized tree", flush=True)


def main(argv=None):
    from ihpr_tpu_torch.utils.shutdown import install_graceful_shutdown

    install_graceful_shutdown()
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default="/tmp/dress_tree")
    # 130 a train subject -> 26 loaded each (sampling 5) = 130 train samples
    # >= the flagship global batch 128 -> at least 1 step an epoch.
    ap.add_argument("--frames_train", type=int, default=130)
    # 128 a test subject -> 2 loaded each (sampling 64).
    ap.add_argument("--frames_test", type=int, default=128)
    ap.add_argument("--img_size", type=int, default=400)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--run", action="store_true", help="drive the port's train and test CLIs on the tree")
    ap.add_argument("--output_dir", default="/tmp/dress_out")
    ap.add_argument("--device", default="cuda", help="where the frames are encoded and the CLIs run")
    args = ap.parse_args(argv)

    if not os.path.exists(os.path.join(args.root, "annotations")):
        build_tree(args.root, args.frames_train, args.frames_test, args.img_size, args.device)
    else:
        print(f"dress_rehearsal: reusing existing tree at {args.root}", flush=True)
    validate(args.root)
    if args.run:
        run_clis(args.root, args.output_dir, args.steps, args.device)


if __name__ == "__main__":
    main()
