"""Regenerate tests/data/real_root: a tiny dataset root in the reference's
file layouts, with JPEG frames, for the real-data path's tests.

    python tests/make_real_fixture.py

Writes, from seed 0:

- ``annotations/Human36M_subject{9,11}_{data,camera,joint_3d}.json``: two
  320x240 frames per protocol-2 test subject, the joints 2.5 m from the
  camera; ``annotations/train.json``: two MPII frames (COCO format, one
  with a ``head_box``);
- ``images/*.jpg``: each frame's synthetic rendering (a blob per joint,
  ``render_synthetic_image`` of the JAX package's loaded sample) over a
  smooth background, written by ``cv2.imwrite`` at quality 95 (4:2:0, as
  ``materialize_synthetic`` writes);
- ``pixels.npz``: each JPEG decoded by libjpeg (``cv2.imread``, RGB), by
  file name;
- ``patches.npz``: the JAX package's loader batch of the six frames
  (h36m3d_r50, no augmentation, the host warp: the native library's fused
  libjpeg decode + warp): ``patch``, ``joint_img``, ``joint_vis``,
  ``sample_idx``.

The tests and ``chip_smoke.py`` (its real-data phase) hold the port's
loaders, decoders and loader batches against these files.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "real_root")
H, W = 240, 320


def _write_json(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def _bbox(xy, margin=1.2):
    (x0, y0), (x1, y1) = xy.min(0), xy.max(0)
    w, h = (x1 - x0) * margin, (y1 - y0) * margin
    return [float((x0 + x1 - w) / 2), float((y0 + y1 - h) / 2), float(w), float(h)]


def write_annotations(rng):
    for subj in (9, 11):
        images, annotations, joints_3d = [], [], {}
        cam = {"1": dict(R=np.eye(3).tolist(), t=[0.0, 0.0, 0.0], f=[310.0, 305.0], c=[160.0, 120.0])}
        for i in range(2):
            img_id = subj * 100 + i
            jw = rng.uniform(-450, 450, (17, 3)) + np.array([0.0, 0.0, 2500.0])
            xy = jw[:, :2] / jw[:, 2:] * np.array([310.0, 305.0]) + np.array([160.0, 120.0])
            images.append(dict(id=img_id, file_name=f"h36m_s{subj}_{i}.jpg", width=W, height=H, cam_idx=1,
                               frame_idx=i, subaction_idx=1, action_idx=2 + i + subj % 3))
            annotations.append(dict(id=img_id, image_id=img_id, bbox=_bbox(xy)))
            joints_3d.setdefault(str(2 + i + subj % 3), {}).setdefault("1", {})[str(i)] = jw.tolist()
        prefix = f"{ROOT}/annotations/Human36M_subject{subj}_"
        _write_json(prefix + "data.json", dict(images=images, annotations=annotations))
        _write_json(prefix + "camera.json", cam)
        _write_json(prefix + "joint_3d.json", joints_3d)
    images, annotations = [], []
    for i in range(2):
        images.append(dict(id=i, file_name=f"mpii_{i}.jpg", width=W, height=H))
        kpts = np.ones((16, 3))
        kpts[:, 0] = rng.uniform(90, 230, 16)
        kpts[:, 1] = rng.uniform(40, 200, 16)
        ann = dict(id=10 + i, image_id=i, bbox=_bbox(kpts[:, :2]), keypoints=kpts.ravel().tolist())
        if i == 0:
            ann["head_box"] = [150.0, 40.0, 180.0, 75.0]
        annotations.append(ann)
    _write_json(f"{ROOT}/annotations/train.json", dict(images=images, annotations=annotations))


def main():
    import cv2

    from ihpr_tpu.config import get_config
    from ihpr_tpu.data import skeletons
    from ihpr_tpu.data.datasets import PoseDataset, load_h36m, load_mpii, render_synthetic_image
    from ihpr_tpu.data.pipeline import BatchLoader

    shutil.rmtree(ROOT, ignore_errors=True)
    rng = np.random.RandomState(0)
    write_annotations(rng)
    h36m = load_h36m(ROOT, "test", protocol=2, sampling=1)
    mpii = load_mpii(ROOT, "train")
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    pixels = {}
    os.makedirs(f"{ROOT}/images", exist_ok=True)
    for k, s in enumerate(h36m + mpii):
        background = np.stack([xx / W * 90 + 20, yy / H * 70 + 30 + 10 * k, (xx + yy) / (W + H) * 60], -1)
        img = np.maximum(render_synthetic_image(s), background.astype(np.uint8))
        assert cv2.imwrite(s["img_path"], np.ascontiguousarray(img[:, :, ::-1]), [cv2.IMWRITE_JPEG_QUALITY, 95])
        pixels[os.path.basename(s["img_path"])] = cv2.imread(s["img_path"], cv2.IMREAD_COLOR)[:, :, ::-1]
    np.savez_compressed(f"{ROOT}/pixels.npz", **pixels)

    cfg = get_config("h36m3d_r50")
    sets = [PoseDataset("Human36M", skeletons.H36M, h36m, True), PoseDataset("MPII", skeletons.MPII, mpii, True)]
    loader = BatchLoader(sets, cfg, 6, train=False, num_workers=0, host_warp=True)
    hb = next(loader.epoch(0))
    np.savez_compressed(f"{ROOT}/patches.npz", patch=hb.patch, joint_img=hb.joint_img, joint_vis=hb.joint_vis,
                        sample_idx=hb.sample_idx)
    total = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(ROOT) for f in fs)
    print(f"wrote {ROOT}: {total} bytes")


if __name__ == "__main__":
    main()
