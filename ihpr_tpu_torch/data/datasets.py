"""Pose datasets and their evaluators, counterpart of
``ihpr_tpu.data.datasets``: the Human3.6M, MPII and MSCOCO annotation
loaders (the reference's file layouts), the synthetic dataset, and
``materialize_synthetic``, which writes synthetic frames as JPEGs so that a
synthetic set reads like a real one.

The synthetic samples are random but geometrically consistent, and their
images are rendered on demand (a Gaussian blob per joint, hue coding the
joint, radius coding its depth), so a model can learn to localize them.
The same seed gives the JAX package's samples and pixels exactly (numpy
``RandomState`` throughout).

Sample dict fields: ``img_path`` (None: synthetic), ``img_shape``,
``bbox`` (4,) original px, ``joint_img`` (J, 3) x, y original px and z
root-relative mm, ``joint_vis`` (J,), ``root_z``, ``f``, ``c``,
``action``; MPII adds ``head_box`` where the annotation has one, MSCOCO
``image_id`` and ``area``; synthetic samples carry ``area`` and the
rendering fields (``synth_seed``, hue fields).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import warnings
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np

from ihpr_tpu_torch.config import Config
from ihpr_tpu_torch.data import geometry, jpeg, skeletons
from ihpr_tpu_torch.data.coco import COCO, keypoint_ap


@dataclasses.dataclass
class PoseDataset:
    name: str
    skeleton: skeletons.Skeleton
    samples: List[dict]
    is_train: bool

    def __len__(self):
        return len(self.samples)

    @property
    def joint_num(self):
        return self.skeleton.joint_num


H36M_ACTIONS = (
    "Directions", "Discussion", "Eating", "Greeting", "Phoning", "Photo",
    "Posing", "Purchases", "Sitting", "SittingDown", "Smoking", "Waiting",
    "WalkDog", "Walking", "WalkTogether",
)

# Protocol splits (reference data/Human36M/Human36M.py): protocol 1
# (PA-MPJPE) trains on S1, 5, 6, 7, 8, 9 and tests on S11; protocol 2
# (MPJPE) trains on S1, 5, 6, 7, 8 and tests on S9 and S11.
H36M_TRAIN_SUBJECTS = {1: (1, 5, 6, 7, 8, 9), 2: (1, 5, 6, 7, 8)}
H36M_TEST_SUBJECTS = {1: (11,), 2: (9, 11)}


def load_h36m(root: str, split: str, protocol: int = 2, sampling: Optional[int] = None) -> List[dict]:
    """Samples of the protocol's ``split`` subjects from the preprocessed
    annotation release, every ``sampling``-th frame (default 5 for train,
    64 for test):
    ``{root}/annotations/Human36M_subject{N}_{data,camera,joint_3d}.json``.

    - data: COCO-style images (``file_name``, ``width``, ``height``,
      ``cam_idx``, ``frame_idx``, ``subaction_idx``, and ``action_name`` or
      ``action_idx``) and annotations (``bbox``);
    - camera: ``{cam_idx: {R, t, f, c}}``;
    - joint_3d: ``{action_idx: {subaction_idx: {frame_idx: (17, 3)}}}``
      world mm, or flat ``{image_id: (17, 3)}``.

    17 joints get the Thorax (mid-shoulders) as the 18th; z is made
    root-relative. Without ``action_name`` the action is
    ``H36M_ACTIONS[action_idx - 2]``, with one warning per call."""
    skel = skeletons.H36M
    subjects = H36M_TRAIN_SUBJECTS[protocol] if split == "train" else H36M_TEST_SUBJECTS[protocol]
    if sampling is None:
        sampling = 5 if split == "train" else 64
    warned = False
    samples: List[dict] = []
    for subj in subjects:
        prefix = os.path.join(root, "annotations", f"Human36M_subject{subj}_")
        if not os.path.exists(prefix + "data.json"):
            raise FileNotFoundError(
                f"H36M annotations not found at {prefix}data.json; point --data_root at "
                "the preprocessed annotation release or use the synthetic dataset"
            )
        with open(prefix + "data.json") as f:
            db = COCO(dataset=json.load(f))
        with open(prefix + "camera.json") as f:
            cameras = json.load(f)
        with open(prefix + "joint_3d.json") as f:
            joints_world = json.load(f)
        for i, img_id in enumerate(db.get_img_ids()):
            if i % sampling:
                continue
            img = db.imgs[img_id]
            cam = cameras[str(img["cam_idx"])]
            R, t, f_, c_ = (np.asarray(cam[k], np.float32) for k in ("R", "t", "f", "c"))
            try:
                jw = joints_world[str(img["action_idx"])][str(img["subaction_idx"])][str(img["frame_idx"])]
            except (KeyError, TypeError):
                jw = joints_world[str(img_id)]
            jc = geometry.world2cam(np.asarray(jw, np.float32), R, t)
            if jc.shape[0] == 17:
                thorax = (jc[11] + jc[14]) * 0.5  # mid-shoulders
                jc = np.concatenate([jc, thorax[None]], 0)
            jp = geometry.cam2pixel(jc, f_, c_)
            root_z = float(jc[skel.root_idx, 2])
            joint_img = jp.copy()
            joint_img[:, 2] = jc[:, 2] - root_z  # root-relative mm
            anns = db.load_anns(db.get_ann_ids([img_id]))
            bbox = np.asarray(anns[0]["bbox"], np.float32) if anns else _bbox_from_joints(jp)
            action = img.get("action_name")
            if action is None:
                if not warned:
                    warned = True
                    warnings.warn(
                        "H36M annotations lack action_name; deriving the action from action_idx-2 "
                        "- verify the per-action MPJPE table against the official toolkit.",
                        stacklevel=2,
                    )
                action = H36M_ACTIONS[int(img.get("action_idx", 2)) - 2]
            samples.append(dict(
                img_path=os.path.join(root, "images", img["file_name"]),
                img_shape=(img["height"], img["width"]),
                bbox=bbox,
                joint_img=joint_img.astype(np.float32),
                joint_vis=np.ones(skel.joint_num, np.float32),
                root_z=root_z,
                f=f_,
                c=c_,
                action=action,
            ))
    return samples


def evaluate_h36m(
    preds_mm: np.ndarray, samples: Sequence[dict], protocol: int = 2
) -> Dict[str, float]:
    """Per-action and total MPJPE (protocol 2) or PA-MPJPE (protocol 1).
    preds_mm: (N, J, 3) camera-space mm, not root-aligned: root alignment
    happens here (reference Human36M.evaluate)."""
    skel = skeletons.H36M
    ej = list(skel.eval_joints)
    per_action: Dict[str, List[float]] = {a: [] for a in H36M_ACTIONS}
    all_err: List[float] = []
    for pred, sample in zip(preds_mm, samples):
        gt = sample["joint_cam"] if "joint_cam" in sample else _sample_joint_cam(sample)
        pred_rel = pred - pred[skel.root_idx]
        gt_rel = gt - gt[skel.root_idx]
        p, g = pred_rel[ej], gt_rel[ej]
        if protocol == 1:
            p = geometry.rigid_align(p, g)
        err = float(np.sqrt(((p - g) ** 2).sum(-1)).mean())
        all_err.append(err)
        act = sample.get("action")
        if act in per_action:
            per_action[act].append(err)
    out = {f"MPJPE {a}": float(np.mean(v)) for a, v in per_action.items() if v}
    out["MPJPE total"] = float(np.mean(all_err))
    return out


def _sample_joint_cam(sample: dict) -> np.ndarray:
    ji = sample["joint_img"]
    px = ji.copy()
    px[:, 2] = ji[:, 2] + sample["root_z"]
    return geometry.pixel2cam(px, sample["f"], sample["c"])


def _keypoint_sample(root_images: str, img: dict, ann: dict, joint_num: int) -> dict:
    """The sample of one COCO-format keypoint annotation (2D: z = 0)."""
    kpts = np.asarray(ann["keypoints"], np.float32).reshape(-1, 3)
    joint_img = np.concatenate([kpts[:, :2], np.zeros((joint_num, 1))], 1)
    return dict(
        img_path=os.path.join(root_images, img["file_name"]),
        img_shape=(img["height"], img["width"]),
        bbox=np.asarray(ann["bbox"], np.float32),
        joint_img=joint_img.astype(np.float32),
        joint_vis=(kpts[:, 2] > 0).astype(np.float32),
        root_z=0.0,
        f=np.array([1.0, 1.0], np.float32),
        c=np.array([0.0, 0.0], np.float32),
        action="",
    )


def load_mpii(root: str, split: str) -> List[dict]:
    """COCO-format MPII annotations, ``{root}/annotations/{split}.json``
    (reference data/MPII/MPII.py); annotations with no visible joint are
    skipped, and ``head_box`` (x1, y1, x2, y2) is kept where present."""
    db = COCO(os.path.join(root, "annotations", f"{split}.json"))
    samples: List[dict] = []
    for ann_id in db.get_ann_ids():
        ann = db.anns[ann_id]
        sample = _keypoint_sample(os.path.join(root, "images"), db.imgs[ann["image_id"]], ann,
                                  skeletons.MPII.joint_num)
        if sample["joint_vis"].sum() == 0:
            continue
        if "head_box" in ann:
            sample["head_box"] = np.asarray(ann["head_box"], np.float32)
        samples.append(sample)
    return samples


def load_mscoco(root: str, split: str) -> List[dict]:
    """COCO person keypoints, ``{root}/annotations/person_keypoints_{split}.json``
    with images under ``{root}/images/{split}`` (reference
    data/MSCOCO/MSCOCO.py); crowd and zero-keypoint annotations are
    skipped."""
    db = COCO(os.path.join(root, "annotations", f"person_keypoints_{split}.json"))
    samples: List[dict] = []
    for ann_id in db.get_ann_ids():
        ann = db.anns[ann_id]
        if ann.get("iscrowd", 0) or ann.get("num_keypoints", 0) == 0:
            continue
        sample = _keypoint_sample(os.path.join(root, "images", split), db.imgs[ann["image_id"]], ann,
                                  skeletons.MSCOCO.joint_num)
        sample["image_id"] = ann["image_id"]
        sample["area"] = float(ann.get("area", ann["bbox"][2] * ann["bbox"][3]))
        samples.append(sample)
    return samples


# Standard MPII PCKh headbox scaling (the official eval's SC_BIAS): the
# normalizer is 0.6 * headbox diagonal, approximating head segment length.
MPII_SC_BIAS = 0.6


def evaluate_mpii_pckh(
    preds_px: np.ndarray, samples: Sequence[dict], thresh: float = 0.5
) -> Dict[str, float]:
    """PCKh@0.5 with the per-joint breakdown. The normalizer is the official
    ``SC_BIAS * headbox diagonal`` where a sample carries ``head_box``
    (x1, y1, x2, y2), else the Head-Neck segment length (an approximation
    of the official metric)."""
    skel = skeletons.MPII
    head_idx = skel.joints_name.index("Head")
    neck_idx = skel.joints_name.index("Neck")
    j = skel.joint_num
    correct = np.zeros(j)
    total = np.zeros(j)
    for pred, sample in zip(preds_px, samples):
        gt = sample["joint_img"][:, :2]
        vis = sample["joint_vis"] > 0
        if "head_box" in sample:
            x1, y1, x2, y2 = np.asarray(sample["head_box"], np.float64)
            head_size = MPII_SC_BIAS * float(np.hypot(x2 - x1, y2 - y1))
        else:
            head_size = np.linalg.norm(gt[head_idx] - gt[neck_idx])
        if head_size < 1e-3:
            continue
        d = np.linalg.norm(pred[:, :2] - gt, axis=-1)
        correct += ((d <= thresh * head_size) & vis).astype(np.float64)
        total += vis.astype(np.float64)
    out = {
        f"PCKh@0.5 {name}": float(correct[i] / total[i])
        for i, name in enumerate(skel.joints_name)
        if total[i] > 0
    }
    out["PCKh@0.5"] = float(correct.sum() / max(total.sum(), 1))
    return out


def evaluate_mscoco(preds_px: np.ndarray, samples: Sequence[dict]) -> Dict[str, float]:
    """OKS keypoint AP via the numpy COCOeval port."""
    gts, dts = [], []
    for i, (pred, sample) in enumerate(zip(preds_px, samples)):
        img_id = sample.get("image_id", i)
        gt_k = np.concatenate([sample["joint_img"][:, :2], sample["joint_vis"][:, None]], 1)
        gts.append(dict(image_id=img_id, keypoints=gt_k, area=sample["area"]))
        dt_k = np.concatenate([pred[:, :2], np.ones((pred.shape[0], 1))], 1)
        dts.append(dict(image_id=img_id, keypoints=dt_k, score=1.0))
    return keypoint_ap(gts, dts)


def _bbox_from_joints(jp: np.ndarray, margin: float = 1.2) -> np.ndarray:
    x0, y0 = jp[:, 0].min(), jp[:, 1].min()
    x1, y1 = jp[:, 0].max(), jp[:, 1].max()
    w, h = x1 - x0, y1 - y0
    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
    return np.array(
        [cx - w * margin / 2, cy - h * margin / 2, w * margin, h * margin], np.float32
    )


def _semantic_hue_coding(skeleton: skeletons.Skeleton):
    """Per-joint (hue_class, tilt, class count) for mirror-consistent
    rendering: both members of a flip pair share a hue class, and
    left/right is coded as the blob's tilt (+45 deg for the first member,
    -45 deg for the second, 0 for self-paired joints)."""
    j = skeleton.joint_num
    hue_class = np.full(j, -1, np.int32)
    tilt = np.zeros(j, np.float32)
    n_class = 0
    for a, b in skeleton.flip_pairs:
        hue_class[a] = hue_class[b] = n_class
        tilt[a], tilt[b] = np.pi / 4, -np.pi / 4
        n_class += 1
    for i in range(j):
        if hue_class[i] < 0:
            hue_class[i] = n_class
            n_class += 1
    return hue_class, tilt, n_class


def make_synthetic(
    skeleton: skeletons.Skeleton,
    n: int,
    seed: int = 0,
    img_size: int = 400,
    with_depth: Optional[bool] = None,
    easy_depth: bool = False,
    hue_mode: str = "index",
    hue_skeleton: Optional[skeletons.Skeleton] = None,
) -> List[dict]:
    """``n`` random samples of ``skeleton``; images are rendered on demand
    by ``render_synthetic_image``.

    ``hue_mode="semantic"`` renders mirror-consistently (shared pair hues,
    chirality as blob tilt); ``"index"`` gives each joint index its own hue.
    ``hue_skeleton`` gives each joint the hue its same-named joint has in
    that skeleton, so a mixed trainset codes joint identity alike across
    datasets; every joint name must exist there (else ValueError).
    ``easy_depth`` makes z a function of the image y coordinate."""
    rng = np.random.RandomState(seed)
    if with_depth is None:
        with_depth = skeleton.has_depth
    f = np.array([1100.0, 1100.0], np.float32)
    c = np.array([img_size / 2, img_size / 2], np.float32)
    name_map = None
    if hue_skeleton is not None and hue_skeleton is not skeleton:
        hs_index = {nm: i for i, nm in enumerate(hue_skeleton.joints_name)}
        missing = [nm for nm in skeleton.joints_name if nm not in hs_index]
        if missing:
            raise ValueError(f"hue_skeleton {hue_skeleton.name!r} lacks joints {missing}")
        name_map = np.array([hs_index[nm] for nm in skeleton.joints_name], np.int32)
    if hue_mode == "semantic":
        hue_class, tilt, n_hue = _semantic_hue_coding(hue_skeleton or skeleton)
        if name_map is not None:
            hue_class = hue_class[name_map]
            tilt = tilt[name_map]
    elif hue_mode != "index":
        raise ValueError(f"unknown hue_mode {hue_mode!r}")
    samples = []
    for i in range(n):
        j = skeleton.joint_num
        center = rng.uniform(img_size * 0.3, img_size * 0.7, 2)
        spread = rng.uniform(40, 80)
        xy = center + rng.randn(j, 2) * spread
        xy = np.clip(xy, 5, img_size - 5)
        if not with_depth:
            z = np.zeros((j, 1))
        elif easy_depth:
            z = ((xy[:, 1:2] / img_size) - 0.5) * 1100.0
        else:
            z = rng.uniform(-600, 600, (j, 1))
        joint_img = np.concatenate([xy, z], 1).astype(np.float32)
        bbox = _bbox_from_joints(joint_img)
        s = dict(
            img_path=None,
            synth_seed=seed * 100003 + i,
            img_shape=(img_size, img_size),
            bbox=bbox.astype(np.float32),
            joint_img=joint_img,
            joint_vis=np.ones(j, np.float32),
            root_z=4000.0,
            f=f,
            c=c,
            action=H36M_ACTIONS[i % len(H36M_ACTIONS)],
            area=float(bbox[2] * bbox[3]),
        )
        if hue_mode == "semantic":
            s["hue_mode"] = "semantic"
            s["hue_class"] = hue_class
            s["hue_classes_total"] = n_hue
            s["tilt"] = tilt
        elif name_map is not None:
            s["hue_idx"] = name_map
            s["hue_idx_total"] = hue_skeleton.joint_num
        samples.append(s)
    return samples


def render_synthetic_image(sample: dict, sigma: float = 4.0) -> np.ndarray:
    """(H, W, 3) uint8 with a Gaussian blob per joint, rendered in a +-4
    sigma window: hue codes the joint, the radius its depth (sigma 2.5 to
    6.5 px over z in [-600, 600] mm); overlapping blobs composite by max,
    so the locally stronger blob keeps its hue. Semantic-hue samples draw
    anisotropic blobs tilted by the joint's chirality, so that flipping the
    image renders the flipped pose exactly."""
    h, w = sample["img_shape"]
    img = np.zeros((h, w, 3), np.float32)
    wmax = np.zeros((h, w), np.float32)  # per-pixel winning blob weight
    joints = sample["joint_img"]
    n = len(joints)
    semantic = sample.get("hue_mode", "index") == "semantic"
    for j, (x, y, z) in enumerate(joints):
        sj = sigma * (0.625 + max(-1.0, min(1.0, z / 600.0)) * 0.5) + 0.5
        r = int(4 * sj * (1.5 if semantic else 1.0))
        xi, yi = int(round(x)), int(round(y))
        x0, x1 = max(0, xi - r), min(w, xi + r + 1)
        y0, y1 = max(0, yi - r), min(h, yi + r + 1)
        if x0 >= x1 or y0 >= y1:
            continue
        ys = np.arange(y0, y1, dtype=np.float32)[:, None]
        xs = np.arange(x0, x1, dtype=np.float32)[None, :]
        if semantic:
            th = float(sample["tilt"][j])
            ct, st = np.cos(th), np.sin(th)
            u = ct * (xs - x) + st * (ys - y)
            v = -st * (xs - x) + ct * (ys - y)
            blob = np.exp(-(u**2 / (2 * (1.45 * sj) ** 2) + v**2 / (2 * (0.6 * sj) ** 2)))
            ang = 2 * np.pi * sample["hue_class"][j] / max(sample["hue_classes_total"], 1)
        else:
            blob = np.exp(-((xs - x) ** 2 + (ys - y) ** 2) / (2 * sj**2))
            if "hue_idx" in sample:
                ang = 2 * np.pi * sample["hue_idx"][j] / max(sample["hue_idx_total"], 1)
            else:
                ang = 2 * np.pi * j / max(n, 1)
        rgb = 128 + 120 * np.array(
            [np.cos(ang), np.cos(ang - 2 * np.pi / 3), np.cos(ang + 2 * np.pi / 3)]
        )
        win = blob > wmax[y0:y1, x0:x1]
        np.copyto(img[y0:y1, x0:x1], blob[..., None] * rgb, where=win[..., None])
        np.maximum(wmax[y0:y1, x0:x1], blob, out=wmax[y0:y1, x0:x1])
    return np.clip(img, 0, 255).astype(np.uint8)


# Bump whenever render_synthetic_image's output changes for the same sample
# dict: it is part of materialize_synthetic's cache key, so a JPEG from an
# older renderer is never reused. The JAX package's value, since both
# packages render the same pixels and name a frame alike.
_RENDERER_VERSION = 2

_ENCODE_CHUNK = 32  # frames rendered and held at once by materialize_synthetic


def _synthetic_key(s: dict, quality: int) -> str:
    """The JAX package's cache key of a synthetic frame: a hash of what
    determines its pixels (joints, frame size, JPEG quality, renderer
    version, hue coding)."""
    hue_mode = s.get("hue_mode", "index")
    parts = [
        np.ascontiguousarray(s["joint_img"], np.float32).tobytes(),
        bytes(str((tuple(s["img_shape"]), quality, _RENDERER_VERSION, hue_mode)), "ascii"),
    ]
    if hue_mode == "semantic":
        parts += [np.asarray(s["hue_class"], np.int32).tobytes(), np.asarray(s["tilt"], np.float32).tobytes(),
                  str(s["hue_classes_total"]).encode("ascii")]
    if "hue_idx" in s:
        parts += [np.asarray(s["hue_idx"], np.int32).tobytes(), str(s["hue_idx_total"]).encode("ascii")]
    return hashlib.sha1(b"".join(parts)).hexdigest()[:12]


def materialize_synthetic(samples: Sequence[dict], out_dir: str, quality: int = 95,
                          device="cuda") -> List[dict]:
    """Write each synthetic sample's rendered frame to
    ``{out_dir}/synth_{synth_seed}_{key}.jpg`` (the JAX package's names and
    cache key) and return new sample dicts whose ``img_path`` points at it,
    so that the loader reads the set as it reads a real one. Files already
    there are reused. Frames are encoded on ``device`` (``jpeg.encode``:
    nvJPEG on a CUDA device, cv2 on the CPU), ``_ENCODE_CHUNK`` at a time."""
    os.makedirs(out_dir, exist_ok=True)
    paths = [os.path.join(out_dir, f"synth_{s['synth_seed']}_{_synthetic_key(s, quality)}.jpg") for s in samples]
    todo = [i for i, p in enumerate(paths) if not os.path.exists(p)]
    for lo in range(0, len(todo), _ENCODE_CHUNK):
        chunk = todo[lo : lo + _ENCODE_CHUNK]
        blobs = jpeg.encode([render_synthetic_image(samples[i]) for i in chunk], quality, device)
        for i, blob in zip(chunk, blobs):
            tmp = f"{paths[i]}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, paths[i])
    return [{**s, "img_path": p} for s, p in zip(samples, paths)]


_LOADERS = {"Human36M": load_h36m, "MPII": load_mpii, "MSCOCO": load_mscoco}


def build_dataset(
    name: str,
    split: str,
    cfg: Config,
    data_root: Optional[str] = None,
    synthetic_size: int = 256,
    hue_skeleton: Optional[skeletons.Skeleton] = None,
) -> PoseDataset:
    """The ``name`` dataset's ``split``, as the JAX package builds it.
    ``data_root`` is the root of every dataset name (default
    ``data/{name}``); a root that does not exist raises
    ``FileNotFoundError``. Human3.6M takes ``cfg.eval.protocol``'s
    subjects. ``data_root="synthetic"``: ``synthetic_size`` samples seeded
    by crc32 of ``name/split`` (stable across processes), rendered in
    ``hue_skeleton``'s hue space when the joint names allow it (else a
    warning and per-dataset hues)."""
    skel = skeletons.get_skeleton(name)
    root = data_root or os.path.join("data", name)
    if data_root == "synthetic":
        seed = zlib.crc32(f"{name}/{split}".encode()) % 2**31
        try:
            samples = make_synthetic(skel, synthetic_size, seed=seed, hue_skeleton=hue_skeleton)
        except ValueError as err:
            warnings.warn(
                f"synthetic {name}: hue_skeleton unification failed ({err}); falling back "
                "to per-dataset index hues (joint identity will be coded differently "
                "across the mixed trainset)"
            )
            samples = make_synthetic(skel, synthetic_size, seed=seed)
    elif not os.path.exists(root):
        raise FileNotFoundError(
            f"dataset root {root!r} does not exist; pass --data_root pointing at the {name} "
            "release, or --synthetic / data_root='synthetic' for blob data"
        )
    elif name == "Human36M":
        samples = load_h36m(root, split, cfg.eval.protocol)
    else:
        samples = _LOADERS[name](root, split)
    return PoseDataset(name=name, skeleton=skel, samples=samples, is_train=split == "train")
