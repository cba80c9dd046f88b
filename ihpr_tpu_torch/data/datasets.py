"""Synthetic pose datasets and the datasets' evaluators, counterpart of the
synthetic part and the ``evaluate_*`` functions of
``ihpr_tpu.data.datasets``.

The repository holds no real dataset, so the port carries only the
synthetic one: random but geometrically consistent samples whose images
are rendered on demand (a Gaussian blob per joint, hue coding the joint,
radius coding its depth), so a model can learn to localize them. The same
seed gives the JAX package's samples and pixels exactly (numpy
``RandomState`` throughout).

Sample dict fields: ``img_path`` (None: synthetic), ``bbox`` (4,) original
px, ``joint_img`` (J, 3) x, y original px and z root-relative mm,
``joint_vis`` (J,), ``root_z``, ``f``, ``c``, ``action``, ``area``, and the
rendering fields (``synth_seed``, ``img_shape``, hue fields).
"""

from __future__ import annotations

import dataclasses
import warnings
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np

from ihpr_tpu_torch.config import Config
from ihpr_tpu_torch.data import geometry, skeletons
from ihpr_tpu_torch.data.coco import keypoint_ap


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


def build_dataset(
    name: str,
    split: str,
    cfg: Config,
    data_root: Optional[str] = None,
    synthetic_size: int = 256,
    hue_skeleton: Optional[skeletons.Skeleton] = None,
) -> PoseDataset:
    """The ``name`` dataset's ``split``. Only ``data_root="synthetic"`` is
    ported: ``synthetic_size`` samples seeded by crc32 of ``name/split``
    (the JAX package's seed, stable across processes), rendered in
    ``hue_skeleton``'s hue space when the joint names allow it (else a
    warning and per-dataset hues). Any other root raises: there is no real
    dataset loader in the port."""
    skel = skeletons.get_skeleton(name)
    if data_root != "synthetic":
        raise ValueError(
            f"data_root {data_root!r}: ihpr_tpu_torch has no real-dataset loader; "
            "use data_root='synthetic' (--synthetic)"
        )
    del cfg  # real loaders read cfg.eval.protocol; the synthetic one needs nothing
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
    return PoseDataset(name=name, skeleton=skel, samples=samples, is_train=split == "train")
