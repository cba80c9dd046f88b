"""The COCO annotation index and COCO keypoint evaluation in numpy, the
port's copy of ``ihpr_tpu.data.coco``: ``COCO`` (the subset of
pycocotools' index the loaders use), object keypoint similarity and
COCOeval's keypoint AP."""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

# Per-keypoint OKS falloff constants (COCOeval kpt_oks_sigmas).
COCO_KPT_SIGMAS = np.array(
    [
        0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
        0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089,
    ],
    np.float32,
)


class COCO:
    """Read-only index of a COCO-format annotation file or dict, as
    pycocotools' ``COCO`` orders it: image ids sorted, annotation ids sorted,
    or in file order per image."""

    def __init__(self, annotation_file: Optional[str] = None, dataset: Optional[dict] = None):
        if annotation_file is not None:
            with open(annotation_file) as f:
                dataset = json.load(f)
        self.dataset = dataset or {}
        self.anns: Dict[int, dict] = {}
        self.imgs: Dict[int, dict] = {}
        self.cats: Dict[int, dict] = {}
        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.img_to_anns[ann["image_id"]].append(ann)
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat

    def get_img_ids(self) -> List[int]:
        return sorted(self.imgs)

    def get_ann_ids(self, img_ids: Optional[Iterable[int]] = None) -> List[int]:
        if img_ids is None:
            return sorted(self.anns)
        return [a["id"] for i in img_ids for a in self.img_to_anns.get(i, [])]

    def load_anns(self, ids: Iterable[int]) -> List[dict]:
        return [self.anns[i] for i in ids]

    def load_imgs(self, ids: Iterable[int]) -> List[dict]:
        return [self.imgs[i] for i in ids]


def compute_oks(
    gt_kpts: np.ndarray,
    dt_kpts: np.ndarray,
    area: float,
    sigmas: np.ndarray = COCO_KPT_SIGMAS,
) -> float:
    """Object keypoint similarity between one GT (K, 3 with v flag) and one
    detection (K, 2+). COCOeval.computeOks semantics."""
    vis = gt_kpts[:, 2] > 0
    if not vis.any():
        return 0.0
    d2 = ((gt_kpts[vis, :2] - dt_kpts[vis, :2]) ** 2).sum(-1)
    var = (2 * sigmas[vis]) ** 2
    e = d2 / var / (area + np.spacing(1)) / 2.0
    return float(np.exp(-e).mean())


def keypoint_ap(
    gts: Sequence[dict],
    dts: Sequence[dict],
    sigmas: np.ndarray = COCO_KPT_SIGMAS,
    oks_thresholds: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """COCO keypoint AP over OKS thresholds .50:.05:.95.

    gts: [{image_id, keypoints (K,3), area}], dts: [{image_id, keypoints
    (K,2+), score}]. Greedy matching per image by descending score, as
    COCOeval does (single category, no area ranges, maxDets=20), then the
    101-point interpolated precision."""
    if oks_thresholds is None:
        oks_thresholds = np.linspace(0.5, 0.95, 10)

    gt_by_img: Dict[int, List[dict]] = defaultdict(list)
    for g in gts:
        gt_by_img[g["image_id"]].append(g)
    dt_by_img: Dict[int, List[dict]] = defaultdict(list)
    for d in dts:
        dt_by_img[d["image_id"]].append(d)

    n_gt = len(gts)
    scores: List[float] = []
    matches: List[np.ndarray] = []  # per-dt bool per threshold
    for img_id, dt_list in dt_by_img.items():
        gt_list = gt_by_img.get(img_id, [])
        dt_list = sorted(dt_list, key=lambda d: -d["score"])[:20]
        ious = np.zeros((len(dt_list), len(gt_list)))
        for i, d in enumerate(dt_list):
            for j, g in enumerate(gt_list):
                ious[i, j] = compute_oks(
                    np.asarray(g["keypoints"], np.float32).reshape(-1, 3),
                    np.asarray(d["keypoints"], np.float32).reshape(-1, 3),
                    g["area"],
                    sigmas,
                )
        taken = np.zeros((len(oks_thresholds), len(gt_list)), bool)
        for i, d in enumerate(dt_list):
            m = np.zeros(len(oks_thresholds), bool)
            for ti, thr in enumerate(oks_thresholds):
                best, best_j = thr, -1
                for j in range(len(gt_list)):
                    if taken[ti, j]:
                        continue
                    if ious[i, j] >= best:
                        best, best_j = ious[i, j], j
                if best_j >= 0:
                    taken[ti, best_j] = True
                    m[ti] = True
            scores.append(d["score"])
            matches.append(m)

    if not scores or n_gt == 0:
        return {"AP": 0.0, "AP50": 0.0, "AP75": 0.0}

    order = np.argsort(-np.asarray(scores))
    match_arr = np.stack(matches)[order]  # (n_dt, n_thr)
    tp = np.cumsum(match_arr, axis=0)
    fp = np.cumsum(~match_arr, axis=0)
    recall = tp / n_gt
    precision = tp / np.maximum(tp + fp, np.spacing(1))

    # 101-point interpolated AP per threshold (COCOeval accumulate).
    rec_thrs = np.linspace(0, 1, 101)
    ap_per_thr = np.zeros(len(oks_thresholds))
    for ti in range(len(oks_thresholds)):
        p = precision[:, ti]
        r = recall[:, ti]
        for k in range(len(p) - 2, -1, -1):  # monotone precision envelope
            p[k] = max(p[k], p[k + 1])
        idx = np.searchsorted(r, rec_thrs, side="left")
        q = np.where(idx < len(p), p[np.minimum(idx, len(p) - 1)], 0.0)
        ap_per_thr[ti] = q.mean()

    return {
        "AP": float(ap_per_thr.mean()),
        "AP50": float(ap_per_thr[0]),
        "AP75": float(ap_per_thr[5]),
    }
