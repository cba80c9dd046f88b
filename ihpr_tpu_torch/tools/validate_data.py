"""Preflight validator for a dataset root, the port of the repository's
``tools/validate_data.py`` on the port's loaders.

Checks an on-disk annotation tree against the schema the loaders expect
(the upstream layouts, reference ``data/Human36M|MPII|MSCOCO/*.py``)
before a long training run, with the reference tool's messages: which file
is missing, which key is malformed, whether image files resolve. The
checks, messages and ``stats`` are JAX's; the loaders run are the port's
(``data/datasets.py``: ``load_h36m``, ``load_mpii``, ``load_mscoco``). It
reads files only: no device is touched.

    python -m ihpr_tpu_torch.tools.validate_data --dataset Human36M --data_root /data/h36m \
        [--split test] [--protocol 2] [--check_images 16]

Exit code 0 = the tree is loadable (warnings allowed); 1 = errors.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ihpr_tpu_torch.data.datasets import (
    H36M_TEST_SUBJECTS,
    H36M_TRAIN_SUBJECTS,
    load_h36m,
    load_mpii,
    load_mscoco,
)


class Report:
    def __init__(self):
        self.errors: list = []
        self.warnings: list = []
        self.stats: dict = {}

    def error(self, msg: str):
        self.errors.append(msg)

    def warn(self, msg: str):
        self.warnings.append(msg)

    def dump(self) -> int:
        for w in self.warnings:
            print(f"WARN  {w}")
        for e in self.errors:
            print(f"ERROR {e}")
        for k, v in self.stats.items():
            print(f"stat  {k} = {v}")
        print("validate_data:", "FAIL" if self.errors else "OK")
        return 1 if self.errors else 0


def _load_json(path: str, rep: Report):
    if not os.path.exists(path):
        rep.error(f"missing annotation file: {path}")
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except Exception as e:  # malformed json
        rep.error(f"unparseable json {path}: {e}")
        return None


def _arr(val, where: str, rep: Report):
    """np.asarray that reports ragged/non-numeric content as a diagnostic
    instead of crashing the validator with a raw numpy traceback."""
    try:
        return np.asarray(val, np.float64)
    except (ValueError, TypeError) as e:
        rep.error(f"{where}: not a rectangular numeric array ({e})")
        return None


def _check_images(samples, n: int, rep: Report):
    """Probe n image paths SPREAD across the sample list (not the first n:
    H36M samples are subject-ordered, so a prefix probe would pass a tree
    whose entire last subject is missing)."""
    if not n or not samples:
        return
    idx = np.unique(np.linspace(0, len(samples) - 1, min(n, len(samples))).astype(int))
    missing = [
        samples[i]["img_path"] for i in idx
        if not os.path.exists(samples[i]["img_path"])
    ]
    rep.stats["images_checked"] = len(idx)
    if missing:
        rep.error(
            f"{len(missing)}/{len(idx)} sampled image files missing "
            f"(first: {missing[0]}) — expected under <data_root>/images/"
        )


def validate_h36m(root: str, split: str, protocol: int, check_images: int) -> Report:
    rep = Report()
    subjects = (
        H36M_TRAIN_SUBJECTS[protocol] if split == "train" else H36M_TEST_SUBJECTS[protocol]
    )
    rep.stats["subjects"] = list(subjects)
    for subj in subjects:
        base = os.path.join(root, "annotations", f"Human36M_subject{subj}_")
        data = _load_json(base + "data.json", rep)
        cams = _load_json(base + "camera.json", rep)
        j3d = _load_json(base + "joint_3d.json", rep)
        if data is None or cams is None or j3d is None:
            continue
        for key in ("images", "annotations"):
            if key not in data:
                rep.error(f"{base}data.json: missing top-level '{key}' list")
        imgs = data.get("images", [])
        if not imgs:
            rep.error(f"{base}data.json: empty images list")
            continue
        img = imgs[0]
        for key in ("id", "file_name", "width", "height", "cam_idx", "frame_idx"):
            if key not in img:
                rep.error(f"{base}data.json images[0]: missing '{key}'")
        if "action_name" not in img and "action_idx" not in img:
            rep.error(f"{base}data.json images[0]: needs action_name or action_idx")
        elif "action_name" not in img:
            rep.warn(
                f"subject {subj}: no action_name — per-action MPJPE falls back to "
                "action_idx-2 indexing (verify against the official toolkit)"
            )
        cam = cams.get(str(img.get("cam_idx")))
        if cam is None:
            rep.error(
                f"{base}camera.json: no entry for cam_idx={img.get('cam_idx')} "
                f"(keys: {sorted(cams)[:6]})"
            )
        else:
            for key, shape in (("R", (3, 3)), ("t", (3,)), ("f", (2,)), ("c", (2,))):
                arr = _arr(
                    cam.get(key, []),
                    f"{base}camera.json cam {img.get('cam_idx')} '{key}'",
                    rep,
                )
                if arr is not None and arr.shape != shape:
                    rep.error(
                        f"{base}camera.json cam {img.get('cam_idx')}: '{key}' shape "
                        f"{arr.shape} != {shape}"
                    )
        # joint_3d: nested {action}{subaction}{frame} or flat {image_id}
        try:
            jw = j3d[str(img["action_idx"])][str(img["subaction_idx"])][
                str(img["frame_idx"])
            ]
        except (KeyError, TypeError):
            jw = j3d.get(str(img.get("id")))
        if jw is None:
            rep.error(
                f"{base}joint_3d.json: no world joints for images[0] via "
                "[action_idx][subaction_idx][frame_idx] nesting OR flat [image_id]"
            )
        else:
            arr = _arr(jw, f"{base}joint_3d.json images[0] joints", rep)
            if arr is not None and arr.shape not in ((17, 3), (18, 3)):
                rep.error(
                    f"{base}joint_3d.json: joints shape {arr.shape}, expected "
                    "(17, 3) (Thorax is synthesized) or (18, 3)"
                )
        if not data.get("annotations"):
            rep.warn(f"subject {subj}: no bbox annotations — falling back to "
                     "joint-extent bboxes")
    if rep.errors:
        return rep
    samples = load_h36m(root, split, protocol=protocol)
    rep.stats["samples"] = len(samples)
    if not samples:
        rep.error("loader returned 0 samples (subsampling too aggressive?)")
        return rep
    depth = np.asarray([s["root_z"] for s in samples], np.float64)
    if not ((depth > 500) & (depth < 20000)).all():
        rep.warn(
            f"root depths outside [0.5m, 20m] (min {depth.min():.0f}mm, max "
            f"{depth.max():.0f}mm) — check camera t units are millimeters"
        )
    _check_images(samples, check_images, rep)
    return rep


def _validate_coco_format(
    path: str, joint_num: int, check_images: int, rep: Report, loader, *args
):
    """Shared COCO-format checks. Returns the parsed json (or None) so the
    dataset-specific wrappers can inspect it WITHOUT re-parsing a
    possibly-hundreds-of-MB annotation file."""
    data = _load_json(path, rep)
    if data is None:
        return None
    for key in ("images", "annotations"):
        if key not in data:
            rep.error(f"{path}: missing top-level '{key}' list")
    anns = data.get("annotations", [])
    if anns:
        ann = anns[0]
        kp = _arr(ann.get("keypoints", []), f"{path} annotations[0] keypoints", rep)
        if kp is not None and kp.size != joint_num * 3:
            rep.error(
                f"{path} annotations[0]: keypoints length {kp.size} != "
                f"{joint_num}*3 (x, y, vis triplets)"
            )
        if "bbox" not in ann:
            rep.error(f"{path} annotations[0]: missing 'bbox'")
    else:
        rep.error(f"{path}: empty annotations list")
    if rep.errors:
        return data
    samples = loader(*args)
    rep.stats["samples"] = len(samples)
    if not samples:
        rep.error("loader returned 0 samples (all invisible/crowd-filtered?)")
        return data
    _check_images(samples, check_images, rep)
    return data


def validate_mpii(root: str, split: str, check_images: int) -> Report:
    rep = Report()
    path = os.path.join(root, "annotations", f"{split}.json")
    data = _validate_coco_format(path, 16, check_images, rep, load_mpii, root, split)
    if data and not rep.errors:
        anns = data.get("annotations", [])
        if anns and "head_box" not in anns[0]:
            rep.warn(
                "annotations carry no head_box: PCKh will use the Head-Neck "
                "segment approximation instead of the official SC_BIAS "
                "headbox normalizer (data/datasets.py:evaluate_mpii_pckh)"
            )
    return rep


def validate_mscoco(root: str, split: str, check_images: int) -> Report:
    rep = Report()
    path = os.path.join(root, "annotations", f"person_keypoints_{split}.json")
    data = _validate_coco_format(path, 17, check_images, rep, load_mscoco, root, split)
    if data:
        n_crowd = sum(int(a.get("iscrowd", 0)) for a in data.get("annotations", []))
        rep.stats["crowd_filtered"] = n_crowd
    return rep


def main(argv=None):
    from ihpr_tpu_torch.utils.shutdown import install_graceful_shutdown

    install_graceful_shutdown()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", required=True, choices=["Human36M", "MPII", "MSCOCO"])
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--split", default=None, help="default: train (H36M/MPII), "
                    "train2017 (MSCOCO)")
    ap.add_argument("--protocol", type=int, default=2, choices=[1, 2],
                    help="H36M protocol")
    ap.add_argument("--check_images", type=int, default=16,
                    help="probe this many image files spread across the "
                    "sample list for existence (0 = skip)")
    args = ap.parse_args(argv)

    if args.dataset == "Human36M":
        rep = validate_h36m(
            args.data_root, args.split or "train", args.protocol, args.check_images
        )
    elif args.dataset == "MPII":
        rep = validate_mpii(args.data_root, args.split or "train", args.check_images)
    else:
        rep = validate_mscoco(
            args.data_root, args.split or "train2017", args.check_images
        )
    sys.exit(rep.dump())


if __name__ == "__main__":
    main()
