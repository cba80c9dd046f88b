"""Write a dataset root in the reference's file layouts from synthetic
samples, and a seeded backbone in torchvision's layout, so that the
real-data path (the annotation loaders, JPEG decode, ``--data_root``,
``--pretrained``) runs where no dataset and no ImageNet weights are at hand
(``chip_smoke.py``'s real-data phase, ``tests/test_torch_datasets.py``).

``write_h36m_root`` and ``write_mpii_root`` write under a root:

- ``annotations/Human36M_subject{S}_{data,camera,joint_3d}.json`` for the
  protocol-2 subjects (train S1, 5, 6, 7, 8; test S9, 11), the samples
  dealt over them in turn. ``load_h36m`` keeps every 5th frame of a train
  subject and every 64th of a test subject, so each sample is listed as
  that many consecutive frames, all of one file and one pose: the loader
  yields exactly the samples asked for, and every listed file exists;
- ``annotations/train.json``: MPII in COCO format, 1280x720 frames;
- ``images/``: every frame's rendering (``datasets.render_synthetic_image``)
  as a q95 JPEG written by ``datasets.materialize_synthetic`` on ``device``
  (nvJPEG on a CUDA device, cv2 on the CPU).

The cameras are the identity at the origin with the synthetic samples'
intrinsics, so the loaded joints are the rendered ones (depth made
root-relative by the loader). Frames are ``make_synthetic`` samples of
fixed seeds. ``write_torchvision_resnet`` writes a ResNet ``state_dict``
under torchvision's names, drawn from a seed, for ``--pretrained``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
import torch

from ihpr_tpu_torch.data import geometry, skeletons
from ihpr_tpu_torch.data.datasets import (
    H36M_TEST_SUBJECTS,
    H36M_TRAIN_SUBJECTS,
    make_synthetic,
    materialize_synthetic,
)
from ihpr_tpu_torch.models.resnet import ResNetBackbone

H36M_SAMPLING = {"train": 5, "test": 64}  # load_h36m's defaults
MPII_SHAPE = (720, 1280)  # (height, width)
QUALITY = 95  # JPEG quality of the frames


def _write_json(path: str, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def _h36m_subject(samples: List[dict], sampling: int, subj: int, f, c) -> Dict[str, dict]:
    """The three annotation files of one subject: each sample as
    ``sampling`` consecutive frames of its file and pose, under action 0,
    subaction 1 (the frames carry ``action_name``)."""
    images, annotations, joints = [], [], {}
    for k, s in enumerate(samples):
        px = s["joint_img"].astype(np.float64)
        px[:, 2] += s["root_z"]
        cam = geometry.pixel2cam(px, s["f"], s["c"]).tolist()
        h, w = s["img_shape"]
        for frame in range(k * sampling, (k + 1) * sampling):
            img_id = subj * 1_000_000 + frame
            images.append(dict(id=img_id, file_name=os.path.basename(s["img_path"]), width=w, height=h, cam_idx=1,
                               frame_idx=frame, action_idx=0, subaction_idx=1, action_name=s["action"]))
            annotations.append(dict(id=img_id, image_id=img_id, bbox=[float(v) for v in s["bbox"]]))
            joints[str(frame)] = cam
    camera = {"1": dict(R=np.eye(3).tolist(), t=[0.0, 0.0, 0.0], f=[float(v) for v in f], c=[float(v) for v in c])}
    return {"data": dict(images=images, annotations=annotations), "camera": camera,
            "joint_3d": {"0": {"1": joints}}}


def write_h36m_root(root: str, n_train: int, n_test: int, size: int = 1000, device="cuda") -> Dict[str, List[dict]]:
    """Human3.6M annotations and JPEGs of ``n_train`` + ``n_test`` samples
    at ``size`` x ``size``; returns each split's synthetic samples, their
    ``img_path`` pointing at their JPEGs."""
    out = {}
    for split, n, subjects in (("train", n_train, H36M_TRAIN_SUBJECTS[2]), ("test", n_test, H36M_TEST_SUBJECTS[2])):
        samples = make_synthetic(skeletons.H36M, n, seed=int(split == "test"), img_size=size)
        samples = materialize_synthetic(samples, os.path.join(root, "images"), QUALITY, device)
        f, c = np.array([1100.0, 1100.0]), np.array([size / 2, size / 2])  # make_synthetic's intrinsics
        for i, subj in enumerate(subjects):
            files = _h36m_subject(samples[i :: len(subjects)], H36M_SAMPLING[split], subj, f, c)
            for kind, obj in files.items():
                _write_json(os.path.join(root, "annotations", f"Human36M_subject{subj}_{kind}.json"), obj)
        out[split] = samples
    return out


def write_mpii_root(root: str, n: int, device="cuda") -> List[dict]:
    """MPII train annotations (COCO format) and JPEGs of ``n`` 1280x720
    frames, the people centred; returns the synthetic samples."""
    h, w = MPII_SHAPE
    samples = make_synthetic(skeletons.MPII, n, seed=2, img_size=h)
    shift = np.array([(w - h) / 2, 0.0, 0.0], np.float32)
    for s in samples:
        s["joint_img"] = s["joint_img"] + shift
        s["bbox"] = s["bbox"] + np.concatenate([shift[:2], [0.0, 0.0]]).astype(np.float32)
        s["img_shape"] = (h, w)
    samples = materialize_synthetic(samples, os.path.join(root, "images"), QUALITY, device)
    images, annotations = [], []
    for i, s in enumerate(samples):
        images.append(dict(id=i, file_name=os.path.basename(s["img_path"]), width=w, height=h))
        kpts = np.concatenate([s["joint_img"][:, :2], np.ones((len(s["joint_img"]), 1))], 1)
        annotations.append(dict(id=i, image_id=i, bbox=[float(v) for v in s["bbox"]],
                                keypoints=kpts.ravel().tolist(), num_keypoints=len(kpts)))
    _write_json(os.path.join(root, "annotations", "train.json"), dict(images=images, annotations=annotations))
    return samples


def write_torchvision_resnet(path: str, resnet_type: int, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Save (and return) a torchvision ResNet ``state_dict`` drawn from
    ``seed``: He-scaled convs, BN parameters and statistics near the
    identity, ``num_batches_tracked``, and a 1000-way ``fc``."""
    rng = np.random.RandomState(seed)
    backbone = ResNetBackbone(resnet_type, torch.float32, "lean", device="meta")
    sd = {}
    for name, t in backbone.state_dict().items():
        key = name.replace(".down_conv.", ".downsample.0.").replace(".down_bn.", ".downsample.1.")
        key = key.replace("_", ".", 1) if key.startswith("layer") else key
        shape = tuple(t.shape)
        if len(shape) == 4:
            v = rng.standard_normal(shape) * np.sqrt(1.0 / np.prod(shape[1:]))
        elif name.endswith(("running_var", "weight")):
            v = rng.uniform(0.8, 1.2, shape)
        else:
            v = rng.uniform(-0.1, 0.1, shape)
        sd[key] = torch.from_numpy(v.astype(np.float32))
        if name.endswith("running_var"):
            sd[key.replace("running_var", "num_batches_tracked")] = torch.tensor(0)
    sd["fc.weight"] = torch.from_numpy((rng.standard_normal((1000, backbone.out_features)) * 0.01).astype(np.float32))
    sd["fc.bias"] = torch.zeros(1000)
    torch.save(sd, path)
    return sd

