"""Joint-set definitions for H36M / MPII / COCO (the port's copy of
``ihpr_tpu.data.skeletons``: same names, joint orders and flip pairs, and
the name-based remap between joint sets)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Skeleton:
    name: str
    joints_name: Tuple[str, ...]
    flip_pairs: Tuple[Tuple[int, int], ...]
    skeleton: Tuple[Tuple[int, int], ...]  # bone edges, for vis
    root_idx: int
    # Joints used for the headline error metric.
    eval_joints: Tuple[int, ...]
    has_depth: bool  # whether this dataset supervises z

    @property
    def joint_num(self) -> int:
        return len(self.joints_name)

    def flip_permutation(self) -> np.ndarray:
        """Permutation p with p[i] = index of the joint that takes i's place
        after a horizontal flip (an involution)."""
        perm = np.arange(self.joint_num)
        for a, b in self.flip_pairs:
            perm[a], perm[b] = perm[b], perm[a]
        return perm


# 18-joint H36M set: 17 canonical + Thorax.
H36M = Skeleton(
    name="Human36M",
    joints_name=(
        "Pelvis", "R_Hip", "R_Knee", "R_Ankle", "L_Hip", "L_Knee", "L_Ankle",
        "Torso", "Neck", "Nose", "Head", "L_Shoulder", "L_Elbow", "L_Wrist",
        "R_Shoulder", "R_Elbow", "R_Wrist", "Thorax",
    ),
    flip_pairs=((1, 4), (2, 5), (3, 6), (14, 11), (15, 12), (16, 13)),
    skeleton=(
        (0, 7), (7, 8), (8, 9), (9, 10), (8, 11), (11, 12), (12, 13),
        (8, 14), (14, 15), (15, 16), (0, 1), (1, 2), (2, 3), (0, 4),
        (4, 5), (5, 6),
    ),
    root_idx=0,
    eval_joints=tuple(range(17)),
    has_depth=True,
)

MPII = Skeleton(
    name="MPII",
    joints_name=(
        "R_Ankle", "R_Knee", "R_Hip", "L_Hip", "L_Knee", "L_Ankle", "Pelvis",
        "Thorax", "Neck", "Head", "R_Wrist", "R_Elbow", "R_Shoulder",
        "L_Shoulder", "L_Elbow", "L_Wrist",
    ),
    flip_pairs=((0, 5), (1, 4), (2, 3), (10, 15), (11, 14), (12, 13)),
    skeleton=(
        (0, 1), (1, 2), (2, 6), (6, 3), (3, 4), (4, 5), (6, 7), (7, 8),
        (8, 9), (7, 12), (12, 11), (11, 10), (7, 13), (13, 14), (14, 15),
    ),
    root_idx=6,
    eval_joints=tuple(range(16)),
    has_depth=False,
)

MSCOCO = Skeleton(
    name="MSCOCO",
    joints_name=(
        "Nose", "L_Eye", "R_Eye", "L_Ear", "R_Ear", "L_Shoulder",
        "R_Shoulder", "L_Elbow", "R_Elbow", "L_Wrist", "R_Wrist", "L_Hip",
        "R_Hip", "L_Knee", "R_Knee", "L_Ankle", "R_Ankle",
    ),
    flip_pairs=(
        (1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16),
    ),
    skeleton=(
        (0, 1), (0, 2), (1, 3), (2, 4), (5, 6), (5, 7), (7, 9), (6, 8),
        (8, 10), (11, 12), (5, 11), (6, 12), (11, 13), (13, 15), (12, 14),
        (14, 16),
    ),
    root_idx=11,  # L_Hip (2D dataset; root unused for depth)
    eval_joints=tuple(range(17)),
    has_depth=False,
)

_REGISTRY: Dict[str, Skeleton] = {s.name: s for s in (H36M, MPII, MSCOCO)}


def get_skeleton(name: str) -> Skeleton:
    if name not in _REGISTRY:
        raise KeyError(f"unknown dataset {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def transform_joint_to_other_db(
    src_joint: np.ndarray, src: Skeleton, dst: Skeleton
) -> np.ndarray:
    """Remap joints (..., J_src, C) from src order into dst order by name;
    joints missing in src are zero (reference
    ``common/utils/pose_utils.py:transform_joint_to_other_db``)."""
    out_shape = src_joint.shape[:-2] + (dst.joint_num, src_joint.shape[-1])
    out = np.zeros(out_shape, dtype=src_joint.dtype)
    src_index = {n: i for i, n in enumerate(src.joints_name)}
    for j, name in enumerate(dst.joints_name):
        if name in src_index:
            out[..., j, :] = src_joint[..., src_index[name], :]
    return out
