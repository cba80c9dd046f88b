"""Immutable experiment configuration (the port's copy of ``ihpr_tpu.config``).

The dataclasses, their field names and values, and the named ``CONFIGS``
are the JAX package's, so a config name means the same model in both
packages. The copy exists because importing ``ihpr_tpu`` pulls in JAX;
the port imports neither.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ImageNet normalization (torchvision ToTensor + Normalize).
IMAGENET_MEAN: Tuple[float, float, float] = (0.485, 0.456, 0.406)
IMAGENET_STD: Tuple[float, float, float] = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Backbone + head."""

    resnet_type: int = 50  # one of 18, 34, 50, 101, 152
    # Deconv stages in the head, each ConvTranspose(256, k4, s2) + BN + ReLU.
    num_deconv_layers: int = 3
    deconv_channels: int = 256
    head_final_init_std: float = 0.001
    # Compute dtype for convs and matmuls; BN statistics stay fp32.
    compute_dtype: str = "float32"  # "float32" | "bfloat16"
    # None | "default" | "highest". "highest" makes fp32 mean fp32: the port
    # turns TF32 off for convs and matmuls for the duration of a forward.
    matmul_precision: Optional[str] = None
    # Emit the plain heatmap logits in fp32 (False keeps compute_dtype).
    fp32_logits: bool = True
    # The stem as space-to-depth 2 + a 4x4 stride-1 conv on 12 channels,
    # exact for an embedded 7x7/2 stem (models/resnet.py:S2DStem).
    s2d_stem: bool = False
    bn_momentum: float = 0.9
    bn_epsilon: float = 1e-5
    # "flax": (x - mean) * (scale * rsqrt(var + eps)) + bias in fp32, cast
    # to compute_dtype. "lean": the same normalize folded in fp32 into one
    # per-channel (mul, add) pair, applied as x * mul + add in compute_dtype.
    # Measurement modes, lean's apply with other statistics: "lean16"
    # (in compute_dtype), "lean_subN" (every N-th image row), "lean_sg" /
    # "lean_sgv" (mean and var / var detached), "frozen" (running
    # statistics in train mode too) (models/resnet.py:BN).
    bn_mode: str = "flax"
    # Recompute each residual block's forward in the backward (training):
    # "full" keeps block inputs only, "conv_outs" also every conv output.
    block_remat: bool = False
    remat_policy: str = "full"
    # Train-mode lean-BN Bottlenecks on JAX's fused routes: conv1/conv3 with
    # the BN statistics in the matmul (ops/matmul_bn.py, K5/K6); conv2 with
    # the bn1 apply and bn2 statistics (ops/conv_bn.py, K7/K8).
    fused_1x1: bool = False
    fused_conv3: bool = False


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input pipeline + augmentation."""

    trainset: Tuple[str, ...] = ("Human36M", "MPII")
    testset: str = "Human36M"
    # (height, width) of the network input patch.
    input_shape: Tuple[int, int] = (256, 256)
    # (height, width) of the heatmap: input / 4.
    output_shape: Tuple[int, int] = (64, 64)
    depth_dim: int = 64
    # Metric volume (z, y, x) in mm mapped onto the voxel grid.
    bbox_3d_shape: Tuple[int, int, int] = (2000, 2000, 2000)
    pixel_mean: Tuple[float, float, float] = IMAGENET_MEAN
    pixel_std: Tuple[float, float, float] = IMAGENET_STD
    scale_factor: float = 0.25
    rot_factor: float = 30.0
    rot_prob: float = 0.6
    color_factor: float = 0.2
    flip_prob: float = 0.5
    bbox_margin: float = 1.25
    use_aug: bool = True


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Optimizer + schedule (Adam with step decay)."""

    lr: float = 1e-3
    lr_dec_epoch: Tuple[int, ...] = (17, 21)
    lr_dec_factor: float = 10.0
    end_epoch: int = 25
    batch_size_per_device: int = 32
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = None
    snapshot_interval: int = 1
    snapshot_keep: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device layout. ``spatial_axis_size`` S splits each sample's image rows
    over S ranks (a D x S grid, ``parallel/mesh.py``); ``data_axis_size``
    (None: the world size over S) is checked against the process group;
    ``shard_opt_state`` is ZeRO-1."""

    data_axis_size: Optional[int] = None
    data_axis_name: str = "data"
    spatial_axis_size: int = 1
    spatial_axis_name: str = "spatial"
    shard_opt_state: bool = False
    donate: bool = True


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    flip_test: bool = True
    protocol: int = 2  # H36M protocol: 1 = PA-MPJPE (S11), 2 = MPJPE (S9, S11)
    batch_size_per_device: int = 128
    dump_artifacts: bool = True


@dataclasses.dataclass(frozen=True)
class Config:
    name: str = "h36m3d_r50"
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    seed: int = 0
    output_dir: str = "output"

    @property
    def joint_num(self) -> int:
        """Joints of the primary (first) train set."""
        from ihpr_tpu_torch.data import skeletons

        return skeletons.get_skeleton(self.data.trainset[0]).joint_num

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _cfg(**kw) -> Config:
    return Config(**kw)


CONFIGS = {
    # ResNet-50 + 64^3 soft-argmax, single-image fp32 forward (parity).
    "parity_r50": _cfg(
        name="parity_r50",
        model=ModelConfig(matmul_precision="highest"),
        data=DataConfig(trainset=("Human36M",), use_aug=False),
        optim=OptimConfig(batch_size_per_device=1),
    ),
    # MPII 2D pose: ResNet-50 + 64x64 integral (depth_dim=1).
    "mpii2d_r50": _cfg(
        name="mpii2d_r50",
        data=DataConfig(trainset=("MPII",), testset="MPII", depth_dim=1),
    ),
    # COCO 2D keypoints: the 2D-integral family on the 17-joint skeleton.
    "coco2d_r50": _cfg(
        name="coco2d_r50",
        data=DataConfig(trainset=("MSCOCO",), testset="MSCOCO", depth_dim=1),
    ),
    # Human3.6M 3D flagship: ResNet-50 + 64^3 volumetric integral, bf16
    # convs with fp32 master params, lean BN, bf16 logits into the fused op.
    "h36m3d_r50": _cfg(
        name="h36m3d_r50",
        model=ModelConfig(
            compute_dtype="bfloat16", fp32_logits=False, bn_mode="lean"
        ),
        optim=OptimConfig(batch_size_per_device=128),
    ),
    # The flagship in full fp32 ("highest": no TF32 anywhere).
    "h36m3d_r50_fp32": _cfg(
        name="h36m3d_r50_fp32", model=ModelConfig(matmul_precision="highest")
    ),
    # ResNet-152 @ 288x384 input, bf16.
    "h36m3d_r152_384": _cfg(
        name="h36m3d_r152_384",
        model=ModelConfig(
            resnet_type=152, compute_dtype="bfloat16", bn_mode="lean"
        ),
        data=DataConfig(
            input_shape=(384, 288),
            output_shape=(96, 72),
            depth_dim=64,
        ),
    ),
    # Multi-device data-parallel variant of the flagship.
    "h36m3d_r50_dp": _cfg(
        name="h36m3d_r50_dp",
        model=ModelConfig(compute_dtype="bfloat16", bn_mode="lean"),
        parallel=ParallelConfig(data_axis_size=None),
    ),
}


def get_config(name: str) -> Config:
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; available: {sorted(CONFIGS)}")
    return CONFIGS[name]
