"""PoseNet: backbone + deconv head + integral soft-argmax, counterpart of
``ihpr_tpu.models.pose_net``.

Public inputs are NHWC ``(B, H, W, 3)`` normalized images, as in the JAX
package; inside, tensors are NCHW in ``channels_last`` memory format (the
NHWC input permuted to NCHW already has those strides).
"""

from __future__ import annotations

import contextlib
import copy

import torch
from torch import nn

from ihpr_tpu_torch.config import Config
from ihpr_tpu_torch.models.head import Deconv, DeconvHead
from ihpr_tpu_torch.models.resnet import Conv, ResNetBackbone
from ihpr_tpu_torch.ops.fused_head_integral import no_tf32
from ihpr_tpu_torch.ops.integral import soft_argmax_3d

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@contextlib.contextmanager
def _precision_scope(matmul_precision):
    """``"highest"``: TF32 off (``no_tf32``) while the block runs, so one
    model's setting does not leak into the process. A training step runs
    its ``backward()`` inside the block too (``PoseNet.precision``), as
    JAX's ``precision="highest"`` covers the VJP."""
    if matmul_precision != "highest":
        yield
        return
    with no_tf32():
        yield


class PoseNet(nn.Module):
    def __init__(
        self,
        resnet_type: int = 50,
        joint_num: int = 18,
        depth_dim: int = 64,
        num_deconv_layers: int = 3,
        deconv_features: int = 256,
        compute_dtype: torch.dtype = torch.float32,
        fp32_logits: bool = True,
        bn_mode: str = "flax",
        matmul_precision=None,
        device=None,
        fused_1x1: bool = False,
        fused_conv3: bool = False,
    ):
        super().__init__()
        self.joint_num = joint_num
        self.depth_dim = depth_dim
        self.matmul_precision = matmul_precision
        self.backbone = ResNetBackbone(
            resnet_type, compute_dtype, bn_mode, device, fused_1x1, fused_conv3
        )
        self.head = DeconvHead(
            self.backbone.out_features,
            joint_num * depth_dim,
            num_deconv_layers,
            deconv_features,
            compute_dtype,
            bn_mode,
            fp32_logits,
            device,
        )

    def precision(self):
        """Context manager holding this model's matmul precision; wrap a
        forward and its ``backward()`` in it (forward calls also enter it
        themselves)."""
        return _precision_scope(self.matmul_precision)

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        return self.backbone(x.permute(0, 3, 1, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) image -> (B, H/4, W/4, J*D) heatmap logits."""
        with self.precision():
            return self.head(self._features(x))

    def coords(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) image -> (B, J, 3) voxel coords (x, y, z) through the
        fused final-conv + integral op: the logits volume is never written."""
        with self.precision():
            return self.head(
                self._features(x), "coords", self.joint_num, self.depth_dim
            )

    def coords_plain(self, x: torch.Tensor) -> torch.Tensor:
        """``coords`` via the heatmap logits and the plain soft-argmax."""
        hm = self(x)
        b, h, w, _ = hm.shape
        vol = hm.reshape(b, h, w, self.joint_num, self.depth_dim)
        return soft_argmax_3d(vol.permute(0, 3, 4, 1, 2))


def build_pose_net(
    cfg: Config,
    joint_num: int | None = None,
    device="cuda",
    generator: torch.Generator | None = None,
    trainable: bool = False,
) -> PoseNet:
    """PoseNet for ``cfg`` on ``device`` with fp32 parameters, initialized
    the way the JAX package initializes (``models.convert.init_state_dict``)
    from ``generator``, or from ``torch.Generator().manual_seed(cfg.seed)``.
    Frozen in eval mode, or in train mode with gradients when
    ``trainable``."""
    from ihpr_tpu_torch.models.convert import init_state_dict

    m = cfg.model
    for flag in ("s2d_stem", "block_remat"):
        if getattr(m, flag):
            raise ValueError(f"ModelConfig.{flag} is not ported to ihpr_tpu_torch")
    if m.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype {m.compute_dtype!r} not in {sorted(_DTYPES)}")
    with torch.device("meta"):
        model = PoseNet(
            resnet_type=m.resnet_type,
            joint_num=cfg.joint_num if joint_num is None else joint_num,
            depth_dim=cfg.data.depth_dim,
            num_deconv_layers=m.num_deconv_layers,
            deconv_features=m.deconv_channels,
            compute_dtype=_DTYPES[m.compute_dtype],
            fp32_logits=m.fp32_logits,
            bn_mode=m.bn_mode,
            matmul_precision=m.matmul_precision,
            fused_1x1=m.fused_1x1,
            fused_conv3=m.fused_conv3,
        )
    model = model.to_empty(device=device).train(trainable).requires_grad_(trainable)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            mod.weight.data = mod.weight.data.contiguous(memory_format=torch.channels_last)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    model.load_state_dict(init_state_dict(model, generator, m.head_final_init_std))
    return model


def inference_copy(model: PoseNet) -> PoseNet:
    """A frozen eval-mode copy of ``model`` whose conv, deconv and final-conv
    parameters are stored in the compute dtype, cast once here: each
    forward's per-call cast is then a no-op, so serving launches no cast
    kernels. ``model`` itself is left as it is."""
    frozen = copy.deepcopy(model).eval().requires_grad_(False)
    for mod in frozen.modules():
        if isinstance(mod, (Conv, Deconv)):
            mod.weight.data = mod.weight.data.to(mod.compute_dtype)
    final = frozen.head.final
    for p in (final.weight, final.bias):
        p.data = p.data.to(frozen.head.dtype)
    return frozen
