"""PoseNet: backbone + deconv head + integral soft-argmax, counterpart of
``ihpr_tpu.models.pose_net``.

Public inputs are NHWC ``(B, H, W, 3)`` normalized images, as in the JAX
package; inside, tensors are NCHW in ``channels_last`` memory format (the
NHWC input permuted to NCHW already has those strides).

A model built on a grid of spatial > 1 (``dp``, ``parallel/mesh.py``)
takes this rank's rows of each image (``mesh.row_shard``) and its
``coords`` are ``coords_spatial``: the whole image's coords on every rank.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Mapping

import torch
from torch import nn

from ihpr_tpu_torch.config import Config
from ihpr_tpu_torch.models.head import Deconv, DeconvHead
from ihpr_tpu_torch.models.resnet import Conv, ResNetBackbone
from ihpr_tpu_torch.ops.fused_head_integral import no_tf32
from ihpr_tpu_torch.ops.integral import soft_argmax_3d
from ihpr_tpu_torch.ops.integral_volume import soft_argmax_row_shards
from ihpr_tpu_torch.parallel.mesh import DataParallel

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
        dp: DataParallel | None = None,
        s2d_stem: bool = False,
        block_remat: bool = False,
        remat_policy: str = "full",
    ):
        super().__init__()
        self.joint_num = joint_num
        self.depth_dim = depth_dim
        self.matmul_precision = matmul_precision
        self.rows = dp.row_axis if dp is not None else None
        self.backbone = ResNetBackbone(
            resnet_type, compute_dtype, bn_mode, device, fused_1x1, fused_conv3, dp, s2d_stem, block_remat,
            remat_policy,
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
            dp,
            self.backbone.rows_out,
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
        fused final-conv + integral op: the logits volume is never written.
        On a spatial grid, ``coords_spatial``."""
        if self.rows is not None:
            return self.coords_spatial(x)
        with self.precision():
            return self.head(
                self._features(x), "coords", self.joint_num, self.depth_dim
            )

    def coords_spatial(self, x: torch.Tensor) -> torch.Tensor:
        """This spatial rank's (B, h, W, 3) rows of the images
        (``mesh.row_shard``: h may differ between ranks, or be 0) -> the whole
        images' (B, J, 3) voxel coords, the same on every rank of the row
        group: the head's logits of the rank's rows, then K3/K4 over them
        with the ranks' statistics merged (``soft_argmax_row_shards``). The
        counterpart of JAX's ``coords_plain`` under a ``(data, spatial)``
        mesh. K1/K2 do not run: the fused op sees only one rank's rows."""
        with self.precision():
            hm = self(x)
        return soft_argmax_row_shards(hm, self.joint_num, self.depth_dim, self.rows, self.head.rows_out)

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
    dp: DataParallel | None = None,
    state_dict: Mapping[str, torch.Tensor] | None = None,
) -> PoseNet:
    """PoseNet for ``cfg`` on ``device`` with fp32 parameters. Its weights,
    in the first of these that the caller gives:

    - ``state_dict``, loaded as it is (no draw);
    - ``generator``: the JAX package's scheme drawn by torch
      (``models.convert.init_state_dict``), not JAX's values;
    - otherwise JAX's own initial values (``jax_random.jax_init_params``)
      from ``split(key(cfg.seed))[1]``, the key JAX's ``Trainer``
      initializes from, so one seed gives one model in both packages (the
      port's ``Trainer`` builds its model so).

    Frozen in eval mode, or in train mode with gradients when
    ``trainable``. ``dp`` (``parallel.mesh.DataParallel``, as JAX's
    ``mesh=``): with world > 1, train-mode BN takes global-batch
    statistics; with spatial > 1 the model runs on this rank's rows."""
    from ihpr_tpu_torch.models import jax_random
    from ihpr_tpu_torch.models.convert import from_jax_params, init_state_dict

    m = cfg.model
    if m.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype {m.compute_dtype!r} not in {sorted(_DTYPES)}")
    joint_num = cfg.joint_num if joint_num is None else joint_num
    with torch.device("meta"):
        model = PoseNet(
            resnet_type=m.resnet_type,
            joint_num=joint_num,
            depth_dim=cfg.data.depth_dim,
            num_deconv_layers=m.num_deconv_layers,
            deconv_features=m.deconv_channels,
            compute_dtype=_DTYPES[m.compute_dtype],
            fp32_logits=m.fp32_logits,
            bn_mode=m.bn_mode,
            matmul_precision=m.matmul_precision,
            fused_1x1=m.fused_1x1,
            fused_conv3=m.fused_conv3,
            dp=dp,
            s2d_stem=m.s2d_stem,
            block_remat=m.block_remat,
            remat_policy=m.remat_policy,
        )
    model = model.to_empty(device=device).train(trainable).requires_grad_(trainable)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            mod.weight.data = mod.weight.data.contiguous(memory_format=torch.channels_last)
    if state_dict is None and generator is not None:
        state_dict = init_state_dict(model, generator, m.head_final_init_std)
    elif state_dict is None:
        params, stats = jax_random.jax_init_params(cfg, joint_num, jax_random.trainer_init_key(cfg.seed))
        state_dict = from_jax_params(params, stats, cfg)
    model.load_state_dict(state_dict)
    return model


def on_grid(model: PoseNet, cfg: Config, dp, device) -> PoseNet:
    """``model``, or where ``dp`` splits rows and ``model`` was built for
    another grid, a model of ``cfg`` built on ``dp`` holding ``model``'s
    state (the Tester's and the server's spatial copies)."""
    if dp is None or dp.row_axis == model.rows:
        return model
    return build_pose_net(cfg, model.joint_num, device=device, dp=dp, state_dict=model.state_dict())


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
