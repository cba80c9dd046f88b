"""Ops: the integral soft-argmax (plain, and over a logits volume through
K3/K4), the fused head kernels (K1/K2), the fused conv + BN-statistics
kernels (K5-K8: ``matmul_bn``, ``conv_bn``) and the loss; the counterpart
of ``ihpr_tpu.ops``."""

from ihpr_tpu_torch.ops.integral import soft_argmax_1d, soft_argmax_2d, soft_argmax_3d
from ihpr_tpu_torch.ops.integral_volume import soft_argmax_3d_fused
from ihpr_tpu_torch.ops.loss import joint_location_loss

__all__ = ["soft_argmax_1d", "soft_argmax_2d", "soft_argmax_3d", "soft_argmax_3d_fused", "joint_location_loss"]
