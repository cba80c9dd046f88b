"""Kernel-name classes the metric readers share: data, matched with ``re.search``.

CONV: cuDNN's convolutions and their helpers; GEMM: cuBLAS; HAND: the
program's own CUDA kernels (``ihpr_tpu_torch/ops/csrc``), which live in an
anonymous or an ``fhi`` / ``hopper`` namespace at the top level, where
PyTorch's own kernels sit under ``at::``."""

CONV = (r"conv", r"cudnn", r"implicit_gemm", r"xmma", r"dgrad", r"wgrad", r"fprop", r"winograd", r"cutlass",
        r"sm90_", r"nchwToNhwc", r"nhwcToNchw")
GEMM = (r"gemm", r"nvjet", r"cublas", r"Kernel2")
HAND = (r"^(void )?\(anonymous namespace\)::", r"^(void )?(fhi|hopper)::", r"^(void )?reduce_rows\b",
        r"^(void )?(stats|merge|dv|prep|split_planes|split_w|g|color)_kernel\b")
# The fused head's kernels (ops/csrc/fused_head_integral_{fwd,bwd}.cu).
K1 = r"fused_head_integral_fwd_kernel"
K2 = r"dfeat_kernel"
K2_AFTER = (r"dw_kernel", r"^(void )?\(anonymous namespace\)::reduce_kernel\(")
TRANSPOSE = r"transpose_kernel"
