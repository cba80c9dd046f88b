"""Operations and bytes counted from a configuration's shapes, for the
``mfu.*`` and ``*_roofline`` metrics.

``forward_flops``: 2 x the multiply-adds of every convolution (the stem, each
Bottleneck's three and its projection), each 4x4 stride-2 deconvolution and
the final 1x1 conv, for one image. BatchNorm, ReLU, adds, the pooling and the
soft-argmax are not counted. A train step counts 3 x the forward (the
backward's two products per layer), with no recomputation.

The fused head's counts are of the work the mathematics needs, whatever
kernel does it:

- ``head_forward``: the logits product (B, HW, C) x (C, J*D); reads the
  features, the weight and bias once, writes the coords;
- ``head_backward``: the dfeat and dW products, db's sums; reads the
  features, the weight, bias and the coords' cotangent once, writes dfeat,
  dW and db. The logits the backward needs are not counted again.
"""

from __future__ import annotations

from typing import Dict, Tuple

from benchmark.reference.pose_net import blocks


def _out(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


def forward_macs(sizes: Dict) -> int:
    """Multiply-adds of one image's forward."""
    h, w = sizes["input_shape"]
    h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    macs = h * w * 3 * 64 * 49
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    for _, cin, width, stride, down in blocks(sizes["resnet_type"]):
        ho, wo = _out(h, 3, stride, 1), _out(w, 3, stride, 1)
        out = 4 * width
        macs += h * w * cin * width + ho * wo * width * width * 9 + ho * wo * width * out
        if down:
            macs += ho * wo * cin * out
        h, w, cin = ho, wo, out
    feats = sizes["deconv_channels"]
    for _ in range(sizes["num_deconv_layers"]):
        macs += h * w * cin * feats * 16
        h, w, cin = 2 * h, 2 * w, feats
    return macs + h * w * cin * sizes["joint_num"] * sizes["depth_dim"]


def forward_flops(sizes: Dict) -> float:
    return 2.0 * forward_macs(sizes)


def train_flops(sizes: Dict) -> float:
    return 3.0 * forward_flops(sizes)


def _head(sizes: Dict, batch: int) -> Tuple[int, int, int, int]:
    h, w = sizes["output_shape"]
    return batch, h * w, sizes["deconv_channels"], sizes["joint_num"] * sizes["depth_dim"]


def head_forward(sizes: Dict, batch: int, itemsize: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of the fused head's forward for ``batch`` images."""
    b, hw, c, jd = _head(sizes, batch)
    ops = 2.0 * b * hw * c * jd
    nbytes = itemsize * (b * hw * c + c * jd + jd) + 4 * b * sizes["joint_num"] * 3
    return ops, float(nbytes)


def head_backward(sizes: Dict, batch: int, itemsize: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of the fused head's backward for ``batch`` images."""
    b, hw, c, jd = _head(sizes, batch)
    ops = 4.0 * b * hw * c * jd + b * hw * jd
    nbytes = itemsize * (2 * b * hw * c + 2 * c * jd + 2 * jd) + 4 * b * sizes["joint_num"] * 3
    return ops, float(nbytes)


def bound_s(ops: float, nbytes: float, peak: Dict) -> float:
    """The least time: the larger of operations over the tensor cores' rate
    and bytes over the memory's."""
    return max(ops / peak["bf16_flops_per_s"], nbytes / peak["hbm_bytes_per_s"])
