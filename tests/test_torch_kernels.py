"""The CUDA kernels against their plain versions, on a CUDA device.

Every test here is marked ``cuda`` and skips on a host without a card.
The file imports torch and the port only (no JAX), so it also runs on the
GPU host, where tests/conftest.py (which imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from ihpr_tpu_torch.config import DataConfig, ModelConfig, get_config
from ihpr_tpu_torch.models.pose_net import build_pose_net
from ihpr_tpu_torch.ops import fused_head_integral as fhi


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _head_inputs(shape, device, dtype, seed=4):
    b, h, w, c, j, d = shape
    g = torch.Generator().manual_seed(seed)
    feat = torch.randn(b, h * w, c, generator=g) * 0.5
    kernel = torch.randn(c, j * d, generator=g) * (10.0 / c**0.5)  # logits std ~5
    bias = torch.randn(j * d, generator=g) * 0.1
    return tuple(t.to(device, dtype) for t in (feat, kernel, bias))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize(
    "shape",
    [(2, 16, 16, 128, 4, 32), (2, 16, 16, 128, 18, 16), (3, 9, 7, 64, 17, 64), (2, 8, 8, 256, 16, 1)],
    ids=["aligned", "j18d16", "ragged", "d1"],
)
def test_kernel_matches_plain(cuda, shape, dtype):
    """Both sides accumulate in fp32 from the same operands: 5e-4 voxel on
    coords, 1e-4 on the max logit, 1e-4 relative on the normalizer."""
    b, h, w, c, j, d = shape
    feat, kernel, bias = _head_inputs(shape, cuda, dtype)
    before = fhi.launches
    got = fhi.kernel_stats(feat, kernel, bias, j, d, w)
    assert fhi.launches == before + 1
    want = fhi.plain(feat, kernel, bias, j, d, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], atol=5e-4, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(got[2], want[2], atol=0, rtol=1e-4)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    shape = (2, 16, 16, 128, 4, 32)
    feat, kernel, bias = _head_inputs(shape, cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="dtypes"):
        fhi.kernel_stats(feat, kernel.float(), bias, 4, 32, 16)
    with pytest.raises(ValueError, match="contiguous"):
        fhi.kernel_stats(feat, kernel.t().contiguous().t(), bias, 4, 32, 16)
    with pytest.raises(ValueError, match="multiple of 16"):
        fhi.kernel_stats(feat[..., :120].contiguous(), kernel[:120].contiguous(), bias, 4, 32, 16)
    with pytest.raises(ValueError, match="depth_dim"):
        fhi.kernel_stats(feat, kernel, bias, 1, 128, 16)


@pytest.mark.cuda
def test_pose_net_coords_run_the_kernel(cuda):
    """PoseNet.coords on the card goes through the kernel (the counter
    moves) and agrees with coords_plain on the same fp32 weights, TF32 off:
    2e-3 voxel, the end-to-end bar."""
    cfg = get_config("h36m3d_r50_fp32").replace(
        model=ModelConfig(resnet_type=18, matmul_precision="highest"),
        data=DataConfig(trainset=("Human36M",), input_shape=(64, 64), output_shape=(16, 16), depth_dim=16),
    )
    model = build_pose_net(cfg, device=cuda, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 64, 64, 3).astype(np.float32)).to(cuda)
    with torch.inference_mode():
        feat = model.head.features(model.backbone(x.permute(0, 3, 1, 2)))
        rms = float(feat.pow(2).mean().sqrt())
        c = feat.shape[-1]
        model.head.final.weight.normal_(0.0, 5.0 / (rms * c**0.5))  # logits std ~5
        fhi.launches = 0
        coords = model.coords(x)
        assert fhi.launches == 1
        plain = model.coords_plain(x)
    assert float((plain - plain.mean()).abs().max()) > 1.0  # peaked, not flat
    torch.testing.assert_close(coords, plain, atol=2e-3, rtol=0)
