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


# --- K2: the fused head backward --------------------------------------------

BWD_SHAPES = [(2, 16, 16, 128, 4, 32), (2, 16, 16, 128, 18, 16), (3, 9, 7, 64, 17, 64),
              (2, 8, 8, 256, 16, 1)]
BWD_IDS = ["aligned", "j18d16", "ragged", "d1"]
# Relative to each result's largest magnitude. bf16: dfeat, dW and db are
# rounded to bf16 (2^-8 relative) after fp32 sums taken in another order,
# and dv is rounded to bf16 before both contractions, so one-ulp flips are
# expected; fp32: ex2.approx against exp and the sum order only.
BWD_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


def _bwd_inputs(shape, device, dtype, seed=5):
    b, h, w, c, j, d = shape
    feat, kernel, bias = _head_inputs(shape, device, dtype, seed)
    _, m, s = fhi.kernel_stats(feat, kernel, bias, j, d, w)
    coords = fhi.plain(feat, kernel, bias, j, d, w)[0]
    g = torch.randn(b, j, 3, generator=torch.Generator().manual_seed(seed + 1)).to(device)
    return feat, kernel, bias, m, s, coords.contiguous(), g


def _assert_rel_close(got, want, tol, name, atol=0.0):
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert scale > 0 and err <= tol * scale + atol, f"{name}: max|diff| {err} > {tol} * {scale} + {atol}"


def _db_atol(g, h, w, d):
    """db sums dv over every row of every sample, and can cancel to ~0 (at
    D=1 it is 0 exactly: x and y are centred on the coords). Its error
    follows the summands: sum_r |dv| <= |gx| (w-1) + |gy| (h-1) + |gz| (d-1)
    per sample and joint (p sums to 1), so allow 1e-4 of that bound (fp32
    sums of up to B*HW terms in another order)."""
    ext = torch.tensor([w - 1, h - 1, d - 1], dtype=torch.float32, device=g.device)
    return 1e-4 * float((g.abs() * ext).sum(-1).sum(0).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=BWD_IDS)
def test_bwd_kernel_matches_plain(cuda, shape, dtype):
    h, w, j, d = shape[1], shape[2], shape[4], shape[5]
    args = _bwd_inputs(shape, cuda, dtype)
    before = fhi.bwd_launches
    got = fhi.kernel_bwd(*args, j, d, w)
    assert fhi.bwd_launches == before + 1
    want = fhi.plain_bwd(*args, j, d, w)
    torch.cuda.synchronize()
    for name, a, b in zip(("dfeat", "dW", "db"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        atol = _db_atol(args[-1], h, w, d) if name == "db" else 0.0
        _assert_rel_close(a, b, BWD_TOL[dtype], name, atol)


@pytest.mark.cuda
def test_bwd_kernel_is_deterministic(cuda):
    """dW and db are per-CTA partials reduced in sample order, with no
    atomics: two runs on the same inputs agree bit for bit."""
    shape = (8, 32, 32, 256, 18, 64)
    args = _bwd_inputs(shape, cuda, torch.bfloat16)
    first = fhi.kernel_bwd(*args, 18, 64, 32)
    second = fhi.kernel_bwd(*args, 18, 64, 32)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_bwd_kernel_soft_peak_against_float64(cuda, dtype):
    """A logit of 5 over a flat floor at one voxel: p is spread over the
    volume and dv is nonzero everywhere (a hard one-hot gives dv ~ 0, which
    any kernel passes). dW's column for that voxel against float64 on the
    host, from the same (dtype-rounded) inputs."""
    b, h, w, c, j, d = 2, 16, 16, 64, 4, 32
    r0, z0, j0 = 77, 9, 2
    gen = torch.Generator().manual_seed(7)
    feat = (torch.randn(b, h * w, c, generator=gen) * 0.05).to(dtype)
    kernel = (torch.randn(c, j * d, generator=gen) * 0.05).to(dtype)
    feat[:, r0, 0] = 1.0
    kernel[0, j0 * d + z0] = 5.0
    bias = torch.zeros(j * d, dtype=dtype)
    g = torch.randn(b, j, 3, generator=gen)
    f64, k64 = feat.double(), kernel.double()
    v = (f64 @ k64).view(b, h * w, j, d)
    p = torch.softmax(v.transpose(1, 2).reshape(b, j, -1), -1).view(b, j, h * w, d).transpose(1, 2)
    rows = torch.arange(h * w)
    x, y, z = (rows % w).double(), (rows // w).double(), torch.arange(d).double()
    coords = torch.stack([(p.sum(-1) * x[:, None]).sum(1), (p.sum(-1) * y[:, None]).sum(1),
                          (p.sum(1) * z).sum(-1)], -1)  # (B, J, 3)
    dv = p * (g[:, None, :, 0, None] * (x[None, :, None, None] - coords[:, None, :, 0, None])
              + g[:, None, :, 1, None] * (y[None, :, None, None] - coords[:, None, :, 1, None])
              + g[:, None, :, 2, None] * (z - coords[:, None, :, 2, None]))
    ref_col = (f64.transpose(1, 2) @ dv[:, :, j0, z0, None]).sum(0)[:, 0]  # (C,)

    feat_c, kernel_c, bias_c = (t.to(cuda) for t in (feat, kernel, bias))
    coords_k, m, s = fhi.kernel_stats(feat_c, kernel_c, bias_c, j, d, w)
    _, dw, _ = fhi.kernel_bwd(feat_c, kernel_c, bias_c, m, s, coords_k, g.to(cuda), j, d, w)
    col = dw[:, j0 * d + z0].double().cpu()
    assert float(ref_col.abs().max()) > 1e-3  # the peak column is not ~0
    _assert_rel_close(col, ref_col, 2e-2 if dtype == torch.bfloat16 else 1e-4, "dW peak column")


@pytest.mark.cuda
def test_bwd_kernel_all_equal_logits(cuda):
    """Zero logits: p is uniform and coords sit at the centre; K2 agrees
    with plain (dv is the centred position times a constant)."""
    shape = (2, 16, 16, 128, 18, 64)
    feat, kernel, bias, m, s, coords, g = _bwd_inputs(shape, cuda, torch.bfloat16)
    feat, kernel, bias = (torch.zeros_like(t) for t in (feat, kernel, bias))
    coords, m, s = fhi.kernel_stats(feat, kernel, bias, 18, 64, 16)
    got = fhi.kernel_bwd(feat, kernel, bias, m, s, coords, g, 18, 64, 16)
    want = fhi.plain_bwd(feat, kernel, bias, m, s, coords, g, 18, 64, 16)
    assert float(got[0].abs().max()) == 0.0 and float(got[1].abs().max()) == 0.0  # feat = W = 0
    _assert_rel_close(got[2], want[2], 1e-2, "db", _db_atol(g, 16, 16, 64))


@pytest.mark.cuda
def test_autograd_runs_k1_and_k2(cuda):
    """fused_final_conv_integral on CUDA tensors that need gradients runs K1
    forward and K2 backward, once each, and its gradients are K2's."""
    b, h, w, c, j, d = 2, 16, 16, 128, 18, 16
    feat, kernel, bias = _head_inputs((b, h, w, c, j, d), cuda, torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (feat.view(b, h, w, c), kernel, bias)]
    fhi.launches = fhi.bwd_launches = 0
    coords = fhi.fused_final_conv_integral(*leaves, j, d)
    g = torch.randn_like(coords)
    coords.backward(g)
    assert (fhi.launches, fhi.bwd_launches) == (1, 1)
    _, m, s = fhi.kernel_stats(feat, kernel, bias, j, d, w)
    want = fhi.kernel_bwd(feat, kernel, bias, m, s, coords.detach(), g, j, d, w)
    for leaf, ref in zip(leaves, want):
        assert torch.equal(leaf.grad.reshape(ref.shape), ref)
