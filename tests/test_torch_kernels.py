"""The CUDA kernels against their plain versions, on a CUDA device.

Every test here is marked ``cuda`` and skips on a host without a card.
The file imports torch and the port only (no JAX), so it also runs on the
GPU host, where tests/conftest.py (which imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import ctypes

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ihpr_tpu_torch.config import DataConfig, ModelConfig, get_config
from ihpr_tpu_torch.models.pose_net import build_pose_net
from ihpr_tpu_torch.ops import _build
from ihpr_tpu_torch.ops import fused_head_integral as fhi
from ihpr_tpu_torch.ops import integral_volume as iv


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


# --- the wgmma operand modes K1/K2 build on (csrc/hopper_selftest.cu) ------------


def _selftest(a, b, mode, k, n, sa=None, sb=None):
    """D (64 x n, fp32) of hopper_selftest.cu's one-tile GEMM in ``mode``,
    the tiles of a and b first scaled in shared memory by sa and sb at
    their columns where given."""
    lib = _build.load("hopper_selftest")
    lib.ihpr_hopper_selftest.restype = ctypes.c_int
    lib.ihpr_hopper_selftest.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out = torch.empty(64, n, device=a.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = lib.ihpr_hopper_selftest(a.data_ptr(), b.data_ptr(), ptr(sa), ptr(sb), out.data_ptr(), mode, k, n,
                                   torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"hopper_selftest mode {mode}: error {err}"
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize(
    "mode, k, n, scaled",
    [(0, 64, 64, False), (0, 256, 64, False), (0, 256, 192, False), (1, 128, 64, False), (2, 64, 64, False),
     (2, 256, 64, False), (3, 64, 64, False), (3, 128, 64, False), (0, 256, 256, False), (1, 256, 256, False),
     (2, 128, 256, False), (0, 128, 128, False), (1, 256, 128, False), (2, 64, 128, False),
     (0, 128, 64, True), (0, 64, 256, True), (2, 64, 128, True), (2, 128, 256, True), (1, 128, 128, True),
     (1, 64, 64, True), (1, 256, 256, True)],
    ids=["kmajor_ab", "kmajor_ab_k256", "kmajor_n192", "mnmajor_b", "mmajor_a",
         "mmajor_a_k256", "regs_a_mnmajor_b", "regs_a_mnmajor_b_k128", "kmajor_n256",
         "mnmajor_b_n256", "mmajor_a_n256", "kmajor_n128", "mnmajor_b_n128", "mmajor_a_n128",
         "rewritten_kmajor_ab", "rewritten_kmajor_n256", "rewritten_mmajor_a_n128",
         "rewritten_mmajor_a_n256", "rewritten_mnmajor_b_n128", "rewritten_mnmajor_b",
         "rewritten_mnmajor_b_n256"],
)
def test_wgmma_descriptor_modes_match_matmul(cuda, mode, k, n, scaled):
    """Each operand layout of hopper.cuh that K1/K2, K5/K6, K7/K8 and P2
    issue (K-major A and B; MN-major B; M-major A; A from registers with
    MN-major B; the n128 and n256 shapes of K5's y, K6's da and dw, K7's y,
    K8's da and dw and P2's bf16 tiles) through TMA, 128-byte swizzled tiles
    and wgmma, against torch.matmul in fp32 on the same bf16 values:
    products are exact, so only the sum order differs (1e-5 of the
    largest). ``rewritten``: the tiles are first rewritten in place in
    shared memory (each element times a power of two at its column, as K6
    forms gc and K5/K6 relu(x*mul + add) in the tiles TMA brought in; K5's
    y at n64, n128 and n256 reads such an A K-major with B MN-major), so a
    column taken from the wrong swizzled chunk or a missing proxy fence
    shows."""
    g = torch.Generator().manual_seed(mode * 1000 + k + n + scaled)
    a = torch.randn(64, k, generator=g).to(cuda, torch.bfloat16)
    b = torch.randn(k, n, generator=g).to(cuda, torch.bfloat16)
    a_arg = a.t().contiguous() if mode == 2 else a
    b_arg = b.t().contiguous() if mode == 0 else b
    sa = sb = None
    if scaled:  # powers of two: the rescaled bf16 values stay exact
        sa = (2.0 ** torch.randint(-2, 3, (a_arg.shape[1],), generator=g)).to(cuda)
        sa[::7] = -sa[::7]
        sb = (2.0 ** torch.randint(-2, 3, (b_arg.shape[1],), generator=g)).to(cuda)
        a_arg_scaled, b_arg_scaled = a_arg.float() * sa, b_arg.float() * sb
        a = a_arg_scaled.t() if mode == 2 else a_arg_scaled
        b = b_arg_scaled.t() if mode == 0 else b_arg_scaled
    got = _selftest(a_arg, b_arg, mode, k, n, sa, sb)
    want = a.float() @ b.float()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("k, n", [(128, 128), (256, 128), (128, 256), (256, 256)],
                         ids=["k128_n128", "k256_n128", "k128_n256", "k256_n256"])
def test_wgmma_s8_matches_int_products(cuda, k, n):
    """P2's int8 operand mode: a (64, k) and b^T (n, k) int8 over the full
    range -128 ... 127 through uint8 TMA maps, 128-byte swizzled K-major
    tiles and wgmma m64nNk32 s8 -> s32, bitwise against the float64 product
    of the same integers (exact: |sum| < 2^53)."""
    lib = _build.load("hopper_selftest")
    fn = lib.ihpr_hopper_selftest_s8
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    g = torch.Generator().manual_seed(k + n)
    a = torch.randint(-128, 128, (64, k), generator=g, dtype=torch.int8).to(cuda)
    bt = torch.randint(-128, 128, (n, k), generator=g, dtype=torch.int8).to(cuda)
    out = torch.empty(64, n, dtype=torch.int32, device=cuda)
    err = fn(a.data_ptr(), bt.data_ptr(), out.data_ptr(), k, n, torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"hopper_selftest s8: error {err}"
    torch.cuda.synchronize()
    assert torch.equal(out, (a.double() @ bt.double().t()).to(torch.int32))


def _selftest_tf32(a, b, b2, mode, k, n):
    """D (64 x n) of hopper_selftest.cu's TF32 mode ``mode``, and E (64 x
    n) for mode 4."""
    lib = _build.load("hopper_selftest")
    fn = lib.ihpr_hopper_selftest_tf32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out, out2 = torch.empty(64, n, device=a.device), torch.empty(64, n, device=a.device)
    err = fn(a.data_ptr(), b.data_ptr(), (b2 if b2 is not None else b).data_ptr(), out.data_ptr(),
             out2.data_ptr(), mode, k, n, torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"hopper_selftest tf32 mode {mode}: error {err}"
    torch.cuda.synchronize()
    return out, out2


@pytest.mark.cuda
@pytest.mark.parametrize(
    "mode, k, n",
    [(0, 128, 64), (0, 64, 32), (1, 128, 64), (1, 32, 32), (2, 128, 64), (2, 96, 32), (3, 128, 64),
     (3, 64, 32), (4, 128, 64)],
    ids=["tf32_kmajor_ab_n64", "tf32_kmajor_ab_n32", "tf32_regs_a_n64", "tf32_regs_a_n32",
         "tf32_split_perm32_n64", "tf32_split_perm32_rows32_n32", "tf32_rewritten_split_n64",
         "tf32_rewritten_split_n32", "tf32_acc_as_a_perm8"],
)
def test_wgmma_tf32_modes_match_float64(cuda, mode, k, n):
    """The TF32 wgmma modes K1-fp32 / K2-fp32 build on
    (csrc/fused_head_f32.cuh; hopper_selftest.cu's modes 0-4), against
    float64 products. Modes 0 and 1 (K-major A and B from 128-byte-swizzled
    fp32 TMA tiles; A from registers) take TF32 values (split_planes'
    rounding), so the products are exact: 1e-6 of the sum of |terms|
    (fp32 sums). Modes 2-4 are 3xTF32 on fp32 values: A split in registers
    in perm32's order against the pre-pass's Wt planes (n32 on rows 32-63,
    as dw_kernel's second warpgroup); B rewritten in place in shared memory
    as its hi and lo planes; the accumulator turned into A (as_a) against
    the pre-pass's W planes in perm8's order: 2^-20 of the sum of |terms|,
    where one TF32 pass errs by ~2^-11."""
    g = torch.Generator().manual_seed(100 * mode + k + n)
    a = torch.randn(64, k, generator=g)
    if mode in (0, 1):
        a, b = fhi.tf32_round(a), fhi.tf32_round(torch.randn(n, k, generator=g))
        got, _ = _selftest_tf32(a.to(cuda), b.to(cuda), None, mode, k, n)
        want, scale = a.double() @ b.double().t(), a.double().abs() @ b.double().abs().t()
        assert bool(((got.cpu().double() - want).abs() <= 1e-6 * scale).all())
        return
    if mode == 3:
        b = torch.randn(n, k, generator=g)
        got, _ = _selftest_tf32(a.to(cuda), b.to(cuda), None, mode, k, n)
        bt = b.double()
    else:
        b1 = torch.randn(k, 64, generator=g)  # a kernel (C = k, J*D = 64): Wt planes (2, 64, k)
        planes = fhi.split_planes(b1, 1, 64)[0]
        b2 = torch.randn(n, 64, generator=g)  # mode 4: W planes (2, n, 64) of a kernel (n, 64)
        got, e = _selftest_tf32(a.to(cuda), planes.to(cuda), fhi.split_planes(b2, 1, 64)[1].to(cuda), mode, k, n)
        bt = b1.double().t()[64 - n:]
    want, scale = a.double() @ bt.t(), a.double().abs() @ bt.abs().t()
    assert bool(((got.cpu().double() - want).abs() <= 2.0**-20 * scale).all())
    if mode == 4:
        d1 = got.cpu().double()
        want, scale = d1 @ b2.double().t(), d1.abs() @ b2.double().abs().t()
        assert bool(((e.cpu().double() - want).abs() <= 2.0**-20 * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 18, 64), (64, 17, 64), (96, 5, 24)], ids=["flagship", "j17", "c96_d24"])
def test_split_planes_kernel_matches_plain(cuda, shape):
    """The fp32 kernels' pre-pass (split_planes_kernel) bitwise
    split_planes: the Wt and W planes, hi and lo, padding included."""
    c, j, d = shape
    kernel = torch.randn(c, j * d, generator=torch.Generator().manual_seed(c + j)) * 3.0
    lib = _build.load(fhi._F32_BWD_LIB)
    fn = lib.ihpr_fused_head_integral_bwd_f32_split
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    planes = torch.full((4, j * 64, c), float("nan"), device=cuda)
    assert fn(kernel.to(cuda).data_ptr(), planes.data_ptr(), c, j, d, torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    wt, w = fhi.split_planes(kernel, j, d)
    assert torch.equal(planes[:2].cpu().view(torch.int32), wt.view(torch.int32))
    assert torch.equal(planes[2:].cpu().reshape(2, c, j * 64).view(torch.int32), w.view(torch.int32))


def _tma4d(a, bw, bh, c0, j0, i0, b):
    """The (64, 64) box of hopper.cuh's 4-D NHWC map of a at (channel c0,
    column j0, row i0, image b), unswizzled (hopper_selftest.cu)."""
    lib = _build.load("hopper_selftest")
    fn = lib.ihpr_hopper_selftest_tma4d
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    out = torch.empty(64, 64, device=a.device, dtype=torch.bfloat16)
    err = fn(a.data_ptr(), out.data_ptr(), *a.shape, bw, bh, c0, j0, i0, b,
             torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"tma4d: error {err}"
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape, bw", [((2, 5, 7, 72), 8), ((3, 16, 16, 256), 16)], ids=["ragged_w8", "flagship_w16"])
def test_tma4d_shifted_boxes_match_padded_slices(cuda, shape, bw):
    """The 4-D NHWC box K7/K8 read their taps with (tmap_nhwc +
    tma_load_4d) at the four image corners shifted one pixel outwards
    (negative coordinates included), wholly past the image, and at the last
    channel block (past C at C = 72): bitwise the matching slice of the
    zero-padded tensor, the 3x3 conv's SAME padding."""
    bh = 64 // bw
    nb, h, w, c = shape
    a = torch.randn(*shape, generator=torch.Generator().manual_seed(7)).to(cuda, torch.bfloat16)
    pad = 64
    padded = F.pad(a, (0, 64, pad, pad, pad, pad))
    corners = [(-1, -1), (-1, w - bw + 1), (h - bh + 1, -1), (h - bh + 1, w - bw + 1), (h, w)]
    for b in (0, nb - 1):
        for i0, j0 in corners:
            for c0 in (0, (c - 1) // 64 * 64):
                got = _tma4d(a, bw, bh, c0, j0, i0, b)
                want = padded[b, pad + i0:pad + i0 + bh, pad + j0:pad + j0 + bw, c0:c0 + 64]
                assert torch.equal(got, want.reshape(64, 64)), (b, i0, j0, c0)


def _tma4d_f32(a, bw, bh, c0, j0, i0, b):
    """The (64, 32) box of hopper.cuh's fp32 4-D NHWC map of a at (channel
    c0, column j0, row i0, image b), unswizzled (hopper_selftest.cu)."""
    lib = _build.load("hopper_selftest")
    fn = lib.ihpr_hopper_selftest_tma4d_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    out = torch.empty(64, 32, device=a.device, dtype=torch.float32)
    err = fn(a.data_ptr(), out.data_ptr(), *a.shape, bw, bh, c0, j0, i0, b, torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"tma4d_f32: error {err}"
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape, bw", [((2, 5, 7, 72), 8), ((3, 8, 8, 256), 8), ((2, 12, 8, 40), 8),
                                       ((2, 16, 16, 64), 16)],
                         ids=["ragged_w8", "route_8x8", "plane_12x8", "w16"])
def test_tma4d_f32_shifted_boxes_match_padded_slices(cuda, shape, bw):
    """The fp32 4-D NHWC box K7-fp32 / K8-fp32 read their taps with
    (tmap_nhwc_f32 + tma_load_4d), 32 channels x bw x bh, at the four image
    corners shifted one pixel outwards (negative coordinates included),
    wholly past the image and past the batch, and at the last channel block
    (past C at C = 72 and 40): bitwise the matching slice of the zero-padded
    tensor, the 3x3 conv's SAME padding."""
    bh = 64 // bw
    nb, h, w, c = shape
    a = torch.randn(*shape, generator=torch.Generator().manual_seed(8)).to(cuda)
    pad = 64
    padded = F.pad(a, (0, 32, pad, pad, pad, pad))
    corners = [(-1, -1), (-1, w - bw + 1), (h - bh + 1, -1), (h - bh + 1, w - bw + 1), (h, w)]
    for b in (0, nb - 1, nb):
        for i0, j0 in corners:
            for c0 in (0, (c - 1) // 32 * 32):
                got = _tma4d_f32(a, bw, bh, c0, j0, i0, b)
                want = (padded[b, pad + i0:pad + i0 + bh, pad + j0:pad + j0 + bw, c0:c0 + 32] if b < nb
                        else torch.zeros(bh, bw, 32, device=cuda))
                assert torch.equal(got, want.reshape(64, 32)), (b, i0, j0, c0)


# --- K1: the fused head forward ---------------------------------------------------

HEAD_SHAPES = [(2, 16, 16, 128, 4, 32), (2, 16, 16, 128, 18, 16), (3, 9, 7, 64, 17, 64),
               (2, 8, 8, 256, 16, 1), (2, 8, 8, 80, 5, 24), (2, 6, 5, 16, 3, 64),
               (2, 96, 72, 256, 18, 64)]
HEAD_IDS = ["aligned", "j18d16", "ragged", "d1", "c80", "c16", "r152"]  # r152: h36m3d_r152_384's head


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", HEAD_SHAPES, ids=HEAD_IDS)
def test_kernel_matches_plain(cuda, shape, dtype):
    """Both sides accumulate in fp32 (fp32 operands: K1-fp32's 3xTF32
    products) from the same operands: 5e-4 voxel on coords, 1e-4 on the max
    logit, 1e-4 relative on the normalizer. Each dtype's launch moves its
    own counter. fp32 heads whose C is not a multiple of 32 raise."""
    b, h, w, c, j, d = shape
    feat, kernel, bias = _head_inputs(shape, cuda, dtype)
    counters = ("launches", "f32_launches") if dtype == torch.bfloat16 else ("f32_launches", "launches")
    before = [getattr(fhi, n) for n in counters]
    if dtype == torch.float32 and c % 32:
        with pytest.raises(ValueError, match="multiple of 32"):
            fhi.kernel_stats(feat, kernel, bias, j, d, w)
        assert [getattr(fhi, n) for n in counters] == before
        return
    got = fhi.kernel_stats(feat, kernel, bias, j, d, w)
    assert [getattr(fhi, n) for n in counters] == [before[0] + 1, before[1]]
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
    f32 = [t.float() for t in (feat, kernel, bias)]
    with pytest.raises(ValueError, match="multiple of 32"):
        fhi.kernel_stats(f32[0][..., :112].contiguous(), f32[1][:112].contiguous(), f32[2], 4, 32, 16)
    with pytest.raises(ValueError, match="depth_dim"):
        fhi.kernel_stats(*f32, 1, 128, 16)


@pytest.mark.cuda
def test_pose_net_coords_run_the_kernel(cuda):
    """PoseNet.coords of an fp32 model on the card goes through K1-fp32 (its
    counter moves; K1's and K3's do not): JAX has a fused plan for this
    head (J = 18, D = 16 pads to 24 joints). It agrees with coords_plain on
    the same fp32 weights, TF32 off: 2e-3 voxel, the end-to-end bar."""
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
        fhi.launches = fhi.f32_launches = iv.launches = 0
        coords = model.coords(x)
        assert (fhi.launches, fhi.f32_launches, iv.launches) == (0, 1, 0)
        plain = model.coords_plain(x)
    assert float((plain - plain.mean()).abs().max()) > 1.0  # peaked, not flat
    torch.testing.assert_close(coords, plain, atol=2e-3, rtol=0)


# --- K2: the fused head backward --------------------------------------------

# Relative to each result's largest magnitude: dfeat, dW and db are rounded
# to bf16 (2^-8 relative) after fp32 sums taken in another order, and dv is
# rounded to bf16 before both contractions, so one-ulp flips are expected.
BWD_TOL = 1e-2


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
@pytest.mark.parametrize("shape", HEAD_SHAPES, ids=HEAD_IDS)
def test_bwd_kernel_matches_plain(cuda, shape, dtype):
    """K2 (bf16) within 1e-2 of each result's largest magnitude; K2-fp32
    within 1e-4 (fp32 sums in another order, 3xTF32 products). fp32 heads
    whose C is not a multiple of 32 raise."""
    h, w, c, j, d = shape[1], shape[2], shape[3], shape[4], shape[5]
    counter = "bwd_launches" if dtype == torch.bfloat16 else "f32_bwd_launches"
    before = getattr(fhi, counter)
    if dtype == torch.float32 and c % 32:
        args = _bwd_inputs(shape, cuda, torch.bfloat16)
        fp32 = [t.float() for t in args[:3]] + list(args[3:])
        with pytest.raises(ValueError, match="multiple of 32"):
            fhi.kernel_bwd(*fp32, j, d, w)
        assert getattr(fhi, counter) == before
        return
    args = _bwd_inputs(shape, cuda, dtype)
    got = fhi.kernel_bwd(*args, j, d, w)
    assert getattr(fhi, counter) == before + 1
    want = fhi.plain_bwd(*args, j, d, w)
    torch.cuda.synchronize()
    tol = BWD_TOL if dtype == torch.bfloat16 else 1e-4
    for name, a, b in zip(("dfeat", "dW", "db"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        atol = _db_atol(args[-1], h, w, d) if name == "db" else 0.0
        _assert_rel_close(a, b, tol, name, atol)


EXP_MODES = {"exp2": (True, False), "bexp": (False, True), "exp2_bexp": (True, True)}
EXP_SHAPES = [HEAD_SHAPES[0], HEAD_SHAPES[1], HEAD_SHAPES[2]]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", EXP_SHAPES, ids=HEAD_IDS[:3])
@pytest.mark.parametrize("mode", sorted(EXP_MODES))
def test_exp_modes_kernels_match_plain(cuda, mode, shape, dtype):
    """K1 and K2 (K1-fp32 and K2-fp32 for fp32) in each exp mode against
    ``plain`` / ``plain_bwd`` in the same mode, at ``test_kernel_matches_plain``'s
    and ``test_bwd_kernel_matches_plain``'s bars; under IHPR_BEXP the
    backward's p is a bf16 value, so K2-fp32 takes the bf16 bar there.
    IHPR_EXP2's m is a base-2 max. Each launch moves its own counter once."""
    exp2, bexp = EXP_MODES[mode]
    b, h, w, c, j, d = shape
    feat, kernel, bias = _head_inputs(shape, cuda, dtype)
    fwd, bwd = ("launches", "bwd_launches") if dtype == torch.bfloat16 else ("f32_launches", "f32_bwd_launches")
    before = (getattr(fhi, fwd), getattr(fhi, bwd))
    got = fhi.kernel_stats(feat, kernel, bias, j, d, w, exp2)
    want = fhi.plain(feat, kernel, bias, j, d, w, exp2)
    torch.testing.assert_close(got[0], want[0], atol=5e-4, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(got[2], want[2], atol=0, rtol=1e-4)
    _, m, s = got
    g = torch.randn(b, j, 3, generator=torch.Generator().manual_seed(6)).to(cuda)
    args = (feat, kernel, bias, m, s, want[0].contiguous(), g, j, d, w, exp2, bexp)
    grads = fhi.kernel_bwd(*args)
    assert (getattr(fhi, fwd), getattr(fhi, bwd)) == (before[0] + 1, before[1] + 1)
    ref = fhi.plain_bwd(*args)
    torch.cuda.synchronize()
    tol = BWD_TOL if dtype == torch.bfloat16 or bexp else 1e-4
    for name, a, r in zip(("dfeat", "dW", "db"), grads, ref):
        assert a.dtype == r.dtype and a.shape == r.shape, name
        _assert_rel_close(a, r, tol, name, _db_atol(g, h, w, d) if name == "db" else 0.0)
    if bexp:  # the kernel's own IHPR_BEXP move against plain's, as chip_smoke's bexp_effect_check
        without = (fhi.kernel_bwd(*args[:-1], False), fhi.plain_bwd(*args[:-1], False))
        for name, a, r, a0, r0 in zip(("dfeat", "dW", "db"), grads, ref, *without):
            move = (r.double() - r0.double()).norm()
            off = ((a.double() - a0.double()) - (r.double() - r0.double())).norm()
            assert off <= 0.5 * move, (name, float(off / move))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(EXP_MODES))
def test_exp_modes_reach_the_kernels_through_autograd(cuda, mode, monkeypatch):
    """With the environment set, ``fused_final_conv_integral`` runs K1 / K2
    in that mode: its coords and gradients are the kernels' in the mode,
    called directly, bitwise."""
    exp2, bexp = EXP_MODES[mode]
    for flag, on in (("IHPR_EXP2", exp2), ("IHPR_BEXP", bexp)):
        monkeypatch.setenv(flag, "1" if on else "0")
    shape = HEAD_SHAPES[1]
    b, h, w, c, j, d = shape
    feat, kernel, bias = _head_inputs(shape, cuda, torch.bfloat16)
    f = feat.view(b, h, w, c).clone().requires_grad_()
    k, bb = kernel.clone().requires_grad_(), bias.clone().requires_grad_()
    out = fhi.fused_final_conv_integral(f, k, bb, j, d)
    g = torch.randn(b, j, 3, generator=torch.Generator().manual_seed(7)).to(cuda)
    out.backward(g)
    coords, m, s = fhi.kernel_stats(feat, kernel, bias, j, d, w, exp2)
    grads = fhi.kernel_bwd(feat, kernel, bias, m, s, coords, g, j, d, w, exp2, bexp)
    assert torch.equal(out.detach(), coords)
    for a, want in zip((f.grad.view(b, h * w, c), k.grad, bb.grad), grads):
        assert torch.equal(a, want)


@pytest.mark.cuda
def test_kernel_is_deterministic(cuda):
    """K1 merges its warps' states in a fixed order, with no atomics, so
    repeated launches on the same inputs agree bit for bit. A ring whose
    warpgroups misread a barrier phase consumes a slot before its tile has
    landed, and shows here as a launch that differs (or is NaN); a bf16
    matmul before each launch leaves other data in shared memory."""
    shape = (64, 64, 64, 256, 18, 64)
    args = _head_inputs(shape, cuda, torch.bfloat16)
    first = fhi.kernel_stats(*args, 18, 64, 64)
    x = torch.randn(2048, 2048, device=cuda, dtype=torch.bfloat16)
    differ = torch.zeros((), dtype=torch.int64, device=cuda)
    for _ in range(200):
        x @ x
        got = fhi.kernel_stats(*args, 18, 64, 64)
        differ += torch.stack([(a != b).any() for a, b in zip(got, first)]).any()
    assert int(differ) == 0, f"{int(differ)} of 200 launches differ from the first"


@pytest.mark.cuda
def test_bwd_kernel_is_deterministic(cuda):
    """dW and db are per-warpgroup partials reduced in a fixed order, with
    no atomics: two runs on the same inputs agree bit for bit."""
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
    host, from the same inputs (bf16-rounded for bf16): 2e-2 of its largest
    for K2 (dv rounded to bf16), 1e-4 for K2-fp32."""
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


# --- K3/K4: the standalone integral over a logits volume -----------------------

# (B, H, W, J, D): J*D = 128; J=18, D=16; ragged 9x7 with J=17 (J*D*2 bytes
# 16-aligned); D=1 with J=16 (32-byte rows); J=17, D=1 (34-byte rows: the
# one-lane path); J=18, D=80 (more bins than K1 takes); 96x72.
VOL_SHAPES = [(2, 16, 16, 4, 32), (2, 16, 16, 18, 16), (3, 9, 7, 17, 64), (2, 8, 8, 16, 1),
              (2, 8, 8, 17, 1), (2, 8, 8, 18, 80), (2, 96, 72, 18, 64)]
VOL_IDS = ["aligned", "j18d16", "ragged", "d1", "j17d1", "d80", "96x72"]
# dv relative to its largest magnitude: bf16 rounds every dv once (2^-8)
# after fp32 arithmetic that differs only by ex2.approx and the order of
# sums in m and s; fp32 by those alone.
DV_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


def _volume(shape, device, dtype, seed=6, std=5.0):
    """Logits of std ~5: peaked, so coordinates sit away from the centre."""
    b, h, w, j, d = shape
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, h * w, j * d, generator=g) * std).to(device, dtype)


def _check_stats(got, want):
    torch.testing.assert_close(got[0], want[0], atol=5e-4, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=0, rtol=0)  # the max is exact
    torch.testing.assert_close(got[2], want[2], atol=0, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", VOL_SHAPES, ids=VOL_IDS)
def test_volume_kernels_match_plain(cuda, shape, dtype):
    b, h, w, j, d = shape
    vol = _volume(shape, cuda, dtype)
    before = (iv.launches, iv.bwd_launches)
    got = iv.kernel_stats(vol, j, d, w)
    want = iv.plain(vol, j, d, w)
    torch.cuda.synchronize()
    _check_stats(got, want)
    centre = torch.tensor([(w - 1) / 2, (h - 1) / 2, (d - 1) / 2], device=cuda)
    assert float((want[0] - centre).abs().max()) > 1.0  # peaked, not flat
    g = torch.randn(b, j, 3, generator=torch.Generator().manual_seed(1)).to(cuda)
    dv = iv.kernel_bwd(vol, *got[1:], got[0], g, j, d, w)
    ref = iv.plain_bwd(vol, *got[1:], got[0], g, j, d, w)
    assert (iv.launches, iv.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert dv.dtype == vol.dtype and dv.shape == vol.shape
    scale = float(ref.float().abs().max())
    assert float((dv.float() - ref.float()).abs().max()) <= DV_TOL[dtype] * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_volume_kernels_edge_logits(cuda, dtype):
    """All-equal logits give the volume centre; a one-hot peak gives its
    voxel; a soft peak (logit 5 over a flat floor, p spread everywhere)
    against float64 on the host, coords and dv."""
    b, h, w, j, d = 2, 64, 64, 18, 64
    centre = torch.tensor([(w - 1) / 2, (h - 1) / 2, (d - 1) / 2], device=cuda)
    flat = torch.zeros(b, h * w, j * d, device=cuda, dtype=dtype)
    torch.testing.assert_close(iv.kernel_stats(flat, j, d, w)[0], centre.expand(b, j, 3), atol=1e-3, rtol=0)
    r0, z0, j0 = 1234, 17, 5
    peak = flat.clone()
    peak[:, r0, j0 * d + z0] = 100.0
    expect = centre.expand(b, j, 3).clone()
    expect[:, j0] = torch.tensor([r0 % w, r0 // w, z0], dtype=torch.float32, device=cuda)
    torch.testing.assert_close(iv.kernel_stats(peak, j, d, w)[0], expect, atol=1e-3, rtol=0)

    soft = flat.clone()
    soft[:, r0, j0 * d + z0] = 5.0
    g = torch.randn(b, j, 3, generator=torch.Generator().manual_seed(2)).to(cuda)
    coords, m, s = iv.kernel_stats(soft, j, d, w)
    dv = iv.kernel_bwd(soft, m, s, coords, g, j, d, w)
    v64 = soft.double().cpu().view(b, h * w, j, d)[:, :, j0]  # (B, HW, D)
    p = torch.softmax(v64.reshape(b, -1), -1).view(b, h * w, d)
    rows = torch.arange(h * w)
    x, y, z = (rows % w).double(), (rows // w).double(), torch.arange(d).double()
    c64 = torch.stack([(p.sum(-1) * x).sum(-1), (p.sum(-1) * y).sum(-1), (p.sum(1) * z).sum(-1)], -1)
    assert float((c64 - expect[:, j0].double().cpu()).abs().max()) > 1.0  # soft, not a one-hot
    torch.testing.assert_close(coords[:, j0].double().cpu(), c64, atol=5e-4, rtol=0)
    gj = g[:, j0].double().cpu()
    dv64 = p * (gj[:, 0, None, None] * (x[:, None] - c64[:, 0, None, None])
                + gj[:, 1, None, None] * (y[:, None] - c64[:, 1, None, None])
                + gj[:, 2, None, None] * (z - c64[:, 2, None, None]))
    got = dv.double().cpu().view(b, h * w, j, d)[:, :, j0]
    assert float((got - dv64).abs().max()) <= DV_TOL[dtype] * float(dv64.abs().max())


@pytest.mark.cuda
def test_volume_kernels_are_deterministic(cuda):
    shape = (8, 64, 64, 18, 64)
    vol = _volume(shape, cuda, torch.bfloat16)
    first = iv.kernel_stats(vol, 18, 64, 64)
    second = iv.kernel_stats(vol, 18, 64, 64)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    g = torch.randn(8, 18, 3, generator=torch.Generator().manual_seed(3)).to(cuda)
    args = (vol, first[1], first[2], first[0], g, 18, 64, 64)
    assert torch.equal(iv.kernel_bwd(*args), iv.kernel_bwd(*args))


@pytest.mark.cuda
def test_volume_kernels_past_2gib(cuda):
    """The fp32 flagship volume (128, 4096, 1152) is 2.42 GB: byte offsets
    pass 2^31, so the kernels index with 64 bits."""
    b, h, w, j, d = 128, 64, 64, 18, 64
    vol = _volume((b, h, w, j, d), cuda, torch.float32)
    assert vol.numel() * vol.element_size() > 2**31
    got = iv.kernel_stats(vol, j, d, w)
    _check_stats(got, iv.plain(vol, j, d, w))
    g = torch.randn(b, j, 3, generator=torch.Generator().manual_seed(4)).to(cuda)
    dv = iv.kernel_bwd(vol, got[1], got[2], got[0], g, j, d, w)
    ref = iv.plain_bwd(vol, got[1], got[2], got[0], g, j, d, w)
    assert float((dv - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
def test_volume_kernels_unaligned_base(cuda):
    """A volume that starts 2 bytes past a 16-byte boundary takes one-lane
    loads; the result still matches plain."""
    b, h, w, j, d = 2, 16, 16, 18, 16
    buf = torch.empty(b * h * w * j * d + 1, device=cuda, dtype=torch.bfloat16)
    vol = buf[1:].view(b, h * w, j * d)
    vol.copy_(_volume((b, h, w, j, d), cuda, torch.bfloat16))
    assert vol.data_ptr() % 16 and vol.is_contiguous()
    _check_stats(iv.kernel_stats(vol, j, d, w), iv.plain(vol, j, d, w))


@pytest.mark.cuda
def test_volume_kernels_reject_what_they_do_not_take(cuda):
    vol = _volume((2, 16, 16, 4, 32), cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        iv.kernel_stats(vol.half(), 4, 32, 16)
    with pytest.raises(ValueError, match="contiguous"):
        iv.kernel_stats(vol.transpose(0, 1).contiguous().transpose(0, 1), 4, 32, 16)
    with pytest.raises(ValueError, match="J\\*D"):
        iv.kernel_stats(vol, 4, 31, 16)
    with pytest.raises(ValueError, match="width"):
        iv.kernel_stats(vol, 4, 32, 15)
    with pytest.raises(ValueError, match="CUDA"):
        iv.kernel_stats(vol.cpu(), 4, 32, 16)
    coords, m, s = iv.kernel_stats(vol, 4, 32, 16)
    with pytest.raises(ValueError, match="float32"):
        iv.kernel_bwd(vol, m.double(), s, coords, torch.zeros_like(coords), 4, 32, 16)


@pytest.mark.cuda
def test_heatmap_autograd_runs_k3_and_k4(cuda):
    """soft_argmax_from_heatmap on a CUDA heatmap that needs a gradient runs
    K3 forward and K4 backward, once each, and its gradient is K4's."""
    b, h, w, j, d = 2, 16, 16, 18, 16
    vol = _volume((b, h, w, j, d), cuda, torch.bfloat16)
    hm = vol.view(b, h, w, j * d).clone().requires_grad_()
    iv.launches = iv.bwd_launches = fhi.launches = fhi.bwd_launches = 0
    coords = iv.soft_argmax_from_heatmap(hm, j, d)
    g = torch.randn_like(coords)
    coords.backward(g)
    assert (iv.launches, iv.bwd_launches, fhi.launches, fhi.bwd_launches) == (1, 1, 0, 0)
    _, m, s = iv.kernel_stats(vol, j, d, w)
    assert torch.equal(hm.grad.view(b, h * w, j * d), iv.kernel_bwd(vol, m, s, coords.detach(), g, j, d, w))


@pytest.mark.cuda
@pytest.mark.parametrize("c, d", [(72, 16), (128, 80)], ids=["c72", "d80"])
def test_fused_op_without_a_plan_runs_k3_and_k4(cuda, c, d):
    """Shapes K1/K2 do not take (C not a multiple of 16, D > 64) form the
    fp32 logits and run K3/K4; K1/K2 do not launch. Coords against the
    fused op's plain version, gradients against autograd through it."""
    b, h, w, j = 2, 16, 16, 18
    feat, kernel, bias = _head_inputs((b, h, w, c, j, d), cuda, torch.float32)
    assert not fhi.fused_supported(j, d, h * w, c, torch.float32)
    leaves = [t.clone().requires_grad_() for t in (feat.view(b, h, w, c), kernel, bias)]
    iv.launches = iv.bwd_launches = fhi.launches = fhi.bwd_launches = 0
    fhi.f32_launches = fhi.f32_bwd_launches = 0
    coords = fhi.fused_final_conv_integral(*leaves, j, d)
    g = torch.randn_like(coords)
    coords.backward(g)
    assert (iv.launches, iv.bwd_launches, fhi.launches, fhi.bwd_launches) == (1, 1, 0, 0)
    assert (fhi.f32_launches, fhi.f32_bwd_launches) == (0, 0)
    ref_leaves = [t.clone().requires_grad_() for t in (feat, kernel, bias)]
    ref = fhi.plain(*ref_leaves, j, d, w)[0]
    ref.backward(g)
    torch.testing.assert_close(coords, ref, atol=5e-4, rtol=0)
    for leaf, r in zip(leaves, ref_leaves):
        scale = float(r.grad.abs().max())
        assert float((leaf.grad.reshape(r.grad.shape) - r.grad).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_fused_supported_shapes_fit_shared_memory(cuda):
    """Every channel count fused_supported admits fits K1's and K2's shared
    memory, and K1/K2-fp32's, so the predicate needs no size check."""
    for c in range(16, 257, 16):
        assert fhi.fused_supported(18, 64, 4096, c, torch.bfloat16)
        assert fhi._lib().ihpr_fused_head_integral_fwd_smem(c) <= fhi._MAX_SMEM
        assert fhi._bwd_lib().ihpr_fused_head_integral_bwd_smem(c) <= fhi._MAX_SMEM
    for c in range(32, 257, 32):
        assert fhi._lib(fhi._F32_LIB).ihpr_fused_head_integral_fwd_f32_smem(c) <= fhi._MAX_SMEM
        assert fhi._bwd_lib(fhi._F32_BWD_LIB).ihpr_fused_head_integral_bwd_f32_smem(c) <= fhi._MAX_SMEM
    assert fhi._bwd_lib().ihpr_fused_head_integral_bwd_max_channels() == fhi._MAX_CHANNELS
    assert fhi._bwd_lib(fhi._F32_BWD_LIB).ihpr_fused_head_integral_bwd_f32_max_channels() == fhi._MAX_CHANNELS


# --- K1/K2-fp32: 3xTF32 (csrc/tf32x3.cuh) ------------------------------------------


def _tf32x3_lib():
    lib = _build.load("tf32x3_selftest")
    lib.ihpr_tf32x3_split.restype = lib.ihpr_tf32x3_product.restype = ctypes.c_int
    lib.ihpr_tf32x3_split.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
    lib.ihpr_tf32x3_product.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
    return lib


@pytest.mark.cuda
def test_tf32x3_split(cuda):
    """hi is x rounded to TF32 (low 13 bits zero), bitwise what
    cvt.rna.tf32.f32 gives; the remainder x - hi is exact in fp32, so
    hi + (x - hi) gives x back bitwise; lo is the
    remainder rounded to TF32 and in its turn has its low 13 bits zero, so
    hi + lo is within 2^-22 |x| of x (not x itself: a TF32 lo keeps 11 of
    the remainder's up to 13 significant bits)."""
    gen = torch.Generator().manual_seed(3)
    x = torch.cat([torch.randn(1 << 16, generator=gen) * 10.0 ** torch.randint(-6, 7, (1 << 16,), generator=gen),
                   torch.tensor([0.0, 1.0, -1.0, 1.0 + 2.0**-23, -(2.0 - 2.0**-23), 3.0e38, -1.0e-30])]).to(cuda)
    hi, rem, lo, rna = (torch.empty_like(x) for _ in range(4))
    lib = _tf32x3_lib()
    assert lib.ihpr_tf32x3_split(x.data_ptr(), hi.data_ptr(), rem.data_ptr(), lo.data_ptr(), rna.data_ptr(),
                                 x.numel(), torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    low = (1 << 13) - 1

    def bad(ok):  # the first few x where a check fails, for the message
        return [(float(v), float(h), float(r), float(lo_)) for v, h, r, lo_ in
                zip(x[~ok][:4], hi[~ok][:4], rem[~ok][:4], lo[~ok][:4])]

    ok = (hi.view(torch.int32) & low) == 0
    assert bool(ok.all()), f"hi not TF32: {bad(ok)}"
    ok = hi.view(torch.int32) == rna.view(torch.int32)
    assert bool(ok.all()), f"hi is not cvt.rna.tf32.f32's: {bad(ok)}"
    ok = (lo.view(torch.int32) & low) == 0
    assert bool(ok.all()), f"lo not TF32: {bad(ok)}"
    ok = hi + rem == x
    assert bool(ok.all()), f"hi + (x - hi) != x: {bad(ok)}"
    ok = rem.double() == x.double() - hi.double()  # the remainder is exact
    assert bool(ok.all()), f"x - hi inexact: {bad(ok)}"
    ok = (x.double() - hi.double() - lo.double()).abs() <= 2.0**-22 * x.double().abs()
    assert bool(ok.all()), f"|x - (hi + lo)| > 2^-22 |x|: {bad(ok)}"


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 256], ids=["k8", "k256"])
def test_tf32x3_tile_product_against_float64(cuda, k):
    """One m16n8 tile of A (16 x K) B (K x 8) by 3xTF32, and that tile
    turned in registers into the A fragment of a second product (the path
    of K2-fp32's contractions over dv): each element within 2^-20 of
    sum_k |a b| of float64, where one TF32 pass errs by ~2^-11."""
    gen = torch.Generator().manual_seed(k)
    a = torch.randn(16, k, generator=gen).to(cuda)
    b = torch.randn(k, 8, generator=gen).to(cuda)
    b2 = torch.randn(8, 8, generator=gen).to(cuda)
    d, e = torch.empty(16, 8, device=cuda), torch.empty(16, 8, device=cuda)
    assert _tf32x3_lib().ihpr_tf32x3_product(a.data_ptr(), b.data_ptr(), b2.data_ptr(), d.data_ptr(),
                                              e.data_ptr(), k, torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    a64, b64, b264 = a.double(), b.double(), b2.double()
    d64 = a64 @ b64
    assert bool(((d.double() - d64).abs() <= 2.0**-20 * (a64.abs() @ b64.abs())).all())
    e64 = d.double() @ b264  # from the kernel's own d
    assert bool(((e.double() - e64).abs() <= 2.0**-20 * (d.double().abs() @ b264.abs())).all())
    one_pass = (a64 @ b64 - (a.to(torch.bfloat16).double() @ b.to(torch.bfloat16).double())).abs().max()
    assert float((d.double() - d64).abs().max()) < 1e-3 * float(one_pass)  # far below a 16-bit pass


F32_HEAD = (8, 32, 32, 256, 18, 64)  # a flagship-width head at 32x32


@pytest.mark.cuda
def test_f32_kernels_against_float64(cuda):
    """K1-fp32 and K2-fp32 against plain / plain_bwd run in float64 on the
    same fp32 inputs, beside the no-plan route (fp32 cuBLAS with TF32 off,
    then K3/K4) on the same inputs: K1-fp32's coords at most twice the
    no-plan route's distance from float64 (plus 1e-6 voxel), which shows
    "highest" holds; each gradient of K2-fp32 within 1e-4 of float64's
    largest (fp32 sums of up to B*HW terms)."""
    b, h, w, c, j, d = F32_HEAD
    feat, kernel, bias = _head_inputs(F32_HEAD, cuda, torch.float32, seed=8)
    f64 = [t.double() for t in (feat, kernel, bias)]
    want = fhi.plain(*f64, j, d, w)
    got = fhi.kernel_stats(feat, kernel, bias, j, d, w)
    with fhi.no_tf32():
        logits = torch.addmm(bias, feat.view(-1, c), kernel).view(b, h * w, j * d)
    route = iv.kernel_stats(logits, j, d, w)
    torch.cuda.synchronize()
    k1_err = float((got[0].double() - want[0]).abs().max())
    route_err = float((route[0].double() - want[0]).abs().max())
    assert float((want[0] - want[0].mean()).abs().max()) > 1.0  # peaked
    assert k1_err <= 2 * route_err + 1e-6, (k1_err, route_err)

    g = torch.randn(b, j, 3, generator=torch.Generator().manual_seed(9)).to(cuda)
    coords = want[0].float().contiguous()
    m, s = got[1], got[2]
    grads = fhi.kernel_bwd(feat, kernel, bias, m, s, coords, g, j, d, w)
    ref = fhi.plain_bwd(*f64, m.double(), s.double(), coords.double(), g.double(), j, d, w)
    torch.cuda.synchronize()
    for name, a, r in zip(("dfeat", "dW", "db"), grads, ref):
        _assert_rel_close(a.double(), r, 1e-4, name)


@pytest.mark.cuda
def test_f32_kernels_are_deterministic(cuda):
    """K1-fp32 merges its warps' states and K2-fp32 reduces its partials in
    a fixed order, with no atomics: repeated launches on the same inputs
    agree bit for bit, each K1-fp32 launch after a bf16 matmul that leaves
    other data in shared memory."""
    b, h, w, c, j, d = 16, 64, 64, 256, 18, 64
    args = _head_inputs((b, h, w, c, j, d), cuda, torch.float32)
    first = fhi.kernel_stats(*args, j, d, w)
    x = torch.randn(2048, 2048, device=cuda, dtype=torch.bfloat16)
    differ = torch.zeros((), dtype=torch.int64, device=cuda)
    for _ in range(100):
        x @ x
        got = fhi.kernel_stats(*args, j, d, w)
        differ += torch.stack([(a != b_).any() for a, b_ in zip(got, first)]).any()
    assert int(differ) == 0, f"{int(differ)} of 100 launches differ from the first"
    g = torch.randn(b, j, 3, generator=torch.Generator().manual_seed(2)).to(cuda)
    bwd = [fhi.kernel_bwd(*args, first[1], first[2], first[0], g, j, d, w) for _ in range(3)]
    for other in bwd[1:]:
        for a, b_ in zip(bwd[0], other):
            assert torch.equal(a, b_)


@pytest.mark.cuda
def test_autograd_runs_k1_and_k2_fp32(cuda):
    """fused_final_conv_integral on fp32 CUDA tensors of a head JAX has a
    fused plan for runs K1-fp32 forward and K2-fp32 backward, once each
    (K1/K2 and K3/K4 not at all), and its gradients are K2-fp32's."""
    b, h, w, c, j, d = 2, 16, 16, 128, 18, 16
    feat, kernel, bias = _head_inputs((b, h, w, c, j, d), cuda, torch.float32)
    leaves = [t.clone().requires_grad_() for t in (feat.view(b, h, w, c), kernel, bias)]
    fhi.launches = fhi.bwd_launches = fhi.f32_launches = fhi.f32_bwd_launches = 0
    iv.launches = iv.bwd_launches = 0
    coords = fhi.fused_final_conv_integral(*leaves, j, d)
    g = torch.randn_like(coords)
    coords.backward(g)
    assert (fhi.launches, fhi.bwd_launches, fhi.f32_launches, fhi.f32_bwd_launches) == (0, 0, 1, 1)
    assert (iv.launches, iv.bwd_launches) == (0, 0)
    _, m, s = fhi.kernel_stats(feat, kernel, bias, j, d, w)
    want = fhi.kernel_bwd(feat, kernel, bias, m, s, coords.detach(), g, j, d, w)
    for leaf, ref in zip(leaves, want):
        assert torch.equal(leaf.grad.reshape(ref.shape), ref)


# --- K5-K8: the conv + BN-statistics kernels ------------------------------------

from ihpr_tpu_torch.models import resnet  # noqa: E402
from ihpr_tpu_torch.ops import conv_bn, matmul_bn  # noqa: E402


def _bn_inputs(x_shape, k, n, taps, device, dtype, prologue, seed=5):
    """x, w (taps, K, N), mul, add, y-shaped cotangents dy, ds1, ds2."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(*x_shape, k, generator=g)
    w = torch.randn(taps, k, n, generator=g) / (taps * k) ** 0.5
    mul = torch.rand(k, generator=g) + 0.5 if prologue else None
    add = torch.randn(k, generator=g) * 0.2 if prologue else None
    dy = torch.randn(*x_shape, n, generator=g)
    ds1, ds2 = torch.randn(n, generator=g) * 0.1, torch.randn(n, generator=g) * 0.01
    f32 = dict(device=device, dtype=torch.float32)
    return (x.to(device, dtype), w.to(device, dtype), None if mul is None else mul.to(**f32),
            None if add is None else add.to(**f32), dy.to(device, dtype), ds1.to(**f32), ds2.to(**f32))


def _close_bn(got, want, dtype, label):
    """y and dx: bf16 within one bf16 step (the fp32 sums differ in order,
    which can move one rounding), fp32 within 1e-4 of the largest (cuDNN
    may take a Winograd or FFT algorithm for the plain conv); s1 within
    1e-4 of its
    Cauchy-Schwarz bound sqrt(M s2) and s2 within 1e-4 relative (fp32 sums
    of the same accumulator); dw, dmul, dadd within 1e-2 (bf16) / 1e-4
    (fp32) of each result's largest, as for K2."""
    bf16 = dtype == torch.bfloat16
    rel = 1e-2 if bf16 else 1e-4
    for name, a, b in zip(("y", "s1", "s2", "dx", "dw", "dmul", "dadd"), got, want):
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, (label, name)
        a, b = a.double(), b.double()
        assert torch.isfinite(a).all(), (label, name)
        err = (a - b).abs()
        if name in ("y", "dx") and bf16:
            assert bool((err <= 2.0**-7 * b.abs() + 1e-6 * b.abs().max()).all()), (label, name)
        elif name == "s1":
            m = got[0][..., 0].numel()
            assert float(err.max()) <= 1e-4 * float((m * want[2].double()).sqrt().max()), (label, name)
        elif name == "s2":
            assert float(err.max()) <= 1e-4 * float(b.abs().max()), (label, name)
        else:
            assert float(err.max()) <= rel * float(b.abs().max()), (label, name)


def _run_bn(mod, x, w, mul, add, dy, ds1, ds2):
    """(y, s1, s2, dx, dw, dmul, dadd) of the kernels and of the plain
    versions on the same inputs; the backward takes the plain forward's y."""
    w_op = w[0] if mod is matmul_bn else w
    y, s1, s2 = mod.plain(x, w_op, mul, add)
    plain = (y, s1, s2, *mod.plain_bwd(x, w_op, mul, add, y, dy, ds1, ds2))
    counts = _bn_counters(mod, x.dtype)
    f0, b0 = counts()
    fwd = mod.kernel_fwd(x, w_op, mul, add)
    bwd = mod.kernel_bwd(x, w_op, mul, add, y, dy, ds1, ds2)
    torch.cuda.synchronize()
    assert counts() == (f0 + 1, b0 + 1)
    return (*fwd, *bwd), plain


def _bn_counters(mod, dtype):
    """The launch counters of the kernels ``mod`` runs for ``dtype``: the
    fp32 kernels (K5-fp32 / K6-fp32, K7-fp32 / K8-fp32) count apart from
    bf16's."""
    if dtype == torch.float32:
        return lambda: (mod.f32_launches, mod.f32_bwd_launches)
    return lambda: (mod.launches, mod.bwd_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("prologue", [False, True], ids=["plain", "prologue"])
@pytest.mark.parametrize("shape", [(1, 8, 8), (1000, 24, 40), (4160, 64, 256), (2051, 256, 72), (4097, 256, 128),
                                   (40, 128, 512), (300, 256, 1024), (333, 128, 128), (333, 120, 64), (333, 56, 128),
                                   (333, 200, 64), (300, 64, 512), (300, 512, 64), (333, 1024, 256), (333, 2048, 40),
                                   (333, 1000, 120), (131072, 256, 128), (8192, 256, 1024)],
                         ids=["m1_k8_n8", "ragged", "k64_n256", "k256_n72", "flagship_ragged_m", "m40_k128_n512",
                              "k256_n1024", "k128_n128", "k120_n64", "k56_n128", "k200_n64", "k64_n512", "k512_n64",
                              "k1024_n256", "k2048_n40", "k1000_n120", "fp32_step_m131072", "fp32_step_k256_n1024"])
def test_matmul_bn_kernels_match_plain(cuda, shape, prologue, dtype):
    """K5/K6 against plain; bf16 K5 and K6 take their TMA + wgmma kernels at
    every shape: M = 1 and M = 40 (below one 128-row tile), a ragged M with
    a flagship (K, N), K and N that are not multiples of 64 (ragged,
    k256_n72), the flagship's widest N (k256_n1024: 256-column chunks of N
    in K5, and 128-row tiles of K in K6's dw) and the conv1 of a
    ``fused_1x1``-alone step (k1024_n256). Between them the shapes run every
    instantiated bf16 kernel at a ragged M: K5's at each width 64, 128 and
    256 with w resident in shared memory and streamed with each k-block
    (k2048_n40, k1000_n120, k1024_n256: K x width(N) too large to stay);
    K6's one-pass kernel at each (KW, NW) of (64, 64), (64, 128), (128, 64),
    (128, 128), (64, 256) and (256, 64), and its dx and dw kernels at widths
    64, 128 and 256 (k64_n512 and k512_n64: one of K and N within one
    64-wide box, the other past 256, which take two kernels). fp32 runs
    K5-fp32 / K6-fp32 (3xTF32 on wgmma) at every shape, at the fp32 bars:
    each width 64 and 128 of the forward's N chunks and the dx kernel's K
    ranges, K and N off the 32-wide k-blocks (ragged, k120_n64, k56_n128,
    k200_n64, k1000_n120), and two shapes of a fp32 fused_1x1 step of
    ResNet-50 at batch 32: layer2_0's conv1 (131072 rows, dw summed over
    2048 row tiles in flushed partials) and layer3_0's conv3 (eight
    128-wide chunks of N)."""
    m, k, n = shape
    got, want = _run_bn(matmul_bn, *_bn_inputs((m,), k, n, 1, cuda, dtype, prologue))
    _close_bn(got, want, dtype, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("prologue", [False, True], ids=["plain", "prologue"])
@pytest.mark.parametrize("shape", [(1, 5, 3, 8, 16), (3, 7, 9, 32, 24), (2, 24, 18, 256, 256), (1, 16, 16, 64, 64),
                                   (5, 16, 16, 200, 136), (1, 16, 16, 256, 256), (2, 3, 5, 64, 64),
                                   (32, 8, 8, 256, 256), (3, 12, 8, 256, 256)],
                         ids=["w3", "ragged", "r152_stage3", "b1", "c200_n136", "flagship_b1", "narrow",
                              "fp32_route_8x8", "plane_12x8"])
def test_conv_bn_kernels_match_plain(cuda, shape, prologue, dtype):
    """K7/K8 against plain at shapes that cut the routes' tiles: C and N not
    multiples of 64 or 32 (c200_n136, ragged), the flagship plane at B = 1,
    an image narrower than a box (narrow: 5 x 3 in 8 x 8 boxes), W = 18 and
    3 (boxes that run past the image), the conv3 route's fp32 shape in a
    ResNet-50 step at 128x128 (fp32_route_8x8: one image a box) and a 12 x 8
    plane (a box runs past H; an odd number of boxes leaves the last
    128-pixel tile half empty). fp32 runs K7-fp32 / K8-fp32 (3xTF32 on
    wgmma) at every shape, at the fp32 bars."""
    b, h, w, c, n = shape
    got, want = _run_bn(conv_bn, *_bn_inputs((b, h, w), c, n, 9, cuda, dtype, prologue))
    _close_bn(got, want, dtype, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("mod, dtype", [(matmul_bn, torch.bfloat16), (conv_bn, torch.bfloat16),
                                        (matmul_bn, torch.float32), (conv_bn, torch.float32)],
                         ids=["k5_k6", "k7_k8", "k5_k6_fp32", "k7_k8_fp32"])
def test_bn_kernels_are_deterministic(cuda, mod, dtype):
    x_shape, taps = ((4096,), 1) if mod is matmul_bn else ((4, 16, 16), 9)
    x, w, mul, add, dy, ds1, ds2 = _bn_inputs(x_shape, 128, 128, taps, cuda, dtype, True)
    w_op = w[0] if mod is matmul_bn else w
    first = mod.kernel_fwd(x, w_op, mul, add)
    again = mod.kernel_fwd(x, w_op, mul, add)
    args = (x, w_op, mul, add, first[0], dy, ds1, ds2)
    grads, grads_again = mod.kernel_bwd(*args), mod.kernel_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip((*first, *grads), (*again, *grads_again)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 64), (512, 128), (256, 1024), (200, 72), (8, 8)],
                         ids=["k64_n64", "k512_n128", "k256_n1024", "k200_n72", "k8_n8"])
def test_matmul_bn_split_matches_plain(cuda, shape):
    """K5-fp32 / K6-fp32's pre-pass (split_w_kernel) bitwise split_planes,
    both layouts (K5-fp32's wt, K6-fp32's wn), padding included."""
    k, n = shape
    w = torch.randn(*shape, generator=torch.Generator().manual_seed(sum(shape))) * 3.0
    w_card = w.to(cuda)
    for trans in (True, False):
        want = matmul_bn.split_planes(w, trans)
        got = torch.full(want.shape, float("nan"), device=cuda)
        err = matmul_bn._fwd_lib().ihpr_matmul_bn_split(w_card.data_ptr(), got.data_ptr(), k, n, int(trans),
                                                        torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"ihpr_matmul_bn_split: CUDA error {err}"
        torch.cuda.synchronize()
        assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)), trans


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 256), (200, 72), (8, 40)], ids=["c256_n256", "c200_n72", "c8_n40"])
def test_conv_bn_split_matches_plain(cuda, shape):
    """K7-fp32 / K8-fp32's pre-pass (split_w_kernel over the nine taps in
    one launch) bitwise conv_bn.split_planes, both layouts (K7-fp32's wt,
    K8-fp32's wn), padding included."""
    c, n = shape
    w9 = torch.randn(9, c, n, generator=torch.Generator().manual_seed(c + n)) * 3.0
    w_card = w9.to(cuda)
    for trans in (True, False):
        want = conv_bn.split_planes(w9, trans)
        got = torch.full(want.shape, float("nan"), device=cuda)
        err = conv_bn._fwd_lib().ihpr_conv_bn_split(w_card.data_ptr(), got.data_ptr(), c, n, int(trans),
                                                   torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"ihpr_conv_bn_split: CUDA error {err}"
        torch.cuda.synchronize()
        assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)), trans


@pytest.mark.cuda
def test_bn_kernels_reject_what_they_do_not_take(cuda):
    x, w, mul, add, *_ = _bn_inputs((64,), 16, 16, 1, cuda, torch.bfloat16, True)
    before = matmul_bn.launches
    with pytest.raises(ValueError, match="multiples of 8"):
        matmul_bn.kernel_fwd(x[:, :12].contiguous(), w[0][:12].contiguous())
    with pytest.raises(ValueError, match="bfloat16"):
        matmul_bn.kernel_fwd(x, w[0].float())
    with pytest.raises(ValueError, match="contiguous"):
        matmul_bn.kernel_fwd(x.t().contiguous().t(), w[0])
    with pytest.raises(ValueError, match="mul and add"):
        matmul_bn.kernel_fwd(x, w[0], mul, None)
    with pytest.raises(ValueError, match="CUDA"):
        matmul_bn.kernel_fwd(x.cpu(), w[0].cpu())
    assert matmul_bn.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [(True, False), (False, True)], ids=["fused_1x1", "fused_conv3"])
def test_bottleneck_routes_run_the_kernels(cuda, flags, monkeypatch):
    """A train-mode lean-BN Bottleneck on each fused route launches its
    kernels, forward and backward, and agrees with the same block on the
    plain route (fp32 with TF32 off, so the same arithmetic; 1e-3 of the
    output's largest and 1e-2 of each gradient's largest, after BN over 128
    values)."""
    monkeypatch.setenv("IHPR_CONV3_MIN_CH", "64")
    torch.manual_seed(0)
    blocks = [resnet.Bottleneck(256, 64, 1, torch.float32, "lean", cuda, *f).train()
              .to(memory_format=torch.channels_last) for f in (flags, (False, False))]
    blocks[1].load_state_dict(blocks[0].state_dict())
    x = torch.randn(2, 8, 8, 256, device=cuda).permute(0, 3, 1, 2)
    mod = matmul_bn if flags[0] else conv_bn
    counts = _bn_counters(mod, torch.float32)
    f0, b0 = counts()
    outs = []
    with fhi.no_tf32():
        for block in blocks:
            out = block(x)
            (out * out).sum().backward()
            outs.append(out.detach())
    torch.cuda.synchronize()
    per_block = 2 if flags[0] else 1
    assert counts() == (f0 + per_block, b0 + per_block)
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-3 * float(outs[1].abs().max())
    for (name, p), q in zip(blocks[0].named_parameters(), blocks[1].parameters()):
        assert float((p.grad - q.grad).abs().max()) <= 1e-2 * float(q.grad.abs().max()), name


# --- P1/P2: the probe kernels (ihpr_tpu_torch.tools) -----------------------------

from ihpr_tpu_torch.tools import exp_probe, mxu_int8_probe  # noqa: E402

# Partials and token relative to plain's: fp32 sums of the same values in
# another order and ex2.approx within ~2 ulp; bexpsum rounds each exp's
# argument to bf16 (2^-9 of ~9, so ~2% a term, unbiased) before ex2.
PROBE_TOL = {"sum": 1e-5, "maxsum": 1e-5, "expsum": 1e-5, "exp2sum": 1e-5, "bexpsum": 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", exp_probe.MODES)
def test_exp_probe_kernel_matches_plain(cuda, mode):
    """Every mode at (2, 3*256, 1152): read bitwise, the reductions within
    PROBE_TOL of plain; two runs bitwise equal."""
    x = exp_probe.make_volume(cuda, 3, (2, 3 * 256, 1152))
    before = exp_probe.launches
    got = exp_probe.kernel(x, mode)
    assert exp_probe.launches == before + 1
    want = exp_probe.plain(x, mode)
    again = exp_probe.kernel(x, mode)
    torch.cuda.synchronize()
    for g, w, a in zip(got, want, again):
        assert g.shape == w.shape and g.dtype == torch.float32 and torch.equal(g, a)
        if mode == "read":
            assert torch.equal(g, w)
        else:
            torch.testing.assert_close(g, w, rtol=PROBE_TOL[mode], atol=0)


@pytest.mark.cuda
def test_exp_probe_read_floor_on_the_card(cuda):
    """The flagship volume's read is no faster than its bytes at 3.35 TB/s
    (``run`` checks it), and the guard raises on a read time 100x faster."""
    x = exp_probe.make_volume(cuda, 0)
    nbytes = x.numel() * 4
    results = exp_probe.run(x, iters=3)
    assert results["read"] >= exp_probe.read_floor_ms(nbytes)
    with pytest.raises(RuntimeError, match="elided"):
        exp_probe.check_read_floor(results["read"] / 100, nbytes)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
@pytest.mark.parametrize("shape", [(1024, 1024, 1024), (512, 768, 1280)], ids=["1024", "512x768x1280"])
def test_probe_mm_kernel_matches_plain(cuda, shape, dtype):
    """Every tile against plain_mm: int8 bitwise, bf16 within 1e-4 of
    max|plain| (fp32 sums of exact bf16 products in another order)."""
    m, n, k = shape
    a, b = (t.to(cuda) for t in mxu_int8_probe._mats(np.random.RandomState(0), m, n, k, dtype))
    before = mxu_int8_probe.launches
    mxu_int8_probe.check_tiles(a, b)
    assert mxu_int8_probe.launches == before + len(mxu_int8_probe.TILES[dtype])


@pytest.mark.cuda
def test_probe_wrappers_reject_what_they_do_not_take(cuda):
    x = exp_probe.make_volume(cuda, 0, (2, 512, 1152))
    before = exp_probe.launches
    with pytest.raises(ValueError, match="float32"):
        exp_probe.kernel(x.double(), "sum")
    with pytest.raises(ValueError, match="contiguous"):
        exp_probe.kernel(x.transpose(1, 2).contiguous().transpose(1, 2), "sum")
    with pytest.raises(ValueError, match="blocks"):
        exp_probe.kernel(x[:, :500].contiguous(), "sum")
    with pytest.raises(ValueError, match="CUDA"):
        exp_probe.kernel(x.cpu(), "sum")
    with pytest.raises(ValueError, match="mode"):
        exp_probe.kernel(x, "logsumexp")
    assert exp_probe.launches == before
    a, b = (t.to(cuda) for t in mxu_int8_probe._mats(np.random.RandomState(0), 256, 256, 256, torch.bfloat16))
    before = mxu_int8_probe.launches
    with pytest.raises(ValueError, match="not in the bf16 list"):
        mxu_int8_probe.kernel_mm(a, b, 128, 128, 32)
    with pytest.raises(ValueError, match="not in the bf16 list"):
        mxu_int8_probe.kernel_mm(a, b, 128, 128, 128)
    with pytest.raises(ValueError, match="not in the int8 list"):
        mxu_int8_probe.kernel_mm(a.to(torch.int8), b.to(torch.int8), 128, 128, 64)
    with pytest.raises(ValueError, match="multiple of the tile"):
        mxu_int8_probe.kernel_mm(a[:200].contiguous(), b, 128, 128, 64)
    with pytest.raises(ValueError, match="both bfloat16 or both int8"):
        mxu_int8_probe.kernel_mm(a.float(), b.float(), 128, 128, 64)
    with pytest.raises(ValueError, match="contiguous"):
        mxu_int8_probe.kernel_mm(a.t(), b, 128, 128, 64)
    with pytest.raises(ValueError, match="CUDA"):
        mxu_int8_probe.kernel_mm(a.cpu(), b.cpu(), 128, 128, 64)
    assert mxu_int8_probe.launches == before
