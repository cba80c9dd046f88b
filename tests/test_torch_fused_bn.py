"""The port's fused conv + BN-statistics training path against the JAX
package, on the CPU.

Same numpy inputs go through the JAX op (its Pallas kernel in interpret
mode, IHPR_PALLAS=interpret from conftest) and the port's op (the plain
versions of K5/K6, ``ops/matmul_bn.py``, and K7/K8, ``ops/conv_bn.py``):
forward and all four gradients in fp32 and bf16; gradcheck in fp64; the
route predicates the port copies; one Bottleneck on each fused route; one
whole fused ResNet-50 train step.

Tolerances: fp32 uses the JAX tests' own (tests/test_matmul_bn.py,
tests/test_conv_bn.py). bf16: y within one bf16 step (2^-7 of |y|: the
fp32 sums are taken in another order, which can move a rounding by one
step); s1/s2 within 1e-4 of their largest (both sum the fp32 accumulator);
gradients within 1e-2 of each result's largest (bf16 g and one rounding of
each result, as for K2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihpr_tpu import config as jconfig
from ihpr_tpu.models import resnet as jresnet
from ihpr_tpu.models.pose_net import build_pose_net as jax_build_pose_net
from ihpr_tpu.models.pose_net import init_pose_net
from ihpr_tpu.ops import conv_bn as jconv_bn
from ihpr_tpu.ops import matmul_bn as jmatmul_bn
from ihpr_tpu_torch import config as tconfig
from ihpr_tpu_torch.models import resnet
from ihpr_tpu_torch.models.convert import from_jax_params
from ihpr_tpu_torch.models.pose_net import build_pose_net
from ihpr_tpu_torch.ops import conv_bn, matmul_bn
from test_torch_models import to_port_cfg
from test_torch_train import _jax_step, _port_step, _rel_err, _train_batch

torch.set_num_threads(1)

BF16_STEP = 2.0**-7


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _cotangents(y_shape, n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*y_shape).astype(np.float32), (rng.randn(n) * 0.1).astype(np.float32),
            (rng.randn(n) * 0.01).astype(np.float32))


def _jax_run(fn, args, cts, dtype):
    """(y, s1, s2) and the gradients of sum(y*cy) + sum(s1*c1) + sum(s2*c2)
    for every argument, through the JAX op."""
    jargs = [jnp.asarray(a, dtype) for a in args[:2]] + [jnp.asarray(a) for a in args[2:]]
    outs, vjp = jax.vjp(fn, *jargs)
    grads = vjp((jnp.asarray(cts[0], dtype), jnp.asarray(cts[1]), jnp.asarray(cts[2])))
    f32 = lambda t: np.asarray(jnp.asarray(t, jnp.float32))  # noqa: E731
    return [f32(o) for o in outs], [f32(g) for g in grads]


def _port_run(fn, args, cts, dtype):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in args[:2]]
    leaves += [torch.from_numpy(a).requires_grad_() for a in args[2:]]
    y, s1, s2 = fn(*leaves)
    assert y.dtype == dtype and s1.dtype == s2.dtype == torch.float32
    torch.autograd.backward((y, s1, s2), (torch.from_numpy(cts[0]).to(dtype),
                                          torch.from_numpy(cts[1]), torch.from_numpy(cts[2])))
    outs = [t.detach().float().numpy() for t in (y, s1, s2)]
    grads = [t.grad for t in leaves]
    assert [g.dtype for g in grads[:2]] == [dtype, dtype]
    return outs, [g.float().numpy() for g in grads]


def _check_bf16(outs, ref_outs, grads, ref_grads):
    y, yr = outs[0], ref_outs[0]
    assert np.all(np.abs(y - yr) <= BF16_STEP * np.abs(yr) + 1e-6)
    for s, sr in zip(outs[1:], ref_outs[1:]):
        assert np.abs(s - sr).max() <= 1e-4 * np.abs(sr).max()
    for name, g, gr in zip(("dx", "dw", "dmul", "dadd"), grads, ref_grads):
        assert _rel_err(g.reshape(gr.shape), gr) <= 1e-2, name


# --- K5/K6: fused_matmul_bn ------------------------------------------------------


def _mm_inputs(m, k, n, prologue, seed):
    rng = np.random.RandomState(seed)
    args = [rng.randn(m, k).astype(np.float32), (rng.randn(k, n) * 0.1).astype(np.float32)]
    if prologue:
        args += [(np.abs(rng.randn(k)) + 0.5).astype(np.float32), (rng.randn(k) * 0.1).astype(np.float32)]
    return args


@pytest.mark.parametrize("prologue", [False, True], ids=["plain", "prologue"])
@pytest.mark.parametrize("shape", [(264, 64, 256), (136, 256, 64)], ids=["k64_n256", "k256_n64"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_matmul_bn_matches_jax(dtype, shape, prologue):
    """y, s1, s2 and the gradients of x, w, mul, add against the JAX op (its
    kernel in interpret mode; M = 264 and 136 are not multiples of 256).
    fp32: the JAX test's bounds (outputs atol 2e-3 rtol 2e-5, gradients
    atol 5e-2 rtol 5e-4); bf16: the module's."""
    m, k, n = shape
    args = _mm_inputs(m, k, n, prologue, seed=m + k)
    if dtype == "bfloat16":
        args[:2] = [_bf16(a) for a in args[:2]]
    assert jmatmul_bn.supported(m, k, n, 4 if dtype == "float32" else 2)
    cts = _cotangents((m, n), n, seed=1)
    ref_outs, ref_grads = _jax_run(jmatmul_bn.fused_matmul_bn, args, cts, jnp.dtype(dtype))
    outs, grads = _port_run(matmul_bn.fused_matmul_bn, args, cts, getattr(torch, dtype))
    if dtype == "bfloat16":
        _check_bf16(outs, ref_outs, grads, ref_grads)
        return
    for o, r in zip(outs, ref_outs):
        np.testing.assert_allclose(o, r, atol=2e-3, rtol=2e-5)
    for g, r in zip(grads, ref_grads):
        np.testing.assert_allclose(g, r, atol=5e-2, rtol=5e-4)


# (K, N, prologue) of every K5/K6 launch of the flagship fused train step
# (chip_smoke.py's MM_STEP).
MM_STEP_KN = [(64, 64, False), (256, 64, False), (64, 256, True), (256, 128, False), (512, 128, False),
              (128, 512, True), (512, 256, False), (256, 1024, True)]


@pytest.mark.parametrize("k, n, prologue", MM_STEP_KN, ids=[f"k{k}_n{n}" for k, n, _ in MM_STEP_KN])
def test_matmul_bn_bwd_matches_jax_at_step_shapes(k, n, prologue):
    """The backward the card's K6 is held to (``plain_bwd``) against JAX's
    ``_bwd_call`` (its Pallas kernel in interpret mode) at every (K, N,
    prologue) of the flagship fused step, bf16, M = 264 (not a multiple of
    256), on the same x, w, mul, add, y (JAX's forward), dy, ds1, ds2: dx,
    dw, dmul and dadd within 1e-2 of each result's largest (the module's
    bf16 bound)."""
    m = 264
    x, w, *mul_add = _mm_inputs(m, k, n, prologue, seed=k + n)
    mul_add = mul_add or [None, None]
    dy, ds1, ds2 = _cotangents((m, n), n, seed=2)
    jx, jw, jdy = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, dy))
    jmul, jadd = (None if a is None else jnp.asarray(a) for a in mul_add)
    jy = jmatmul_bn._fwd_call(jx, jw, jmul, jadd)[0]
    want = jmatmul_bn._bwd_call(jx, jw, jmul, jadd, jy, jdy, jnp.asarray(ds1), jnp.asarray(ds2))
    bf16 = lambda a: torch.from_numpy(np.asarray(jnp.asarray(a, jnp.float32))).to(torch.bfloat16)  # noqa: E731
    mul_add = [None if a is None else torch.from_numpy(a) for a in mul_add]
    got = matmul_bn.plain_bwd(bf16(jx), bf16(jw), *mul_add, bf16(jy), bf16(jdy), torch.from_numpy(ds1),
                              torch.from_numpy(ds2))
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    for name, g, w in zip(("dx", "dw", "dmul", "dadd"), got, want):
        if w is None:
            assert g is None, name
            continue
        assert tuple(g.shape) == tuple(w.shape), name
        assert _rel_err(g.float().numpy(), np.asarray(jnp.asarray(w, jnp.float32))) <= 1e-2, name


# ... and of the conv1 of the 5 blocks a fused_1x1-alone step adds (its conv3
# is MM_STEP's (256, 1024, True)).
MM_FWD_KN = MM_STEP_KN + [(1024, 256, False)]


@pytest.mark.parametrize("k, n, prologue", MM_FWD_KN, ids=[f"k{k}_n{n}" for k, n, _ in MM_FWD_KN])
def test_matmul_bn_fwd_matches_jax_at_step_shapes(k, n, prologue):
    """The forward the card's K5 is held to (``plain``) against JAX's
    ``_fwd_call`` (its Pallas kernel in interpret mode) at every (K, N,
    prologue) of the flagship fused step and at the ``fused_1x1``-alone
    conv1, bf16, M = 264 (not a multiple of 256), on the same x, w, mul,
    add: y within one bf16 step, s1 and s2 within 1e-4 of their largest (the
    module's bf16 bounds)."""
    m = 264
    x, w, *mul_add = _mm_inputs(m, k, n, prologue, seed=k + n)
    mul_add = mul_add or [None, None]
    jx, jw = (jnp.asarray(a, jnp.bfloat16) for a in (x, w))
    jmul, jadd = (None if a is None else jnp.asarray(a) for a in mul_add)
    want = [np.asarray(jnp.asarray(a, jnp.float32)) for a in jmatmul_bn._fwd_call(jx, jw, jmul, jadd)]
    bf16 = lambda a: torch.from_numpy(np.asarray(jnp.asarray(a, jnp.float32))).to(torch.bfloat16)  # noqa: E731
    mul_add = [None if a is None else torch.from_numpy(a) for a in mul_add]
    y, s1, s2 = matmul_bn.plain(bf16(jx), bf16(jw), *mul_add)
    assert y.dtype == torch.bfloat16 and s1.dtype == s2.dtype == torch.float32
    assert [tuple(t.shape) for t in (y, s1, s2)] == [a.shape for a in want]
    y, yr = y.float().numpy(), want[0]
    assert np.all(np.abs(y - yr) <= BF16_STEP * np.abs(yr) + 1e-6)
    for name, s, sr in (("s1", s1, want[1]), ("s2", s2, want[2])):
        assert np.abs(s.numpy() - sr).max() <= 1e-4 * np.abs(sr).max(), name


@pytest.mark.parametrize("prologue", [False, True], ids=["plain", "prologue"])
def test_fused_matmul_bn_gradcheck_float64(prologue):
    leaves = [torch.from_numpy(a.astype(np.float64)).requires_grad_()
              for a in _mm_inputs(12, 8, 16, prologue, seed=3)]
    assert torch.autograd.gradcheck(lambda *a: matmul_bn.FusedMatmulBN.apply(*a, *[None] * (4 - len(a))),
                                    leaves)


# --- K7/K8: fused_conv3x3_bn -------------------------------------------------------


def _conv_inputs(b, h, w, c, n, prologue, seed):
    rng = np.random.RandomState(seed)
    args = [(rng.randn(b, h, w, c) * 0.5).astype(np.float32), (rng.randn(3, 3, c, n) * 0.05).astype(np.float32)]
    if prologue:
        args += [rng.uniform(0.5, 1.5, c).astype(np.float32), (rng.randn(c) * 0.2).astype(np.float32)]
    return args


@pytest.mark.parametrize("prologue", [False, True], ids=["plain", "prologue"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 64, 128), (1, 4, 18, 64, 64)], ids=["8x8", "w18"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_conv3x3_bn_matches_jax(dtype, shape, prologue):
    """y, s1, s2 and the four gradients against the JAX op (its kernel in
    interpret mode; a plane with W = 18). fp32: the JAX tests' bounds (y
    atol 2e-4, s1/s2 rtol 1e-4 atol 1e-2, gradients 2e-5 in the 2-norm);
    bf16: the module's. The JAX kernel sums the fp32 accumulator, as the
    port does; its plain-XLA twin (IHPR_PALLAS=off) would sum the bf16
    output instead."""
    b, h, w, c, n = shape
    args = _conv_inputs(b, h, w, c, n, prologue, seed=h * w)
    if dtype == "bfloat16":
        args[:2] = [_bf16(a) for a in args[:2]]
    assert jconv_bn.supported(b, h, w, c, n, 1, 4 if dtype == "float32" else 2)
    cts = _cotangents((b, h, w, n), n, seed=2)
    ref_outs, ref_grads = _jax_run(jconv_bn.fused_conv3x3_bn, args, cts, jnp.dtype(dtype))
    outs, grads = _port_run(conv_bn.fused_conv3x3_bn, args, cts, getattr(torch, dtype))
    if dtype == "bfloat16":
        _check_bf16(outs, ref_outs, grads, ref_grads)
        return
    np.testing.assert_allclose(outs[0], ref_outs[0], atol=2e-4)
    for o, r in zip(outs[1:], ref_outs[1:]):
        np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-2)
    for name, g, r in zip(("dx", "dw", "dmul", "dadd"), grads, ref_grads):
        assert np.linalg.norm(g - r) / np.linalg.norm(r) < 2e-5, name


@pytest.mark.parametrize("prologue", [False, True], ids=["plain", "prologue"])
def test_fused_conv3x3_bn_gradcheck_float64(prologue):
    args = _conv_inputs(1, 3, 4, 8, 8, prologue, seed=4)
    leaves = [torch.from_numpy(a.astype(np.float64)).requires_grad_() for a in args]
    leaves[1] = leaves[1].detach().reshape(9, 8, 8).requires_grad_()
    assert torch.autograd.gradcheck(lambda *a: conv_bn.FusedConv3x3BN.apply(*a, *[None] * (4 - len(a))),
                                    leaves)


def test_kernels_take_cuda_tensors_only():
    """On CPU tensors the kernel wrappers raise before anything launches."""
    x, w = (torch.from_numpy(a) for a in _mm_inputs(16, 8, 8, False, seed=5))
    matmul_bn.launches = conv_bn.launches = 0
    with pytest.raises(ValueError, match="CUDA"):
        matmul_bn.kernel_fwd(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        conv_bn.kernel_fwd(x.view(1, 4, 4, 8), w.view(1, 8, 8).expand(9, 8, 8).contiguous())
    assert matmul_bn.launches == conv_bn.launches == 0


def test_conv_bn_kernel_bwd_takes_cuda_tensors_only():
    """K8's launcher raises on CPU tensors before it asks the library for
    scratch sizes or counts a launch."""
    x, w, mul, add = (torch.from_numpy(a) for a in _conv_inputs(1, 4, 4, 8, 8, True, seed=6))
    w9 = w.reshape(9, 8, 8).contiguous()
    y = dy = torch.zeros(1, 4, 4, 8)
    ds = torch.zeros(8)
    conv_bn.bwd_launches = 0
    with pytest.raises(ValueError, match="CUDA"):
        conv_bn.kernel_bwd(x, w9, mul, add, y, dy, ds, ds)
    assert conv_bn.bwd_launches == 0


# --- the route predicates --------------------------------------------------------------


def _bottleneck_shapes(resnet_type, batch, size):
    """(cin, e, stride, b, h, w) of each Bottleneck of ResNet-resnet_type at
    an input of ``size`` (h, w): the stem and max-pool divide by 4."""
    _, depths, _ = jresnet.RESNET_SPECS[resnet_type]
    h, w = size[0] // 4, size[1] // 4
    cin, out = 64, []
    for stage, (width, depth) in enumerate(zip(jresnet._STAGE_WIDTHS, depths)):
        for i in range(depth):
            stride = 2 if (stage > 0 and i == 0) else 1
            out.append((f"layer{stage + 1}_{i}", cin, width, stride, batch, h, w))
            h, w = (h + 1) // 2 if stride == 2 else h, (w + 1) // 2 if stride == 2 else w
            cin = width * 4
    return out


def test_route_predicates_match_jax():
    """supported (both ops) and profitable equal JAX's on every Bottleneck
    shape of ResNet-50 and -152 at batch 1, 2, 32, 128 and inputs 256x256,
    384x288, 64x64, for bf16 and fp32, including conv3's shape inside a
    fused-1x1 block."""
    checked = 0
    for rt in (50, 152):
        for batch in (1, 2, 32, 128):
            for size in ((256, 256), (384, 288), (64, 64)):
                for _, cin, e, stride, b, h, w in _bottleneck_shapes(rt, batch, size):
                    h2, w2 = (h + 1) // 2 if stride == 2 else h, (w + 1) // 2 if stride == 2 else w
                    assert conv_bn.profitable(e, e) == jconv_bn.profitable(e, e)
                    for item in (2, 4):
                        for args in ((b * h * w, cin, e, item), (b * h2 * w2, e, 4 * e, item)):
                            assert matmul_bn.supported(*args) == jmatmul_bn.supported(*args), args
                        args = (b, h, w, e, e, stride, item)
                        assert conv_bn.supported(*args) == jconv_bn.supported(*args), args
                        checked += 1
    assert checked == 2 * 4 * 3 * (16 + 50)


def _flagship_launches(fused_1x1, fused_conv3, itemsize=2, batch=128, size=(256, 256)):
    """(K5, K6, K7, K8) launches of one ResNet-50 train step at ``size`` (the
    flagship h36m3d_r50: bf16, batch 128, 256x256; h36m3d_r50_fp32: itemsize
    4, batch 32) from the port's predicates, routed as Bottleneck._route: a
    block whose conv1 shape JAX fuses runs K5 twice (conv1, conv3) and K6
    twice. JAX's fused_matmul_bn checks each conv on its own and sends a
    conv3 whose shape is not ``supported`` to ``_reference`` (plain XLA):
    in fp32 layer3_0's conv3 at (8192, 256, 1024), which the port runs on
    K5-fp32 / K6-fp32 all the same (the same function)."""
    k5 = k7 = 0
    for _, cin, e, stride, b, h, w in _bottleneck_shapes(50, batch, size):
        if (fused_conv3 and stride == 1 and conv_bn.profitable(e, e)
                and conv_bn.supported(b, h, w, e, e, 1, itemsize)):
            k7 += 1
        elif fused_1x1 and matmul_bn.supported(b * h * w, cin, e, itemsize):
            k5 += 2
    return k5, k5, k7, k7


@pytest.mark.parametrize("itemsize, batch, size, want", [
    (2, 128, (256, 256), {(True, True): (16, 16, 5, 5), (True, False): (26, 26, 0, 0), (False, True): (0, 0, 5, 5)}),
    (4, 32, (256, 256), {(True, True): (16, 16, 0, 0), (True, False): (16, 16, 0, 0), (False, True): (0, 0, 0, 0)}),
    (4, 32, (128, 128), {(True, True): (16, 16, 5, 5), (True, False): (16, 16, 0, 0), (False, True): (0, 0, 5, 5)}),
], ids=["bf16_b128", "fp32_b32", "fp32_b32_128x128"])
def test_flagship_launch_counts(itemsize, batch, size, want):
    """bf16 at batch 128, both flags: layer1_0 ... layer3_0 on the 1x1
    route, layer3_1 ... layer3_5 on the conv3 route, stage 4 plain;
    fused_1x1 alone: 13 blocks. fp32 at batch 32 (h36m3d_r50_fp32, the
    smoke's fp32-fused phase 7m): the 1x1 route takes layer1_0 ... layer3_0
    with or without fused_conv3. The conv3 route must fit one image's plane
    into JAX's 6 MiB VMEM budget beside the nine fp32 weight blocks (4.72 MB
    at e = 256), which leaves at most 127 pixel rows: it takes no block at
    256x256 (stage 3's planes are 16x16), and at 128x128 (phase 7n) stage
    3's 8x8 planes, layer3_1 ... layer3_5, 5 launches of K7/K8-fp32 a
    step; stage 4 (e = 512) never."""
    for flags, counts in want.items():
        assert _flagship_launches(*flags, itemsize=itemsize, batch=batch, size=size) == counts, flags


# --- K5-fp32 / K6-fp32: the split pre-pass and dw's flush schedule ------------------


def _tf32_np(x):
    """float32 x rounded to TF32 in numpy: to nearest, ties away from zero,
    at bit 13 (the low 13 bits cleared)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _split_np(x):
    hi = _tf32_np(x)
    return hi, _tf32_np((x - hi).astype(np.float32))


@pytest.mark.parametrize("shape", [(64, 64), (200, 72), (8, 40)], ids=["k64_n64", "k200_n72", "k8_n40"])
def test_matmul_bn_split_planes_match_numpy(shape):
    """split_planes (the plain twin of K5-fp32 / K6-fp32's pre-pass) bitwise
    a numpy rendering: TF32 hi and lo of every weight, K5-fp32's wt (rows
    n, over K) and K6-fp32's wn (rows k, over N), the contraction padded
    with zeros to a multiple of 32 and each 32-long run in k-step order:
    slot q of k-step s holds index 8 (q % 4) + 2 s + q // 4."""
    k, n = shape
    w = (np.random.RandomState(k + n).randn(k, n) * 3.0).astype(np.float32)
    slot = [8 * (q % 4) + 2 * s + q // 4 for s in range(4) for q in range(8)]
    for trans, src in ((True, w.T), (False, w)):
        rows, length = src.shape
        padded = np.zeros((rows, -(-length // 32) * 32), np.float32)
        padded[:, :length] = src
        order = [32 * (p // 32) + slot[p % 32] for p in range(padded.shape[1])]
        want = np.stack(_split_np(padded[:, order]))
        got = matmul_bn.split_planes(torch.from_numpy(w), trans).numpy()
        assert got.shape == want.shape and np.array_equal(got.view(np.uint32), want.view(np.uint32)), trans


@pytest.mark.parametrize("shape", [(64, 64), (200, 72), (8, 40)], ids=["c64_n64", "c200_n72", "c8_n40"])
def test_conv_bn_split_planes_match_numpy(shape):
    """conv_bn.split_planes (the plain twin of K7-fp32 / K8-fp32's pre-pass
    over the nine taps) bitwise a numpy rendering: tap t's planes at [t],
    TF32 hi and lo of every weight of w_t, K7-fp32's wt (rows n, over C)
    and K8-fp32's wn (rows c, over N), the contraction padded with zeros to
    a multiple of 32 and each 32-long run in k-step order."""
    c, n = shape
    w9 = (np.random.RandomState(c + n).randn(9, c, n) * 3.0).astype(np.float32)
    slot = [8 * (q % 4) + 2 * s + q // 4 for s in range(4) for q in range(8)]
    for trans in (True, False):
        want = []
        for t in range(9):
            src = w9[t].T if trans else w9[t]
            rows, length = src.shape
            padded = np.zeros((rows, -(-length // 32) * 32), np.float32)
            padded[:, :length] = src
            order = [32 * (p // 32) + slot[p % 32] for p in range(padded.shape[1])]
            want.append(np.stack(_split_np(padded[:, order])))
        want = np.stack(want)
        got = conv_bn.split_planes(torch.from_numpy(w9), trans).numpy()
        assert got.shape == want.shape and np.array_equal(got.view(np.uint32), want.view(np.uint32)), trans


def _rz32(x):
    """float64 x to float32, rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _dw_3xtf32(a, g, flush_rows):
    """dw = a^T g as K6-fp32's dw_kernel sums it on the tensor cores: per
    8-row k-step three TF32 products (lo hi, hi lo, hi hi), each added to
    the fp32 accumulator with its 8 terms exact and the add truncated (the
    tensor cores' fp32 accumulation rounds toward zero); every
    ``flush_rows`` rows (0: never) the accumulator is added to an fp32
    partial with round to nearest and starts again from 0."""
    ah, al = _split_np(a)
    gh, gl = _split_np(g)
    acc = np.zeros((a.shape[1], g.shape[1]), np.float32)
    part = np.zeros_like(acc)
    for r in range(0, a.shape[0], 8):
        for x, y in ((al, gh), (ah, gl), (ah, gh)):
            acc = _rz32(acc.astype(np.float64) + x[r:r + 8].T.astype(np.float64) @ y[r:r + 8].astype(np.float64))
        if flush_rows and (r + 8) % flush_rows == 0:
            part, acc = part + acc, np.zeros_like(acc)
    return part + acc


def test_dw_flush_schedule_holds_the_fp32_bar():
    """dw's longest sum, 131072 rows (the 64x64 maps of layer1 at batch 32
    in one row range), at a narrow K x N: emulated 3xTF32 with the kernel's
    flush every kFlush = 16 tiles of 64 rows lands within 1e-4 of float64
    (of dw's largest, K6's fp32 bar), while one accumulator over all rows
    drifts past it. a is a prologue's output (relu, >= 0) and g has the
    mean ds1 gives it, so the running sums grow with the rows."""
    rng = np.random.RandomState(20)
    m, k, n = 131072, 8, 8
    a = np.maximum(rng.randn(m, k) * 0.8 + 0.2, 0).astype(np.float32)
    g = (rng.randn(m, n) + 0.5).astype(np.float32)
    want = a.astype(np.float64).T @ g.astype(np.float64)
    scale = np.abs(want).max()
    flushed = np.abs(_dw_3xtf32(a, g, 16 * 64) - want).max() / scale
    whole = np.abs(_dw_3xtf32(a, g, 0) - want).max() / scale
    assert flushed <= 1e-4 < whole, (flushed, whole)


def test_conv_dw_flush_schedule_holds_the_fp32_bar():
    """K8-fp32's dw sums one tap over a CTA's range of 64-pixel box tiles
    and flushes every kFlush = 16 of them, as K6-fp32's dw. Its longest
    range on the smoke's paths is 32768 pixels, every box tile of (128, 16,
    16) in one range (dw_ranges is 1 where the 9 taps x channel blocks fill
    the card): emulated 3xTF32 with that flush lands within 1e-4 of float64
    (of dw's largest, the fp32 bar), a the shifted prologue output (zero at
    the SAME padding) and g with the mean ds1 gives it."""
    rng = np.random.RandomState(21)
    m, k, n = 32768, 8, 8
    a = np.maximum(rng.randn(m, k) * 0.8 + 0.2, 0).astype(np.float32)
    a[rng.rand(m) < 1 / 16] = 0.0  # pixels whose shifted source lies outside the image
    g = (rng.randn(m, n) + 0.5).astype(np.float32)
    want = a.astype(np.float64).T @ g.astype(np.float64)
    flushed = np.abs(_dw_3xtf32(a, g, 16 * 64) - want).max() / np.abs(want).max()
    assert flushed <= 1e-4, flushed


# --- one Bottleneck on each route --------------------------------------------------------


def _block_state(params, stats):
    sd = {}
    for name, sub in params.items():
        if "kernel" in sub:
            sd[f"{name}.weight"] = torch.from_numpy(np.asarray(sub["kernel"]).transpose(3, 2, 0, 1).copy())
            continue
        bn, st = sub["BatchNorm_0"], stats[name]["BatchNorm_0"]
        for key, val in (("weight", bn["scale"]), ("bias", bn["bias"]),
                         ("running_mean", st["mean"]), ("running_var", st["var"])):
            sd[f"{name}.{key}"] = torch.from_numpy(np.asarray(val).copy())
    return sd


def _count_plain_calls(monkeypatch):
    calls = {"1x1": 0, "conv3": 0}

    def counting(mod, key):
        orig = mod.plain

        def run(*a, **kw):
            calls[key] += 1
            return orig(*a, **kw)

        monkeypatch.setattr(mod, "plain", run)

    counting(matmul_bn, "1x1")
    counting(conv_bn, "conv3")
    return calls


@pytest.mark.parametrize("flags", [(True, False), (False, True), (True, True)],
                         ids=["fused_1x1", "fused_conv3", "both"])
def test_bottleneck_fused_routes_match_jax(flags, monkeypatch):
    """One fp32 Bottleneck (e = 128, 8x8, batch 2, lean BN, train mode;
    IHPR_CONV3_MIN_CH lowered to 128 as the JAX test does) on the same
    parameters in both packages: the output (atol 1e-4, rtol 1e-5, the
    bound of tests/test_matmul_bn.py), the running statistics (1e-5), and
    the gradients of sum(out^2) in the 2-norm relative to all of them
    (5e-5, the bound of tests/test_conv_bn.py). With both flags the conv3
    route wins, as in JAX."""
    monkeypatch.setenv("IHPR_CONV3_MIN_CH", "128")
    fused_1x1, fused_conv3 = flags
    e = 128
    x = (np.random.RandomState(0).randn(2, 8, 8, 4 * e) * 0.5).astype(np.float32)
    jblock = jresnet.Bottleneck(e, 1, jnp.float32, bn_mode="lean", fused_1x1=fused_1x1,
                                fused_conv3=fused_conv3)
    variables = jresnet.Bottleneck(e, 1, jnp.float32, bn_mode="lean").init(jax.random.key(0), x, True)
    params, stats = variables["params"], variables["batch_stats"]

    def jloss(p):
        out, upd = jblock.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), True,
                                mutable=["batch_stats"])
        return jnp.sum(out * out), (out, upd["batch_stats"])

    (_, (ref, ref_stats)), ref_grads = jax.value_and_grad(jloss, has_aux=True)(params)

    block = resnet.Bottleneck(4 * e, e, 1, torch.float32, "lean", fused_1x1=fused_1x1,
                              fused_conv3=fused_conv3)
    block.load_state_dict(_block_state(params, stats))
    block.train()
    calls = _count_plain_calls(monkeypatch)
    out = block(torch.from_numpy(x).permute(0, 3, 1, 2))
    (out * out).sum().backward()
    assert calls == ({"1x1": 0, "conv3": 1} if fused_conv3 else {"1x1": 2, "conv3": 0})
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-4, rtol=1e-5)
    got_stats = {k: v.numpy() for k, v in block.state_dict().items() if "running" in k}
    want_stats = {k: v.numpy() for k, v in _block_state(params, ref_stats).items() if "running" in k}
    for k, v in got_stats.items():
        np.testing.assert_allclose(v, want_stats[k], atol=1e-5, rtol=1e-5, err_msg=k)
    want = _block_state(ref_grads, {k: {"BatchNorm_0": {"mean": 0.0, "var": 0.0}} for k in ref_grads})
    num = den = 0.0
    for k, p in block.named_parameters():
        num += float(np.sum((p.grad.numpy() - want[k].numpy()) ** 2))
        den += float(np.sum(want[k].numpy() ** 2))
    assert (num / den) ** 0.5 < 5e-5


# --- the model around the routes ----------------------------------------------------------


def test_fused_flags_keep_the_state_dict(monkeypatch):
    """build_pose_net with either fused flag has the same state_dict keys
    and shapes as without it (the seeded init, which does not depend on the
    flags, is skipped)."""
    from ihpr_tpu_torch.models import convert

    monkeypatch.setattr(convert, "init_state_dict", lambda model, *a: model.state_dict())
    base = tconfig.get_config("h36m3d_r50")
    plain = {k: v.shape for k, v in build_pose_net(base, device="cpu").state_dict().items()}
    for flags in ({"fused_1x1": True}, {"fused_conv3": True}, {"fused_1x1": True, "fused_conv3": True}):
        cfg = base.replace(model=dataclasses.replace(base.model, **flags))
        got = build_pose_net(cfg, device="cpu").state_dict()
        assert {k: v.shape for k, v in got.items()} == plain, flags


@pytest.fixture(scope="module")
def fused_r50():
    """A JAX h36m3d_r50-shaped config with both fused flags (ResNet-50,
    64x64, batch 2, fp32 "highest", lean BN) and its JAX init, the final
    conv redrawn so the heatmaps are not flat."""
    jcfg = jconfig.get_config("h36m3d_r50").replace(
        model=jconfig.ModelConfig(resnet_type=50, matmul_precision="highest", bn_mode="lean",
                                  fused_1x1=True, fused_conv3=True),
        data=jconfig.DataConfig(trainset=("Human36M",), testset="Human36M", input_shape=(64, 64),
                                output_shape=(16, 16), depth_dim=16),
        optim=jconfig.OptimConfig(batch_size_per_device=2, lr=1e-3),
        parallel=jconfig.ParallelConfig(data_axis_size=1),
    )
    params, stats = init_pose_net(jax_build_pose_net(jcfg), jax.random.key(7), jcfg.data.input_shape)
    params, stats = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats)
    final = params["head"]["final"]
    final["kernel"] = (np.random.RandomState(8).randn(*final["kernel"].shape) * 0.05).astype(np.float32)
    return jcfg, params, stats


def test_from_jax_params_loads_a_fused_jax_init(fused_r50):
    """A JAX PoseNet initialized with both fused flags (its _ConvParam /
    _SumBN tree is the plain tree) loads into the fused port model."""
    jcfg, params, stats = fused_r50
    cfg = to_port_cfg(jcfg)
    model = build_pose_net(cfg, device="cpu")
    sd = from_jax_params(params, stats, cfg)
    model.load_state_dict(sd)
    assert set(sd) == set(model.state_dict())
    np.testing.assert_array_equal(
        model.backbone.layer3_1.conv2.weight.detach().numpy(),
        params["backbone"]["layer3_1"]["conv2"]["kernel"].transpose(3, 2, 0, 1),
    )


def _grads_only(step):
    return {k: np.float64(v) for k, v in step["grads"].items() if "running" not in k}


def test_fused_r50_train_step_matches_jax(fused_r50, monkeypatch):
    """One whole train step of the fused_r50 config (both flags) against
    JAX's with its fused routes on their plain-XLA twins (IHPR_PALLAS=off:
    the same arithmetic at fp32). layer3_1 ... layer3_5 take the conv3
    route, every earlier block the 1x1 route, stage 4 neither.

    The loss is held to PERF.md's 1e-5. PERF.md's per-tensor gradient bound
    (2e-4) holds for no two fp32 steps at this size: train-mode BN over as
    few as 8 values per channel, 53 times over, amplifies fp32 reordering,
    so JAX's own fused and unfused steps differ by 5.9% of the global
    gradient norm here (up to 44% of a tensor's largest gradient). So the
    gradients are held to the JAX package's own bound for a fused
    ResNet-50 step (tests/test_matmul_bn.py:test_fused_dp8_matches_single_device:
    each tensor's error below 0.1 of max(its norm, 1e-2 of the global
    norm)), and the port's global distance from JAX's fused step must not
    exceed the distance between JAX's fused and unfused steps."""
    monkeypatch.setenv("IHPR_PALLAS", "off")
    jcfg, params, stats = fused_r50
    batch = _train_batch()
    ref = _jax_step(jcfg, params, stats, batch)
    unfused = dataclasses.replace(jcfg.model, fused_1x1=False, fused_conv3=False)
    spread = _grads_only(_jax_step(jcfg.replace(model=unfused), params, stats, batch))
    calls = _count_plain_calls(monkeypatch)
    got = _port_step(to_port_cfg(jcfg), params, stats, batch)
    # _port_step runs one train-mode forward for its coords, then the step.
    assert calls == {"1x1": 2 * 2 * 8, "conv3": 2 * 5}
    assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    want = _grads_only(ref)
    assert set(got["grads"]) == set(want)
    gnorm = np.sqrt(sum(np.sum(v * v) for v in want.values()))
    dist = lambda a: np.sqrt(sum(np.sum((a[k] - want[k]) ** 2) for k in want))  # noqa: E731
    for k, g in got["grads"].items():
        assert np.linalg.norm(g - want[k]) < 0.1 * max(np.linalg.norm(want[k]), 1e-2 * gnorm), k
    assert dist(got["grads"]) <= dist(spread)
