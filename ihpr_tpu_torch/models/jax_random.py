"""The JAX package's initial weights, drawn in numpy: ``jax.random`` (threefry
2x32, the partitionable layout), flax's per-parameter keys and the
initializers the JAX package uses, computed as JAX and XLA on a CPU compute
them: bit for bit for keys and bits, and for all but a few values in ten
thousand of the float draws, which land within a few ulp.

One seed then gives one model in both packages: ``jax_init_params(cfg,
joint_num, split(key(seed))[1])`` is what ``flax``'s ``PoseNet.init`` gives
JAX's ``Trainer`` (``ihpr_tpu/engine/trainer.py:126-130``), as numpy trees in
flax's layout, which ``models.convert.from_jax_params`` maps onto the port.

Nothing here imports JAX or flax: the port's hosts have neither.

- A key is the (2,) uint32 data of ``jax.random.key(seed)`` (threefry).
- ``split`` / ``fold_in`` / ``bits``: ``jax_threefry_partitionable`` on (the
  default of jax 0.5 and later): the i-th of n values hashes the 64-bit
  counter i as (hi, lo) words.
- ``uniform``: ``floats * (maxval - minval) + minval`` in one fused
  multiply-add, as XLA's CPU backend contracts it.
- ``normal`` / ``truncated_normal``: ``sqrt(2) * erf_inv(u)`` with XLA's
  float32 ``erf_inv`` (Giles' polynomial, its Horner steps fused
  multiply-adds) and ``log1p`` (Cephes' rational below sqrt(2) - 1, else
  Cephes' ``logf`` as XLA's CPU backend vectorizes it); ``truncated_normal``'s bounds through a float32 ``erf``
  that gives XLA's values there.
- flax folds a parameter's scope path and its counter in the scope into the
  init key once: sha1 of the names (and the counter's big-endian bytes),
  ``fold_in`` of the digest's first 4 bytes (``flax/core/scope.py``
  ``_fold_in_static``; ``flax_fix_rng_separator`` puts a zero byte before
  each name, off by default).
"""

from __future__ import annotations

import functools
import hashlib
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Sequence, Tuple, Union

import numpy as np

# flax's ``flax_fix_rng_separator`` default (flax 0.12).
FIX_RNG_SEPARATOR = False

_U32 = np.uint32
_F32 = np.float32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# Values drawn per chunk: a chunk's temporaries stay in cache, and chunks
# run on a thread pool (numpy releases the GIL in its ufunc loops).
_CHUNK = 1 << 18


def _threads() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``'s key data: the seed as a 64-bit integer
    split into (high, low) uint32 words. With JAX's default 32-bit mode the
    seed is first taken modulo 2^32 as an int32, so the high word is 0."""
    seed = int(seed)
    low = np.int64(seed).astype(np.int32)  # wraps as jnp.asarray(np.int64(seed)) does in 32-bit mode
    return np.array([0, np.uint32(low.view(np.uint32))], dtype=_U32)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(k: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The threefry 2x32 hash (20 rounds) of the words (x0, x1) under key
    ``k``, elementwise over uint32 arrays (``jax._src.prng._threefry2x32_lowering``)."""
    k0, k1 = _U32(k[0]), _U32(k[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, _U32) + ks[0]
        x1 = np.asarray(x1, _U32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 += x1
                x1 = _rotl(x1, r)
                x1 ^= x0
            x0 += ks[(i + 1) % 3]
            x1 += ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def _counters(start: int, stop: int) -> Tuple[np.ndarray, np.ndarray]:
    i = np.arange(start, stop, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(_U32), (i & np.uint64(0xFFFFFFFF)).astype(_U32)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) keys, the i-th the hash of
    counter i."""
    b0, b1 = threefry2x32(k, *_counters(0, num))
    return np.stack([b0, b1], axis=1)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the hash of (0, data)."""
    b0, b1 = threefry2x32(k, np.array([0], _U32), np.array([int(data) & 0xFFFFFFFF], _U32))
    return np.array([b0[0], b1[0]], dtype=_U32)


def _fill(jobs) -> None:
    """For each ``(out, fn)`` of ``jobs`` (``out`` flat), ``out[s:e] =
    fn(s, e)`` over ``out`` in chunks, every job's chunks on one thread
    pool."""
    chunks = [(out, s, min(s + _CHUNK, out.size), fn) for out, fn in jobs for s in range(0, out.size, _CHUNK)]

    def run(chunk):
        out, start, stop, fn = chunk
        out[start:stop] = fn(start, stop)

    if len(chunks) == 1:
        run(chunks[0])
    else:
        with ThreadPoolExecutor(_threads()) as pool:
            list(pool.map(run, chunks))


def _draw(fn, shape: Sequence[int], dtype) -> np.ndarray:
    """``fn(start, stop)``'s values of the flat indices of ``shape``."""
    out = np.empty(math.prod(shape), dtype)
    _fill([(out, fn)])
    return out.reshape(shape)


def _bits_range(k: np.ndarray, start: int, stop: int) -> np.ndarray:
    b0, b1 = threefry2x32(k, *_counters(start, stop))
    return b0 ^ b1


def bits(k: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(key, shape)`` (uint32): the two hash words of each
    flat index, xor'd."""
    return _draw(functools.partial(_bits_range, k), shape, _U32)


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once (the product is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(_F32)


def _uniform_from_bits(b: np.ndarray, minval, maxval) -> np.ndarray:
    lo, hi = _F32(minval), _F32(maxval)
    floats = ((b >> _U32(9)) | _U32(0x3F800000)).view(_F32) - _F32(1.0)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


def uniform(k: np.ndarray, shape: Sequence[int], minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    return _draw(lambda s, e: _uniform_from_bits(_bits_range(k, s, e), minval, maxval), shape, _F32)


def _horner(x: np.ndarray, coeffs) -> np.ndarray:
    """XLA's ``EvaluatePolynomial``: Horner from the highest coefficient,
    each step a fused multiply-add."""
    p = np.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, _F32(c))
    return p


# XLA's log1p: x + (-x^2 / 2 + x^3 P(x) / Q(x)) below |x| = sqrt(2) - 1 (Cephes),
# else log(1 + x).
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
              2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
              3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1)
# XLA's vectorized float32 log on the CPU (Cephes' logf as Eigen writes it).
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
          -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def _log(x: np.ndarray) -> np.ndarray:
    """float32 log of positive normal ``x``: the mantissa in [0.5, 1), then
    Cephes' polynomial in three interleaved Horner chains."""
    b = x.view(_U32)
    e = _F32(1.0) + ((b >> _U32(23)).astype(np.int32) - 127).astype(_F32)
    m = ((b & _U32(0x807FFFFF)) | _U32(0x3F000000)).view(_F32)
    small = m < _F32(0.707106781186547524)
    t = (m - _F32(1.0)) + np.where(small, m, _F32(0.0))
    e = e - np.where(small, _F32(1.0), _F32(0.0))
    t2 = t * t
    t3 = t2 * t
    p = [_F32(c) for c in _LOG_P]
    y = _fma(_fma(t, p[0], p[1]), t, p[2])
    y1 = _fma(_fma(t, p[3], p[4]), t, p[5])
    y2 = _fma(_fma(t, p[6], p[7]), t, p[8])
    y = _fma(_fma(y, t3, y1), t3, y2) * t3
    y = y + _F32(-2.12194440e-4) * e
    t = t - _F32(0.5) * t2
    return (t + y) + _F32(0.693359375) * e


def log1p(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``log1p`` on the CPU, for x in (-1, 1)."""
    x = np.asarray(x, _F32)
    x2 = x * x
    small = _fma(_F32(-0.5), x2, (x * x2) * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN))) + x
    with np.errstate(divide="ignore", invalid="ignore"):
        large = _log(np.maximum(_F32(1.0) + x, np.finfo(_F32).tiny))
    return np.where(np.abs(x) < _F32(0.41421356237309504880), small, large)


# XLA's float32 erf_inv (Giles, "Approximating the erfinv function"):
# coefficients for w = -log1p(-x^2) below 5 and at or above it.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
               -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
               -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv``: Giles' polynomial in Horner form, each step
    one fused multiply-add; +-inf at +-1."""
    x = np.asarray(x, _F32)
    w = -log1p(x * -x)
    lt = w < _F32(5.0)
    w = np.where(lt, w - _F32(2.5), np.sqrt(w) - _F32(3.0))
    coef = [np.where(lt, _F32(a), _F32(b)) for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coef[0]
    for c in coef[1:]:
        p = _fma(p, w, c)
    with np.errstate(over="ignore"):
        return np.where(np.abs(x) == _F32(1.0), x * _F32(np.finfo(_F32).max), p * x)


# float32 erf as a rational approximation (Eigen's fast erf, the form XLA's
# CPU backend emits): odd numerator and even denominator in x^2, +-1 past
# |x| = 3.8325.
_ERF_ALPHA = (0.00022905065861350646, 0.0034082910107109506, 0.050955695062380861, 0.18520832239976145,
              1.128379143519084)
_ERF_BETA = (-1.1791602954361697e-7, 0.000023547966471313185, 0.0010179625278914885, 0.014070470171167667,
             0.11098505178285362, 0.49746925110067538, 1.0)


def erf(x) -> np.ndarray:
    """float32 ``erf``, Horner steps as fused multiply-adds. Bitwise XLA's at
    +-2 / sqrt(2), the bounds ``truncated_normal`` takes for the
    initializers; elsewhere within 3e-7 of it (not bitwise everywhere)."""
    x = np.asarray(x, _F32)
    x2 = x * x

    def poly(coeffs):
        p = np.full_like(x2, _F32(coeffs[0]))
        for c in coeffs[1:]:
            p = _fma(p, x2, _F32(c))
        return p

    r = (x * poly(_ERF_ALPHA)) / poly(_ERF_BETA)
    return np.where(np.abs(x) >= _F32(3.832506856900711), np.copysign(_F32(1.0), x), r)


_SQRT2 = _F32(np.sqrt(2))


def _normal_range(k: np.ndarray, start: int, stop: int) -> np.ndarray:
    lo = np.nextafter(_F32(-1.0), _F32(0.0))
    return _SQRT2 * erf_inv(_uniform_from_bits(_bits_range(k, start, stop), lo, _F32(1.0)))


def _truncated_range(k: np.ndarray, lower: float, upper: float, start: int, stop: int) -> np.ndarray:
    lower, upper = _F32(lower), _F32(upper)
    a, b = erf(lower / _SQRT2), erf(upper / _SQRT2)
    out = _SQRT2 * erf_inv(_uniform_from_bits(_bits_range(k, start, stop), a, b))
    return np.clip(out, np.nextafter(lower, _F32(np.inf)), np.nextafter(upper, _F32(-np.inf)))


def normal(k: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32."""
    return _draw(functools.partial(_normal_range, k), shape, _F32)


def truncated_normal(k: np.ndarray, lower: float, upper: float, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.truncated_normal(key, lower, upper, shape)`` in float32."""
    return _draw(functools.partial(_truncated_range, k, lower, upper), shape, _F32)


Foldable = Union[str, int]


def fold_in_static(k: np.ndarray, data: Sequence[Foldable], fix_separator: bool = FIX_RNG_SEPARATOR) -> np.ndarray:
    """flax's ``_fold_in_static``: ``fold_in`` of the first 4 bytes
    (big-endian) of the sha1 of ``data``'s names (utf-8) and integers
    (minimal big-endian bytes), each after a zero byte with
    ``fix_separator``. Empty ``data`` leaves the key as it is."""
    if not data:
        return k
    m = hashlib.sha1()
    for x in data:
        if fix_separator:
            m.update(b"\x00")
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"expected int or str, got {x!r}")
    return fold_in(k, int.from_bytes(m.digest()[:4], byteorder="big"))


def param_key(root: np.ndarray, path: Sequence[str], counter: int) -> np.ndarray:
    """The key flax's ``init`` hands the ``counter``-th (from 1) parameter
    created in the scope at ``path`` (module names from the root)."""
    return fold_in_static(root, (*path, counter))


# The initializers of the JAX package (``flax.linen.initializers``).

# Std of a standard normal truncated to [-2, 2]; lecun_normal divides by it
# so the truncated draw keeps variance 1 / fan_in.
TRUNC_STD = 0.87962566103423978


def _lecun_std(shape: Sequence[int]) -> np.float32:
    return np.sqrt(_F32(1.0 / math.prod(shape[:-1]))) / _F32(TRUNC_STD)


def lecun_normal(k: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``lecun_normal()``: variance 1 / fan_in (fan_in = the product of every
    axis but the last, as for a (kh, kw, in, out) kernel), truncated at 2
    std and divided by the truncated normal's std."""
    return truncated_normal(k, -2.0, 2.0, shape) * _lecun_std(shape)


def normal_init(k: np.ndarray, shape: Sequence[int], stddev: float) -> np.ndarray:
    """``normal(stddev)``."""
    return normal(k, shape) * _F32(stddev)


def zeros(shape: Sequence[int]) -> np.ndarray:
    return np.zeros(shape, _F32)


def ones(shape: Sequence[int]) -> np.ndarray:
    return np.ones(shape, _F32)


# The JAX package's PoseNet: its parameter tree as ``init_pose_net`` walks it.

Tree = Dict[str, Union["Tree", np.ndarray]]


class _Init:
    """Builds ``params`` / ``batch_stats`` trees, each parameter drawn from its
    flax key. Every scope here creates its parameters in the order flax's
    modules do (kernel then bias; scale then bias), and only BN scopes hold
    statistics. The draws are queued and run together (``draw``): most
    kernels are smaller than a chunk."""

    def __init__(self, root: np.ndarray):
        self.root = root
        self.params: Tree = {}
        self.stats: Tree = {}
        self.jobs: list = []

    @staticmethod
    def _put(tree: Tree, path: Sequence[str], leaf: str, value: np.ndarray):
        for name in path:
            tree = tree.setdefault(name, {})
        tree[leaf] = value

    def _queue(self, path, shape, fn, scale):
        out = np.empty(math.prod(shape), _F32)
        self._put(self.params, path, "kernel", out.reshape(shape))
        self.jobs.append((out, lambda s, e: fn(s, e) * scale))

    def conv(self, path, shape):
        """``lecun_normal``."""
        k = param_key(self.root, path, 1)
        self._queue(path, shape, functools.partial(_truncated_range, k, -2.0, 2.0), _lecun_std(shape))

    def normal_conv(self, path, shape, std, bias: bool = False):
        """``normal(std)``, and a zero bias."""
        self._queue(path, shape, functools.partial(_normal_range, param_key(self.root, path, 1)), _F32(std))
        if bias:
            self._put(self.params, path, "bias", zeros(shape[-1:]))

    def bn(self, path, c):
        path = (*path, "BatchNorm_0")  # ``_BN``'s inner scope in every mode
        self._put(self.params, path, "scale", ones((c,)))
        self._put(self.params, path, "bias", zeros((c,)))
        self._put(self.stats, path, "mean", zeros((c,)))
        self._put(self.stats, path, "var", ones((c,)))

    def draw(self) -> Tuple[Tree, Tree]:
        _fill(self.jobs)
        return self.params, self.stats


def jax_init_params(cfg, joint_num: int, k: np.ndarray) -> Tuple[Tree, Tree]:
    """``init_pose_net(build_pose_net(cfg, joint_num), k)`` of the JAX
    package, in numpy: (``params``, ``batch_stats``) with flax's paths,
    shapes and values. The tree depends on the ResNet depth, ``s2d_stem``
    (the stem kernel (4, 4, 12, 64)), the head's layers and width, and
    ``joint_num * depth_dim``; every other model option (fused routes, BN
    modes, remat, logits dtype, precision) leaves it as it is, since
    ``init`` runs the eval-mode forward."""
    from ihpr_tpu_torch.models.resnet import _STAGE_WIDTHS, RESNET_SPECS

    m = cfg.model
    init = _Init(np.asarray(k, _U32))
    kind, depths, expansion = RESNET_SPECS[m.resnet_type]
    bb = ("backbone",)
    init.conv((*bb, "conv1"), (4, 4, 12, 64) if m.s2d_stem else (7, 7, 3, 64))
    init.bn((*bb, "bn1"), 64)
    cin = 64
    for stage, (width, depth) in enumerate(zip(_STAGE_WIDTHS, depths)):
        for i in range(depth):
            stride = 2 if (stage > 0 and i == 0) else 1
            blk = (*bb, f"layer{stage + 1}_{i}")
            cout = width * expansion
            if kind == "basic":
                convs = [("conv1", 3, cin, width), ("conv2", 3, width, width)]
            else:
                convs = [("conv1", 1, cin, width), ("conv2", 3, width, width), ("conv3", 1, width, cout)]
            for j, (name, ks, ci, co) in enumerate(convs):
                init.conv((*blk, name), (ks, ks, ci, co))
                init.bn((*blk, f"bn{j + 1}"), co)
            if stride != 1 or cin != cout:
                init.conv((*blk, "down_conv"), (1, 1, cin, cout))
                init.bn((*blk, "down_bn"), cout)
            cin = cout
    head = ("head",)
    for i in range(m.num_deconv_layers):
        init.normal_conv((*head, f"deconv{i + 1}"), (4, 4, cin, m.deconv_channels), m.head_final_init_std)
        init.bn((*head, f"bn{i + 1}"), m.deconv_channels)
        cin = m.deconv_channels
    init.normal_conv((*head, "final"), (1, 1, cin, joint_num * cfg.data.depth_dim), m.head_final_init_std,
                     bias=True)
    return init.draw()


def subpixel_params(k: np.ndarray, cin: int, features: int) -> Tree:
    """``SubpixelConvTranspose(features).init(k, x)["params"]`` of the JAX
    package (``ihpr_tpu/models/head.py:27``) for an input of ``cin``
    channels: its (4, 4, cin, features) kernel, lecun-normal."""
    return {"kernel": lecun_normal(param_key(k, (), 1), (4, 4, cin, features))}


def trainer_init_key(seed: int) -> np.ndarray:
    """The key JAX's ``Trainer`` initializes its model from:
    ``split(key(seed))[1]``."""
    return split(key(seed))[1]
