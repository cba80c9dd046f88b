"""The port's probe tools (ihpr_tpu_torch.tools) against the JAX probes
(tools/exp_probe.py, tools/mxu_int8_probe.py) on the CPU.

tools/ is a directory of scripts, not a package: each JAX probe is loaded
from its file, and its module globals are set to a small size (its
``build`` reads them at call time). The Pallas kernels run in interpret
mode, so the grid runs in order and the last block's token is what the TPU
kernel's output holds. The same numpy inputs go to both sides.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihpr_tpu_torch.tools import exp_probe, mxu_int8_probe

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(B=2, CHUNK=8, LANES=128, NCHUNK=3)
# Relative to the value: fp32 sums of the same 1024 terms in another order
# and exp/exp2 within an ulp; bf16 exp rounds each term to 2^-9.
TOKEN_TOL = {"sum": 1e-5, "maxsum": 1e-5, "expsum": 1e-5, "exp2sum": 1e-5, "bexpsum": 1e-3}


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_exp_probe():
    mod = _load("exp_probe")
    for k, v in SMALL.items():
        setattr(mod, k, v)
    return mod


@pytest.fixture(scope="module")
def jax_mm_probe():
    return _load("mxu_int8_probe")


def _volume(seed=0):
    rng = np.random.RandomState(seed)
    shape = (SMALL["B"], SMALL["NCHUNK"] * SMALL["CHUNK"], SMALL["LANES"])
    return (rng.randn(*shape) - 3.0).astype(np.float32)


def _scaled(tok: float) -> float:
    """The JAX probe's return value for a token tok: tok * 1e-30 in fp32."""
    return float(np.float32(tok) * np.float32(1e-30))


@pytest.mark.parametrize("mode", exp_probe.MODES)
def test_exp_probe_token_matches_jax(jax_exp_probe, monkeypatch, mode):
    """float(build(mode)(x, 1)) is the TPU kernel's token[0, 0] times 1e-30
    (one chained pass, nothing perturbed yet): read exactly, the
    reductions within TOKEN_TOL."""
    for k, v in SMALL.items():
        monkeypatch.setattr(exp_probe, k, v)
    x = _volume()
    got = float(jax_exp_probe.build(mode)(jnp.asarray(x), 1))
    partials, token = exp_probe.probe(torch.from_numpy(x), mode)
    assert partials.shape == (SMALL["B"], SMALL["NCHUNK"]) and token.shape == (8, 128)
    if mode == "read":
        last = (SMALL["NCHUNK"] - 1) * SMALL["CHUNK"]
        assert torch.equal(token, torch.from_numpy(x[-1, last : last + 8, :128]))
        assert _scaled(token[0, 0]) == got
    else:
        assert torch.equal(token, token[0, 0].expand(8, 128))
        assert token[0, 0] == partials[-1, -1]
        assert abs(float(token[0, 0]) - got / 1e-30) <= TOKEN_TOL[mode] * abs(got / 1e-30)


def _bf16(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16 (nearest even), as float64."""
    return torch.from_numpy(a).to(torch.bfloat16).double().numpy()


@pytest.mark.parametrize("mode", exp_probe.MODES)
def test_exp_probe_partials_against_float64(mode):
    """Every block's r against numpy in float64 (bexpsum: bf16-rounded
    inputs, v - 3 rounded to bf16, the exp itself unrounded)."""
    x = _volume(1)
    b, nchunk, chunk = SMALL["B"], SMALL["NCHUNK"], SMALL["CHUNK"]
    v = x.astype(np.float64).reshape(b, nchunk, -1)
    ref = {
        "read": v[..., 0],
        "sum": v.sum(-1),
        "maxsum": v.max(-1) + v.sum(-1),
        "expsum": np.exp(v - 3).sum(-1),
        "exp2sum": np.exp2(v - 3).sum(-1),
        "bexpsum": np.exp(_bf16((_bf16(v) - 3).astype(np.float32))).sum(-1),
    }[mode]
    partials, _ = exp_probe.plain(torch.from_numpy(x), mode, chunk=chunk)
    got = partials.double().numpy()
    if mode == "read":
        assert np.array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=TOKEN_TOL[mode], atol=0)


def test_exp_probe_read_floor_guard():
    """A read faster than the bytes at 3.35 TB/s raises; one at the floor
    or slower passes. 2.416 GB -> 0.721 ms."""
    nbytes = 128 * 4096 * 1152 * 4
    assert abs(exp_probe.read_floor_ms(nbytes) - 0.7212) < 1e-3
    exp_probe.check_read_floor(0.80, nbytes)
    exp_probe.check_read_floor(exp_probe.read_floor_ms(nbytes), nbytes)
    with pytest.raises(RuntimeError, match="elided"):
        exp_probe.check_read_floor(0.01, nbytes)


def test_exp_probe_main_on_cpu(capsys):
    results = exp_probe.main(["--device", "cpu", "--shape", "2", "3", "8", "128", "--iters", "1"])
    assert set(results) == set(exp_probe.MODES)
    assert all(ms > 0 for ms in results.values())
    out = capsys.readouterr().out
    assert "host clock" in out and "marginal exp pass" in out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
def test_mats_match_jax(jax_mm_probe, dtype):
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.int8
    ja, jb = jax_mm_probe._mats(np.random.RandomState(3), 64, 32, 48, jdtype)
    a, b = mxu_int8_probe._mats(np.random.RandomState(3), 64, 32, 48, dtype)
    assert a.dtype == dtype and a.shape == (64, 48) and b.shape == (48, 32)
    for j, t in ((ja, a), (jb, b)):
        assert np.array_equal(np.asarray(j).astype(np.float32), t.float().numpy())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
def test_pallas_mm_matches_jax(jax_mm_probe, dtype):
    """JAX's interpret-mode pallas_mm at 256^3 with 128^3 tiles against the
    port's plain_mm on the same operands: int8 bitwise, bf16 within 1e-5 of
    max|out| (fp32 sums of exact bf16 products in another order)."""
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.int8
    ja, jb = jax_mm_probe._mats(np.random.RandomState(4), 256, 256, 256, jdtype)
    want = np.asarray(jax_mm_probe.pallas_mm(256, 256, 256, jdtype, 128, 128, 128)(ja, jb))
    a, b = mxu_int8_probe._mats(np.random.RandomState(4), 256, 256, 256, dtype)
    got = mxu_int8_probe.plain_mm(a, b)
    # The port's own callable takes the plain route on CPU tensors.
    assert torch.equal(mxu_int8_probe.pallas_mm(256, 256, 256, dtype)(a, b), got)
    if dtype == torch.int8:
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    else:
        assert got.dtype == torch.float32
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_conv9_int8_token_matches_jax(jax_mm_probe):
    """The token in int64 (JAX's int32 token would wrap past 2^31; at this
    size |token| is far below it)."""
    rng = np.random.RandomState(5)
    x = np.clip(np.round(rng.randn(2, 8, 8, 128) * 10), -127, 127)
    w = np.clip(np.round(rng.randn(3, 3, 128, 128) * 5), -127, 127)
    want = int(jax_mm_probe.conv9(jnp.asarray(x, jnp.int8), jnp.asarray(w, jnp.int8)))
    got = mxu_int8_probe.conv9(torch.from_numpy(x).to(torch.int8), torch.from_numpy(w).to(torch.int8))
    assert got.dtype == torch.int64 and abs(want) < 2**31
    assert int(got) == want


def test_pallas_mm_asserts_divisibility():
    with pytest.raises(AssertionError):
        mxu_int8_probe.pallas_mm(256, 256, 200, torch.bfloat16, 128, 128, 32)


def test_mxu_probe_main_on_cpu(capsys):
    results = mxu_int8_probe.main(["--device", "cpu", "--size", "256", "--conv", "2", "8", "8", "16",
                                   "--iters", "1"])
    tiles = [f"pallas_{t}_{bm}x{bn}x{bk}" for dt, t in mxu_int8_probe.TAGS.items()
             for bm, bn, bk in mxu_int8_probe.TILES[dt]]
    for name in ("dot_bf16", "dot_int8", "pallas_bf16", "pallas_int8", "conv9_bf16", "conv9_int8",
                 "convref_bf16", *tiles):
        assert results[name] > 0, name
    assert "convref_int8" not in results
    out = capsys.readouterr().out
    assert "not available: no int8 conv" in out and "int8 is" in out


def test_mxu_probe_check_on_cpu(capsys):
    assert mxu_int8_probe.main(["--device", "cpu", "--check"]) == {}
    assert "check OK" in capsys.readouterr().out
