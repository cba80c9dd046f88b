"""The port's draw of the JAX package's initial weights
(``ihpr_tpu_torch/models/jax_random.py``, numpy only) against JAX and flax
on the CPU: ``jax.random``'s keys and bits, its float draws, flax's
per-parameter keys, ``init_pose_net`` for every model option the port
builds, the s2d stem and ``SubpixelConvTranspose`` included, the fixture
``chip_smoke.py --only jax-init`` holds the card host's draw to, and the
port's Trainer's initial state against JAX's Trainer's.

Bars: keys, split, fold_in and bits bitwise; a float draw within 4 ulp of
JAX's on every element, near zero in ulps of the tensor's std
(``_ulps``: |a - b| / spacing(max(|b|, std))), and at least 97% bitwise.
Measured (JAX 0.9.0, flax 0.12.3, an x86-64 CPU): normal 99.997% bitwise, at
most 2 ulp; truncated_normal 99.995%, at most 4 (one value in 10^5); each
model's parameters 99.99% or more bitwise, at most 4. XLA's ``log1p``
and ``log`` are copied from its CPU emitter; what still differs is
``_fma``'s emulation of a fused multiply-add in float64 (double rounding)
where XLA's CPU code does not contract.

JAX runs ``init_pose_net`` eagerly, as its Trainer does (``jax.jit`` of it
fuses the draws differently: 88% bitwise).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihpr_tpu.config import get_config as jax_get_config
from ihpr_tpu.engine.trainer import Trainer as JaxTrainer
from ihpr_tpu.models.head import SubpixelConvTranspose as JaxSubpixel
from ihpr_tpu.models.pose_net import build_pose_net as jax_build_pose_net
from ihpr_tpu.models.pose_net import init_pose_net
from ihpr_tpu_torch.engine.trainer import Trainer
from ihpr_tpu_torch.models import jax_random as jr
from ihpr_tpu_torch.models.convert import from_jax_params
from make_jax_init_fixture import LEAVES, N, PATH, leaf
from test_torch_models import jax_tiny_cfg, to_port_cfg
from torch_tmp import free_tmp_path  # noqa: F401  (autouse: frees each passing test's tmp_path)

torch.set_num_threads(1)

MAX_ULPS = 4
MIN_BITWISE = 0.97
DRAWS = 100_000

SEEDS = (0, 1, 42, 2**31 - 1, 2**31, 2**32, 2**32 + 5, 2**40 + 3, -1, -7)


def _ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got - want| in ulps of max(|want|, the tensor's std) (float32)."""
    std = np.float32(max(float(want.std()), 1e-30))
    return np.abs(got.astype(np.float64) - want) / np.spacing(np.maximum(np.abs(want), std))


def _check_close(got: np.ndarray, want: np.ndarray, what) -> float:
    """The bars of the module docstring; returns the bitwise share."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32, what
    assert _ulps(got, want).max() <= MAX_ULPS, what
    return float(np.mean(got == want))


def _flat(tree, prefix=()):
    out = {}
    for name, sub in tree.items():
        if isinstance(sub, dict):
            out.update(_flat(sub, (*prefix, name)))
        else:
            out["/".join((*prefix, name))] = np.asarray(sub)
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_and_bits_are_jax_bitwise(seed):
    """``key`` (64-bit and negative seeds wrap as JAX's 32-bit mode wraps
    them), ``split``, ``fold_in`` and ``bits`` bitwise ``jax.random``'s."""
    jkey = jax.random.key(seed)
    k = jr.key(seed)
    np.testing.assert_array_equal(k, np.asarray(jax.random.key_data(jkey)))
    np.testing.assert_array_equal(jr.split(k, 3), np.asarray(jax.random.key_data(jax.random.split(jkey, 3))))
    for data in (0, 7, 2**31 + 3, 2**32 - 1):
        want = np.asarray(jax.random.key_data(jax.random.fold_in(jkey, data)))
        np.testing.assert_array_equal(jr.fold_in(k, data), want)
    # more values than one chunk of the thread pool, in a shape
    want = np.asarray(jax.random.bits(jkey, (3, 50_000), jnp.uint32))
    np.testing.assert_array_equal(jr.bits(k, (3, 50_000)), want)
    want = np.asarray(jax.random.key_data(jax.random.split(jkey)[1]))
    np.testing.assert_array_equal(jr.trainer_init_key(seed), want)


def test_uniform_is_jax_bitwise():
    """``uniform`` bitwise JAX's, on [0, 1) and on the truncated normal's
    (erf(-sqrt 2), erf(sqrt 2)), where the scale-and-add's one rounding
    (a fused multiply-add) shows."""
    jkey, k = jax.random.key(5), jr.key(5)
    for lo, hi in ((0.0, 1.0), (-0.9544997, 0.9544997), (-0.7, 0.95)):
        want = np.asarray(jax.random.uniform(jkey, (DRAWS,), minval=lo, maxval=hi))
        np.testing.assert_array_equal(jr.uniform(k, (DRAWS,), lo, hi), want)


@pytest.mark.parametrize("seed", (0, 3))
def test_normal_and_truncated_normal_match_jax(seed):
    """``normal`` and ``truncated_normal(-2, 2)`` at 10^5 values: within 4
    ulp of JAX's on every element (near zero in ulps of the std), at least
    97% bitwise; ``erf`` bitwise XLA's at the truncation bounds."""
    jkey, k = jax.random.key(seed), jr.key(seed)
    share = _check_close(jr.normal(k, (DRAWS,)), np.asarray(jax.random.normal(jkey, (DRAWS,))), "normal")
    assert share >= MIN_BITWISE
    want = np.asarray(jax.random.truncated_normal(jkey, -2.0, 2.0, (DRAWS,)))
    got = jr.truncated_normal(k, -2.0, 2.0, (DRAWS,))
    assert _check_close(got, want, "truncated_normal") >= MIN_BITWISE
    assert np.abs(got).max() < 2.0
    bound = np.float32(2.0) / np.float32(np.sqrt(2))
    want = np.asarray(jax.lax.erf(jnp.array([-bound, bound])))
    np.testing.assert_array_equal(jr.erf(np.array([-bound, bound])), want)


def test_fold_in_static_is_flax_with_either_separator_rule():
    """``fold_in_static`` against flax's ``_fold_in_static`` for names and
    counters, with the ``flax_fix_rng_separator`` rule off (flax's default)
    and on."""
    from flax import config as flax_config
    from flax.core.scope import _fold_in_static

    jkey, k = jax.random.key(11), jr.key(11)
    data = ("backbone", "layer1_0", "conv1", 1)
    for fix in (False, True):
        with flax_config.temp_flip_flag("fix_rng_separator", fix):
            want = np.asarray(jax.random.key_data(_fold_in_static(jkey, data)))
        np.testing.assert_array_equal(jr.fold_in_static(k, data, fix), want, err_msg=str(fix))
    assert not np.array_equal(jr.fold_in_static(k, data, False), jr.fold_in_static(k, data, True))
    assert not flax_config.flax_fix_rng_separator and not jr.FIX_RNG_SEPARATOR


# Each case: (name, JAX config name, model fields, joint_num, depth_dim, key seed,
# init input size). The tree depends on the depth, the stem, the joints and
# D; the other options (fused routes, logits dtype, BN mode) are folded in
# to show they leave it alone. The flagship case is the Trainer's key at
# seed 0 (the fixture's draw); R152 and R18 take a 64x64 input to init
# (the parameters do not depend on it).
CASES = (
    ("r50_flagship_fused", "h36m3d_r50", dict(fused_1x1=True, fused_conv3=True), 18, 64, None, (256, 256)),
    ("r152_s2d_j17", "h36m3d_r152_384", dict(s2d_stem=True, fp32_logits=True, compute_dtype="float32"), 17, 64, 3,
     (64, 64)),
    ("r18_2d_j16", "h36m3d_r50", dict(resnet_type=18, fp32_logits=False, bn_mode="lean"), 16, 1, 4, (64, 64)),
)


def _case(name):
    _, config, fields, joints, depth, seed, size = next(c for c in CASES if c[0] == name)
    jcfg = jax_get_config(config)
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, **fields),
                        data=dataclasses.replace(jcfg.data, depth_dim=depth))
    return jcfg, to_port_cfg(jcfg), joints, seed, size


def _jax_init(jcfg, joints, seed, size):
    jkey = jax.random.split(jax.random.key(0))[1] if seed is None else jax.random.key(seed)
    params, stats = init_pose_net(jax_build_pose_net(jcfg, joints), jkey, size)
    return _flat(jax.tree.map(np.asarray, params)), _flat(jax.tree.map(np.asarray, stats))


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_jax_init_params_match_init_pose_net(name):
    """``jax_init_params`` against JAX's ``init_pose_net``: the same paths
    and shapes, every parameter within the module's bars (99.99% bitwise
    measured), ``batch_stats`` exact; the converted state loads into the
    port's model."""
    jcfg, cfg, joints, seed, size = _case(name)
    want, want_stats = _jax_init(jcfg, joints, seed, size)
    k = jr.trainer_init_key(0) if seed is None else jr.key(seed)
    params, stats = jr.jax_init_params(cfg, joints, k)
    got, got_stats = _flat(params), _flat(stats)
    assert got.keys() == want.keys() and got_stats.keys() == want_stats.keys()
    equal = total = 0
    for path, w in want.items():
        _check_close(got[path], w, path)
        equal += int((got[path] == w).sum())
        total += w.size
    assert equal / total >= 0.9999, equal / total
    for path, w in want_stats.items():
        np.testing.assert_array_equal(got_stats[path], w, err_msg=path)
    assert want["head/final/kernel"].shape[-1] == joints * cfg.data.depth_dim
    if name == "r50_flagship_fused":
        fixture = np.load(PATH)
        assert sorted(fixture.files) == sorted(LEAVES)
        for path in LEAVES:
            np.testing.assert_array_equal(fixture[path], want[path].reshape(-1)[:N], err_msg=path)
            _check_close(leaf(params, path), fixture[path], path)
    from ihpr_tpu_torch.models.pose_net import build_pose_net

    build_pose_net(cfg, joints, device="cpu", state_dict=from_jax_params(params, stats, cfg))


def test_subpixel_params_match_jax():
    """``subpixel_params`` against JAX's ``SubpixelConvTranspose(...).init``
    (its kernel is lecun-normal, unlike the head's deconvs)."""
    jkey, k = jax.random.key(6), jr.key(6)
    want = JaxSubpixel(32).init(jkey, jnp.zeros((1, 4, 4, 48)))["params"]
    got = jr.subpixel_params(k, 48, 32)
    assert got.keys() == want.keys()
    assert _check_close(got["kernel"], np.asarray(want["kernel"]), "kernel") >= MIN_BITWISE


def test_trainer_initial_state_matches_jax_trainer(tmp_path):
    """The port's Trainer and JAX's Trainer on the tiny R18 config at seed
    0 (and at seed 9): the port's model is JAX's initial model, every
    tensor within the module's bars; a caller's ``generator`` keeps the
    torch draw."""
    from ihpr_tpu.data import datasets as jdatasets
    from ihpr_tpu.data import skeletons as jskeletons
    from ihpr_tpu_torch.data import datasets, skeletons
    from ihpr_tpu_torch.models.pose_net import build_pose_net

    for seed in (0, 9):
        jcfg = jax_tiny_cfg(matmul_precision="highest", bn_mode="lean")
        jcfg = jcfg.replace(seed=seed, output_dir=str(tmp_path / f"jax{seed}"),
                            parallel=dataclasses.replace(jcfg.parallel, data_axis_size=1))
        jds = jdatasets.PoseDataset("Human36M", jskeletons.H36M,
                                    jdatasets.make_synthetic(jskeletons.H36M, 4, seed=0, img_size=200), True)
        jtrainer = JaxTrainer(jcfg, datasets=[jds], num_workers=0)
        want = {k: v.numpy() for k, v in from_jax_params(
            jax.tree.map(np.asarray, jtrainer.state.params), jax.tree.map(np.asarray, jtrainer.state.batch_stats),
            to_port_cfg(jcfg)).items()}
        cfg = to_port_cfg(jcfg).replace(output_dir=str(tmp_path / f"port{seed}"))
        ds = datasets.PoseDataset("Human36M", skeletons.H36M,
                                  datasets.make_synthetic(skeletons.H36M, 4, seed=0, img_size=200), is_train=True)
        trainer = Trainer(cfg, datasets=[ds], num_workers=0, device="cpu")
        try:
            got = {k: v.detach().numpy() for k, v in trainer.model.state_dict().items()}
        finally:
            trainer.close()
        assert got.keys() == want.keys()
        for k, w in want.items():
            _check_close(got[k], w, (seed, k))
    torch_draw = build_pose_net(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    w = "backbone.conv1.weight"
    assert _ulps(torch_draw.state_dict()[w].numpy(), want[w]).max() > 1e3
