"""ihpr_tpu_torch models vs the JAX package on the same weights (CPU).

A JAX R18 PoseNet (64x64 input, 16x16 heatmaps, J=18, D=16) is initialized,
its BN statistics, deconvs and final conv are redrawn with numpy from a
seed so that activations are O(1) and the heatmaps are peaked (the init's
std-0.001 head makes them flat, and flat heatmaps put every coordinate at
the volume centre, where any two implementations agree). The same arrays
go through ``from_jax_params`` into the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihpr_tpu import config as jconfig
from ihpr_tpu.models.pose_net import build_pose_net as jax_build_pose_net
from ihpr_tpu.models.pose_net import init_pose_net
from ihpr_tpu_torch import config as tconfig
from ihpr_tpu_torch.models.convert import from_jax_params, init_state_dict
from ihpr_tpu_torch.models.pose_net import build_pose_net

torch.set_num_threads(1)

TINY_DATA = dict(
    trainset=("Human36M",), testset="Human36M",
    input_shape=(64, 64), output_shape=(16, 16), depth_dim=16,
)
FINAL_STD = 0.3  # with O(1) head features: logits of std ~4, peaked heatmaps


def jax_tiny_cfg(**model_kw):
    return jconfig.get_config("h36m3d_r50").replace(
        model=jconfig.ModelConfig(resnet_type=18, **model_kw),
        data=jconfig.DataConfig(**TINY_DATA),
    )


def to_port_cfg(jcfg) -> tconfig.Config:
    """The port's Config with the same field values as a JAX Config."""
    parts = {
        f.name: getattr(tconfig, type(getattr(jcfg, f.name)).__name__)(
            **dataclasses.asdict(getattr(jcfg, f.name))
        )
        for f in dataclasses.fields(jcfg)
        if dataclasses.is_dataclass(getattr(jcfg, f.name))
    }
    return tconfig.Config(name=jcfg.name, seed=jcfg.seed, output_dir=jcfg.output_dir, **parts)


def jax_pose_weights(jcfg, seed=0):
    """JAX-initialized PoseNet params/batch_stats (numpy), with BN stats,
    deconvs and the final conv redrawn from ``seed``."""
    model = jax_build_pose_net(jcfg)
    params, stats = init_pose_net(model, jax.random.key(seed), jcfg.data.input_shape)
    params = jax.tree.map(np.asarray, params)
    stats = jax.tree.map(np.asarray, stats)
    rng = np.random.RandomState(seed)

    def redraw(p, s):
        for name, sub in p.items():
            if name == "BatchNorm_0":
                c = sub["scale"].shape[0]
                sub["scale"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
                sub["bias"] = rng.uniform(-0.1, 0.1, c).astype(np.float32)
                s[name]["mean"] = rng.uniform(-0.2, 0.2, c).astype(np.float32)
                s[name]["var"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
            elif name.startswith("deconv"):
                k = sub["kernel"]
                sub["kernel"] = (rng.randn(*k.shape) * np.sqrt(0.5 / k.shape[2])).astype(np.float32)
            elif name == "final":
                k = sub["kernel"]
                sub["kernel"] = (rng.randn(*k.shape) * FINAL_STD).astype(np.float32)
                sub["bias"] = (rng.randn(k.shape[-1]) * 0.1).astype(np.float32)
            elif "kernel" not in sub:
                redraw(sub, s.get(name, {}))

    redraw(params, stats)
    return model, params, stats


def port_model(jcfg, params, stats):
    cfg = to_port_cfg(jcfg)
    model = build_pose_net(cfg, device="cpu", state_dict=from_jax_params(params, stats, cfg))
    return model


def _image(seed=1, b=2):
    return np.random.RandomState(seed).randn(b, 64, 64, 3).astype(np.float32)


def _apply(model, params, stats, x, method=None):
    return np.asarray(
        model.apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(x), train=False,
            **({"method": method} if method is not None else {}),
        ),
        np.float32,
    )


@pytest.fixture(scope="module", params=["flax", "lean"])
def fp32_pair(request):
    jcfg = jax_tiny_cfg(matmul_precision="highest", bn_mode=request.param)
    jmodel, params, stats = jax_pose_weights(jcfg)
    return jcfg, jmodel, params, stats, port_model(jcfg, params, stats)


def test_backbone_activations_match_jax(fp32_pair):
    _, jmodel, params, stats, tmodel = fp32_pair
    x = _image()
    ref = _apply(jmodel, params, stats, x, lambda m, v, train: m.backbone(v, train))
    with torch.inference_mode():
        out = tmodel.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-4, atol=1e-4)


def test_heatmap_logits_match_jax(fp32_pair):
    _, jmodel, params, stats, tmodel = fp32_pair
    x = _image()
    ref = _apply(jmodel, params, stats, x)
    with torch.inference_mode():
        out = tmodel(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 16, 16, 18 * 16)
    assert ref.std() > 2.0  # peaked heatmaps, not a flat volume
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_coords_match_jax(fp32_pair):
    """coords (fused op, plain on CPU) and coords_plain vs JAX coords (the
    Pallas kernel in interpret mode): 2e-3 voxel, the end-to-end bar."""
    _, jmodel, params, stats, tmodel = fp32_pair
    x = _image()
    ref = _apply(jmodel, params, stats, x, jmodel.coords)
    assert np.abs(ref - 7.5).max() > 1.0  # coordinates away from the centre
    with torch.inference_mode():
        xt = torch.from_numpy(x)
        coords, plain = tmodel.coords(xt).numpy(), tmodel.coords_plain(xt).numpy()
    np.testing.assert_allclose(coords, ref, atol=2e-3)
    np.testing.assert_allclose(plain, ref, atol=2e-3)


def test_bf16_lean_flagship_dtypes_match_jax():
    """bf16 convs + lean BN + bf16 logits (the flagship's dtypes). Both sides
    round every conv and BN output to bf16 (relative step 2^-8), but not at
    the same places (XLA keeps excess precision inside its fusions), so they
    agree only to bf16 noise. At these peaked heatmaps that noise alone
    moves coords ~0.4 voxel from fp32: the bound is 0.5 voxel, and the two
    bf16 paths must agree at least as well as bf16 agrees with fp32."""
    jcfg = jax_tiny_cfg(compute_dtype="bfloat16", bn_mode="lean", fp32_logits=False)
    jmodel, params, stats = jax_pose_weights(jcfg, seed=3)
    tmodel = port_model(jcfg, params, stats)
    fp32 = port_model(jax_tiny_cfg(matmul_precision="highest", bn_mode="lean"), params, stats)
    x = _image(seed=4)
    ref = _apply(jmodel, params, stats, x, jmodel.coords)
    with torch.inference_mode():
        out = tmodel.coords(torch.from_numpy(x)).numpy()
        ref32 = fp32.coords(torch.from_numpy(x)).numpy()
    assert np.abs(ref - 7.5).max() > 1.0
    np.testing.assert_allclose(out, ref, atol=0.5)
    assert np.abs(out - ref).max() <= np.abs(ref - ref32).max()


def test_from_jax_params_covers_every_weight():
    jcfg = jax_tiny_cfg()
    _, params, stats = jax_pose_weights(jcfg)
    cfg = to_port_cfg(jcfg)
    sd = from_jax_params(params, stats, cfg)
    model = build_pose_net(cfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape, k
    # deconv taps are un-flipped: torch (in, out, kh, kw)[..., 0, 0] is flax [3, 3]
    k = params["head"]["deconv2"]["kernel"]
    np.testing.assert_array_equal(sd["head.deconv2.weight"][:, :, 0, 0].numpy(), k[3, 3])


@pytest.mark.parametrize("field, value", [("bn_mode", "lean_subx"), ("bn_mode", "lean_sub0"), ("bn_mode", "fused"),
                                          ("remat_policy", "dots")])
def test_build_pose_net_rejects_unported_options(field, value):
    """Every option of JAX's ModelConfig is ported (``test_every_jax_model_option_builds``);
    a bn_mode or remat_policy JAX does not know is refused by name."""
    base = tconfig.get_config("h36m3d_r50")
    cfg = base.replace(model=dataclasses.replace(base.model, block_remat=True, **{field: value}))
    with pytest.raises(ValueError, match=value):
        build_pose_net(cfg, device="cpu")


@pytest.mark.parametrize("options", [
    dict(bn_mode=m) for m in ("flax", "lean", "lean16", "lean_sub4", "lean_sub8", "lean_sg", "lean_sgv", "frozen")
] + [dict(block_remat=True, remat_policy=p) for p in ("full", "conv_outs")] + [dict(s2d_stem=True)],
    ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_every_jax_model_option_builds(options):
    """Each bn_mode, remat policy and the s2d stem JAX's ModelConfig takes
    builds a PoseNet (R18 at 64x64) that runs a train-mode forward."""
    cfg = tconfig.get_config("h36m3d_r50").replace(
        model=tconfig.ModelConfig(resnet_type=18, **options), data=tconfig.DataConfig(**TINY_DATA))
    model = build_pose_net(cfg, device="cpu", trainable=True)
    out = model.coords(torch.zeros(2, 64, 64, 3))
    assert out.shape == (2, 18, 3) and bool(torch.isfinite(out).all())


def test_seeded_init_is_reproducible():
    cfg = tconfig.get_config("h36m3d_r50").replace(
        model=tconfig.ModelConfig(resnet_type=18), data=tconfig.DataConfig(**TINY_DATA)
    )
    model = build_pose_net(cfg, device="cpu")
    a = init_state_dict(model, torch.Generator().manual_seed(0))
    b = init_state_dict(model, torch.Generator().manual_seed(0))
    c = init_state_dict(model, torch.Generator().manual_seed(1))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["backbone.conv1.weight"], c["backbone.conv1.weight"])
    # lecun-normal: std ~ 1/sqrt(fan_in) for the stem (fan_in 3*7*7)
    std = float(a["backbone.conv1.weight"].std())
    assert abs(std - (1 / 147) ** 0.5) < 0.02


def test_bf16_config_keeps_fp32_master_weights():
    """A bf16 config holds fp32 parameters, as the JAX package does
    (param_dtype=float32, cast per call): state_dict() after
    from_jax_params equals the JAX fp32 tree exactly."""
    jcfg = jax_tiny_cfg(compute_dtype="bfloat16", bn_mode="lean", fp32_logits=False)
    _, params, stats = jax_pose_weights(jcfg)
    cfg = to_port_cfg(jcfg)
    sd = from_jax_params(params, stats, cfg)
    model = build_pose_net(cfg, device="cpu", state_dict=sd)
    out = model.state_dict()
    assert set(out) == set(sd)
    for k, v in out.items():
        assert v.dtype == torch.float32 and torch.equal(v, sd[k]), k
    np.testing.assert_array_equal(
        out["backbone.conv1.weight"].numpy(), params["backbone"]["conv1"]["kernel"].transpose(3, 2, 0, 1)
    )
    np.testing.assert_array_equal(out["head.final.weight"].numpy(), params["head"]["final"]["kernel"][0, 0])
