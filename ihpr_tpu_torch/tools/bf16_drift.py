"""Where bf16 inference of trained weights departs from fp32, layer by
layer: the localisation tool for a trained ``accuracy_loop`` run.

    python -m ihpr_tpu_torch.tools.bf16_drift --preset flagship --output_dir D [--bn_mode lean]
        [--epoch latest|earliest|N] [--stats_out F.npz] [--batch 32] [--device cuda]
        [--k2_batches 4] [--reestimate_frames 2048]

It reads a snapshot in ``D`` (an ``accuracy_loop`` run's ``--output_dir``;
the latest by default, ``--epoch earliest`` the oldest one kept) and the
preset's unseen test frames and the run's train frames (seeded; their
JPEGs are the ones that run cached in ``D``; its seed and train size from
its ``accuracy_loop.json``, the preset's where there is none), then:

1. scores the same weights through five arithmetics (MPJPE total, flip-test
   off, as the tool's headline): bf16 with ``--bn_mode`` (default: the
   preset's), fp32, bf16 with the other BN mode, a bf16 backbone feeding
   an fp32 head, and an fp32 backbone feeding a bf16 head;
2. on the first ``--batch`` test patches, hooks every BN, block and deconv
   of the fp32 and both bf16 models and reports, per layer, the
   accumulated relative error (RMS of the difference over RMS of the fp32
   output), and per BN the local error of each arithmetic on the fp32
   model's own input rounded to bf16, the systematic part of it (the
   largest per-channel mean error over that channel's fp32 std), and the
   cancellation ``max |running_mean * mul| / max |x * mul + add|``;
   ``first_drift`` names the first layer whose error in the ``--bn_mode``
   model passes twice the other mode's and ``DRIFT`` (bf16 noise there);
3. holds K1 against its plain version on the bf16 head's features of
   that batch (CUDA only; the plain version is all the CPU has);
4. with ``--stats_out``, writes every BN's scale, bias, running mean and
   running variance (float32, keyed ``<module>.<field>``) to an npz;
5. ``k2`` (``k2_report``): K1/K2 on the trained head as training runs it.
   On ``--k2_batches`` train batches of ``--batch``, drawn in the run's
   order (the config's seed, epoch 0), the bf16 model in train mode gives
   the head features; with the final conv's bf16 weight and bias and the
   loss's cotangent, K1's coords and K2's dfeat, dW and db (CUDA only), and
   the plain route in the same dtype (JAX's arithmetic), are each held
   against the plain route in float64 on the same bf16-rounded inputs:
   max and mean |error| over the float64 result's largest, the cosine with
   float64, and the signed mean error over the mean |float64| (a bias
   witness); and the share of K1's (on the CPU: plain's) coordinates that
   sit on a whole voxel;
6. ``bn_reestimate`` (``bn_reestimate_report``): the unseen MPJPE in bf16
   and fp32 with the snapshot's running statistics and with every BN's
   statistics re-estimated on its trained weights (``reestimate_bn``: the
   cumulative average of the batch statistics over
   ``--reestimate_frames`` train frames in train mode, at the train
   batch (or the whole set, where it is smaller), no weight update), and per BN the largest ratio of re-estimated
   to running variance over its channels (and its inverse).

Writes ``{output_dir}/bf16_drift.json`` (``bf16_drift_epoch<N>.json`` with
``--epoch``) and prints a summary; the JSON records the kernel switch
(``IHPR_PALLAS``) under ``"kernels"``. Every model runs in ``"highest"``
precision (TF32 off), as the accuracy tools do.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from ihpr_tpu_torch.data import skeletons
from ihpr_tpu_torch.data.datasets import PoseDataset
from ihpr_tpu_torch.data.pipeline import BatchLoader, prefetch_to_device
from ihpr_tpu_torch.engine.checkpoint import CheckpointManager, load_snapshot
from ihpr_tpu_torch.engine.tester import metrics_from_voxel_preds
from ihpr_tpu_torch.models.head import Deconv
from ihpr_tpu_torch.models.pose_net import build_pose_net, inference_copy
from ihpr_tpu_torch.models.resnet import BN, BasicBlock, Bottleneck
from ihpr_tpu_torch.ops import fused_head_integral as fhi
from ihpr_tpu_torch.ops.integral_volume import kernel_mode
from ihpr_tpu_torch.ops.loss import joint_location_loss
from ihpr_tpu_torch.parallel.train_step import patch_batch
from ihpr_tpu_torch.tools._accuracy import device_info, synthetic_samples

ARITHMETICS = ("flax", "lean")  # the two BN applies the tool sets against each other

# A layer drifts where its error passes this (relative RMS), about four
# bf16 roundings' worth, and twice the other BN mode's error there.
DRIFT = 2.0 ** -7


def _rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.float()
    den = ref.pow(2).mean().sqrt()
    return float((a.float() - ref).pow(2).mean().sqrt() / den) if den > 0 else 0.0


def bn_fields(model) -> dict:
    """Every BN's weight, bias, running_mean and running_var as float32
    arrays keyed ``<module name>.<field>``."""
    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, BN):
            for field in ("weight", "bias", "running_mean", "running_var"):
                out[f"{name}.{field}"] = getattr(mod, field).detach().float().cpu().numpy()
    return out


def lean_bf16(bn: BN, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode lean BN of ``x`` in bf16: ``x * bf16(mul) + bf16(add)``."""
    mul, add = (t.to(torch.bfloat16)[:, None, None] for t in bn._fold(bn.running_mean, bn.running_var))
    return torch.addcmul(add, x.to(torch.bfloat16), mul)


def flax_bf16(bn: BN, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode flax BN of ``x`` in bf16: fp32 ``(x - mean) * mul + bias``,
    then one rounding to bf16."""
    mul = (torch.rsqrt(bn.running_var + bn.eps) * bn.weight)[:, None, None]
    y = (x.float() - bn.running_mean[:, None, None]) * mul + bn.bias[:, None, None]
    return y.to(torch.bfloat16)


def bn_local(bn: BN, x32: torch.Tensor, y32: torch.Tensor) -> dict:
    """One BN's bf16 error on the fp32 model's input ``x32`` (its fp32
    output ``y32``): each arithmetic's relative RMS error, its systematic
    part (the largest |per-channel mean error| over the channel's std), and
    the cancellation of the lean fold."""
    std = y32.float().std(dim=(0, 2, 3)).clamp_min(1e-30)
    out = {}
    for mode, fn in (("lean", lean_bf16), ("flax", flax_bf16)):
        d = fn(bn, x32).float() - y32.float()
        out[f"local_{mode}"] = _rel(fn(bn, x32), y32)
        out[f"bias_{mode}"] = float((d.mean(dim=(0, 2, 3)) / std).abs().max())
    mul, _ = bn._fold(bn.running_mean, bn.running_var)
    big = float((bn.running_mean * mul).abs().max())
    out["cancellation"] = big / max(float(y32.float().abs().max()), 1e-30)
    return out


def _hook(model, record: dict, keep_input: bool):
    handles = []
    for name, mod in model.named_modules():
        if isinstance(mod, (BN, BasicBlock, Bottleneck, Deconv)):
            def hook(mod, inp, outp, name=name):
                record[name] = (inp[0].detach() if keep_input and isinstance(mod, BN) else None, outp.detach())
            handles.append(mod.register_forward_hook(hook))
    return handles


def layer_errors(models: dict, mode: str, other: str, image: torch.Tensor) -> tuple:
    """(per-layer rows in execution order, the first drifting layer's name
    or None) for one batch of patches through ``models`` ("fp32", ``mode``,
    ``other``)."""
    records = {k: {} for k in models}
    for key, model in models.items():
        handles = _hook(model, records[key], keep_input=key == "fp32")
        try:
            with torch.inference_mode():
                model.coords(image)
        finally:
            for h in handles:
                h.remove()
    rows, first = [], None
    mods = dict(models[mode].named_modules())
    for name, (x32, y32) in records["fp32"].items():
        row = {"layer": name, mode: _rel(records[mode][name][1], y32), other: _rel(records[other][name][1], y32)}
        if x32 is not None:
            with torch.inference_mode():
                row.update(bn_local(mods[name], x32, y32))
        if first is None and row[mode] > DRIFT and row[mode] > 2 * row[other]:
            first = name
        rows.append(row)
    return rows, first


def k1_check(model, image: torch.Tensor) -> dict | None:
    """K1 against its plain version on the bf16 head's features of
    ``image`` (CUDA tensors only): the coords' max |difference| in voxels
    and the logits' range."""
    if not image.is_cuda:
        return None
    with torch.inference_mode():
        feat = model.head.features(model.backbone(image.permute(0, 3, 1, 2))).contiguous()
        b, h, w, c = feat.shape
        feat = feat.view(b, h * w, c)
        args = (feat, model.head.final.weight, model.head.final.bias, model.joint_num, model.depth_dim, w)
        coords, m, _ = fhi.kernel_stats(*args)
        want, want_m, _ = fhi.plain(*args)
        logits = feat.float() @ model.head.final.weight.float() + model.head.final.bias.float()
    return {"max_abs_err": float((coords - want).abs().max()), "m_max_abs_err": float((m - want_m).abs().max()),
            "logit_min": float(logits.min()), "logit_max": float(logits.max()), "shape": [b, h * w, c]}


def _hybrid(backbone_model, head_model):
    def coords(x):
        with head_model.precision():
            feat = backbone_model._features(x).to(head_model.head.dtype)
            return head_model.head(feat, "coords", head_model.joint_num, head_model.depth_dim)

    return coords


BF16 = dict(compute_dtype="bfloat16", fp32_logits=False)
FP32 = dict(compute_dtype="float32", fp32_logits=True)


def _build(cfg, joint_num: int, state_dict: dict, device, trainable: bool = False, **kw):
    """A PoseNet of ``cfg`` with ``kw`` replacing model fields, in "highest"
    precision, loaded with ``state_dict``: its inference copy, or the
    trainable model itself."""
    c = cfg.replace(model=dataclasses.replace(cfg.model, matmul_precision="highest", **kw))
    model = build_pose_net(c, joint_num, device=device, state_dict=state_dict, trainable=trainable)
    return model if trainable else inference_copy(model)


def _patches(loader: BatchLoader, cfg, name: str, device, train: bool, batches=None) -> list:
    """[(finalized (B, H, W, 3) images, their sample indices)] of one epoch
    of ``loader`` (the first ``batches`` of it; epoch 0)."""
    flip_perm = torch.as_tensor(skeletons.get_skeleton(name).flip_permutation())
    return [(patch_batch(b, cfg, flip_perm, train=train), idx)
            for b, idx in prefetch_to_device(loader.epoch(0, batches), device)]


def _mpjpe(cfg, loader: BatchLoader, test_ds: PoseDataset, images: list, fn) -> float:
    """Unseen MPJPE total (mm) of ``fn`` (images -> voxel coords) over
    ``images`` of ``loader``'s epoch, as the Tester scores it."""
    preds = np.zeros((len(loader.index), test_ds.joint_num, 3), np.float32)
    with torch.inference_mode():
        for image, idx in images:
            preds[idx] = fn(image).float().cpu().numpy()
    return round(metrics_from_voxel_preds(cfg, loader, test_ds, preds)[0]["MPJPE total"], 2)


def run(cfg, test_ds: PoseDataset, state_dict: dict, device, batch: int = 32, num_workers: int = 4) -> dict:
    """Steps 1-3 of the module docstring on ``state_dict`` (a PoseNet's):
    the result dict."""
    device = torch.device(device)
    mode = cfg.model.bn_mode
    other = next(m for m in ARITHMETICS if m != mode)

    def build(**kw):
        return _build(cfg, test_ds.joint_num, state_dict, device, **kw)

    models = {"fp32": build(**FP32), mode: build(**BF16), other: build(bn_mode=other, **BF16)}
    loader = BatchLoader([test_ds], cfg, cfg.eval.batch_size_per_device, train=False, num_workers=num_workers,
                         device=device)
    try:
        images = [(pb.image, idx) for pb, idx in _patches(loader, cfg, test_ds.name, device, train=False)]
        variants = {
            f"bf16 {mode}": models[mode].coords,
            "fp32": models["fp32"].coords,
            f"bf16 {other}": models[other].coords,
            "bf16 backbone + fp32 head": _hybrid(models[mode], models["fp32"]),
            "fp32 backbone + bf16 head": _hybrid(models["fp32"], models[mode]),
        }
        mpjpe = {label: _mpjpe(cfg, loader, test_ds, images, fn) for label, fn in variants.items()}
    finally:
        loader.close()
    image = torch.cat([im for im, _ in images])[:batch]
    rows, first = layer_errors(models, mode, other, image)
    with torch.inference_mode():
        want = models["fp32"].coords(image)
        final = {k: _rel(models[k].coords(image), want) for k in (mode, other)}
    bns = [r for r in rows if "cancellation" in r]
    return {
        "bn_mode": mode,
        "mpjpe_mm": mpjpe,
        "first_drift": first,
        "drift_bar": DRIFT,
        "worst_bn": sorted(bns, key=lambda r: -r[f"local_{mode}"])[:8],
        "max_cancellation": max((r["cancellation"] for r in bns), default=None),
        "final_coords_error": final,
        "k1": k1_check(models[mode], image),
        "layers": rows,
        "hook_batch": int(image.shape[0]),
        **device_info(device),
    }


def _vs_float64(got: torch.Tensor, want: torch.Tensor) -> dict:
    """``got`` against the float64 ``want``: max and mean |error| over
    max |want|, the cosine, and the signed mean error over mean |want|."""
    got, want = got.double().flatten(), want.double().flatten()
    d, top = got - want, want.abs().max().clamp_min(1e-300)
    return {
        "max_rel": float(d.abs().max() / top),
        "mean_rel": float(d.abs().mean() / top),
        "cosine": float(torch.dot(got, want) / (got.norm() * want.norm()).clamp_min(1e-300)),
        "bias": float(d.mean() / want.abs().mean().clamp_min(1e-300)),
    }


def _merge(stats: list) -> dict:
    """Per-batch ``_vs_float64`` results as one: the largest max, the mean
    of the means and biases, the smallest cosine."""
    return {"max_rel": max(x["max_rel"] for x in stats), "mean_rel": float(np.mean([x["mean_rel"] for x in stats])),
            "cosine": min(x["cosine"] for x in stats), "bias": float(np.mean([x["bias"] for x in stats]))}


def k2_report(cfg, train_ds: PoseDataset, state_dict: dict, device, batches: int = 4, batch: int = 32,
              num_workers: int = 4) -> dict:
    """Step 5 of the module docstring: {"kernel": {tensor: figures} (None
    off CUDA), "plain_bf16": {tensor: figures}, "whole_voxel_share",
    "batches", "batch", "logit_range"}. Tensors: coords (K1 / plain), dfeat,
    dw, db (K2 / plain_bwd); each batch's K2 and plain backward get the
    coords, m and s of their own forward and the cotangent of the float64
    coords."""
    device = torch.device(device)
    model = _build(cfg, train_ds.joint_num, state_dict, device, trainable=True, **BF16)
    model.train()
    j, d = model.joint_num, model.depth_dim
    kernel = model.head.final.weight.detach().to(model.head.dtype)
    bias = model.head.final.bias.detach().to(model.head.dtype)
    loader = BatchLoader([train_ds], cfg, batch, train=True, num_workers=num_workers, seed=cfg.seed, device=device)
    try:
        drawn = _patches(loader, cfg, train_ds.name, device, train=True, batches=batches)
    finally:
        loader.close()
    on_card = device.type == "cuda"
    per = {"kernel": [], "plain_bf16": []}
    whole, lo, hi = [], float("inf"), float("-inf")
    for pb, _ in drawn:
        with torch.no_grad(), model.precision():
            feat = model.head.features(model._features(pb.image)).contiguous()
        b, h, w, c = feat.shape
        flat = feat.view(b, h * w, c)
        args = (flat, kernel, bias, j, d, w)
        with torch.no_grad():
            c64, m64, s64 = fhi.plain(*(t.double() for t in args[:3]), j, d, w)
            logits = flat.float() @ kernel.float() + bias.float()
            lo, hi = min(lo, float(logits.min())), max(hi, float(logits.max()))
            del logits
        cot = c64.float().requires_grad_()
        (g,) = torch.autograd.grad(joint_location_loss(cot, pb.joint_img, pb.joint_vis, pb.joints_have_depth), cot)
        g = g.contiguous()
        with torch.no_grad():
            want = (c64, *fhi.plain_bwd(*(t.double() for t in args[:3]), m64, s64, c64, g.double(), j, d, w))
            routes = {"plain_bf16": (fhi.plain, fhi.plain_bwd)}
            if on_card:
                routes["kernel"] = (fhi.kernel_stats, fhi.kernel_bwd)
            for route, (fwd, bwd) in routes.items():
                coords, m, s = fwd(*args)
                got = (coords, *bwd(flat, kernel, bias, m, s, coords, g, j, d, w))
                per[route].append({k: _vs_float64(x, y) for k, x, y in zip(("coords", "dfeat", "dw", "db"), got, want)})
                if route == ("kernel" if on_card else "plain_bf16"):
                    whole.append(float((coords == coords.round()).float().mean()))
    merged = {route: ({k: _merge([x[k] for x in rows]) for k in rows[0]} if rows else None)
              for route, rows in per.items()}
    return {**merged, "whole_voxel_share": float(np.mean(whole)), "batches": len(drawn), "batch": batch,
            "logit_range": [lo, hi]}


def reestimate_bn(model, images) -> dict:
    """Every BN's statistics re-estimated on ``model``'s weights: {BN module
    name: (mean, var)}, each the cumulative (equal-weight) average of the
    batch statistics the BN takes in train mode over ``images`` (a sequence
    of (B, H, W, 3) finalized batches), in float64. The model runs in train
    mode with no gradient; its running statistics are left as they were
    (each BN's update is diverted for the pass) and its mode is restored."""
    bns = {name: mod for name, mod in model.named_modules() if isinstance(mod, BN)}
    sums = {}

    def accumulate(name):
        def update(mean, var):
            m, v, n = sums.get(name, (0.0, 0.0, 0))
            sums[name] = (m + mean.detach().double(), v + var.detach().double(), n + 1)
        return update

    was_training = model.training
    for name, bn in bns.items():
        bn._update_running = accumulate(name)  # an instance attribute: the class's update is shadowed
    try:
        model.train()
        with torch.no_grad(), model.precision():
            for image in images:
                model.head.features(model._features(image))
    finally:
        for bn in bns.values():
            del bn._update_running
        model.train(was_training)
    return {name: (m / n, v / n) for name, (m, v, n) in sums.items()}


def bn_reestimate_report(cfg, train_ds: PoseDataset, test_ds: PoseDataset, state_dict: dict, device,
                         frames: int = 2048, num_workers: int = 4) -> dict:
    """Step 6 of the module docstring: {"mpjpe_mm": {"running"/"reestimated":
    {"bf16", "fp32"}}, "frames", "batch", "var_ratio": {BN: [max re/run,
    max run/re]}, "worst_var_ratio": the eight BNs furthest from 1}."""
    device = torch.device(device)
    batch = min(cfg.optim.batch_size_per_device, len(train_ds))  # the train batch, or all a small set holds
    model = _build(cfg, train_ds.joint_num, state_dict, device, trainable=True, **BF16)
    loader = BatchLoader([train_ds], cfg, batch, train=True, num_workers=num_workers, seed=cfg.seed, device=device)
    try:
        images = [pb.image for pb, _ in _patches(loader, cfg, train_ds.name, device, train=True,
                                                 batches=max(1, -(-frames // batch)))]
    finally:
        loader.close()
    if not images:
        raise ValueError(f"no train batch of {batch} to re-estimate the BN statistics on")
    stats = reestimate_bn(model, images)
    used = sum(int(im.shape[0]) for im in images)
    del images, model
    new_sd = dict(state_dict)
    ratios = {}
    for name, (mean, var) in stats.items():
        run_var = state_dict[f"{name}.running_var"].double().to(var.device)
        new_sd[f"{name}.running_mean"] = mean.float().cpu()
        new_sd[f"{name}.running_var"] = var.float().cpu()
        r = var / run_var.clamp_min(1e-30)
        ratios[name] = [float(r.max()), float((1 / r.clamp_min(1e-30)).max())]
    test_loader = BatchLoader([test_ds], cfg, cfg.eval.batch_size_per_device, train=False,
                              num_workers=num_workers, device=device)
    try:
        test_images = [(pb.image, idx) for pb, idx in _patches(test_loader, cfg, test_ds.name, device, train=False)]
        mpjpe = {}
        for label, sd in (("running", state_dict), ("reestimated", new_sd)):
            mpjpe[label] = {dt: _mpjpe(cfg, test_loader, test_ds, test_images,
                                       _build(cfg, test_ds.joint_num, sd, device, **kw).coords)
                            for dt, kw in (("bf16", BF16), ("fp32", FP32))}
    finally:
        test_loader.close()
    worst = sorted(ratios.items(), key=lambda kv: -max(kv[1]))[:8]
    return {"mpjpe_mm": mpjpe, "frames": used, "batch": batch,
            "var_ratio": ratios, "worst_var_ratio": dict(worst)}


def main(argv=None):
    from ihpr_tpu_torch.tools.accuracy_loop import PRESETS, preset_config

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", choices=sorted(PRESETS), default="flagship")
    ap.add_argument("--output_dir", required=True, help="the accuracy_loop run's --output_dir")
    ap.add_argument("--bn_mode", choices=ARITHMETICS, default=None, help="default: the preset's")
    ap.add_argument("--test_size", type=int, default=None)
    ap.add_argument("--batch", type=int, default=32, help="patches through the hooked models")
    ap.add_argument("--stats_out", default=None, help="write every BN's parameters and statistics here (npz)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--epoch", default="latest", help="the snapshot: latest, earliest (the oldest kept) or N")
    ap.add_argument("--k2_batches", type=int, default=4, help="train batches of --batch for the k2 report")
    ap.add_argument("--reestimate_frames", type=int, default=2048, help="train frames the BN re-estimation averages")
    args = ap.parse_args(argv)
    kernels = kernel_mode()
    default_train, default_test, _, _, img_size = PRESETS[args.preset]
    ran = {}
    run_json = os.path.join(args.output_dir, "accuracy_loop.json")
    if os.path.exists(run_json):
        with open(run_json) as f:
            ran = json.load(f)
    # The run's seed (its train order) and train set, as its result file
    # records them; the preset's where there is none.
    seed, train_size = ran.get("seed"), ran.get("train_size") or default_train
    cfg = preset_config(args.preset).replace(output_dir=args.output_dir)
    if args.bn_mode:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, bn_mode=args.bn_mode))
    if seed is not None:
        cfg = cfg.replace(seed=seed)
    cfg = cfg.replace(eval=dataclasses.replace(cfg.eval, flip_test=False))
    skel = skeletons.H36M
    synth = dict(img_size=img_size, easy_depth=True, hue_mode="index")
    samples = synthetic_samples(skel, args.test_size or default_test, 22, args.output_dir, **synth)
    train_samples = synthetic_samples(skel, train_size, 11, args.output_dir, **synth)
    if args.epoch in ("latest", "earliest"):
        epochs = CheckpointManager(args.output_dir).epochs()
        if not epochs:
            raise FileNotFoundError(f"no snapshot in {args.output_dir}/model_dump; train first")
        wanted = epochs[-1] if args.epoch == "latest" else epochs[0]
    else:
        wanted = int(args.epoch)
    state_dict, epoch = load_snapshot(args.output_dir, wanted)
    test_ds = PoseDataset("Human36M", skel, samples, False)
    train_ds = PoseDataset("Human36M", skel, train_samples, True)
    result = run(cfg, test_ds, state_dict["model"], args.device, batch=args.batch)
    result["k2"] = k2_report(cfg, train_ds, state_dict["model"], args.device, batches=args.k2_batches,
                             batch=args.batch)
    result["bn_reestimate"] = bn_reestimate_report(cfg, train_ds, test_ds, state_dict["model"], args.device,
                                                   frames=args.reestimate_frames)
    result.update(preset=args.preset, snapshot_epoch=epoch, seed=cfg.seed, train_size=train_size, kernels=kernels)
    if args.stats_out:
        model = build_pose_net(cfg, skel.joint_num, device="cpu",
                               state_dict={k: v.cpu() for k, v in state_dict["model"].items()})
        os.makedirs(os.path.dirname(os.path.abspath(args.stats_out)), exist_ok=True)
        np.savez_compressed(args.stats_out, **bn_fields(model))
        result["stats_out"] = args.stats_out
    name = "bf16_drift.json" if args.epoch == "latest" else f"bf16_drift_epoch{epoch}.json"
    path = os.path.join(args.output_dir, name)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    brief = {k: v for k, v in result.items() if k != "layers"}
    brief["bn_reestimate"] = {k: v for k, v in result["bn_reestimate"].items() if k != "var_ratio"}
    print(json.dumps(brief, indent=1))
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
