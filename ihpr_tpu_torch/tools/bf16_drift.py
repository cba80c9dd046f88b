"""Where bf16 inference of trained weights departs from fp32, layer by
layer: the localisation tool for a trained ``accuracy_loop`` run.

    python -m ihpr_tpu_torch.tools.bf16_drift --preset flagship --output_dir D [--bn_mode lean]
        [--stats_out F.npz] [--batch 32] [--device cuda]

It reads the latest snapshot in ``D`` (an ``accuracy_loop`` run's
``--output_dir``) and the preset's unseen test frames (seeded; their JPEGs
are the ones that run cached in ``D``), then:

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
   running variance (float32, keyed ``<module>.<field>``) to an npz.

Writes ``{output_dir}/bf16_drift.json`` and prints a summary. Every model
runs in ``"highest"`` precision (TF32 off), as the accuracy tools do.
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
from ihpr_tpu_torch.engine.checkpoint import load_snapshot
from ihpr_tpu_torch.engine.tester import metrics_from_voxel_preds
from ihpr_tpu_torch.models.head import Deconv
from ihpr_tpu_torch.models.pose_net import build_pose_net, inference_copy
from ihpr_tpu_torch.models.resnet import BN, BasicBlock, Bottleneck
from ihpr_tpu_torch.ops import fused_head_integral as fhi
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


def run(cfg, test_ds: PoseDataset, state_dict: dict, device, batch: int = 32, num_workers: int = 4) -> dict:
    """Steps 1-3 of the module docstring on ``state_dict`` (a PoseNet's):
    the result dict."""
    device = torch.device(device)
    mode = cfg.model.bn_mode
    other = next(m for m in ARITHMETICS if m != mode)

    def build(**kw):
        c = cfg.replace(model=dataclasses.replace(cfg.model, matmul_precision="highest", **kw))
        return inference_copy(build_pose_net(c, test_ds.joint_num, device=device, state_dict=state_dict))

    bf16 = dict(compute_dtype="bfloat16", fp32_logits=False)
    models = {"fp32": build(compute_dtype="float32", fp32_logits=True), mode: build(**bf16),
              other: build(bn_mode=other, **bf16)}
    loader = BatchLoader([test_ds], cfg, cfg.eval.batch_size_per_device, train=False, num_workers=num_workers,
                         device=device)
    try:
        flip_perm = torch.as_tensor(skeletons.get_skeleton(test_ds.name).flip_permutation())
        images = [(patch_batch(b, cfg, flip_perm, train=False).image, idx)
                  for b, idx in prefetch_to_device(loader.epoch(), device)]
        variants = {
            f"bf16 {mode}": models[mode].coords,
            "fp32": models["fp32"].coords,
            f"bf16 {other}": models[other].coords,
            "bf16 backbone + fp32 head": _hybrid(models[mode], models["fp32"]),
            "fp32 backbone + bf16 head": _hybrid(models["fp32"], models[mode]),
        }
        mpjpe = {}
        n = len(loader.index)
        for label, fn in variants.items():
            preds = np.zeros((n, test_ds.joint_num, 3), np.float32)
            with torch.inference_mode():
                for image, idx in images:
                    preds[idx] = fn(image).float().cpu().numpy()
            mpjpe[label] = round(metrics_from_voxel_preds(cfg, loader, test_ds, preds)[0]["MPJPE total"], 2)
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
    args = ap.parse_args(argv)
    _, default_test, _, _, img_size = PRESETS[args.preset]
    cfg = preset_config(args.preset).replace(output_dir=args.output_dir)
    if args.bn_mode:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, bn_mode=args.bn_mode))
    cfg = cfg.replace(eval=dataclasses.replace(cfg.eval, flip_test=False))
    skel = skeletons.H36M
    samples = synthetic_samples(skel, args.test_size or default_test, 22, args.output_dir,
                                img_size=img_size, easy_depth=True, hue_mode="index")
    state_dict, epoch = load_snapshot(args.output_dir)
    result = run(cfg, PoseDataset("Human36M", skel, samples, False), state_dict["model"], args.device,
                 batch=args.batch)
    result.update(preset=args.preset, snapshot_epoch=epoch)
    if args.stats_out:
        model = build_pose_net(cfg, skel.joint_num, device="cpu",
                               state_dict={k: v.cpu() for k, v in state_dict["model"].items()})
        os.makedirs(os.path.dirname(os.path.abspath(args.stats_out)), exist_ok=True)
        np.savez_compressed(args.stats_out, **bn_fields(model))
        result["stats_out"] = args.stats_out
    path = os.path.join(args.output_dir, "bf16_drift.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "layers"}, indent=1))
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
