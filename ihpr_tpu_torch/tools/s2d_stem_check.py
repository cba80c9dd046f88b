"""The space-to-depth stem's fp32 arithmetic on the card, held against
float64.

``models.resnet.S2DStem`` with the 7x7 stem embedded (``s2d_stem_kernel``)
is the 7x7 stride-2 stem in exact arithmetic. For one batch of the
flagship's stem input (h36m3d_r50: batch 32, 3 x 256 x 256, fp32, TF32 off)
this prints each route's largest and mean error, relative to the output's
largest magnitude, against the 7x7 stem computed in float64, and the CUDA
kernels each route launched (``torch.profiler``):

- ``7x7``: the 7x7 stride-2 stem (``Conv``);
- ``s2d``: ``S2DStem`` in one process;
- ``s2d_nocudnn``: the same with cuDNN off (ATen's own conv);
- ``s2d_grid``: ``S2DStem`` as each rank of an S = 2 grid computes it
  (image rows [2a - 4, 2b + 2) of its stem rows [a, b), the 4x4 conv
  unpadded in H), both halves concatenated.

Then the loss of one fp32 "highest" train step of h36m3d_r50 at that batch
(synthetic samples, weights drawn by torch from ``--seed``, the head
peaked) under the witnesses of ``train_losses``: the 7x7 and the s2d stem,
each with other arithmetic for its stem or for the whole step. One JSON
line at the end holds the numbers.

    python -m ihpr_tpu_torch.tools.s2d_stem_check [--batch 32] [--device cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json

import numpy as np
import torch
import torch.nn.functional as F

from ihpr_tpu_torch.models.resnet import S2DStem, s2d_stem_kernel
from ihpr_tpu_torch.parallel.mesh import row_range, s2d_needs


def _grid_stem(stem: S2DStem, x: torch.Tensor, world: int) -> torch.Tensor:
    """The s2d stem's output as ``world`` row shards compute it, concatenated."""
    h = x.shape[2]
    outs = []
    for r, (lo, hi) in enumerate(s2d_needs(h, world)):
        a, b = row_range(h // 2, r, world)
        if b == a:
            continue
        block = x[:, :, max(lo, 0):min(hi, h)]
        block = F.pad(block, (0, 0, max(-lo, 0), max(hi - h, 0)))
        bb, c, hh, ww = block.shape
        s = block.reshape(bb, c, hh // 2, 2, ww // 2, 2).permute(0, 3, 5, 1, 2, 4).reshape(bb, 4 * c, hh // 2, ww // 2)
        s = F.pad(s.contiguous(memory_format=torch.channels_last), (2, 1, 0, 0))
        outs.append(F.conv2d(s, stem.weight))
    return torch.cat(outs, 2)


def _kernels(fn) -> list:
    """The CUDA kernels one call of ``fn`` launched, by name (empty where the
    profiler sees no device activity)."""
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sorted({e.name for e in prof.events() if e.device_type.name == "CUDA"})
    except Exception as e:  # the trace is context only
        return [f"profiler failed: {e!r}"]


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def stem_errors(batch: int, size: int, device: str, seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, 3, size, size, generator=gen).to(device).contiguous(memory_format=torch.channels_last)
    w7 = (torch.randn(64, 3, 7, 7, generator=gen) * 0.1).to(device)
    stem = S2DStem(3, 64, torch.float32, device=device)
    with torch.no_grad():
        stem.weight.copy_(s2d_stem_kernel(w7))
    stem.weight.data = stem.weight.data.contiguous(memory_format=torch.channels_last)
    w7 = w7.contiguous(memory_format=torch.channels_last)
    ref = F.conv2d(x.double(), w7.double(), stride=2, padding=3)
    scale = float(ref.abs().max())

    def no_cudnn():
        with torch.backends.cudnn.flags(enabled=False):
            return stem(x)

    routes = {
        "7x7": lambda: F.conv2d(x, w7, stride=2, padding=3),
        "s2d": lambda: stem(x),
        "s2d_nocudnn": no_cudnn,
        "s2d_grid": lambda: _grid_stem(stem, x, 2),
    }
    out = {}
    with _no_tf32(), torch.no_grad():
        for name, fn in routes.items():
            err = (fn().double() - ref).abs()
            out[name] = {"max_rel": float(err.max()) / scale, "mean_rel": float(err.mean()) / scale,
                         "kernels": _kernels(fn) if device == "cuda" else []}
    return out


def _peak_head(model, image: torch.Tensor, gen: torch.Generator):
    """Redraw the final conv so the heatmap logits have std ~4 in ``model``'s
    mode (as ``chip_smoke.py``'s ``_peak_heatmaps``): the init's near-flat
    heatmaps put every coordinate at the volume centre, where the loss
    hardly depends on the features."""
    with torch.inference_mode():
        feat = model.head.features(model.backbone(image.permute(0, 3, 1, 2)))
        rms = float(feat.float().pow(2).mean().sqrt())
        w = model.head.final.weight
        w.copy_(torch.randn(w.shape, generator=gen) * (4.0 / (rms * w.shape[0] ** 0.5)))


def train_losses(batch: int, device: str, seed: int, peak_in_train_mode: bool) -> dict:
    """One fp32 "highest" train step's loss of h36m3d_r50 from one state
    and one batch, under each witness: the 7x7 stem; its conv with cuDNN
    off; its weight perturbed by 1e-7 relative; the whole step with cuDNN's
    deterministic algorithms; the s2d stem (the 7x7 embedded); its conv
    with cuDNN off; the whole s2d step deterministic. The head is peaked in
    train mode (``peak_in_train_mode``), or in eval mode: train-mode BN
    then scales the logits far past std 4, the heatmaps' softmax saturates
    and the coordinates fall on whole voxels, so the loss is a step
    function of the features (a joint whose two best voxels nearly tie
    jumps between them)."""
    from ihpr_tpu_torch.config import get_config
    from ihpr_tpu_torch.data import skeletons
    from ihpr_tpu_torch.data.augment import finalize_patch
    from ihpr_tpu_torch.data.datasets import build_dataset
    from ihpr_tpu_torch.data.pipeline import BatchLoader
    from ihpr_tpu_torch.models.pose_net import build_pose_net
    from ihpr_tpu_torch.parallel.train_step import make_optimizer, make_train_step

    cfg = get_config("h36m3d_r50")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32", matmul_precision="highest"),
                      optim=dataclasses.replace(cfg.optim, batch_size_per_device=batch))
    primary = skeletons.get_skeleton(cfg.data.trainset[0])
    sets = [build_dataset(name, "train", cfg, "synthetic", batch, hue_skeleton=primary if i else None)
            for i, name in enumerate(cfg.data.trainset)]
    loader = BatchLoader(sets, cfg, batch, num_workers=4, seed=cfg.seed)
    hb = next(loader.epoch(0, 1))
    loader.close()
    fields = ("patch", "color_scale", "joint_img", "joint_vis", "joints_have_depth")
    data = {f: torch.from_numpy(np.asarray(getattr(hb, f))).to(device) for f in fields}
    gen = torch.Generator().manual_seed(seed)
    net = build_pose_net(cfg, device=device, generator=gen, trainable=peak_in_train_mode)
    _peak_head(net, finalize_patch(data["patch"], data["color_scale"], cfg.data), gen)
    sd7 = {k: v.detach().clone() for k, v in net.state_dict().items()}
    del net
    w = sd7["backbone.conv1.weight"]
    noise = torch.randn(w.shape, generator=torch.Generator().manual_seed(seed + 1)).to(w.device)
    sd7p = {**sd7, "backbone.conv1.weight": w * (1 + 1e-7 * noise)}
    sds = {**sd7, "backbone.conv1.weight": s2d_stem_kernel(w)}
    cfg_s2d = cfg.replace(model=dataclasses.replace(cfg.model, s2d_stem=True))
    no_cudnn = lambda: torch.backends.cudnn.flags(enabled=False)  # noqa: E731
    deterministic = lambda: torch.backends.cudnn.flags(enabled=True, deterministic=True)  # noqa: E731
    runs = (("7x7", cfg, sd7, None, None), ("7x7_stem_nocudnn", cfg, sd7, no_cudnn, None),
            ("7x7_stem_perturbed_1e-7", cfg, sd7p, None, None), ("7x7_deterministic", cfg, sd7, None, deterministic),
            ("s2d", cfg_s2d, sds, None, None), ("s2d_stem_nocudnn", cfg_s2d, sds, no_cudnn, None),
            ("s2d_deterministic", cfg_s2d, sds, None, deterministic))
    losses, gaps, ref, whole = {}, {}, {}, {}
    watched = ("backbone.conv1", "backbone.bn1", "backbone.layer1_0", "backbone.layer4_2", "head")
    for name, c, sd, stem_ctx, step_ctx in runs:
        model = build_pose_net(c, device=device, trainable=True, state_dict=sd)
        acts = {}

        def keep(module, inputs, out, acts=acts):  # the first output of each watched module
            acts.setdefault(module.watched_as, out.detach().float().clone())

        for mod in watched:
            model.get_submodule(mod).watched_as = mod
            model.get_submodule(mod).register_forward_hook(keep)
        if stem_ctx is not None:
            stem, forward = model.backbone.conv1, model.backbone.conv1.forward

            def stem_forward(x, forward=forward, stem_ctx=stem_ctx):
                with stem_ctx():  # ATen's own conv gives NCHW: back to the model's layout
                    return forward(x).contiguous(memory_format=torch.channels_last)

            stem.forward = stem_forward
        opt, sched = make_optimizer(model, c, 100)
        step = make_train_step(model, opt, c, scheduler=sched)
        with step_ctx() if step_ctx is not None else contextlib.nullcontext():
            losses[name] = float(step(data)["loss"])
        ref = ref or acts
        whole[name] = float((acts["head"] == acts["head"].round()).float().mean())
        gaps[name] = {m: float((acts[m] - ref[m]).abs().max() / ref[m].abs().max()) for m in watched}
        print(f"s2d_stem_check: head peaked in {'train' if peak_in_train_mode else 'eval'} mode, {name}: loss "
              f"{losses[name]:.7f}, coordinates on whole voxels {whole[name]:.3f}; train-mode outputs' largest gap "
              f"to the 7x7 run's, of its largest: " + ", ".join(f"{m} {g:.3g}" for m, g in gaps[name].items()),
              flush=True)
        del model, opt, step, acts
    return dict(losses=losses, gaps=gaps, whole_voxels=whole)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--size", type=int, default=256, help="the stem's input height and width")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--no_train", action="store_true", help="the stem alone, no train step")
    a = p.parse_args(argv)
    res = {"stem": stem_errors(a.batch, a.size, a.device, a.seed)}
    for name, r in res["stem"].items():
        print(f"s2d_stem_check: {name}: max {r['max_rel']:.3g}, mean {r['mean_rel']:.3g} of the output's largest "
              f"from float64; kernels {r['kernels']}")
    if not a.no_train:
        for mode in ("eval", "train"):
            res[f"peak_{mode}"] = r = train_losses(a.batch, a.device, a.seed, mode == "train")
            base = r["losses"]["7x7"]
            print(f"s2d_stem_check: head peaked in {mode} mode, one fp32 train step's loss (relative gap to the 7x7 "
                  f"stem's): " + ", ".join(f"{k} {v:.7f} ({abs(v - base) / abs(base):.3g})"
                                          for k, v in r["losses"].items()))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
