"""End-to-end accuracy evidence, the port of JAX's ``tools/accuracy_loop.py``:
synthetic train -> Tester MPJPE -> an oracle on the CPU.

No real Human3.6M frames or ImageNet weights are in the repository, so the
strongest accuracy proxy there is:

1. train on synthetic but learnable frames (a Gaussian blob per joint, its
   hue coding the joint and its radius the depth;
   ``datasets.render_synthetic_image``), written as JPEGs by cv2 on the
   CPU (the JAX tool's bytes; ``_accuracy.synthetic_samples``) and read
   back through the loader, until the unseen set beats a stated MPJPE bar
   through the whole eval chain (Tester -> warp back -> pixel2cam -> root
   alignment -> per-action MPJPE; reference ``Human36M.evaluate``);
2. run the same trained weights through the port on the CPU (fp32,
   ``"highest"``, the plain versions of K1-K4) on the same loader patches
   and through the same ``metrics_from_voxel_preds``: the gap to the
   card's fp32 eval must stay within ``--oracle_tol_mm``. JAX's oracle is a
   torch re-implementation of the reference (``tools/torch_reference.py``),
   which the port does not carry; the port's independence from itself is
   held by its CPU test against JAX's Tester on the same weights
   (``tests/test_torch_accuracy.py``, through ``models.convert.to_jax_params``).

The presets are JAX's, with its seeds (train 11, test 22, MPII mix 33),
frame sizes, epochs, decay epochs (rescaled under ``--end_epoch``),
snapshot interval and keep, and bars:

- ``tiny``: ResNet-18 at 128x128, 32^3 volume, fp32, batch 32, 4096 / 256
  frames, 60 epochs, bar 130 mm; its fp32 head has JAX's fused plan (J*D =
  576 padded to 20 joints), so it trains on K1-fp32 / K2-fp32;
- ``flagship``: ``h36m3d_r50`` (bf16, batch 128) without augmentation,
  8192 / 256 frames, 60 epochs, bar 75 mm; K1 / K2;
- ``r152``: ``h36m3d_r152_384``, 2048 / 128 frames, 30 epochs, bar 250 mm;
  K1 / K2.

Every preset runs with ``matmul_precision="highest"`` (TF32 off), as JAX's
tool runs fp32 in true fp32. The Trainer starts from JAX's own initial
weights for the config's seed (``models/jax_random.py``: the values JAX's
Trainer draws, computed without JAX), so a run and JAX's tool at one seed
train one model. ``--seed`` sets that seed (model init and the loader's
order; JAX's presets use 0); the synthetic sets keep theirs. ``--bn_mode`` overrides the preset's BN
arithmetic, as JAX's does, with any of JAX's modes (``models.resnet.BN_MODES``:
``flax``, ``lean`` and the measurement modes); an unknown one raises before
anything is rendered; the result records the mode the run used. ``--platform`` is ``--device`` here
(``cuda`` by default, ``cpu`` on request).

Writes ``{output_dir}/accuracy_loop.json`` with JAX's keys plus the device
(the card's name and power limit), the train loop's img/s and the share of
its wall time spent waiting for the loader, and under ``"kernels"`` the
kernel switch the run read (``IHPR_PALLAS``: ``auto``, or ``off`` for the
plain versions of K1-K8 on the card); prints the markdown row and
``accuracy_loop: PASS`` or ``FAIL``, and exits 0 or 1 by JAX's rule:

    python -m ihpr_tpu_torch.tools.accuracy_loop --preset tiny
    python -m ihpr_tpu_torch.tools.accuracy_loop --preset flagship --output_dir output/accuracy_flagship
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ihpr_tpu_torch.config import DataConfig, ModelConfig, OptimConfig, get_config
from ihpr_tpu_torch.data import skeletons
from ihpr_tpu_torch.data.datasets import PoseDataset
from ihpr_tpu_torch.data.pipeline import prefetch_to_device
from ihpr_tpu_torch.engine.tester import metrics_from_voxel_preds
from ihpr_tpu_torch.models.pose_net import build_pose_net, inference_copy
from ihpr_tpu_torch.models.resnet import BN_MODES, bn_subsample
from ihpr_tpu_torch.ops.integral_volume import kernel_mode
from ihpr_tpu_torch.parallel.train_step import make_eval_step
from ihpr_tpu_torch.tools._accuracy import (
    device_info,
    evaluate,
    finish,
    scale_horizon,
    synthetic_samples,
    train_timed,
)

# preset: (train frames, test frames, epochs, MPJPE bar in mm, frame size)
PRESETS = {
    "tiny": (4096, 256, 60, 130.0, 400),
    "flagship": (8192, 256, 60, 75.0, 320),
    "r152": (2048, 128, 30, 250.0, 320),
}


def preset_config(preset: str):
    """The preset's Config (JAX's, before ``--end_epoch`` and the run's
    flags)."""
    if preset == "tiny":
        # R18 at 128^2, 32^3 volume: at 64^2 the warped blobs shrink below
        # ~2 px and the depth-coding radius aliases away.
        return get_config("h36m3d_r50").replace(
            name="accuracy_tiny",
            model=ModelConfig(resnet_type=18),
            data=DataConfig(trainset=("Human36M",), input_shape=(128, 128), output_shape=(32, 32), depth_dim=32,
                            use_aug=False),
            optim=OptimConfig(batch_size_per_device=32, end_epoch=60, lr=1e-3, lr_dec_epoch=(45, 55),
                              snapshot_interval=20, snapshot_keep=2),
        )
    base, name, epochs, decay, interval = {
        "flagship": ("h36m3d_r50", "accuracy_flagship", 60, (45, 55), 20),
        "r152": ("h36m3d_r152_384", "accuracy_r152", 30, (22, 27), 15),
    }[preset]
    cfg = get_config(base)
    return cfg.replace(
        name=name,
        data=dataclasses.replace(cfg.data, trainset=("Human36M",), use_aug=False),
        optim=dataclasses.replace(cfg.optim, end_epoch=epochs, lr_dec_epoch=decay, snapshot_interval=interval,
                                  snapshot_keep=2),
    )


def oracle_preds(cfg, loader, joint_num: int, state_dict) -> np.ndarray:
    """The trained weights through the port on the CPU in fp32 "highest"
    (plain K1-K4), on ``loader``'s patches (the card Tester's loader: its
    frames decoded where it decodes them) and with ``cfg.eval.flip_test``:
    (N, J, 3) voxel coords in ``loader.index`` order."""
    cpu_cfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32", fp32_logits=True,
                                                    matmul_precision="highest"))
    model = build_pose_net(cpu_cfg, joint_num, device="cpu",
                           state_dict={k: v.to("cpu") for k, v in state_dict.items()})
    step = make_eval_step(inference_copy(model), cpu_cfg)
    n = len(loader.index)
    preds = np.zeros((n, joint_num, 3), np.float32)
    seen = np.zeros(n, bool)
    for batch, idx in prefetch_to_device(loader.epoch(), "cpu"):
        preds[idx] = step(batch)[0].numpy()
        seen[idx] = True
    if not seen.all():
        raise AssertionError(f"{int((~seen).sum())} test samples got no oracle prediction")
    return preds


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", choices=sorted(PRESETS), default="tiny")
    ap.add_argument("--train_size", type=int, default=None)
    ap.add_argument("--test_size", type=int, default=None)
    ap.add_argument("--end_epoch", type=int, default=None)
    ap.add_argument("--mpjpe_bar_mm", type=float, default=None)
    ap.add_argument("--oracle_tol_mm", type=float, default=1.0)
    ap.add_argument("--output_dir", default=None, help="default output/accuracy_<preset>")
    ap.add_argument("--skip_oracle", action="store_true")
    ap.add_argument("--hue_mode", choices=["index", "semantic"], default=None,
                    help="synthetic hue coding; 'semantic' renders mirror-consistently (required for "
                    "--flip_ab / --use_aug, and forced on by them)")
    ap.add_argument("--flip_ab", action="store_true",
                    help="after the headline (no-flip) eval, evaluate with flip_test=True and require "
                    "MPJPE_flip <= MPJPE_noflip + --flip_tol_mm")
    ap.add_argument("--flip_tol_mm", type=float, default=2.0)
    ap.add_argument("--use_aug", action="store_true",
                    help="train with the full augmentation; the bar is relaxed by --aug_bar_mult")
    ap.add_argument("--aug_bar_mult", type=float, default=1.4)
    ap.add_argument("--mixed", action="store_true",
                    help="mix a synthetic MPII (2-D only) trainset into the Human36M one, coded in the "
                    "Human36M hues; the bar is unchanged")
    ap.add_argument("--mixed_size", type=int, default=None, help="MPII frames (default: --train_size)")
    ap.add_argument("--bn_mode", default=None,
                    help=f"override cfg.model.bn_mode with one of JAX's modes {BN_MODES} (JAX's flag; "
                    "lean_subN: lean_sub2, lean_sub4, ...)")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    ap.add_argument("--seed", type=int, default=None,
                    help="the config's seed: JAX's initial weights for it and the loader's order (default: the "
                    "preset's, 0)")
    ap.add_argument("--continue", dest="continue_train", action="store_true",
                    help="resume from the latest snapshot in --output_dir (the synthetic sets are seeded and "
                    "their JPEGs cached there, so the resumed run sees the same stream)")
    return ap.parse_args(argv)


def main(argv=None):
    from ihpr_tpu_torch.utils.shutdown import install_graceful_shutdown

    install_graceful_shutdown()
    args = parse_args(argv)
    if args.bn_mode is not None:
        bn_subsample(args.bn_mode)  # raises for a mode that is not JAX's
    hue_mode = args.hue_mode or ("semantic" if (args.flip_ab or args.use_aug) else "index")
    if (args.flip_ab or args.use_aug) and hue_mode != "semantic":
        raise SystemExit("--flip_ab/--use_aug need --hue_mode semantic")
    device = torch.device(args.device)
    default_train, default_test, default_end, default_bar, img_size = PRESETS[args.preset]
    train_size = args.train_size or default_train
    test_size = args.test_size or default_test
    end_epoch = args.end_epoch or default_end
    bar = args.mpjpe_bar_mm or default_bar
    out_dir = args.output_dir or f"output/accuracy_{args.preset}"

    cfg = scale_horizon(preset_config(args.preset), args.end_epoch, default_end)
    # True fp32: TF32 would move coords by a fraction of a voxel against the
    # fp32 oracle, and the gap would measure rounding, not the port.
    cfg = cfg.replace(output_dir=out_dir, model=dataclasses.replace(cfg.model, matmul_precision="highest"))
    if args.bn_mode:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, bn_mode=args.bn_mode))
    if args.seed is not None:
        cfg = cfg.replace(seed=args.seed)
    if args.use_aug:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, use_aug=True))
        bar *= args.aug_bar_mult
    # The headline eval is flip_test=False in every mode, so numbers stay
    # comparable; 'index' hues are not mirror-consistent.
    cfg = cfg.replace(eval=dataclasses.replace(cfg.eval, flip_test=False))

    skel = skeletons.H36M
    synth = dict(img_size=img_size, easy_depth=True, hue_mode=hue_mode)
    train_samples = synthetic_samples(skel, train_size, 11, out_dir, **synth)
    test_samples = synthetic_samples(skel, test_size, 22, out_dir, **synth)
    train_ds = PoseDataset("Human36M", skel, train_samples, True)
    test_ds = PoseDataset("Human36M", skel, test_samples, False)
    train_datasets = [train_ds]
    mixed_size = 0
    if args.mixed:
        mixed_size = train_size if args.mixed_size is None else args.mixed_size
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, trainset=("Human36M", "MPII")))
        mpii = synthetic_samples(skeletons.MPII, mixed_size, 33, out_dir, img_size=img_size,
                                 hue_mode=hue_mode, hue_skeleton=skel)
        if mpii:  # --mixed_size 0: the config alone, as a control
            train_datasets.append(PoseDataset("MPII", skeletons.MPII, mpii, True))

    state, stats = train_timed(cfg, train_datasets, device, continue_train=args.continue_train,
                               end_epoch=end_epoch)
    metrics, eval_s, tester = evaluate(cfg, test_ds, state, device, keep=not args.skip_oracle)
    ours = metrics["MPJPE total"]
    print(f"\nours ({device.type}) MPJPE total: {ours:.2f} mm (bar {bar:.0f} mm)")

    # Memorisation against generalisation: the same eval on a train subset,
    # in a directory of its own so the headline result files stay.
    aux = dict(dump_artifacts=False)
    train_mpjpe = evaluate(cfg.replace(output_dir=f"{out_dir}/train_subset"),
                           PoseDataset("Human36M", skel, train_samples[:test_size], False), state, device,
                           **aux)[0]["MPJPE total"]
    print(f"train-subset MPJPE total: {train_mpjpe:.2f} mm")
    flip_mpjpe = None
    if args.flip_ab:
        flip_mpjpe = evaluate(cfg.replace(output_dir=f"{out_dir}/flip_eval"), test_ds, state, device,
                              flip_test=True, **aux)[0]["MPJPE total"]
        print(f"flip-test MPJPE total: {flip_mpjpe:.2f} mm (no-flip {ours:.2f}, tol +{args.flip_tol_mm} mm)")

    result = {
        "preset": args.preset,
        "hue_mode": hue_mode,
        "use_aug": bool(args.use_aug),
        "mixed_mpii_size": mixed_size,
        "config": cfg.name,
        "resnet": cfg.model.resnet_type,
        "bn_mode": cfg.model.bn_mode,
        "seed": cfg.seed,
        "kernels": kernel_mode(),
        "input_shape": list(cfg.data.input_shape),
        "depth_dim": cfg.data.depth_dim,
        "train_size": train_size,
        "test_size": test_size,
        "end_epoch": end_epoch,
        "train_seconds": stats["train_seconds"],
        "eval_seconds": eval_s,
        "mpjpe_bar_mm": bar,
        "mpjpe_ours_mm": round(ours, 2),
        "mpjpe_flip_mm": None if flip_mpjpe is None else round(flip_mpjpe, 2),
        "mpjpe_train_subset_mm": round(train_mpjpe, 2),
        "metrics_ours": {k: round(v, 2) for k, v in metrics.items()},
        **device_info(device),
        **{k: stats[k] for k in ("train_steps", "train_img_per_s", "loader_share")},
    }

    if not args.skip_oracle:
        try:
            # The oracle is fp32: compare it with an fp32 eval of the same
            # weights (for bf16 presets a second eval; the headline stays
            # in the preset's dtype).
            if cfg.model.compute_dtype == "float32":
                ours_fp32 = ours
            else:
                # A model built in fp32 from the config: the trained one
                # keeps the preset's compute dtype whatever cfg says.
                cfg_fp32 = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32",
                                                                 fp32_logits=True),
                                       output_dir=f"{out_dir}/fp32_eval")
                fp32_model = build_pose_net(cfg_fp32, test_ds.joint_num, device=device,
                                            state_dict=state.model.state_dict())
                ours_fp32 = evaluate(cfg_fp32, test_ds, fp32_model, device, **aux)[0]["MPJPE total"]
                del fp32_model
                print(f"ours (fp32 eval, same weights) MPJPE total: {ours_fp32:.2f} mm")
                result["mpjpe_ours_fp32_mm"] = round(ours_fp32, 2)
            t0 = time.perf_counter()
            preds = oracle_preds(cfg, tester.loader, test_ds.joint_num, state.model.state_dict())
            oracle_s = time.perf_counter() - t0
        finally:
            tester.close()
        oracle_metrics = metrics_from_voxel_preds(cfg, tester.loader, test_ds, preds)[0]
        oracle = oracle_metrics["MPJPE total"]
        gap = abs(ours_fp32 - oracle)
        print(f"CPU oracle MPJPE total: {oracle:.2f} mm (|gap| {gap:.3f} mm vs fp32 eval, tol "
              f"{args.oracle_tol_mm} mm, {oracle_s:.0f}s)")
        result.update(
            mpjpe_torch_mm=round(oracle, 2),
            mpjpe_gap_mm=round(gap, 3),
            oracle_tol_mm=args.oracle_tol_mm,
            oracle_seconds=round(oracle_s, 1),
            metrics_torch={k: round(v, 2) for k, v in oracle_metrics.items()},
        )

    label = args.preset + ("+mpii" if args.mixed else "")
    gpu = result["gpu"]
    row = (f"| {label} | r{cfg.model.resnet_type} @ {cfg.data.input_shape[0]}^2, {cfg.data.depth_dim}^3 vol | "
           f"{train_size} imgs x {end_epoch} ep | {ours:.1f} | {result.get('mpjpe_torch_mm', float('nan')):.1f} | "
           f"{result.get('mpjpe_gap_mm', float('nan')):.3f} | {result['train_img_per_s']} img/s | "
           f"loader {result['loader_share']} | {gpu['name'] + ', ' + gpu['power_limit'] if gpu else device} |")
    ok = ours <= bar
    if not args.skip_oracle:
        ok = ok and result["mpjpe_gap_mm"] <= args.oracle_tol_mm
    if args.flip_ab:
        ok = ok and flip_mpjpe <= ours + args.flip_tol_mm
    finish("accuracy_loop", out_dir, result, ok, rows=[row])


if __name__ == "__main__":
    main()
