"""What the accuracy tools share (``accuracy_loop``, ``mpii2d_probe``,
``coco_probe``): synthetic JPEG sets, a timed train, the device line, and
the result file with its PASS / FAIL exit."""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Optional, Sequence

import torch

from ihpr_tpu_torch.config import Config
from ihpr_tpu_torch.data import skeletons
from ihpr_tpu_torch.data.datasets import PoseDataset, make_synthetic, materialize_synthetic
from ihpr_tpu_torch.tools import device_line


def scale_horizon(cfg: Config, end_epoch: Optional[int], default_end: int) -> Config:
    """``cfg`` trained for ``end_epoch`` epochs in place of its preset's
    ``default_end``, with the step-decay epochs scaled alike (as JAX's
    ``tools/accuracy_loop.py`` does: a decay left at the preset's epoch
    would freeze a longer run's plateau, or never come in a shorter one)."""
    if not end_epoch or end_epoch == default_end:
        return cfg
    scale = end_epoch / default_end
    return cfg.replace(optim=dataclasses.replace(
        cfg.optim, end_epoch=end_epoch,
        lr_dec_epoch=tuple(max(1, round(e * scale)) for e in cfg.optim.lr_dec_epoch),
    ))


def synthetic_samples(skel: skeletons.Skeleton, n: int, seed: int, out_dir: str, **kw) -> list:
    """``n`` synthetic samples of ``skel`` from ``seed``, their frames written
    as JPEGs under ``{out_dir}/imgs`` (files already there are reused), so
    that the loader reads them as it reads a real set. The frames are
    encoded on the CPU by cv2, the bytes the JAX package's tools train on,
    whatever device the run uses: nvJPEG's encode of the same frames cost
    the flagship 13-20 mm of unseen MPJPE at two seeds (PERF.md §6 PR 22).
    ``kw`` goes to ``make_synthetic`` (``img_size``, ``hue_mode``, ...)."""
    return materialize_synthetic(make_synthetic(skel, n, seed=seed, **kw), f"{out_dir}/imgs", device="cpu")


def device_info(device) -> dict:
    """The device the numbers come from: its type and, on a CUDA device, the
    card's name and power limit as ``nvidia-smi`` gives them."""
    device = torch.device(device)
    info = {"device": str(device), "gpu": None}
    if device.type == "cuda":
        name, limit = (part.strip() for part in device_line(device).split(",", 1))
        info["gpu"] = {"name": name, "power_limit": limit}
    return info


def train_timed(cfg: Config, datasets: Sequence[PoseDataset], device, continue_train: bool = False,
                end_epoch: Optional[int] = None, num_workers: int = 8):
    """Build a Trainer and run it to ``end_epoch``: (its final TrainState,
    {train_seconds (construction included, as JAX's tools count it),
    train_steps taken in this run, train_img_per_s over the train loop,
    loader_share: the loop's host time spent waiting for batches over its
    wall time})."""
    from ihpr_tpu_torch.engine.trainer import Trainer

    t0 = time.perf_counter()
    trainer = Trainer(cfg, datasets=list(datasets), num_workers=num_workers, continue_train=continue_train,
                      device=device)
    try:
        step0 = trainer.state.step
        t1 = time.perf_counter()
        state = trainer.train(end_epoch=end_epoch)
        loop_s = time.perf_counter() - t1
    finally:
        trainer.close()
    steps = state.step - step0
    stats = {
        "train_seconds": round(time.perf_counter() - t0, 1),
        "train_steps": steps,
        "train_img_per_s": round(steps * trainer.batch_size / loop_s, 1) if steps else None,
        "loader_share": round(trainer.loader_wait_s / loop_s, 4) if steps else None,
    }
    return state, stats


def evaluate(cfg: Config, dataset: PoseDataset, state, device, num_workers: int = 4, keep: bool = False,
             **eval_kw):
    """``Tester(cfg, dataset, state).evaluate()`` with ``eval_kw`` replacing
    fields of ``cfg.eval``: (metrics, eval seconds, the Tester: closed
    unless ``keep``, and then the caller closes it)."""
    from ihpr_tpu_torch.engine.tester import Tester

    if eval_kw:
        cfg = cfg.replace(eval=dataclasses.replace(cfg.eval, **eval_kw))
    tester = Tester(cfg, dataset=dataset, state=state, num_workers=num_workers, device=device)
    t0 = time.perf_counter()
    try:
        metrics = tester.evaluate()
    except BaseException:
        tester.close()
        raise
    if not keep:
        tester.close()
    return metrics, round(time.perf_counter() - t0, 1), tester


def finish(tool: str, out_dir: str, result: dict, ok: bool, rows: Sequence[str] = ()):
    """Write ``{out_dir}/{tool}.json``, print ``rows`` and ``{tool}: PASS``
    or ``FAIL``, and exit 0 or 1."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{tool}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {path}")
    for row in rows:
        print(row)
    print(f"{tool}:", "PASS" if ok else "FAIL")
    sys.exit(0 if ok else 1)


def probe_2d(argv, doc: str, tool: str, config: str, skel: skeletons.Skeleton, seeds: tuple, metric: str,
             json_key: str, bar: float, artifact: Optional[str] = None, train_size: int = 4096,
             test_size: int = 256, end_epoch: int = 40):
    """The 2-D probes of JAX's ``tools/mpii2d_probe.py`` and
    ``tools/coco_probe.py``: train ``config`` (augmentation off, 40 epochs,
    decay at 30 and 36, snapshots every 20, two kept) on ``train_size``
    synthetic frames of ``skel`` from ``seeds[0]``, score ``metric`` through
    the Tester on ``test_size`` unseen frames from ``seeds[1]`` (320 pixels
    square, flip-test off: index-coded hues are not mirror-consistent),
    write ``{output_dir}/{tool}.json`` (JAX's keys, with ``json_key`` for
    the metric, plus the device and the train loop's rate and loader share)
    and exit 0 if the metric reaches ``bar``. ``artifact``: a result file
    under ``{output_dir}/result`` the Tester must have written. The command
    line takes ``--device`` and ``--output_dir`` only; ``end_epoch`` other
    than 40 scales the decay epochs with it."""
    import argparse

    from ihpr_tpu_torch.config import get_config
    from ihpr_tpu_torch.utils.shutdown import install_graceful_shutdown

    install_graceful_shutdown()
    ap = argparse.ArgumentParser(description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--output_dir", default=f"output/{tool}")
    args = ap.parse_args(argv)
    out_dir, device = args.output_dir, torch.device(args.device)
    base = get_config(config)
    cfg = base.replace(
        name=tool, output_dir=out_dir,
        data=dataclasses.replace(base.data, use_aug=False),
        optim=dataclasses.replace(base.optim, end_epoch=40, lr_dec_epoch=(30, 36), snapshot_interval=20,
                                  snapshot_keep=2),
        eval=dataclasses.replace(base.eval, flip_test=False),
    )
    cfg = scale_horizon(cfg, end_epoch, 40)
    name = cfg.data.trainset[0]
    train = synthetic_samples(skel, train_size, seeds[0], out_dir, img_size=320)
    test = synthetic_samples(skel, test_size, seeds[1], out_dir, img_size=320)
    state, stats = train_timed(cfg, [PoseDataset(name, skel, train, True)], device)
    metrics, eval_s, _ = evaluate(cfg, PoseDataset(name, skel, test, False), state, device, num_workers=8)
    value = metrics[metric]
    print(f"\n{metric} on {test_size} unseen synthetic {name} frames: {value:.4f} (bar {bar})")
    result = dict(
        config=cfg.name, **{json_key: round(value, 4)}, bar=bar, train_size=train_size,
        test_size=test_size, end_epoch=cfg.optim.end_epoch, train_seconds=stats["train_seconds"],
        metrics={k: round(v, 4) for k, v in metrics.items()}, eval_seconds=eval_s, **device_info(device),
        **{k: stats[k] for k in ("train_steps", "train_img_per_s", "loader_share")},
    )
    if artifact is not None:
        path = os.path.join(out_dir, "result", artifact)
        if not os.path.exists(path):
            raise AssertionError(f"the Tester wrote no {path}")
        result["artifact"] = path
    finish(tool, out_dir, result, value >= bar)
