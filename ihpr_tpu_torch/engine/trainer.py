"""Trainer: the epoch loop wiring data -> train step, counterpart of
``ihpr_tpu.engine.trainer`` on one device.

Builds the train datasets (synthetic only in the port), the host-warp
``BatchLoader``, a trainable ``PoseNet`` and its optimizer, then runs
epochs of ``make_train_step``: the full-metrics step at log points, the
loss-only step between them. The current epoch's losses stay on the
device in ``losses`` (cleared when the next epoch starts, so a long run
holds one epoch of them); the loop reads metrics on the host only at log
points.
Checkpoints, resume, the host-RSS watchdog and the profiler window of the
JAX trainer are not ported.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Sequence

import torch

from ihpr_tpu_torch.config import Config
from ihpr_tpu_torch.data import skeletons
from ihpr_tpu_torch.data.datasets import PoseDataset, build_dataset
from ihpr_tpu_torch.data.pipeline import BatchLoader, prefetch_to_device
from ihpr_tpu_torch.models.pose_net import build_pose_net
from ihpr_tpu_torch.parallel.train_step import (
    TrainState,
    create_train_state,
    make_lr_schedule,
    make_train_step,
)

logger = logging.getLogger(__name__)
_LOG_EVERY = 50  # steps between full-metrics log lines (the JAX trainer's)


class Trainer:
    def __init__(
        self,
        cfg: Config,
        data_root: Optional[str] = None,
        datasets: Optional[Sequence[PoseDataset]] = None,
        num_workers: int = 8,
        synthetic_size: int = 512,
        device="cuda",
    ):
        self.cfg = cfg
        self.device = torch.device(device)
        if datasets is None:
            # Secondary datasets render in the primary skeleton's hue space,
            # so joint identity is coded alike across the mix.
            primary = skeletons.get_skeleton(cfg.data.trainset[0])
            datasets = [
                build_dataset(name, "train", cfg, data_root, synthetic_size,
                              hue_skeleton=primary if i else None)
                for i, name in enumerate(cfg.data.trainset)
            ]
        self.batch_size = cfg.optim.batch_size_per_device
        self.loader = BatchLoader(datasets, cfg, self.batch_size, num_workers=num_workers, seed=cfg.seed)
        self.steps_per_epoch = len(self.loader)
        logger.info(
            "train: %d samples (%s), batch %d, %d steps/epoch, on %s",
            sum(len(d) for d in datasets), "+".join(d.name for d in datasets),
            self.batch_size, self.steps_per_epoch, self.device,
        )
        self.model = build_pose_net(cfg, self.loader.joint_num, device=self.device, trainable=True)
        self.max_steps: Optional[int] = None  # set by cap_steps_per_epoch
        self.start_epoch = 0
        self.losses: List[torch.Tensor] = []  # the current epoch's losses, on the device
        self._make_steps()

    def _make_steps(self):
        """Optimizer, schedule and step functions for the current epoch
        length (the decay boundaries are counted in steps)."""
        self.state: TrainState = create_train_state(self.model, self.cfg, self.steps_per_epoch)
        opt, sched = self.state.optimizer, self.state.scheduler
        self.step_fn = make_train_step(self.model, opt, self.cfg, scheduler=sched)
        self.lean_step_fn = make_train_step(self.model, opt, self.cfg, lean=True, scheduler=sched)
        self.lr_sched = make_lr_schedule(self.cfg, self.steps_per_epoch)

    def cap_steps_per_epoch(self, n: int):
        """Shrink epochs to n steps (smoke runs). Rebuilds the optimizer and
        schedule so the decay boundaries follow the capped epoch length."""
        self.steps_per_epoch = min(n, self.steps_per_epoch)
        self.max_steps = self.steps_per_epoch
        self._make_steps()

    def close(self):
        self.loader.close()

    def train(self, end_epoch: Optional[int] = None) -> TrainState:
        """Run epochs [start_epoch, end_epoch) (``cfg.optim.end_epoch`` by
        default); a later call continues from there."""
        end_epoch = end_epoch or self.cfg.optim.end_epoch
        for epoch in range(self.start_epoch, end_epoch):
            batches = prefetch_to_device(self.loader.epoch(epoch, self.max_steps), self.device)
            self.losses = []
            window_start, window_steps = time.perf_counter(), 0
            for itr, (batch, _) in enumerate(batches):
                log_step = itr % _LOG_EVERY == 0 or itr == self.steps_per_epoch - 1
                metrics = (self.step_fn if log_step else self.lean_step_fn)(batch)
                self.state.step += 1
                self.losses.append(metrics["loss"])
                window_steps += 1
                if log_step:
                    vals = {k: float(v) for k, v in metrics.items()}  # waits for the device
                    now = time.perf_counter()
                    itr_time = (now - window_start) / window_steps
                    window_start, window_steps = now, 0
                    logger.info(
                        "epoch %d/%d itr %d/%d: lr %.2e loss %.4f |g| %.3f err xy %.2f z %.2f vox "
                        "%.1f ms/itr %.1f img/s",
                        epoch, end_epoch, itr, self.steps_per_epoch,
                        self.lr_sched(self.state.step), vals["loss"], vals["grad_norm"],
                        vals["err_xy_voxels"], vals["err_z_voxels"], itr_time * 1e3,
                        self.batch_size / max(itr_time, 1e-9),
                    )
            self.start_epoch = epoch + 1
        return self.state
