"""Trainer: the epoch loop wiring data -> train step -> snapshots, counterpart
of ``ihpr_tpu.engine.trainer``.

Builds the train datasets (from ``data_root``), the ``BatchLoader``
(host-warped patches where the native warp library is available, else
canvases warped on the device, as JAX's), a trainable ``PoseNet`` and its optimizer, then runs
epochs of ``make_train_step``: the full-metrics step at log points, the
loss-only step between them. The current epoch's losses stay on the
device in ``losses`` (cleared when the next epoch starts, so a long run
holds one epoch of them); the loop reads metrics on the host only at log
points. Snapshots go to ``{output_dir}/model_dump`` in the background
(``CheckpointManager``), the log to ``{output_dir}/log/train_logs.txt``.
``continue_train`` resumes from the latest snapshot, mid-epoch included,
bit for bit. A host-RSS watchdog snapshots and exits with ``EX_TEMPFAIL``
past its limit, and ``train(profile_dir=...)`` writes a ``torch.profiler``
trace of a window of steps.

Data-parallel (an initialized ``torch.distributed`` group, one rank per
process, ``parallel/mesh.py``): the global batch is
``batch_size_per_device`` times the world size, each rank loads its rows of
it, the model's BN takes global-batch statistics and DDP sums the
gradients; img/s counts the global batch. ``--continue`` checks that every
rank resumes at the same point, and the RSS watchdog is a vote: one rank
over its limit makes every rank snapshot and exit.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import List, Optional, Sequence

import torch

from ihpr_tpu_torch.config import Config
from ihpr_tpu_torch.data import skeletons
from ihpr_tpu_torch.data.datasets import PoseDataset, build_dataset
from ihpr_tpu_torch.data.pipeline import BatchLoader, prefetch_to_device
from ihpr_tpu_torch.engine.checkpoint import CheckpointManager
from ihpr_tpu_torch.engine.logger import colorlogger
from ihpr_tpu_torch.models.pose_net import build_pose_net
from ihpr_tpu_torch.models.pretrained import load_backbone
from ihpr_tpu_torch.ops.integral_volume import kernel_mode, use_kernels
from ihpr_tpu_torch.parallel.mesh import all_gather_rows, any_rank, barrier, comm_device, data_parallel
from ihpr_tpu_torch.parallel.train_step import (
    TrainState,
    create_train_state,
    make_lr_schedule,
    make_train_step,
)
from ihpr_tpu_torch.utils.hostmem import EX_TEMPFAIL, host_rss_mb, resolve_rss_limit_mb

_LOG_EVERY = 50  # steps between full-metrics log lines (the JAX trainer's)


class Trainer:
    def __init__(
        self,
        cfg: Config,
        data_root: Optional[str] = None,
        continue_train: bool = False,
        datasets: Optional[Sequence[PoseDataset]] = None,
        num_workers: int = 8,
        synthetic_size: int = 512,
        rss_limit_mb: Optional[float] = None,
        rss_check_interval_steps: int = 100,
        device="cuda",
    ):
        """``rss_limit_mb``: the host-RSS watchdog (``utils/hostmem.py``):
        None = 80% of MemTotal, 0 disables. Past the limit the loop
        snapshots and exits with ``EX_TEMPFAIL`` (75) for a ``--continue``
        relaunch. It checks every ``rss_check_interval_steps`` steps (0 =
        epoch boundaries only) and at epoch boundaries. On a process group
        ``device`` is this rank's, and every rank must construct its
        Trainer and call ``train`` alike."""
        self.cfg = cfg
        self.device = torch.device(device)
        self.dp = data_parallel(cfg)
        self.rss_limit_mb = resolve_rss_limit_mb(rss_limit_mb)
        self.rss_check_interval_steps = int(rss_check_interval_steps)
        self.logger = colorlogger(f"{cfg.output_dir}/log", "train_logs.txt")
        use_kernels(self.device)  # refuses IHPR_PALLAS=off on the card before anything is built
        mode = kernel_mode()
        if mode != "auto":
            self.logger.info("IHPR_PALLAS=%s: %s", mode, "the fused head's no-plan route on the CPU"
                             if mode == "off" else "routes as auto (the port has no interpreter)")
        if datasets is None:
            # Secondary datasets render in the primary skeleton's hue space,
            # so joint identity is coded alike across the mix.
            primary = skeletons.get_skeleton(cfg.data.trainset[0])
            datasets = [
                build_dataset(name, "train", cfg, data_root, synthetic_size,
                              hue_skeleton=primary if i else None)
                for i, name in enumerate(cfg.data.trainset)
            ]
        data = self.dp.data_axis
        self.batch_size = cfg.optim.batch_size_per_device * data.world  # the global batch
        self.loader = BatchLoader(datasets, cfg, self.batch_size, num_workers=num_workers, seed=cfg.seed,
                                  rank=data.rank, world=data.world, device=self.device)
        self.steps_per_epoch = len(self.loader)
        self.logger.info(
            "train: %d samples (%s), global batch %d on %d rank(s) (data %d x spatial %d), %d steps/epoch, on %s",
            sum(len(d) for d in datasets), "+".join(d.name for d in datasets),
            self.batch_size, self.dp.world, data.world, self.dp.spatial, self.steps_per_epoch, self.device,
        )
        # JAX's initial values from the key JAX's Trainer takes, the same on
        # every rank.
        self.model = build_pose_net(cfg, self.loader.joint_num, device=self.device, trainable=True,
                                    dp=self.dp)
        self.max_steps: Optional[int] = None  # set by cap_steps_per_epoch
        self.losses: List[torch.Tensor] = []  # the current epoch's losses, on the device
        # Host seconds the loop spent waiting for its next batch (decode,
        # warp, copy), summed over every train() call.
        self.loader_wait_s = 0.0
        self._make_steps()
        self.ckpt = CheckpointManager(cfg.output_dir, keep=cfg.optim.snapshot_keep)
        self.start_epoch = 0
        # Batches of start_epoch already consumed by a mid-epoch snapshot
        # (itr >= 0): the resumed loop replays the epoch's deterministic host
        # stream and skips the first resume_skip batches.
        self.resume_skip = 0
        if continue_train:
            restored = self.ckpt.load_latest()
            if restored is not None:
                state_dict, epoch, itr = restored
                self.state.load_state_dict(state_dict)
                if itr >= 0:
                    self.start_epoch, self.resume_skip = epoch, itr + 1
                    self.logger.info(
                        "resumed from snapshot_%d (mid-epoch, itr %d; skipping %d consumed batches)",
                        epoch, itr, self.resume_skip,
                    )
                else:
                    self.start_epoch = epoch + 1
                    self.logger.info("resumed from snapshot_%d", epoch)
            if self.dp.group is not None:
                # Only rank 0 writes snapshots: a rank that reads another
                # directory, or an older state of it, would train a diverged
                # stream. The output_dir must be shared.
                mine = torch.tensor([[self.start_epoch, self.resume_skip]], device=comm_device(self.dp))
                points = all_gather_rows(mine, self.dp).tolist()
                if any(p != points[0] for p in points):
                    raise RuntimeError(
                        f"ranks disagree on the resume point (epoch, skipped batches): {points}; "
                        "--continue needs an output_dir every rank reads"
                    )

    def _make_steps(self):
        """Optimizer, schedule and step functions for the current epoch
        length (the decay boundaries are counted in steps)."""
        self.state: TrainState = create_train_state(self.model, self.cfg, self.steps_per_epoch, self.dp)
        opt, sched = self.state.optimizer, self.state.scheduler
        self.step_fn = make_train_step(self.model, opt, self.cfg, scheduler=sched, dp=self.dp)
        self.lean_step_fn = make_train_step(self.model, opt, self.cfg, lean=True, scheduler=sched, dp=self.dp)
        self.lr_sched = make_lr_schedule(self.cfg, self.steps_per_epoch)

    def cap_steps_per_epoch(self, n: int):
        """Shrink epochs to n steps (smoke runs). Rebuilds the optimizer and
        schedule so the decay boundaries follow the capped epoch length. As
        in the JAX trainer, after a restore (``--continue --steps N``) this
        restarts Adam's moments and count and the schedule's count; the
        update count ``state.step`` stays."""
        self.steps_per_epoch = min(n, self.steps_per_epoch)
        self.max_steps = self.steps_per_epoch
        step = self.state.step
        self._make_steps()
        self.state.step = step

    def load_pretrained_backbone(self, path: str):
        """Replace the backbone's parameters and BN statistics, and nothing
        else, with ImageNet weights (JAX ``Trainer.load_pretrained_backbone``;
        the reference downloads them from the model zoo). ``path``: a
        torchvision ResNet ``state_dict`` (``.pth`` / ``.pt``) or the flax
        msgpack of ``tools/convert_torch_ckpt.py --kind backbone`` (any other
        name); see ``models/pretrained.py``."""
        load_backbone(self.model.backbone, path)
        self.logger.info("loaded pretrained backbone from %s", path)

    def close(self):
        self.loader.close()

    def train(
        self,
        end_epoch: Optional[int] = None,
        profile_dir: Optional[str] = None,
        profile_steps: tuple = (20, 25),
    ) -> TrainState:
        """Run epochs [start_epoch, end_epoch) (``cfg.optim.end_epoch`` by
        default); a later call continues from there. ``profile_dir``: a
        ``torch.profiler`` window over iterations [profile_steps) of the
        first epoch, written there as a Chrome trace named by the update
        count it closed at; a window that would end past the first epoch
        closes at its end."""
        end_epoch = end_epoch or self.cfg.optim.end_epoch
        self._profiler = None
        try:
            self._epoch_loop(end_epoch, profile_dir, profile_steps)
        finally:
            if self._profiler is not None:
                # Close a window left open by an abnormal exit inside it (an
                # RSS preempt, SIGTERM), so the trace on disk is usable and a
                # later train() starts clean. A failure to write the trace
                # (a full disk) is logged, not raised: it must neither
                # replace the exit in flight (75 for the supervisor) nor
                # skip the drain below.
                try:
                    self._stop_profile(profile_dir)
                except Exception:
                    self.logger.exception("closing the profile window failed; the trace is lost")
            # Drain the snapshot in flight on every exit path, the SIGTERM ->
            # SystemExit unwind of the CLIs (utils/shutdown.py) included.
            self.ckpt.wait()
        # Every rank returns once rank 0's snapshot is on disk, so what runs
        # next on any rank (an eval of it, a resume) finds it.
        barrier(self.dp)
        return self.state

    def _start_profile(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._profiler = torch.profiler.profile(activities=activities)
        self._profiler.start()

    def _stop_profile(self, profile_dir: str):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self._profiler = self._profiler, None
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"trace_step{self.state.step}.json")
        prof.export_chrome_trace(path)
        self.logger.info("profile written to %s", path)

    def _timed(self, batches):
        """``batches``, adding the host time each ``next`` takes to
        ``loader_wait_s``."""
        while True:
            t0 = time.perf_counter()
            item = next(batches, None)
            self.loader_wait_s += time.perf_counter() - t0
            if item is None:
                return
            yield item

    def _rss_check(self, epoch: int, itr: int = -1, already_saved: bool = False):
        """The watchdog: past the limit, self-preempt before the OOM killer:
        snapshot (mid-epoch when itr >= 0; resume skips the consumed
        batches), then exit with EX_TEMPFAIL so a supervisor relaunches with
        --continue (train()'s finally drains the save). On a process group
        the trip is a vote (JAX ``_rss_over_limit``): every rank votes its
        local RSS against its limit (a rank with the watchdog off votes no)
        at the same points, and one rank over makes every rank snapshot and
        exit, since the snapshot's ZeRO consolidation and the next step's
        collectives need all of them."""
        if self.rss_limit_mb is None and self.dp.group is None:
            return
        rss = host_rss_mb()
        if not any_rank(self.rss_limit_mb is not None and rss > self.rss_limit_mb, self.dp):
            return
        if not already_saved:
            self.ckpt.save(epoch, self.state, itr=itr)
        where = f"mid-epoch at itr {itr}" if itr >= 0 else "at the epoch boundary"
        limit = "off" if self.rss_limit_mb is None else f"{self.rss_limit_mb:.0f} MB"
        self.logger.warning(
            "host RSS %.0f MB, limit %s (tripped on any rank %s): snapshot_%d saved, exiting %d - "
            "relaunch with --continue",
            rss, limit, where, epoch, EX_TEMPFAIL,
        )
        raise SystemExit(EX_TEMPFAIL)

    def _epoch_loop(self, end_epoch: int, profile_dir: Optional[str], profile_steps: tuple):
        first_epoch = self.start_epoch
        for epoch in range(first_epoch, end_epoch):
            host_it = self.loader.epoch(epoch, self.max_steps)
            start_itr = 0
            if epoch == first_epoch and self.resume_skip:
                # Mid-epoch resume: drop the consumed prefix of the epoch's
                # deterministic host stream before it is staged on the device.
                host_it = itertools.islice(host_it, self.resume_skip, None)
                start_itr = self.resume_skip
            batches = self._timed(prefetch_to_device(host_it, self.device))
            self.losses = []
            window_start, window_steps = time.perf_counter(), 0
            for itr, (batch, _) in enumerate(batches, start=start_itr):
                if profile_dir and epoch == first_epoch:
                    # The guard covers both edges: a mid-epoch resume can
                    # start inside the window, past its first itr.
                    if itr == profile_steps[0]:
                        self._start_profile()
                    elif itr == profile_steps[1] and self._profiler is not None:
                        self._stop_profile(profile_dir)
                log_step = itr % _LOG_EVERY == 0 or itr == self.steps_per_epoch - 1
                # A canvas batch's augmentation is drawn for (epoch, updates
                # taken): JAX's fold_in(fold_in(data_rng, epoch), state.step).
                aug_key = (epoch, self.state.step) if "canvas" in batch else ()
                metrics = (self.step_fn if log_step else self.lean_step_fn)(batch, *aug_key)
                self.state.step += 1
                self.losses.append(metrics["loss"])
                window_steps += 1
                if log_step:
                    vals = {k: float(v) for k, v in metrics.items()}  # waits for the device
                    now = time.perf_counter()
                    itr_time = (now - window_start) / window_steps
                    window_start, window_steps = now, 0
                    self.logger.info(
                        "epoch %d/%d itr %d/%d: lr %.2e loss %.4f |g| %.3f err xy %.2f z %.2f vox "
                        "%.1f ms/itr %.1f img/s",
                        epoch, end_epoch, itr, self.steps_per_epoch,
                        self.lr_sched(self.state.step), vals["loss"], vals["grad_norm"],
                        vals["err_xy_voxels"], vals["err_z_voxels"], itr_time * 1e3,
                        self.batch_size / max(itr_time, 1e-9),
                    )
                # The step-granular watchdog; the last itr defers to the
                # boundary check below, which saves an end-of-epoch snapshot.
                if (
                    self.rss_check_interval_steps
                    and (itr + 1) % self.rss_check_interval_steps == 0
                    and itr != self.steps_per_epoch - 1
                ):
                    self._rss_check(epoch, itr=itr)
            if self._profiler is not None:
                # The window ends past the first epoch: close it here, or it
                # would record every later epoch in host memory.
                self._stop_profile(profile_dir)
            saved = (epoch + 1) % self.cfg.optim.snapshot_interval == 0 or epoch == end_epoch - 1
            if saved:
                self.ckpt.save(epoch, self.state)
                self.logger.info("saving snapshot_%d (async)", epoch)
            self.start_epoch, self.resume_skip = epoch + 1, 0
            if epoch != end_epoch - 1:
                # itr = -1: the epoch is complete (no second save when the
                # snapshot interval just wrote this epoch).
                self._rss_check(epoch, already_saved=saved)
