"""Epoch-granular snapshot save and restore, counterpart of
``ihpr_tpu.engine.checkpoint``.

Reference: ``common/base.py:save_model/load_model``: one snapshot per
epoch, ``--continue`` resumes from the highest epoch found. Here
``output_dir/model_dump/snapshot_{e}/state.pt`` holds one ``torch.save``
payload: ``TrainState.state_dict()`` (the model's fp32 master weights and
BN running statistics, the Adam moments and counts, the schedule's count,
the update count), the epoch, ``itr`` and a format version.

No RNG is stored. The JAX snapshot carries ``data_rng``, the key of its
device-side augmentation; the port's train step draws nothing at random,
and its data stream is a function of (seed, epoch, batch index) alone
(``data/pipeline.py:BatchLoader``), so a resumed run replays it exactly.

Data-parallel, every rank calls ``save`` at the same points and only rank
0 writes; the payload has the single-process format (ZeRO's optimizer state
is consolidated onto rank 0 first), so a snapshot resumes on any number of
ranks. Every rank reads the shared directory on ``--continue``.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, Optional, Tuple

import torch

from ihpr_tpu_torch.engine.logger import _process_index

FORMAT_VERSION = 1
_FILE = "state.pt"


def _host_copy(obj: Any) -> Any:
    """``obj`` with every tensor replaced by a CPU copy of its current value.
    A copy from the device waits for the work queued on the stream, so it
    holds the value after the last step, and the optimizer's next in-place
    update cannot reach it."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


class CheckpointManager:
    def __init__(self, output_dir: str, keep: Optional[int] = None):
        """``keep``: retain only the newest N snapshots on disk (None = keep
        every epoch, the reference's behaviour)."""
        if keep is not None and keep < 1:
            # keep=0 would make _prune's [:-keep or None] slice delete every
            # snapshot; reject it up front.
            raise ValueError(f"snapshot keep must be >= 1 or None, got {keep}")
        self.dump_dir = os.path.abspath(os.path.join(output_dir, "model_dump"))
        self.keep = keep
        os.makedirs(self.dump_dir, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._failure: Optional[Tuple[str, BaseException]] = None

    def _epochs_on_disk(self):
        return sorted(
            int(m.group(1))
            for name in os.listdir(self.dump_dir)
            if (m := re.fullmatch(r"snapshot_(\d+)", name))
            and os.path.isdir(os.path.join(self.dump_dir, name))
        )

    def _path(self, epoch: int) -> str:
        return os.path.join(self.dump_dir, f"snapshot_{epoch}")

    def _drain(self):
        """Wait for the save in flight; raise its failure, if it failed."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._failure is not None:
            path, exc = self._failure
            self._failure = None
            raise RuntimeError(f"writing snapshot {path} failed") from exc

    def save(self, epoch: int, state, itr: int = -1):
        """Asynchronous: the host copy of ``state`` (a ``TrainState``) is
        taken before this returns, and only its ``torch.save`` runs in the
        background. The previous save is drained first (one in flight; its
        failure raises here); call ``wait()`` before the process exits.

        ``itr``: the last completed iteration within ``epoch`` for a
        mid-epoch snapshot (the RSS watchdog's self-preempt); -1 (the
        default) means the epoch finished. Resume skips the first itr + 1
        batches of that epoch's deterministic stream, so the continued run
        is bit-identical either way.

        Data-parallel, call it on every rank at the same point: under ZeRO
        the optimizer's ``consolidate_state_dict`` (a collective) runs
        first. Only rank 0 copies and writes."""
        consolidate = getattr(getattr(state, "optimizer", None), "consolidate_state_dict", None)
        if consolidate is not None:
            consolidate(to=0)
        if _process_index() != 0:
            return
        self._drain()
        # Prune before the new write, and only down to ``keep``: the write
        # in flight goes to a name that does not match snapshot_\d+, so
        # pruning to keep - 1 would leave no restorable snapshot if the
        # process died mid-write. Disk holds keep + 1 for a while; wait()
        # prunes to exactly keep.
        self._prune(self.keep)
        payload = {
            "format": FORMAT_VERSION,
            "epoch": int(epoch),
            "itr": int(itr),
            "state": _host_copy(state.state_dict()),
        }
        self._writer = threading.Thread(
            target=self._write, args=(self._path(epoch), payload), name=f"snapshot_{epoch}"
        )
        self._writer.start()

    def _write(self, path: str, payload: dict):
        try:
            tmp = f"{path}.partial"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(payload, os.path.join(tmp, _FILE))
            if os.path.isdir(path):  # a mid-epoch snapshot of this epoch: swap the file
                os.replace(os.path.join(tmp, _FILE), os.path.join(path, _FILE))
                os.rmdir(tmp)
            else:
                os.replace(tmp, path)
        except Exception as exc:  # raised by the next save() or wait()
            self._failure = (path, exc)

    def _prune(self, keep: Optional[int]):
        """Remove all but the newest ``keep`` snapshots. Call only after a
        drain (every snapshot on disk is then complete). Process 0 only."""
        if keep is None or _process_index() != 0:
            return
        for e in self._epochs_on_disk()[: -keep or None]:
            shutil.rmtree(self._path(e), ignore_errors=True)

    def wait(self):
        self._drain()
        self._prune(self.keep)

    def epochs(self) -> list:
        """The epochs of the snapshots on disk, oldest first."""
        self._drain()  # make the save in flight visible
        return self._epochs_on_disk()

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def load(self, epoch: int) -> Tuple[dict, int, int]:
        """-> (state_dict, epoch, itr): ``TrainState.state_dict()`` with its
        tensors on the CPU (``TrainState.load_state_dict`` or
        ``model.load_state_dict(state_dict["model"])`` moves them onto the
        device of the model they go into); itr = -1 for an end-of-epoch
        snapshot."""
        self._drain()
        payload = torch.load(
            os.path.join(self._path(epoch), _FILE), map_location="cpu", weights_only=True
        )
        if payload.get("format") != FORMAT_VERSION:
            raise ValueError(
                f"snapshot_{epoch} has format {payload.get('format')}, expected {FORMAT_VERSION}"
            )
        return payload["state"], payload["epoch"], payload["itr"]

    def load_latest(self) -> Optional[Tuple[dict, int, int]]:
        """Reference ``--continue``: the highest snapshot, or None."""
        epoch = self.latest_epoch()
        if epoch is None:
            return None
        return self.load(epoch)


def load_snapshot(output_dir: str, epoch: Optional[int] = None) -> Tuple[dict, int]:
    """(state_dict, epoch) of snapshot ``epoch`` (default: the latest) of the
    run in ``output_dir``, for the Tester and the server (reference
    ``--test_epoch``). Raises FileNotFoundError when there is none."""
    ckpt = CheckpointManager(output_dir)
    epoch = epoch if epoch is not None else ckpt.latest_epoch()
    if epoch is None:
        raise FileNotFoundError(f"no snapshot in {output_dir}/model_dump; train first")
    state_dict, epoch, _ = ckpt.load(epoch)
    return state_dict, epoch
