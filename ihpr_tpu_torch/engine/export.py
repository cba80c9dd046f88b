"""Serialized serving artifacts via ``torch.export``, counterpart of
``ihpr_tpu.engine.export``.

``export_server`` captures a ``PoseServer``'s patch -> coords program
(uint8 ``finalize_patch``, backbone, deconv head, soft-argmax, and the
flip-test as one 2B forward when the server has it on) with the WEIGHTS
BAKED IN, and serializes it with ``torch.export.save`` to one
self-contained ``bytes`` blob. A serving process loads it with nothing but
torch installed (``torch.export.load(...).module()``): no model
definition, no ``ihpr_tpu_torch``, no snapshot directory.
``load_exported`` does that and returns a callable.

- Inputs: ``(B, in_h, in_w, 3) uint8`` patches and ``(B, 3) float32``
  per-channel colour scales (ones for eval). Output: ``(B, J, 3)`` voxel
  coords (x, y, z).
- ``batch`` fixes B, or ``"poly"`` makes it symbolic
  (``torch.export.Dim``): one artifact for every batch size, through the
  flip-test branch too, whose concat doubles the symbolic batch.
- The program holds the PLAIN composition, ``PoseNet.coords_plain``: the
  heatmap logits, then the plain soft-argmax. The fused head kernel (K1)
  is a ctypes launch on raw pointers, which export's tracing cannot enter;
  the JAX package traces under ``IHPR_PALLAS=off`` for the same reason.
  The live ``PoseServer`` keeps K1 and stays the fast path: on an H100 the
  plain head of a flip-test dispatch of 32 takes ~10 ms of device time
  against K1's ~0.3 (PERF.md). Use an artifact where deployment isolation
  matters.
- A config's ``matmul_precision="highest"`` (TF32 off) is a process flag,
  not part of the graph: the artifact records it in its metadata
  (``METADATA``, one of its ``extra_files``), and ``load_exported``'s
  callable turns TF32 off around each call. Exporting leaves the
  process's flags as it found them.
- A spatial server (``partition="spatial"`` over several ranks) exports
  the whole-image program: a one-process copy of its model, the same
  weights with no grid, as JAX exports ``coords_plain`` under a spatial
  mesh. Every rank may export it; the artifacts are equal.
- The program runs on the device it was exported on, or on the one
  ``load_exported`` moves it to, and raises where that device is missing.
  Artifacts are specific to the torch version: export and load with the
  same one.
"""

from __future__ import annotations

import contextlib
import io
import json
from typing import Callable, Optional, Union

import torch
from torch import nn

from ihpr_tpu_torch.data.augment import finalize_patch
from ihpr_tpu_torch.models.pose_net import build_pose_net, inference_copy
from ihpr_tpu_torch.ops.fused_head_integral import no_tf32
from ihpr_tpu_torch.parallel.train_step import flip_test_coords

METADATA = "ihpr_export.json"  # the artifact's metadata, one of its extra_files
_MAX_POLY_BATCH = 1024


class _ServingProgram(nn.Module):
    """``PoseServer._forward`` with ``coords_plain`` in place of the fused
    head: the module that export traces. It shares the server's frozen
    model and changes nothing in it."""

    def __init__(self, server, model):
        super().__init__()
        self.model = model
        self.data = server.cfg.data
        self.flip_test = bool(server.flip_test)
        self.register_buffer("flip_perm", server.flip_perm.clone(), persistent=False)

    def forward(self, patch_u8: torch.Tensor, color_scale: torch.Tensor) -> torch.Tensor:
        image = finalize_patch(patch_u8, color_scale, self.data)
        if not self.flip_test:
            return self.model.coords_plain(image)
        return flip_test_coords(
            self.model.coords_plain, image, self.flip_perm, self.data.output_shape[1]
        )


def _whole_image_model(server) -> nn.Module:
    """``server.model``, or where it holds one spatial rank's rows, a frozen
    one-process copy with its weights (``build_pose_net`` with no grid)."""
    model = server.model
    if model.rows is None:
        return model
    return inference_copy(build_pose_net(server.cfg, model.joint_num, device=server.device,
                                         state_dict=model.state_dict()))


def export_server(server, batch: Union[int, str, None] = None) -> bytes:
    """Serialize ``server``'s inference program, weights baked in, on the
    server's device. ``batch``: an int for a fixed-shape artifact, ``None``
    for ``server.max_batch``, or ``"poly"`` for a batch-polymorphic one
    (1 to 1024). A spatial server exports its model's one-process copy."""
    in_h, in_w = server.cfg.data.input_shape
    dynamic = None
    if batch == "poly":
        # An example batch of 1 would specialize the dimension to 1.
        n = max(2, server.max_batch)
        b = torch.export.Dim("b", min=1, max=_MAX_POLY_BATCH)
        dynamic = ({0: b}, {0: b})
    elif batch is None:
        n = server.max_batch
    elif isinstance(batch, int) and batch >= 1:
        n = batch
    else:
        raise ValueError(f"batch must be a positive int, None or 'poly', got {batch!r}")
    device = server.device
    example = (
        torch.zeros((n, in_h, in_w, 3), dtype=torch.uint8, device=device),
        torch.ones((n, 3), dtype=torch.float32, device=device),
    )
    meta = {
        "batch": "poly" if batch == "poly" else n,
        "flip_test": bool(server.flip_test),
        "device": str(device),
        "matmul_precision": server.model.matmul_precision,
    }
    # A plain function under no_grad: the server's own forward runs under
    # inference_mode, whose tensors export cannot trace.
    with torch.no_grad():
        program = torch.export.export(
            _ServingProgram(server, _whole_image_model(server)), example, dynamic_shapes=dynamic, strict=False
        )
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={METADATA: json.dumps(meta)})
    return buf.getvalue()


def _require(device: torch.device):
    if device.type != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError(f"the artifact runs on {device}, and torch.cuda.is_available() is False")
    if device.index is not None and device.index >= torch.cuda.device_count():
        raise RuntimeError(f"{device} is not present ({torch.cuda.device_count()} CUDA devices)")


def load_exported(
    data: bytes, device: Optional[Union[str, torch.device]] = None
) -> Callable[..., torch.Tensor]:
    """bytes -> callable ``(patch_u8, color_scale) -> (B, J, 3)`` voxel
    coords, a tensor on the program's device. The inputs may be numpy
    arrays or tensors on any device; they are moved to the program's.
    ``device``: move the program there first (default: where it was
    exported). Raises if that device is missing; nothing runs on the CPU in
    its place."""
    extra = {METADATA: ""}
    program = torch.export.load(io.BytesIO(data), extra_files=extra)
    meta = json.loads(extra[METADATA])
    target = torch.device(device if device is not None else meta["device"])
    _require(target)
    if device is not None:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, target)
    module = program.module()
    highest = meta["matmul_precision"] == "highest"

    def run(patch_u8, color_scale) -> torch.Tensor:
        patch = torch.as_tensor(patch_u8).to(target)
        scale = torch.as_tensor(color_scale, dtype=torch.float32).to(target)
        with torch.no_grad(), no_tf32() if highest else contextlib.nullcontext():
            return module(patch, scale)

    run.metadata = meta
    return run
