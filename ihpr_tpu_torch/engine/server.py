"""Batched inference server, counterpart of ``ihpr_tpu.engine.server``.

``PoseServer`` takes pre-cropped uint8 patches, or original images with
person bboxes, pads every dispatch to ``max_batch`` by repeating the last
patch (one fixed shape per call), runs ``finalize_patch`` and
``PoseNet.coords`` on ``device`` (flip-test as one 2B batch), and maps the
voxel coords back to original-image pixels and millimetre depth on the
host. On a CUDA device the forward runs the fused head kernel; there is no
plain fallback on that path. Images are cropped by the native warp, or, where
that library is missing, by the device warp (``data/warp.py``), as JAX's
server does. ``load_server`` builds a server from a training snapshot.

Serving over W > 1 ranks (``dp``): every rank is called with the same
requests and pads each dispatch to ``max_batch``.

- ``partition="data"``: each rank runs its samples [r * m/W, (r + 1) * m/W)
  of a dispatch on its device, and ``mesh.all_gather_rows`` hands every
  rank the whole dispatch's coords in rank order.
- ``partition="spatial"`` (JAX's default): the ranks split each patch's
  image rows (a grid of S = W, ``mesh.make_grid``); each rank takes the
  whole dispatch, keeps its rows, and returns the merged coords
  (``PoseNet.coords_spatial``: K3 on its rows, not K1).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ihpr_tpu_torch.config import Config
from ihpr_tpu_torch.data import geometry, native, skeletons
from ihpr_tpu_torch.data.augment import finalize_patch
from ihpr_tpu_torch.data.warp import affine_warp_bilinear, gen_trans_np
from ihpr_tpu_torch.models.pose_net import PoseNet, build_pose_net, inference_copy, on_grid
from ihpr_tpu_torch.parallel.mesh import DataParallel, all_gather_rows, make_grid, row_shard
from ihpr_tpu_torch.parallel.train_step import flip_test_coords

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class PoseResult:
    coords_voxel: np.ndarray  # (J, 3) heatmap-space
    coords_img: np.ndarray  # (J, 3) original px + mm depth (root-relative
    # unless root_z was provided)


class PoseServer:
    def __init__(
        self,
        cfg: Config,
        model_or_state: Union[PoseNet, Mapping[str, torch.Tensor]],
        max_batch: int = 16,
        flip_test: Optional[bool] = None,
        device: Union[str, torch.device] = "cuda",
        dp: Optional[DataParallel] = None,
        partition: str = "spatial",
    ):
        """``model_or_state``: a ``PoseNet`` or a state_dict for
        ``build_pose_net(cfg)``'s model. The server runs its own frozen copy
        on ``device``, with the conv weights cast to the compute dtype once
        (``pose_net.inference_copy``); the model passed in is left as it
        is.

        ``dp``: this rank's ``parallel.mesh.DataParallel`` of the world;
        None or world 1 is one process. At world > 1 (module docstring),
        ``partition="data"`` needs ``max_batch`` divisible by the world
        (ValueError otherwise); ``"spatial"`` takes any input rows, in
        GSPMD's uneven layout where they do not split evenly (build the
        server on every rank at the same point)."""
        if partition not in ("spatial", "data"):
            raise ValueError(f"partition must be 'spatial' or 'data', got {partition!r}")
        self.dp = dp if dp is not None and dp.world > 1 else None
        self.partition = partition if self.dp is not None else "spatial"
        if self.dp is not None and partition == "data" and max_batch % self.dp.world:
            raise ValueError(
                f"data-parallel serving pads every dispatch to max_batch, which must divide over "
                f"the ranks ({max_batch} over {self.dp.world})"
            )
        if self.dp is not None and partition == "spatial":
            self.dp = make_grid(DataParallel(self.dp.rank, self.dp.world, self.dp.group), self.dp.world,
                                cfg.data.input_shape[0])
        self.cfg = cfg
        self.device = torch.device(device)
        self.skeleton = skeletons.get_skeleton(cfg.data.testset)
        joints = self.skeleton.joint_num
        if isinstance(model_or_state, PoseNet):
            model = on_grid(model_or_state, cfg, self.dp, self.device)
        else:
            model = build_pose_net(cfg, joints, device=self.device, dp=self.dp, state_dict=model_or_state)
        self.model = inference_copy(model).to(self.device)
        if self.model.joint_num != joints:
            raise ValueError(
                f"model has {self.model.joint_num} joints, {cfg.data.testset} has {joints}"
            )
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = max_batch
        self.flip_test = cfg.eval.flip_test if flip_test is None else flip_test
        self.flip_perm = torch.as_tensor(self.skeleton.flip_permutation(), device=self.device)
        # This rank's samples of a padded dispatch (all of them on one
        # process and under the spatial partition).
        rank, world = (self.dp.rank, self.dp.world) if self.partition == "data" else (0, 1)
        rows = max_batch // world
        self._rows = slice(rank * rows, (rank + 1) * rows)
        self._ones = torch.ones((rows, 3), dtype=torch.float32, device=self.device)
        self._device_warp_logged = False

    @torch.inference_mode()
    def _forward(self, patch_u8: torch.Tensor, color_scale: torch.Tensor) -> torch.Tensor:
        image = row_shard(finalize_patch(patch_u8, color_scale, self.cfg.data), self.model.rows)
        if not self.flip_test:
            return self.model.coords(image)
        return flip_test_coords(self.model.coords, image, self.flip_perm, self.cfg.data.output_shape[1])

    def submit_patches(self, patches_u8: np.ndarray) -> torch.Tensor:
        """Submit ONE chunk: (B <= max_batch, in_h, in_w, 3) uint8 -> (B, J, 3)
        voxel coords as a tensor on ``device``, without waiting for the
        device. Read it with ``.cpu()`` when needed. Over several ranks,
        every rank must submit the same chunk: the gather of the ranks'
        samples, or the merge of their rows' statistics, waits for all."""
        b = len(patches_u8)
        if b > self.max_batch:
            raise ValueError(f"{b} patches > max_batch {self.max_batch}")
        if b == 0:
            return torch.zeros(
                (0, self.skeleton.joint_num, 3), dtype=torch.float32, device=self.device
            )
        chunk = np.asarray(patches_u8)
        in_h, in_w = self.cfg.data.input_shape
        if chunk.dtype != np.uint8 or chunk.shape[1:] != (in_h, in_w, 3):
            raise ValueError(
                f"patches {chunk.dtype}{chunk.shape[1:]}: need uint8 ({in_h}, {in_w}, 3)"
            )
        pad = self.max_batch - b
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
        patch = torch.from_numpy(np.ascontiguousarray(chunk[self._rows]))
        if self.device.type == "cuda":
            patch = patch.pin_memory().to(self.device, non_blocking=True)
        coords = self._forward(patch, self._ones)
        if self.partition == "data":
            coords = all_gather_rows(coords, self.dp)
        return coords[:b]

    def predict_patches(self, patches_u8: np.ndarray) -> np.ndarray:
        """(N, in_h, in_w, 3) uint8 patches -> (N, J, 3) voxel coords, in
        ``max_batch`` chunks."""
        n = len(patches_u8)
        out = np.empty((n, self.skeleton.joint_num, 3), np.float32)
        for s in range(0, n, self.max_batch):
            chunk = patches_u8[s : s + self.max_batch]
            out[s : s + len(chunk)] = self.submit_patches(chunk).cpu().numpy()
        return out

    def _preprocess(self, images: Sequence[np.ndarray], bboxes: np.ndarray):
        """bbox aspect fix + affine crop to the network input: the native
        warp, or where it is unavailable the device warp on ``device`` (the
        images pasted on a zero canvas of the largest size, the bilinear warp,
        uint8 by truncation, as JAX's fallback). Returns the uint8 patches
        and the per-person inverse affines."""
        d = self.cfg.data
        in_h, in_w = d.input_shape
        aspect = in_w / in_h
        boxes = []
        for i, bb in enumerate(np.asarray(bboxes, np.float32)):
            fixed = geometry.process_bbox(
                bb, images[i].shape[1], images[i].shape[0], aspect, d.bbox_margin
            )
            boxes.append(fixed if fixed is not None else bb)
        boxes = np.stack(boxes)
        cx = boxes[:, 0] + boxes[:, 2] / 2
        cy = boxes[:, 1] + boxes[:, 3] / 2
        invs = np.stack(
            [
                gen_trans_np(cx[i], cy[i], boxes[i, 2], boxes[i, 3], in_w, in_h, 1.0, 0.0, inv=True)
                for i in range(len(boxes))
            ]
        )
        if native.available():
            patches = native.warp_batch(list(images), invs, np.zeros(len(boxes), np.int32), in_h, in_w)
            return patches, invs
        if not self._device_warp_logged:
            _log.warning("PoseServer: the device warp on %s, since native.available() is False (%s)",
                         self.device, native.unavailable_reason())
            self._device_warp_logged = True
        maxh = max(im.shape[0] for im in images)
        maxw = max(im.shape[1] for im in images)
        canvas = np.zeros((len(images), maxh, maxw, 3), np.uint8)
        for i, im in enumerate(images):
            canvas[i, : im.shape[0], : im.shape[1]] = im
        warped = affine_warp_bilinear(
            torch.from_numpy(canvas).to(self.device), torch.from_numpy(invs).to(self.device), (in_h, in_w)
        )
        return warped.to(torch.uint8).cpu().numpy(), invs

    def _postprocess(
        self, voxels: np.ndarray, invs: np.ndarray, root_z: Optional[np.ndarray]
    ) -> list:
        """Voxel coords -> original-image px + mm depth (host, numpy)."""
        d = self.cfg.data
        results = []
        for i, vox in enumerate(np.asarray(voxels)):
            img_coords = geometry.warp_coord_to_original(
                vox,
                invs[i],
                d.output_shape,
                d.input_shape,
                d.depth_dim,
                d.bbox_3d_shape[0],
                root_z=float(root_z[i]) if root_z is not None else 0.0,
            )
            results.append(PoseResult(coords_voxel=vox, coords_img=img_coords))
        return results

    def predict(
        self,
        images: Sequence[np.ndarray],
        bboxes: np.ndarray,
        root_z: Optional[np.ndarray] = None,
        f: Optional[np.ndarray] = None,
        c: Optional[np.ndarray] = None,
    ) -> list:
        """Original images + one person bbox per image -> per-person results
        in original-image pixels and mm depth. The camera intrinsics ``f``
        and ``c`` are accepted and ignored, as in ``ihpr_tpu``'s server."""
        patches, invs = self._preprocess(images, bboxes)
        voxels = self.predict_patches(patches)
        return self._postprocess(voxels, invs, root_z)

    def predict_stream(self, requests, depth: int = 2):
        """Iterate ``(images, bboxes)`` or ``(images, bboxes, root_z)``
        requests, yielding one ``predict``-equivalent result list per request
        in order. Keeps ``depth`` requests in flight, so the host warp of the
        next request runs while the device computes this one."""
        q = collections.deque()

        def stage(req):
            images, bboxes = req[0], req[1]
            root_z = req[2] if len(req) > 2 else None
            patches, invs = self._preprocess(images, bboxes)
            handles = [
                self.submit_patches(patches[s : s + self.max_batch])
                for s in range(0, len(patches), self.max_batch)
            ]
            return handles, invs, root_z

        def finish(handles, invs, root_z):
            voxels = (
                torch.cat(handles).cpu().numpy()
                if handles
                else np.zeros((0, self.skeleton.joint_num, 3), np.float32)
            )
            return self._postprocess(voxels, invs, root_z)

        for req in requests:
            q.append(stage(req))
            if len(q) >= depth:
                yield finish(*q.popleft())
        while q:
            yield finish(*q.popleft())


def load_server(
    cfg: Config, snapshot_dir: Optional[str] = None, epoch: Optional[int] = None, **kw
) -> PoseServer:
    """A ``PoseServer`` with the weights of a training snapshot (reference
    ``--test_epoch``): snapshot ``epoch`` (default: the latest) of the run in
    ``snapshot_dir`` (default: ``cfg.output_dir``). ``kw`` go to
    ``PoseServer`` (``max_batch``, ``flip_test``, ``device``, ``dp``,
    ``partition``), which runs on ``device="cuda"`` unless asked otherwise."""
    from ihpr_tpu_torch.engine.checkpoint import load_snapshot

    state_dict, _ = load_snapshot(snapshot_dir or cfg.output_dir, epoch)
    return PoseServer(cfg, state_dict["model"], **kw)
