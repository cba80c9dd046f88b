"""Host input pipeline: batches warped on the host, and a prefetch to the
device. Counterpart of the host-warp path of ``ihpr_tpu.data.pipeline``
(``BatchLoader._epoch_host_warp`` and ``prefetch_to_device``).

Per batch, the host draws the augmentation (scale, rotation, flip, colour)
from a ``RandomState`` seeded by (seed, epoch, batch index), builds the
patch affines, warps every image with the native C++ warp
(``data/native.py``), and maps the joints into heatmap voxels. The device
only runs ``finalize_patch`` (colour scale + normalize). In evaluation
(``train=False``) there is no shuffle and no augmentation. The draws,
affines and joint transforms are the JAX package's, so both loaders give
the same batches for the same seed and datasets.

Data-parallel, ``batch_size`` is the global batch and rank r of W loads
rows [r * B/W, (r + 1) * B/W) of each one. Every rank shuffles with the
same seed and draws the augmentation for the whole global batch before it
takes its rows, so the W ranks' batches concatenate to the batch of one
process, bit for bit (JAX ``_batch_selection`` and ``_epoch_host_warp``).
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import dataclasses
import itertools
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ihpr_tpu_torch.config import Config
from ihpr_tpu_torch.data import native, skeletons
from ihpr_tpu_torch.data.datasets import PoseDataset, render_synthetic_image
from ihpr_tpu_torch.data.geometry import process_bbox
from ihpr_tpu_torch.data.warp import gen_trans_np


def _load_image(sample: dict) -> np.ndarray:
    """RGB uint8 image of a synthetic sample (the port has no image decoder)."""
    if sample.get("img_path") is not None:
        raise ValueError(f"{sample['img_path']}: real images are not ported; synthetic samples only")
    return render_synthetic_image(sample)


@dataclasses.dataclass
class WarpedHostBatch:
    """Columnar numpy batch, patches already warped on the host."""

    patch: np.ndarray  # (B, in_h, in_w, 3) uint8
    color_scale: np.ndarray  # (B, 3)
    joint_img: np.ndarray  # (B, J, 3) voxel coords
    joint_vis: np.ndarray  # (B, J)
    joints_have_depth: np.ndarray  # (B,)
    sample_idx: np.ndarray  # (B,) flat positions into BatchLoader.index


class BatchLoader:
    """Epochs over one or more datasets, with joint order unified onto the
    primary (first) dataset's skeleton (reference
    ``common/base.py:Trainer._make_batch_generator``). ``train``: shuffled,
    augmented, the last partial batch dropped. ``train=False``: natural
    order, no augmentation, and the last batch kept, padded to full size by
    repeating its last sample; ``sample_idx`` says which sample each row
    is. ``batch_size`` is the global batch; ``rank`` of ``world`` yields its
    contiguous share of each."""

    def __init__(
        self,
        datasets: Sequence[PoseDataset],
        cfg: Config,
        batch_size: int,
        train: bool = True,
        num_workers: int = 8,
        seed: int = 0,
        rank: int = 0,
        world: int = 1,
    ):
        if batch_size % world:
            raise ValueError(f"global batch {batch_size} is not a multiple of the {world} ranks")
        self.datasets = list(datasets)
        self.cfg = cfg
        self.batch_size = batch_size
        self.train = train
        self.seed = seed
        self.rank, self.world = rank, world
        self.primary = self.datasets[0].skeleton
        self._pool = cf.ThreadPoolExecutor(num_workers) if num_workers > 0 else None

        aspect = cfg.data.input_shape[1] / cfg.data.input_shape[0]
        # (dataset index, sample index, aspect-fixed bbox); degenerate boxes dropped
        self.index: List[tuple] = []
        for di, ds in enumerate(self.datasets):
            for si, s in enumerate(ds.samples):
                bb = process_bbox(
                    np.asarray(s["bbox"], np.float32), s["img_shape"][1], s["img_shape"][0],
                    aspect, cfg.data.bbox_margin,
                )
                if bb is not None:
                    self.index.append((di, si, bb))
        self._unified = self._unify()

    @property
    def joint_num(self) -> int:
        return self.primary.joint_num

    def __len__(self):
        n = len(self.index)
        return n // self.batch_size if self.train else -(-n // self.batch_size)

    def close(self):
        """Stop the image-loading threads."""
        if self._pool is not None:
            self._pool.shutdown()

    def _unify(self):
        """Joints, visibility and depth flag of every sample in the primary
        skeleton's order, and the fixed bboxes, as stacked arrays."""
        all_joints, all_vis, all_hd = [], [], []
        for di, si, _ in self.index:
            ds = self.datasets[di]
            s = ds.samples[si]
            j, v = s["joint_img"], s["joint_vis"]
            if ds.skeleton.name != self.primary.name:
                j = skeletons.transform_joint_to_other_db(j, ds.skeleton, self.primary)
                v = skeletons.transform_joint_to_other_db(v[:, None], ds.skeleton, self.primary)[:, 0]
            all_joints.append(j)
            all_vis.append(v)
            all_hd.append(float(ds.skeleton.has_depth))
        return (
            np.stack(all_joints).astype(np.float32),
            np.stack(all_vis).astype(np.float32),
            np.asarray(all_hd, np.float32),
            np.stack([e[2] for e in self.index]).astype(np.float32),
        )

    def _batch_selection(self, epoch_idx: int) -> Iterator[np.ndarray]:
        """This rank's sample positions of each global batch: rows
        [rank * local, (rank + 1) * local) of it."""
        order = np.arange(len(self.index))
        if self.train:
            np.random.RandomState(self.seed + epoch_idx).shuffle(order)
        bs = self.batch_size
        local = bs // self.world
        for b in range(len(self)):
            sel = order[b * bs : (b + 1) * bs]
            if len(sel) < bs:  # pad the final batch by repeating its last sample
                sel = np.concatenate([sel, np.full(bs - len(sel), sel[-1])])
            yield sel[self.rank * local : (self.rank + 1) * local]

    def _load_entry_image(self, entry) -> np.ndarray:
        di, si, _ = entry
        return _load_image(self.datasets[di].samples[si])

    def epoch(self, epoch_idx: int = 0, max_steps: Optional[int] = None) -> Iterator[WarpedHostBatch]:
        """One epoch of batches; ``max_steps`` truncates it."""
        yield from itertools.islice(self._epoch_host_warp(epoch_idx), max_steps)

    def _epoch_host_warp(self, epoch_idx: int) -> Iterator[WarpedHostBatch]:
        d = self.cfg.data
        in_h, in_w = d.input_shape
        out_h, out_w = d.output_shape
        perm = self.primary.flip_permutation()
        jnum = self.primary.joint_num
        u_joints, u_vis, u_hd, u_bbox = self._unified

        for bi, sel in enumerate(self._batch_selection(epoch_idx)):
            entries = [self.index[i] for i in sel]
            b = len(entries)
            samples = [self.datasets[di].samples[si] for di, si, _ in entries]
            img_w = np.asarray([s["img_shape"][1] for s in samples], np.float32)

            # Augmentation draws (reference get_aug_config distributions),
            # drawn for the global batch gb and sliced to this rank's rows.
            rng = np.random.RandomState((self.seed * 1000003 + epoch_idx * 131071 + bi) % (2**31))
            if self.train and d.use_aug:
                gb = self.batch_size
                rows = slice(self.rank * b, (self.rank + 1) * b)
                scale = (1.0 + d.scale_factor * np.clip(rng.randn(gb), -1, 1))[rows]
                rot_all = d.rot_factor * np.clip(rng.randn(gb), -2, 2)
                rot = np.where(rng.rand(gb) <= d.rot_prob, rot_all, 0.0)[rows]
                flips = (rng.rand(gb) <= d.flip_prob).astype(np.int32)[rows]
                colors = rng.uniform(1 - d.color_factor, 1 + d.color_factor, (gb, 3)).astype(np.float32)[rows]
            else:
                scale = np.ones(b)
                rot = np.zeros(b)
                flips = np.zeros(b, np.int32)
                colors = np.ones((b, 3), np.float32)

            bbox = u_bbox[sel]
            c_x = bbox[:, 0] + bbox[:, 2] * 0.5
            c_y = bbox[:, 1] + bbox[:, 3] * 0.5
            c_x = np.where(flips, img_w - 1.0 - c_x, c_x)  # reference flip
            invs = gen_trans_np(c_x, c_y, bbox[:, 2], bbox[:, 3], in_w, in_h, scale, rot, inv=True)
            fwds = gen_trans_np(c_x, c_y, bbox[:, 2], bbox[:, 3], in_w, in_h, scale, rot)
            if self._pool is not None:
                images = list(self._pool.map(self._load_entry_image, entries))
            else:
                images = [self._load_entry_image(e) for e in entries]
            patches = native.warp_batch(images, invs, flips, in_h, in_w)

            # Joints: flip (x mirror + pair swap), patch affine, voxels.
            joints = u_joints[sel]
            vis = u_vis[sel].copy()
            fl = flips.astype(bool)
            xy = joints[:, :, :2].copy()
            z = joints[:, :, 2].copy()
            xy[fl, :, 0] = img_w[fl, None] - 1.0 - xy[fl, :, 0]
            xy[fl] = xy[fl][:, perm]
            z[fl] = z[fl][:, perm]
            vis[fl] = vis[fl][:, perm]
            ones = np.ones((b, jnum, 1), np.float32)
            xy_patch = np.einsum("bij,bkj->bki", fwds, np.concatenate([xy, ones], -1))
            x_hm = xy_patch[:, :, 0] / in_w * out_w
            y_hm = xy_patch[:, :, 1] / in_h * out_h
            z_hm = z / (d.bbox_3d_shape[0] / 2.0) * (d.depth_dim / 2.0) + d.depth_dim / 2.0
            inside = (
                (x_hm >= 0) & (x_hm < out_w)
                & (y_hm >= 0) & (y_hm < out_h)
                & (z_hm >= 0) & (z_hm < d.depth_dim)
            )
            yield WarpedHostBatch(
                patch=patches,
                color_scale=colors,
                joint_img=np.stack([x_hm, y_hm, z_hm], -1).astype(np.float32),
                joint_vis=(vis * inside).astype(np.float32),
                joints_have_depth=u_hd[sel],
                sample_idx=np.asarray(sel, np.int64),
            )


def prefetch_to_device(
    it: Iterator[WarpedHostBatch], device, depth: int = 2
) -> Iterator[Tuple[Dict[str, torch.Tensor], np.ndarray]]:
    """Yields (dict of tensors on ``device``, sample_idx), keeping ``depth``
    batches in flight: on a CUDA device each array is copied into pinned
    host memory and sent with a ``non_blocking`` copy, so the next batch's
    host work overlaps the device's compute."""
    device = torch.device(device)

    def put(hb: WarpedHostBatch):
        out = {}
        for f in dataclasses.fields(hb):
            if f.name == "sample_idx":
                continue
            t = torch.from_numpy(np.ascontiguousarray(getattr(hb, f.name)))
            if device.type == "cuda":
                out[f.name] = t.pin_memory().to(device, non_blocking=True)
            else:
                out[f.name] = t.to(device)
        return out, hb.sample_idx

    queue = collections.deque()
    for hb in it:
        queue.append(put(hb))
        if len(queue) >= depth:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
