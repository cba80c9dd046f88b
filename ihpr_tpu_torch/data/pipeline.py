"""Host input pipeline: batches for the two input paths, and a prefetch to
the device. Counterpart of ``ihpr_tpu.data.pipeline``.

- **Host warp** (``WarpedHostBatch``, the default where the native library
  builds): per batch, the host draws the augmentation (scale, rotation,
  flip, colour) from a ``RandomState`` seeded by (seed, epoch, batch index),
  builds the patch affines, warps every image with the native C++ warp
  (``data/native.py``), and maps the joints into heatmap voxels. The device
  only runs ``finalize_patch``.
- **Canvas** (``HostBatch``, ``host_warp=False``, or the default where the
  native library is missing): the host crops a fixed-size uint8 canvas
  around each bbox (``extract_canvas``: a slice and a zero pad, resampled
  only for people larger than ``canvas_px / span``), and the train and eval
  steps warp and augment on the device (``data/augment.py:make_patch_batch``).

A sample with an ``img_path`` is read from its file: the batch's files are
read on the loader's threads and decoded together on the loader's
``device`` (``data/jpeg.py``: nvJPEG on a CUDA device, cv2 on the CPU),
then copied back to the host for the warp or the canvas crop. On a CUDA
device the decode and the copy back run on a stream of their own, and the
loader waits for that stream alone, so a batch's decode does not queue
behind the train or eval step in flight on PyTorch's current stream. Images are
RGB, as in the JAX package (PARITY.md deviation #4). A synthetic sample
(no ``img_path``) is rendered.

In evaluation (``train=False``) there is no shuffle and no augmentation.
The draws, affines and joint transforms are the JAX package's, so both
loaders give the same batches for the same seed and datasets.

Data-parallel, ``batch_size`` is the global batch and rank r of W loads
rows [r * B/W, (r + 1) * B/W) of each one. Every rank shuffles with the
same seed and draws the augmentation for the whole global batch before it
takes its rows, so the W ranks' batches concatenate to the batch of one
process, bit for bit (JAX ``_batch_selection`` and ``_epoch_host_warp``).
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import contextlib
import dataclasses
import functools
import itertools
import logging
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ihpr_tpu_torch.config import Config
from ihpr_tpu_torch.data import jpeg, native, skeletons
from ihpr_tpu_torch.data.datasets import PoseDataset, render_synthetic_image
from ihpr_tpu_torch.data.geometry import process_bbox
from ihpr_tpu_torch.data.warp import gen_trans_np

_log = logging.getLogger(__name__)


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _to_host(images: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Tensors -> numpy arrays on the host. CUDA tensors are copied into one
    pinned buffer, one asynchronous copy each on the current stream, which
    is then waited for once (a pageable copy each ran at about 1 GB/s on an
    H100 host, PERF.md)."""
    if not images or images[0].device.type == "cpu":
        return [im.numpy() for im in images]
    buf = torch.empty(sum(im.numel() for im in images), dtype=torch.uint8, pin_memory=True)
    out, off = [], 0
    for im in images:
        dst = buf[off : off + im.numel()].view(im.shape)
        dst.copy_(im, non_blocking=True)
        out.append(dst.numpy())
        off += im.numel()
    torch.cuda.current_stream(images[0].device).synchronize()
    return out


@functools.cache
def _decode_stream(device: torch.device) -> torch.cuda.Stream:
    """The loader's stream on a CUDA device, for the decode and the copy
    back (one a device, made on first use)."""
    return torch.cuda.Stream(device)


def _load_images(samples: Sequence[dict], device, map_fn=map) -> List[np.ndarray]:
    """RGB (H, W, 3) uint8 host images of ``samples``: the files of those
    with an ``img_path`` read, decoded together on ``device`` and brought
    back to the host; the others rendered. On a CUDA device the decode and
    the copy back run on ``_decode_stream``. Reads and renders go through
    ``map_fn`` (the loader passes its thread pool's map)."""
    files = [s.get("img_path") is not None for s in samples]
    paths = [s["img_path"] for s, f in zip(samples, files) if f]
    blobs = list(map_fn(_read_bytes, paths))
    device = torch.device(device)
    on_card = device.type == "cuda" and bool(blobs)
    if on_card and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with torch.cuda.stream(_decode_stream(device)) if on_card else contextlib.nullcontext():
        decoded = iter(_to_host(jpeg.decode(blobs, device, paths)))
    rendered = iter(list(map_fn(render_synthetic_image, [s for s, f in zip(samples, files) if not f])))
    return [next(decoded) if f else next(rendered) for f in files]


def _resize_linear(img: np.ndarray, size: int) -> np.ndarray:
    """(H, W, C) uint8 -> (size, size, C) uint8 by bilinear interpolation with
    ``cv2.resize(INTER_LINEAR)``'s mapping: destination pixel p samples source
    (p + 0.5) * (src / dst) - 0.5, a source coordinate past an edge takes the
    edge pixel, and the arithmetic is cv2's fixed-point uint8 path: weights
    rounded to 11 fractional bits, the rows' sums shifted right by 4, each
    vertical product by 16, and the total rounded by 2 bits."""

    def taps(src: int):
        f = ((np.arange(size) + 0.5) * (src / size) - 0.5).astype(np.float32)
        i = np.floor(f).astype(np.int64)
        f = f - i
        f[i < 0], i[i < 0] = 0.0, 0
        last = i >= src - 1
        f[last], i[last] = 0.0, src - 1
        a1 = np.rint(f * 2048.0).astype(np.int64)
        a0 = np.rint((1.0 - f) * 2048.0).astype(np.int64)
        return i, np.minimum(i + 1, src - 1), a0, a1

    h, w = img.shape[:2]
    x0, x1, ax0, ax1 = taps(w)
    y0, y1, ay0, ay1 = taps(h)
    src = img.astype(np.int64)
    rows = src[:, x0] * ax0[None, :, None] + src[:, x1] * ax1[None, :, None]  # (H, size, C)
    out = ((rows[y0] >> 4) * ay0[:, None, None] >> 16) + ((rows[y1] >> 4) * ay1[:, None, None] >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


def extract_canvas(img: np.ndarray, bbox: np.ndarray, canvas_px: int, span: float):
    """Crop a (canvas_px, canvas_px) uint8 window centred on the bbox.

    ``span``: the window's extent as a multiple of the bbox's long side (2.0
    covers rotation and scale augmentation; 1.05 suffices for eval). Returns
    (canvas, origin (2,), scale) with image px = origin + scale * canvas px.
    A window larger than ``canvas_px`` is resampled to it (``_resize_linear``,
    the JAX package's ``cv2.resize``), and the origin moves by
    0.5 * (scale - 1), so that labels stay on the resampled pixels."""
    h, w = img.shape[:2]
    side = max(bbox[2], bbox[3]) * span
    scale = max(1.0, side / canvas_px)
    win = int(round(canvas_px * scale))
    cx, cy = bbox[0] + bbox[2] / 2.0, bbox[1] + bbox[3] / 2.0
    x0 = int(round(cx - win / 2.0))
    y0 = int(round(cy - win / 2.0))

    sx0, sy0 = max(0, x0), max(0, y0)
    sx1, sy1 = min(w, x0 + win), min(h, y0 + win)
    out = np.zeros((win, win, img.shape[2]), img.dtype)
    if sx1 > sx0 and sy1 > sy0:
        out[sy0 - y0 : sy1 - y0, sx0 - x0 : sx1 - x0] = img[sy0:sy1, sx0:sx1]
    origin = np.array([x0, y0], np.float32)
    if scale > 1.0:
        out = _resize_linear(out, canvas_px)
        origin += 0.5 * (scale - 1.0)
    return out, origin, np.float32(scale)


@dataclasses.dataclass
class HostBatch:
    """Columnar numpy batch of the canvas path (warped on the device)."""

    canvas: np.ndarray  # (B, C, C, 3) uint8
    canvas_origin: np.ndarray  # (B, 2)
    canvas_scale: np.ndarray  # (B,)
    bbox: np.ndarray  # (B, 4)
    joints: np.ndarray  # (B, J, 3) image px, mm; the primary skeleton's order
    joint_vis: np.ndarray  # (B, J)
    joints_have_depth: np.ndarray  # (B,)
    sample_idx: np.ndarray  # (B,) flat positions into BatchLoader.index


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
    ``common/base.py:Trainer._make_batch_generator``). ``train``: shuffled
    and augmented. ``train=False``: natural order, no augmentation.
    ``drop_last`` (default: ``train``) drops the last partial batch, else it
    is padded to full size by repeating its last sample; ``sample_idx`` says
    which sample each row is. ``batch_size`` is the global batch; ``rank``
    of ``world`` yields its contiguous share of each.

    ``host_warp``: yield ``WarpedHostBatch`` (True) or ``HostBatch`` canvases
    of ``canvas_px`` (False); None takes the host warp where the native
    library is available. ``device`` decodes the samples' image files."""

    def __init__(
        self,
        datasets: Sequence[PoseDataset],
        cfg: Config,
        batch_size: int,
        train: bool = True,
        canvas_px: int = 384,
        num_workers: int = 8,
        seed: int = 0,
        drop_last: Optional[bool] = None,
        host_warp: Optional[bool] = None,
        rank: int = 0,
        world: int = 1,
        device="cuda",
    ):
        if batch_size % world:
            raise ValueError(f"global batch {batch_size} is not a multiple of the {world} ranks")
        self.datasets = list(datasets)
        self.cfg = cfg
        self.batch_size = batch_size
        self.train = train
        self.canvas_px = canvas_px
        self.span = 2.0 if train and cfg.data.use_aug else 1.05
        self.seed = seed
        self.drop_last = train if drop_last is None else drop_last
        self.rank, self.world = rank, world
        self.device = torch.device(device)
        if host_warp is None:
            host_warp = native.available()
            if not host_warp:
                _log.warning("BatchLoader: the device warp (canvas batches), since native.available() is "
                             "False (%s)", native.unavailable_reason())
        self.host_warp = host_warp
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
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

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

    def _map(self, fn, entries) -> list:
        if self._pool is not None:
            return list(self._pool.map(fn, entries))
        return [fn(e) for e in entries]

    def _load_entry_images(self, entries) -> List[np.ndarray]:
        """The host images of index entries, the batch's files read on the
        pool and decoded on ``self.device`` in one call."""
        samples = [self.datasets[di].samples[si] for di, si, _ in entries]
        return _load_images(samples, self.device, self._map)

    def epoch(
        self, epoch_idx: int = 0, max_steps: Optional[int] = None
    ) -> Iterator[Union[WarpedHostBatch, HostBatch]]:
        """One epoch of batches; ``max_steps`` truncates it."""
        it = self._epoch_host_warp(epoch_idx) if self.host_warp else self._epoch_full(epoch_idx)
        yield from itertools.islice(it, max_steps)

    def _epoch_full(self, epoch_idx: int) -> Iterator[HostBatch]:
        u_joints, u_vis, u_hd, u_bbox = self._unified
        for sel in self._batch_selection(epoch_idx):
            entries = [self.index[i] for i in sel]
            images = self._load_entry_images(entries)
            canvas, origin, cscale = zip(*self._map(
                lambda k: extract_canvas(images[k], entries[k][2], self.canvas_px, self.span), range(len(sel))
            ))
            yield HostBatch(
                canvas=np.stack(canvas),
                canvas_origin=np.stack(origin),
                canvas_scale=np.asarray(cscale, np.float32),
                bbox=u_bbox[sel],
                joints=u_joints[sel],
                joint_vis=u_vis[sel],
                joints_have_depth=u_hd[sel],
                sample_idx=np.asarray(sel, np.int64),
            )

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
            patches = native.warp_batch(self._load_entry_images(entries), invs, flips, in_h, in_w)

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
    it: Iterator[Union[WarpedHostBatch, HostBatch]], device, depth: int = 2
) -> Iterator[Tuple[Dict[str, torch.Tensor], np.ndarray]]:
    """Yields (dict of tensors on ``device``, sample_idx) of either kind of
    batch, keeping ``depth`` batches in flight: on a CUDA device each array
    is copied into pinned host memory and sent with a ``non_blocking`` copy,
    so the next batch's host work overlaps the device's compute."""
    device = torch.device(device)

    def put(hb: Union[WarpedHostBatch, HostBatch]):
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
