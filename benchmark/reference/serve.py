"""The reference's answer to a serving request: one frame and its people's
boxes -> each person's joints in frame pixels and millimetres of depth.

1. Each box is clipped to the frame, widened or heightened to the network's
   aspect ratio about its centre and enlarged by the margin (a degenerate box
   is kept as given).
2. The crop samples the frame at ``src = c + (dst - in / 2) * size / in`` for
   each integer patch pixel ``dst``, bilinearly, zero outside the frame, and
   rounds to uint8 (half up).
3. The network runs in inference mode on the crop and on its mirror image;
   the mirror's coords are mirrored back (``x -> out_w - 1 - x``, the left
   and right joints swapped) and averaged with the crop's.
4. Voxel x, y scale to patch pixels (``* in / out``) and map through step 2's
   affine to frame pixels; voxel z maps to ``(z / D * 2 - 1) * depth_mm / 2``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import pose_net
from .train import no_tf32


def fix_box(box: np.ndarray, frame_w: int, frame_h: int, aspect: float, margin: float) -> np.ndarray:
    x, y, w, h = (float(t) for t in box)
    x1, y1 = max(0.0, x), max(0.0, y)
    x2 = min(frame_w - 1.0, x1 + max(0.0, w - 1.0))
    y2 = min(frame_h - 1.0, y1 + max(0.0, h - 1.0))
    if not (w * h > 0 and x2 >= x1 and y2 >= y1):
        return np.asarray(box, np.float64)
    w, h = x2 - x1, y2 - y1
    cx, cy = x1 + w / 2.0, y1 + h / 2.0
    if w > aspect * h:
        h = w / aspect
    elif w < aspect * h:
        w = h * aspect
    return np.array([cx - w * margin / 2.0, cy - h * margin / 2.0, w * margin, h * margin])


def crop_affine(box: np.ndarray, in_h: int, in_w: int) -> np.ndarray:
    """Patch pixel -> frame pixel, (2, 3)."""
    x, y, w, h = box
    return np.array([[w / in_w, 0.0, x], [0.0, h / in_h, y]])


def crops(frame: torch.Tensor, affines: torch.Tensor, in_h: int, in_w: int) -> torch.Tensor:
    """(H, W, 3) uint8 frame, (N, 2, 3) float32 affines -> (N, in_h, in_w, 3) uint8."""
    fh, fw = frame.shape[:2]
    dev = frame.device
    ys = torch.arange(in_h, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(in_w, dtype=torch.float32, device=dev)[None, None, :]
    a = affines.to(dev, torch.float32)
    sx = a[:, 0, 0, None, None] * xs + a[:, 0, 1, None, None] * ys + a[:, 0, 2, None, None]
    sy = a[:, 1, 0, None, None] * xs + a[:, 1, 1, None, None] * ys + a[:, 1, 2, None, None]
    x0, y0 = sx.floor(), sy.floor()
    ax, ay = (sx - x0)[..., None], (sy - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    src = frame.to(torch.float32)
    acc = torch.zeros(sx.shape + (3,), dtype=torch.float32, device=dev)
    for dy, wy in ((0, 1 - ay), (1, ay)):
        for dx, wx in ((0, 1 - ax), (1, ax)):
            yy, xx = y0 + dy, x0 + dx
            inside = ((yy >= 0) & (yy < fh) & (xx >= 0) & (xx < fw))[..., None]
            pix = src[yy.clamp(0, fh - 1), xx.clamp(0, fw - 1)]
            acc += torch.where(inside, wx * wy * pix, 0.0)
    return (acc + 0.5).floor().clamp(0, 255).to(torch.uint8)


def flip_test(net: pose_net.PoseNetRef, p, image: torch.Tensor, flip_pairs, out_w: int) -> torch.Tensor:
    b = image.shape[0]
    both = net.coords(p, torch.cat([image, image.flip(2)]), train=False)
    plain, mirrored = both[:b], both[b:].clone()
    mirrored[..., 0] = out_w - 1.0 - mirrored[..., 0]
    perm = list(range(mirrored.shape[1]))
    for i, j in flip_pairs:
        perm[i], perm[j] = perm[j], perm[i]
    return (plain + mirrored[:, perm]) * 0.5


def answer(sizes: Dict, state: Dict[str, torch.Tensor], frames: Sequence[torch.Tensor],
           requests: Sequence[Tuple[int, np.ndarray]], quant=None, chunk: int = 16) -> List[Dict]:
    """Each request (frame index, (N, 4) boxes x, y, w, h) -> {"coords": (N, J, 3)
    frame pixels and mm, "px_per_voxel": (N,) the box's frame pixels per
    heatmap voxel}. ``frames``: uint8 (H, W, 3) tensors on the device the
    reference runs on; ``chunk``: people a forward."""
    in_h, in_w = sizes["input_shape"]
    out_h, out_w = sizes["output_shape"]
    depth, depth_mm = sizes["depth_dim"], sizes["bbox_3d_shape"][0]
    net = pose_net.PoseNetRef(sizes, quant)
    people = []
    for r, (idx, boxes) in enumerate(requests):
        fh, fw = frames[idx].shape[:2]
        for box in np.asarray(boxes, np.float64):
            people.append((r, idx, crop_affine(fix_box(box, fw, fh, in_w / in_h, sizes["bbox_margin"]), in_h, in_w)))
    coords = []
    with torch.no_grad(), no_tf32():
        for s in range(0, len(people), chunk):
            part = people[s:s + chunk]
            patches = torch.cat([crops(frames[idx], torch.as_tensor(aff[None], dtype=torch.float32), in_h, in_w)
                                 for _, idx, aff in part])
            ones = torch.ones((len(part), 3), dtype=torch.float32, device=patches.device)
            image = pose_net.normalize(patches, ones, sizes)
            coords.append(flip_test(net, state, image, sizes["flip_pairs"], out_w).double().cpu().numpy())
    vox = np.concatenate(coords) if coords else np.zeros((0, sizes["joint_num"], 3))
    out = [{"coords": [], "px_per_voxel": []} for _ in requests]
    for (r, _, aff), v in zip(people, vox):
        xy = np.stack([v[:, 0] / out_w * in_w, v[:, 1] / out_h * in_h, np.ones(len(v))], -1) @ aff.T
        z = (v[:, 2] / depth * 2.0 - 1.0) * (depth_mm / 2.0)
        out[r]["coords"].append(np.concatenate([xy, z[:, None]], -1))
        out[r]["px_per_voxel"].append(aff[0, 0] * in_w / out_w)
    return [{k: np.asarray(v) for k, v in o.items()} for o in out]
