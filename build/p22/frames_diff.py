"""The flagship preset's first synthetic train frames encoded by nvJPEG (on
the card) and by cv2 (the CPU), both decoded by the loader's decoder on the
card: each against the rendered frame (mean and max |level| difference,
over all pixels and over the blobs' pixels), the two against each other,
the file sizes and each encoder's chroma subsampling.

    PYTHONPATH=. python build/p22/frames_diff.py [N]
"""

import sys

import numpy as np
import torch

from ihpr_tpu_torch.data import jpeg, skeletons
from ihpr_tpu_torch.data.datasets import make_synthetic, render_synthetic_image

n = int(sys.argv[1]) if len(sys.argv) > 1 else 64
samples = make_synthetic(skeletons.H36M, n, seed=11, img_size=320, easy_depth=True, hue_mode="index")
imgs = [render_synthetic_image(s) for s in samples]
blobs = {dev: jpeg.encode(imgs, 95, dev) for dev in ("cuda", "cpu")}
dec = {dev: [t.cpu().numpy().astype(np.int16) for t in jpeg.decode(b, "cuda")] for dev, b in blobs.items()}
ref = [im.astype(np.int16) for im in imgs]
blob_px = [im.max(axis=2) > 8 for im in imgs]  # pixels a blob covers
for dev in ("cuda", "cpu"):
    d = [np.abs(a - r) for a, r in zip(dec[dev], ref)]
    print(f"{'nvJPEG' if dev == 'cuda' else 'cv2'} frames: mean |diff| {np.mean([x.mean() for x in d]):.4f} levels, "
          f"on blob pixels {np.mean([x[m].mean() for x, m in zip(d, blob_px)]):.4f}, max {max(x.max() for x in d)}; "
          f"{np.mean([len(b) for b in blobs[dev]]):.0f} bytes a frame; subsampling "
          f"{jpeg.subsampling(blobs[dev][0])}")
d = [np.abs(a - b) for a, b in zip(dec["cuda"], dec["cpu"])]
print(f"nvJPEG vs cv2 frames decoded: mean |diff| {np.mean([x.mean() for x in d]):.4f}, on blob pixels "
      f"{np.mean([x[m].mean() for x, m in zip(d, blob_px)]):.4f}, max {max(x.max() for x in d)}  "
      f"[{torch.cuda.get_device_name(0)}]")
