"""Time K1 / K2 (natural base) and K1-fp32 / K2-fp32 of the tree this runs
in, at the flagship head, CUDA events (20 launches, median of 5): one JSON
line. Run from two trees in turns to compare them on one card:

    PYTHONPATH=. python k12_time.py TAG
"""

import json
import statistics
import sys

import torch

from ihpr_tpu_torch.ops import fused_head_integral as fhi


def ms(fn, n=20, reps=5):
    fn()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / n)
    return statistics.median(out)


res = {"tree": sys.argv[1], "device": torch.cuda.get_device_name(0)}
for dtype, bsz, tag in ((torch.bfloat16, 128, "bf16"), (torch.float32, 32, "fp32")):
    g = torch.Generator().manual_seed(0)
    feat = (torch.randn(bsz, 4096, 256, generator=g) * 0.5).to("cuda", dtype)
    kernel = (torch.randn(256, 1152, generator=g) * (10.0 / 16)).to("cuda", dtype)
    bias = (torch.randn(1152, generator=g) * 0.1).to("cuda", dtype)
    coords, m, s = fhi.kernel_stats(feat, kernel, bias, 18, 64, 64)
    gc = torch.randn(bsz, 18, 3, generator=g).cuda()
    res[f"K1_{tag}_ms"] = ms(lambda: fhi.kernel_stats(feat, kernel, bias, 18, 64, 64))
    res[f"K2_{tag}_ms"] = ms(lambda: fhi.kernel_bwd(feat, kernel, bias, m, s, coords, gc, 18, 64, 64), n=10)
print(json.dumps(res))
