"""Published dense peaks of the cards a run may find (NVIDIA's data sheet,
SXM part, without sparsity), matched by a part of the name that
``torch.cuda.get_device_name`` gives. They assume the card's full power
limit; the result line carries the limit the card reports."""

from __future__ import annotations

from typing import Dict

PEAKS = {
    "H100": {"bf16_flops_per_s": 989e12, "tf32_flops_per_s": 495e12, "fp32_flops_per_s": 67e12,
             "hbm_bytes_per_s": 3.35e12},
}


def peak(kind: str) -> Dict[str, float]:
    for part, values in PEAKS.items():
        if part in kind:
            return values
    raise KeyError(f"no published peaks for {kind!r}")
