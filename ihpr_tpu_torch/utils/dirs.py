"""Output-tree helpers (the port's copy of ``ihpr_tpu.utils.dirs``).

The reference's output layout: ``model_dump``, ``log``, ``result`` and
``vis`` under ``output_dir``.
"""

from __future__ import annotations

import os


def make_folder(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


def make_output_tree(output_dir: str) -> dict:
    """Create the reference's output layout; returns the subdir map."""
    return {
        name: make_folder(os.path.join(output_dir, name))
        for name in ("model_dump", "log", "result", "vis")
    }
