"""ihpr_tpu_torch and chip_smoke.py import neither JAX nor the JAX package."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
import ihpr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ihpr_tpu_torch.__path__, "ihpr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "ihpr_tpu"))
print(len(names), ",".join(names), leaked)
"""


def test_port_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    count, names, leaked = proc.stdout.strip().split(" ", 2)
    assert int(count) >= 15, proc.stdout  # every module was found and imported
    for name in ("ihpr_tpu_torch.engine.export", "ihpr_tpu_torch.tools.export_artifact",
                 "ihpr_tpu_torch.parallel.mesh", "ihpr_tpu_torch.parallel.launch",
                 "ihpr_tpu_torch.tools.serving_bench", "ihpr_tpu_torch.data.jpeg",
                 "ihpr_tpu_torch.models.pretrained", "ihpr_tpu_torch.utils.msgpack",
                 "ihpr_tpu_torch.tools.synthetic_root", "ihpr_tpu_torch.ops.jpeg_color",
                 "ihpr_tpu_torch.tools.accuracy_loop", "ihpr_tpu_torch.tools.mpii2d_probe",
                 "ihpr_tpu_torch.tools.coco_probe", "ihpr_tpu_torch.tools._accuracy",
                 "ihpr_tpu_torch.tools.bf16_drift", "ihpr_tpu_torch.tools.validate_data",
                 "ihpr_tpu_torch.tools.dress_rehearsal", "ihpr_tpu_torch.utils.vis"):
        assert name in names.split(","), name
    assert leaked == "[]", leaked
