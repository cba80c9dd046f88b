"""End-to-end evidence for the 2-D config family, the port of JAX's
``tools/mpii2d_probe.py``.

Trains ``mpii2d_r50`` (ResNet-50 + 64x64 2-D integral, depth_dim=1) on
4096 synthetic MPII-skeleton frames (seed 31) for 40 epochs, and scores
PCKh@0.5 on 256 unseen frames (seed 32) through the whole eval chain
(Tester -> warp back to the original pixels -> head-normalised PCKh).
Chance is about 0.05; the bar is 0.85, JAX's. Writes
``{output_dir}/mpii2d_probe.json`` and exits 0 at or above the bar:

    python -m ihpr_tpu_torch.tools.mpii2d_probe [--device cuda] [--output_dir output/mpii2d_probe]
"""

from __future__ import annotations

from ihpr_tpu_torch.data import skeletons
from ihpr_tpu_torch.tools._accuracy import probe_2d


# The probe as JAX's tool runs it (``_accuracy.probe_2d``'s keywords).
PROBE = dict(tool="mpii2d_probe", config="mpii2d_r50", skel=skeletons.MPII, seeds=(31, 32), metric="PCKh@0.5",
             json_key="pckh_at_05", bar=0.85)


def main(argv=None):
    probe_2d(argv, __doc__, **PROBE)


if __name__ == "__main__":
    main()
