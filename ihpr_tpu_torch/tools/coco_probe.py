"""End-to-end evidence for the COCO config family, the port of JAX's
``tools/coco_probe.py``.

Trains ``coco2d_r50`` (ResNet-50 + 64x64 2-D integral, the 17-joint COCO
skeleton) on 4096 synthetic frames (seed 41) for 40 epochs, and scores OKS
keypoint AP on 256 unseen frames (seed 42) through the whole eval chain,
the COCOeval detections file (``result/person_keypoints_result.json``)
included. A centre guess scores AP of about 0; the bar is 0.80, JAX's.
Writes ``{output_dir}/coco_probe.json`` and exits 0 at or above the bar:

    python -m ihpr_tpu_torch.tools.coco_probe [--device cuda] [--output_dir output/coco_probe]
"""

from __future__ import annotations

from ihpr_tpu_torch.data import skeletons
from ihpr_tpu_torch.tools._accuracy import probe_2d


# The probe as JAX's tool runs it (``_accuracy.probe_2d``'s keywords).
PROBE = dict(tool="coco_probe", config="coco2d_r50", skel=skeletons.MSCOCO, seeds=(41, 42), metric="AP",
             json_key="oks_ap", bar=0.80, artifact="person_keypoints_result.json")


def main(argv=None):
    probe_2d(argv, __doc__, **PROBE)


if __name__ == "__main__":
    main()
