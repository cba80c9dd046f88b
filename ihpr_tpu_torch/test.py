"""Evaluation CLI of the port, counterpart of the repository's ``test.py``.

    python -m ihpr_tpu_torch.test --config h36m3d_r50 --data_root /data/root [--test_epoch N] [--output_dir D]
    python -m ihpr_tpu_torch.test --config h36m3d_r50 --synthetic

evaluates snapshot N (default: the latest) of the run in ``output_dir``
(default: the config's) on the config's test set, with flip-test, on one
CUDA device (``--device``), prints the metrics and writes them, the
predictions and the reference's result files to ``{output_dir}/result``.
With ``--multihost`` (under torchrun, as the train CLI) each rank scores
its rows of each global batch, every rank prints the gathered metrics and
rank 0 writes the files; ``--spatial N`` splits each sample's image rows
over N of the ranks (``parallel/mesh.py``), each sample scored once.
``--data_root`` is the test set's root in the reference's file layout
(default ``data/<name>``), its JPEGs decoded on the device; ``--synthetic``
evaluates ``--synthetic_size`` rendered samples. ``--vis`` also writes
the overlays of the first 8 predictions to ``{output_dir}/vis/pred_{i}.jpg``
(``Tester.evaluate(vis=True)``), as ``test.py --vis`` does.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

import torch

from ihpr_tpu_torch.utils.shutdown import install_graceful_shutdown

def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="h36m3d_r50")
    ap.add_argument("--data_root", default=None, help="dataset root directory (default data/<name>)")
    ap.add_argument("--synthetic", action="store_true", help="evaluate on synthetic data")
    ap.add_argument("--test_epoch", type=int, default=None, help="snapshot epoch (default: latest)")
    ap.add_argument("--synthetic_size", type=int, default=128)
    ap.add_argument("--num_workers", type=int, default=8)
    ap.add_argument("--output_dir", default=None, help="default: the config's output_dir")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--multihost", action="store_true",
                    help="join the process group torchrun describes (data-parallel eval)")
    ap.add_argument("--spatial", type=int, default=None, metavar="N",
                    help="shard each sample's image rows over N ranks (a (data, spatial) grid)")
    ap.add_argument("--vis", action="store_true", help="dump keypoint overlays to {output_dir}/vis")
    return ap.parse_args(argv)


def main(argv=None):
    install_graceful_shutdown()
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from ihpr_tpu_torch.config import get_config
    from ihpr_tpu_torch.engine.tester import Tester
    from ihpr_tpu_torch.parallel import mesh

    cfg = get_config(args.config)
    if args.output_dir:
        cfg = cfg.replace(output_dir=args.output_dir)
    if args.spatial:
        cfg = cfg.replace(parallel=dataclasses.replace(cfg.parallel, spatial_axis_size=args.spatial))
    device = args.device
    if args.multihost:
        device = mesh.init_process_group(torch.device(args.device).type)
    try:
        tester = Tester(
            cfg, test_epoch=args.test_epoch, data_root="synthetic" if args.synthetic else args.data_root,
            num_workers=args.num_workers,
            synthetic_size=args.synthetic_size, device=device,
        )
        try:
            metrics = tester.evaluate(vis=args.vis)
        finally:
            tester.close()
    finally:
        if args.multihost:
            torch.distributed.destroy_process_group()
    print(metrics)
    return metrics


if __name__ == "__main__":
    main()
