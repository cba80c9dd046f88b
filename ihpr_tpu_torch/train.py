"""Training CLI of the port, counterpart of the repository's ``train.py``.

    python -m ihpr_tpu_torch.train --config h36m3d_r50 --data_root /data/root --pretrained resnet50.pth
    python -m ihpr_tpu_torch.train --config h36m3d_r50 --synthetic --steps 20 --end_epoch 1
    python -m ihpr_tpu_torch.train --config h36m3d_r50 --synthetic --continue
    python -m torch.distributed.run --standalone --nproc_per_node N -m ihpr_tpu_torch.train \
        --config h36m3d_r50_dp --synthetic --multihost
    python -m torch.distributed.run --standalone --nproc_per_node 4 -m ihpr_tpu_torch.train \
        --config h36m3d_r50 --synthetic --multihost --spatial 2

trains on one CUDA device (``--device``), or data-parallel with
``--multihost``: one rank per process, joined from torchrun's environment
(NCCL on ``cuda:LOCAL_RANK``; gloo with ``--device cpu``), the global batch
``batch_size_per_device`` times the ranks. ``--shard_opt_state`` shards
the Adam moments over the ranks (ZeRO-1). ``--spatial N`` splits each
sample's image rows over N ranks (a D x N grid of the ranks, N dividing
them; rows that do not split evenly split as GSPMD's; ``parallel/mesh.py``), as
``train.py --spatial`` does over JAX's devices. ``--steps 20`` caps each epoch at
20 steps; the run takes ``--end_epoch`` epochs, the config's
``optim.end_epoch`` without it, as in ``train.py``. Snapshots go to
``{output_dir}/model_dump`` (``--output_dir``, default the config's), and
``--continue`` resumes from the latest one. Past ``--rss_limit_mb`` of host
memory the run snapshots and exits with code 75 for a ``--continue``
relaunch; SIGTERM exits with 143 after the snapshot in flight is written.
``--profile_dir`` writes a ``torch.profiler`` trace of steps 20-24 of the
first epoch. ``--data_root`` is the root of every train set, in the
reference's file layouts (default ``data/<name>``; ``datasets.build_dataset``),
and its JPEGs are decoded on the device (nvJPEG on a CUDA device);
``--synthetic`` trains on rendered blobs instead. ``--pretrained`` loads an
ImageNet backbone, a torchvision ``.pth`` or the flax msgpack of
``tools/convert_torch_ckpt.py`` (``models/pretrained.py``). Under
``parallel.launch.spawn`` the process group is already joined: call
``main`` without ``--multihost``.
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
    ap.add_argument("--trainset", default=None,
                    help="comma-separated dataset override, e.g. Human36M or Human36M,MPII")
    ap.add_argument("--no_aug", action="store_true", help="disable augmentation")
    ap.add_argument("--synthetic", action="store_true", help="train on synthetic data")
    ap.add_argument("--end_epoch", type=int, default=None,
                    help="default: cfg.optim.end_epoch (with --steps too; pass 1 for one epoch)")
    ap.add_argument("--steps", type=int, default=None, help="cap steps per epoch (smoke runs)")
    ap.add_argument("--synthetic_size", type=int, default=512)
    ap.add_argument("--num_workers", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--continue", dest="continue_train", action="store_true",
                    help="resume from the latest snapshot in output_dir")
    ap.add_argument("--output_dir", default=None, help="default: the config's output_dir")
    ap.add_argument("--profile_dir", default=None, help="write a torch.profiler trace here")
    ap.add_argument("--rss_limit_mb", type=float, default=None,
                    help="host-RSS watchdog: past it, snapshot and exit 75 "
                    "(default 80%% of MemTotal, 0 disables)")
    ap.add_argument("--rss_check_steps", type=int, default=100,
                    help="check the watchdog every N steps (0: epoch boundaries only)")
    ap.add_argument("--multihost", action="store_true",
                    help="join the process group torchrun describes (data-parallel, one rank a process)")
    ap.add_argument("--shard_opt_state", action="store_true",
                    help="ZeRO-1: shard the Adam moments over the ranks")
    ap.add_argument("--pretrained", default=None,
                    help="ImageNet backbone: a torchvision .pth, or convert_torch_ckpt.py's msgpack")
    ap.add_argument("--spatial", type=int, default=None, metavar="N",
                    help="shard each sample's image rows over N ranks (a (data, spatial) grid)")
    return ap.parse_args(argv)


def main(argv=None):
    install_graceful_shutdown()
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from ihpr_tpu_torch.config import get_config
    from ihpr_tpu_torch.parallel import mesh

    device = args.device
    if args.multihost:
        device = mesh.init_process_group(torch.device(args.device).type)
    try:
        _train(args, get_config(args.config), device)
    finally:
        if args.multihost:
            torch.distributed.destroy_process_group()


def _train(args, cfg, device):
    from ihpr_tpu_torch.engine.trainer import Trainer

    if args.output_dir:
        cfg = cfg.replace(output_dir=args.output_dir)
    kw = {}
    if args.trainset:
        kw["trainset"] = tuple(args.trainset.split(","))
    if args.no_aug:
        kw["use_aug"] = False
    if kw:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, **kw))
    par = {}
    if args.shard_opt_state:
        par["shard_opt_state"] = True
    if args.spatial:
        par["spatial_axis_size"] = args.spatial
    if par:
        cfg = cfg.replace(parallel=dataclasses.replace(cfg.parallel, **par))
    trainer = Trainer(
        cfg, data_root="synthetic" if args.synthetic else args.data_root, continue_train=args.continue_train,
        num_workers=args.num_workers, synthetic_size=args.synthetic_size,
        rss_limit_mb=args.rss_limit_mb, rss_check_interval_steps=args.rss_check_steps,
        device=device,
    )
    try:
        if args.pretrained:
            trainer.load_pretrained_backbone(args.pretrained)
        if args.steps is not None:
            # After a restore this restarts Adam, as JAX's train.py does.
            trainer.cap_steps_per_epoch(args.steps)
        trainer.train(args.end_epoch, profile_dir=args.profile_dir)
    finally:
        trainer.close()


if __name__ == "__main__":
    main()
