"""Training CLI of the port, counterpart of the repository's ``train.py``.

    python -m ihpr_tpu_torch.train --config h36m3d_r50 --synthetic --steps 20

trains on one CUDA device (``--device``) for 20 steps: one epoch capped at
20 steps, unless ``--end_epoch`` asks for more epochs. Only synthetic data
is ported. The flags of ``train.py`` that this slice does not have
(checkpoints, resume, pretrained backbones, profiling, multi-host and
sharding, the RSS watchdog) are rejected.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

_UNPORTED = {
    "continue_train": "--continue",
    "pretrained": "--pretrained",
    "output_dir": "--output_dir",
    "profile_dir": "--profile_dir",
    "multihost": "--multihost",
    "spatial": "--spatial",
    "shard_opt_state": "--shard_opt_state",
    "rss_limit_mb": "--rss_limit_mb",
    "rss_check_steps": "--rss_check_steps",
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="h36m3d_r50")
    ap.add_argument("--data_root", default=None, help="only 'synthetic' is ported")
    ap.add_argument("--trainset", default=None,
                    help="comma-separated dataset override, e.g. Human36M or Human36M,MPII")
    ap.add_argument("--no_aug", action="store_true", help="disable augmentation")
    ap.add_argument("--synthetic", action="store_true", help="train on synthetic data")
    ap.add_argument("--end_epoch", type=int, default=None,
                    help="default: cfg.optim.end_epoch, or 1 with --steps")
    ap.add_argument("--steps", type=int, default=None, help="cap steps per epoch (smoke runs)")
    ap.add_argument("--synthetic_size", type=int, default=512)
    ap.add_argument("--num_workers", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    # train.py's flags that the port does not have: accepted, then refused.
    ap.add_argument("--continue", dest="continue_train", action="store_true")
    ap.add_argument("--pretrained", default=None)
    ap.add_argument("--output_dir", default=None)
    ap.add_argument("--profile_dir", default=None)
    ap.add_argument("--multihost", action="store_true")
    ap.add_argument("--spatial", type=int, default=None)
    ap.add_argument("--shard_opt_state", action="store_true")
    ap.add_argument("--rss_limit_mb", type=float, default=None)
    ap.add_argument("--rss_check_steps", type=int, default=None)
    args = ap.parse_args(argv)
    given = [flag for dest, flag in _UNPORTED.items() if getattr(args, dest) not in (None, False)]
    if given:
        ap.error(f"{', '.join(given)}: not ported to ihpr_tpu_torch")
    if not args.synthetic and args.data_root != "synthetic":
        ap.error("only synthetic data is ported: pass --synthetic")
    return args


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from ihpr_tpu_torch.config import get_config
    from ihpr_tpu_torch.engine.trainer import Trainer

    cfg = get_config(args.config)
    kw = {}
    if args.trainset:
        kw["trainset"] = tuple(args.trainset.split(","))
    if args.no_aug:
        kw["use_aug"] = False
    if kw:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, **kw))
    trainer = Trainer(
        cfg, data_root="synthetic", num_workers=args.num_workers,
        synthetic_size=args.synthetic_size, device=args.device,
    )
    try:
        end_epoch = args.end_epoch
        if args.steps is not None:
            trainer.cap_steps_per_epoch(args.steps)
            end_epoch = end_epoch or 1
        trainer.train(end_epoch)
    finally:
        trainer.close()


if __name__ == "__main__":
    main()
