"""Run ``accuracy_loop`` in one variant of its flagship condition, without a
new flag on the tool (JAX's tool has none):

    python build/p22/accuracy_variants.py --variant fp32 -- --preset flagship --bn_mode flax --output_dir D
    python build/p22/accuracy_variants.py --variant seed --seed 1 -- ...

The synthetic frames are the tool's own: cv2's bytes, encoded on the CPU
(``tools/_accuracy.py:synthetic_samples``), as the JAX package writes them.

- ``fp32``: the preset trains in fp32 with fp32 logits (the arithmetic of
  ``h36m3d_r50_fp32``; the tool already sets ``matmul_precision="highest"``);
- ``seed``: the preset with ``cfg.seed`` (model init and loader order) set.

The result file gains ``variant``, ``seed`` and ``compute_dtype``."""

import argparse
import dataclasses
import sys

from ihpr_tpu_torch.tools import accuracy_loop

ap = argparse.ArgumentParser()
ap.add_argument("--variant", choices=["fp32", "seed"], required=True)
ap.add_argument("--seed", type=int, default=0)
ap.add_argument("rest", nargs=argparse.REMAINDER)
args = ap.parse_args()
rest = args.rest[1:] if args.rest[:1] == ["--"] else args.rest

preset_config = accuracy_loop.preset_config


def patched_preset(preset):
    cfg = preset_config(preset).replace(seed=args.seed)
    if args.variant == "fp32":
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32", fp32_logits=True))
    return cfg


accuracy_loop.preset_config = patched_preset
finish = accuracy_loop.finish


def patched_finish(tool, out_dir, result, ok, rows=()):
    result.update(variant=args.variant, seed=args.seed,
                  compute_dtype=patched_preset(result["preset"]).model.compute_dtype)
    finish(tool, out_dir, result, ok, rows)


accuracy_loop.finish = patched_finish
sys.argv = [sys.argv[0]] + rest
accuracy_loop.main(rest)
