"""Run ``accuracy_loop`` in one variant of its flagship condition, without a
new flag on the tool (JAX's tool has none):

    PYTHONPATH=. python build/p24/accuracy_variants.py --variant base -- --preset flagship --bn_mode flax --output_dir D
    PYTHONPATH=. python build/p24/accuracy_variants.py --variant off -- ...
    PYTHONPATH=. python build/p24/accuracy_variants.py --variant perturb -- ...
    PYTHONPATH=. python build/p24/accuracy_variants.py --variant cudnn_det -- ...

The synthetic frames are the tool's own (cv2's bytes, as the JAX package
writes them) and the Trainer starts from JAX's initial weights for
``--seed`` (default 0).

- ``base``: the preset as it is (the run to reproduce);
- ``off``: the plain versions of K1-K8 on the card
  (``chip_smoke.plain_versions``; the port itself refuses
  ``IHPR_PALLAS=off`` on CUDA tensors): the fused head takes the no-plan
  route with the plain integral, as JAX's ``IHPR_PALLAS=off`` does, so
  neither K1/K2 nor K3/K4 runs;
- ``perturb``: every parameter of the Trainer's initial model times
  (1 + 1e-7 x a standard normal draw, ``numpy.random.RandomState(1)``), as
  ``tests/test_torch_trainer_steps.py:_perturbed`` does;
- ``cudnn_det``: ``torch.backends.cudnn.deterministic = True`` and
  ``benchmark = False``: cuDNN's deterministic algorithms.

The result file gains ``variant``."""

import argparse
import contextlib
import sys

import numpy as np
import torch

import chip_smoke
from ihpr_tpu_torch.engine import trainer as trainer_mod
from ihpr_tpu_torch.ops import conv_bn, integral_volume, matmul_bn
from ihpr_tpu_torch.ops import fused_head_integral as fhi
from ihpr_tpu_torch.tools import accuracy_loop

ap = argparse.ArgumentParser()
ap.add_argument("--variant", choices=["base", "off", "perturb", "cudnn_det"], required=True)
ap.add_argument("--seed", type=int, default=0)
ap.add_argument("rest", nargs=argparse.REMAINDER)
args = ap.parse_args()
rest = args.rest[1:] if args.rest[:1] == ["--"] else args.rest

PERTURB = 1e-7

if args.variant == "cudnn_det":
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

if args.variant == "perturb":
    init = trainer_mod.Trainer.__init__

    def perturbed_init(self, *a, **kw):
        init(self, *a, **kw)
        if self.start_epoch == 0 and self.resume_skip == 0:
            rng = np.random.RandomState(1)
            with torch.no_grad():
                for p in self.model.parameters():
                    x = p.detach().cpu().numpy()
                    p.copy_(torch.from_numpy((x * (1 + PERTURB * rng.standard_normal(x.shape))).astype(np.float32)))
            self.logger.info("initial parameters perturbed by %g relative", PERTURB)

    trainer_mod.Trainer.__init__ = perturbed_init

finish = accuracy_loop.finish


def patched_finish(tool, out_dir, result, ok, rows=()):
    result.update(variant=args.variant, cudnn_deterministic=bool(torch.backends.cudnn.deterministic))
    finish(tool, out_dir, result, ok, rows)


accuracy_loop.finish = patched_finish
sys.argv = [sys.argv[0]] + rest + ["--seed", str(args.seed)]
with (chip_smoke.plain_versions(fhi, integral_volume, matmul_bn, conv_bn) if args.variant == "off"
      else contextlib.nullcontext()):
    accuracy_loop.main(rest + ["--seed", str(args.seed)])
