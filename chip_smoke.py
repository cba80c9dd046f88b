"""Smoke run of the PyTorch/CUDA port (ihpr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the environment: torch, CUDA, nvcc, the card's name and power limit.
2. Builds every CUDA kernel (K1-K8 of the serving, training, fused-train,
   heatmap and eval paths, K5/K6-fp32 with K5/K6; K1/K2-fp32 of the fp32
   heads JAX fuses and the
   3xTF32 self-test's rate probe; P1/P2 of the probe tools; the JPEG colour
   kernel of the decode) and the nvJPEG codec from ihpr_tpu_torch/ops/csrc,
   one nvcc per source, all at once.
2b. JAX's initial weights on this host, which has no JAX (jax_init_phase,
   7p): the h36m3d_r50 Trainer at seed 0 holds four parameters within 4
   ulp of tests/data/jax_init_flagship.npz (JAX's own values); the draw's
   host time for h36m3d_r50 and h36m3d_r152_384.
3. K1 (fused head forward, bf16): holds it against its plain PyTorch
   version on the card, at the serving shapes and at edge cases (J=17,
   H*W=96*72, D=1, all-equal logits, a one-hot peak), and times both with
   CUDA events (median of repeated launches, in turns) at the
   serving dispatch (B=64) and at the train batch (B=128).
4. K2 (fused head backward, bf16): holds it against plain_bwd at a
   training shape, at J=17, H*W=96*72, D=1, all-equal logits and a soft
   peak (checked against float64 on the host), checks that two runs give
   bitwise-equal dfeat, dW and db, and times both at the train batch, with
   each of its four launches' device time (torch.profiler).
5. K3/K4 (integral over a logits volume, forward and backward): hold them
   against plain / plain_bwd in bf16 and fp32 at J=18/D=64, J=17, D=1,
   H*W=96*72, all-equal logits (the centre), a one-hot peak and a soft peak
   (against float64), on an fp32 volume past 2^31 bytes, and two runs
   bitwise equal; time both at (128, 4096, 1152) in bf16 and fp32.
5b. K1/K2's library composition (cuBLAS final conv + K3/K4), a yardstick,
   at K1's two batches and K2's.
5d. K1-fp32 / K2-fp32 (the fused head in 3xTF32, f32_kernel_phase) on the
   fp32 flagship head (64x64, C=256, J=18, D=64): the head through
   fused_final_conv_integral at B=8, counted (K1/K2-fp32 once each,
   nothing else), against plain / plain_bwd; the tensor cores' rates alone
   (mma.sync TF32 and bf16, wgmma TF32 n64 and n32 with A from registers);
   the split pre-pass bitwise split_planes; K1-fp32 at B = 64 and 128
   against plain (5e-4 voxel), its
   distance from plain in float64 at most twice the no-plan route's
   (cuBLAS fp32 + K3) on the same inputs, 500 repeated launches bitwise
   equal; K2-fp32 at B = 32 and 128 against plain_bwd (1e-4 of each
   largest), two runs bitwise equal; K1-fp32 at B = 32, 64, 128 and K2-fp32
   at 32 and 128 timed beside plain and the no-plan route (the library),
   in turns; K1-fp32's three and K2-fp32's four launches' device time
   (torch.profiler).
5c. K5/K6 (fused 1x1 conv + BN statistics) and K7/K8 (fused 3x3 conv + BN
   statistics), forward and backward: against plain / plain_bwd at every
   shape of the flagship fused step and of a fused_1x1-alone step (bf16)
   and at edge cases (fp32, M = 1, M = 40, K = N = 8, K = 2048 and 1000 with
   N <= 128, a 24x18 and a 5x3 plane; for K7/K8's tiles C = 200, N = 136,
   the flagship plane at B = 1 and a 3x5 plane), two runs bitwise equal;
   kernel, plain and library (cuBLAS / cuDNN in bf16 + sums) times, summed
   over each step's launches beside the step's bound; K5 and K6 at each
   shape with their bytes, share of the bound and sub-launches
   (torch.profiler), and their device time summed over each step; each
   sub-launch of one bf16 K7 and one K8 call beside its own bound. Then
   K5-fp32 / K6-fp32 (3xTF32 on wgmma) at every shape of a fp32 fused_1x1
   step of h36m3d_r50_fp32 (f32_breakdown.BN_STEP, batch 32) against plain, timed
   beside plain and cuBLAS fp32 (TF32 off) + sums, with their sub-launches,
   the 3xTF32 bound and the FMA peak's time, summed over the step's 16
   launches, two runs bitwise equal; K7/K8-fp32 (3xTF32 on wgmma) the same
   way at the conv3 route's fp32 shape (32, 8, 8, 256) x (9, 256, 256) (5
   launches a step of 7n) and at (32, 16, 16, 256), timed only, beside
   cuDNN fp32 + sums, with each wrapper's host enqueue.
6. Serves the flagship config h36m3d_r50 (ResNet-50, 256x256, 18 joints,
   64 depth bins, bf16, flip-test) at max_batch 32 with seeded random
   weights: predict_patches, predict (native warp) and predict_stream.
6b. Exports that server (ihpr_tpu_torch.engine.export): a fixed-batch
   and a batch-polymorphic artifact on cuda, each loaded and run by a
   process that has torch and numpy alone (the poly one at batch 1, 7 and
   32) and the fixed one by load_exported; every output against eager
   coords_plain + the flip remap on the card (1e-3 voxel), the distance
   from the live server's K1 coords, the artifact's MB, export and load
   seconds and ms per 32-patch flip-test dispatch beside the live server's.
7. Trains h36m3d_r50 at full width and depth (batch 128, lean BN in train
   mode) through the Trainer on synthetic H36M+MPII: a few warm-up steps,
   then a counted epoch of TRAIN_STEPS steps; the head gradients of one
   step against plain_bwd on the same saved inputs; the loss falling over
   10 steps on one repeated batch; device ms per step (CUDA events),
   host-clock img/s and the loader's host ms per batch.
7o. The JAX package's modes (modes_phase): K1/K2 bf16 at (128, 4096, 256)
   x (256, 1152) and K1/K2-fp32 at batch 32 under IHPR_EXP2, IHPR_BEXP and
   both, each against plain in the same mode (TOL_VOXEL, TOL_BWD), K2's
   own IHPR_BEXP move against plain's (TOL_BEXP), K1 500 repeats bitwise, times beside the natural base in turns; h36m3d_r50 at
   batch 128 on two resident batches under every BN mode (flax, lean16,
   lean_sub4, lean_sub8, lean_sg, lean_sgv, frozen), both remat policies
   and each exp mode (tools/bwd_experiments.measure: loss finite, ms a
   step, device busy, peak GiB); each remat policy's gradients and BN
   statistics against the plain step's from the same state (cuDNN's
   deterministic algorithms); a flip-test dispatch through PoseServer with
   the s2d stem against the 7x7 stem on embedded weights. K1 / K2 counted.
7a. The snapshot lifecycle of h36m3d_r50 (batch 128, synthetic H36M+MPII
   cut to 4 steps an epoch, cuDNN's deterministic algorithms): two epochs
   uninterrupted; the same run preempted by the RSS watchdog at itr 1
   (exit 75, a mid-epoch snapshot) and resumed with continue_train, its
   K1/K2 counted, ending bitwise equal to the uninterrupted run (weights,
   BN statistics, Adam moments and counts); the Tester and load_server from
   a snapshot, bitwise those of the live model; python -m
   ihpr_tpu_torch.test on the run in a subprocess; a torch.profiler window
   of the Trainer whose trace names K1's and K2's kernels; the snapshot's
   size and the save's blocking, background and load times (host clock).
7l. The fp32 heads JAX fuses, on their configs at full width and depth:
   h36m3d_r50_fp32 (ResNet-50, 256x256, fp32 "highest", flax BN, batch 32)
   on synthetic H36M+MPII: the first forward and backward on K1/K2-fp32
   and on the no-plan route from the same weights (loss 1e-4, gradient
   norm 1e-3 relative), then 3 counted Trainer steps (K1/K2-fp32 once a
   step), each route's device ms a step and peak memory; parity_r50
   (fp32, batch 1) served through PoseServer with flip-test, K1-fp32 once
   a dispatch, coords against flip-test coords_plain.
7m. h36m3d_r50_fp32 with lean BN and fused_1x1 (fp32_fused_phase; ResNet-50
   at 256x256, fp32 "highest", batch 32): the first forward and backward
   on the fused route (K5-fp32 / K6-fp32 16 each, K1/K2-fp32 one, K7/K8
   none) and on the unfused lean route from the same weights (loss 1e-4,
   gradient norm 1e-3 relative); 3 counted Trainer steps, one K5-fp32 and
   one K6-fp32 launch of them against plain on its saved inputs; device ms
   a step, peak memory and device-busy time, fused_1x1 against unfused, in
   turns, medians of three rounds.
7n. h36m3d_r50_fp32 with lean BN and both fused flags at a 128x128 frame
   (fp32_conv3_phase; ResNet-50 at full width, fp32 "highest", batch 32,
   32x32x64 heatmaps), the one full-width fp32 step on which JAX's conv3
   route takes blocks: the first forward and backward on the fused route
   (K5-fp32 / K6-fp32 16 each, K7-fp32 / K8-fp32 5 each, K1/K2-fp32 one)
   and on the unfused lean route from the same weights (7m's bars); 3
   counted Trainer steps, one K7-fp32 and one K8-fp32 launch of them
   against plain on its saved inputs; device ms a step, device-busy ms
   and peak memory with both flags, fused_1x1 alone and unfused, in turns,
   medians of three rounds.
7c. h36m3d_r152_384 (ResNet-152, 384x288 input, 96x72x64 heatmaps, bf16)
   at full depth and width on seeded weights: serves 40 patches at
   max_batch 32 with flip-test (K1 at H*W = 6912, W = 72, the padded
   dispatch against the plain head), trains 3 counted steps at batch 32
   through the Trainer (K2 against plain_bwd on one step's head inputs),
   device ms per dispatch and per step and peak memory; K1 at (64, 6912,
   256) and K2 at (32, 6912, 256) timed beside plain, the library
   composition and the bound.
7b. Trains h36m3d_r50 with fused_1x1 and fused_conv3 through the Trainer
   (batch 128): K5/K6 16 and K7/K8 5 launches per step, K1/K2 one; one
   launch of each of K5-K8 in those steps against plain on its saved
   inputs; a fused_1x1-alone step (K5/K6 26 each); device ms per step and
   peak memory with both flags, fused_1x1 alone and unfused (the H100 A/B,
   in turns, medians of three rounds), and each one's device-busy time and
   K5-K8 share (torch.profiler); the loss falling over 10 steps on one
   repeated batch.
7d. Data parallelism of h36m3d_r50_dp (ResNet-50, 256x256, bf16, batch 32
   a rank): (a) the train CLI under torchrun with --multihost, one rank on
   NCCL, in a subprocess: exit 0, a snapshot, its logged losses those of a
   1-process Trainer; (b) two ranks on the one card over gloo
   (parallel.launch.spawn) from seeded, peaked weights: the first step
   against one process on the 64-image batch (loss 1e-3 relative, gradient
   norm within twice bf16's distance from the fp32 step; the same step in
   fp32 "highest" at 1e-4 / 1e-3), parameters and BN buffers bitwise equal
   across the ranks after 3 steps, K1/K2 counted per rank, K1/K2 against
   plain on one step's head inputs, device ms per step, the collectives'
   share and host<->device copies (torch.profiler) and peak memory (two
   ranks on one card: not a scaling number); one step with both fused flags, K5/K6 26 and K7/K8 0 per
   rank (world 2 never takes the conv3 route), one K5 and K6 launch against
   plain, beside one process's counts on the global batch; (c) the 2-rank
   Tester on 128 samples: gathered predictions against one process's, the
   same metrics on both ranks, rank 0 alone writing. The ranks' K1, K2, K5
   and K6 launches join the kernels line.
7e. Data-parallel serving of h36m3d_r50 (max_batch 32, flip-test, seeded
   peaked weights): two ranks on the one card over gloo (launch.spawn), each
   serving 40 patches (2 dispatches) and one 5-person predict through
   PoseServer(dp=, partition="data"); K1 counted per rank (one a dispatch,
   on the rank's 16 rows), the gathered coords equal on the ranks and
   against one process's server (bitwise, or within 1e-3 voxel, stated);
   ms a dispatch a rank (CUDA events) and the gather's share.
7f. The device warp (the canvas path), selected explicitly while the
   native warp is available (asserted): one 128-batch (no aug) through
   make_patch_batch against the host-warp batch (joints 1e-2 voxel, pixels
   p99 < 0.05, PARITY.md), its ms beside the native warp's; 5 counted
   Trainer steps on canvas batches with aug (K1/K2 5/5); the Tester on 300
   samples on canvas batches (K1 3) beside the host path's metrics;
   PoseServer.predict through the device warp against the native warp's
   patches.
7g. python -m ihpr_tpu_torch.tools.serving_bench in a subprocess: exit 0,
   its phases and JSON line echoed.
7h. The real-data path (real_data_phase): nvJPEG (ihpr_tpu_torch/ops/csrc/
   nvjpeg_codec.cu, built with the kernels) decodes the fixture's JPEGs to
   planes, each plane held against libjpeg's (tests/data/real_root/
   ycbcr.npz), and the colour kernel (ops/csrc/jpeg_color.cu: libjpeg's
   upsampling and colour conversion) against its plain version bitwise and
   against libjpeg's pixels, beside nvJPEG's own RGBI decode; the loader's
   batch of that root against the JAX loader's committed patches; a
   dataset root in the reference's layouts (H36M 1000x1000, MPII 1280x720)
   encoded on the card, with encode, decode (with the colour kernel and
   with RGBI) and loader times, the colour kernel against its plain
   version on every frame of a 128-frame batch and on one MPII frame, both
   timed on that batch and on one frame, and the host's ms a batch in the
   planes decode's header parse, layout and kernel call; the train CLI on
   it with --pretrained (a seeded torchvision ResNet-50 .pth), K1/K2 and
   the colour kernel counted in the subprocess; the test CLI on its test
   split with --vis (K1 and the colour kernel counted, the colour kernel
   once a batch and once an overlay's frame; the 8 overlays
   vis/pred_{i}.jpg exist and decode to the frame's size), its
   coordinates (nvJPEG) against the same JPEGs decoded by libjpeg through
   the same snapshot, and both beside the frames rendered without JPEG.
7j. The accuracy harness (accuracy_phase): python -m
   ihpr_tpu_torch.tools.accuracy_loop --preset tiny through its main, cut
   to 512 / 64 frames and 5 epochs, with its CPU oracle (gap within 1 mm);
   K1/K2-fp32 (its fp32 head has a fused plan: J = 18, D = 32) and the
   colour kernel counted over the run; img/s and the
   loader's share of the train loop printed; then the colour kernel
   against its plain version on 64 of the tool's JPEGs. The kernels line's
   max_abs_err for the colour kernel is the largest of 7h's and 7j's
   comparisons.
7i. Spatial partitioning of h36m3d_r50 at full width and depth, cut to
   batch 32 a data index, on ranks that time-share the one card over gloo
   (spatial_phase): S = 2, D = 1, (a) the flip-test eval step against one
   process (fp32 "highest" 2e-3 voxel; bf16 within twice one process's
   bf16 distance from fp32), K3/K4 against plain on a rank's rows'
   logits, (b) 3 Trainer steps (the first loss against a 1-process
   Trainer's, K3 and K4 once a step a rank, K1/K2 never, ms a step, the
   halo exchanges' host share and bytes, peak memory), (c)
   PoseServer(partition="spatial") on 40 patches against one process's
   server, (e) that server exported on each rank, bitwise the one-process
   server's artifact, both run by a torch-only process to equal coords;
   (s) the s2d stem (the 7x7 stem embedded) in fp32 "highest": the
   flip-test eval step against one process's s2d dispatch (2e-3 voxel) and
   one train step from (b)'s state against one process's (1e-5 relative,
   as 7k's), K3 and K4 counted;
   D = 2 x S = 2 on four ranks, (d) one step in bf16 and fp32 against one
   process. The ranks' K3/K4 launches join the kernels line.
7k. Spatial partitioning on uneven row shards (spatial_uneven_phase),
   h36m3d_r50 in fp32 "highest" at batch 32: (f) S = 3 on three ranks at
   256x256 (3/3/2 rows at stride 32): the flip-test eval step against one
   process (2e-3 voxel), one train step's loss (1e-5 relative), K3 once a
   rank in eval, K3 and K4 once a rank a step, K3/K4 against plain on each
   rank's rows, the halo exchanges' share of a step's host time; (g) a
   1 x 4 grid at 64x64 in eval mode, where ranks 2 and 3 own no stride-32
   row, against one process. Phase 5's K3/K4 checks also hold that a
   0-row shard launches neither kernel.
8. The heatmap-logits path: h36m3d_r50 at batch 128 takes an optimizer
   step through model(x) -> soft_argmax_from_heatmap -> loss (K3 forward,
   K4 backward), coords and dv against plain on the same logits, device ms
   per step; again with fp32_logits at batch 32.
9. The fused op on fp32 heads with no fused plan (C=72, D=80, and the
   D=1 head of mpii2d_r50): fp32 logits and K3/K4, forward and backward,
   against the plain fused op; K1/K2 and K1/K2-fp32 do not launch.
10. Evaluates h36m3d_r50 through the Tester (300 synthetic H36M test
    samples, batch 128, the last batch padded, flip-test): MPJPE and the
    result files; one batch's coords against plain; host-clock img/s and
    the loader's ms per batch. Then mpii2d_r50 (D=1, PCKh, an fp32 head:
    logits + K3) on 64 samples.
11. P1, the exp-pass probe (ihpr_tpu_torch.tools.exp_probe): its main
    times all six modes on the (128, 4096, 1152) fp32 volume and checks the
    read floor (0.721 ms at 3.35 TB/s); every mode's partials and token
    against plain (read bitwise, bexpsum 1e-2, the others 1e-5 relative),
    two runs bitwise equal; plain expsum and torch.sum over the blocks.
12. P2, the tiled matmul probe (ihpr_tpu_torch.tools.mxu_int8_probe): its
    main times cuBLAS bf16 / torch._int_mm, every tile of the kernel in bf16
    and int8 at 4096^3 and the conv9 / cuDNN pair; every tile against
    plain_mm at 4096^3 (int8 bitwise, bf16 1e-4 of max|plain|), its rate,
    share of the bound and ratio to the library; the int8 transpose's share
    of one call (torch.profiler).

In 6-12 (7a: its resumed training, the snapshot Tester and server; 7c:
its serving and its training, each counted on its own; 7d: each rank's
steps, fused step and Tester, counted in the rank; 7e: each rank's serving;
7f: the train steps, the Tester and the server, each on its own; 7h: the
train and test CLIs, counted in their subprocesses, and the Tester; 7j:
the accuracy tool's whole run; 5d: the fused op's forward and backward;
7l: each route's forward and backward, the Trainer's steps, the server; 7m:
each route's forward and backward, the Trainer's steps; 7i:
each rank's eval steps, Trainer steps, server, s2d eval and train step
and grid step, counted in the rank; 7k: each rank's eval step and train step, counted in the rank) the
kernels' launch counters are set to 0 just before the path
runs and read just after (in 11-12 the path is the tool's main); each kernel of the path must have launched as
often as the path dispatched it, and the others not at all. Outputs are
checked for shape and finiteness and against the plain versions.

Prints one JSON line of kernel results, the card's name and power limit,
and last {"ok": true, "device": {...}}. Any failure raises and exits
non-zero; so does a host without CUDA.

    python3 chip_smoke.py --only bn fused

builds the kernels and runs only the named phases (bn: 5c; fused: 7b; dp:
7d; dp-serve: 7e; device-warp: 7f; serving-bench: 7g; real-data: 7h;
spatial: 7i; spatial-uneven: 7k; accuracy: 7j; fp32-kernels: 5d;
fp32-train and parity-serve: 7l; fp32-fused: 7m; fp32-conv3: 7n; no-plan: 9; modes: 7o;
jax-init: 2b), for timing one tree's K5-K8 against another's (copy this file into a
checkout of the other tree and run it there) or trying one phase. It
prints no JSON lines.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import glob
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

TOL_VOXEL = 5e-4  # kernel vs plain coords: same operands, fp32 accumulation
# Backward kernels vs plain_bwd, relative to each result's largest
# magnitude: bf16 rounds dv before the contractions and every result once
# (2^-8), after fp32 sums taken in another order; fp32 (K4, K6, K8) differs
# only in sum order and, in K4, ex2.approx.
TOL_BWD = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# The no-plan route's fp32 gradients against autograd through the plain
# fused op: dW and db sum dv over 8 x 4096 rows and cancel to near 0, so
# the sum order alone moves them by ~6e-5 of their largest (two fp32
# orders on a CPU).
TOL_NOPLAN_GRAD = 3e-4
MAX_BATCH = 32
TRAIN_BATCH = 128  # h36m3d_r50's batch_size_per_device
TRAIN_STEPS = 5  # counted steps of the train phase
R152_BATCH = 32  # h36m3d_r152_384's batch_size_per_device
EVAL_SAMPLES = 300  # not a multiple of the eval batch (128): the last is padded
K1_REPEATS = 500  # launches of K1 on one input, held to be bitwise equal
SEED = 0


def _gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _cuda_ms(fn, n: int, reps: int = 5) -> float:
    """Device time of one call of fn, in ms: CUDA events around n calls
    back to back, median over reps."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def _head_inputs(b, hw, c, jd, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    feat = torch.randn(b, hw, c, generator=g) * 0.5
    kernel = torch.randn(c, jd, generator=g) * (10.0 / c**0.5)  # logits std ~5
    bias = torch.randn(jd, generator=g) * 0.1
    return tuple(t.to("cuda", dtype) for t in (feat, kernel, bias))


def check_kernel(fhi, feat, kernel, bias, j, d, w, expect=None, exp2=False):
    """Kernel vs plain on the card (both in IHPR_EXP2's base 2 with
    ``exp2``); returns max |coords diff| in voxels."""
    got = fhi.kernel_stats(feat, kernel, bias, j, d, w, exp2)
    want = fhi.plain(feat, kernel, bias, j, d, w, exp2)
    torch.cuda.synchronize()
    err = float((got[0] - want[0]).abs().max())
    if not (err <= TOL_VOXEL and torch.isfinite(got[0]).all()):
        finite = {k: bool(torch.isfinite(v).all()) for k, v in (("K1", got[0]), ("plain", want[0]))}
        raise AssertionError(f"coords differ from plain by {err} voxel (> {TOL_VOXEL}); all finite: {finite}")
    torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(got[2], want[2], atol=0, rtol=1e-4)
    if expect is not None:
        e = float((got[0] - expect).abs().max())
        if e > 1e-3:
            raise AssertionError(f"coords {e} voxel from the analytic answer")
    return err


def repeat_check(fhi, args, j, d, w, n, exp2=False):
    """Launch K1 n times on the same inputs, each after a bf16 matmul that
    leaves other data in shared memory, and count the launches whose
    coords, m or s differ bitwise from the first's (NaN counts as
    different). K1 is deterministic, so any count above 0 is a race."""
    want = fhi.kernel_stats(*args, j, d, w, exp2)
    x = torch.randn(2048, 2048, device="cuda", dtype=torch.bfloat16)
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    for _ in range(n):
        x @ x
        got = fhi.kernel_stats(*args, j, d, w, exp2)
        bad += torch.stack([(a != b).any() for a, b in zip(got, want)]).any()
    return int(bad)


def kernel_phase(fhi, gpu: str):
    """K1 vs plain at the serving shapes and edge cases; kernel and plain
    times at the flagship dispatch (2 x 32 flip-test samples, 64x64
    heatmap, C=256) and at the train batch (128), bf16, with TFLOP/s and
    the share of the bound; K1 repeated at both batches, bitwise. Returns
    the largest |coords diff| and, per batch, (kernel ms, plain ms)."""
    b, hw, w, c, d = 2 * MAX_BATCH, 64 * 64, 64, 256, 64
    errs = []
    timing = {}
    for bsz in (b, TRAIN_BATCH):
        args = _head_inputs(bsz, hw, c, 18 * d, torch.bfloat16, SEED)
        errs.append(check_kernel(fhi, *args, 18, d, w))
        differ = repeat_check(fhi, args, 18, d, w, K1_REPEATS)
        print(f"K1 ({bsz}, {hw}, {c}) repeated: {differ} of {K1_REPEATS} launches differ bitwise from the first")
        if differ:
            raise AssertionError(f"K1 at batch {bsz}: {differ} of {K1_REPEATS} repeated launches differ bitwise")
        runs = {"plain": (lambda: fhi.plain(*args, 18, d, w), []),
                "kernel": (lambda: fhi.kernel_stats(*args, 18, d, w), [])}
        for name in ("plain", "kernel", "kernel", "plain") * 2:  # in turns
            fn, out = runs[name]
            out.append(_cuda_ms(fn, 10 if name == "kernel" else 3, reps=3))
        plain_ms, kernel_ms = runs["plain"][1], runs["kernel"][1]
        timing[bsz] = (statistics.median(kernel_ms), statistics.median(plain_ms))
        flops = 2 * bsz * hw * c * 18 * d
        bound = k1_bound(bsz)[0]
        print(
            f"K1 bf16 ({bsz}, {hw}, {c}) x ({c}, {18 * d}): kernel {timing[bsz][0]:.4f} ms "
            f"({flops / timing[bsz][0] / 1e9:.1f} TFLOP/s; bound {bound:.4f} ms, "
            f"{bound / timing[bsz][0]:.3f} of it), plain {timing[bsz][1]:.4f} ms, "
            f"max|dcoords| {errs[-1]:.3g} voxel  [{gpu}]"
        )
        del args, runs
    torch.cuda.empty_cache()
    errs.append(check_kernel(fhi, *_head_inputs(b, hw, c, 17 * d, torch.bfloat16, 1), 17, d, w))
    print(f"K1 J=17 (COCO skeleton): max|dcoords| {errs[-1]:.3g} voxel")
    errs.append(check_kernel(fhi, *_head_inputs(b, 96 * 72, c, 18 * d, torch.bfloat16, 2), 18, d, 72))
    print(f"K1 H*W = 96*72: max|dcoords| {errs[-1]:.3g} voxel")
    errs.append(check_kernel(fhi, *_head_inputs(b, hw, c, 16, torch.bfloat16, 4), 16, 1, w))
    print(f"K1 D=1, J=16 (a 2D config's head in bf16): max|dcoords| {errs[-1]:.3g} voxel")
    # All-equal logits: every coordinate is the volume centre.
    feat, kernel, bias = (torch.zeros_like(t) for t in _head_inputs(4, hw, c, 18 * d, torch.bfloat16, 3))
    centre = torch.tensor([(w - 1) / 2, (hw // w - 1) / 2, (d - 1) / 2], device="cuda")
    errs.append(check_kernel(fhi, feat, kernel, bias, 18, d, w, expect=centre.expand(4, 18, 3)))
    print(f"K1 all-equal logits -> centre: max|dcoords| {errs[-1]:.3g} voxel")
    # One-hot peak: logit 100 at (row r0, bin z0) of joint 5, 0 elsewhere.
    r0, z0, j0 = 1234, 17, 5
    feat[:, r0, 0] = 1.0
    kernel[0, j0 * d + z0] = 100.0
    expect = centre.expand(4, 18, 3).clone()
    expect[:, j0] = torch.tensor([r0 % w, r0 // w, z0], dtype=torch.float32, device="cuda")
    errs.append(check_kernel(fhi, feat, kernel, bias, 18, d, w, expect=expect))
    print(f"K1 one-hot peak -> its voxel: max|dcoords| {errs[-1]:.3g} voxel")
    return max(errs), timing


def _bwd_inputs(fhi, b, hw, c, j, d, w, dtype, seed):
    """Head inputs, K1's m and s, coords and a random cotangent g."""
    feat, kernel, bias = _head_inputs(b, hw, c, j * d, dtype, seed)
    coords, m, s = fhi.kernel_stats(feat, kernel, bias, j, d, w)
    g = torch.randn(b, j, 3, generator=torch.Generator().manual_seed(seed)).cuda()
    return feat, kernel, bias, m, s, coords, g


def check_bwd(fhi, args, j, d, w, tol, label, want=None, modes=(False, False)):
    """K2 vs plain_bwd (or ``want``) on the card, both in the exp ``modes``
    (exp2, bexp), each result relative to its largest magnitude; db may
    also differ by 1e-4 of its summands' bound, sum_b |gx| (w-1) + |gy|
    (h-1) + |gz| (d-1), since it can cancel to ~0. Returns the largest
    absolute difference."""
    got = fhi.kernel_bwd(*args, j, d, w, *modes)
    want = fhi.plain_bwd(*args, j, d, w, *modes) if want is None else want
    torch.cuda.synchronize()
    g, h = args[-1], args[0].shape[1] // w
    ext = torch.tensor([w - 1, h - 1, d - 1], dtype=torch.float32, device=g.device)
    db_atol = 1e-4 * float((g.abs() * ext).sum(-1).sum(0).max())
    worst, rel = 0.0, []
    for name, a, b in zip(("dfeat", "dW", "db"), got, want):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"K2 {label} {name}: {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
        err = float((a.float() - b.float()).abs().max())
        scale = float(b.float().abs().max())
        if err > tol * scale + (db_atol if name == "db" else 0.0):
            raise AssertionError(f"K2 {label} {name}: max|diff| {err} > {tol} x max|plain| {scale}")
        worst = max(worst, err)
        rel.append(f"{name} {err / scale if scale else 0.0:.2e}")
    print(f"K2 {label}: |diff|/max|plain| " + ", ".join(rel))
    return worst, got


def _soft_peak_check(fhi):
    """A logit of 5 over a flat floor at one voxel (p spread over the whole
    volume, dv nonzero everywhere): dW's column for that voxel against
    float64 on the host from the same bf16-rounded inputs, within 2e-2 of
    its largest."""
    b, h, w, c, j, d = 2, 64, 64, 256, 18, 64
    dtype = torch.bfloat16
    r0, z0, j0 = 1234, 17, 5
    gen = torch.Generator().manual_seed(9)
    feat = (torch.randn(b, h * w, c, generator=gen) * 0.05).to(dtype)
    kernel = (torch.randn(c, j * d, generator=gen) * 0.05).to(dtype)
    feat[:, r0, 0] = 1.0
    kernel[0, j0 * d + z0] = 5.0
    g = torch.randn(b, j, 3, generator=gen)
    f64 = feat.double()
    v = (f64 @ kernel.double())[:, :, j0 * d : (j0 + 1) * d]  # joint j0 only: (B, HW, D)
    p = torch.softmax(v.reshape(b, -1), -1).view(b, h * w, d)
    rows = torch.arange(h * w)
    x, y, z = (rows % w).double(), (rows // w).double(), torch.arange(d).double()
    cx, cy, cz = ((p.sum(-1) * x).sum(-1), (p.sum(-1) * y).sum(-1), (p.sum(1) * z).sum(-1))
    gj = g[:, j0].double()
    dv = p[:, :, z0] * (gj[:, 0, None] * (x - cx[:, None]) + gj[:, 1, None] * (y - cy[:, None])
                        + gj[:, 2, None] * (z0 - cz[:, None]))  # (B, HW)
    ref = (f64 * dv[..., None]).sum(dim=(0, 1))  # (C,)
    feat_c, kernel_c = feat.cuda(), kernel.cuda()
    bias_c = torch.zeros(j * d, dtype=dtype, device="cuda")
    coords, m, s = fhi.kernel_stats(feat_c, kernel_c, bias_c, j, d, w)
    _, dw, _ = fhi.kernel_bwd(feat_c, kernel_c, bias_c, m, s, coords, g.cuda(), j, d, w)
    col = dw[:, j0 * d + z0].double().cpu()
    err, scale = float((col - ref).abs().max()), float(ref.abs().max())
    if not (scale > 1e-3 and err <= 2e-2 * scale):
        raise AssertionError(f"K2 soft peak: dW column {err} from float64 (max {scale})")
    print(f"K2 soft peak (logit 5 over a flat floor), bf16: dW column vs float64 |diff|/max {err / scale:.2e}")
    return err


def k2_phase(fhi, gpu: str):
    """K2 vs plain_bwd at a training shape (B=16, 64x64, C=256, J=18, D=64)
    and edge cases; bitwise determinism of dfeat, dW and db; kernel and
    plain_bwd times at B=128 with TFLOP/s and the share of the bound."""
    hw, w, c, d = 64 * 64, 64, 256, 64
    bf16 = TOL_BWD[torch.bfloat16]
    args = _bwd_inputs(fhi, 16, hw, c, 18, d, w, torch.bfloat16, SEED)
    err, got = check_bwd(fhi, args, 18, d, w, bf16, "train shape bf16")
    errs = [err]
    again = fhi.kernel_bwd(*args, 18, d, w)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("K2 is not deterministic: two runs differ")
    print("K2 two runs on the same inputs: dfeat, dW, db bitwise equal")
    errs.append(check_bwd(fhi, _bwd_inputs(fhi, 16, hw, c, 17, d, w, torch.bfloat16, 1), 17, d, w,
                          bf16, "J=17 (COCO skeleton)")[0])
    errs.append(check_bwd(fhi, _bwd_inputs(fhi, 16, 96 * 72, c, 18, d, 72, torch.bfloat16, 2),
                          18, d, 72, bf16, "H*W = 96*72")[0])
    errs.append(check_bwd(fhi, _bwd_inputs(fhi, 16, hw, c, 16, 1, w, torch.bfloat16, 5), 16, 1, w,
                          bf16, "D=1, J=16 (a 2D config's head in bf16)")[0])
    feat, kernel, bias, m, s, coords, g = _bwd_inputs(fhi, 4, hw, c, 18, d, w, torch.bfloat16, 3)
    feat, kernel, bias = (torch.zeros_like(t) for t in (feat, kernel, bias))
    coords, m, s = fhi.kernel_stats(feat, kernel, bias, 18, d, w)
    errs.append(check_bwd(fhi, (feat, kernel, bias, m, s, coords, g), 18, d, w, bf16,
                          "all-equal logits (db only: feat = W = 0)",
                          want=(torch.zeros_like(feat), torch.zeros_like(kernel),
                                fhi.plain_bwd(feat, kernel, bias, m, s, coords, g, 18, d, w)[2]))[0])
    errs.append(_soft_peak_check(fhi))

    args = _bwd_inputs(fhi, TRAIN_BATCH, hw, c, 18, d, w, torch.bfloat16, 4)
    runs = {"plain": (lambda: fhi.plain_bwd(*args, 18, d, w), []),
            "kernel": (lambda: fhi.kernel_bwd(*args, 18, d, w), [])}
    for name in ("plain", "kernel", "kernel", "plain"):  # in turns
        fn, out = runs[name]
        out.append(_cuda_ms(fn, 5 if name == "kernel" else 1, reps=3))
    kernel_ms, plain_ms = statistics.median(runs["kernel"][1]), statistics.median(runs["plain"][1])
    flops = 4 * 2 * TRAIN_BATCH * hw * c * 18 * d
    bound = k2_bound(TRAIN_BATCH)[0]
    print(f"K2 bf16 ({TRAIN_BATCH}, {hw}, {c}) x ({c}, {18 * d}): kernel {kernel_ms:.4f} ms "
          f"({flops / kernel_ms / 1e9:.1f} TFLOP/s over its 4 products; bound {bound:.4f} ms, "
          f"{bound / kernel_ms:.3f} of it), plain_bwd {plain_ms:.4f} ms  [{gpu}]")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fhi.kernel_bwd(*args, 18, d, w)
        torch.cuda.synchronize()
    names = ("transpose_kernel", "dfeat_kernel", "dw_kernel", "reduce_kernel")  # one call's launches
    parts = [f"{k} {e.self_device_time_total / e.count / 1e3:.4f} ms"
             for e in prof.key_averages() for k in names if k in e.key]
    print(f"K2's launches per call (torch.profiler, 3 calls): {', '.join(parts) or 'not measured'}  [{gpu}]")
    del args, runs
    torch.cuda.empty_cache()
    return max(errs), (kernel_ms, plain_ms)


def _volume(b, hw, jd, dtype, seed, std=5.0):
    """Logits of std ~5: peaked heatmaps, coordinates away from the centre."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, hw, jd, generator=g) * std).to("cuda", dtype)


def check_volume(iv, vol, j, d, w, label, expect=None):
    """K3 vs plain (coords within TOL_VOXEL, m exact, s to 1e-4) and K4 vs
    plain_bwd (dv within TOL_BWD of its largest magnitude) on the card.
    Returns the largest |coords diff| and |dv diff|."""
    coords, m, s = iv.kernel_stats(vol, j, d, w)
    want = iv.plain(vol, j, d, w)
    g = torch.randn(vol.shape[0], j, 3, generator=torch.Generator().manual_seed(7)).cuda()
    dv = iv.kernel_bwd(vol, m, s, coords, g, j, d, w)
    dv_ref = iv.plain_bwd(vol, m, s, coords, g, j, d, w)
    torch.cuda.synchronize()
    err = float((coords - want[0]).abs().max())
    if not (err <= TOL_VOXEL and torch.isfinite(coords).all()):
        raise AssertionError(f"K3 {label}: coords differ from plain by {err} voxel (> {TOL_VOXEL})")
    torch.testing.assert_close(m, want[1], atol=0, rtol=0)
    torch.testing.assert_close(s, want[2], atol=0, rtol=1e-4)
    if expect is not None and float((coords - expect).abs().max()) > 1e-3:
        raise AssertionError(f"K3 {label}: coords {float((coords - expect).abs().max())} from the answer")
    dv_err = float((dv.float() - dv_ref.float()).abs().max())
    scale = float(dv_ref.float().abs().max())
    if dv.dtype != vol.dtype or not (scale > 0 and dv_err <= TOL_BWD[vol.dtype] * scale):
        raise AssertionError(f"K4 {label}: {dv.dtype} dv {dv_err} from plain_bwd (max {scale})")
    print(f"K3/K4 {label}: max|dcoords| {err:.3g} voxel, max|ddv|/max|dv| {dv_err / scale:.2e}")
    return err, dv_err


def _volume_soft_peak(iv, dtype):
    """A logit of 5 over a flat floor at one voxel of joint 5: its coords
    and dv against float64 on the host."""
    b, h, w, j, d = 2, 64, 64, 18, 64
    r0, z0, j0 = 1234, 17, 5
    vol = torch.zeros(b, h * w, j * d, device="cuda", dtype=dtype)
    vol[:, r0, j0 * d + z0] = 5.0
    g = torch.randn(b, j, 3, generator=torch.Generator().manual_seed(8)).cuda()
    coords, m, s = iv.kernel_stats(vol, j, d, w)
    dv = iv.kernel_bwd(vol, m, s, coords, g, j, d, w)
    p = torch.softmax(vol.double().cpu().view(b, h * w, j, d)[:, :, j0].reshape(b, -1), -1).view(b, h * w, d)
    rows = torch.arange(h * w)
    x, y, z = (rows % w).double(), (rows // w).double(), torch.arange(d).double()
    c64 = torch.stack([(p.sum(-1) * x).sum(-1), (p.sum(-1) * y).sum(-1), (p.sum(1) * z).sum(-1)], -1)
    gj = g[:, j0].double().cpu()
    dv64 = p * (gj[:, 0, None, None] * (x[:, None] - c64[:, 0, None, None])
                + gj[:, 1, None, None] * (y[:, None] - c64[:, 1, None, None])
                + gj[:, 2, None, None] * (z - c64[:, 2, None, None]))
    err = float((coords[:, j0].double().cpu() - c64).abs().max())
    dv_err = float((dv.double().cpu().view(b, h * w, j, d)[:, :, j0] - dv64).abs().max())
    scale = float(dv64.abs().max())
    # fp32 coords sum p * x over 262,144 near-equal p: 1e-3 voxel from
    # float64 (plain lands 9e-4 from it on a CPU), which enters dv through
    # x - cx: fp32 dv within 5e-4 of its largest (plain: 1.0e-4).
    dv_tol = {torch.bfloat16: TOL_BWD[torch.bfloat16], torch.float32: 5e-4}[dtype]
    if not (err <= 1e-3 and dv_err <= dv_tol * scale):
        raise AssertionError(f"K3/K4 soft peak {dtype}: coords {err}, dv {dv_err} (max {scale}) from float64")
    print(f"K3/K4 soft peak (logit 5 over a flat floor), {str(dtype)[6:]}: coords vs float64 "
          f"{err:.3g} voxel, dv |diff|/max {dv_err / scale:.2e}")
    return err


def volume_phase(iv, gpu: str):
    """K3/K4 vs plain at the heatmap path's shapes and edge cases, bitwise
    determinism, the fp32 flagship volume (2.42 GB, past 2^31 bytes), and
    both timed at (128, 4096, 1152) in bf16 and fp32."""
    hw, w, d = 64 * 64, 64, 64
    errs, dv_errs = [], []

    def add(res):
        errs.append(res[0])
        dv_errs.append(res[1])

    for dtype in (torch.bfloat16, torch.float32):
        add(check_volume(iv, _volume(16, hw, 18 * d, dtype, SEED), 18, d, w, f"J=18 D=64 {str(dtype)[6:]}"))
    add(check_volume(iv, _volume(16, hw, 17 * d, torch.bfloat16, 1), 17, d, w, "J=17 (COCO skeleton)"))
    add(check_volume(iv, _volume(16, hw, 16, torch.bfloat16, 2), 16, 1, w, "D=1, J=16 (2D configs)"))
    add(check_volume(iv, _volume(16, hw, 17, torch.float32, 2), 17, 1, w, "D=1, J=17 fp32 (one-lane loads)"))
    add(check_volume(iv, _volume(16, 96 * 72, 18 * d, torch.bfloat16, 3), 18, d, 72, "H*W = 96*72"))
    centre = torch.tensor([(w - 1) / 2, (hw // w - 1) / 2, (d - 1) / 2], device="cuda").expand(4, 18, 3)
    flat = torch.zeros(4, hw, 18 * d, device="cuda", dtype=torch.bfloat16)
    add(check_volume(iv, flat, 18, d, w, "all-equal logits -> centre", expect=centre))
    r0, z0, j0 = 1234, 17, 5
    flat[:, r0, j0 * d + z0] = 100.0
    expect = centre.clone()
    expect[:, j0] = torch.tensor([r0 % w, r0 // w, z0], dtype=torch.float32, device="cuda")
    add(check_volume(iv, flat, 18, d, w, "one-hot peak -> its voxel", expect=expect))
    for dtype in (torch.bfloat16, torch.float32):
        errs.append(_volume_soft_peak(iv, dtype))
    vol = _volume(16, hw, 18 * d, torch.bfloat16, 4)
    first, again = iv.kernel_stats(vol, 18, d, w), iv.kernel_stats(vol, 18, d, w)
    g = torch.randn(16, 18, 3, generator=torch.Generator().manual_seed(9)).cuda()
    args = (vol, first[1], first[2], first[0], g, 18, d, w)
    if not (all(torch.equal(a, b) for a, b in zip(first, again))
            and torch.equal(iv.kernel_bwd(*args), iv.kernel_bwd(*args))):
        raise AssertionError("K3/K4 are not deterministic: two runs differ")
    print("K3/K4 two runs on the same inputs: coords, m, s and dv bitwise equal")
    # A spatial rank's empty shard (spatial-uneven (g)): no rows, no launch
    # (a grid of no blocks is a launch error); m -inf and s 0, which the
    # merge adds as 0; dv empty.
    n3, n4 = iv.launches, iv.bwd_launches
    empty = torch.empty(4, 0, 18 * d, device="cuda", dtype=torch.bfloat16)
    c0, m0, s0 = iv.kernel_stats(empty, 18, d, w)
    dv0 = iv.kernel_bwd(empty, m0, s0, c0, torch.zeros_like(c0), 18, d, w)
    torch.cuda.synchronize()
    if ((iv.launches, iv.bwd_launches) != (n3, n4) or not bool((m0 == float("-inf")).all())
            or not bool((s0 == 0).all()) or not bool((c0 == 0).all()) or dv0.shape != empty.shape):
        raise AssertionError(f"K3/K4 on a 0-row shard: launches {iv.launches - n3} / {iv.bwd_launches - n4}, "
                             f"m {m0.unique()}, s {s0.unique()}, dv {tuple(dv0.shape)}")
    print("K3/K4 on a 0-row shard (4, 0, 1152): no launch; coords 0, m -inf, s 0, dv empty")

    timing = {}
    for dtype in (torch.bfloat16, torch.float32):
        vol = _volume(TRAIN_BATCH, hw, 18 * d, dtype, 10)
        size = vol.numel() * vol.element_size()
        if dtype == torch.float32:
            if size <= 2**31:
                raise AssertionError(f"the fp32 flagship volume is {size} bytes")
            add(check_volume(iv, vol, 18, d, w, f"fp32 flagship volume, {size} bytes (> 2^31)"))
        coords, m, s = iv.kernel_stats(vol, 18, d, w)
        g = torch.randn(TRAIN_BATCH, 18, 3, generator=torch.Generator().manual_seed(11)).cuda()
        bwd = (vol, m, s, coords, g, 18, d, w)
        runs = {"k3": (lambda: iv.kernel_stats(vol, 18, d, w), []),
                "plain": (lambda: iv.plain(vol, 18, d, w), []),
                "k4": (lambda: iv.kernel_bwd(*bwd), []),
                "plain_bwd": (lambda: iv.plain_bwd(*bwd), [])}
        for name in ("plain", "k3", "k3", "plain", "plain_bwd", "k4", "k4", "plain_bwd"):  # in turns
            fn, out = runs[name]
            out.append(_cuda_ms(fn, 20 if name.startswith("k") else 2, reps=3))
        timing[dtype] = {k: statistics.median(v[1]) for k, v in runs.items()}
        t = timing[dtype]
        print(f"K3 {str(dtype)[6:]} ({TRAIN_BATCH}, {hw}, {18 * d}): kernel {t['k3']:.4f} ms "
              f"({size / t["k3"] / 1e6:.1f} GB/s read), plain {t['plain']:.4f} ms  [{gpu}]")
        print(f"K4 {str(dtype)[6:]} ({TRAIN_BATCH}, {hw}, {18 * d}): kernel {t['k4']:.4f} ms "
              f"({2 * size / t["k4"] / 1e6:.1f} GB/s read+write), plain_bwd {t['plain_bwd']:.4f} ms  [{gpu}]")
        del vol, runs, bwd, coords, m, s
        torch.cuda.empty_cache()
    t = timing[torch.bfloat16]
    return max(errs), max(dv_errs), (t["k3"], t["plain"]), (t["k4"], t["plain_bwd"])


def _peak_heatmaps(model, image: torch.Tensor, gen: torch.Generator):
    """Redraw the final conv so the heatmap logits have std ~4: the random
    init's head gives near-flat heatmaps, whose coordinates all sit at the
    volume centre and would make any comparison pass."""
    with torch.inference_mode():
        feat = model.head.features(model.backbone(image.permute(0, 3, 1, 2)))
        rms = float(feat.float().pow(2).mean().sqrt())
        w = model.head.final.weight
        std = 4.0 / (rms * math.sqrt(w.shape[0]))
        w.copy_(torch.randn(w.shape, generator=gen) * std)


def _reference_coords(cfg, model, flip_perm, patches: np.ndarray, fhi) -> np.ndarray:
    """Flip-test coords of a batch of uint8 patches, recomputed on the card
    with the fused op's plain version on the same head features."""
    from ihpr_tpu_torch.data.augment import finalize_patch

    n = len(patches)
    with torch.inference_mode():
        image = finalize_patch(
            torch.from_numpy(patches).cuda(), torch.ones(n, 3, device="cuda"), cfg.data
        )
        both = torch.cat([image, image.flip(2)])
        feat = model.head.features(model.backbone(both.permute(0, 3, 1, 2)))
        bb, h, w, c = feat.shape
        coords = fhi.plain(
            feat.reshape(bb, h * w, c), model.head.final.weight, model.head.final.bias,
            model.joint_num, model.depth_dim, w,
        )[0]
        cf = coords[n:].clone()
        cf[..., 0] = cfg.data.output_shape[1] - 1.0 - cf[..., 0]
        out = (coords[:n] + cf[:, flip_perm]) * 0.5
    return out.cpu().numpy()


def serve_phase(fhi, gpu: str):
    from ihpr_tpu_torch.config import get_config
    from ihpr_tpu_torch.data.augment import finalize_patch
    from ihpr_tpu_torch.engine.server import PoseServer
    from ihpr_tpu_torch.models.pose_net import build_pose_net

    cfg = get_config("h36m3d_r50")
    in_h, in_w = cfg.data.input_shape
    gen = torch.Generator().manual_seed(SEED)
    model = build_pose_net(cfg, device="cuda", generator=gen)
    rng = np.random.RandomState(SEED)
    patches = rng.randint(0, 256, (80, in_h, in_w, 3)).astype(np.uint8)
    with torch.inference_mode():
        image = finalize_patch(
            torch.from_numpy(patches[:MAX_BATCH]).cuda(),
            torch.ones(MAX_BATCH, 3, device="cuda"), cfg.data,
        )
    _peak_heatmaps(model, image, gen)
    server = PoseServer(cfg, model, max_batch=MAX_BATCH, flip_test=True, device="cuda")
    images = [rng.randint(0, 256, (480, 640, 3)).astype(np.uint8),
              rng.randint(0, 256, (720, 1280, 3)).astype(np.uint8)]
    bboxes = np.array([[100, 80, 200, 300], [300, 50, 180, 360], [10, 10, 400, 450],
                       [500, 100, 300, 500], [900, 200, 250, 480]], np.float32)
    requests = [
        ([images[k % 2]] * (1 + k % 3), bboxes[: 1 + k % 3], np.full(1 + k % 3, 4000.0))
        for k in range(4)
    ]
    server.predict_patches(patches[:MAX_BATCH])  # warm-up: cuDNN setup, kernel load
    torch.cuda.synchronize()

    # --- the main path, counted ---
    fhi.launches = 0
    t0 = time.perf_counter()
    voxels = server.predict_patches(patches)
    t_patches = time.perf_counter() - t0
    results = server.predict([images[0]] * 2 + [images[1]] * 3, bboxes, root_z=np.full(5, 4500.0))
    stream = list(server.predict_stream(requests, depth=2))
    launches = fhi.launches
    # --------------------------------

    dispatches = math.ceil(80 / MAX_BATCH) + 1 + len(requests)
    if launches != dispatches:
        raise AssertionError(f"K1 launched {launches} times for {dispatches} dispatches")
    if voxels.shape != (80, 18, 3) or not np.isfinite(voxels).all():
        raise AssertionError(f"predict_patches gave {voxels.shape}, finite={np.isfinite(voxels).all()}")
    for r in results + [r for res in stream for r in res]:
        if r.coords_img.shape != (18, 3) or not np.isfinite(r.coords_img).all():
            raise AssertionError("predict / predict_stream gave a malformed result")
    if [len(s) for s in stream] != [1 + k % 3 for k in range(4)]:
        raise AssertionError("predict_stream lost or reordered results")
    tail = patches[64:]  # the last dispatch, padded as the server pads it
    chunk = np.concatenate([tail, np.repeat(tail[-1:], MAX_BATCH - len(tail), 0)])
    ref = _reference_coords(cfg, server.model, server.flip_perm, chunk, fhi)[: len(tail)]
    serve_err = float(np.abs(voxels[64:] - ref).max())
    spread = float(np.abs(voxels - voxels.mean()).max())
    if not (serve_err <= 2 * TOL_VOXEL and spread > 1.0):
        raise AssertionError(f"served coords {serve_err} voxel from plain (spread {spread})")
    print(f"serve: predict_patches(80) -> {voxels.shape}, predict 5 people, stream 4 requests; "
          f"K1 launches {launches} = dispatches {dispatches}; coords vs plain {serve_err:.3g} voxel "
          f"(coord spread {spread:.3g})")

    n_disp = math.ceil(80 / MAX_BATCH)
    print(f"serve: predict_patches 80 patches in {n_disp} dispatches: "
          f"{t_patches * 1e3 / n_disp:.3f} ms/dispatch, {80 / t_patches:.1f} img/s (host clock)  [{gpu}]")
    chunk = patches[:MAX_BATCH]
    steady = _cuda_ms(lambda: server.submit_patches(chunk), 10)
    print(f"serve: {MAX_BATCH}-patch flip-test dispatches back to back: {steady:.3f} ms each, "
          f"{MAX_BATCH / steady * 1e3:.1f} img/s (CUDA events)  [{gpu}]")
    return launches, server


# A serving artifact loaded and run by a process that has torch and numpy
# alone: it cannot import the repository (its working directory is a
# temporary one and PYTHONPATH is cleared) and asserts it did not.
_ARTIFACT_CHILD = r"""
import json, sys, time
import numpy as np
import torch
meta_name, out_dir, patches_path = sys.argv[1:4]
patches = torch.from_numpy(np.load(patches_path)).cuda()
ones = torch.ones(len(patches), 3, device="cuda")
report = {}
for name, sizes in (("fixed", (len(patches),)), ("poly", (1, 7, len(patches)))):
    extra = {meta_name: ""}
    t0 = time.perf_counter()
    program = torch.export.load(f"{out_dir}/{name}.pt2", extra_files=extra).module()
    report[name + "_load_s"] = time.perf_counter() - t0
    if json.loads(extra[meta_name])["matmul_precision"] == "highest":
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        for n in sizes:
            np.save(f"{out_dir}/{name}_{n}.npy", program(patches[:n], ones[:n]).cpu().numpy())
        times = []
        for _ in range(3):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(5):
                program(patches, ones)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 5)
    report[name + "_ms"] = sorted(times)[1]
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("ihpr_tpu_torch", "ihpr_tpu", "jax"))
assert not leaked, leaked
print(json.dumps(report))
"""
TOL_ARTIFACT = 1e-3  # artifact vs eager coords_plain on the card: the same composition
TOL_ARTIFACT_K1 = 0.3  # artifact (bf16 logits) vs the live server's K1 (fp32 logits), voxel


def export_phase(server, gpu: str):
    """The serving export on the card, on the serve phase's h36m3d_r50 server
    (max_batch 32, flip-test): a fixed-batch and a batch-polymorphic artifact
    exported on cuda and written to files; each loaded and run by a process
    with torch and numpy alone (the poly one at batch 1, 7 and 32), and the
    fixed one by load_exported here; every output against eager
    coords_plain + the flip remap on the same patches (TOL_ARTIFACT), and its
    distance from the live server's K1 coords printed beside
    TOL_ARTIFACT_K1. Prints the artifact's MB, export and load seconds, and
    ms per 32-patch flip-test dispatch of the artifact and of the live
    server (CUDA events, inputs resident)."""
    from ihpr_tpu_torch.data.augment import finalize_patch
    from ihpr_tpu_torch.engine.export import METADATA, export_server, load_exported
    from ihpr_tpu_torch.parallel.train_step import flip_test_coords

    cfg = server.cfg
    in_h, in_w = cfg.data.input_shape
    patches = np.random.RandomState(SEED + 1).randint(0, 256, (MAX_BATCH, in_h, in_w, 3)).astype(np.uint8)
    dev = torch.from_numpy(patches).cuda()
    ones = torch.ones(MAX_BATCH, 3, device="cuda")

    def eager(n):
        with torch.inference_mode():
            image = finalize_patch(dev[:n], ones[:n], cfg.data)
            return flip_test_coords(server.model.coords_plain, image, server.flip_perm,
                                    cfg.data.output_shape[1]).cpu().numpy()

    with tempfile.TemporaryDirectory() as tmp:
        blobs, export_s = {}, {}
        for name, batch in (("fixed", None), ("poly", "poly")):
            t0 = time.perf_counter()
            blobs[name] = export_server(server, batch=batch)
            export_s[name] = time.perf_counter() - t0
            with open(f"{tmp}/{name}.pt2", "wb") as f:
                f.write(blobs[name])
        np.save(f"{tmp}/patches.npy", patches)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run(
            [sys.executable, "-c", _ARTIFACT_CHILD, METADATA, tmp, f"{tmp}/patches.npy"],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise AssertionError(f"the torch-only process failed:\n{proc.stderr[-4000:]}")
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        outs = {(name, n): np.load(f"{tmp}/{name}_{n}.npy")
                for name, sizes in (("fixed", (MAX_BATCH,)), ("poly", (1, 7, MAX_BATCH))) for n in sizes}

    t0 = time.perf_counter()
    here = load_exported(blobs["fixed"], device="cuda")
    load_here_s = time.perf_counter() - t0
    outs[("load_exported", MAX_BATCH)] = here(dev, ones).cpu().numpy()
    with torch.inference_mode():
        live = server._forward(dev, ones).cpu().numpy()
    refs = {n: eager(n) for n in (1, 7, MAX_BATCH)}
    errs = {}
    for (name, n), got in outs.items():
        if got.shape != (n, 18, 3) or not np.isfinite(got).all():
            raise AssertionError(f"artifact {name} at batch {n}: {got.shape}, finite={np.isfinite(got).all()}")
        errs[name, n] = float(np.abs(got - refs[n]).max())
    worst = max(errs.values())
    if worst > TOL_ARTIFACT:
        raise AssertionError(f"artifact coords {errs} voxel from eager coords_plain (> {TOL_ARTIFACT})")
    spread = float(np.abs(live - live.mean()).max())
    to_k1 = float(np.abs(outs["fixed", MAX_BATCH] - live).max())
    print("export: " + ", ".join(f"{name} B={n} {e:.3g}" for (name, n), e in errs.items())
          + f" voxel from eager coords_plain + flip remap (bar {TOL_ARTIFACT}); the torch-only process "
          f"imported neither ihpr_tpu_torch nor ihpr_tpu")
    print(f"export: fixed artifact vs the live server's K1 coords {to_k1:.4g} voxel (bf16 logits against "
          f"K1's fp32 ones; expected up to ~{TOL_ARTIFACT_K1}; coord spread {spread:.3g})")
    steady = _cuda_ms(lambda: server._forward(dev, ones), 5, reps=3)
    print(f"export: artifact {len(blobs['fixed']) / 1e6:.1f} MB (poly {len(blobs['poly']) / 1e6:.1f} MB); "
          f"export {export_s['fixed']:.2f} s (poly {export_s['poly']:.2f} s); load {child['fixed_load_s']:.2f} s "
          f"(poly {child['poly_load_s']:.2f} s; load_exported here {load_here_s:.2f} s)  [{gpu}]")
    print(f"export: {MAX_BATCH}-patch flip-test dispatch: artifact {child['fixed_ms']:.3f} ms (poly "
          f"{child['poly_ms']:.3f} ms), live server {steady:.3f} ms (CUDA events, inputs resident)  [{gpu}]")


def _head_grad_check(fhi, trainer, batch):
    """One training forward on ``batch`` through the model's head features,
    then the fused op (K1) and the loss's backward (K2) on those saved
    inputs, against plain_bwd on the same inputs."""
    from ihpr_tpu_torch.data.augment import finalize_patch
    from ihpr_tpu_torch.ops.loss import joint_location_loss

    cfg, model = trainer.cfg, trainer.model
    j, d = model.joint_num, model.depth_dim
    labels = (batch["joint_img"], batch["joint_vis"], batch["joints_have_depth"])
    with torch.no_grad():
        image = finalize_patch(batch["patch"], batch["color_scale"], cfg.data)
        feat = model.head.features(model.backbone(image.permute(0, 3, 1, 2))).contiguous()
    b, h, w, c = feat.shape
    leaves = [feat.requires_grad_(),
              model.head.final.weight.detach().to(model.head.dtype).requires_grad_(),
              model.head.final.bias.detach().to(model.head.dtype).requires_grad_()]
    coords = fhi.fused_final_conv_integral(*leaves, j, d)  # K1
    joint_location_loss(coords, *labels).backward()  # K2
    cot = coords.detach().requires_grad_()
    (g,) = torch.autograd.grad(joint_location_loss(cot, *labels), cot)
    flat, kernel, bias = feat.detach().view(b, h * w, c), leaves[1].detach(), leaves[2].detach()
    _, m, s = fhi.kernel_stats(flat, kernel, bias, j, d, w)
    args = (flat, kernel, bias, m, s, coords.detach(), g)
    got = (leaves[0].grad.view(b, h * w, c), leaves[1].grad, leaves[2].grad)
    if not all(torch.equal(x, y) for x, y in zip(got, fhi.kernel_bwd(*args, j, d, w))):
        raise AssertionError("autograd's head gradients are not K2's output on the saved inputs")
    return check_bwd(fhi, args, j, d, w, TOL_BWD[torch.bfloat16],
                     f"one train step's head gradients (B={b})")[0]


def train_phase(fhi, gpu: str):
    from ihpr_tpu_torch.config import get_config
    from ihpr_tpu_torch.data.pipeline import prefetch_to_device
    from ihpr_tpu_torch.engine.trainer import Trainer

    scratch = tempfile.TemporaryDirectory()  # the Trainer's log and snapshot; removed on return
    cfg = get_config("h36m3d_r50").replace(output_dir=scratch.name)
    if cfg.optim.batch_size_per_device != TRAIN_BATCH:
        raise AssertionError(f"h36m3d_r50 trains at batch {cfg.optim.batch_size_per_device}")
    t0 = time.perf_counter()
    trainer = Trainer(cfg, data_root="synthetic", synthetic_size=384, num_workers=8, device="cuda")
    try:
        print(f"train: Trainer built in {time.perf_counter() - t0:.2f} s "
              f"({len(trainer.loader.index)} samples, {'+'.join(cfg.data.trainset)})")
        host = trainer.loader.epoch(99, 3)
        t0 = time.perf_counter()
        host_batches = list(host)
        loader_ms = (time.perf_counter() - t0) * 1e3 / len(host_batches)
        batch, _ = next(prefetch_to_device(iter(host_batches[:1]), "cuda"))
        for _ in range(2):  # warm-up: cuDNN plans, kernel load
            trainer.lean_step_fn(batch)
        torch.cuda.synchronize()
        head_err = _head_grad_check(fhi, trainer, batch)

        # --- the main path, counted: one epoch of TRAIN_STEPS steps ---
        trainer.cap_steps_per_epoch(TRAIN_STEPS)
        fhi.launches = fhi.bwd_launches = 0
        t0 = time.perf_counter()
        trainer.train(trainer.start_epoch + 1)
        torch.cuda.synchronize()
        t_epoch = time.perf_counter() - t0
        k1, k2 = fhi.launches, fhi.bwd_launches
        # ---------------------------------------------------------------
        losses = [float(x) for x in trainer.losses]  # the epoch's losses
        if (k1, k2) != (TRAIN_STEPS, TRAIN_STEPS):
            raise AssertionError(f"K1/K2 launched {k1}/{k2} times in {TRAIN_STEPS} train steps")
        if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"train losses {losses}")
        print(f"train: {TRAIN_STEPS} steps through Trainer.train, K1 launches {k1}, K2 launches "
              f"{k2}; losses {', '.join(f'{x:.4f}' for x in losses)}")
        print(f"train: host clock {t_epoch * 1e3 / TRAIN_STEPS:.3f} ms/step, "
              f"{TRAIN_STEPS * TRAIN_BATCH / t_epoch:.1f} img/s (loader included)  [{gpu}]")
        print(f"train: loader host {loader_ms:.3f} ms per {TRAIN_BATCH}-image batch "
              f"(render + native warp, {len(host_batches)} batches)  [{gpu}]")

        step_ms = _cuda_ms(lambda: trainer.lean_step_fn(batch), 3, reps=1)
        print(f"train: device {step_ms:.3f} ms/step on one resident batch, "
              f"{TRAIN_BATCH / step_ms * 1e3:.1f} img/s (CUDA events)  [{gpu}]")
        falling = [float(trainer.lean_step_fn(batch)["loss"]) for _ in range(10)]
        if not (all(math.isfinite(x) for x in falling) and falling[-1] < falling[0]):
            raise AssertionError(f"loss does not fall on one repeated batch: {falling}")
        print(f"train: 10 steps on one repeated batch, loss {falling[0]:.4f} -> {falling[-1]:.4f}")
    finally:
        trainer.close()
    return k1, k2, head_err


# --- 7l: the fp32 heads JAX fuses, on the card: h36m3d_r50_fp32 and parity_r50 ---

F32_STEPS = 3  # counted Trainer steps of h36m3d_r50_fp32
F32_SIZE = 64  # synthetic samples per train set: H36M + MPII = 128, 4 batches of 32
PARITY_PATCHES = 6  # parity_r50 serves at batch 1: one dispatch (2 images with flip-test) a patch
# The first loss and gradient norm on K1/K2-fp32 against the no-plan route,
# relative: the fp32 "highest" step bars of 7d (TOL_DP_FP32).
TOL_F32_LOSS = 1e-4
TOL_F32_GRAD = 1e-3


def _first_step(model, cfg, batch, state, flip_perm):
    """Loss and gradients of one train-mode forward and backward of
    ``model`` from ``state`` on ``batch`` (no update)."""
    from ihpr_tpu_torch.ops.loss import joint_location_loss
    from ihpr_tpu_torch.parallel.train_step import patch_batch

    model.load_state_dict(state)
    pb = patch_batch(batch, cfg, flip_perm, train=True)
    model.train()
    model.zero_grad(set_to_none=True)
    with model.precision():
        coords = model.coords(pb.image)
        loss = joint_location_loss(coords, pb.joint_img, pb.joint_vis, pb.joints_have_depth)
        loss.backward()
    torch.cuda.synchronize()
    return float(loss.detach()), {n: p.grad.detach().clone() for n, p in model.named_parameters()
                                  if p.grad is not None}


@contextlib.contextmanager
def _no_plan_route(fhi):
    """fused_final_conv_integral with every head on the no-plan route
    (logits, then K3/K4): the route fp32 heads took before K1/K2-fp32."""
    supported = fhi.fused_supported
    fhi.fused_supported = lambda *args: False
    try:
        yield
    finally:
        fhi.fused_supported = supported


def fp32_train_phase(fhi, iv, gpu: str):
    """h36m3d_r50_fp32 at full width and depth (ResNet-50 at 256x256, fp32
    "highest", flax BN, batch 32) on synthetic H36M + MPII: its fp32 head
    has a fused plan, so K1-fp32 and K2-fp32 run once a step. First one
    train-mode forward and backward from the same weights on the fused route
    (counted: K1/K2-fp32 once each, K1-K4 none) and on the no-plan route
    (K3/K4 once each): loss within TOL_F32_LOSS and the gradient norm within
    TOL_F32_GRAD, relative, and the final conv's gradients compared; then
    F32_STEPS counted steps through Trainer.train (K1/K2-fp32 once a step);
    then each route's device ms per step and peak memory on one resident
    batch. Returns K1-fp32's and K2-fp32's launches."""
    from ihpr_tpu_torch.config import get_config
    from ihpr_tpu_torch.data import skeletons
    from ihpr_tpu_torch.data.pipeline import prefetch_to_device
    from ihpr_tpu_torch.engine.trainer import Trainer

    t_phase = time.perf_counter()
    scratch = tempfile.TemporaryDirectory()  # the Trainer's log and snapshot; removed on return
    cfg = get_config("h36m3d_r50_fp32").replace(output_dir=scratch.name)
    if (cfg.optim.batch_size_per_device, cfg.model.matmul_precision, cfg.model.compute_dtype,
            cfg.model.bn_mode) != (F32_TRAIN_BATCH, "highest", "float32", "flax"):
        raise AssertionError(f"h36m3d_r50_fp32 is {cfg.model} at batch {cfg.optim.batch_size_per_device}")
    trainer = Trainer(cfg, data_root="synthetic", synthetic_size=F32_SIZE, num_workers=8, device="cuda")
    try:
        model = trainer.model
        flip_perm = skeletons.get_skeleton(cfg.data.trainset[0]).flip_permutation()
        batch, _ = next(prefetch_to_device(iter(list(trainer.loader.epoch(99, 1))), "cuda"))
        state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        _first_step(model, cfg, batch, state, flip_perm)  # warm-up: cuDNN plans, kernel load
        # --- one forward and backward on each route, counted ---
        _zero_counts(fhi, iv)
        loss, grads = _first_step(model, cfg, batch, state, flip_perm)
        fused_counts = _counts(fhi, iv) + _f32_counts(fhi)
        with _no_plan_route(fhi):
            _zero_counts(fhi, iv)
            loss_np, grads_np = _first_step(model, cfg, batch, state, flip_perm)
            noplan_counts = _counts(fhi, iv) + _f32_counts(fhi)
        # --------------------------------------------------------
        model.load_state_dict(state)
        norm = float(torch.stack([g.double().norm() for g in grads.values()]).norm())
        norm_np = float(torch.stack([g.double().norm() for g in grads_np.values()]).norm())
        head = {n: float((grads[n] - grads_np[n]).abs().max() / grads_np[n].abs().max())
                for n in grads if n.startswith("head.final")}
        worst = max(float((grads[n] - grads_np[n]).abs().max() / grads_np[n].abs().max()) for n in grads)
        print(f"fp32 train: h36m3d_r50_fp32 first forward and backward at batch {F32_TRAIN_BATCH}: loss "
              f"{loss:.8f} on K1/K2-fp32, {loss_np:.8f} on the no-plan route (relative {abs(loss - loss_np) / abs(loss_np):.3g}, "
              f"bar {TOL_F32_LOSS:g}); gradient norm {norm:.8g} / {norm_np:.8g} (relative "
              f"{abs(norm - norm_np) / norm_np:.3g}, bar {TOL_F32_GRAD:g}); final conv |diff|/max "
              f"{', '.join(f'{n} {v:.2e}' for n, v in head.items())}; worst tensor {worst:.2e}; K1-K4, K1/K2-fp32 "
              f"{fused_counts} fused, {noplan_counts} no-plan")
        if (fused_counts != (0, 0, 0, 0, 1, 1) or noplan_counts != (0, 0, 1, 1, 0, 0)
                or abs(loss - loss_np) > TOL_F32_LOSS * abs(loss_np) or abs(norm - norm_np) > TOL_F32_GRAD * norm_np):
            raise AssertionError(f"fp32 train: loss {loss} / {loss_np}, |g| {norm} / {norm_np}, launches "
                                 f"{fused_counts} / {noplan_counts}")
        del grads, grads_np

        # --- the main path, counted: F32_STEPS steps through Trainer.train ---
        trainer.cap_steps_per_epoch(F32_STEPS)
        _zero_counts(fhi, iv)
        t0 = time.perf_counter()
        trainer.train(trainer.start_epoch + 1)
        torch.cuda.synchronize()
        t_epoch = time.perf_counter() - t0
        counts = _counts(fhi, iv) + _f32_counts(fhi)
        # ---------------------------------------------------------------------
        losses = [float(x) for x in trainer.losses]
        if counts != (0, 0, 0, 0, F32_STEPS, F32_STEPS):
            raise AssertionError(f"fp32 train: K1-K4, K1/K2-fp32 launched {counts} times in {F32_STEPS} steps")
        if len(losses) != F32_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"fp32 train losses {losses}")
        print(f"fp32 train: {F32_STEPS} steps through Trainer.train, K1-fp32 {counts[4]}, K2-fp32 {counts[5]}, "
              f"K1-K4 0; losses {', '.join(f'{x:.4f}' for x in losses)}; host clock "
              f"{t_epoch * 1e3 / F32_STEPS:.3f} ms/step (loader included)  [{gpu}]")
        for label, route in (("K1/K2-fp32", contextlib.nullcontext()), ("no-plan route", _no_plan_route(fhi))):
            with route:
                trainer.lean_step_fn(batch)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                step_ms = _cuda_ms(lambda: trainer.lean_step_fn(batch), 3, reps=1)
                peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"fp32 train ({label}): device {step_ms:.3f} ms/step on one resident batch of "
                  f"{F32_TRAIN_BATCH}, {F32_TRAIN_BATCH / step_ms * 1e3:.1f} img/s (CUDA events); peak "
                  f"{peak:.3f} GiB allocated  [{gpu}]")
    finally:
        trainer.close()
        scratch.cleanup()
    torch.cuda.empty_cache()
    print(f"fp32 train: the phase took {time.perf_counter() - t_phase:.1f} s  [{gpu}]")
    return counts[4], counts[5]


def _f32_fused_counts(fhi, mm, cb):
    """(K5-fp32, K6-fp32, K7-fp32, K8-fp32, K1-fp32, K2-fp32, then bf16 K5,
    K6, K7, K8) launches."""
    return (mm.f32_launches, mm.f32_bwd_launches, cb.f32_launches, cb.f32_bwd_launches, *_f32_counts(fhi),
            *_counts(mm, cb))


def _fp32_fused_routes(tag, cfg, modes, per_step, wrapped_mod, labels, fhi, iv, mm, cb, gpu: str):
    """What 7m and 7n run on ``cfg`` (h36m3d_r50_fp32, lean BN, batch
    F32_TRAIN_BATCH) through a Trainer on synthetic H36M + MPII. ``modes``
    maps a name to the Bottlenecks' (fused_1x1, fused_conv3); the first is
    the main path, the last unfused. First one train-mode forward and
    backward from the same weights on the first and the last mode (counted:
    the first launches ``per_step``, _f32_fused_counts' order, the last only
    K1/K2-fp32; loss within TOL_F32_LOSS and gradient norm within
    TOL_F32_GRAD, relative); then F32_STEPS counted steps through
    Trainer.train in the first mode, one launch of ``wrapped_mod``'s
    kernel_fwd and one of its kernel_bwd (fp32, with the prologue) held
    against plain on their saved inputs (``labels`` name them); then device
    ms a step, device-busy ms and peak memory on one resident batch in every
    mode, in turns (the order rotated every round), medians of three rounds.
    Returns the main path's launches (the first step's and the Trainer
    steps', summed) and the saved launches' largest y and dx differences."""
    from ihpr_tpu_torch.data import skeletons
    from ihpr_tpu_torch.data.pipeline import prefetch_to_device
    from ihpr_tpu_torch.engine.trainer import Trainer
    from ihpr_tpu_torch.models.resnet import Bottleneck

    if (cfg.optim.batch_size_per_device, cfg.model.matmul_precision, cfg.model.compute_dtype, cfg.model.bn_mode,
            cfg.model.resnet_type) != (F32_TRAIN_BATCH, "highest", "float32", "lean", 50):
        raise AssertionError(f"{tag}: h36m3d_r50_fp32 is {cfg.model} at batch {cfg.optim.batch_size_per_device}")
    size = "x".join(map(str, cfg.data.input_shape))
    trainer = Trainer(cfg, data_root="synthetic", synthetic_size=F32_SIZE, num_workers=8, device="cuda")
    blocks = [m for m in trainer.model.modules() if isinstance(m, Bottleneck)]

    def set_mode(mode):
        for blk in blocks:
            blk.fused_1x1, blk.fused_conv3 = modes[mode]

    main, unfused = list(modes)[0], list(modes)[-1]
    counts = lambda: _f32_fused_counts(fhi, mm, cb)  # noqa: E731
    wrapped = {}
    try:
        model = trainer.model
        flip_perm = skeletons.get_skeleton(cfg.data.trainset[0]).flip_permutation()
        batch, _ = next(prefetch_to_device(iter(list(trainer.loader.epoch(99, 1))), "cuda"))
        state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        runs = {}
        for mode in (main, unfused):
            set_mode(mode)
            _first_step(model, cfg, batch, state, flip_perm)  # warm-up: kernel loads, cuDNN plans
            # --- one forward and backward on each route, counted ---
            _zero_counts(fhi, iv, mm, cb)
            runs[mode] = (*_first_step(model, cfg, batch, state, flip_perm), counts())
            # --------------------------------------------------------
        model.load_state_dict(state)
        set_mode(main)
        (loss, grads, fused_n), (loss_u, grads_u, unfused_n) = runs[main], runs[unfused]
        norm = float(torch.stack([g.double().norm() for g in grads.values()]).norm())
        norm_u = float(torch.stack([g.double().norm() for g in grads_u.values()]).norm())
        worst = max(float((grads[n] - grads_u[n]).abs().max() / grads_u[n].abs().max()) for n in grads)
        print(f"{tag}: h36m3d_r50_fp32 lean BN at {size}, first forward and backward at batch {F32_TRAIN_BATCH}: "
              f"loss {loss:.8f} with {main}, {loss_u:.8f} {unfused} (relative {abs(loss - loss_u) / abs(loss_u):.3g}, "
              f"bar {TOL_F32_LOSS:g}); gradient norm {norm:.8g} / {norm_u:.8g} (relative "
              f"{abs(norm - norm_u) / norm_u:.3g}, bar {TOL_F32_GRAD:g}); worst tensor |diff|/max {worst:.2e}; "
              f"K5/K6-fp32, K7/K8-fp32, K1/K2-fp32, K5-K8 launches {fused_n} fused, {unfused_n} unfused")
        if (fused_n != per_step or unfused_n != (0, 0, 0, 0, 1, 1, 0, 0, 0, 0)
                or abs(loss - loss_u) > TOL_F32_LOSS * abs(loss_u) or abs(norm - norm_u) > TOL_F32_GRAD * norm_u):
            raise AssertionError(f"{tag}: loss {loss} / {loss_u}, |g| {norm} / {norm_u}, launches "
                                 f"{fused_n} / {unfused_n}")
        del grads, grads_u

        with_prologue = lambda args: args[2] is not None and args[0].dtype == torch.float32  # noqa: E731
        for name in ("kernel_fwd", "kernel_bwd"):
            wrapped[name] = _FirstLaunch(getattr(wrapped_mod, name), with_prologue)
            setattr(wrapped_mod, name, wrapped[name])
        # --- the main path, counted: F32_STEPS steps through Trainer.train ---
        trainer.cap_steps_per_epoch(F32_STEPS)
        _zero_counts(fhi, iv, mm, cb)
        trainer.train(trainer.start_epoch + 1)
        torch.cuda.synchronize()
        steps_n = counts()
        # ---------------------------------------------------------------------
        for name, w in wrapped.items():
            setattr(wrapped_mod, name, w.fn)
        losses = [float(x) for x in trainer.losses]
        if steps_n != tuple(F32_STEPS * c for c in per_step):
            raise AssertionError(f"{tag}: {F32_STEPS} Trainer steps launched {steps_n}")
        if len(losses) != F32_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{tag} losses {losses}")
        print(f"{tag}: {F32_STEPS} steps through Trainer.train, K5/K6-fp32, K7/K8-fp32, K1/K2-fp32, K5-K8 launches "
              f"{steps_n}; losses {', '.join(f'{x:.4f}' for x in losses)}")
        (f_args, f_out), (b_args, b_out) = wrapped["kernel_fwd"].saved, wrapped["kernel_bwd"].saved
        rows = f_out[0].numel() // f_out[0].shape[-1]
        shape = f"{tuple(f_args[0].shape)} x {tuple(f_args[1].shape)}"
        errs = (compare_bn(f"{labels[0]} {shape}, one launch of a counted step", FWD_NAMES, f_out,
                           wrapped_mod.plain(*f_args), torch.float32, rows)["y"],
                compare_bn(f"{labels[1]} {shape}, one launch of a counted step", BWD_NAMES, b_out,
                           wrapped_mod.plain_bwd(*b_args), torch.float32, rows)["dx"])

        # The A/B on one resident batch: every mode in turns (the order
        # rotated every round), three rounds of three steps.
        step = lambda: trainer.lean_step_fn(batch)  # noqa: E731
        timing, peak = {m: [] for m in modes}, {}
        order = list(modes)
        for rnd in range(3):
            for mode in order[rnd % len(order):] + order[:rnd % len(order)]:
                set_mode(mode)
                torch.cuda.reset_peak_memory_stats()
                timing[mode].append(_cuda_ms(step, 3, reps=1))
                peak[mode] = torch.cuda.max_memory_allocated() / 2**30
        for mode in modes:
            set_mode(mode)
            step()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
            kinds = prof.key_averages()
            busy = sum(e.self_device_time_total for e in kinds) / 1e3
            conv3 = sum(e.self_device_time_total for e in kinds if "c3f::" in e.key) / 1e3
            fused = sum(e.self_device_time_total for e in kinds if "mbf::" in e.key) / 1e3
            ms = statistics.median(timing[mode])
            print(f"{tag} A/B, h36m3d_r50_fp32 lean {size} batch {F32_TRAIN_BATCH}, {mode}: {ms:.3f} ms/step median "
                  f"of {', '.join(f'{t:.3f}' for t in timing[mode])} ({F32_TRAIN_BATCH / ms * 1e3:.1f} img/s, peak "
                  f"{peak[mode]:.3f} GiB); device busy {busy:.3f} ms, idle share {1 - busy / ms:.3f}; K5/K6-fp32 "
                  f"kernels {fused:.3f} ms, K7/K8-fp32 {conv3:.3f} ms (CUDA events, same model, in turns; "
                  f"torch.profiler)  [{gpu}]")
        set_mode(main)
    finally:
        for name, w in wrapped.items():
            setattr(wrapped_mod, name, w.fn)
        trainer.close()
    torch.cuda.empty_cache()
    return tuple(a + b for a, b in zip(fused_n, steps_n)), errs


def fp32_fused_phase(fhi, iv, mm, cb, gpu: str):
    """7m: h36m3d_r50_fp32 with lean BN and fused_1x1 (ResNet-50 at 256x256,
    fp32 "highest", batch 32) on synthetic H36M + MPII: 8 Bottlenecks take
    the 1x1 route, so a step launches K5-fp32 and K6-fp32 16 times each,
    K1/K2-fp32 once (its fp32 head has a fused plan) and K7/K8 never.
    _fp32_fused_routes runs it: fused_1x1 against unfused, one K5-fp32 and
    one K6-fp32 launch of the counted steps against plain. Returns
    K5-fp32's and K6-fp32's launches and the saved launches' largest y and
    dx differences."""
    from ihpr_tpu_torch.config import get_config

    t_phase = time.perf_counter()
    scratch = tempfile.TemporaryDirectory()  # the Trainer's log and snapshot; removed on return
    try:
        base = get_config("h36m3d_r50_fp32").replace(output_dir=scratch.name)
        cfg = base.replace(model=dataclasses.replace(base.model, bn_mode="lean", fused_1x1=True))
        launches, errs = _fp32_fused_routes(
            "fp32 fused", cfg, {"fused_1x1": (True, False), "unfused": (False, False)},
            (16, 16, 0, 0, 1, 1, 0, 0, 0, 0), mm, ("K5-fp32", "K6-fp32"), fhi, iv, mm, cb, gpu)
    finally:
        scratch.cleanup()
    print(f"fp32 fused: the phase took {time.perf_counter() - t_phase:.1f} s  [{gpu}]")
    return launches[0], launches[1], errs


# 7n's frame: the largest input at which JAX's conv3 route takes fp32
# ResNet-50 blocks (stage 3's 8x8 planes), and its heatmaps (depth 64).
CONV3_F32_FRAME = ((128, 128), (32, 32))


def fp32_conv3_phase(fhi, iv, mm, cb, gpu: str):
    """7n: h36m3d_r50_fp32 with lean BN and both fused flags at a 128x128
    frame (ResNet-50 at full width, fp32 "highest", batch 32, synthetic
    H36M + MPII): the 1x1 route takes layer1_0 ... layer3_0 (K5-fp32 /
    K6-fp32 16 each a step) and the conv3 route layer3_1 ... layer3_5's
    conv2 (K7-fp32 / K8-fp32 5 each), K1/K2-fp32 once. _fp32_fused_routes
    runs it: both flags against fused_1x1 alone and unfused, one K7-fp32
    and one K8-fp32 launch of the counted steps against plain. Returns the
    launches of K5-fp32, K6-fp32, K7-fp32, K8-fp32, K1-fp32 and K2-fp32, and
    the saved launches' largest y and dx differences."""
    from ihpr_tpu_torch.config import get_config

    t_phase = time.perf_counter()
    scratch = tempfile.TemporaryDirectory()
    try:
        base = get_config("h36m3d_r50_fp32").replace(output_dir=scratch.name)
        size, heatmap = CONV3_F32_FRAME
        cfg = base.replace(model=dataclasses.replace(base.model, bn_mode="lean", fused_1x1=True, fused_conv3=True),
                           data=dataclasses.replace(base.data, input_shape=size, output_shape=heatmap))
        if cfg.data.depth_dim != 64:
            raise AssertionError(f"h36m3d_r50_fp32's depth is {cfg.data.depth_dim}")
        launches, errs = _fp32_fused_routes(
            "fp32 conv3", cfg, {"both flags": (True, True), "fused_1x1": (True, False), "unfused": (False, False)},
            (16, 16, 5, 5, 1, 1, 0, 0, 0, 0), cb, ("K7-fp32", "K8-fp32"), fhi, iv, mm, cb, gpu)
    finally:
        scratch.cleanup()
    print(f"fp32 conv3: the phase took {time.perf_counter() - t_phase:.1f} s  [{gpu}]")
    return launches[:6], errs


def parity_serve_phase(fhi, iv, gpu: str):
    """parity_r50 (ResNet-50 at 256x256, fp32 "highest", served at batch 1)
    through PoseServer with flip-test on PARITY_PATCHES patches, seeded
    weights with peaked heatmaps: one dispatch (2 images) a patch, K1-fp32
    once a dispatch and nothing else; the coords against flip-test
    coords_plain (the logits and the plain soft-argmax) on the same
    weights. Returns K1-fp32's launches."""
    from ihpr_tpu_torch.config import get_config
    from ihpr_tpu_torch.data.augment import finalize_patch
    from ihpr_tpu_torch.engine.server import PoseServer
    from ihpr_tpu_torch.models.pose_net import build_pose_net
    from ihpr_tpu_torch.parallel.train_step import flip_test_coords

    cfg = get_config("parity_r50")
    if (cfg.optim.batch_size_per_device, cfg.model.matmul_precision, cfg.model.compute_dtype) != (
            1, "highest", "float32"):
        raise AssertionError(f"parity_r50 is {cfg.model} at batch {cfg.optim.batch_size_per_device}")
    in_h, in_w = cfg.data.input_shape
    gen = torch.Generator().manual_seed(SEED)
    model = build_pose_net(cfg, device="cuda", generator=gen)
    patches = np.random.RandomState(SEED).randint(0, 256, (PARITY_PATCHES, in_h, in_w, 3)).astype(np.uint8)
    with torch.inference_mode():
        image = finalize_patch(torch.from_numpy(patches).cuda(), torch.ones(PARITY_PATCHES, 3, device="cuda"),
                               cfg.data)
    _peak_heatmaps(model, image, gen)
    server = PoseServer(cfg, model, max_batch=cfg.optim.batch_size_per_device, flip_test=True, device="cuda")
    server.predict_patches(patches[:1])  # warm-up: cuDNN setup, kernel load
    torch.cuda.synchronize()
    # --- the main path, counted ---
    _zero_counts(fhi, iv)
    t0 = time.perf_counter()
    voxels = server.predict_patches(patches)
    t_serve = time.perf_counter() - t0
    counts = _counts(fhi, iv) + _f32_counts(fhi)
    # ------------------------------
    with torch.inference_mode():
        ref = flip_test_coords(server.model.coords_plain, image, server.flip_perm,
                               cfg.data.output_shape[1]).cpu().numpy()
    err = float(np.abs(voxels - ref).max())
    spread = float(np.abs(ref - ref.mean()).max())
    dispatch_ms = _cuda_ms(lambda: server.submit_patches(patches[:1]), 10)
    print(f"parity serve: parity_r50 through PoseServer (max_batch {server.max_batch}, flip-test) on "
          f"{PARITY_PATCHES} patches: K1-fp32 {counts[4]} for {PARITY_PATCHES} dispatches, K1-K4 and K2-fp32 "
          f"{counts[:4] + counts[5:]}; coords vs flip-test coords_plain {err:.3g} voxel (bar {2 * TOL_VOXEL:g}, "
          f"spread {spread:.3g}); {t_serve * 1e3 / PARITY_PATCHES:.3f} ms a dispatch (host clock), "
          f"{dispatch_ms:.3f} ms (CUDA events)  [{gpu}]")
    if counts != (0, 0, 0, 0, PARITY_PATCHES, 0) or voxels.shape != (PARITY_PATCHES, 18, 3):
        raise AssertionError(f"parity serve: K1-K4, K1/K2-fp32 {counts} for {PARITY_PATCHES} dispatches, "
                             f"coords {voxels.shape}")
    if not (np.isfinite(voxels).all() and err <= 2 * TOL_VOXEL and spread > 1.0):
        raise AssertionError(f"parity serve: coords {err} voxel from coords_plain (spread {spread})")
    del server, model
    torch.cuda.empty_cache()
    return counts[4]


R152_SERVE_PATCHES = 40  # two dispatches of the r152 server, the second padded
R152_STEPS = 3  # counted train steps of the r152 phase


def r152_head_times(fhi, iv, gpu: str):
    """K1 at the r152 serving shape (64, 6912, 256) x (256, 1152) and K2 at
    its train batch (32, 6912, 256), bf16, each beside its plain version, the
    library composition (cuBLAS final conv + K3, K4 + two cuBLAS matmuls)
    and its bound, printed."""
    hw, w, c, j, d = 96 * 72, 72, 256, 18, 64
    for name, b in (("K1", 2 * MAX_BATCH), ("K2", R152_BATCH)):
        feat, kernel, bias, m, s, coords, g = _bwd_inputs(fhi, b, hw, c, j, d, w, torch.bfloat16, SEED)
        flat = feat.view(-1, c)
        if name == "K1":
            kern = lambda: fhi.kernel_stats(feat, kernel, bias, j, d, w)  # noqa: E731
            plain = lambda: fhi.plain(feat, kernel, bias, j, d, w)  # noqa: E731
            lib = lambda: iv.kernel_stats(torch.addmm(bias, flat, kernel).view(b, hw, j * d), j, d, w)  # noqa: E731
            bound = k1_bound(b, hw)[0]
        else:
            args = (feat, kernel, bias, m, s, coords, g)
            kern = lambda: fhi.kernel_bwd(*args, j, d, w)  # noqa: E731
            plain = lambda: fhi.plain_bwd(*args, j, d, w)  # noqa: E731
            logits = torch.addmm(bias, flat, kernel).view(b, hw, j * d)
            lc, lm, ls = iv.kernel_stats(logits, j, d, w)

            def lib():
                dv = iv.kernel_bwd(logits, lm, ls, lc, g, j, d, w).view(-1, j * d)
                return dv @ kernel.t(), flat.t() @ dv, dv.float().sum(0)

            bound = k2_bound(b, hw)[0]
        runs = {"plain": (plain, []), "kernel": (kern, []), "library": (lib, [])}
        for key in ("plain", "kernel", "library", "library", "kernel", "plain"):  # in turns
            fn, times = runs[key]
            times.append(_cuda_ms(fn, 5 if key == "kernel" else 2, reps=3))
        ms, plain_ms, lib_ms = (statistics.median(runs[k][1]) for k in ("kernel", "plain", "library"))
        print(f"{name} bf16 r152 ({b}, {hw}, {c}) x ({c}, {j * d}): kernel {ms:.4f} ms (bound {bound:.4f} ms, "
              f"{bound / ms:.3f} of it), plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms  [{gpu}]")
        del feat, kernel, bias, m, s, coords, g, flat, runs
        torch.cuda.empty_cache()


def r152_phase(fhi, iv, gpu: str):
    """h36m3d_r152_384 (ResNet-152 at full depth and width, 384x288 input,
    96x72x64 heatmaps, bf16, lean BN) on seeded weights, its heatmaps peaked:
    serves R152_SERVE_PATCHES patches at max_batch 32 with flip-test (64
    images a dispatch; K1 at H*W = 6912, W = 72) and holds the padded
    dispatch against the plain head on the same features; trains through the
    Trainer at the config's batch (32) on synthetic data for R152_STEPS
    counted steps and holds K2 against plain_bwd on one step's head inputs;
    device ms per train step on a resident batch and per serve dispatch
    (CUDA events) and peak memory; K1/K2 times at these shapes
    (r152_head_times). Returns (K1 launches, K2 launches, K1 err, K2 err)."""
    from ihpr_tpu_torch.config import get_config
    from ihpr_tpu_torch.data.augment import finalize_patch
    from ihpr_tpu_torch.data.pipeline import prefetch_to_device
    from ihpr_tpu_torch.engine.server import PoseServer
    from ihpr_tpu_torch.engine.trainer import Trainer
    from ihpr_tpu_torch.models.pose_net import build_pose_net

    scratch = tempfile.TemporaryDirectory()  # the Trainer's log and snapshot; removed on return
    cfg = get_config("h36m3d_r152_384").replace(output_dir=scratch.name)
    if cfg.optim.batch_size_per_device != R152_BATCH or cfg.data.output_shape != (96, 72):
        raise AssertionError(f"h36m3d_r152_384: batch {cfg.optim.batch_size_per_device}, {cfg.data.output_shape}")
    in_h, in_w = cfg.data.input_shape
    gen = torch.Generator().manual_seed(SEED)
    model = build_pose_net(cfg, device="cuda", generator=gen)
    rng = np.random.RandomState(SEED)
    patches = rng.randint(0, 256, (R152_SERVE_PATCHES, in_h, in_w, 3)).astype(np.uint8)
    with torch.inference_mode():
        image = finalize_patch(torch.from_numpy(patches[:MAX_BATCH]).cuda(),
                               torch.ones(MAX_BATCH, 3, device="cuda"), cfg.data)
    _peak_heatmaps(model, image, gen)
    del image
    server = PoseServer(cfg, model, max_batch=MAX_BATCH, flip_test=True, device="cuda")
    del model
    server.predict_patches(patches[:MAX_BATCH])  # warm-up: cuDNN setup
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # --- the serving path, counted ---
    fhi.launches = fhi.bwd_launches = 0
    voxels = server.predict_patches(patches)
    serve_k1, serve_k2 = fhi.launches, fhi.bwd_launches
    # ---------------------------------
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    dispatches = math.ceil(R152_SERVE_PATCHES / MAX_BATCH)
    if (serve_k1, serve_k2) != (dispatches, 0):
        raise AssertionError(f"r152 serve: K1/K2 launched {serve_k1}/{serve_k2} times for {dispatches} dispatches")
    if voxels.shape != (R152_SERVE_PATCHES, 18, 3) or not np.isfinite(voxels).all():
        raise AssertionError(f"r152 serve gave {voxels.shape}, finite={np.isfinite(voxels).all()}")
    tail = patches[MAX_BATCH:]  # the last dispatch, padded as the server pads it
    chunk = np.concatenate([tail, np.repeat(tail[-1:], MAX_BATCH - len(tail), 0)])
    ref = _reference_coords(cfg, server.model, server.flip_perm, chunk, fhi)[: len(tail)]
    serve_err = float(np.abs(voxels[MAX_BATCH:] - ref).max())
    spread = float(np.abs(voxels - voxels.mean()).max())
    if not (serve_err <= 2 * TOL_VOXEL and spread > 1.0):
        raise AssertionError(f"r152 served coords {serve_err} voxel from plain (spread {spread})")
    chunk = patches[:MAX_BATCH]
    serve_ms = _cuda_ms(lambda: server.submit_patches(chunk), 5, reps=3)
    print(f"r152 serve: predict_patches({R152_SERVE_PATCHES}) -> {voxels.shape}, K1 launches {serve_k1} = "
          f"dispatches {dispatches}, K2 {serve_k2}; coords vs plain {serve_err:.3g} voxel (bar "
          f"{2 * TOL_VOXEL}; coord spread {spread:.3g})")
    print(f"r152 serve: {MAX_BATCH}-patch flip-test dispatch ({2 * MAX_BATCH} images of {in_h}x{in_w}) "
          f"{serve_ms:.3f} ms back to back (CUDA events); peak memory {serve_peak:.2f} GiB  [{gpu}]")
    del server
    torch.cuda.empty_cache()

    trainer = Trainer(cfg, data_root="synthetic", synthetic_size=2 * R152_BATCH, num_workers=8, device="cuda")
    try:
        host = trainer.loader.epoch(99, 1)
        batch, _ = next(prefetch_to_device(host, "cuda"))
        for _ in range(2):  # warm-up: cuDNN plans
            trainer.lean_step_fn(batch)
        torch.cuda.synchronize()
        head_err = _head_grad_check(fhi, trainer, batch)

        # --- the training path, counted: one epoch of R152_STEPS steps ---
        trainer.cap_steps_per_epoch(R152_STEPS)
        fhi.launches = fhi.bwd_launches = 0
        trainer.train(trainer.start_epoch + 1)
        torch.cuda.synchronize()
        train_k1, train_k2 = fhi.launches, fhi.bwd_launches
        # ------------------------------------------------------------------
        losses = [float(x) for x in trainer.losses]
        if (train_k1, train_k2) != (R152_STEPS, R152_STEPS):
            raise AssertionError(f"r152 train: K1/K2 launched {train_k1}/{train_k2} times in {R152_STEPS} steps")
        if len(losses) != R152_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"r152 train losses {losses}")
        torch.cuda.reset_peak_memory_stats()
        step_ms = _cuda_ms(lambda: trainer.lean_step_fn(batch), 3, reps=1)
        train_peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"r152 train: {R152_STEPS} steps through Trainer.train at batch {R152_BATCH}, K1 launches "
              f"{train_k1}, K2 launches {train_k2}; losses {', '.join(f'{x:.4f}' for x in losses)}")
        print(f"r152 train: device {step_ms:.3f} ms/step on one resident batch, "
              f"{R152_BATCH / step_ms * 1e3:.1f} img/s (CUDA events); peak memory {train_peak:.2f} GiB  [{gpu}]")
        del batch
    finally:
        trainer.close()
    del trainer
    torch.cuda.empty_cache()
    r152_head_times(fhi, iv, gpu)
    return serve_k1 + train_k1, train_k2, serve_err, head_err


SNAP_SIZE = 256  # synthetic samples per train set: H36M + MPII = 512, 4 steps of 128
SNAP_TEST = 128  # synthetic H36M test samples of the snapshot Tester: one eval batch


def _state_gaps(got: dict, want: dict) -> list:
    """(name, largest |difference|) of every tensor or count of two
    ``TrainState.state_dict()``s that are not bitwise equal: the model's
    weights and BN running statistics, the Adam moments and counts, the
    schedule's count, the update count."""
    gaps = [(k, float((got["model"][k].double() - v.double()).abs().max()))
            for k, v in want["model"].items() if not torch.equal(got["model"][k], v)]
    for i, st in want["optimizer"]["state"].items():
        gaps += [(f"optimizer.{i}.{k}", float((got["optimizer"]["state"][i][k].double() - v.double()).abs().max()))
                 for k, v in st.items() if not torch.equal(got["optimizer"]["state"][i][k], v)]
    for key, a, b in (("step", got["step"], want["step"]),
                      ("scheduler", got["scheduler"]["last_epoch"], want["scheduler"]["last_epoch"])):
        if a != b:
            gaps.append((key, abs(a - b)))
    return gaps


def snapshot_phase(fhi, gpu: str):
    """The snapshot lifecycle of h36m3d_r50 at full width (batch 128,
    synthetic H36M+MPII, 4 steps an epoch), under cuDNN's deterministic
    algorithms: (a) two epochs uninterrupted; (b) the same run preempted by
    the RSS watchdog at itr 1 of epoch 0 (exit 75, snapshot_0 with itr 1);
    (c) resumed with --continue at (epoch 0, skip 2) through both epochs, K1
    and K2 once per step, its final weights, BN statistics, Adam moments and
    counts bitwise (a)'s; (d) the Tester from (a)'s snapshot_1 against the
    Tester of (a)'s model, bitwise, K1 once per eval batch; (e) load_server
    against PoseServer on (a)'s model, bitwise; (f) ``python -m
    ihpr_tpu_torch.test`` on (a)'s run in a subprocess; (g) a profile window
    of (c)'s trainer whose trace names K1's and K2's kernels. Prints the
    snapshot's size and the save's blocking and background times and the
    load's. Returns the counted K1 and K2 launches of (c)-(e)."""
    from ihpr_tpu_torch.config import get_config
    from ihpr_tpu_torch.data.datasets import build_dataset
    from ihpr_tpu_torch.engine.checkpoint import CheckpointManager, _host_copy
    from ihpr_tpu_torch.engine.server import PoseServer, load_server
    from ihpr_tpu_torch.engine.tester import Tester
    from ihpr_tpu_torch.engine.trainer import Trainer
    from ihpr_tpu_torch.utils.hostmem import EX_TEMPFAIL

    base = get_config("h36m3d_r50")
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    with tempfile.TemporaryDirectory() as tmp:
        run_a, run_b = f"{tmp}/a", f"{tmp}/b"

        def trainer(out, **kw):
            return Trainer(base.replace(output_dir=out), data_root="synthetic", synthetic_size=SNAP_SIZE,
                           num_workers=8, device="cuda", **kw)

        try:
            # (a) uninterrupted
            t0 = time.perf_counter()
            ta = trainer(run_a, rss_limit_mb=0)
            if ta.steps_per_epoch != 4:
                raise AssertionError(f"snapshot phase: {ta.steps_per_epoch} steps an epoch, want 4")
            try:
                ta.train(2)
            finally:
                ta.close()
            want = _host_copy(ta.state.state_dict())
            if ta.ckpt._epochs_on_disk() != [0, 1]:
                raise AssertionError(f"(a) left snapshots {ta.ckpt._epochs_on_disk()}")
            print(f"snapshot (a): 2 epochs of {ta.steps_per_epoch} steps uninterrupted in "
                  f"{time.perf_counter() - t0:.2f} s, snapshot_0 and snapshot_1 written")

            timing = CheckpointManager(f"{tmp}/timing")
            block, write, load = [], [], []
            for e in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                timing.save(e, ta.state)
                t1 = time.perf_counter()
                timing.wait()
                t2 = time.perf_counter()
                timing.load(e)
                t3 = time.perf_counter()
                block.append((t1 - t0) * 1e3)
                write.append((t2 - t1) * 1e3)
                load.append((t3 - t2) * 1e3)
            mb = os.path.getsize(f"{timing.dump_dir}/snapshot_0/state.pt") / 1e6
            print(f"snapshot: {mb:.1f} MB a snapshot (fp32 weights, BN statistics, Adam moments); save "
                  f"blocks the loop {statistics.median(block):.1f} ms (host copy), background write "
                  f"{statistics.median(write):.1f} ms, load {statistics.median(load):.1f} ms (host clock, "
                  f"medians of 3; blocking {', '.join(f'{x:.1f}' for x in block)}; write "
                  f"{', '.join(f'{x:.1f}' for x in write)}; load {', '.join(f'{x:.1f}' for x in load)})  [{gpu}]")

            # (b) preempted by the watchdog at itr 1 of epoch 0
            tb = trainer(run_b, rss_limit_mb=1.0, rss_check_interval_steps=2)
            try:
                tb.train(2)
                raise AssertionError("(b): the watchdog did not preempt")
            except SystemExit as exc:
                code = exc.code
            finally:
                tb.close()
            state_b, epoch_b, itr_b = tb.ckpt.load(0)
            if (code, epoch_b, itr_b, state_b["step"]) != (EX_TEMPFAIL, 0, 1, 2):
                raise AssertionError(f"(b): exit {code}, snapshot_{epoch_b} itr {itr_b} step {state_b['step']}")
            print(f"snapshot (b): preempted with exit {code}, snapshot_0 at itr {itr_b} after "
                  f"{state_b['step']} steps")
            del tb, state_b

            # (c) resumed mid-epoch; the main path, counted
            tc = trainer(run_b, continue_train=True, rss_limit_mb=0)
            if (tc.start_epoch, tc.resume_skip) != (0, 2):
                raise AssertionError(f"(c) resumed at {(tc.start_epoch, tc.resume_skip)}, want (0, 2)")
            _zero_counts(fhi)
            tc.train(2)
            torch.cuda.synchronize()
            k1, k2 = fhi.launches, fhi.bwd_launches
            ran = tc.state.step - 2
            if (k1, k2) != (ran, ran) or ran != 2 * tc.steps_per_epoch - 2:
                raise AssertionError(f"(c): K1/K2 launched {k1}/{k2} times in {ran} steps")
            gaps = _state_gaps(_host_copy(tc.state.state_dict()), want)
            if gaps:
                raise AssertionError(f"(c) is not (a) bitwise: {len(gaps)} differ, e.g. {gaps[:8]}")
            print(f"snapshot (c): resumed at (epoch 0, skip 2), {ran} steps, K1 launches {k1}, K2 {k2}; "
                  f"weights, BN statistics, Adam moments and counts, step {tc.state.step} bitwise "
                  f"equal to (a)'s ({len(want['model'])} + {len(want['optimizer']['state'])} x 3 tensors)")

            # (g) a profile window over itr 1-2 of one more epoch; a window
            # whose trace misses a kernel is taken again in the next epoch
            # (torch.profiler on the card now and then drops kernels, see
            # _launch_ms)
            for epoch in (3, 4):
                prof_dir = f"{tmp}/profile{epoch}"
                tc.train(epoch, profile_dir=prof_dir, profile_steps=(1, 3))
                (trace,) = os.listdir(prof_dir)
                with open(f"{prof_dir}/{trace}") as f:
                    kernels = {e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"}
                named = {k: [n for n in kernels if k in n] for k in
                         ("fused_head_integral_fwd_kernel", "dfeat_kernel", "dw_kernel")}
                if all(named.values()):
                    break
            tc.close()
            if not all(named.values()):
                raise AssertionError(f"(g): the trace names no {[k for k, v in named.items() if not v]}")
            print(f"snapshot (g): profile_steps (1, 3) wrote {trace} ({len(kernels)} kernel names), "
                  f"K1 {_kernel_label(named['fused_head_integral_fwd_kernel'][0])}, K2 "
                  f"{_kernel_label(named['dfeat_kernel'][0])} and {_kernel_label(named['dw_kernel'][0])}")
            del tc

            # (d) the Tester from (a)'s snapshot_1
            cfg_a = base.replace(output_dir=run_a)
            dataset = build_dataset(base.data.testset, "test", base, "synthetic", SNAP_TEST)
            live = Tester(cfg_a, dataset=dataset, state=ta.model, num_workers=8, device="cuda")
            from_snap = Tester(cfg_a, test_epoch=1, dataset=dataset, num_workers=8, device="cuda")
            try:
                want_vox = live.predict_voxels()
                _zero_counts(fhi)
                got_vox = from_snap.predict_voxels()
                k1_eval = fhi.launches
            finally:
                live.close()
                from_snap.close()
            if k1_eval != len(from_snap.loader) or not np.array_equal(got_vox, want_vox):
                raise AssertionError(f"(d): K1 {k1_eval} for {len(from_snap.loader)} batches, "
                                     f"{float(np.abs(got_vox - want_vox).max())} voxel from the live model's")
            print(f"snapshot (d): Tester(test_epoch=1) on {SNAP_TEST} samples, K1 launches {k1_eval}; coords "
                  f"bitwise those of Tester(state=model) (spread {float(np.abs(want_vox - want_vox.mean()).max()):.3g})")

            # (e) load_server from (a)'s run
            patches = np.random.RandomState(SEED).randint(0, 256, (2 * MAX_BATCH, *base.data.input_shape, 3))
            patches = patches.astype(np.uint8)
            want_srv = PoseServer(base, ta.model, max_batch=MAX_BATCH, device="cuda").predict_patches(patches)
            served = load_server(base, run_a, max_batch=MAX_BATCH, device="cuda")
            _zero_counts(fhi)
            got_srv = served.predict_patches(patches)
            k1_srv = fhi.launches
            if k1_srv != 2 or not np.array_equal(got_srv, want_srv):
                raise AssertionError(f"(e): K1 {k1_srv}, {float(np.abs(got_srv - want_srv).max())} voxel "
                                     "from PoseServer's")
            print(f"snapshot (e): load_server predict_patches({len(patches)}) bitwise PoseServer's, "
                  f"K1 launches {k1_srv}")
            del served, ta
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
        torch.cuda.empty_cache()

        # (f) the evaluation CLI on (a)'s run, in a subprocess
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "ihpr_tpu_torch.test", "--synthetic", "--output_dir", run_a,
             "--synthetic_size", "64", "--device", "cuda"],
            cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True, timeout=600,
        )
        printed = proc.stdout.strip().splitlines()[-1:] or [""]
        if proc.returncode != 0 or "MPJPE" not in printed[0]:
            raise AssertionError(f"(f): exit {proc.returncode}: {proc.stdout[-1500:]} {proc.stderr[-1500:]}")
        print(f"snapshot (f): python -m ihpr_tpu_torch.test --synthetic --output_dir <a> --synthetic_size 64 "
              f"exit 0 in {time.perf_counter() - t0:.1f} s: {printed[0][:160]}")
    return k1 + k1_eval + k1_srv, k2


def _counts(*mods):
    """(launches, bwd_launches) of each kernel module, in order."""
    return tuple(c for mod in mods for c in (mod.launches, mod.bwd_launches))


def _zero_counts(*mods):
    for mod in mods:
        mod.launches = mod.bwd_launches = 0
        if hasattr(mod, "f32_launches"):
            mod.f32_launches = mod.f32_bwd_launches = 0


def _f32_counts(fhi):
    """(K1-fp32, K2-fp32) launches."""
    return fhi.f32_launches, fhi.f32_bwd_launches


def heatmap_phase(fhi, iv, gpu: str):
    """The heatmap-logits path at full width: h36m3d_r50 (lean BN in train
    mode) takes optimizer steps through model(x) -> soft_argmax_from_heatmap
    -> loss. One counted step must launch K3 and K4 once each and K1/K2 not
    at all; its coords and the heatmap's gradient (K4's dv) are held
    against plain / plain_bwd on the same logits. Batch 128 with bf16
    logits, then batch 32 with fp32 logits. Returns (K3, K4) launches and
    the largest coords and dv differences."""
    from ihpr_tpu_torch.config import get_config
    from ihpr_tpu_torch.data.augment import finalize_patch
    from ihpr_tpu_torch.data.datasets import build_dataset
    from ihpr_tpu_torch.data.pipeline import BatchLoader, WarpedHostBatch, prefetch_to_device
    from ihpr_tpu_torch.models.pose_net import build_pose_net
    from ihpr_tpu_torch.ops.loss import joint_location_loss
    from ihpr_tpu_torch.parallel.train_step import make_optimizer

    base = get_config("h36m3d_r50")
    loader = BatchLoader([build_dataset("Human36M", "train", base, "synthetic", TRAIN_BATCH)],
                         base, TRAIN_BATCH, num_workers=8, seed=SEED)
    try:
        host = next(loader.epoch(0))
    finally:
        loader.close()
    k3 = k4 = 0
    errs, dv_errs = [], []
    for fp32_logits, bsz in ((False, TRAIN_BATCH), (True, TRAIN_BATCH // 4)):
        cfg = base.replace(model=dataclasses.replace(base.model, fp32_logits=fp32_logits))
        gen = torch.Generator().manual_seed(SEED)
        model = build_pose_net(cfg, device="cuda", generator=gen, trainable=True)
        opt, _ = make_optimizer(model, cfg, steps_per_epoch=10)
        hb = WarpedHostBatch(**{f.name: getattr(host, f.name)[:bsz] for f in dataclasses.fields(host)})
        batch, _ = next(prefetch_to_device(iter([hb]), "cuda"))
        labels = (batch["joint_img"], batch["joint_vis"], batch["joints_have_depth"])
        j, d = model.joint_num, model.depth_dim
        with torch.no_grad():
            _peak_heatmaps(model, finalize_patch(batch["patch"], batch["color_scale"], cfg.data), gen)

        def step(keep=None):
            image = finalize_patch(batch["patch"], batch["color_scale"], cfg.data)
            opt.zero_grad(set_to_none=True)
            with model.precision():
                hm = model(image)
                if keep is not None:
                    hm.retain_grad()
                    keep.append(hm)
                coords = iv.soft_argmax_from_heatmap(hm, j, d)
                loss = joint_location_loss(coords, *labels)
                loss.backward()
            opt.step()
            return coords.detach(), loss.detach()

        step()  # warm-up: cuDNN plans, kernel load
        torch.cuda.synchronize()

        # --- the main path, counted: one heatmap-path train step ---
        _zero_counts(fhi, iv)
        keep = []
        coords, loss = step(keep)
        torch.cuda.synchronize()
        counts = _counts(fhi, iv)
        # -----------------------------------------------------------
        if counts != (0, 0, 1, 1):
            raise AssertionError(f"heatmap step launched K1/K2/K3/K4 {counts} times, want (0, 0, 1, 1)")
        k3, k4 = k3 + counts[2], k4 + counts[3]
        hm = keep[0]
        vol = hm.detach().view(bsz, -1, j * d)
        if vol.dtype != (torch.float32 if fp32_logits else torch.bfloat16):
            raise AssertionError(f"heatmap is {vol.dtype} with fp32_logits={fp32_logits}")
        want, m, s = iv.plain(vol, j, d, hm.shape[2])
        err = float((coords - want).abs().max())
        spread = float((want - want.mean()).abs().max())
        cot = coords.clone().requires_grad_()
        (g,) = torch.autograd.grad(joint_location_loss(cot, *labels), cot)
        dv_ref = iv.plain_bwd(vol, m, s, coords, g, j, d, hm.shape[2])
        dv = hm.grad.view_as(vol)
        dv_err = float((dv.float() - dv_ref.float()).abs().max())
        scale = float(dv_ref.float().abs().max())
        if not (err <= TOL_VOXEL and spread > 1.0 and math.isfinite(float(loss))):
            raise AssertionError(f"heatmap step coords {err} voxel from plain (spread {spread}), loss {loss}")
        if dv.dtype != vol.dtype or not dv_err <= TOL_BWD[vol.dtype] * scale:
            raise AssertionError(f"heatmap step dv {dv_err} from plain_bwd (max {scale})")
        errs.append(err)
        dv_errs.append(dv_err)
        del keep, hm, vol, dv, dv_ref
        step_ms = _cuda_ms(step, 2, reps=1)
        print(f"heatmap path, h36m3d_r50 batch {bsz}, {'fp32' if fp32_logits else 'bf16'} logits: one step "
              f"launched K3 {counts[2]}, K4 {counts[3]}, K1/K2 0; coords vs plain {err:.3g} voxel "
              f"(spread {spread:.3g}), dv vs plain_bwd |diff|/max {dv_err / scale:.2e}; loss "
              f"{float(loss):.4f}; device {step_ms:.3f} ms/step, {bsz / step_ms * 1e3:.1f} img/s "
              f"(CUDA events)  [{gpu}]")
        del model, opt, batch
        torch.cuda.empty_cache()
    return k3, k4, max(errs), max(dv_errs)


def noplan_phase(fhi, iv, gpu: str):
    """fused_final_conv_integral on fp32 heads that have no fused plan (C=72,
    not a multiple of 16; D=80, more than 64 bins; J=16, D=1, the head of
    mpii2d_r50, which JAX computes outside any kernel): fp32 logits, then
    K3/K4, forward and backward, against autograd through the fused op's
    plain version; K1/K2 and K1/K2-fp32 do not launch. Returns (K3, K4)
    launches and the largest coords difference."""
    b, h, w = 8, 64, 64
    k3 = k4 = 0
    errs = []
    for c, j, d in ((72, 18, 64), (256, 18, 80), (256, 16, 1)):
        feat, kernel, bias = _head_inputs(b, h * w, c, j * d, torch.float32, 12)
        if fhi.fused_supported(j, d, h * w, c, feat.dtype):
            raise AssertionError(f"C={c}, J={j}, D={d} fp32 should have no fused plan")
        leaves = [feat.view(b, h, w, c).clone().requires_grad_(),
                  kernel.clone().requires_grad_(), bias.clone().requires_grad_()]
        g = torch.randn(b, j, 3, generator=torch.Generator().manual_seed(13)).cuda()
        # --- the main path, counted ---
        _zero_counts(fhi, iv)
        coords = fhi.fused_final_conv_integral(*leaves, j, d)
        coords.backward(g)
        torch.cuda.synchronize()
        counts = _counts(fhi, iv) + _f32_counts(fhi)
        # ------------------------------
        if counts != (0, 0, 1, 1, 0, 0):
            raise AssertionError(f"no-plan C={c} D={d} launched K1/K2/K3/K4/K1-fp32/K2-fp32 {counts} times")
        k3, k4 = k3 + counts[2], k4 + counts[3]
        ref_leaves = [t.clone().requires_grad_() for t in (feat, kernel, bias)]
        ref = fhi.plain(*ref_leaves, j, d, w)[0]
        ref.backward(g)
        err = float((coords.detach() - ref.detach()).abs().max())
        if not (err <= TOL_VOXEL and float((ref.detach() - ref.detach().mean()).abs().max()) > 1.0):
            raise AssertionError(f"no-plan C={c} D={d}: coords {err} voxel from plain")
        # db can cancel to ~0 (at D = 1 it is 0 exactly): 1e-4 of its summands' bound.
        ext = torch.tensor([w - 1, h - 1, d - 1], dtype=torch.float32, device="cuda")
        db_atol = 1e-4 * float((g.abs() * ext).sum(-1).sum(0).max())
        rel = []
        for name, a, r in zip(("dfeat", "dW", "db"), leaves, ref_leaves):
            diff = float((a.grad.reshape(r.grad.shape) - r.grad).abs().max())
            scale = float(r.grad.abs().max())
            if not diff <= TOL_NOPLAN_GRAD * scale + (db_atol if name == "db" else 0.0):
                raise AssertionError(f"no-plan C={c} D={d} {name}: {diff} from plain (max {scale})")
            rel.append(f"{name} {diff / scale:.2e}")
        errs.append(err)
        print(f"no-plan route C={c} J={j} D={d} (fp32, B={b}): K3 {counts[2]}, K4 {counts[3]}, K1/K2 and "
              f"K1/K2-fp32 0; coords vs plain {err:.3g} voxel; grads |diff|/max " + ", ".join(rel))
    del feat, kernel, bias, leaves, ref_leaves, coords, ref
    torch.cuda.empty_cache()
    return k3, k4, max(errs)


# --- 9b: K1-fp32 / K2-fp32 (3xTF32) on the fp32 heads JAX fuses ------------------

F32_K1_BATCHES = (32, 64, 128)  # K1-fp32 timed at each; checked against float64 and repeated at 64 and 128
F32_K2_BATCHES = (32, 128)  # K2-fp32 checked and timed at each
F32_TRAIN_BATCH = 32  # h36m3d_r50_fp32's batch_size_per_device: the kernels line's times
TOL_F32_F64 = 2.0  # K1-fp32's largest distance from float64 plain, at most this times the no-plan route's
PEAK_TF32_FLOPS = 494.7e12  # dense TF32 on the tensor cores (H100 SXM, 700 W)


def f32_bound(b, products, hw=None):
    """(ms, bound_by) of K1-fp32 (1 product) or K2-fp32 (3: the function's
    dfeat, dW and the logits once; 4 with the logits recomputed in each of
    its two kernels, its own work) at (b, hw, 256) x (256, 1152): three
    TF32 passes a product on the tensor cores (3xTF32) against reading feat
    and W once, and for K2 writing dfeat and dW once, in fp32."""
    hw = _HEAD[0] if hw is None else hw
    _, c, jd = _HEAD
    flops = 3 * products * 2 * b * hw * c * jd
    nbytes = (b * hw * c + c * jd) * 4 * (1 if products == 1 else 2)
    t_ops, t_bytes = flops / PEAK_TF32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


MMA_RATE_BLOCKS, MMA_RATE_ITERS = 528, 4096  # 4 CTAs an SM
WGMMA_RATE_BLOCKS, WGMMA_RATE_ITERS = 132, 2048  # one CTA of 2 warpgroups an SM


def tensor_core_rates():
    """TFLOP/s of the tensor cores' paths alone (no loads; tf32x3_selftest.cu's
    rate kernels), CUDA events: mma.sync m16n8k8 TF32 and m16n8k16 bf16 (what
    an mma.sync design of K1/K2-fp32 could reach at most), then wgmma
    m64n64k8 and m64n32k8 TF32 with A from registers (what K1/K2-fp32's
    products can reach at most)."""
    from ihpr_tpu_torch.ops import _build

    lib = _build.load("tf32x3_selftest")
    for fn in (lib.ihpr_tf32x3_mma_rate, lib.ihpr_tf32x3_wgmma_rate):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out = torch.empty(max(MMA_RATE_BLOCKS, WGMMA_RATE_BLOCKS) * 256, device="cuda")
    runs = [(lib.ihpr_tf32x3_mma_rate, MMA_RATE_BLOCKS, MMA_RATE_ITERS, 0, MMA_RATE_BLOCKS * 8 * 8 * 2048),
            (lib.ihpr_tf32x3_mma_rate, MMA_RATE_BLOCKS, MMA_RATE_ITERS, 1, MMA_RATE_BLOCKS * 8 * 8 * 4096),
            (lib.ihpr_tf32x3_wgmma_rate, WGMMA_RATE_BLOCKS, WGMMA_RATE_ITERS, 64, WGMMA_RATE_BLOCKS * 2 * 8 * 65536),
            (lib.ihpr_tf32x3_wgmma_rate, WGMMA_RATE_BLOCKS, WGMMA_RATE_ITERS, 32, WGMMA_RATE_BLOCKS * 2 * 8 * 32768)]
    rates = []
    for fn, blocks, iters, arg, flops_per_iter in runs:
        def run():
            err = fn(out.data_ptr(), blocks, iters, arg, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"tf32x3_selftest rate launch failed: CUDA error {err}")

        rates.append(flops_per_iter * iters / _cuda_ms(run, 3, reps=3) / 1e9)
    return rates


def f32_kernel_phase(fhi, iv, gpu: str):
    """K1-fp32 and K2-fp32 at the fp32 flagship head (64x64, C=256, J=18,
    D=64: h36m3d_r50_fp32's and parity_r50's), where the port took cuBLAS
    fp32 + K3/K4 before (the no-plan route, timed here as the library).
    (1) The head through fused_final_conv_integral at B=8, forward and
    backward, counted: K1-fp32 and K2-fp32 once each and nothing else;
    coords against plain, gradients against plain_bwd. (2) K1-fp32 at
    B = 64 and 128: within TOL_VOXEL of plain; its largest distance from
    plain in float64 at most TOL_F32_F64 times the no-plan route's on the
    same inputs ("highest" holds); bitwise equal over K1_REPEATS launches.
    (3) K2-fp32 at F32_K2_BATCHES against plain_bwd within TOL_BWD (fp32)
    of each result's largest, two runs bitwise equal. (4) Times in turns:
    K1-fp32, plain and the no-plan route's forward (cuBLAS addmm, TF32 off,
    + K3) at F32_K1_BATCHES; K2-fp32, plain_bwd and the no-plan route's
    backward (K4 + two cuBLAS matmuls + db's sum, on saved logits) at
    F32_K2_BATCHES. (5) Each call's launches' device time at
    F32_TRAIN_BATCH (torch.profiler). Returns (K1-fp32, K2-fp32) launches
    of (1), the largest differences from plain, and {b: (kernel, plain,
    library) ms} of each."""
    from ihpr_tpu_torch.ops import _build

    hw, w, c, j, d = 64 * 64, 64, 256, 18, 64
    # (1) the fused op on the fp32 head, counted
    feat, kernel, bias = _head_inputs(8, hw, c, j * d, torch.float32, 12)
    if not fhi.fused_supported(j, d, hw, c, feat.dtype):
        raise AssertionError("the fp32 flagship head should take K1/K2-fp32")
    leaves = [feat.view(8, 64, w, c).clone().requires_grad_(), kernel.clone().requires_grad_(),
              bias.clone().requires_grad_()]
    g = torch.randn(8, j, 3, generator=torch.Generator().manual_seed(13)).cuda()
    _zero_counts(fhi, iv)
    coords = fhi.fused_final_conv_integral(*leaves, j, d)
    coords.backward(g)
    torch.cuda.synchronize()
    counts = _counts(fhi, iv) + _f32_counts(fhi)
    if counts != (0, 0, 0, 0, 1, 1):
        raise AssertionError(f"fp32 flagship head launched K1/K2/K3/K4/K1-fp32/K2-fp32 {counts} times")
    coords_p = fhi.plain(feat, kernel, bias, j, d, w)[0]
    _, m, s = fhi.kernel_stats(feat, kernel, bias, j, d, w)  # the m and s autograd saved
    err = float((coords.detach() - coords_p).abs().max())
    if not (err <= TOL_VOXEL and float((coords_p - coords_p.mean()).abs().max()) > 1.0):
        raise AssertionError(f"fp32 flagship head through the fused op: coords {err} voxel from plain")
    got = tuple(t.grad.reshape(r.shape) for t, r in zip(leaves, (feat, kernel, bias)))
    k2_errs = [check_bwd(fhi, (feat, kernel, bias, m, s, coords.detach(), g), j, d, w, TOL_BWD[torch.float32],
                         "fp32 flagship head (B=8), autograd's gradients of the fused op",
                         want=fhi.plain_bwd(feat, kernel, bias, m, s, coords.detach(), g, j, d, w))[0]]
    again = fhi.kernel_bwd(feat, kernel, bias, m, s, coords.detach(), g, j, d, w)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("autograd's fp32 head gradients are not K2-fp32's output on the saved inputs")
    print(f"fp32 flagship head (8, {hw}, {c}) through fused_final_conv_integral: K1-fp32 {counts[4]}, K2-fp32 "
          f"{counts[5]}, K1-K4 0; coords vs plain {err:.3g} voxel")
    k1_errs = [err]
    del leaves, coords, got, again

    # The ceiling of their products: the tensor cores' paths alone.
    rates = tensor_core_rates()
    peak = PEAK_TF32_FLOPS / 1e12
    print(f"tensor cores alone on this card (tf32x3_selftest.cu): mma.sync m16n8k8 TF32 {rates[0]:.1f} TFLOP/s "
          f"({rates[0] / peak:.3f} of dense TF32's {peak:g}; {MMA_RATE_BLOCKS} CTAs of 8 warps), m16n8k16 bf16 "
          f"{rates[1]:.1f}; wgmma TF32, A from registers ({WGMMA_RATE_BLOCKS} CTAs of 2 warpgroups): m64n64k8 "
          f"{rates[2]:.1f} ({rates[2] / peak:.3f}), m64n32k8 {rates[3]:.1f} ({rates[3] / peak:.3f})  [{gpu}]")

    # The pre-pass bitwise its plain version, on the flagship head's weight.
    wt_want, w_want = fhi.split_planes(kernel, j, d)
    split = _build.load(fhi._F32_BWD_LIB).ihpr_fused_head_integral_bwd_f32_split
    split.restype = ctypes.c_int
    split.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    planes = torch.full((4, j * 64, c), float("nan"), device="cuda")
    if split(kernel.data_ptr(), planes.data_ptr(), c, j, d, torch.cuda.current_stream().cuda_stream):
        raise RuntimeError("split_planes_kernel launch failed")
    torch.cuda.synchronize()
    same = (torch.equal(planes[:2].view(torch.int32), wt_want.view(torch.int32))
            and torch.equal(planes[2:].reshape(w_want.shape).view(torch.int32), w_want.view(torch.int32)))
    print(f"split_planes_kernel ({c}, {j * d}) -> 4 planes of ({j * 64}, {c}): bitwise split_planes: {same}")
    if not same:
        raise AssertionError("the fp32 kernels' pre-pass differs from split_planes")
    del planes, wt_want, w_want

    # (2) K1-fp32 against plain, float64 and itself; (4) its times
    fwd = {}
    for b in F32_K1_BATCHES:
        args = _head_inputs(b, hw, c, j * d, torch.float32, SEED)
        flat = args[0].view(-1, c)

        def library():
            with fhi.no_tf32():
                logits = torch.addmm(args[2], flat, args[1]).view(b, hw, j * d)
            return iv.kernel_stats(logits, j, d, w)

        if b in (64, 128):
            k1_errs.append(check_kernel(fhi, *args, j, d, w))
            got, route = fhi.kernel_stats(*args, j, d, w)[0], library()[0]
            want = fhi.plain(*(t.double() for t in args), j, d, w)[0]
            e_k, e_r = (float((x.double() - want).abs().max()) for x in (got, route))
            del want
            differ = repeat_check(fhi, args, j, d, w, K1_REPEATS)
            print(f"K1-fp32 ({b}, {hw}, {c}): max|dcoords| from plain {k1_errs[-1]:.3g} voxel; from float64 "
                  f"plain {e_k:.3g} voxel, the no-plan route's {e_r:.3g} (bar {TOL_F32_F64:g}x); {differ} of "
                  f"{K1_REPEATS} repeated launches differ bitwise from the first")
            if not e_k <= TOL_F32_F64 * e_r:
                raise AssertionError(f"K1-fp32 at batch {b}: {e_k} voxel from float64, the no-plan route {e_r}")
            if differ:
                raise AssertionError(f"K1-fp32 at batch {b}: {differ} of {K1_REPEATS} repeated launches differ")
        runs = {"plain": (lambda: fhi.plain(*args, j, d, w), []),
                "kernel": (lambda: fhi.kernel_stats(*args, j, d, w), []),
                "library": (library, [])}
        for name in ("plain", "kernel", "library", "library", "kernel", "plain"):  # in turns
            fn, out = runs[name]
            out.append(_cuda_ms(fn, 3 if name == "plain" else 5, reps=3))
        fwd[b] = tuple(statistics.median(runs[k][1]) for k in ("kernel", "plain", "library"))
        bound = f32_bound(b, 1)[0]
        print(f"K1-fp32 ({b}, {hw}, {c}) x ({c}, {j * d}): kernel {fwd[b][0]:.4f} ms ({3 * 2 * b * hw * c * j * d / fwd[b][0] / 1e9:.1f} "
              f"TFLOP/s of TF32 passes; bound {bound:.4f} ms, {bound / fwd[b][0]:.3f} of it), plain {fwd[b][1]:.4f} ms, "
              f"no-plan route (cuBLAS fp32 + K3) {fwd[b][2]:.4f} ms  [{gpu}]")
        del args, flat, runs
        torch.cuda.empty_cache()

    # (3) K2-fp32 against plain_bwd and itself; (4) its times
    bwd = {}
    for b in F32_K2_BATCHES:
        args = _bwd_inputs(fhi, b, hw, c, j, d, w, torch.float32, 4)
        err, got = check_bwd(fhi, args, j, d, w, TOL_BWD[torch.float32], f"fp32 ({b}, {hw}, {c})")
        k2_errs.append(err)
        if not all(torch.equal(x, y) for x, y in zip(got, fhi.kernel_bwd(*args, j, d, w))):
            raise AssertionError(f"K2-fp32 at batch {b} is not deterministic: two runs differ")
        feat, kernel, bias, m, s, coords, g = args
        flat = feat.view(-1, c)
        with fhi.no_tf32():
            logits = torch.addmm(bias, flat, kernel).view(b, hw, j * d)

        def library():
            dv = iv.kernel_bwd(logits, m, s, coords, g, j, d, w).view(-1, j * d)
            with fhi.no_tf32():
                return dv @ kernel.t(), flat.t() @ dv, dv.sum(0)

        runs = {"plain": (lambda: fhi.plain_bwd(*args, j, d, w), []),
                "kernel": (lambda: fhi.kernel_bwd(*args, j, d, w), []),
                "library": (library, [])}
        for name in ("plain", "kernel", "library", "library", "kernel", "plain"):  # in turns
            fn, out = runs[name]
            out.append(_cuda_ms(fn, 1 if name == "plain" else 3, reps=3))
        bwd[b] = tuple(statistics.median(runs[k][1]) for k in ("kernel", "plain", "library"))
        bound, bound4 = f32_bound(b, 3)[0], f32_bound(b, 4)[0]
        print(f"K2-fp32 ({b}, {hw}, {c}) x ({c}, {j * d}): kernel {bwd[b][0]:.4f} ms ({9 * 2 * b * hw * c * j * d / bwd[b][0] / 1e9:.1f} "
              f"TFLOP/s of TF32 passes over the function's 3 products; bound {bound:.4f} ms, {bound / bwd[b][0]:.3f} "
              f"of it; over the 4 it computes {bound4:.4f} ms, {bound4 / bwd[b][0]:.3f}), plain_bwd {bwd[b][1]:.4f} ms, "
              f"no-plan route (K4 + cuBLAS fp32) {bwd[b][2]:.4f} ms; two runs bitwise equal  [{gpu}]")
        del args, feat, flat, logits, runs, got
        torch.cuda.empty_cache()
    # (5) each call's launches
    args = _bwd_inputs(fhi, F32_TRAIN_BATCH, hw, c, j, d, w, torch.float32, 4)
    for label, fn, expect in (
            ("K1-fp32", lambda: fhi.kernel_stats(*args[:3], j, d, w), ("fwd_f32_kernel",)),
            ("K2-fp32", lambda: fhi.kernel_bwd(*args, j, d, w), ("dfeat_kernel", "dw_kernel"))):
        ms = _launch_ms(fn, 3, expect)  # the kernel's launches, not the wrapper's torch ops
        parts = ", ".join(f"{_kernel_label(k)} {v:.4f} ms" for k, v in ms.items()
                          if not _kernel_label(k).startswith("at::"))
        print(f"{label}'s launches per call at B={F32_TRAIN_BATCH} (torch.profiler, 3 calls): "
              f"{parts or 'not measured'}  [{gpu}]")
    del args
    torch.cuda.empty_cache()
    return counts[4], counts[5], max(k1_errs), max(k2_errs), fwd, bwd


def eval_phase(fhi, iv, gpu: str):
    """The Tester on h36m3d_r50 (EVAL_SAMPLES synthetic H36M test samples,
    batch 128, the last padded, flip-test; a bf16 head: K1) and on
    mpii2d_r50 (64 samples, D=1, PCKh; an fp32 head: logits + K3), seeded
    weights with peaked heatmaps: the head's kernel launches once per eval
    batch and nothing else launches; every row of the predictions that
    ``evaluate`` scored (the padded last batch's included) against the
    fused op's plain version on the loader's batches; metrics finite; the
    result files written. Returns K1 and K3 launches and the largest coords
    difference on each route (K1's, K3's)."""
    from ihpr_tpu_torch.config import get_config
    from ihpr_tpu_torch.data import skeletons
    from ihpr_tpu_torch.data.augment import finalize_patch
    from ihpr_tpu_torch.data.datasets import build_dataset
    from ihpr_tpu_torch.data.pipeline import prefetch_to_device
    from ihpr_tpu_torch.engine.tester import Tester
    from ihpr_tpu_torch.models.pose_net import build_pose_net

    k1 = k3 = 0
    errs = {"K1": [], "K3": []}
    with tempfile.TemporaryDirectory() as tmp:
        for name, route, n, key, files in (
            ("h36m3d_r50", "K1", EVAL_SAMPLES, "MPJPE total",
             ("metrics_Human36M.json", "preds_Human36M.npy", "bbox_root_pose_h36m_output.json")),
            ("mpii2d_r50", "K3", 64, "PCKh@0.5", ("metrics_MPII.json", "preds_MPII.npy", "pred.mat")),
        ):
            cfg = get_config(name).replace(output_dir=f"{tmp}/{name}")
            gen = torch.Generator().manual_seed(SEED)
            model = build_pose_net(cfg, device="cuda", generator=gen)
            dataset = build_dataset(cfg.data.testset, "test", cfg, "synthetic", n)
            tester = Tester(cfg, dataset=dataset, state=model, num_workers=8, device="cuda")
            try:
                host = list(tester.loader.epoch())
                batch, _ = next(prefetch_to_device(iter(host[:1]), "cuda"))
                with torch.inference_mode():
                    image = finalize_patch(batch["patch"], batch["color_scale"], cfg.data)
                _peak_heatmaps(tester.model, image, gen)
                tester.eval_step(batch)  # warm-up: cuDNN plans
                torch.cuda.synchronize()
                scored = []

                def predict_and_keep(predict=tester.predict_voxels):
                    scored.append(predict())
                    return scored[-1]

                tester.predict_voxels = predict_and_keep  # keeps what evaluate scores

                # --- the main path, counted: Tester.evaluate ---
                _zero_counts(fhi, iv)
                t0 = time.perf_counter()
                metrics = tester.evaluate()
                t_eval = time.perf_counter() - t0
                counts = _counts(fhi, iv)
                # -----------------------------------------------
                batches = len(tester.loader)
                head = tester.model.head
                want = (batches, 0, 0, 0) if route == "K1" else (0, 0, batches, 0)
                if counts != want:
                    raise AssertionError(f"{name} eval launched K1/K2/K3/K4 {counts}, want {want}")
                k1, k3 = k1 + counts[0], k3 + counts[2]
                (vox,) = scored
                perm = torch.as_tensor(skeletons.get_skeleton(cfg.data.testset).flip_permutation(), device="cuda")
                ref = np.full_like(vox, np.nan)
                for hb in host:
                    ref[hb.sample_idx] = _reference_coords(cfg, tester.model, perm, hb.patch, fhi)
                err = float(np.abs(vox - ref).max())
                spread = float(np.abs(ref - ref.mean()).max())
                if not (vox.shape == (n, tester.dataset.joint_num, 3) and err <= 2 * TOL_VOXEL and spread > 1.0):
                    raise AssertionError(f"{name} eval coords {vox.shape}, {err} voxel from plain (spread {spread})")
                errs[route].append(err)
                missing = [f for f in files if not os.path.exists(f"{cfg.output_dir}/result/{f}")]
                if not math.isfinite(metrics[key]) or missing:
                    raise AssertionError(f"{name} eval: {key} {metrics[key]}, missing {missing}")
                print(f"eval {name}: {n} samples in {batches} batches of {cfg.eval.batch_size_per_device} "
                      f"(flip-test {cfg.eval.flip_test}), {str(head.dtype)[6:]} head, K1 launches "
                      f"{counts[0]}, K3 {counts[2]}; {key} "
                      f"{metrics[key]:.2f}; all {n} scored rows vs plain {err:.3g} voxel (spread {spread:.3g}); "
                      f"wrote {', '.join(files)}")
                wait = tester.loader_wait_s
                print(f"eval {name}: Tester.evaluate {t_eval:.3f} s, {n / t_eval:.1f} img/s (host clock, "
                      f"loader included); waiting on the loader {wait * 1e3 / batches:.3f} ms per batch, "
                      f"{wait / t_eval:.2f} of the evaluate wall time  [{gpu}]")
            finally:
                tester.close()
            del model, tester
            torch.cuda.empty_cache()
    return k1, k3, max(errs["K1"]), max(errs["K3"])


# --- K5-K8: the conv + BN-statistics kernels -----------------------------------

# One h36m3d_r50 train step at batch 128 (256x256 input, bf16): the 1x1
# route's shapes of K5/K6, (M, K, N, prologue, launches with both fused
# flags, launches with fused_1x1 alone), and the conv3 route's K7/K8 shape
# (B, H, W, C, N) with its launches (both flags).
MM_STEP = (
    (524288, 64, 64, False, 1, 1),    # layer1_0 conv1
    (524288, 256, 64, False, 2, 2),   # layer1_1, layer1_2 conv1
    (524288, 64, 256, True, 3, 3),    # layer1_* conv3 (bn2 prologue)
    (524288, 256, 128, False, 1, 1),  # layer2_0 conv1
    (131072, 512, 128, False, 3, 3),  # layer2_1 ... layer2_3 conv1
    (131072, 128, 512, True, 4, 4),   # layer2_* conv3
    (131072, 512, 256, False, 1, 1),  # layer3_0 conv1
    (32768, 256, 1024, True, 1, 6),   # layer3_0 conv3 (fused_1x1 alone: layer3_1 ... 3_5 too)
    (32768, 1024, 256, False, 0, 5),  # layer3_1 ... layer3_5 conv1 (fused_1x1 alone)
)
CONV_STEP = ((128, 16, 16, 256, 256), 5)  # layer3_1 ... layer3_5 conv2
# A fused_1x1 step of h36m3d_r50_fp32 with lean BN (batch 32) runs K5-fp32 /
# K6-fp32 at ihpr_tpu_torch/tools/f32_breakdown.py:BN_STEP's 8 shapes, 16
# launches each. JAX's conv3 route takes an fp32 block only where one
# image's plane fits its VMEM budget beside the nine fp32 weight blocks: at
# a 128x128 frame stage 3's 8x8 planes (layer3_1 ... layer3_5 conv2, 5
# launches of K7/K8-fp32 a step with both fused flags, phase 7n), at 256x256
# none. CONV_F32 keeps v1's 16x16 row, timed only.
CONV_F32_STEP = ((32, 8, 8, 256, 256), 5)
CONV_F32 = (32, 16, 16, 256, 256)  # K7/K8-fp32, timed only: the R50 stage-3 conv2 at batch 32, 256x256
# The kernels line's names of K5-fp32 / K6-fp32 and K7-fp32 / K8-fp32, whose
# sources are the headers both entry points include.
F32_FWD_NAME, F32_BWD_NAME = "matmul_bn_fwd_f32", "matmul_bn_bwd_f32"
CONV_F32_FWD_NAME, CONV_F32_BWD_NAME = "conv_bn_fwd_f32", "conv_bn_bwd_f32"
SOURCES = {F32_FWD_NAME: "ihpr_tpu_torch/ops/csrc/matmul_bn_f32.cuh",
           F32_BWD_NAME: "ihpr_tpu_torch/ops/csrc/matmul_bn_f32.cuh",
           CONV_F32_FWD_NAME: "ihpr_tpu_torch/ops/csrc/conv3_f32.cuh",
           CONV_F32_BWD_NAME: "ihpr_tpu_torch/ops/csrc/conv3_f32.cuh"}
# Peak rates of one H100 SXM (NVIDIA's data sheet, dense) for the bounds.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def _bound(flops: float, nbytes: float, dtype=torch.bfloat16, elementwise: bool = False):
    """(least ms, what bounds it) for work of ``flops`` operations in
    ``dtype`` moving ``nbytes`` bytes. Matrix products in fp32 count as
    3xTF32 on the tensor cores (three TF32 passes a product, f32_bound's
    rule); ``elementwise`` fp32 work runs on the FMA units."""
    if dtype == torch.bfloat16:
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
    elif elementwise:
        t_ops = flops / PEAK_FP32_FLOPS * 1e3
    else:
        t_ops = 3 * flops / PEAK_TF32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _bn_work(x_shape, k, n, taps, item):
    """(fwd flops, fwd bytes, bwd flops, bwd bytes) of K5/K7 and K6/K8: each
    input read once and each output written once (mul/add and the (N,)
    statistics are noise); the backward's two products (dx and dw)."""
    m = math.prod(x_shape)
    prod = 2 * m * k * n * taps
    fwd_bytes = (m * k + taps * k * n + m * n) * item
    bwd_bytes = (m * k + taps * k * n + 2 * m * n + m * k) * item + taps * k * n * 4
    return prod, fwd_bytes, 2 * prod, bwd_bytes


def _bn_inputs(x_shape, k, n, taps, dtype, prologue, seed):
    """x, w ((K, N) or (9, K, N)), mul, add, dy, ds1, ds2 on the card, with
    the statistics' cotangents of the size a BN backward gives them."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(*x_shape, k, generator=g).to("cuda", dtype)
    w = (torch.randn(taps, k, n, generator=g) / (taps * k) ** 0.5).to("cuda", dtype)
    mul = (torch.rand(k, generator=g) + 0.5).cuda() if prologue else None
    add = (torch.randn(k, generator=g) * 0.2).cuda() if prologue else None
    dy = torch.randn(*x_shape, n, generator=g).to("cuda", dtype)
    ds1 = (torch.randn(n, generator=g) * 0.1).cuda()
    ds2 = (torch.randn(n, generator=g) * 0.01).cuda()
    return x, (w[0] if taps == 1 else w), mul, add, dy, ds1, ds2


def compare_bn(label, names, got, want, dtype, rows):
    """Kernel results against plain ones on the same inputs: y and dx
    within one bf16 step of |plain| (fp32: 1e-4 of the largest, since cuDNN
    may take a Winograd or FFT algorithm for the plain conv); s1 within
    1e-4 of its Cauchy-Schwarz bound sqrt(rows * s2) and s2 within 1e-4
    relative (fp32 sums of the same accumulator in another order); dw,
    dmul, dadd within TOL_BWD of their largest. Returns {name: max|diff|}."""
    plain = dict(zip(names, want))
    errs, rel = {}, []
    for name, a, b in zip(names, got, want):
        if b is None:
            if a is not None:
                raise AssertionError(f"{label} {name}: kernel gave a result where plain gives None")
            continue
        if a.dtype != b.dtype or a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{label} {name}: {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
        diff = (a.double() - b.double()).abs()
        scale = float(b.double().abs().max())
        if name in ("y", "dx") and dtype == torch.bfloat16:
            ok = bool((diff <= 2.0**-7 * b.double().abs() + 1e-6 * scale).all())
        elif name == "s1":
            scale = float((rows * plain["s2"].double()).sqrt().max())
            ok = float(diff.max()) <= 1e-4 * scale
        elif name == "s2":
            ok = float(diff.max()) <= 1e-4 * scale
        else:
            ok = float(diff.max()) <= TOL_BWD[dtype] * scale
        if not ok:
            raise AssertionError(f"{label} {name}: max|diff| {float(diff.max())} (scale {scale})")
        errs[name] = float(diff.max())
        rel.append(f"{name} {errs[name] / scale if scale else 0.0:.1e}")
    print(f"{label}: |diff|/scale " + ", ".join(rel))
    return errs


FWD_NAMES, BWD_NAMES = ("y", "s1", "s2"), ("dx", "dw", "dmul", "dadd")


def check_bn(mod, args, label):
    """Both kernels against the plain versions on the same inputs (the
    backward takes the plain forward's y). Returns max |y diff|, |dx diff|."""
    x, w, mul, add, dy, ds1, ds2 = args
    want = mod.plain(x, w, mul, add)
    bwd = (x, w, mul, add, want[0], dy, ds1, ds2)
    got = (*mod.kernel_fwd(x, w, mul, add), *mod.kernel_bwd(*bwd))
    torch.cuda.synchronize()
    rows = want[0].numel() // want[0].shape[-1]
    errs = compare_bn(label, FWD_NAMES + BWD_NAMES, got, (*want, *mod.plain_bwd(*bwd)), x.dtype, rows)
    return errs["y"], errs["dx"]


def _library_mm(x, w, mul, add, dy, ds1, ds2):
    """The same two functions through cuBLAS in x's dtype (torch.matmul)
    and elementwise PyTorch: a yardstick only, the port never calls it."""
    pre = x if mul is None else torch.addcmul(add.to(x.dtype), x, mul.to(x.dtype))
    a = x if mul is None else torch.relu(pre)
    y = a @ w

    def fwd():
        yf = (a @ w).float()
        return yf.sum(0), (yf * yf).sum(0)

    def bwd():
        gc = (dy.float() + ds1 + 2 * y.float() * ds2).to(x.dtype)
        da = gc @ w.t()
        if mul is not None:
            t = da * (pre > 0)
            return t * mul.to(x.dtype), a.t() @ gc, (t * x).float().sum(0), t.float().sum(0)
        return da, a.t() @ gc

    return fwd, bwd


def _library_conv(x, w9, mul, add, dy, ds1, ds2):
    """The same through cuDNN in x's dtype (conv2d and its two backward
    convolutions) and elementwise PyTorch: a yardstick only."""
    import torch.nn.functional as F

    c, n = w9.shape[1], w9.shape[2]
    wt = w9.reshape(3, 3, c, n).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    xn = x.permute(0, 3, 1, 2)
    pre = xn if mul is None else torch.addcmul(add.to(x.dtype)[:, None, None], xn, mul.to(x.dtype)[:, None, None])
    a = xn if mul is None else torch.relu(pre)
    y = F.conv2d(a, wt, padding=1)
    gn = dy.permute(0, 3, 1, 2)

    def fwd():
        yf = F.conv2d(a, wt, padding=1).float()
        return yf.sum((0, 2, 3)), (yf * yf).sum((0, 2, 3))

    def bwd():
        gc = (gn.float() + ds1[:, None, None] + 2 * y.float() * ds2[:, None, None]).to(x.dtype)
        da = torch.nn.grad.conv2d_input(a.shape, wt, gc, padding=1)
        dw = torch.nn.grad.conv2d_weight(a, wt.shape, gc, padding=1)
        if mul is not None:
            t = da * (pre > 0)
            return (t * mul.to(x.dtype)[:, None, None], dw, (t * xn).float().sum((0, 2, 3)),
                    t.float().sum((0, 2, 3)))
        return da, dw

    return fwd, bwd


def _time_bn(mod, args, library):
    """Device ms of the kernels, the plain versions and the library
    composition, forward and backward, on the same inputs, in turns."""
    x, w, mul, add, dy, ds1, ds2 = args
    y = mod.kernel_fwd(x, w, mul, add)[0]
    lib_fwd, lib_bwd = library(*args)
    runs = {
        "kernel_fwd": (lambda: mod.kernel_fwd(x, w, mul, add), 10, []),
        "kernel_bwd": (lambda: mod.kernel_bwd(x, w, mul, add, y, dy, ds1, ds2), 10, []),
        "plain_fwd": (lambda: mod.plain(x, w, mul, add), 2, []),
        "plain_bwd": (lambda: mod.plain_bwd(x, w, mul, add, y, dy, ds1, ds2), 2, []),
        "library_fwd": (lib_fwd, 10, []),
        "library_bwd": (lib_bwd, 10, []),
    }
    for kind in ("fwd", "bwd"):
        for name in ("plain", "kernel", "library", "library", "kernel", "plain"):  # in turns
            fn, n, out = runs[f"{name}_{kind}"]
            out.append(_cuda_ms(fn, n, reps=2))
    return {k: statistics.median(v[2]) for k, v in runs.items()}


def _launch_ms(fn, calls: int = 3, expect: tuple = ()) -> dict:
    """{kernel name: device ms per launch} of the CUDA kernels fn launches,
    averaged over ``calls`` calls (torch.profiler's key_averages; fn runs
    once before, as a warm-up). On the card a profile now and then misses
    kernels: one caught none, another only the first of a call's three. So
    a profile that caught no kernel, or none whose name holds one of the
    fragments in ``expect``, is taken again, at most six times in all; the
    caller checks what the last one caught."""
    fn()
    torch.cuda.synchronize()
    for _ in range(6):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ms = {e.key: e.self_device_time_total / e.count / 1e3 for e in prof.key_averages()
              if e.self_device_time_total > 0}
        if ms and all(any(frag in name for name in ms) for frag in expect):
            break
    return ms


def _kernel_label(name: str) -> str:
    """A profiler kernel name without its return type, anonymous namespace
    and arguments."""
    return name.removeprefix("void ").replace("(anonymous namespace)::", "").split("(")[0]


def _host_us(fn, n: int = 50) -> float:
    """Host time to enqueue one call of fn, in us (median of 3 runs of n
    calls), with the card kept busy (torch.cuda._sleep) so that no call
    waits on it."""
    fn()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(5e8))
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def conv_breakdown(cb, args, gpu: str):
    """Where one bf16 K7 call and one K8 call spend their time: each
    sub-launch's device ms (torch.profiler, 3 calls) beside its own bound,
    with TFLOP/s for the products and GB/s for the passes over memory; their
    sum beside the wrapper's host time to enqueue one call."""
    x, w9, mul, add, dy, ds1, ds2 = args
    m, c, n = x.numel() // x.shape[-1], x.shape[-1], w9.shape[-1]
    conv = 2.0 * m * c * n * 9  # flops of one of the three products
    y = cb.kernel_fwd(x, w9, mul, add)[0]
    # (kernel name, label, launches per call, flops, bytes) in launch order.
    work = {
        "K7": [("prep_kernel", "prologue pass a", 1, 0, 4 * m * c),
               ("gemm_kernel<true", "y GEMM + s1/s2 partials", 1, conv, 2 * (m * c + m * n + 9 * c * n)),
               ("reduce_rows", "s1/s2 reduce", 1, 0, 0)],
        "K8": [("prep_kernel", "gc + prologue pass", 1, 0, 4 * m * c + 6 * m * n),
               ("gemm_kernel<false", "da GEMM + prologue backward", 1, conv, 2 * (m * n + 2 * m * c + 9 * c * n)),
               ("dw_kernel", "dw GEMM partials", 1, conv, 2 * (m * c + m * n)),
               ("reduce_rows", "dmul/dadd + dw reduces", 2, 0, 0)],
    }
    calls = {"K7": lambda: cb.kernel_fwd(x, w9, mul, add),
             "K8": lambda: cb.kernel_bwd(x, w9, mul, add, y, dy, ds1, ds2)}
    for key, fn in calls.items():
        per_launch = _launch_ms(fn, expect=tuple(frag for frag, *_ in work[key]))
        parts, device_ms = [], 0.0
        for frag, label, per_call, flops, nbytes in work[key]:
            hits = [t for name, t in per_launch.items() if frag in name]
            if len(hits) != 1:
                raise AssertionError(f"{key}: no single {frag} among the profiled kernels {sorted(per_launch)}")
            ms = hits[0] * per_call
            device_ms += ms
            if flops:
                bound = _bound(flops, nbytes)[0]
                parts.append(f"{label} {ms:.4f} ms ({flops / ms / 1e9:.0f} TFLOP/s, {bound / ms:.2f} of its bound)")
            elif nbytes:
                parts.append(f"{label} {ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s, {nbytes / PEAK_HBM_BYTES * 1e3 / ms:.2f} "
                             f"of its bound)")
            else:
                parts.append(f"{label} {ms:.4f} ms")
        print(f"{key} bf16 {tuple(x.shape)} x {tuple(w9.shape)}, one call's launches: {'; '.join(parts)}; device "
              f"{device_ms:.4f} ms in all, the wrapper's host enqueue {_host_us(fn):.1f} us per call  [{gpu}]")


def _k6_one_pass(k: int, n: int) -> bool:
    """Whether bf16 K6 takes one_pass_kernel at (K, N): mbh::one_pass of
    csrc/matmul_bn_hopper.cuh."""
    def width(cols):
        return 64 if cols <= 64 else 128 if cols <= 128 else 256
    return k <= 256 and n <= 256 and width(k) * width(n) <= 128 * 128


def bn_f32_step(mm, cb, gpu: str):
    """K5-fp32 / K6-fp32 at every shape of a fused_1x1 step of
    h36m3d_r50_fp32 (f32_breakdown.BN_STEP): each against plain (the fp32 bars of
    compare_bn), then kernel, plain and library (cuBLAS fp32 with TF32 off,
    and torch sums) in turns, the sub-launches (torch.profiler), the 3xTF32
    bound and the time the products would take at the FMA units' peak;
    summed over the step's 16 launches each; two runs bitwise equal at
    the longest sums. Then K7/K8-fp32 the same way at CONV_F32_STEP (summed
    over its 5 launches a step) and at CONV_F32 (timed only), with each
    wrapper's host enqueue. Returns ({"k5f", "k6f", "k7f", "k8f": max |y|
    or |dx diff|}, {the same keys: (ms, plain, library, flops, bytes,
    device ms, (bound ms, bound by)) a step})."""
    from ihpr_tpu_torch.ops.fused_head_integral import no_tf32
    from ihpr_tpu_torch.tools.f32_breakdown import BN_STEP

    errs = {"k5f": 0.0, "k6f": 0.0}
    step = {k: [0.0] * 6 for k in ("k5f", "k6f")}
    # The step's bound: the sum of each launch's own (launches run one after
    # another), split by what bounds each.
    bounds = {k: {"bytes": 0.0, "operations": 0.0} for k in ("k5f", "k6f")}
    for i, (m, k, n, prologue, launches) in enumerate(BN_STEP):
        shape = f"({m}, {k}) x ({k}, {n}){' +prologue' if prologue else ''}"
        args = _bn_inputs((m,), k, n, 1, torch.float32, prologue, SEED + 60 + i)
        ey, edx = check_bn(mm, args, f"K5/K6-fp32 {shape}")
        errs["k5f"], errs["k6f"] = max(errs["k5f"], ey), max(errs["k6f"], edx)
        with no_tf32():
            t = _time_bn(mm, args, _library_mm)
        work = _bn_work((m,), k, n, 1, 4)
        x, w, mul, add, dy, ds1, ds2 = args
        y = mm.kernel_fwd(x, w, mul, add)[0]
        calls = {"k5f": (lambda: mm.kernel_fwd(x, w, mul, add), "fwd", work[0], work[1]),
                 "k6f": (lambda: mm.kernel_bwd(x, w, mul, add, y, dy, ds1, ds2), "bwd", work[2], work[3])}
        for key, (fn, kind, flops, nbytes) in calls.items():
            parts = _launch_ms(fn, expect=("reduce_rows",))
            device = sum(parts.values())
            acc = step[key]
            for j, v in enumerate((t[f"kernel_{kind}"], t[f"plain_{kind}"], t[f"library_{kind}"], flops, nbytes,
                                   device)):
                acc[j] += launches * v
            bound, by = _bound(flops, nbytes, torch.float32)
            bounds[key][by] += launches * bound
            print(f"{'K5' if kind == 'fwd' else 'K6'}-fp32 {shape} x{launches}/step: kernel {t[f'kernel_{kind}']:.4f} "
                  f"ms ({bound / t[f'kernel_{kind}']:.2f} of its bound {bound:.4f}, {by}; FMA peak "
                  f"{flops / PEAK_FP32_FLOPS * 1e3:.4f}), plain {t[f'plain_{kind}']:.4f}, cuBLAS fp32+sums "
                  f"{t[f'library_{kind}']:.4f}, {nbytes / 1e6:.1f} MB; sub-launches "
                  + "; ".join(f"{_kernel_label(name)} {ms:.4f} ms" for name, ms in parts.items())
                  + f" (device {device:.4f})  [{gpu}]")
        del args, x, w, mul, add, dy, ds1, ds2, y
    for key, label in (("k5f", "K5-fp32"), ("k6f", "K6-fp32")):
        ms, plain_ms, lib_ms, flops, nbytes, device = step[key]
        bound_ms, bound_by = sum(bounds[key].values()), max(bounds[key], key=bounds[key].get)
        step[key].append((bound_ms, bound_by))
        print(f"{label} per fp32 fused_1x1 step ({sum(r[4] for r in BN_STEP)} launches): kernel {ms:.4f} ms "
              f"(device {device:.4f} by torch.profiler), plain {plain_ms:.4f}, library {lib_ms:.4f}, bound "
              f"{bound_ms:.4f} (the launches' own, summed: bytes {bounds[key]['bytes']:.4f}, operations "
              f"{bounds[key]['operations']:.4f}; {ms and bound_ms / ms:.2f} of it), FMA peak "
              f"{flops / PEAK_FP32_FLOPS * 1e3:.4f}; {flops / 1e9:.1f} GFLOP, {nbytes / 1e9:.3f} GB  [{gpu}]")

    # Two runs bitwise equal where the sums are longest (dw over 2048 row
    # tiles, flushed into partials), with the prologue.
    x, w, mul, add, dy, ds1, ds2 = _bn_inputs((131072,), 256, 128, 1, torch.float32, True, SEED + 69)
    first, again = mm.kernel_fwd(x, w, mul, add), mm.kernel_fwd(x, w, mul, add)
    bwd = (x, w, mul, add, first[0], dy, ds1, ds2)
    if not all(torch.equal(a, b) for a, b in zip((*first, *mm.kernel_bwd(*bwd)), (*again, *mm.kernel_bwd(*bwd)))):
        raise AssertionError("K5/K6-fp32 are not deterministic: two runs differ")
    print("K5/K6-fp32 two runs at (131072, 256) x (256, 128) +prologue: y, s1, s2, dx, dw, dmul, dadd bitwise equal")
    del x, w, mul, add, dy, ds1, ds2, first, again, bwd

    for key in ("k7f", "k8f"):
        errs[key] = 0.0
    for i, (shape, launches) in enumerate(((CONV_F32_STEP[0], CONV_F32_STEP[1]), (CONV_F32, 0))):
        b, h, w_, c, n = shape
        args = _bn_inputs((b, h, w_), c, n, 9, torch.float32, True, SEED + 70 + i)
        label = f"({b}, {h}, {w_}, {c}) x (9, {c}, {n})"
        ey, edx = check_bn(cb, args, f"K7/K8-fp32 {label}")
        errs["k7f"], errs["k8f"] = max(errs["k7f"], ey), max(errs["k8f"], edx)
        with no_tf32():
            t = _time_bn(cb, args, _library_conv)
        work = _bn_work((b, h, w_), c, n, 9, 4)
        x, w, mul, add, dy, ds1, ds2 = args
        y = cb.kernel_fwd(x, w, mul, add)[0]
        calls = {"k7f": (lambda: cb.kernel_fwd(x, w, mul, add), "fwd", work[0], work[1]),
                 "k8f": (lambda: cb.kernel_bwd(x, w, mul, add, y, dy, ds1, ds2), "bwd", work[2], work[3])}
        for key, (fn, kind, flops, nbytes) in calls.items():
            parts = _launch_ms(fn, expect=("reduce_rows",))
            device = sum(parts.values())
            bound, by = _bound(flops, nbytes, torch.float32)
            ms = t[f"kernel_{kind}"]
            if launches:
                step[key] = [launches * v for v in (ms, t[f"plain_{kind}"], t[f"library_{kind}"], flops, nbytes,
                                                     device)] + [(launches * bound, by)]
            where = f"x{launches}/step of a fp32 step with both fused flags at 128x128" if launches else (
                "timed only")
            print(f"{'K7' if kind == 'fwd' else 'K8'}-fp32 {label} {where}: kernel {ms:.4f} ms (device {device:.4f}; "
                  f"{bound / ms:.2f} of its bound {bound:.4f}, {by}; FMA peak {flops / PEAK_FP32_FLOPS * 1e3:.4f}), "
                  f"plain {t[f'plain_{kind}']:.4f}, cuDNN fp32+sums {t[f'library_{kind}']:.4f}, "
                  f"{nbytes / 1e6:.1f} MB; the wrapper's host enqueue {_host_us(fn):.1f} us; sub-launches "
                  + "; ".join(f"{_kernel_label(name)} {v:.4f} ms" for name, v in parts.items()) + f"  [{gpu}]")
        del args, x, w, mul, add, dy, ds1, ds2, y
    # Two runs bitwise equal at the route's shape, with the prologue.
    x, w, mul, add, dy, ds1, ds2 = _bn_inputs(CONV_F32_STEP[0][:3], 256, 256, 9, torch.float32, True, SEED + 72)
    first, again = cb.kernel_fwd(x, w, mul, add), cb.kernel_fwd(x, w, mul, add)
    bwd = (x, w, mul, add, first[0], dy, ds1, ds2)
    if not all(torch.equal(a, b) for a, b in zip((*first, *cb.kernel_bwd(*bwd)), (*again, *cb.kernel_bwd(*bwd)))):
        raise AssertionError("K7/K8-fp32 are not deterministic: two runs differ")
    print(f"K7/K8-fp32 two runs at {CONV_F32_STEP[0]} +prologue: y, s1, s2, dx, dw, dmul, dadd bitwise equal")
    del x, w, mul, add, dy, ds1, ds2, first, again, bwd
    torch.cuda.empty_cache()
    return errs, step


def bn_kernel_phase(mm, cb, gpu: str):
    """K5/K6 and K7/K8 against their plain versions at every shape of the
    flagship fused step and of a fused_1x1-alone step (bf16, with the
    prologue where the step has it), K5/K6-fp32 at a fp32 fused_1x1 step's
    (bn_f32_step), and at edge cases (fp32, M = 1, M = 40,
    K = N = 8, K5's streamed w, the R152 stage-3 plane, B = 1, and the bf16
    K7/K8 tiles' edges); K5's and K6's sub-launches at each 1x1 shape,
    K7/K8's at the flagship; two runs bitwise equal; each timed (kernel,
    plain, library) and summed over each step's launches. Returns, per
    kernel name, (max |y or dx diff|, step ms, step plain ms, step library
    ms, step bound ms, bound by) of the step with both flags (k5f, k6f: of
    the fp32 fused_1x1 step)."""
    errs = {k: 0.0 for k in ("k5", "k6", "k7", "k8")}
    step = {k: [0.0, 0.0, 0.0, 0.0, 0.0] for k in ("k5", "k6", "k7", "k8")}  # ms, plain, library, ops, bytes
    alone = {k: [0.0, 0.0, 0.0, 0.0, 0.0] for k in ("k5", "k6")}  # the same over a fused_1x1-alone step

    def add_step(sums, kf, kb, t, work, launches):
        for key, kind, flops, nbytes in ((kf, "fwd", work[0], work[1]), (kb, "bwd", work[2], work[3])):
            acc = sums[key]
            acc[0] += launches * t[f"kernel_{kind}"]
            acc[1] += launches * t[f"plain_{kind}"]
            acc[2] += launches * t[f"library_{kind}"]
            acc[3] += launches * flops
            acc[4] += launches * nbytes

    device = {k: [0.0, 0.0] for k in ("k5", "k6")}  # device ms (torch.profiler) per step: both flags, alone

    def sub_launches(key, fn, launches, alone_launches, k, n):
        if key == "k5":
            expect = ("fwd_kernel", "reduce_rows")
        else:
            expect = ("one_pass_kernel",) if _k6_one_pass(k, n) else ("da_kernel", "dw_kernel")
            expect += ("reduce_rows",)
        parts = _launch_ms(fn, expect=expect)
        missing = [frag for frag in expect if not any(frag in name for name in parts)]
        if missing:
            raise AssertionError(f"{key}: no {missing} among the profiled kernels {sorted(parts)}")
        ms = sum(parts.values())
        device[key][0] += launches * ms
        device[key][1] += alone_launches * ms
        return "; ".join(f"{_kernel_label(name)} {t:.4f} ms" for name, t in parts.items()) + f" (device {ms:.4f})"

    for i, (m, k, n, prologue, launches, alone_launches) in enumerate(MM_STEP):
        shape = f"({m}, {k}) x ({k}, {n}){' +prologue' if prologue else ''}"
        args = _bn_inputs((m,), k, n, 1, torch.bfloat16, prologue, SEED + i)
        ey, edx = check_bn(mm, args, f"K5/K6 {shape}")
        errs["k5"], errs["k6"] = max(errs["k5"], ey), max(errs["k6"], edx)
        t = _time_bn(mm, args, _library_mm)
        work = _bn_work((m,), k, n, 1, 2)
        add_step(step, "k5", "k6", t, work, launches)
        add_step(alone, "k5", "k6", t, work, alone_launches)
        fwd_bound, bwd_bound = _bound(work[0], work[1])[0], _bound(work[2], work[3])[0]
        print(f"K5/K6 ({m}, {k}) x ({k}, {n}) bf16 x{launches}/step (x{alone_launches} with fused_1x1 alone): fwd "
              f"kernel {t['kernel_fwd']:.4f} ms (bound {fwd_bound:.4f}), plain {t['plain_fwd']:.4f}, cuBLAS+sums "
              f"{t['library_fwd']:.4f}; bwd kernel {t['kernel_bwd']:.4f} (bound "
              f"{bwd_bound:.4f}), plain {t['plain_bwd']:.4f}, cuBLAS "
              f"{t['library_bwd']:.4f}  [{gpu}]")
        x, w, mul, add, dy, ds1, ds2 = args
        fwd = sub_launches('k5', lambda: mm.kernel_fwd(x, w, mul, add), launches, alone_launches, k, n)
        print(f"K5 {shape}: {t['kernel_fwd']:.4f} ms, {work[1] / 1e6:.1f} MB, {fwd_bound / t['kernel_fwd']:.2f} of "
              f"its bound; sub-launches {fwd}  [{gpu}]")
        y = mm.kernel_fwd(x, w, mul, add)[0]
        bwd = sub_launches('k6', lambda: mm.kernel_bwd(x, w, mul, add, y, dy, ds1, ds2), launches, alone_launches, k, n)
        print(f"K6 {shape}: {t['kernel_bwd']:.4f} ms, {work[3] / 1e6:.1f} MB, {bwd_bound / t['kernel_bwd']:.2f} of "
              f"its bound; sub-launches {bwd}  [{gpu}]")
        del args, x, w, mul, add, dy, ds1, ds2, y
    f32_errs, f32_step = bn_f32_step(mm, cb, gpu)
    errs.update(f32_errs)
    # Edges: M below a tile, K and N off the 64-grid, K or N within one box
    # with the other past 256 (bf16 K6 takes two kernels there), and K x N
    # too large for K5 to keep w in shared memory at widths 64 and 128.
    for dtype, shape, prologue in ((torch.float32, (4096, 256, 128), True), (torch.bfloat16, (1, 8, 8), True),
                                   (torch.float32, (1, 8, 8), False), (torch.bfloat16, (1000, 24, 40), True),
                                   (torch.bfloat16, (40, 128, 512), True), (torch.bfloat16, (300, 64, 512), True),
                                   (torch.bfloat16, (300, 512, 64), False), (torch.bfloat16, (333, 2048, 40), False),
                                   (torch.bfloat16, (333, 1000, 120), True)):
        m, k, n = shape
        args = _bn_inputs((m,), k, n, 1, dtype, prologue, SEED + 20)
        ey, edx = check_bn(mm, args, f"K5/K6 {str(dtype)[6:]} ({m}, {k}) x ({k}, {n})")
        errs["k5"], errs["k6"] = max(errs["k5"], ey), max(errs["k6"], edx)

    (b, h, w, c, n), launches = CONV_STEP
    for dtype in (torch.bfloat16, torch.float32):
        args = _bn_inputs((b, h, w), c, n, 9, dtype, True, SEED + 30)
        ey, edx = check_bn(cb, args, f"K7/K8 {str(dtype)[6:]} ({b}, {h}, {w}, {c}) x (9, {c}, {n})")
        k7, k8 = ("k7", "k8") if dtype == torch.bfloat16 else ("k7f", "k8f")
        errs[k7], errs[k8] = max(errs[k7], ey), max(errs[k8], edx)
        if dtype == torch.bfloat16:
            t = _time_bn(cb, args, _library_conv)
            work = _bn_work((b, h, w), c, n, 9, 2)
            add_step(step, "k7", "k8", t, work, launches)
            print(f"K7/K8 ({b}, {h}, {w}, {c}) x (9, {c}, {n}) bf16 x{launches}/step: fwd kernel "
                  f"{t['kernel_fwd']:.4f} ms ({work[0] / t['kernel_fwd'] / 1e9:.1f} TFLOP/s, bound "
                  f"{_bound(work[0], work[1])[0]:.4f}), plain {t['plain_fwd']:.4f}, cuDNN+sums "
                  f"{t['library_fwd']:.4f}; bwd kernel {t['kernel_bwd']:.4f} ({work[2] / t['kernel_bwd'] / 1e9:.1f} "
                  f"TFLOP/s, bound {_bound(work[2], work[3])[0]:.4f}), plain {t['plain_bwd']:.4f}, cuDNN "
                  f"{t['library_bwd']:.4f}  [{gpu}]")
            conv_breakdown(cb, args, gpu)
        del args
    # Edges, both dtypes: W = 18 and 3 (boxes run past the image), no
    # prologue, C and N not multiples of 64, the flagship plane at B = 1, an
    # image narrower than a box, a 12 x 8 plane (an odd number of boxes).
    for shape, prologue in (((2, 24, 18, 256, 256), True), ((1, 16, 16, 64, 64), False), ((1, 5, 3, 8, 16), True),
                            ((5, 16, 16, 200, 136), True), ((1, 16, 16, 256, 256), True), ((2, 3, 5, 64, 64), True),
                            ((3, 12, 8, 256, 256), True)):
        b, h, w, c, n = shape
        for dtype, k7, k8 in ((torch.bfloat16, "k7", "k8"), (torch.float32, "k7f", "k8f")):
            args = _bn_inputs((b, h, w), c, n, 9, dtype, prologue, SEED + 40)
            ey, edx = check_bn(cb, args, f"K7/K8 {str(dtype)[6:]} ({b}, {h}, {w}, {c}) x (9, {c}, {n})")
            errs[k7], errs[k8] = max(errs[k7], ey), max(errs[k8], edx)

    for mod, label, shape, taps in ((mm, "K5/K6", (8192,), 1), (cb, "K7/K8", (8, 16, 16), 9)):
        x, w, mul, add, dy, ds1, ds2 = _bn_inputs(shape, 256, 256, taps, torch.bfloat16, True, SEED + 50)
        first, again = mod.kernel_fwd(x, w, mul, add), mod.kernel_fwd(x, w, mul, add)
        bwd = (x, w, mul, add, first[0], dy, ds1, ds2)
        if not all(torch.equal(a, b) for a, b in zip((*first, *mod.kernel_bwd(*bwd)),
                                                     (*again, *mod.kernel_bwd(*bwd)))):
            raise AssertionError(f"{label} are not deterministic: two runs differ")
        print(f"{label} two runs on the same inputs: y, s1, s2, dx, dw, dmul, dadd bitwise equal")
    torch.cuda.empty_cache()
    out = {}
    for key in ("k5", "k6", "k7", "k8"):
        ms, plain_ms, lib_ms, flops, nbytes = step[key]
        bound_ms, bound_by = _bound(flops, nbytes)
        out[key] = (errs[key], ms, plain_ms, lib_ms, bound_ms, bound_by)
        dev = f" (device {device[key][0]:.4f} by torch.profiler)" if key in device else ""
        print(f"{key.upper()} per flagship step: kernel {ms:.4f} ms{dev}, plain {plain_ms:.4f}, library "
              f"{lib_ms:.4f}, bound {bound_ms:.4f} ({bound_by})  [{gpu}]")
    for key in ("k5f", "k6f", "k7f", "k8f"):
        ms, plain_ms, lib_ms, _, _, _, (bound_ms, bound_by) = f32_step[key]
        out[key] = (errs[key], ms, plain_ms, lib_ms, bound_ms, bound_by)
    for key in ("k5", "k6"):
        ms, plain_ms, lib_ms, flops, nbytes = alone[key]
        bound_ms, bound_by = _bound(flops, nbytes)
        print(f"{key.upper()} per fused_1x1-alone step ({sum(r[5] for r in MM_STEP)} launches): kernel {ms:.4f} ms "
              f"(device {device[key][1]:.4f} by torch.profiler), plain {plain_ms:.4f}, library {lib_ms:.4f}, bound "
              f"{bound_ms:.4f} ({bound_by})  [{gpu}]")
    return out


class _FirstLaunch:
    """Wraps a kernel wrapper: keeps clones of the inputs and outputs of
    its first launch that ``want(args)`` accepts, and adds nothing else (the
    wrapper itself counts the launch)."""

    def __init__(self, fn, want):
        self.fn, self.want, self.saved = fn, want, None

    def __call__(self, *args):
        out = self.fn(*args)
        if self.saved is None and self.want(args):
            clone = lambda t: None if t is None else t.detach().clone()  # noqa: E731
            self.saved = ([clone(a) for a in args], [clone(o) for o in out])
        return out


def fused_train_phase(fhi, iv, mm, cb, gpu: str):
    """h36m3d_r50 with fused_1x1 and fused_conv3 trains through the Trainer
    at batch 128 (the main path, counted): K5/K6 16 and K7/K8 5 launches
    per step, K1/K2 one. One launch of each of K5-K8 in those steps is held
    against the plain versions on its saved inputs. A fused_1x1-alone step
    (counted: K5/K6 26 each). Then the H100 A/B: device ms per step and
    peak memory with both flags, fused_1x1 alone and unfused (the same
    model, in turns, medians of three rounds) with each one's device-busy
    time, and the loss falling over 10 steps on one repeated batch. Returns
    the main path's K5-K8 launches (the fused_1x1 step's included) and the
    saved launches' largest differences."""
    from ihpr_tpu_torch.config import get_config
    from ihpr_tpu_torch.data.pipeline import prefetch_to_device
    from ihpr_tpu_torch.engine.trainer import Trainer
    from ihpr_tpu_torch.models.resnet import Bottleneck

    scratch = tempfile.TemporaryDirectory()  # the Trainer's log and snapshot; removed on return
    base = get_config("h36m3d_r50").replace(output_dir=scratch.name)
    cfg = base.replace(model=dataclasses.replace(base.model, fused_1x1=True, fused_conv3=True))
    trainer = Trainer(cfg, data_root="synthetic", synthetic_size=384, num_workers=8, device="cuda")
    blocks = [m for m in trainer.model.modules() if isinstance(m, Bottleneck)]

    def set_flags(f1, f3):
        for blk in blocks:
            blk.fused_1x1, blk.fused_conv3 = f1, f3

    wrapped = {}
    try:
        batch, _ = next(prefetch_to_device(iter(list(trainer.loader.epoch(99, 1))), "cuda"))
        for _ in range(2):  # warm-up: kernel loads, cuDNN plans
            trainer.lean_step_fn(batch)
        torch.cuda.synchronize()
        with_prologue = lambda args: args[2] is not None  # noqa: E731
        for mod, name in ((mm, "kernel_fwd"), (mm, "kernel_bwd"), (cb, "kernel_fwd"), (cb, "kernel_bwd")):
            wrapped[mod, name] = _FirstLaunch(getattr(mod, name), with_prologue)
            setattr(mod, name, wrapped[mod, name])

        # --- the main path, counted: one epoch of TRAIN_STEPS fused steps ---
        trainer.cap_steps_per_epoch(TRAIN_STEPS)
        _zero_counts(fhi, iv, mm, cb)
        trainer.train(trainer.start_epoch + 1)
        torch.cuda.synchronize()
        counts = _counts(fhi, iv, mm, cb)
        # ---------------------------------------------------------------------
        for (mod, name), w in wrapped.items():
            setattr(mod, name, w.fn)
        want = tuple(TRAIN_STEPS * k for k in (1, 1, 0, 0, 16, 16, 5, 5))
        if counts != want:
            raise AssertionError(f"fused train steps launched K1-K8 {counts} times, want {want}")
        losses = [float(x) for x in trainer.losses]  # the epoch's losses
        if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"fused train losses {losses}")
        print(f"fused train: {TRAIN_STEPS} steps through Trainer.train, launches K1-K8 {counts}; "
              f"losses {', '.join(f'{x:.4f}' for x in losses)}")

        errs = {}
        for label, mod in (("K5/K6", mm), ("K7/K8", cb)):
            (f_args, f_out), (b_args, b_out) = wrapped[mod, "kernel_fwd"].saved, wrapped[mod, "kernel_bwd"].saved
            dtype, rows = f_args[0].dtype, f_out[0].numel() // f_out[0].shape[-1]
            errs[label] = (
                compare_bn(f"{label[:2]}, one launch of a counted step", FWD_NAMES, f_out,
                           mod.plain(*f_args), dtype, rows)["y"],
                compare_bn(f"{label[3:]}, one launch of a counted step", BWD_NAMES, b_out,
                           mod.plain_bwd(*b_args), dtype, rows)["dx"],
            )

        set_flags(True, False)
        trainer.lean_step_fn(batch)  # warm-up of the stage-3 1x1 shapes
        torch.cuda.synchronize()
        # --- the main path, counted: one fused_1x1-alone step ---
        _zero_counts(fhi, iv, mm, cb)
        trainer.lean_step_fn(batch)
        torch.cuda.synchronize()
        alone = _counts(fhi, iv, mm, cb)
        # --------------------------------------------------------
        if alone != (1, 1, 0, 0, 26, 26, 0, 0):
            raise AssertionError(f"a fused_1x1 step launched K1-K8 {alone} times")
        print(f"fused_1x1 alone: one step launched K1-K8 {alone}")

        # The A/B: the same model with both flags, fused_1x1 alone and
        # unfused, in turns (the order reversed every other round), three
        # rounds of three steps each; medians.
        step = lambda: trainer.lean_step_fn(batch)  # noqa: E731
        flags = {"both flags": (True, True), "fused_1x1 alone": (True, False), "unfused": (False, False)}
        timing, peak = {k: [] for k in flags}, {}
        for rnd in range(3):
            for name in (flags if rnd % 2 == 0 else reversed(flags)):
                set_flags(*flags[name])
                torch.cuda.reset_peak_memory_stats()
                timing[name].append(_cuda_ms(step, 3, reps=1))
                peak[name] = torch.cuda.max_memory_allocated() / 2**30
        for name, ts in timing.items():
            ms = statistics.median(ts)
            print(f"fused train A/B, h36m3d_r50 batch {TRAIN_BATCH}, {name}: {ms:.3f} ms/step median of "
                  f"{', '.join(f'{t:.3f}' for t in ts)} ({TRAIN_BATCH / ms * 1e3:.1f} img/s, peak {peak[name]:.2f} "
                  f"GiB) (CUDA events, same model, in turns)  [{gpu}]")
        # What the device does in one step of each: busy time (the kernels'
        # device time, one stream), against the median above, and K5-K8's share.
        for name, f in flags.items():
            set_flags(*f)
            step()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
            kinds = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
            busy = sum(e.self_device_time_total for e in kinds) / 1e3
            fused = sum(e.self_device_time_total for e in kinds if e.key.split("::")[0].split()[-1] in ("c3", "cbn", "mbh")) / 1e3
            ms = statistics.median(timing[name])
            print(f"fused train profile, {name}: device busy {busy:.3f} ms per step, idle share {1 - busy / ms:.3f} "
                  f"of the median; K5-K8 kernels {fused:.3f} ms; largest: "
                  + "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f}" for e in kinds[:3]) + f"  [{gpu}]")

        set_flags(True, True)
        falling = [float(trainer.lean_step_fn(batch)["loss"]) for _ in range(10)]
        if not (all(math.isfinite(x) for x in falling) and falling[-1] < falling[0]):
            raise AssertionError(f"fused loss does not fall on one repeated batch: {falling}")
        print(f"fused train: 10 steps on one repeated batch, loss {falling[0]:.4f} -> {falling[-1]:.4f}")
    finally:
        for (mod, name), w in wrapped.items():
            setattr(mod, name, w.fn)
        trainer.close()
    launches = tuple(c + a for c, a in zip(counts[4:], alone[4:]))
    return launches, errs


def head_library_phase(fhi, iv, gpu: str):
    """The library composition beside K1 and K2 (a yardstick only): the
    final conv as one cuBLAS addmm, then K3 (K1's function) at K1's serving
    shape (64, 4096, 256) and at the train batch (128, 4096, 256); K4 on
    those logits, then dfeat and dW as two cuBLAS matmuls (K2's function)
    at the train batch; bf16. Returns (K1's at 64, K1's at 128, K2's)."""
    hw, w, c, j, d = 64 * 64, 64, 256, 18, 64
    out = []
    for b in (2 * MAX_BATCH, TRAIN_BATCH):
        feat, kernel, bias = _head_inputs(b, hw, c, j * d, torch.bfloat16, SEED)
        flat = feat.view(-1, c)

        def fwd():
            return iv.kernel_stats(torch.addmm(bias, flat, kernel).view(b, hw, j * d), j, d, w)

        out.append(_cuda_ms(fwd, 5, reps=3))
        if b == TRAIN_BATCH:
            logits = torch.addmm(bias, flat, kernel).view(b, hw, j * d)
            coords, m, s = iv.kernel_stats(logits, j, d, w)
            g = torch.randn(b, j, 3, generator=torch.Generator().manual_seed(SEED)).cuda()

            def bwd():
                dv = iv.kernel_bwd(logits, m, s, coords, g, j, d, w).view(-1, j * d)
                return dv @ kernel.t(), flat.t() @ dv, dv.float().sum(0)

            out.append(_cuda_ms(bwd, 5, reps=3))
            del logits
        del feat, flat
    torch.cuda.empty_cache()
    print(f"K1's library composition (cuBLAS addmm + K3): {out[0]:.4f} ms at ({2 * MAX_BATCH}, {hw}, {c}), "
          f"{out[1]:.4f} ms at ({TRAIN_BATCH}, {hw}, {c}); K2's (K4 + two cuBLAS matmuls) at "
          f"({TRAIN_BATCH}, {hw}, {c}): {out[2]:.4f} ms  [{gpu}]")
    return tuple(out)


_HEAD = (64 * 64, 256, 18 * 64)  # the flagship head's (H*W, C, J*D)


def k1_bound(b, hw=_HEAD[0]):
    """(ms, bound_by) of K1 at (b, hw, 256) x (256, 1152), bf16: the logits
    product against reading feat and W once."""
    _, c, jd = _HEAD
    return _bound(2 * b * hw * c * jd, (b * hw * c + c * jd) * 2)


def k2_bound(b, hw=_HEAD[0]):
    """(ms, bound_by) of K2 at (b, hw, 256): three products (the logits
    recomputed, dfeat, dW) against reading feat and W and writing dfeat
    and dW once."""
    _, c, jd = _HEAD
    return _bound(3 * 2 * b * hw * c * jd, (2 * b * hw * c + 2 * c * jd) * 2)


def head_bounds():
    """(ms, bound_by) of K1 at the serving shape (64, 4096, 256), K2 at the
    train batch (128, 4096, 256), K3 and K4 at the (128, 4096, 1152) volume;
    ~5 fp32 operations per logit for the softmax terms."""
    vol = TRAIN_BATCH * _HEAD[0] * _HEAD[2]
    k3 = max(_bound(5 * vol, 0, torch.float32, elementwise=True), _bound(0, 2 * vol))
    k4 = max(_bound(5 * vol, 0, torch.float32, elementwise=True), _bound(0, 4 * vol))
    return k1_bound(2 * MAX_BATCH), k2_bound(TRAIN_BATCH), k3, k4


# --- P1/P2: the probe tools (ihpr_tpu_torch.tools) ---------------------------------

EXP_ITERS = 30  # passes per mode in exp_probe's timing
MM_ITERS = 20  # calls per phase in mxu_int8_probe's timing
MM_SIZE = 4096  # M = N = K of mxu_int8_probe's products
PROBE_CONV = (64, 64, 64, 256)  # (B, H, W, C) of its conv9 / convref pair
# exp_probe partials and token against plain, relative (read: bitwise): fp32
# sums in another order and ex2.approx; bexpsum rounds each exp's argument
# to bf16 before ex2.
TOL_EXP = {"sum": 1e-5, "maxsum": 1e-5, "expsum": 1e-5, "exp2sum": 1e-5, "bexpsum": 1e-2}


def exp_probe_phase(ep, gpu: str):
    """P1 on the (128, 4096, 1152) fp32 volume (2.416 GB). The probe path,
    counted: the tool's entry ``main`` times all six modes (CUDA events)
    and checks the read floor. Then, on a new volume, every mode's partials
    and token against plain (read bitwise, the reductions within TOL_EXP),
    two runs bitwise equal, and the plain expsum and the library sum
    (``torch.sum`` over the blocks) timed. Returns (launches, expsum's max
    |diff|, expsum ms, plain ms, library ms, bound ms)."""
    # --- the probe path, counted: exp_probe.main ---
    ep.launches = 0
    results = ep.main(["--iters", str(EXP_ITERS), "--device", "cuda"])
    torch.cuda.synchronize()
    launches = ep.launches
    # -----------------------------------------------
    if launches != len(ep.MODES) * ep.ROUNDS * (EXP_ITERS + 1):
        raise AssertionError(f"exp_probe.main launched the kernel {launches} times")
    x = ep.make_volume("cuda", SEED + 1)
    nbytes = x.numel() * x.element_size()
    errs = {}
    for mode in ep.MODES:
        got, again, want = ep.kernel(x, mode), ep.kernel(x, mode), ep.plain(x, mode)
        torch.cuda.synchronize()
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise AssertionError(f"exp_probe {mode}: two runs differ")
        rel = 0.0
        for g, w in zip(got, want):
            if g.shape != w.shape or not torch.isfinite(g).all():
                raise AssertionError(f"exp_probe {mode}: {tuple(g.shape)} vs {tuple(w.shape)}, finite "
                                     f"{bool(torch.isfinite(g).all())}")
            if mode == "read":
                if not torch.equal(g, w):
                    raise AssertionError("exp_probe read: partials or token differ from plain")
                continue
            rel = max(rel, float(((g - w).abs() / w.abs()).max()))
            if rel > TOL_EXP[mode]:
                raise AssertionError(f"exp_probe {mode}: {rel} relative from plain (> {TOL_EXP[mode]})")
        errs[mode] = max(float((g - w).abs().max()) for g, w in zip(got, want))
        print(f"exp_probe {mode}: partials {tuple(got[0].shape)} and token vs plain max|diff| {errs[mode]:.3g} "
              f"({'bitwise' if mode == 'read' else f'{rel:.2e} relative'}), two runs bitwise equal")
        del got, again, want
    blocks = x.view(ep.B * ep.NCHUNK, -1)
    plain_ms = _cuda_ms(lambda: ep.plain(x, "expsum"), 2, reps=3)
    library_ms = _cuda_ms(lambda: blocks.sum(1), 10, reps=3)
    bound_ms = ep.read_floor_ms(nbytes)
    print(f"exp_probe at ({ep.B}, {ep.NCHUNK * ep.CHUNK}, {ep.LANES}) fp32: expsum {results['expsum']:.4f} ms, "
          f"sum {results['sum']:.4f}, read {results['read']:.4f} (bound {bound_ms:.4f}, bytes); plain expsum "
          f"{plain_ms:.4f} ms; torch.sum over the blocks {library_ms:.4f} ms  [{gpu}]")
    del x, blocks
    torch.cuda.empty_cache()
    return launches, errs["expsum"], results["expsum"], plain_ms, library_ms, bound_ms


def probe_mm_phase(pm, gpu: str):
    """P2 at M = N = K = 4096. The probe path, counted: the tool's entry
    ``main`` times the library products, every tile of the kernel in bf16
    and int8, and the conv9 / convref pair. Then every tile against
    plain_mm at 4096^3 (int8 bitwise, bf16 within 1e-4 of max|plain|) and
    plain_mm timed. Returns (launches, bf16 max |diff|, best bf16 tile ms,
    plain ms, cuBLAS bf16 ms, bound ms, bound by)."""
    size = MM_SIZE
    # --- the probe path, counted: mxu_int8_probe.main ---
    pm.launches = 0
    results = pm.main(["--iters", str(MM_ITERS), "--size", str(size), "--device", "cuda",
                       "--conv", *map(str, PROBE_CONV)])
    torch.cuda.synchronize()
    launches = pm.launches
    # ----------------------------------------------------
    tiles = sum(len(t) for t in pm.TILES.values())
    if launches != tiles * (MM_ITERS + 1):
        raise AssertionError(f"mxu_int8_probe.main launched the kernel {launches} times")
    rng = np.random.RandomState(SEED)
    errs, plain_ms = {}, {}
    for dtype in (torch.bfloat16, torch.int8):
        a, b = (t.cuda() for t in pm._mats(rng, size, size, size, dtype))
        errs[dtype] = pm.check_tiles(a, b)
        plain_ms[dtype] = _cuda_ms(lambda: pm.plain_mm(a, b), 2, reps=3)
        tag = pm.TAGS[dtype]
        bound = 2 * size**3 / pm.PEAK[dtype] * 1e3
        lib_ms = results[f"dot_{tag}"]
        lib_name = "torch._int_mm" if dtype == torch.int8 else "cuBLAS"
        for bm, bn, bk in pm.TILES[dtype]:
            ms = results[f"pallas_{tag}_{bm}x{bn}x{bk}"]
            print(f"probe_mm {tag} tile ({bm}, {bn}, {bk}): {ms:.4f} ms, {2 * size**3 / ms / 1e9:.1f} "
                  f"T{'OP' if dtype == torch.int8 else 'FLOP'}/s, {bound / ms:.2f} of the bound, "
                  f"{ms / lib_ms:.2f}x {lib_name} ({lib_ms:.4f} ms)  [{gpu}]")
        best = min((k for k in results if k.startswith(f"pallas_{tag}_")), key=results.get)
        if dtype == torch.int8:  # the share of B's transpose in one call of the best tile
            bm, bn, bk = map(int, best[len(tag) + 8:].split("x"))
            parts = _launch_ms(lambda: pm.kernel_mm(a, b, bm, bn, bk), calls=5, expect=("transpose", "mm_kernel"))
            transpose = sum(t for n, t in parts.items() if "transpose" in n)
            print(f"probe_mm int8 {best[len(tag) + 8:]}, one call's launches: "
                  + "; ".join(f"{_kernel_label(name)} {t:.4f} ms" for name, t in parts.items())
                  + (f"; the transpose {transpose / sum(parts.values()):.2f} of the call's device time"
                     if transpose else "; the profiler recorded no transpose launch") + f"  [{gpu}]")
        print(f"probe_mm {tag} {size}^3: every tile vs plain_mm max|diff| {errs[dtype]:.3g}"
              f"{' (bitwise)' if dtype == torch.int8 else ''}; best tile {best[len(tag) + 8:]} "
              f"{results[best]:.4f} ms, library {lib_ms:.4f} ms, plain {plain_ms[dtype]:.4f} ms, "
              f"bound {bound:.4f} ms (operations)  [{gpu}]")
        del a, b
    cb_, ch, cw, cc = PROBE_CONV
    conv_bound = 2 * cb_ * ch * cw * cc * cc * 9 / PEAK_BF16_FLOPS * 1e3
    print(f"probe_mm conv {PROBE_CONV} x (3, 3, {cc}, {cc}): conv9 bf16 {results['conv9_bf16']:.4f} ms, "
          f"int8 {results['conv9_int8']:.4f} ms; convref bf16 (cuDNN) {results['convref_bf16']:.4f} ms; "
          f"bf16 bound {conv_bound:.4f} ms  [{gpu}]")
    torch.cuda.empty_cache()
    bound_ms, bound_by = _bound(2 * size**3, (2 * size * size * 2 + size * size * 4))
    return (launches, errs[torch.bfloat16], results["pallas_bf16"], plain_ms[torch.bfloat16],
            results["dot_bf16"], bound_ms, bound_by)



# --- data parallelism: one rank on NCCL, two ranks on one card over gloo ---------

DP_CONFIG = "h36m3d_r50_dp"  # ResNet-50, 256x256, bf16, lean BN, batch 32 a rank
DP_RANKS = 2  # (b) and (c): two ranks on the one card, over gloo
DP_STEPS = 3  # counted steps of the 2-rank run
DP_CLI_STEPS = 4  # steps of (a), the train CLI under torchrun
DP_SIZE = 128  # synthetic samples per train set of (a)
DP_TEST = 128  # synthetic H36M test samples of (c)
DP_EVAL_BATCH = 64  # (c)'s eval batch a rank: one global batch of 128 on 2 ranks, two in 1 process
TOL_DP_LOSS = 1e-3  # (b) one bf16 step on 2 ranks vs one process on the global batch, relative
# The same bf16 step's gradient global norm: within twice bf16's own distance
# from the fp32 step (the repository's rule for two bf16 paths, ROADMAP.md
# Traps). On an H100 one process's bf16 |g| moved 1.2% when only the order
# of the batch's halves changed (PERF.md), so no fixed 1e-2 holds for bf16.
TOL_DP_NORM_BF16 = 2.0
TOL_DP_FP32 = (1e-4, 1e-3)  # the step in fp32 "highest" on 2 ranks vs one process: loss, |g|, relative
TOL_DP_EVAL = 1e-4  # (c) gathered predictions vs one process's, voxel
TOL_DP_CLI = 1e-3  # (a) the last logged loss vs the 1-process Trainer's, relative (after 3 bf16 updates)
# K1-K8 launches a rank in one step with both fused flags: 13 Bottlenecks on
# the 1x1 route at 32 a rank, conv3 never (tests/test_torch_dp.py's route table).
DP_FUSED = (1, 1, 0, 0, 26, 26, 0, 0)


def _dp_cfg(out: str):
    from ihpr_tpu_torch.config import get_config

    cfg = get_config(DP_CONFIG).replace(output_dir=out)
    return cfg.replace(eval=dataclasses.replace(cfg.eval, batch_size_per_device=DP_EVAL_BATCH))


def _state_digest(model) -> str:
    import hashlib

    h = hashlib.sha1()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _collective_share(step, gpu: str, label: str) -> str:
    """One profiled step: the host time inside collective ops over the step's
    wall time, and the host<->device copies (gloo moves CUDA tensors through
    host memory)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    coll = [e for e in events if any(s in e.key.lower() for s in ("allreduce", "all_reduce", "gloo", "nccl",
                                                                   "all_gather", "broadcast"))]
    coll_ms = sum(e.self_cpu_time_total for e in coll) / 1e3
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = {d: sum(e.count for e in device if f"memcpy {d}" in e.key.lower()) for d in ("dtoh", "htod")}
    busy = sum(e.self_device_time_total for e in device) / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:3]
    return (f"{label}: one profiled step {wall:.3f} ms wall, device time {busy:.3f} ms summed over its "
            f"streams (largest: " + "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f}" for e in top)
            + f"); collective ops "
            f"{coll_ms:.3f} ms of host time ({coll_ms / wall:.3f} of the step; {sum(e.count for e in coll)} calls: "
            + ", ".join(f"{e.key} x{e.count}" for e in coll[:4])
            + f"); memcpy DtoH {copies['dtoh']}, HtoD {copies['htod']}  [{gpu}]")


def _dp_rank(rank: int, world: int, work: str, gpu: str):
    """One rank of dp_phase (b) and (c), on cuda:0 over gloo: DP_STEPS steps
    of h36m3d_r50_dp from the seeded weights on this rank's rows of the
    global batch (counted), K1 and K2 held against plain on one step's head
    inputs, device ms per step, the collectives' share and peak memory; one
    counted step with both fused flags (the world-2 routes; one K5 and K6
    launch held against plain); then the 2-rank Tester (counted). Returns
    what the parent checks."""
    from types import SimpleNamespace

    from ihpr_tpu_torch.data.augment import finalize_patch
    from ihpr_tpu_torch.data.datasets import build_dataset
    from ihpr_tpu_torch.engine import tester as tester_mod
    from ihpr_tpu_torch.models.pose_net import build_pose_net
    from ihpr_tpu_torch.models.resnet import Bottleneck
    from ihpr_tpu_torch.ops import conv_bn as cb
    from ihpr_tpu_torch.ops import fused_head_integral as fhi
    from ihpr_tpu_torch.ops import integral_volume as iv
    from ihpr_tpu_torch.ops import matmul_bn as mm
    from ihpr_tpu_torch.parallel import train_step
    from ihpr_tpu_torch.parallel.mesh import data_parallel

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    inputs = torch.load(f"{work}/inputs.pt", weights_only=False)
    cfg = _dp_cfg(f"{work}/rank{rank}")
    dp = data_parallel(cfg)
    model = build_pose_net(cfg, device="cuda", trainable=True, dp=dp, state_dict=inputs["model"])
    b = cfg.optim.batch_size_per_device
    local = {k: torch.from_numpy(v[rank * b:(rank + 1) * b]).cuda() for k, v in inputs["batch"].items()}
    opt, sched = train_step.make_optimizer(model, cfg, 100, dp)
    full = train_step.make_train_step(model, opt, cfg, scheduler=sched, dp=dp)
    lean = train_step.make_train_step(model, opt, cfg, lean=True, scheduler=sched, dp=dp)
    out = {}

    # --- the main path, counted: DP_STEPS steps on this rank's rows ---
    _zero_counts(fhi, iv, mm, cb)
    first = full(local)
    for _ in range(DP_STEPS - 1):
        lean(local)
    torch.cuda.synchronize()
    out["counts"] = _counts(fhi, iv, mm, cb)
    # -----------------------------------------------------------------
    out["first"] = {k: float(v) for k, v in first.items()}
    out["digest"] = _state_digest(model)

    # K1 and K2 on one train forward's head inputs against plain (every
    # rank runs it: train-mode BN all-reduces its statistics).
    with torch.no_grad():
        image = finalize_patch(local["patch"], local["color_scale"], cfg.data)
        feat = model.head.features(model.backbone(image.permute(0, 3, 1, 2))).contiguous()
    bb, h, w, c = feat.shape
    kernel, bias = (t.detach().to(model.head.dtype) for t in (model.head.final.weight, model.head.final.bias))
    out["k1_err"] = check_kernel(fhi, feat.view(bb, h * w, c), kernel, bias, model.joint_num, model.depth_dim, w)
    out["k2_err"] = _head_grad_check(fhi, SimpleNamespace(cfg=cfg, model=model), local)

    step = lambda: lean(local)  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    out["ms"] = _cuda_ms(step, 3, reps=2)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["profile"] = _collective_share(step, gpu, f"dp (b) rank {rank}")

    # --- both fused flags: the routes of world 2 (conv3 never), counted ---
    for blk in model.modules():
        if isinstance(blk, Bottleneck):
            blk.fused_1x1 = blk.fused_conv3 = True
    lean(local)  # warm-up of the 1x1 route's shapes
    torch.cuda.synchronize()
    wrapped = {name: _FirstLaunch(getattr(mm, name), lambda args: args[2] is not None)
               for name in ("kernel_fwd", "kernel_bwd")}
    for name, fn in wrapped.items():
        setattr(mm, name, fn)
    try:
        _zero_counts(fhi, iv, mm, cb)
        lean(local)
        torch.cuda.synchronize()
        out["fused_counts"] = _counts(fhi, iv, mm, cb)
    finally:
        for name, fn in wrapped.items():
            setattr(mm, name, fn.fn)
    # ---------------------------------------------------------------------
    (f_args, f_out), (b_args, b_out) = wrapped["kernel_fwd"].saved, wrapped["kernel_bwd"].saved
    rows = f_out[0].numel() // f_out[0].shape[-1]
    out["k5_err"] = compare_bn(f"dp (b) rank {rank} K5, one launch of the fused step", FWD_NAMES, f_out,
                               mm.plain(*f_args), f_args[0].dtype, rows)["y"]
    out["k6_err"] = compare_bn(f"dp (b) rank {rank} K6, one launch of the fused step", BWD_NAMES, b_out,
                               mm.plain_bwd(*b_args), b_args[0].dtype, rows)["dx"]
    out["fused_ms"] = _cuda_ms(step, 3, reps=1)
    del model, opt, full, lean
    torch.cuda.empty_cache()

    # The step in fp32 "highest" from the same weights (no bf16 rounding):
    # against one process on the global batch at fp32 bars.
    fp32_cfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32",
                                                     matmul_precision="highest"))
    model = build_pose_net(fp32_cfg, device="cuda", trainable=True, dp=dp, state_dict=inputs["model"])
    opt, sched = train_step.make_optimizer(model, fp32_cfg, 100, dp)
    out["fp32"] = {k: float(v) for k, v in
                   train_step.make_train_step(model, opt, fp32_cfg, scheduler=sched, dp=dp)(local).items()}
    del model, opt, local
    torch.cuda.empty_cache()

    # --- (c) the Tester on this rank's rows, counted ---
    net = build_pose_net(cfg, device="cuda", state_dict=inputs["eval_model"])
    written = []
    save, dump = np.save, tester_mod.json.dump
    np.save = lambda path, *a, **kw: (written.append(str(path)), save(path, *a, **kw))[1]
    tester_mod.json.dump = lambda obj, f, *a, **kw: (written.append(f.name), dump(obj, f, *a, **kw))[1]
    tester = tester_mod.Tester(cfg, dataset=build_dataset(cfg.data.testset, "test", cfg, "synthetic", DP_TEST),
                               state=net, num_workers=4, device="cuda")
    try:
        scored = []
        predict = tester.predict_voxels
        tester.predict_voxels = lambda: (scored.append(predict()), scored[-1])[1]
        _zero_counts(fhi, iv, mm, cb)
        out["metrics"] = tester.evaluate()
        out["eval_counts"] = _counts(fhi, iv, mm, cb)
        out["eval_batches"] = len(tester.loader)
    finally:
        np.save, tester_mod.json.dump = save, dump
        tester.close()
    out["preds"], out["written"] = scored[0], written
    return out


def _log_losses(path: str) -> dict:
    """{itr: the loss printed on that log line} of a train log."""
    import re

    return {int(m.group(1)): float(m.group(2))
            for m in re.finditer(r"itr (\d+)/\d+: lr \S+ loss (\S+)", open(path).read())}


def dp_phase(fhi, iv, mm, cb, gpu: str):
    """Data parallelism of h36m3d_r50_dp (ResNet-50, 256x256, bf16, batch 32
    a rank) on the one card. (a) ``python -m torch.distributed.run
    --standalone --nproc_per_node 1 -m ihpr_tpu_torch.train ... --multihost``
    (one rank on NCCL) in a subprocess: exit 0, its snapshot written, its
    logged losses those of a 1-process Trainer of the same config and seed.
    (b) Two ranks over gloo (``parallel.launch.spawn``) from seeded, peaked
    weights on a 64-image batch: the first step's loss and gradient norm
    against one process on the whole batch (beside two yardsticks of the
    bf16 step's noise), the same step in fp32 "highest", parameters and BN buffers
    bitwise equal across the ranks after DP_STEPS steps, K1/K2 counted per
    rank, device ms per step, the collectives' share and peak memory (gloo
    through host memory on one card: not a scaling number); one step with
    both fused flags, K5/K6 counted per rank as world 2 routes them and K7/K8
    0, beside one process's counts on the global batch. (c) The 2-rank
    Tester on DP_TEST samples: its gathered predictions against one
    process's, the same metrics on both ranks, rank 0 alone writing.
    Returns the ranks' launches of K1, K2, K5 and K6 (summed over the ranks)
    and the largest kernel-vs-plain differences."""
    from ihpr_tpu_torch.data import skeletons
    from ihpr_tpu_torch.data.augment import finalize_patch
    from ihpr_tpu_torch.data.datasets import build_dataset
    from ihpr_tpu_torch.data.pipeline import BatchLoader
    from ihpr_tpu_torch.engine.tester import Tester
    from ihpr_tpu_torch.engine.trainer import Trainer
    from ihpr_tpu_torch.models.pose_net import build_pose_net
    from ihpr_tpu_torch.models.resnet import Bottleneck
    from ihpr_tpu_torch.parallel import launch
    from ihpr_tpu_torch.parallel.train_step import make_optimizer, make_train_step

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as work:
        # (a) the train CLI under torchrun: one rank on NCCL
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
             "-m", "ihpr_tpu_torch.train", "--config", DP_CONFIG, "--synthetic", "--multihost",
             "--steps", str(DP_CLI_STEPS), "--end_epoch", "1", "--synthetic_size", str(DP_SIZE),
             "--rss_limit_mb", "0", "--output_dir", f"{work}/cli"],
            cwd=root, capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": root},
        )
        t_cli = time.perf_counter() - t0
        if proc.returncode != 0 or not os.path.exists(f"{work}/cli/model_dump/snapshot_0/state.pt"):
            raise AssertionError(f"dp (a): exit {proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-3000:]}")
        logged = _log_losses(f"{work}/cli/log/train_logs.txt")
        ref = Trainer(_dp_cfg(f"{work}/ref"), data_root="synthetic", synthetic_size=DP_SIZE,
                      num_workers=8, rss_limit_mb=0, device="cuda")
        try:
            ref.cap_steps_per_epoch(DP_CLI_STEPS)
            ref.train(1)
            want = [float(x) for x in ref.losses]
        finally:
            ref.close()
        del ref
        torch.cuda.empty_cache()
        last = DP_CLI_STEPS - 1
        if (sorted(logged) != [0, last] or f"{logged[0]:.4f}" != f"{want[0]:.4f}"
                or abs(logged[last] - want[last]) > 1e-4 + TOL_DP_CLI * abs(want[last])):
            raise AssertionError(f"dp (a): logged losses {logged}, the 1-process Trainer's {want}")
        print(f"dp (a): torchrun --nproc_per_node 1 -m ihpr_tpu_torch.train --config {DP_CONFIG} --multihost "
              f"(NCCL) exit 0 in {t_cli:.1f} s, snapshot_0 written; logged losses "
              f"{', '.join(f'itr {i} {v:.4f}' for i, v in sorted(logged.items()))} against the 1-process "
              f"Trainer's {', '.join(f'{want[i]:.4f}' for i in sorted(logged))}")

        # The seeded, peaked weights and a 64-image batch the ranks share.
        cfg = _dp_cfg(f"{work}/one")
        gen = torch.Generator().manual_seed(SEED)
        model = build_pose_net(cfg, device="cuda", generator=gen, trainable=True)
        primary = skeletons.get_skeleton(cfg.data.trainset[0])
        sets = [build_dataset(name, "train", cfg, "synthetic", DP_SIZE, hue_skeleton=primary if i else None)
                for i, name in enumerate(cfg.data.trainset)]
        gb = DP_RANKS * cfg.optim.batch_size_per_device
        loader = BatchLoader(sets, cfg, gb, num_workers=8, seed=cfg.seed)
        hb = next(loader.epoch(0, 1))
        loader.close()
        batch_np = {f: getattr(hb, f) for f in ("patch", "color_scale", "joint_img", "joint_vis", "joints_have_depth")}
        batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
        image = finalize_patch(batch["patch"], batch["color_scale"], cfg.data)
        with torch.no_grad():
            _peak_heatmaps(model, image, gen)
        start = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        # The Tester's weights: peaked on eval-mode features (running statistics).
        net = build_pose_net(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
        _peak_heatmaps(net, image, gen)
        eval_sd = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
        torch.save({"model": start, "eval_model": eval_sd, "batch": batch_np}, f"{work}/inputs.pt")

        # One process on the global batch: the step (b) is held to, then its
        # K5-K8 counts with both fused flags (world 1 routes conv3). Beside
        # it, two yardsticks of the bf16 step's own noise: the same step on
        # the batch with its halves swapped (BN sums in another order, as on
        # two ranks), and the step in fp32 "highest".
        def one_step(step_cfg, rows):
            net = build_pose_net(step_cfg, device="cuda", trainable=True, state_dict=start)
            o, sc = make_optimizer(net, step_cfg, 100)
            return {k: float(v) for k, v in make_train_step(net, o, step_cfg, scheduler=sc)(
                {k: v[rows] for k, v in batch.items()}).items()}

        half = gb // DP_RANKS
        swapped = one_step(cfg, torch.cat([torch.arange(half, gb), torch.arange(half)]).cuda())
        fp32_cfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32",
                                                         matmul_precision="highest"))
        fp32 = one_step(fp32_cfg, torch.arange(gb).cuda())
        opt, sched = make_optimizer(model, cfg, 100)
        one = {k: float(v) for k, v in make_train_step(model, opt, cfg, scheduler=sched)(batch).items()}
        for blk in model.modules():
            if isinstance(blk, Bottleneck):
                blk.fused_1x1 = blk.fused_conv3 = True
        lean = make_train_step(model, opt, cfg, lean=True, scheduler=sched)
        lean(batch)
        torch.cuda.synchronize()
        _zero_counts(fhi, iv, mm, cb)
        lean(batch)
        torch.cuda.synchronize()
        world1 = _counts(fhi, iv, mm, cb)
        del model, opt, lean
        torch.cuda.empty_cache()

        # (b) and (c): two ranks on the card over gloo
        t0 = time.perf_counter()
        ranks = launch.spawn(_dp_rank, DP_RANKS, "gloo", work, gpu, workdir=work)
        t_ranks = time.perf_counter() - t0

        # One process's Tester on the same weights and samples (two batches of 64).
        tester = Tester(cfg, dataset=build_dataset(cfg.data.testset, "test", cfg, "synthetic", DP_TEST),
                        state=net, num_workers=8, device="cuda")
        try:
            want_vox = tester.predict_voxels()
        finally:
            tester.close()

    steps = (DP_STEPS, DP_STEPS, 0, 0, 0, 0, 0, 0)
    failed = []  # every check runs and prints; the phase raises at its end
    for rank, r in enumerate(ranks):
        eval_want = (r["eval_batches"], 0, 0, 0, 0, 0, 0, 0)
        if r["counts"] != steps or r["fused_counts"] != DP_FUSED or r["eval_counts"] != eval_want:
            failed.append(f"dp rank {rank}: launches K1-K8 {r['counts']} in {DP_STEPS} steps (want {steps}), "
                          f"{r['fused_counts']} in a fused step (want {DP_FUSED}), {r['eval_counts']} in eval")
        if not (abs(r["first"]["loss"] - one["loss"]) <= TOL_DP_LOSS * abs(one["loss"])
                and abs(r["first"]["grad_norm"] - one["grad_norm"])
                <= TOL_DP_NORM_BF16 * abs(one["grad_norm"] - fp32["grad_norm"])):
            failed.append(f"dp rank {rank}: first step {r['first']}, one process {one}, fp32 {fp32}")
        if not (abs(r["fp32"]["loss"] - fp32["loss"]) <= TOL_DP_FP32[0] * abs(fp32["loss"])
                and abs(r["fp32"]["grad_norm"] - fp32["grad_norm"]) <= TOL_DP_FP32[1] * fp32["grad_norm"]):
            failed.append(f"dp rank {rank}: fp32 step {r['fp32']}, one process {fp32}")
    if len({r["digest"] for r in ranks}) != 1:
        failed.append("dp (b): parameters and BN buffers differ between the ranks")
    err_vox = max(float(np.abs(r["preds"] - want_vox).max()) for r in ranks)
    spread = float(np.abs(want_vox - want_vox.mean()).max())
    if not (err_vox <= TOL_DP_EVAL and spread > 1.0 and ranks[0]["metrics"] == ranks[1]["metrics"]
            and len(ranks[0]["written"]) >= 3 and ranks[1]["written"] == []):
        failed.append(f"dp (c): predictions {err_vox} voxel from one process's (spread {spread}), metrics "
                      f"{[r['metrics'] for r in ranks]}, written {[r['written'] for r in ranks]}")
    r0 = ranks[0]
    print(f"dp (b): the bf16 step's own noise: one process with the batch's halves swapped, loss "
          f"{swapped['loss']:.6f} / |g| {swapped['grad_norm']:.6f}; in fp32 \"highest\" {fp32['loss']:.6f} / "
          f"{fp32['grad_norm']:.6f}")
    print(f"dp (b): the step in fp32 \"highest\" (K1/K2-fp32 head) on {DP_RANKS} ranks, loss "
          f"{r0['fp32']['loss']:.6f} / |g| {r0['fp32']['grad_norm']:.6f}, against one process "
          f"{fp32['loss']:.6f} / {fp32['grad_norm']:.6f} (bars {TOL_DP_FP32[0]:g} / {TOL_DP_FP32[1]:g})")
    print(f"dp (b): {DP_RANKS} ranks over gloo on one card, {DP_CONFIG} at batch {gb // DP_RANKS} a rank "
          f"({gb} global), in {t_ranks:.1f} s: first step loss {r0['first']['loss']:.6f} / |g| "
          f"{r0['first']['grad_norm']:.6f} against one process on the {gb}-image batch {one['loss']:.6f} / "
          f"{one['grad_norm']:.6f}; after {DP_STEPS} steps parameters and BN buffers bitwise equal on the ranks; "
          f"K1/K2 per rank {[r['counts'][:2] for r in ranks]}")
    print(f"dp (b): K1 vs plain {max(r['k1_err'] for r in ranks):.3g} voxel, K2 vs plain_bwd "
          f"{max(r['k2_err'] for r in ranks):.3g} on one step's head inputs (B={gb // DP_RANKS} a rank)")
    for rank, r in enumerate(ranks):
        print(f"dp (b) rank {rank}: device {r['ms']:.3f} ms per step (both flags {r['fused_ms']:.3f}), peak "
              f"{r['peak_gib']:.2f} GiB (CUDA events; two ranks share the card and gloo reduces through host "
              f"memory: not a scaling number)  [{gpu}]")
        print(r["profile"])
    print(f"dp (b): both fused flags, K1-K8 per rank per step {[r['fused_counts'] for r in ranks]} (world 2: "
          f"K7/K8 never); one process on the {gb}-image batch {world1}; K5 vs plain "
          f"{max(r['k5_err'] for r in ranks):.3g}, K6 {max(r['k6_err'] for r in ranks):.3g}")
    print(f"dp (c): the {DP_RANKS}-rank Tester on {DP_TEST} samples ({r0['eval_batches']} global batch, K1 "
          f"{[r['eval_counts'][0] for r in ranks]} per rank): gathered predictions {err_vox:.3g} voxel from one "
          f"process's (spread {spread:.3g}); MPJPE {r0['metrics'].get('MPJPE total', float('nan')):.2f} on both "
          f"ranks; rank 0 wrote {len(r0['written'])} files, rank 1 none")
    if failed:
        raise AssertionError("; ".join(failed))
    launches = {k: sum(r["counts"][i] + r["fused_counts"][i] + r["eval_counts"][i] for r in ranks)
                for k, i in (("K1", 0), ("K2", 1), ("K5", 4), ("K6", 5))}
    errs = {"K1": max(r["k1_err"] for r in ranks), "K2": max(r["k2_err"] for r in ranks),
            "K5": max(r["k5_err"] for r in ranks), "K6": max(r["k6_err"] for r in ranks)}
    return launches, errs


# --- 7e-7g: data-parallel serving, the device warp, the serving bench ----------

DP_SERVE_RANKS = 2  # two ranks on the one card, over gloo
DP_SERVE_PATCHES = 40  # two dispatches of max_batch 32, the second padded
# Gathered coords of two ranks (16 rows a rank and dispatch, 32 with the
# flip-test's mirrors) against one process's server at the same dispatch
# (max_batch 16), voxel. Against one process at max_batch 32 the bf16 convs
# run at another batch, and cuDNN's algorithms for it round otherwise: that
# gap is printed beside the same gap between the two one-process servers.
TOL_DP_SERVE = 1e-3
# The canvas path against the host-warp path (PARITY.md "host-warp vs
# device-warp paths"): joints, voxel; pixels' p99, normalized units.
TOL_WARP_JOINTS = 1e-2
TOL_WARP_P99 = 0.05
WARP_STEPS = 5  # counted train steps on canvas batches


def _serve_inputs(cfg):
    """Seeded uint8 patches, two frames and a 5-person request, as serve_phase draws them."""
    in_h, in_w = cfg.data.input_shape
    rng = np.random.RandomState(SEED)
    patches = rng.randint(0, 256, (DP_SERVE_PATCHES, in_h, in_w, 3)).astype(np.uint8)
    images = [rng.randint(0, 256, (480, 640, 3)).astype(np.uint8),
              rng.randint(0, 256, (720, 1280, 3)).astype(np.uint8)]
    bboxes = np.array([[100, 80, 200, 300], [300, 50, 180, 360], [10, 10, 400, 450],
                       [500, 100, 300, 500], [900, 200, 250, 480]], np.float32)
    return patches, [images[0]] * 2 + [images[1]] * 3, bboxes


def _dp_serve_rank(rank: int, world: int, work: str, gpu: str):
    """One rank of dp_serve_phase on cuda:0 over gloo: a data-parallel
    PoseServer (partition="data") on the seeded weights; predict_patches of
    DP_SERVE_PATCHES and one 5-person predict, counted; ms a dispatch (CUDA
    events) and the gather's share of a dispatch's host time."""
    from ihpr_tpu_torch.config import get_config
    from ihpr_tpu_torch.engine.server import PoseServer
    from ihpr_tpu_torch.ops import fused_head_integral as fhi
    from ihpr_tpu_torch.parallel.mesh import all_gather_rows, data_parallel

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    inputs = torch.load(f"{work}/inputs.pt", weights_only=False)
    cfg = get_config("h36m3d_r50")
    dp = data_parallel()
    server = PoseServer(cfg, inputs["model"], max_batch=MAX_BATCH, flip_test=True, device="cuda", dp=dp,
                        partition="data")
    patches, images, bboxes = inputs["patches"], inputs["images"], inputs["bboxes"]
    server.predict_patches(patches[:MAX_BATCH])  # warm-up: cuDNN setup, kernel load
    torch.cuda.synchronize()

    # --- the main path, counted: predict_patches, then predict ---
    fhi.launches = fhi.bwd_launches = 0
    voxels = server.predict_patches(patches)
    k1_patches = fhi.launches
    results = server.predict(images, bboxes, root_z=np.full(len(bboxes), 4500.0))
    torch.cuda.synchronize()
    k1 = fhi.launches
    # -------------------------------------------------------------
    chunk = patches[:MAX_BATCH]
    ms = _cuda_ms(lambda: server.submit_patches(chunk), 5, reps=3)
    local = server._forward(torch.from_numpy(np.ascontiguousarray(chunk[server._rows])).cuda(), server._ones)
    torch.cuda.synchronize()

    def host_ms(fn, n=10):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    dispatch_ms = host_ms(lambda: server.submit_patches(chunk).cpu())
    gather_ms = host_ms(lambda: all_gather_rows(local, dp).cpu())
    return {"voxels": voxels, "coords_img": np.stack([r.coords_img for r in results]), "k1": k1,
            "k1_patches": k1_patches, "ms": ms, "dispatch_ms": dispatch_ms, "gather_ms": gather_ms,
            "rows": (server._rows.start, server._rows.stop)}


def dp_serve_phase(fhi, gpu: str):
    """Data-parallel serving of h36m3d_r50 (ResNet-50, 256x256, bf16, J=18,
    D=64, flip-test, max_batch 32) on DP_SERVE_RANKS ranks on the one card
    over gloo (parallel.launch.spawn; NCCL refuses two ranks on one device),
    from seeded, peaked weights: each rank serves DP_SERVE_PATCHES patches (2
    dispatches) and one 5-person predict (1), K1 counted per rank (a launch a
    dispatch: the rank's 16 rows and their mirrors); the gathered coords the
    same on both ranks, and against one process's server on the same
    weights at the ranks' dispatch (max_batch 16; bitwise, or within
    TOL_DP_SERVE, stated), with the distance from one process at max_batch
    32 beside the two one-process servers' own distance; ms a dispatch a rank
    (CUDA events) and the gather's share of a dispatch's host time (two
    ranks share the card: not a scaling number). Returns the ranks' K1
    launches."""
    from ihpr_tpu_torch.config import get_config
    from ihpr_tpu_torch.data.augment import finalize_patch
    from ihpr_tpu_torch.engine.server import PoseServer
    from ihpr_tpu_torch.models.pose_net import build_pose_net
    from ihpr_tpu_torch.parallel import launch

    cfg = get_config("h36m3d_r50")
    gen = torch.Generator().manual_seed(SEED)
    model = build_pose_net(cfg, device="cuda", generator=gen)
    patches, images, bboxes = _serve_inputs(cfg)
    with torch.inference_mode():
        image = finalize_patch(torch.from_numpy(patches[:MAX_BATCH]).cuda(),
                               torch.ones(MAX_BATCH, 3, device="cuda"), cfg.data)
    _peak_heatmaps(model, image, gen)
    root_z = np.full(len(bboxes), 4500.0)
    want, want_img = {}, {}
    for mb in (MAX_BATCH // DP_SERVE_RANKS, MAX_BATCH):  # the ranks' dispatch, and one process's
        one = PoseServer(cfg, model, max_batch=mb, flip_test=True, device="cuda")
        want[mb] = one.predict_patches(patches)
        want_img[mb] = np.stack([r.coords_img for r in one.predict(images, bboxes, root_z=root_z)])
        del one
        torch.cuda.empty_cache()
    same = MAX_BATCH // DP_SERVE_RANKS
    with tempfile.TemporaryDirectory() as work:
        torch.save({"model": {k: v.detach().cpu() for k, v in model.state_dict().items()}, "patches": patches,
                    "images": images, "bboxes": bboxes}, f"{work}/inputs.pt")
        del model
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = launch.spawn(_dp_serve_rank, DP_SERVE_RANKS, "gloo", work, gpu, workdir=work, timeout_s=600)
        t_spawn = time.perf_counter() - t0
    dispatches = math.ceil(DP_SERVE_PATCHES / MAX_BATCH)
    total = dispatches + math.ceil(len(bboxes) / MAX_BATCH)
    for rank, r in enumerate(ranks):
        rows = MAX_BATCH // DP_SERVE_RANKS
        if (r["k1_patches"], r["k1"]) != (dispatches, total) or r["rows"] != (rank * rows, (rank + 1) * rows):
            raise AssertionError(f"dp-serve rank {rank}: K1 {r['k1_patches']}/{r['k1']} launches for "
                                 f"{dispatches}/{total} dispatches, rows {r['rows']}")
        if r["voxels"].shape != want[same].shape or not np.isfinite(r["voxels"]).all():
            raise AssertionError(f"dp-serve rank {rank}: coords {r['voxels'].shape}, finite "
                                 f"{np.isfinite(r['voxels']).all()}")
    if not all(np.array_equal(r["voxels"], ranks[0]["voxels"]) and np.array_equal(r["coords_img"], ranks[0]["coords_img"])
               for r in ranks):
        raise AssertionError("dp-serve: the ranks' gathered coords differ")
    got = ranks[0]["voxels"]
    err = float(np.abs(got - want[same]).max())
    spread = float(np.abs(want[same] - want[same].mean()).max())
    bitwise = np.array_equal(got, want[same]) and np.array_equal(ranks[0]["coords_img"], want_img[same])
    if not (err <= TOL_DP_SERVE and spread > 1.0):
        raise AssertionError(f"dp-serve: gathered coords {err} voxel from one process's at max_batch {same} "
                             f"(spread {spread})")
    gap, yard = (float(np.abs(a - want[MAX_BATCH]).max()) for a in (got, want[same]))
    print(f"dp-serve: {DP_SERVE_RANKS} ranks (gloo, one card), max_batch {MAX_BATCH}: predict_patches "
          f"{DP_SERVE_PATCHES} in {dispatches} dispatches + one 5-person predict; K1 per rank "
          f"{[r['k1'] for r in ranks]} ({total} dispatches, rows {[r['rows'] for r in ranks]}); "
          f"gathered coords equal on the ranks, {'bitwise' if bitwise else f'{err:.3g} voxel from'} one "
          f"process's at max_batch {same}, the ranks' dispatch (spread {spread:.3g}); {gap:.3g} voxel from one "
          f"process's at max_batch {MAX_BATCH}, whose own distance from max_batch {same} is {yard:.3g} (bf16 "
          f"convs at another batch); spawn {t_spawn:.1f} s")
    for rank, r in enumerate(ranks):
        print(f"dp-serve rank {rank}: {r['ms']:.3f} ms a {MAX_BATCH}-patch flip-test dispatch (CUDA events); "
              f"host {r['dispatch_ms']:.3f} ms a dispatch read back, of which the gather {r['gather_ms']:.3f} ms "
              f"({r['gather_ms'] / r['dispatch_ms']:.3f}); two ranks share the card: not a scaling number  [{gpu}]")
    return sum(r["k1"] for r in ranks)


def device_warp_phase(fhi, gpu: str):
    """The canvas path of h36m3d_r50 at full width (batch 128, synthetic
    H36M+MPII), selected explicitly (BatchLoader(host_warp=False), and the
    native warp reported missing to the server) while the native library is
    there: (a) native.available() on this host, so the main paths stay on the
    host warp; (b) without augmentation, one batch through both paths:
    joints within TOL_WARP_JOINTS voxel, pixels' p99 within TOL_WARP_P99
    (PARITY.md), the device warp's ms a batch (CUDA events) beside the native
    warp's host ms; (c) WARP_STEPS counted train steps with augmentation
    through the Trainer on canvas batches: K1/K2 one a step, finite losses,
    ms a step; (d) the Tester on EVAL_SAMPLES test samples on canvas batches
    (K1 once a batch) beside the host path's metrics; (e) PoseServer.predict
    through the device warp: its patches within (b)'s pixel bar of the native
    warp's, and the coords' distance. Returns K1 and K2 launches."""
    from ihpr_tpu_torch.config import get_config
    from ihpr_tpu_torch.data import native, skeletons
    from ihpr_tpu_torch.data.augment import finalize_patch, make_patch_batch
    from ihpr_tpu_torch.data.datasets import build_dataset
    from ihpr_tpu_torch.data.pipeline import BatchLoader, HostBatch, prefetch_to_device
    from ihpr_tpu_torch.data.warp import gen_trans_np
    from ihpr_tpu_torch.engine.server import PoseServer
    from ihpr_tpu_torch.engine.tester import Tester
    from ihpr_tpu_torch.engine.trainer import Trainer
    from ihpr_tpu_torch.models.pose_net import build_pose_net

    # (a)
    if not native.available():
        raise AssertionError(f"the native warp is unavailable on this host: {native.unavailable_reason()}")
    print("device-warp (a): native.available() True: the main paths take the host warp; this phase "
          "selects the canvas path itself")

    # (b) one batch through both paths, no augmentation
    base = get_config("h36m3d_r50")
    cfg = base.replace(data=dataclasses.replace(base.data, use_aug=False))
    in_h, in_w = cfg.data.input_shape
    primary = skeletons.get_skeleton(cfg.data.trainset[0])
    sets = [build_dataset(name, "train", cfg, "synthetic", TRAIN_BATCH, hue_skeleton=primary if i else None)
            for i, name in enumerate(cfg.data.trainset)]
    kw = dict(num_workers=8, seed=cfg.seed)
    host_loader = BatchLoader(sets, cfg, TRAIN_BATCH, host_warp=True, **kw)
    canvas_loader = BatchLoader(sets, cfg, TRAIN_BATCH, host_warp=False, **kw)
    try:
        hb = next(host_loader.epoch(0, 1))
        t0 = time.perf_counter()
        db = next(canvas_loader.epoch(0, 1))
        canvas_host_ms = (time.perf_counter() - t0) * 1e3
        entries = [canvas_loader.index[i] for i in db.sample_idx]
        frames = canvas_loader._load_entry_images(entries)
    finally:
        host_loader.close()
        canvas_loader.close()
    if not (isinstance(db, HostBatch) and np.array_equal(hb.sample_idx, db.sample_idx)):
        raise AssertionError("device-warp (b): the two loaders gave other samples")
    batch, _ = next(prefetch_to_device(iter([db]), "cuda"))
    perm = primary.flip_permutation()
    args = [batch[k] for k in ("canvas", "canvas_origin", "canvas_scale", "bbox", "joints", "joint_vis",
                               "joints_have_depth")]
    pb = make_patch_batch(*args, perm, cfg.data, train=False)
    host_img = finalize_patch(torch.from_numpy(hb.patch).cuda(), torch.from_numpy(hb.color_scale).cuda(), cfg.data)
    j_err = float(np.abs(pb.joint_img.cpu().numpy() - hb.joint_img).max())
    p99 = float(np.percentile((pb.image - host_img).abs().cpu().numpy(), 99))
    vis_equal = np.array_equal(pb.joint_vis.cpu().numpy(), hb.joint_vis)
    if not (j_err <= TOL_WARP_JOINTS and p99 < TOL_WARP_P99 and vis_equal):
        raise AssertionError(f"device-warp (b): joints {j_err} voxel, pixel p99 {p99}, vis equal {vis_equal}")
    warp_ms = _cuda_ms(lambda: make_patch_batch(*args, perm, cfg.data, train=False), 3, reps=3)
    bbox = canvas_loader._unified[3][db.sample_idx]
    invs = gen_trans_np(bbox[:, 0] + bbox[:, 2] * 0.5, bbox[:, 1] + bbox[:, 3] * 0.5, bbox[:, 2], bbox[:, 3],
                        in_w, in_h, 1.0, 0.0, inv=True)
    flips = np.zeros(len(frames), np.int32)
    native.warp_batch(frames, invs, flips, in_h, in_w)
    t0 = time.perf_counter()
    for _ in range(3):
        native.warp_batch(frames, invs, flips, in_h, in_w)
    native_ms = (time.perf_counter() - t0) * 1e3 / 3
    print(f"device-warp (b): {TRAIN_BATCH} samples (H36M+MPII, no aug), canvas path vs host path: joints "
          f"{j_err:.3g} voxel (bar {TOL_WARP_JOINTS}), pixels p99 {p99:.3g} (bar {TOL_WARP_P99}), vis equal; "
          f"canvases {db.canvas.nbytes / 1e6:.1f} MB vs patches {hb.patch.nbytes / 1e6:.1f} MB; {int((db.canvas_scale > 1).sum())} "
          f"canvases resampled")
    print(f"device-warp (b): make_patch_batch {warp_ms:.3f} ms a {TRAIN_BATCH}-batch on the card (CUDA events); "
          f"native warp {native_ms:.3f} ms on {os.cpu_count()} host cores; canvas batch built in "
          f"{canvas_host_ms:.1f} ms on the host (render + crop)  [{gpu}]")
    del batch, pb, host_img, args

    # (c) the Trainer on canvas batches, augmentation on
    scratch = tempfile.TemporaryDirectory()
    tcfg = base.replace(output_dir=scratch.name)
    trainer = Trainer(tcfg, data_root="synthetic", synthetic_size=TRAIN_BATCH * 3, num_workers=8, device="cuda")
    try:
        trainer.loader.close()
        trainer.loader = BatchLoader(trainer.loader.datasets, tcfg, trainer.batch_size, num_workers=8,
                                     seed=tcfg.seed, host_warp=False)
        trainer.cap_steps_per_epoch(WARP_STEPS)
        resident, _ = next(prefetch_to_device(trainer.loader.epoch(7, 1), "cuda"))
        trainer.lean_step_fn(resident, 7, 0)  # warm-up
        torch.cuda.synchronize()

        # --- the main path, counted: one epoch of WARP_STEPS steps on canvas batches ---
        fhi.launches = fhi.bwd_launches = 0
        t0 = time.perf_counter()
        trainer.train(trainer.start_epoch + 1)
        torch.cuda.synchronize()
        t_epoch = time.perf_counter() - t0
        k1, k2 = fhi.launches, fhi.bwd_launches
        # ------------------------------------------------------------------------------
        losses = [float(x) for x in trainer.losses]
        if (k1, k2) != (WARP_STEPS, WARP_STEPS) or len(losses) != WARP_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"device-warp (c): K1/K2 {k1}/{k2} in {WARP_STEPS} steps, losses {losses}")
        step_ms = _cuda_ms(lambda: trainer.lean_step_fn(resident, 7, 1), 3, reps=1)
    finally:
        trainer.close()
        scratch.cleanup()
    print(f"device-warp (c): {WARP_STEPS} Trainer steps on canvas batches (aug on, draws from (seed, epoch, "
          f"step)), K1 {k1}, K2 {k2}; losses {', '.join(f'{x:.4f}' for x in losses)}")
    print(f"device-warp (c): device {step_ms:.3f} ms a step on one resident canvas batch (CUDA events); host "
          f"clock {t_epoch * 1e3 / WARP_STEPS:.3f} ms a step, loader included  [{gpu}]")
    del trainer, resident
    torch.cuda.empty_cache()

    # (d) the Tester on canvas batches, beside the host path
    metrics, preds, times = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        ecfg = base.replace(output_dir=tmp)
        gen = torch.Generator().manual_seed(SEED)
        dataset = build_dataset(ecfg.data.testset, "test", ecfg, "synthetic", EVAL_SAMPLES)
        testers = {"host": Tester(ecfg, dataset=dataset, state=build_pose_net(ecfg, device="cuda", generator=gen),
                                  num_workers=8, device="cuda")}
        try:
            hb = next(testers["host"].loader.epoch())
            with torch.inference_mode():
                image = finalize_patch(torch.from_numpy(hb.patch).cuda(), torch.from_numpy(hb.color_scale).cuda(),
                                       ecfg.data)
            model = testers["host"].model
            _peak_heatmaps(model, image, gen)
            testers["canvas"] = Tester(ecfg, dataset=dataset, state=model, num_workers=8, device="cuda")
            testers["canvas"].loader.close()
            testers["canvas"].loader = BatchLoader([dataset], ecfg, ecfg.eval.batch_size_per_device, train=False,
                                                   num_workers=8, host_warp=False)
            for path, tester in testers.items():
                scored = []
                predict = tester.predict_voxels
                tester.predict_voxels = lambda predict=predict: (scored.append(predict()), scored[-1])[1]
                fhi.launches = 0
                t0 = time.perf_counter()
                metrics[path] = tester.evaluate()
                times[path] = time.perf_counter() - t0
                if path == "canvas":
                    eval_k1, batches = fhi.launches, len(tester.loader)
                preds[path] = scored[0]
        finally:
            for tester in testers.values():
                tester.close()
    key = "MPJPE total"
    gap = float(np.abs(preds["canvas"] - preds["host"]).max())
    if eval_k1 != batches or not (math.isfinite(metrics["canvas"][key]) and np.isfinite(preds["canvas"]).all()):
        raise AssertionError(f"device-warp (d): K1 {eval_k1} for {batches} batches, {key} {metrics['canvas'][key]}")
    print(f"device-warp (d): Tester on {EVAL_SAMPLES} samples, canvas path: K1 {eval_k1} = batches {batches}; "
          f"{key} {metrics['canvas'][key]:.2f} (host path {metrics['host'][key]:.2f}); predictions at most "
          f"{gap:.3g} voxel from the host path's")
    print(f"device-warp (d): Tester.evaluate host path {times['host']:.3f} s, canvas path {times['canvas']:.3f} s "
          f"(host clock, loader included)  [{gpu}]")

    # (e) the server's device warp
    _, images, bboxes = _serve_inputs(base)
    server = PoseServer(base, model, max_batch=MAX_BATCH, flip_test=True, device="cuda")
    native_patches, _ = server._preprocess(images, bboxes)
    want = server.predict(images, bboxes)
    available = native.available
    native.available = lambda: False
    try:
        fhi.launches = 0
        dev_patches, _ = server._preprocess(images, bboxes)
        got = server.predict(images, bboxes)
        serve_k1 = fhi.launches
    finally:
        native.available = available
    ones = torch.ones(len(bboxes), 3, device="cuda")
    a, b = (finalize_patch(torch.from_numpy(p).cuda(), ones, base.data) for p in (dev_patches, native_patches))
    p99 = float(np.percentile((a - b).abs().cpu().numpy(), 99))
    steps = int(np.abs(dev_patches.astype(int) - native_patches.astype(int)).max())
    coord_gap = max(float(np.abs(g.coords_voxel - w.coords_voxel).max()) for g, w in zip(got, want))
    dispatches = math.ceil(len(bboxes) / MAX_BATCH)
    if not (p99 < TOL_WARP_P99 and serve_k1 == dispatches and all(np.isfinite(g.coords_img).all() for g in got)):
        raise AssertionError(f"device-warp (e): patches p99 {p99} from the native warp's, K1 {serve_k1}")
    print(f"device-warp (e): PoseServer.predict of 5 people through the device warp (uint8 by truncation): "
          f"patches within {steps} intensity steps of the native warp's, p99 {p99:.3g} normalized (bar "
          f"{TOL_WARP_P99}); coords {coord_gap:.3g} voxel from the native path's; K1 {serve_k1}")
    return k1 + eval_k1 + serve_k1, k2


def serving_bench_phase(gpu: str):
    """``python -m ihpr_tpu_torch.tools.serving_bench`` (h36m3d_r50, max_batch
    32, 24 chunks, flip-test) in a subprocess: exit 0; its JSON line echoed."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ihpr_tpu_torch.tools.serving_bench"], cwd=root,
                          capture_output=True, text=True, timeout=600, env={**os.environ, "PYTHONPATH": root})
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"serving_bench exit {proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    out = json.loads(lines[-1])
    if out.get("sustained_img_per_s") is None or not all(
            math.isfinite(v) for v in out.values() if isinstance(v, float)):
        raise AssertionError(f"serving_bench printed {lines[-1]}")
    for line in lines[:-1]:
        print(f"serving-bench: {line}")
    print(f"serving-bench: exit 0 in {dt:.1f} s; its JSON line: {lines[-1]}")


# --- the real-data path: dataset roots of JPEGs, nvJPEG, --pretrained ----------

REAL_TRAIN = 256  # H36M train samples of the real-data root (S1, 5, 6, 7, 8) ...
REAL_MPII = 128  # ... and MPII's: 384 = 3 train batches of 128
REAL_TEST = 128  # H36M test samples (S9, 11): one eval batch
REAL_SIZE = 1000  # H36M frame side, px (the release's frames are 1000x1000 or 1000x1002)
REAL_STEPS = 3  # counted steps of the train CLI
# Steps of the rate loop after the counted run (epochs 1-3 of the root): the
# Trainer's log window, waited for after its first step and at its end only,
# so that each batch loads while the step before it runs, as in a long run.
REAL_RATE_STEPS = 9
# The card's decode (nvJPEG's planes + the colour kernel) against libjpeg on
# the fixture's frames, levels of 255 (tests/test_torch_jpeg.py's bars:
# measured on an H100, RGB max 3, mean 0.0172-0.0186 per image; each plane
# max 1, mean at most 0.0172; only the IDCTs differ). nvJPEG's own RGBI sat
# up to 67 levels and 0.59-0.69 on average away: the phase prints it beside.
TOL_NVJPEG_MAX = 4
TOL_NVJPEG_MEAN = 0.025
TOL_NVJPEG_PLANE_MAX = 2
TOL_NVJPEG_PLANE_MEAN = 0.025
# The loader's no-aug patches of those frames (bilinear samples of them)
# against the JAX loader's: measured max 3, mean 0.0194 with the colour
# kernel (54 and 0.7313 from nvJPEG's RGBI, under bars of 60 and 0.8); the
# bars are the decode's.
TOL_PATCH_MAX = TOL_NVJPEG_MAX
TOL_PATCH_MEAN = TOL_NVJPEG_MEAN
# (d) The test CLI's coordinates from the JPEGs (nvJPEG) against the same
# JPEGs decoded by libjpeg (cv2, on the host) through the same snapshot,
# whose heads were peaked from random weights: such a net amplifies the
# decoders' small differences, and a joint with two near-equal peaks jumps
# between them, so the bound is on the mean and the largest gap is
# printed. The distance of each decode from the same frames rendered
# without JPEG is printed beside it (how far the compression alone moves
# the coordinates is the net's). Measured: x/y mean 0.968 px, max 36.3
# px; z mean 0.326 mm, p99 0, max 125 mm (JAX's initial head; from the
# render nvJPEG sits at 1.99 px / 1.03 mm and libjpeg at 2.05 / 1.14).
TOL_REAL_XY = 2.0  # mean, px
TOL_REAL_Z = 0.65  # mean, mm

_REAL_TRAIN_CHILD = r"""
import itertools, json, sys, time
import torch
import chip_smoke
from ihpr_tpu_torch import train
from ihpr_tpu_torch.data.augment import finalize_patch
from ihpr_tpu_torch.data.pipeline import prefetch_to_device
from ihpr_tpu_torch.engine.trainer import Trainer
from ihpr_tpu_torch.models import pretrained
from ihpr_tpu_torch.ops import fused_head_integral as fhi
from ihpr_tpu_torch.ops import jpeg_color

argv, pth = json.loads(sys.argv[1]), sys.argv[2]
real_train, report = Trainer.train, {}


def train_and_report(self, *args, **kwargs):
    want, got = pretrained.read(pth), self.model.backbone.state_dict()
    report["backbone_is_the_file"] = got.keys() == want.keys() and all(
        torch.equal(got[k].cpu(), want[k]) for k in got)
    # Peaked heatmaps (chip_smoke._peak_heatmaps), so that the evaluation's
    # coordinates depend on the image; the backbone stays the file's.
    batch, _ = next(prefetch_to_device(self.loader.epoch(0, 1), self.device))
    self.model.eval()
    chip_smoke._peak_heatmaps(self.model, finalize_patch(batch["patch"], batch["color_scale"], self.cfg.data),
                              torch.Generator().manual_seed(chip_smoke.SEED))
    self.model.train()
    # The first step is a log step, which the Trainer waits for.
    ends, step_fn = [], self.step_fn

    def timed(*a, **k):
        out = step_fn(*a, **k)
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        return out

    self.step_fn = timed
    fhi.launches = fhi.bwd_launches = jpeg_color.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = real_train(self, *args, **kwargs)
    report.update(k1=fhi.launches, k2=fhi.bwd_launches, losses=[float(x) for x in self.losses],
                  first_ms=(ends[0] - t0) * 1e3)
    # The rate loop, once the snapshot is on disk: the Trainer's steps fed as
    # its epoch loop feeds them, waited for after the first and at the end;
    # the host's time in the loader (next batch) and in the step's call.
    batches = prefetch_to_device(itertools.chain(*(self.loader.epoch(e) for e in (1, 2, 3))), self.device)
    n, load_s, call_s = 0, 0.0, 0.0
    while True:
        t = time.perf_counter()
        batch = next(batches, None)
        if batch is None:
            break
        u = time.perf_counter()
        self.lean_step_fn(batch[0])
        n += 1
        if n == 1:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        else:
            load_s, call_s = load_s + u - t, call_s + time.perf_counter() - u
    torch.cuda.synchronize()
    report.update(rate_steps=n, rate_ms=(time.perf_counter() - t1) * 1e3 / (n - 1),
                  rate_load_ms=load_s * 1e3 / (n - 1), rate_call_ms=call_s * 1e3 / (n - 1),
                  rate_k1=fhi.launches - report["k1"], rate_k2=fhi.bwd_launches - report["k2"],
                  colour=jpeg_color.launches)
    return out


Trainer.train = train_and_report
train.main(argv)
print(json.dumps(report))
"""

_REAL_TEST_CHILD = r"""
import json, sys
from ihpr_tpu_torch import test
from ihpr_tpu_torch.ops import fused_head_integral as fhi
from ihpr_tpu_torch.ops import jpeg_color
fhi.launches = fhi.bwd_launches = jpeg_color.launches = 0
metrics = test.main(json.loads(sys.argv[1]))
print(json.dumps({"k1": fhi.launches, "k2": fhi.bwd_launches, "colour": jpeg_color.launches, "metrics": metrics}))
"""


REAL_VIS = 8  # the overlays Tester.evaluate(vis=True) writes by default


def _check_overlays(vis_dir: str, n: int, frame_hw) -> str:
    """The test CLI's --vis files: exactly pred_0.jpg ... pred_{n-1}.jpg, each
    decoding (cv2, on the host) to a frame of ``frame_hw``."""
    import cv2

    names = sorted(os.listdir(vis_dir)) if os.path.isdir(vis_dir) else []
    want = sorted(f"pred_{i}.jpg" for i in range(n))
    if names != want:
        raise AssertionError(f"--vis wrote {names}, want {want}")
    sizes = []
    for name in names:
        img = cv2.imdecode(np.fromfile(os.path.join(vis_dir, name), np.uint8), cv2.IMREAD_COLOR)
        if img is None or img.shape[:2] != tuple(frame_hw):
            raise AssertionError(f"{name}: decodes to {None if img is None else img.shape}, want {frame_hw}")
        sizes.append(os.path.getsize(os.path.join(vis_dir, name)))
    return f"{n} overlays {names[0]} ... {names[-1]}, {frame_hw[1]}x{frame_hw[0]}, {min(sizes)}-{max(sizes)} bytes"


def _nvjpeg_vs(got: torch.Tensor, want: np.ndarray):
    diff = np.abs(got.cpu().numpy().astype(np.int16) - want.astype(np.int16))
    return int(diff.max()), float(diff.mean())


def _child(code: str, *args, timeout: int = 600) -> dict:
    """Run ``code`` in a fresh interpreter at the repository root; its last
    line of output is a JSON object."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=root, capture_output=True, text=True,
                          timeout=timeout, env={**os.environ, "PYTHONPATH": root})
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"exit {proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    return json.loads(lines[-1])


def colour_vs_plain(jpeg, jpeg_color, blobs, label: str) -> int:
    """The colour kernel against its plain version, both on nvJPEG's planes
    of ``blobs`` on the card, every frame: the largest difference in levels.
    Fails above 0 (the kernel is libjpeg's integer arithmetic, as plain is).
    A comparison: the decode's and the kernel's counts are left as they
    were."""
    counts = jpeg.launches, jpeg_color.launches
    planes, layouts = jpeg.decode_planes(blobs, "cuda")
    rgb = jpeg_color.to_rgb(planes, layouts)
    jpeg.launches, jpeg_color.launches = counts
    err = max(int((img.to(torch.int16) - jpeg_color.plain(*jpeg_color.plane_views(planes, lay), lay.hs, lay.vs)
                   .to(torch.int16)).abs().max()) for img, lay in zip(rgb, layouts))
    kinds = sorted({(lay.h, lay.w, (lay.hs, lay.vs)) for lay in layouts})
    print(f"{label}: the colour kernel against its plain version on {len(layouts)} frame(s) (h, w, (hs, vs)) "
          f"{kinds}: max {err} levels")
    if err:
        raise AssertionError(f"{label}: the colour kernel differs from its plain version by {err} levels")
    return err


def colour_times(jpeg, jpeg_color, blobs, mpii_blob: bytes, gpu: str) -> dict:
    """The colour kernel on the planes of ``blobs`` (a train batch of 128
    frames) and of its first frame: held against its plain version on every
    frame of the batch and on one MPII 1280x720 frame (``mpii_blob``),
    kernel and plain times (CUDA events; plain on the same CUDA planes,
    frame by frame), its bound (each plane read once, the RGB written once,
    over the card's memory rate), and the decode with it (nvJPEG's planes +
    the kernel) against nvJPEG's own RGBI decode, per frame alone and per
    batch (host clock, waited for), in turns; then the host's share of the
    planes decode per batch: the start-of-frame parse (``subsampling``), the
    whole layout (``_layouts``: nvJPEG's image info + the parse) and the
    kernel's call (its frame table, the pinned copy, the launch). These
    launches are comparisons and are not counted."""
    err = max(colour_vs_plain(jpeg, jpeg_color, blobs, "real-data (b) H36M batch"),
              colour_vs_plain(jpeg, jpeg_color, [mpii_blob], "real-data (b) MPII frame"))
    planes, layouts = jpeg.decode_planes(blobs, "cuda")
    out = torch.empty(sum(lay.h * lay.w * 3 for lay in layouts), dtype=torch.uint8, device="cuda")
    views = [jpeg_color.plane_views(planes, lay) for lay in layouts]
    res = {}
    for label, lays in (("frame", layouts[:1]), ("batch", layouts)):
        nbytes = sum(lay.h * lay.w * 4 + 2 * (lay.chroma_shape[0] * lay.chroma_shape[1]) for lay in lays)
        res[label] = {
            "ms": _cuda_ms(lambda: jpeg_color.kernel(planes, lays, out), 20),
            "plain_ms": _cuda_ms(lambda: [jpeg_color.plain(*v, lay.hs, lay.vs) for v, lay in zip(views, lays)],
                                 2 if label == "batch" else 10, reps=3),
            "bound_ms": nbytes / PEAK_HBM_BYTES * 1e3,
            "frames": len(lays),
        }
    decode_ms = {}
    for label, fn in (("planes+kernel", jpeg.decode), ("RGBI", jpeg.decode_rgbi)) * 2:
        for n in (1, len(blobs)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3 if n > 1 else 16):
                fn(blobs[:n], "cuda")
            torch.cuda.synchronize()
            decode_ms.setdefault((label, n), []).append((time.perf_counter() - t0) * 1e3 / (3 if n > 1 else 16))
    codec, host_ms = jpeg._codec(), {}
    for _ in range(5):
        for label, fn in (("SOF parse", lambda: [jpeg.subsampling(b) for b in blobs]),
                          ("_layouts", lambda: jpeg._layouts(codec, blobs, None)),
                          ("kernel call", lambda: jpeg_color.kernel(planes, layouts, out))):
            torch.cuda.synchronize()
            with codec.lock:
                t0 = time.perf_counter()
                fn()
                host_ms.setdefault(label, []).append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    for label, r in res.items():
        print(f"real-data (b): colour kernel on {r['frames']} {layouts[0].h}x{layouts[0].w} 4:2:0 frame(s): "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms (bytes; "
              f"{r['bound_ms'] / r['ms']:.2f} of it)  [{gpu}]")
    print("real-data (b): decode, host clock, two rounds in turns: " + "; ".join(
        f"{label} {n} frame(s) {', '.join(f'{t:.3f}' for t in ts)} ms" for (label, n), ts in decode_ms.items())
        + f"  [{gpu}]")
    print(f"real-data (b): host ms a {len(blobs)}-frame batch of the planes decode, median of 5 (min-max): " + "; ".join(
        f"{label} {statistics.median(ts):.3f} ({min(ts):.3f}-{max(ts):.3f})" for label, ts in host_ms.items())
        + f"  [{gpu}]")
    batch = res["batch"]
    return {"ms": batch["ms"], "plain_ms": batch["plain_ms"], "bound_ms": batch["bound_ms"], "err": err}


def real_data_phase(fhi, gpu: str):
    """The real-data path on the card. (a) nvJPEG decodes the fixture's
    JPEGs (tests/data/real_root) against libjpeg's committed pixels, and the
    loader's no-aug host-warp batch of that root against the JAX loader's
    committed patches. (b) A dataset root in the reference's layouts at a
    realistic size (H36M 1000x1000: REAL_TRAIN train samples over S1, 5, 6,
    7, 8 and REAL_TEST test samples over S9, 11; MPII 1280x720: REAL_MPII),
    its frames rendered and encoded on the card (materialize_synthetic);
    encode, decode and loader times. (c) The train CLI's main in a
    subprocess: --data_root <root> --pretrained <a seeded torchvision
    ResNet-50 .pth> --steps REAL_STEPS --end_epoch 1, h36m3d_r50 at full width
    and batch 128: the backbone before step 1 is the file's, the losses
    finite, K1/K2 once a step; the first step's ms, then ms per step and
    img/s over REAL_RATE_STEPS more steps (K1/K2 once each) waited for only
    after the first and at the end, so that each batch loads while the step
    before it runs. (d) The test CLI's
    main in a subprocess on the test split (flip-test, K1 once per eval
    batch): MPJPE; its coordinates against the same samples rendered
    without JPEG through the same snapshot. Returns K1 and K2 launches."""
    from ihpr_tpu_torch.config import get_config
    from ihpr_tpu_torch.data import jpeg, skeletons
    from ihpr_tpu_torch.data.datasets import PoseDataset, build_dataset, load_h36m, load_mpii, render_synthetic_image
    from ihpr_tpu_torch.data.pipeline import BatchLoader, _read_bytes, _to_host
    from ihpr_tpu_torch.engine.tester import Tester, metrics_from_voxel_preds
    from ihpr_tpu_torch.ops import jpeg_color
    from ihpr_tpu_torch.tools.synthetic_root import write_h36m_root, write_mpii_root, write_torchvision_resnet

    t_phase = time.perf_counter()
    cfg = get_config("h36m3d_r50")
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "real_root")

    # (a) the decoder and the loader against libjpeg and the JAX loader
    pixels = np.load(os.path.join(fixture, "pixels.npz"))
    ycbcr = np.load(os.path.join(fixture, "ycbcr.npz"))
    blobs = [_read_bytes(os.path.join(fixture, "images", name)) for name in pixels.files]
    jpeg.launches = jpeg_color.launches = 0
    planes, layouts = jpeg.decode_planes(blobs, "cuda", pixels.files)
    decoded = jpeg_color.to_rgb(planes, layouts)
    torch.cuda.synchronize()
    calls = (jpeg.launches, jpeg_color.launches)
    host = planes.cpu()
    colour_err = max(int((img.cpu().to(torch.int16) - jpeg_color.plain(*jpeg_color.plane_views(host, lay), lay.hs,
                                                                        lay.vs).to(torch.int16)).abs().max())
                     for img, lay in zip(decoded, layouts))
    plane_gaps = {name: {key: _nvjpeg_vs(got, ycbcr[f"{name}/{key}"]) for key, got in
                         zip(("y", "cb", "cr"), jpeg_color.plane_views(host, lay))}
                  for name, lay in zip(pixels.files, layouts)}
    gaps = [_nvjpeg_vs(img, pixels[name]) for img, name in zip(decoded, pixels.files)]
    rgbi_gaps = [_nvjpeg_vs(img, pixels[name]) for img, name in
                 zip(jpeg.decode_rgbi(blobs, "cuda", pixels.files), pixels.files)]
    for name, gap, old in zip(pixels.files, gaps, rgbi_gaps):
        print(f"real-data (a) {name}: planes vs libjpeg's (max, mean levels) "
              + ", ".join(f"{k} {m} {a:.4f}" for k, (m, a) in plane_gaps[name].items())
              + f"; RGB vs libjpeg's pixels {gap[0]} {gap[1]:.4f} (nvJPEG's own RGBI {old[0]} {old[1]:.4f})")
    worst_plane = max((g for gs in plane_gaps.values() for g in gs.values()), key=lambda g: (g[0], g[1]))
    if (calls != (1, 1) or colour_err != 0
            or any(m > TOL_NVJPEG_MAX or a > TOL_NVJPEG_MEAN for m, a in gaps)
            or any(m > TOL_NVJPEG_PLANE_MAX or a > TOL_NVJPEG_PLANE_MEAN
                   for gs in plane_gaps.values() for m, a in gs.values())
            or max(m for m, _ in gaps) >= max(m for m, _ in rgbi_gaps)
            or max(a for _, a in gaps) >= min(a for _, a in rgbi_gaps)):
        raise AssertionError(f"real-data (a): (decode, colour) calls {calls}; colour kernel vs plain {colour_err}; "
                             f"RGB vs libjpeg (max, mean) {gaps}, RGBI {rgbi_gaps}; planes {plane_gaps}")
    print(f"real-data (a): nvJPEG decoded the fixture's {len(blobs)} JPEGs to planes in one call, the colour kernel "
          f"converted them in one launch, equal to its plain version bitwise; against libjpeg's pixels max "
          f"{max(m for m, _ in gaps)} levels (bar {TOL_NVJPEG_MAX}), mean {min(a for _, a in gaps):.4f}-"
          f"{max(a for _, a in gaps):.4f} per image (bar {TOL_NVJPEG_MEAN}); planes at most {worst_plane[0]} "
          f"(bar {TOL_NVJPEG_PLANE_MAX}); nvJPEG's own RGBI max {max(m for m, _ in rgbi_gaps)}, mean "
          f"{min(a for _, a in rgbi_gaps):.4f}-{max(a for _, a in rgbi_gaps):.4f}")
    h36m_fix = load_h36m(fixture, "test", 2, sampling=1)
    sets = [PoseDataset("Human36M", skeletons.H36M, h36m_fix, True),
            PoseDataset("MPII", skeletons.MPII, load_mpii(fixture, "train"), True)]
    loader = BatchLoader(sets, cfg, 6, train=False, num_workers=4, host_warp=True, device="cuda")
    try:
        hb = next(loader.epoch(0))
    finally:
        loader.close()
    ref = np.load(os.path.join(fixture, "patches.npz"))
    p_max, p_mean = _nvjpeg_vs(torch.from_numpy(hb.patch), ref["patch"])
    if not (np.array_equal(hb.sample_idx, ref["sample_idx"]) and np.array_equal(hb.joint_img, ref["joint_img"])
            and p_max <= TOL_PATCH_MAX and p_mean <= TOL_PATCH_MEAN):
        raise AssertionError(f"real-data (a): loader patches vs JAX's: max {p_max}, mean {p_mean}")
    print(f"real-data (a): the loader's no-aug host-warp batch of the fixture root (nvJPEG + native warp) against "
          f"the JAX loader's (libjpeg + native warp): joints bitwise, patches max {p_max} levels (bar "
          f"{TOL_PATCH_MAX}), mean {p_mean:.4f} (bar {TOL_PATCH_MEAN})")

    with tempfile.TemporaryDirectory() as tmp:
        root, run = os.path.join(tmp, "root"), os.path.join(tmp, "run")
        # (b) the root, encoded on the card; encode, decode and loader times
        t0 = time.perf_counter()
        written = write_h36m_root(root, REAL_TRAIN, REAL_TEST, REAL_SIZE, device="cuda")
        mpii = write_mpii_root(root, REAL_MPII, device="cuda")
        t_root = time.perf_counter() - t0
        train_files = sorted({s["img_path"] for s in written["train"]})
        frames = [render_synthetic_image(s) for s in written["train"][:32]]
        jpeg.encode(frames[:2], 95, "cuda")  # warm-up
        t0 = time.perf_counter()
        jpeg.encode(frames, 95, "cuda")
        enc_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
        blobs = [_read_bytes(p) for p in train_files[:128]]
        for blob in blobs[:4]:  # warm-up
            jpeg.decode([blob], "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for blob in blobs[:32]:
            jpeg.decode([blob], "cuda")
        torch.cuda.synchronize()
        dec1_ms = (time.perf_counter() - t0) * 1e3 / 32
        batch_ms, back_ms = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            imgs = jpeg.decode(blobs, "cuda")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            host = _to_host(imgs)
            batch_ms.append((t1 - t0) * 1e3)
            back_ms.append((time.perf_counter() - t1) * 1e3)
        colour = colour_times(jpeg, jpeg_color, blobs, _read_bytes(mpii[0]["img_path"]), gpu)
        colour["err"] = max(colour["err"], colour_err)
        mb = sum(map(len, blobs)) / 2**20
        print(f"real-data (b): wrote {len(written['train'])} + {len(written['test'])} H36M {REAL_SIZE}x{REAL_SIZE} "
              f"and {REAL_MPII} MPII 1280x720 frames (render + nvJPEG encode at q95) in {t_root:.2f} s  [{gpu}]")
        print(f"real-data (b): nvJPEG encode {enc_ms:.3f} ms per {REAL_SIZE}x{REAL_SIZE} frame (host frame in, "
              f"bytes out); decode {dec1_ms:.3f} ms per frame alone, {statistics.median(batch_ms):.3f} ms per "
              f"batch of {len(blobs)} ({mb:.1f} MiB of JPEG; {statistics.median(batch_ms) / len(blobs):.3f} ms a "
              f"frame), copy back to the host (one pinned buffer) {statistics.median(back_ms):.3f} ms  [{gpu}]")
        del frames, imgs, host
        train_sets = [build_dataset(name, "train", cfg, root) for name in cfg.data.trainset]
        rendered = [PoseDataset(d.name, d.skeleton, [{**s, "img_path": None} for s in d.samples], True)
                    for d in train_sets]
        loader_ms = {}
        for label, sets in (("JPEG", train_sets), ("rendered", rendered)):
            loader = BatchLoader(sets, cfg, TRAIN_BATCH, num_workers=8, seed=cfg.seed, device="cuda")
            try:
                t0 = time.perf_counter()
                n = sum(1 for _ in loader.epoch(0, 3))
                loader_ms[label] = (time.perf_counter() - t0) * 1e3 / n
            finally:
                loader.close()
        print(f"real-data (b): loader host {loader_ms['JPEG']:.3f} ms per {TRAIN_BATCH}-image train batch from the "
              f"root's JPEGs (read + nvJPEG + copy back + native warp), {loader_ms['rendered']:.3f} ms from the "
              f"same samples rendered (H36M {REAL_SIZE}x{REAL_SIZE} + MPII 1280x720)  [{gpu}]")

        # (c) the train CLI with --pretrained
        pth = os.path.join(tmp, f"resnet{cfg.model.resnet_type}.pth")
        write_torchvision_resnet(pth, cfg.model.resnet_type, SEED)
        argv = ["--config", "h36m3d_r50", "--data_root", root, "--pretrained", pth, "--steps", str(REAL_STEPS),
                "--end_epoch", "1", "--output_dir", run, "--device", "cuda"]
        t0 = time.perf_counter()
        rep = _child(_REAL_TRAIN_CHILD, json.dumps(argv), pth)
        t_train = time.perf_counter() - t0
        losses, steady = rep["losses"], rep["rate_ms"]
        rate = (rep["rate_steps"], rep["rate_k1"], rep["rate_k2"])
        if not (rep["backbone_is_the_file"] and rate == (REAL_RATE_STEPS,) * 3 and (rep["k1"], rep["k2"]) == (REAL_STEPS, REAL_STEPS)
                and rep["colour"] == REAL_STEPS + REAL_RATE_STEPS  # one decode a batch
                and len(losses) == REAL_STEPS and all(map(math.isfinite, losses))):
            raise AssertionError(f"real-data (c): {rep}")
        print(f"real-data (c): train --data_root <root> --pretrained <seeded torchvision ResNet-"
              f"{cfg.model.resnet_type} .pth> --steps "
              f"{REAL_STEPS}: exit 0 in {t_train:.1f} s; the backbone before step 1 is the file's, bitwise; K1 "
              f"{rep['k1']}, K2 {rep['k2']} launches, the colour kernel {rep['colour']} (with the rate loop's); "
              f"losses {', '.join(f'{x:.4f}' for x in losses)}  [{gpu}]")
        print(f"real-data (c): host clock, the loader's JPEG batches included: the first step (two batches "
              f"loaded, cuDNN's plans) {rep['first_ms']:.1f} ms; then {REAL_RATE_STEPS} more steps from epochs 1-3, "
              f"waited for after the first and at the end only: {steady:.1f} ms a step, "
              f"{TRAIN_BATCH / steady * 1e3:.1f} img/s; of it on the host {rep['rate_load_ms']:.1f} ms in the "
              f"loader and {rep['rate_call_ms']:.1f} ms in the step's call  [{gpu}]")

        # (d) the test CLI, and its coordinates against libjpeg's decode and the frames rendered without JPEG
        t0 = time.perf_counter()
        rep_t = _child(_REAL_TEST_CHILD, json.dumps(["--config", "h36m3d_r50", "--data_root", root,
                                                     "--output_dir", run, "--device", "cuda", "--vis"]))
        t_test = time.perf_counter() - t0
        test_set = build_dataset(cfg.data.testset, "test", cfg, root)
        batches = -(-len(test_set) // cfg.eval.batch_size_per_device)
        mpjpe = rep_t["metrics"]["MPJPE total"]
        n_vis = min(REAL_VIS, len(test_set))  # --vis: each overlay's frame decoded on the card, one colour launch
        if (rep_t["k1"], rep_t["k2"], rep_t["colour"]) != (batches, 0, batches + n_vis) or not math.isfinite(mpjpe):
            raise AssertionError(f"real-data (d): {rep_t}")
        vis = _check_overlays(os.path.join(run, "vis"), n_vis, (REAL_SIZE, REAL_SIZE))
        print(f"real-data (d): test --data_root <root> --vis: exit 0 in {t_test:.1f} s, {len(test_set)} samples, "
              f"flip-test, K1 launches {rep_t['k1']}, the colour kernel {rep_t['colour']} ({batches} batches + "
              f"{n_vis} overlay frames); MPJPE {mpjpe:.2f} mm; {vis}  [{gpu}]")
        by_file = {os.path.basename(s["img_path"]): s for s in written["test"]}
        plain = PoseDataset(test_set.name, test_set.skeleton,
                            [{**by_file[os.path.basename(s["img_path"])], "img_path": None} for s in test_set.samples],
                            False)
        tester = Tester(cfg.replace(output_dir=run), dataset=plain, num_workers=8, device="cuda")
        try:
            fhi.launches = 0
            vox = tester.predict_voxels()
            k1_plain = fhi.launches
            _, preds, _, _ = metrics_from_voxel_preds(cfg, tester.loader, test_set, vox)
        finally:
            tester.close()
        # The same JPEGs decoded by libjpeg (cv2, on the host) through the same snapshot.
        tester = Tester(cfg.replace(output_dir=run), dataset=test_set, num_workers=8, device="cuda")
        tester.loader.close()
        tester.loader = BatchLoader([test_set], cfg, cfg.eval.batch_size_per_device, train=False, num_workers=8,
                                    device="cpu")
        try:
            fhi.launches = 0
            vox = tester.predict_voxels()
            k1_ref = fhi.launches
            _, ref, _, _ = metrics_from_voxel_preds(cfg, tester.loader, test_set, vox)
        finally:
            tester.close()
        cli = np.load(os.path.join(run, "result", "preds_Human36M.npy"))
        d_xy, d_z = np.abs(cli[..., :2] - preds[..., :2]), np.abs(cli[..., 2] - preds[..., 2])
        r_xy, r_z = np.abs(ref[..., :2] - preds[..., :2]), np.abs(ref[..., 2] - preds[..., 2])
        c_xy, c_z = np.abs(cli[..., :2] - ref[..., :2]), np.abs(cli[..., 2] - ref[..., 2])
        spread = float(np.abs(preds[..., :2] - preds[..., :2].mean((0, 1))).max())
        print(f"real-data (d): the CLI's coordinates (nvJPEG) against the same JPEGs decoded by libjpeg through the "
              f"same snapshot (K1 {k1_ref}): x/y mean {c_xy.mean():.4f} px (bar {TOL_REAL_XY}), p99 "
              f"{np.percentile(c_xy, 99):.3f}, max {c_xy.max():.3f}; z mean {c_z.mean():.4f} mm (bar {TOL_REAL_Z}), "
              f"p99 {np.percentile(c_z, 99):.3f}, max {c_z.max():.3f}; the predictions spread {spread:.1f} px; from "
              f"the same samples rendered without JPEG (K1 {k1_plain}): nvJPEG x/y mean {d_xy.mean():.4f} px, z mean "
              f"{d_z.mean():.4f} mm, libjpeg x/y mean {r_xy.mean():.4f} px, z mean {r_z.mean():.4f} mm  [{gpu}]")
        if (k1_plain != batches or k1_ref != batches or cli.shape != ref.shape or not np.isfinite(cli).all()
                or c_xy.mean() > TOL_REAL_XY or c_z.mean() > TOL_REAL_Z):
            raise AssertionError(f"real-data (d): K1 {k1_plain} / {k1_ref}, shapes {cli.shape} {ref.shape}, x/y "
                                 f"mean {c_xy.mean()} px (bar {TOL_REAL_XY}), z mean {c_z.mean()} mm from libjpeg's "
                                 f"(bar {TOL_REAL_Z})")
    print(f"real-data: the phase took {time.perf_counter() - t_phase:.1f} s  [{gpu}]")
    colour["launches"] = rep["colour"] + rep_t["colour"]
    return rep["k1"] + rep["rate_k1"] + rep_t["k1"] + k1_plain + k1_ref, rep["k2"] + rep["rate_k2"], colour


# --- 7j: the accuracy harness -----------------------------------------------------

ACC_TRAIN, ACC_TEST, ACC_EPOCHS = 512, 64, 5  # accuracy_loop --preset tiny cut to 16 steps an epoch
ACC_COMPARED = 64  # of the tool's JPEGs, decoded after the run to hold the colour kernel against plain
ACC_EVAL_BATCHES = 2  # the headline and the train-subset eval: one batch of 128 each (the oracle runs on the CPU)
TOL_ORACLE_MM = 1.0  # the tool's own --oracle_tol_mm


def accuracy_phase(fhi, iv, mm, cb, gpu: str):
    """``python -m ihpr_tpu_torch.tools.accuracy_loop --preset tiny`` cut to
    ACC_TRAIN / ACC_TEST frames and ACC_EPOCHS epochs, with its oracle,
    through the tool's main: the synthetic frames rendered and encoded by
    cv2 on the CPU (the JAX tool's bytes), decoded on the card (nvJPEG +
    the colour kernel), ResNet-18
    at 128x128 trained in fp32 "highest" (its fp32 head, J = 18 and D = 32,
    has a fused plan in JAX: K1-fp32 and K2-fp32), the Tester's MPJPE, and
    the trained weights on the
    CPU (the oracle) within TOL_ORACLE_MM of the card's eval. The bar is set
    out of reach (5 epochs do not learn the task), so the exit code is the
    oracle's verdict. K1-K8 and the colour kernel counted over the run;
    then the colour kernel held against its plain version on ACC_COMPARED
    of the tool's JPEGs. Returns K1-fp32's, K2-fp32's and the colour
    kernel's launches, and the colour kernel's largest difference from
    plain."""
    from ihpr_tpu_torch.data import jpeg
    from ihpr_tpu_torch.data.pipeline import _read_bytes
    from ihpr_tpu_torch.ops import jpeg_color
    from ihpr_tpu_torch.tools import accuracy_loop

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        argv = ["--preset", "tiny", "--train_size", str(ACC_TRAIN), "--test_size", str(ACC_TEST), "--end_epoch",
                str(ACC_EPOCHS), "--mpjpe_bar_mm", "1e9", "--oracle_tol_mm", str(TOL_ORACLE_MM), "--output_dir", out]
        torch.cuda.synchronize()
        _zero_counts(fhi, iv, mm, cb)
        jpeg_color.launches = 0
        try:
            accuracy_loop.main(argv)
            code = 0
        except SystemExit as exc:
            code = exc.code
        torch.cuda.synchronize()
        counts, colour = _counts(fhi, iv, mm, cb) + _f32_counts(fhi), jpeg_color.launches
        with open(os.path.join(out, "accuracy_loop.json")) as f:
            result = json.load(f)
        frames = sorted(glob.glob(os.path.join(out, "imgs", "*.jpg")))[:ACC_COMPARED]
        if len(frames) != ACC_COMPARED:
            raise AssertionError(f"accuracy: {len(frames)} JPEGs under the tool's imgs/, want {ACC_COMPARED} or more")
        err = colour_vs_plain(jpeg, jpeg_color, [_read_bytes(p) for p in frames], "accuracy: the tool's frames")
    steps = ACC_TRAIN // 32 * ACC_EPOCHS
    want = (0, 0, 0, 0, 0, 0, 0, 0, steps + ACC_EVAL_BATCHES, steps)
    # One decode a batch: the train batches, the two evals' and the oracle's
    # (its patches are the card loader's).
    want_colour = steps + ACC_EVAL_BATCHES + 1
    ours, gap = result["mpjpe_ours_mm"], result["mpjpe_gap_mm"]
    print(f"accuracy: accuracy_loop --preset tiny --train_size {ACC_TRAIN} --test_size {ACC_TEST} --end_epoch "
          f"{ACC_EPOCHS}: exit {code}; unseen MPJPE {ours} mm, train subset {result['mpjpe_train_subset_mm']} mm, "
          f"CPU oracle {result['mpjpe_torch_mm']} mm, gap {gap} mm (bar {TOL_ORACLE_MM}); {result['train_steps']} "
          f"steps in {result['train_seconds']} s, {result['train_img_per_s']} img/s, the loader's share of the "
          f"train loop {result['loader_share']}; K1-K8, K1/K2-fp32 {counts} (want {want}), the colour kernel {colour} (want "
          f"{want_colour})  [{gpu}]")
    if (code != 0 or counts != want or colour != want_colour or result["train_steps"] != steps
            or not (math.isfinite(ours) and gap <= TOL_ORACLE_MM) or result["gpu"] is None):
        raise AssertionError(f"accuracy: exit {code}, K1-K8, K1/K2-fp32 {counts} (want {want}), colour {colour} (want "
                             f"{want_colour}), {result}")
    print(f"accuracy: the phase took {time.perf_counter() - t_phase:.1f} s  [{gpu}]")
    return counts[8], counts[9], colour, err


# --- 7i: spatial partitioning ---------------------------------------------------

SP_RANKS = 2  # (a)-(c): S = 2, D = 1, two ranks on the one card over gloo
SP_GRID4 = (4, 2)  # (d): four ranks, D = 2 x S = 2
SP_BATCH = 32  # h36m3d_r50 cut to batch 32 a data index
SP_STEPS = 3  # counted Trainer steps of (b)
SP_SIZE = 96  # synthetic samples per train set of (b)'s Trainers: 192, 6 batches of 32
SP_PATCHES = 40  # (c): two dispatches of max_batch 32, the second padded
TOL_SP_FP32 = 2e-3  # (a) the fp32 "highest" flip-test eval step on the grid vs one process, voxel
TOL_SP_LOSS = 1e-3  # (b) the first bf16 step's loss on the grid vs one process's, relative (as TOL_DP_LOSS)
# bf16 coords on the grid against one process's bf16: within twice one
# process's own bf16 distance from fp32 (the rule of ROADMAP.md Traps for two
# bf16 paths): half-height bf16 convs are other cuDNN calls and round otherwise.
TOL_SP_BF16 = 2.0


def _sp_cfg(out: str, spatial: int = 1, fp32: bool = False, s2d: bool = False):
    """h36m3d_r50 at batch SP_BATCH a data index, on a grid of ``spatial``;
    with ``fp32`` in fp32 "highest"; with ``s2d`` the space-to-depth stem."""
    from ihpr_tpu_torch.config import get_config

    cfg = get_config("h36m3d_r50").replace(output_dir=out)
    model = dataclasses.replace(cfg.model, compute_dtype="float32", matmul_precision="highest") if fp32 else cfg.model
    model = dataclasses.replace(model, s2d_stem=s2d)
    return cfg.replace(model=model, optim=dataclasses.replace(cfg.optim, batch_size_per_device=SP_BATCH),
                       eval=dataclasses.replace(cfg.eval, batch_size_per_device=SP_BATCH),
                       parallel=dataclasses.replace(cfg.parallel, spatial_axis_size=spatial))


class _HaloMeter:
    """Host time and bytes sent in ``mesh.HaloRows``'s forward and backward
    while it is installed (each waits for the device at its copy to the host:
    gloo gathers host tensors)."""

    def __init__(self, mesh):
        self.mesh, self.s, self.nbytes, self.calls = mesh, 0.0, 0, 0
        self.orig = (mesh.HaloRows.forward, mesh.HaloRows.backward)

    def __enter__(self):
        fwd, bwd = self.orig
        mesh = self.mesh

        def forward(ctx, x, rows_in, needs, fill, rows):
            plan = mesh.halo_plan(rows_in, needs)
            sent = plan["pad_before"] + plan["pad_after"]
            self.nbytes += sent * x.shape[0] * x.shape[1] * x.shape[3] * x.element_size()
            return self._timed(fwd, ctx, x, rows_in, needs, fill, rows)

        def backward(ctx, g):
            plan = mesh.halo_plan(ctx.rows_in, ctx.needs)
            sent = plan["pad_above"] + plan["pad_below"]
            self.nbytes += sent * g.shape[0] * g.shape[1] * g.shape[3] * g.element_size()
            return self._timed(bwd, ctx, g)

        self.mesh.HaloRows.forward, self.mesh.HaloRows.backward = staticmethod(forward), staticmethod(backward)
        return self

    def _timed(self, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self.s += time.perf_counter() - t0
            self.calls += 1

    def __exit__(self, *exc):
        self.mesh.HaloRows.forward, self.mesh.HaloRows.backward = (staticmethod(f) for f in self.orig)


def _spatial_rank(rank: int, world: int, work: str, gpu: str):
    """One rank of spatial_phase (a)-(c) on cuda:0 over gloo, S = 2: the
    flip-test eval step on its rows (bf16 and fp32, K3 counted), K3/K4
    against plain on its rows' logits, SP_STEPS Trainer steps (counted), ms
    a step, the halo exchanges' host share and bytes, peak memory; then
    PoseServer(partition="spatial") on SP_PATCHES patches (counted)."""
    from ihpr_tpu_torch.engine.server import PoseServer
    from ihpr_tpu_torch.engine.trainer import Trainer
    from ihpr_tpu_torch.models.pose_net import build_pose_net, inference_copy
    from ihpr_tpu_torch.ops import conv_bn as cb
    from ihpr_tpu_torch.ops import fused_head_integral as fhi
    from ihpr_tpu_torch.ops import integral_volume as iv
    from ihpr_tpu_torch.ops import matmul_bn as mm
    from ihpr_tpu_torch.parallel import mesh
    from ihpr_tpu_torch.parallel.train_step import make_eval_step

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    inputs = torch.load(f"{work}/inputs.pt", weights_only=False)
    batch = {k: torch.from_numpy(v[:SP_BATCH]).cuda() for k, v in inputs["batch"].items()}
    out = {}

    # --- (a) the flip-test eval step on this rank's rows, counted ---
    for fp32 in (False, True):
        cfg = _sp_cfg(f"{work}/rank{rank}", SP_RANKS, fp32)
        dp = mesh.data_parallel(cfg)
        net = build_pose_net(cfg, device="cuda", dp=dp, state_dict=inputs["eval_model"])
        step = make_eval_step(inference_copy(net), cfg)
        step(batch)  # warm-up
        torch.cuda.synchronize()
        _zero_counts(fhi, iv, mm, cb)
        coords = step(batch)[0]
        torch.cuda.synchronize()
        out["eval_fp32" if fp32 else "eval_bf16"] = (coords.cpu().numpy(), _counts(fhi, iv, mm, cb))
    # --- (s) the s2d stem on this rank's rows (fp32 "highest"): the flip-test
    # eval step and one train step, counted ---
    from ihpr_tpu_torch.parallel.train_step import make_optimizer, make_train_step

    s2d_cfg = _sp_cfg(f"{work}/rank{rank}", SP_RANKS, fp32=True, s2d=True)
    dp = mesh.data_parallel(s2d_cfg)
    net = build_pose_net(s2d_cfg, device="cuda", dp=dp, state_dict=inputs["s2d_model"])
    step = make_eval_step(inference_copy(net), s2d_cfg)
    step(batch)  # warm-up
    torch.cuda.synchronize()
    _zero_counts(fhi, iv, mm, cb)
    coords = step(batch)[0]
    torch.cuda.synchronize()
    eval_counts = _counts(fhi, iv, mm, cb)
    model = build_pose_net(s2d_cfg, device="cuda", dp=dp, trainable=True, state_dict=inputs["s2d_start"])
    opt, sched = make_optimizer(model, s2d_cfg, 100, dp)
    train = make_train_step(model, opt, s2d_cfg, scheduler=sched, dp=dp)
    _zero_counts(fhi, iv, mm, cb)
    loss = float(train(batch)["loss"])
    torch.cuda.synchronize()
    out["s2d"] = (coords.cpu().numpy(), eval_counts, loss, _counts(fhi, iv, mm, cb))
    del net, model, opt, train
    # ------------------------------------------------------------------
    cfg = _sp_cfg(f"{work}/rank{rank}", SP_RANKS)
    dp = mesh.data_parallel(cfg)
    net = build_pose_net(cfg, device="cuda", dp=dp, trainable=True, state_dict=inputs["eval_model"])
    from ihpr_tpu_torch.data.augment import finalize_patch

    with torch.no_grad():
        image = mesh.row_shard(finalize_patch(batch["patch"], batch["color_scale"], cfg.data), net.rows)
        hm = net(image).contiguous()
    b, h, w, c = hm.shape
    out["volume"] = (b, h * w, c)
    out["k3_err"], out["k4_err"] = check_volume(iv, hm.view(b, h * w, c), net.joint_num, net.depth_dim, w,
                                                f"spatial rank {rank}, its rows' logits ({b}, {h * w}, {c})")
    del net, hm, image

    # --- (b) SP_STEPS Trainer steps, counted ---
    trainer = Trainer(cfg, data_root="synthetic", synthetic_size=SP_SIZE, num_workers=4, rss_limit_mb=0,
                      device="cuda")
    try:
        trainer.cap_steps_per_epoch(SP_STEPS)
        torch.cuda.synchronize()
        _zero_counts(fhi, iv, mm, cb)
        trainer.train(1)
        torch.cuda.synchronize()
        out["counts"] = _counts(fhi, iv, mm, cb)
        out["losses"] = [float(x) for x in trainer.losses]
        out["digest"] = _state_digest(trainer.model)
        # ---------------------------------------------------------------
        step = lambda: trainer.lean_step_fn(batch)  # noqa: E731
        torch.cuda.reset_peak_memory_stats()
        out["ms"] = _cuda_ms(step, 3, reps=2)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        walls = []
        with _HaloMeter(mesh) as meter:
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
        out["halo"] = (meter.s / 3, meter.nbytes / 3, meter.calls / 3, sum(walls) / 3)
    finally:
        trainer.close()
    del trainer
    torch.cuda.empty_cache()

    # --- (c) PoseServer(partition="spatial"), counted ---
    server = PoseServer(_sp_cfg(work), inputs["eval_model"], max_batch=MAX_BATCH, flip_test=True, device="cuda",
                        dp=mesh.data_parallel(), partition="spatial")
    server.predict_patches(inputs["patches"][:MAX_BATCH])  # warm-up
    torch.cuda.synchronize()
    _zero_counts(fhi, iv, mm, cb)
    out["served"] = server.predict_patches(inputs["patches"])
    torch.cuda.synchronize()
    out["serve_counts"] = _counts(fhi, iv, mm, cb)
    # -----------------------------------------------------------
    chunk = inputs["patches"][:MAX_BATCH]
    out["serve_ms"] = _cuda_ms(lambda: server.submit_patches(chunk), 3, reps=2)

    # --- (e) the spatial server's export: the whole-image program ---
    from ihpr_tpu_torch.engine.export import export_server

    blob = export_server(server)
    out["export_sha1"] = hashlib.sha1(blob).hexdigest()
    if rank == 0:
        with open(f"{work}/spatial.pt2", "wb") as f:
            f.write(blob)
    return out


def _spatial4_rank(rank: int, world: int, work: str, gpu: str):
    """One rank of spatial_phase (d): a D = 2 x S = 2 grid on the one card,
    one counted train step on its data index's SP_BATCH samples of the
    64-image batch, from the seeded weights, in bf16 and in fp32
    "highest"."""
    from ihpr_tpu_torch.models.pose_net import build_pose_net
    from ihpr_tpu_torch.ops import conv_bn as cb
    from ihpr_tpu_torch.ops import fused_head_integral as fhi
    from ihpr_tpu_torch.ops import integral_volume as iv
    from ihpr_tpu_torch.ops import matmul_bn as mm
    from ihpr_tpu_torch.parallel import mesh, train_step

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    inputs = torch.load(f"{work}/inputs.pt", weights_only=False)
    out = {}
    for fp32 in (False, True):
        cfg = _sp_cfg(f"{work}/rank{rank}", SP_GRID4[1], fp32)
        dp = mesh.data_parallel(cfg)
        d = dp.data_axis.rank
        local = {k: torch.from_numpy(v[d * SP_BATCH:(d + 1) * SP_BATCH]).cuda() for k, v in inputs["batch"].items()}
        model = build_pose_net(cfg, device="cuda", trainable=True, dp=dp, state_dict=inputs["model"])
        opt, sched = train_step.make_optimizer(model, cfg, 100, dp)
        step = train_step.make_train_step(model, opt, cfg, scheduler=sched, dp=dp)
        torch.cuda.synchronize()
        # --- (d) the main path, counted: one step ---
        _zero_counts(fhi, iv, mm, cb)
        metrics = {k: float(v) for k, v in step(local).items()}
        torch.cuda.synchronize()
        counts = _counts(fhi, iv, mm, cb)
        # -------------------------------------------
        out["fp32" if fp32 else "bf16"] = {"metrics": metrics, "counts": counts, "digest": _state_digest(model)}
        del model, opt, step
        torch.cuda.empty_cache()
    out["grid"] = (dp.data_axis.rank, dp.data_axis.world, dp.spatial)
    return out


_SPATIAL_ARTIFACT_CHILD = r"""
import json, sys
import numpy as np
import torch
work = sys.argv[1]
patches = torch.from_numpy(np.load(f"{work}/export_patches.npy")).cuda()
ones = torch.ones(len(patches), 3, device="cuda")
outs = {}
for name in ("spatial", "one"):
    program = torch.export.load(f"{work}/{name}.pt2").module()
    with torch.no_grad():
        outs[name] = program(patches, ones).cpu().numpy()
a, b = outs["spatial"], outs["one"]
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("ihpr_tpu_torch", "ihpr_tpu", "jax"))
print(json.dumps({"equal": bool(np.array_equal(a, b)), "finite": bool(np.isfinite(a).all()), "shape": list(a.shape),
                  "spread": float(np.abs(a - a.mean()).max()), "leaked": leaked}))
"""


def spatial_phase(fhi, iv, gpu: str):
    """Spatial partitioning of h36m3d_r50 (ResNet-50, 256x256, bf16, lean BN,
    J=18, D=64) at full width and depth, cut to batch SP_BATCH a data
    index, on ranks that time-share the one card over gloo
    (parallel.launch.spawn). S = 2, D = 1: (a) the flip-test eval step of a
    32-image batch on seeded, peaked weights, against one process (fp32
    "highest" within TOL_SP_FP32 voxel, bf16 within TOL_SP_BF16 times one
    process's own bf16 distance from fp32); K3/K4 against plain on a rank's
    rows' logits; (b) SP_STEPS Trainer steps (synthetic H36M+MPII), the
    first step's loss against a 1-process Trainer's, K3 and K4 once a step
    a rank and K1/K2 never, device ms a step a rank, the halo exchanges'
    share of a step's host time and their bytes, peak memory; (c)
    PoseServer(partition="spatial") on SP_PATCHES patches at max_batch 32
    with flip-test against one process's server (the bf16 rule of (a));
    (e) each rank exports that server (engine/export.py: the whole-image
    program of a one-process copy of its model), bitwise the one-process
    server's artifact, and a process with torch alone runs both artifacts
    on MAX_BATCH patches to bitwise equal coords; (s) the s2d stem on the
    same weights (the 7x7 stem embedded) in fp32 "highest": the flip-test
    eval step against one process's s2d dispatch (TOL_SP_FP32) and one
    train step from (b)'s state against one process's (TOL_SPU_LOSS), K3
    and K4 counted.
    D = 2 x S = 2 on four ranks: (d) one step on a 64-image batch from the
    peaked weights, its loss against one process's (fp32 "highest" within
    TOL_DP_FP32's loss bar, bf16 by the rule of (a)). Returns the ranks' K3 and K4 launches and the
    largest K3/K4-vs-plain differences."""
    from ihpr_tpu_torch.data import skeletons
    from ihpr_tpu_torch.data.augment import finalize_patch
    from ihpr_tpu_torch.data.datasets import build_dataset
    from ihpr_tpu_torch.data.pipeline import BatchLoader
    from ihpr_tpu_torch.engine.export import export_server
    from ihpr_tpu_torch.engine.server import PoseServer
    from ihpr_tpu_torch.engine.trainer import Trainer
    from ihpr_tpu_torch.models.pose_net import build_pose_net, inference_copy
    from ihpr_tpu_torch.parallel import launch
    from ihpr_tpu_torch.parallel.train_step import make_eval_step, make_optimizer, make_train_step

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        cfg = _sp_cfg(f"{work}/one")
        gen = torch.Generator().manual_seed(SEED)
        primary = skeletons.get_skeleton(cfg.data.trainset[0])
        sets = [build_dataset(name, "train", cfg, "synthetic", SP_SIZE, hue_skeleton=primary if i else None)
                for i, name in enumerate(cfg.data.trainset)]
        gb = SP_GRID4[0] // SP_GRID4[1] * SP_BATCH
        loader = BatchLoader(sets, cfg, gb, num_workers=8, seed=cfg.seed)
        hb = next(loader.epoch(0, 1))
        loader.close()
        batch_np = {f: getattr(hb, f) for f in ("patch", "color_scale", "joint_img", "joint_vis", "joints_have_depth")}
        batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
        model = build_pose_net(cfg, device="cuda", generator=gen, trainable=True)
        image = finalize_patch(batch["patch"], batch["color_scale"], cfg.data)
        with torch.no_grad():
            _peak_heatmaps(model, image, gen)
        start = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        net = build_pose_net(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
        _peak_heatmaps(net, image, gen)
        eval_sd = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
        # The s2d stem's weights: the 7x7 stem embedded exactly (s2d_stem_kernel).
        from ihpr_tpu_torch.models.resnet import s2d_stem_kernel

        s2d_sd = {**eval_sd, "backbone.conv1.weight": s2d_stem_kernel(eval_sd["backbone.conv1.weight"])}
        # The train step starts from (b)'s state, whose head was peaked in
        # train mode: eval_sd's, peaked in eval mode, saturates the train-mode
        # heatmaps (every coordinate on a whole voxel), and its loss jumps
        # where two voxels nearly tie (tools/s2d_stem_check.py).
        s2d_start = {**start, "backbone.conv1.weight": s2d_stem_kernel(start["backbone.conv1.weight"])}
        patches = np.random.RandomState(SEED).randint(0, 256, (SP_PATCHES, *cfg.data.input_shape, 3)).astype(np.uint8)
        torch.save({"model": start, "eval_model": eval_sd, "s2d_model": s2d_sd, "s2d_start": s2d_start,
                    "batch": batch_np,
                    "patches": patches}, f"{work}/inputs.pt")

        # One process: the eval step and the server in bf16 and fp32, the
        # Trainer's first steps, and the 64-image step of (d).
        half = {k: v[:SP_BATCH] for k, v in batch.items()}
        want = {}
        for fp32 in (False, True):
            c = _sp_cfg(f"{work}/one", 1, fp32)
            one = build_pose_net(c, device="cuda", state_dict=eval_sd)
            want["eval", fp32] = make_eval_step(inference_copy(one), c)(half)[0].cpu().numpy()
            want["serve", fp32] = PoseServer(c, eval_sd, max_batch=MAX_BATCH, flip_test=True,
                                             device="cuda").predict_patches(patches)
            del one
        c = _sp_cfg(f"{work}/one", 1, fp32=True, s2d=True)
        one = build_pose_net(c, device="cuda", state_dict=s2d_sd)
        want["s2d"] = make_eval_step(inference_copy(one), c)(half)[0].cpu().numpy()
        # One train step's loss in one process: the s2d stem, and (printed
        # beside it) the 7x7 stem it embeds.
        for key, cs, sd in (("s2d_loss", c, s2d_start), ("7x7_loss", _sp_cfg(f"{work}/one", 1, fp32=True), start)):
            one = build_pose_net(cs, device="cuda", trainable=True, state_dict=sd)
            opt, sched = make_optimizer(one, cs, 100)
            want[key] = float(make_train_step(one, opt, cs, scheduler=sched)(half)["loss"])
        del one, opt
        ref = Trainer(cfg, data_root="synthetic", synthetic_size=SP_SIZE, num_workers=8, rss_limit_mb=0,
                      device="cuda")
        try:
            ref.cap_steps_per_epoch(SP_STEPS)
            ref.train(1)
            want_losses = [float(x) for x in ref.losses]
        finally:
            ref.close()
        del ref
        opt, sched = make_optimizer(model, cfg, 100)
        want4 = {False: {k: float(v) for k, v in make_train_step(model, opt, cfg, scheduler=sched)(batch).items()}}
        del model, net, opt
        c = _sp_cfg(f"{work}/one", 1, True)
        model = build_pose_net(c, device="cuda", trainable=True, state_dict=start)
        opt, sched = make_optimizer(model, c, 100)
        want4[True] = {k: float(v) for k, v in make_train_step(model, opt, c, scheduler=sched)(batch).items()}
        del model, opt, batch, image
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        ranks = launch.spawn(_spatial_rank, SP_RANKS, "gloo", work, gpu, workdir=work)
        t_ranks = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks4 = launch.spawn(_spatial4_rank, SP_GRID4[0], "gloo", work, gpu, workdir=work)
        t_ranks4 = time.perf_counter() - t0

        # (e) the ranks' artifacts against the one-process server's, run by a
        # process with torch alone
        one_blob = export_server(PoseServer(_sp_cfg(work), eval_sd, max_batch=MAX_BATCH, flip_test=True,
                                            device="cuda"))
        with open(f"{work}/one.pt2", "wb") as f:
            f.write(one_blob)
        np.save(f"{work}/export_patches.npy", patches[:MAX_BATCH])
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run([sys.executable, "-c", _SPATIAL_ARTIFACT_CHILD, work], cwd=work, env=env,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"spatial (e): the torch-only process failed:\n{proc.stderr[-4000:]}")
        art = json.loads(proc.stdout.strip().splitlines()[-1])

    failed = []  # every check runs and prints; the phase raises at its end
    r0 = ranks[0]
    for key in ("eval_bf16", "eval_fp32", "served"):
        if not all(np.array_equal(r[key][0] if key != "served" else r[key], r0[key][0] if key != "served"
                                  else r0[key]) for r in ranks):
            failed.append(f"spatial: {key} coords differ between the ranks")
    own = float(np.abs(want["eval", False] - want["eval", True]).max())
    err32 = float(np.abs(r0["eval_fp32"][0] - want["eval", True]).max())
    err16 = float(np.abs(r0["eval_bf16"][0] - want["eval", False]).max())
    spread = float(np.abs(want["eval", True] - want["eval", True].mean()).max())
    if not (err32 <= TOL_SP_FP32 and err16 <= TOL_SP_BF16 * own and spread > 1.0):
        failed.append(f"spatial (a): fp32 {err32} voxel, bf16 {err16} (one process's bf16 from fp32 {own}), "
                      f"spread {spread}")
    eval_want = (0, 0, 1, 0, 0, 0, 0, 0)
    steps_want = (0, 0, SP_STEPS, SP_STEPS, 0, 0, 0, 0)
    serve_want = (0, 0, 2, 0, 0, 0, 0, 0)
    for rank, r in enumerate(ranks):
        if (r["eval_bf16"][1], r["eval_fp32"][1], r["counts"], r["serve_counts"]) != (
                eval_want, eval_want, steps_want, serve_want):
            failed.append(f"spatial rank {rank}: launches K1-K8 eval {r['eval_bf16'][1]} / {r['eval_fp32'][1]} "
                          f"(want {eval_want}), {SP_STEPS} steps {r['counts']} (want {steps_want}), serve "
                          f"{r['serve_counts']} (want {serve_want})")
        if abs(r["losses"][0] - want_losses[0]) > TOL_SP_LOSS * abs(want_losses[0]):
            failed.append(f"spatial (b) rank {rank}: losses {r['losses']}, one process {want_losses}")
    if len({r["digest"] for r in ranks}) != 1:
        failed.append("spatial (b): parameters and BN buffers differ between the ranks")
    own_srv = float(np.abs(want["serve", False] - want["serve", True]).max())
    err_srv = float(np.abs(r0["served"] - want["serve", False]).max())
    if not err_srv <= TOL_SP_BF16 * own_srv:
        failed.append(f"spatial (c): served coords {err_srv} voxel from one process's (its bf16 from fp32 "
                      f"{own_srv})")
    s2d_err = float(np.abs(r0["s2d"][0] - want["s2d"]).max())
    s2d_loss_err = max(abs(r["s2d"][2] - want["s2d_loss"]) / abs(want["s2d_loss"]) for r in ranks)
    stem_gap = abs(want["s2d_loss"] - want["7x7_loss"]) / abs(want["7x7_loss"])
    for rank, r in enumerate(ranks):
        if (not np.array_equal(r["s2d"][0], r0["s2d"][0]) or r["s2d"][1] != eval_want
                or r["s2d"][3] != (0, 0, 1, 1, 0, 0, 0, 0)):
            failed.append(f"spatial (s) rank {rank}: s2d coords differ from rank 0's, or launches K1-K8 eval "
                          f"{r['s2d'][1]} (want {eval_want}), step {r['s2d'][3]}")
    if not (s2d_err <= TOL_SP_FP32 and s2d_loss_err <= TOL_SPU_LOSS):
        failed.append(f"spatial (s): s2d coords {s2d_err} voxel from one process's s2d dispatch (bar "
                      f"{TOL_SP_FP32:g}), loss {s2d_loss_err} relative (bar {TOL_SPU_LOSS:g})")
    own4 = abs(want4[False]["loss"] - want4[True]["loss"])
    for rank, r in enumerate(ranks4):
        bf16, fp32 = r["bf16"], r["fp32"]
        if (bf16["counts"] != (0, 0, 1, 1, 0, 0, 0, 0) or fp32["counts"] != bf16["counts"]
                or abs(fp32["metrics"]["loss"] - want4[True]["loss"]) > TOL_DP_FP32[0] * abs(want4[True]["loss"])
                or abs(bf16["metrics"]["loss"] - want4[False]["loss"]) > TOL_SP_BF16 * own4):
            failed.append(f"spatial (d) rank {rank} (data {r['grid'][0]} of {r['grid'][1]}): loss bf16 "
                          f"{bf16['metrics']['loss']} / fp32 {fp32['metrics']['loss']}, one process "
                          f"{want4[False]['loss']} / {want4[True]['loss']}, K1-K8 {bf16['counts']} / {fp32['counts']}")
    for key in ("bf16", "fp32"):
        if len({r[key]["digest"] for r in ranks4}) != 1:
            failed.append(f"spatial (d): {key} parameters and BN buffers differ between the ranks")
    one_sha1 = hashlib.sha1(one_blob).hexdigest()
    if ({r["export_sha1"] for r in ranks} != {one_sha1} or not art["equal"] or not art["finite"]
            or art["shape"] != [MAX_BATCH, 18, 3] or art["leaked"]):
        failed.append(f"spatial (e): the ranks' artifacts {[r['export_sha1'] for r in ranks]}, one process's "
                      f"{one_sha1}; the torch-only run {art}")

    print(f"spatial (a): {SP_RANKS} ranks (S = {SP_RANKS}, D = 1) over gloo on one card, h36m3d_r50 flip-test "
          f"eval step on {SP_BATCH} images: fp32 \"highest\" {err32:.3g} voxel from one process (bar "
          f"{TOL_SP_FP32:g}), bf16 {err16:.3g} (bar {TOL_SP_BF16:g} x one process's bf16 from fp32, {own:.3g}); "
          f"coords spread {spread:.3g}; K3 {[r['eval_bf16'][1][2] for r in ranks]} a rank, K1 0  [{gpu}]")
    print(f"spatial (s): the s2d stem on {SP_RANKS} ranks (each takes image rows [2a - 4, 2b + 2) for its stem rows "
          f"[a, b)), fp32 \"highest\": flip-test eval coords {s2d_err:.3g} voxel from one process's s2d dispatch "
          f"(bar {TOL_SP_FP32:g}), the same on both ranks; one train step from (b)'s state, loss "
          f"{r0['s2d'][2]:.7f} against one process's {want['s2d_loss']:.7f}, {s2d_loss_err:.3g} relative (bar "
          f"{TOL_SPU_LOSS:g}; one process's 7x7 stem {want['7x7_loss']:.7f}, {stem_gap:.3g} from its s2d); K3/K4 "
          f"{[(r['s2d'][1][2] + r['s2d'][3][2], r['s2d'][3][3]) for r in ranks]} a rank  [{gpu}]")
    print(f"spatial (a): K3 vs plain {max(r['k3_err'] for r in ranks):.3g} voxel, K4 vs plain_bwd "
          f"{max(r['k4_err'] for r in ranks):.3g} on a rank's rows' logits {r0['volume']} bf16")
    print(f"spatial (b): {SP_STEPS} Trainer steps at batch {SP_BATCH} in {t_ranks:.1f} s (the ranks' whole run): "
          f"losses {', '.join(f'{x:.6f}' for x in r0['losses'])}, one process "
          f"{', '.join(f'{x:.6f}' for x in want_losses)}; K1-K4 per rank {[r['counts'][:4] for r in ranks]}; "
          f"parameters and BN buffers bitwise equal on the ranks")
    for rank, r in enumerate(ranks):
        halo_s, halo_bytes, halo_calls, wall = r["halo"]
        print(f"spatial (b) rank {rank}: device {r['ms']:.3f} ms a step (CUDA events), peak {r['peak_gib']:.2f} GiB; "
              f"halo exchanges {halo_s * 1e3:.3f} ms of host time a step ({halo_s / wall:.3f} of its "
              f"{wall * 1e3:.3f} ms wall, {halo_calls:.0f} calls), {halo_bytes / 2**20:.3f} MiB sent a step "
              f"(two ranks share the card; gloo copies through host memory: not a scaling number)  [{gpu}]")
    print(f"spatial (c): PoseServer(partition=\"spatial\") on {SP_PATCHES} patches at max_batch {MAX_BATCH}, "
          f"flip-test: {err_srv:.3g} voxel from one process's server (its bf16 from fp32 {own_srv:.3g}), the "
          f"same on both ranks; K3 {[r['serve_counts'][2] for r in ranks]} a rank, K1 0; "
          f"{r0['serve_ms']:.3f} ms a dispatch a rank (CUDA events)  [{gpu}]")
    print(f"spatial (d): D = 2 x S = 2 on {SP_GRID4[0]} ranks in {t_ranks4:.1f} s, one step on {gb} images: fp32 "
          f"\"highest\" loss {ranks4[0]['fp32']['metrics']['loss']:.6f} against one process's "
          f"{want4[True]['loss']:.6f} (bar {TOL_DP_FP32[0]:g} relative); bf16 {ranks4[0]['bf16']['metrics']['loss']:.6f} "
          f"against {want4[False]['loss']:.6f} (bar {TOL_SP_BF16:g} x one process's bf16 from fp32, {own4:.3g}); "
          f"K3/K4 {[r['bf16']['counts'][2:4] for r in ranks4]} a rank a step; parameters and BN buffers bitwise "
          f"equal on the ranks")
    print(f"spatial (e): export_server on each of the {SP_RANKS} ranks of PoseServer(partition=\"spatial\"): "
          f"artifacts bitwise the one-process server's ({len(one_blob) / 1e6:.1f} MB, sha1 {one_sha1[:12]}); a "
          f"process with torch alone ran both on {MAX_BATCH} patches with flip-test: outputs bitwise equal "
          f"({art['equal']}), coords spread {art['spread']:.3g} voxel")
    print(f"spatial: the phase took {time.perf_counter() - t_phase:.1f} s  [{gpu}]")
    if failed:
        raise AssertionError("; ".join(failed))
    k3 = sum(r["eval_bf16"][1][2] + r["eval_fp32"][1][2] + r["counts"][2] + r["serve_counts"][2]
             + r["s2d"][1][2] + r["s2d"][3][2] for r in ranks)
    k4 = sum(r["counts"][3] + r["s2d"][3][3] for r in ranks)
    k3 += sum(r[key]["counts"][2] for r in ranks4 for key in ("bf16", "fp32"))
    k4 += sum(r[key]["counts"][3] for r in ranks4 for key in ("bf16", "fp32"))
    return k3, k4, max(r["k3_err"] for r in ranks), max(r["k4_err"] for r in ranks)


# --- 7p: JAX's initial weights, drawn on this host (no JAX here) ----------------

JAX_INIT_ULPS = 4  # the port's draw vs JAX's values (tests/test_torch_jax_init.py's bar)
JAX_INIT_FIXTURE = os.path.join("tests", "data", "jax_init_flagship.npz")


def _keep_jax_draws():
    """Keep each of this process's draws of JAX's initial weights
    (``jax_random.jax_init_params``, by the values that define the tree and
    the key): the smoke builds the same few models many times, and a draw
    of ResNet-50 takes seconds on the host. Returns the draw itself, which
    keeps nothing (the jax-init phase times it)."""
    from ihpr_tpu_torch.models import jax_random

    draw, kept = jax_random.jax_init_params, {}

    def kept_draw(cfg, joint_num, k):
        m = cfg.model
        tree = (m.resnet_type, m.s2d_stem, m.num_deconv_layers, m.deconv_channels, m.head_final_init_std,
                joint_num * cfg.data.depth_dim, tuple(int(x) for x in k))
        if tree not in kept:
            kept[tree] = draw(cfg, joint_num, k)
        return kept[tree]

    jax_random.jax_init_params = kept_draw
    return draw


def jax_init_phase(gpu: str, draw):
    """The Trainer of h36m3d_r50 at seed 0 on the card: its initial model is
    JAX's Trainer's, drawn by ``models/jax_random.py`` on this host, which
    has no JAX. Four of its parameters (the stem conv, layer4_2's 3x3 conv,
    deconv1, the final conv; flax's layout, first 4096 values each) against
    ``tests/data/jax_init_flagship.npz``, JAX's own values
    (``tests/make_jax_init_fixture.py``), within JAX_INIT_ULPS ulp (of
    max(|value|, the tensor's std)); then the host time of the draw alone
    (``draw``, ``jax_init_params`` uncached) for h36m3d_r50 and for
    h36m3d_r152_384."""
    from ihpr_tpu_torch.config import get_config
    from ihpr_tpu_torch.engine.trainer import Trainer
    from ihpr_tpu_torch.models import jax_random
    from ihpr_tpu_torch.models.convert import to_jax_params

    root = os.path.dirname(os.path.abspath(__file__))
    fixture = np.load(os.path.join(root, JAX_INIT_FIXTURE))
    failed = []
    with tempfile.TemporaryDirectory() as work:
        cfg = get_config("h36m3d_r50").replace(output_dir=work, seed=0)
        cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, batch_size_per_device=4))
        t0 = time.perf_counter()
        trainer = Trainer(cfg, data_root="synthetic", synthetic_size=8, num_workers=1, rss_limit_mb=0, device="cuda")
        t_trainer = time.perf_counter() - t0
        try:
            params, _ = to_jax_params(trainer.model)
        finally:
            trainer.close()
        del trainer
    rows = []
    for name in fixture.files:  # each a path in flax's params tree
        leaf = params
        for part in name.split("/"):
            leaf = leaf[part]
        want = fixture[name]
        got = np.asarray(leaf, np.float32).reshape(-1)[:want.size]
        std = np.float32(max(float(want.std()), 1e-30))
        ulps = float((np.abs(got.astype(np.float64) - want) / np.spacing(np.maximum(np.abs(want), std))).max())
        bitwise = float(np.mean(got == want))
        rows.append(f"{name.rsplit('/', 1)[0]} {ulps:.0f} ulp, {bitwise:.5f} bitwise")
        if not ulps <= JAX_INIT_ULPS:
            failed.append(f"jax-init: {name} is {ulps} ulp from JAX's values (bar {JAX_INIT_ULPS})")
    times = {}
    for config in ("h36m3d_r50", "h36m3d_r152_384"):
        c = get_config(config)
        t0 = time.perf_counter()
        p, _ = draw(c, c.joint_num, jax_random.trainer_init_key(c.seed))
        times[config] = (time.perf_counter() - t0, sum(int(np.prod(v.shape)) for v in _leaves(p)))
    print(f"jax-init: the h36m3d_r50 Trainer (seed 0) on the card holds JAX's initial weights, drawn on this host "
          f"without JAX: {'; '.join(rows)} against {JAX_INIT_FIXTURE} (bar {JAX_INIT_ULPS} ulp); the Trainer "
          f"built in {t_trainer:.2f} s  [{gpu}]")
    print("jax-init: the draw alone on the host, " + ", ".join(
        f"{c} {t:.2f} s ({n / 1e6:.1f} M parameters)" for c, (t, n) in times.items())
          + f", {jax_random._threads()} threads of {os.cpu_count()} CPUs  [{gpu}]")
    if failed:
        raise AssertionError("; ".join(failed))
    return times


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# --- 7k: spatial partitioning on uneven row shards ------------------------------

SPU_GRIDS = {"f": (3, 256), "g": (4, 64)}  # name: (ranks = S, input rows)
SPU_STEPS = 3  # (f): timed fp32 steps after the counted one, for the halo's share
TOL_SPU_LOSS = 1e-5  # (f) the first fp32 "highest" train loss on the grid vs one process, relative


def _spu_cfg(out: str, world: int, rows: int):
    """h36m3d_r50 in fp32 "highest" at rows x rows input (heatmaps rows / 4)
    on a 1 x ``world`` grid (world 1: one process), batch SP_BATCH."""
    cfg = _sp_cfg(out, world, fp32=True)
    return cfg.replace(data=dataclasses.replace(cfg.data, input_shape=(rows, rows),
                                                output_shape=(rows // 4, rows // 4)))


def _uneven_rank(rank: int, world: int, work: str, gpu: str):
    """One rank of spatial_uneven_phase on cuda:0 over gloo, S = world: the
    fp32 flip-test eval step on its rows (K3 counted), K3/K4 against plain
    on its rows' logits; at S = 3 also one counted fp32 train step and
    SPU_STEPS timed ones with the halo exchanges metered."""
    from ihpr_tpu_torch.data.augment import finalize_patch
    from ihpr_tpu_torch.models.pose_net import build_pose_net, inference_copy
    from ihpr_tpu_torch.ops import conv_bn as cb
    from ihpr_tpu_torch.ops import fused_head_integral as fhi
    from ihpr_tpu_torch.ops import integral_volume as iv
    from ihpr_tpu_torch.ops import matmul_bn as mm
    from ihpr_tpu_torch.parallel import mesh, train_step

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    name = next(k for k, (w, _) in SPU_GRIDS.items() if w == world)
    rows = SPU_GRIDS[name][1]
    inputs = torch.load(f"{work}/inputs_{name}.pt", weights_only=False)
    batch = {k: torch.from_numpy(v).cuda() for k, v in inputs["batch"].items()}
    cfg = _spu_cfg(f"{work}/rank{rank}", world, rows)
    dp = mesh.data_parallel(cfg)
    out = {"rows": [mesh.row_range(r, rank, world) for r in (rows, rows // 32 + (rows % 32 > 0), rows // 4)]}
    net = build_pose_net(cfg, device="cuda", dp=dp, state_dict=inputs["eval_model"])
    step = train_step.make_eval_step(inference_copy(net), cfg)
    step(batch)  # warm-up
    torch.cuda.synchronize()
    # --- the eval step on this rank's rows, counted ---
    _zero_counts(fhi, iv, mm, cb)
    coords = step(batch)[0]
    torch.cuda.synchronize()
    out["eval"] = (coords.cpu().numpy(), _counts(fhi, iv, mm, cb))
    # --------------------------------------------------
    with torch.no_grad():
        image = mesh.row_shard(finalize_patch(batch["patch"], batch["color_scale"], cfg.data), net.rows)
        hm = net(image).contiguous()
    b, h, w, c = hm.shape
    out["volume"] = (b, h * w, c)
    out["k3_err"], out["k4_err"] = check_volume(iv, hm.view(b, h * w, c), net.joint_num, net.depth_dim, w,
                                                f"spatial-uneven rank {rank} of {world}, its rows' logits ({b}, "
                                                f"{h * w}, {c}) fp32")
    del net, hm, image
    if name == "f":
        model = build_pose_net(cfg, device="cuda", trainable=True, dp=dp, state_dict=inputs["model"])
        opt, sched = train_step.make_optimizer(model, cfg, 100, dp)
        step = train_step.make_train_step(model, opt, cfg, scheduler=sched, dp=dp)
        torch.cuda.synchronize()
        # --- one train step, counted ---
        _zero_counts(fhi, iv, mm, cb)
        metrics = {k: float(v) for k, v in step(batch).items()}
        torch.cuda.synchronize()
        out["train"] = (metrics, _counts(fhi, iv, mm, cb))
        # -------------------------------
        walls = []
        with _HaloMeter(mesh) as meter:
            for _ in range(SPU_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(batch)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
        out["halo"] = (meter.s / SPU_STEPS, meter.nbytes / SPU_STEPS, meter.calls / SPU_STEPS, sum(walls) / SPU_STEPS)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["digest"] = _state_digest(model)
    return out


def spatial_uneven_phase(fhi, iv, gpu: str):
    """Spatial partitioning on GSPMD's uneven row shards (mesh.row_range:
    blocks of ceil(R / S) rows, the last short or empty), h36m3d_r50 at
    full width and depth in fp32 "highest", batch SP_BATCH, on ranks that
    time-share the one card over gloo. (f) S = 3 at 256x256: 86/86/84 input
    rows, 3/3/2 rows at stride 32, 22/22/20 heatmap rows: the flip-test eval
    step against one process (within TOL_SP_FP32 voxel), one train step's
    loss (within TOL_SPU_LOSS relative) and parameters bitwise equal on the
    ranks, K3 once a rank in eval and K3 + K4 once a rank a step, K3/K4
    against plain on each rank's rows, the halo exchanges' share of a
    step's host time. (g) a 1 x 4 grid at 64x64 in eval mode: 2 rows at
    stride 32, so ranks 2 and 3 own none there (at stride 16, one row
    each), 4 heatmap rows each: the eval step against one
    process. Returns the ranks' K3 and K4 launches and the largest
    K3/K4-vs-plain differences."""
    from ihpr_tpu_torch.data import skeletons
    from ihpr_tpu_torch.data.augment import finalize_patch
    from ihpr_tpu_torch.data.datasets import build_dataset
    from ihpr_tpu_torch.data.pipeline import BatchLoader
    from ihpr_tpu_torch.models.pose_net import build_pose_net, inference_copy
    from ihpr_tpu_torch.parallel import launch
    from ihpr_tpu_torch.parallel.train_step import make_eval_step, make_optimizer, make_train_step

    t_phase = time.perf_counter()
    failed = []
    results = {}
    with tempfile.TemporaryDirectory() as work:
        for name, (world, rows) in SPU_GRIDS.items():
            cfg = _spu_cfg(f"{work}/one", 1, rows)
            gen = torch.Generator().manual_seed(SEED)
            primary = skeletons.get_skeleton(cfg.data.trainset[0])
            sets = [build_dataset(n, "train", cfg, "synthetic", SP_SIZE, hue_skeleton=primary if i else None)
                    for i, n in enumerate(cfg.data.trainset)]
            loader = BatchLoader(sets, cfg, SP_BATCH, num_workers=8, seed=cfg.seed)
            hb = next(loader.epoch(0, 1))
            loader.close()
            batch_np = {f: getattr(hb, f) for f in ("patch", "color_scale", "joint_img", "joint_vis",
                                                    "joints_have_depth")}
            batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
            net = build_pose_net(cfg, device="cuda", generator=gen)
            image = finalize_patch(batch["patch"], batch["color_scale"], cfg.data)
            _peak_heatmaps(net, image, gen)
            sd = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
            torch.save({"model": sd, "eval_model": sd, "batch": batch_np}, f"{work}/inputs_{name}.pt")
            want = {"eval": make_eval_step(inference_copy(net), cfg)(batch)[0].cpu().numpy()}
            model = None
            if name == "f":
                model = build_pose_net(cfg, device="cuda", trainable=True, state_dict=sd)
                opt, sched = make_optimizer(model, cfg, 100)
                want["loss"] = float(make_train_step(model, opt, cfg, scheduler=sched)(batch)["loss"])
            del model, net, image, batch
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            ranks = launch.spawn(_uneven_rank, world, "gloo", work, gpu, workdir=work)
            results[name] = (ranks, want, time.perf_counter() - t0)

    k3 = k4 = 0
    for name, (ranks, want, secs) in results.items():
        world, rows = SPU_GRIDS[name]
        r0 = ranks[0]
        if not all(np.array_equal(r["eval"][0], r0["eval"][0]) for r in ranks):
            failed.append(f"spatial-uneven ({name}): eval coords differ between the ranks")
        err = float(np.abs(r0["eval"][0] - want["eval"]).max())
        spread = float(np.abs(want["eval"] - want["eval"].mean()).max())
        if not (err <= TOL_SP_FP32 and spread > 0.5):
            failed.append(f"spatial-uneven ({name}): eval {err} voxel from one process (bar {TOL_SP_FP32}), "
                          f"spread {spread}")
        for rank, r in enumerate(ranks):
            if r["eval"][1] != (0, 0, 1, 0, 0, 0, 0, 0):
                failed.append(f"spatial-uneven ({name}) rank {rank}: eval launches K1-K8 {r['eval'][1]}")
            k3 += r["eval"][1][2]
        layout = "; ".join(f"rank {i}: input {r['rows'][0]}, stride 32 {r['rows'][1]}, heatmap {r['rows'][2]}"
                           for i, r in enumerate(ranks))
        print(f"spatial-uneven ({name}): 1 x {world} ranks over gloo on one card, h36m3d_r50 fp32 \"highest\" at "
              f"{rows}x{rows}, rows [lo, hi) {layout}; flip-test eval step on {SP_BATCH} images {err:.3g} voxel from "
              f"one process (bar {TOL_SP_FP32:g}), spread {spread:.3g}; K3 {[r['eval'][1][2] for r in ranks]} a "
              f"rank, K1 0; {secs:.1f} s for the ranks' run  [{gpu}]")
        print(f"spatial-uneven ({name}): K3 vs plain {max(r['k3_err'] for r in ranks):.3g} voxel, K4 vs plain_bwd "
              f"{max(r['k4_err'] for r in ranks):.3g} on each rank's rows' logits "
              f"{[r['volume'] for r in ranks]} fp32")
        if name != "f":
            continue
        for rank, r in enumerate(ranks):
            metrics, counts = r["train"]
            if counts != (0, 0, 1, 1, 0, 0, 0, 0) or abs(metrics["loss"] - want["loss"]) > TOL_SPU_LOSS * abs(
                    want["loss"]):
                failed.append(f"spatial-uneven (f) rank {rank}: loss {metrics['loss']} against one process's "
                              f"{want['loss']} (bar {TOL_SPU_LOSS} relative), K1-K8 {counts}")
            k3, k4 = k3 + counts[2], k4 + counts[3]
            halo_s, halo_bytes, halo_calls, wall = r["halo"]
            print(f"spatial-uneven (f) rank {rank}: fp32 step {wall * 1e3:.3f} ms wall (host clock, {SPU_STEPS} "
                  f"steps), halo exchanges {halo_s * 1e3:.3f} ms of it ({halo_s / wall:.3f}, {halo_calls:.0f} "
                  f"calls), {halo_bytes / 2**20:.3f} MiB sent a step, peak {r['peak_gib']:.2f} GiB (three ranks "
                  f"share the card; gloo copies through host memory: not a scaling number)  [{gpu}]")
        if len({r["digest"] for r in ranks}) != 1:
            failed.append("spatial-uneven (f): parameters and BN buffers differ between the ranks")
        print(f"spatial-uneven (f): one fp32 train step: loss {r0['train'][0]['loss']:.8f} against one process's "
              f"{want['loss']:.8f} (relative {abs(r0['train'][0]['loss'] - want['loss']) / abs(want['loss']):.3g}, "
              f"bar {TOL_SPU_LOSS:g}); K3/K4 {[r['train'][1][2:4] for r in ranks]} a rank; parameters and BN "
              f"buffers bitwise equal on the ranks")
    print(f"spatial-uneven: the phase took {time.perf_counter() - t_phase:.1f} s  [{gpu}]")
    if failed:
        raise AssertionError("; ".join(failed))
    errs = [r[key] for ranks, _, _ in results.values() for r in ranks for key in ("k3_err", "k4_err")]
    return k3, k4, max(errs[0::2]), max(errs[1::2])


EXP_MODES = {"exp2": (True, False), "bexp": (False, True), "exp2_bexp": (True, True)}
EXP_F32_BATCH = 32  # K1/K2-fp32 in the exp modes, at h36m3d_r50_fp32's batch
EXP_HEAD = (64 * 64, 64, 256, 18, 64)  # (H*W, W, C, J, D): the flagship head
# The flagship train steps of the modes phase: (label, ModelConfig fields,
# environment), each run as tools/bwd_experiments.py measures a variant.
MODE_RUNS = [("lean", {}, {})] + [
    (m, dict(bn_mode=m), {}) for m in ("flax", "lean16", "lean_sub4", "lean_sub8", "lean_sg", "lean_sgv", "frozen")
] + [(f"remat_{p}", dict(block_remat=True, remat_policy=p), {}) for p in ("full", "conv_outs")] + [
    (m, {}, {"IHPR_EXP2": "1" if e2 else "0", "IHPR_BEXP": "1" if be else "0"}) for m, (e2, be) in EXP_MODES.items()
]
MODE_STEPS = 2  # timed steps a run (beside its first step and one profiled step)
TOL_BEXP = 0.5  # K2's IHPR_BEXP move (with against without) vs plain_bwd's, of plain's move (2-norm)
TOL_REMAT = 1e-3  # a remat step's gradients vs the plain step's, of each tensor's largest
TOL_S2D = 0.3  # voxel: the s2d stem's served coords vs the 7x7 stem's, two bf16 roundings (as TOL_ARTIFACT_K1)


def bexp_effect_check(fhi, args, j, d, w, exp2, label):
    """IHPR_BEXP moves K2's results by one bf16 rounding of p, less than
    TOL_BWD, so check_bwd alone cannot tell a K2 that ignores it. Here the
    kernel's own move (with IHPR_BEXP against without, the same exp2) is
    held against plain_bwd's on the same inputs: their difference within
    TOL_BEXP of plain's move, 2-norm, for each result. Returns the largest
    ratio."""
    kern = [fhi.kernel_bwd(*args, j, d, w, exp2, on) for on in (True, False)]
    plain = [fhi.plain_bwd(*args, j, d, w, exp2, on) for on in (True, False)]
    worst, rel = 0.0, []
    for name, a, a0, r, r0 in zip(("dfeat", "dW", "db"), *kern, *plain):
        move = r.double() - r0.double()
        ratio = float(((a.double() - a0.double()) - move).norm() / move.norm())
        if not ratio <= TOL_BEXP:
            raise AssertionError(f"K2 {label} {name}: the kernel's IHPR_BEXP move is off plain's by {ratio:.3g} of it")
        worst = max(worst, ratio)
        rel.append(f"{name} {ratio:.3g}")
    print(f"K2 {label}: |kernel's IHPR_BEXP move - plain's| / |plain's| " + ", ".join(rel) + f" (bar {TOL_BEXP})")
    return worst


def exp_modes_check(fhi, gpu: str):
    """K1 / K2 in bf16 at the train batch (128, 4096, 256) x (256, 1152) and
    K1-fp32 / K2-fp32 at EXP_F32_BATCH, under IHPR_EXP2, IHPR_BEXP and both
    (kernel_stats / kernel_bwd with the modes): each against plain /
    plain_bwd in the same mode at TOL_VOXEL and TOL_BWD (under IHPR_BEXP p
    is a bf16 value, so K2-fp32 takes the bf16 bar, and bexp_effect_check
    holds the mode's own move), K1 bitwise over K1_REPEATS launches; each mode's time beside the natural base's, in
    turns. Returns the largest differences {K1, K2, K1f, K2f}."""
    hw, w, c, j, d = EXP_HEAD
    errs = {}
    for dtype, b, k1, k2 in ((torch.bfloat16, TRAIN_BATCH, "K1", "K2"), (torch.float32, EXP_F32_BATCH, "K1f", "K2f")):
        feat, kernel, bias = _head_inputs(b, hw, c, j * d, dtype, SEED)
        g = torch.randn(b, j, 3, generator=torch.Generator().manual_seed(SEED)).cuda()
        tag = f"{'bf16' if dtype == torch.bfloat16 else 'fp32'} ({b}, {hw}, {c}) x ({c}, {j * d})"
        e1, e2 = [], []
        runs = {}
        for mode, (exp2, bexp) in {"natural": (False, False), **EXP_MODES}.items():
            e1.append(check_kernel(fhi, feat, kernel, bias, j, d, w, exp2=exp2))
            differ = repeat_check(fhi, (feat, kernel, bias), j, d, w, K1_REPEATS, exp2=exp2)
            if differ:
                raise AssertionError(f"{k1} {mode}: {differ} of {K1_REPEATS} repeated launches differ bitwise")
            coords, m, s = fhi.kernel_stats(feat, kernel, bias, j, d, w, exp2)
            args = (feat, kernel, bias, m, s, coords, g)
            tol = TOL_BWD[torch.bfloat16 if bexp else dtype]
            e2.append(check_bwd(fhi, args, j, d, w, tol, f"{mode} {tag}", modes=(exp2, bexp))[0])
            if bexp:
                bexp_effect_check(fhi, args, j, d, w, exp2, f"{mode} {tag}")
            runs[mode] = (lambda a=args, m2=(exp2, bexp): fhi.kernel_stats(*a[:3], j, d, w, m2[0]),
                          lambda a=args, m2=(exp2, bexp): fhi.kernel_bwd(*a, j, d, w, *m2))
        times = {mode: ([], []) for mode in runs}
        for rnd in range(2):
            for mode in (list(runs) if rnd == 0 else list(runs)[::-1]):
                times[mode][0].append(_cuda_ms(runs[mode][0], 10, reps=3))
                times[mode][1].append(_cuda_ms(runs[mode][1], 5, reps=3))
        for mode in runs:
            t1, t2 = (statistics.median(t) for t in times[mode])
            print(f"{k1}/{k2} {tag} {mode}: {k1} {t1:.4f} ms, {k2} {t2:.4f} ms (CUDA events, the modes in turns); "
                  f"vs plain in the same mode {k1} max|dcoords| {e1[list(runs).index(mode)]:.3g} voxel, {k2} "
                  f"max|diff| {e2[list(runs).index(mode)]:.3g}; {K1_REPEATS} repeats bitwise  [{gpu}]")
        errs[k1], errs[k2] = max(e1), max(e2)
        del feat, kernel, bias, runs
    torch.cuda.empty_cache()
    return errs


def modes_phase(fhi, gpu: str):
    """The JAX package's model and kernel modes on the card: (a)
    exp_modes_check; (b) h36m3d_r50 (batch 128, bf16) trained on two
    resident batches of synthetic frames under each BN mode, each remat
    policy and each exp mode (MODE_RUNS, tools/bwd_experiments.measure: a
    first step, MODE_STEPS timed, one profiled): loss finite, ms a step,
    device busy, peak GiB; each remat policy's first forward and backward
    against the plain step's from the same state under cuDNN's
    deterministic algorithms (gradients TOL_REMAT, running statistics
    1e-6); (c) a flip-test dispatch of 32 patches through PoseServer with
    the s2d stem, its 7x7 stem embedded (s2d_stem_kernel), against the 7x7
    server's (TOL_S2D), after one warm-up dispatch each. Counted: K1 / K2
    once a step and K1 once a dispatch. Returns (K1 launches, K2 launches, {K1, K2, K1f, K2f: the
    exp checks' largest differences})."""
    from ihpr_tpu_torch.data import skeletons
    from ihpr_tpu_torch.data.augment import finalize_patch
    from ihpr_tpu_torch.engine.server import PoseServer
    from ihpr_tpu_torch.models.pose_net import build_pose_net
    from ihpr_tpu_torch.models.resnet import s2d_stem_kernel
    from ihpr_tpu_torch.tools import bwd_experiments as bx

    t0 = time.perf_counter()
    errs = exp_modes_check(fhi, gpu)
    base = bx.base_config()
    batches = bx.resident_batches(base, TRAIN_BATCH, "cuda")

    # --- the main path under each mode, counted ---
    fhi.launches = fhi.bwd_launches = 0
    steps = 0
    for label, kw, env in MODE_RUNS:
        cfg = base.replace(model=dataclasses.replace(base.model, **kw))
        with bx.environ(env):
            res = bx.measure(cfg, batches, "cuda", MODE_STEPS, 0)
        steps += res["steps_run"]
        print(f"modes: h36m3d_r50 batch {TRAIN_BATCH} {label}: {res['step_ms']:.3f} ms/step "
              f"({TRAIN_BATCH / res['step_ms'] * 1e3:.1f} img/s), device busy {res['busy_ms']:.3f} ms, idle share "
              f"{res['idle_share']:.3f}, peak {res['peak_gib']:.3f} GiB, loss {res['first_loss']:.4f} -> "
              f"{res['loss']:.4f}  [{gpu}]")
    flip_perm = skeletons.get_skeleton(base.data.trainset[0]).flip_permutation()
    torch.backends.cudnn.deterministic = True
    try:
        plain = build_pose_net(base, device="cuda", trainable=True)
        state = {k: v.detach().clone() for k, v in plain.state_dict().items()}
        loss0, grads0 = _first_step(plain, base, batches[0], state, flip_perm)
        stats0 = {k: v.clone() for k, v in plain.named_buffers()}
        del plain
        for policy in ("full", "conv_outs"):
            cfg = base.replace(model=dataclasses.replace(base.model, block_remat=True, remat_policy=policy))
            model = build_pose_net(cfg, device="cuda", trainable=True)
            loss, grads = _first_step(model, cfg, batches[0], state, flip_perm)
            worst = max(float((grads[n] - grads0[n]).abs().max() / grads0[n].abs().max()) for n in grads0)
            stat_gap = max(float((b - stats0[n]).abs().max()) for n, b in model.named_buffers())
            print(f"modes: remat {policy} first forward and backward vs the plain step's from the same state: loss "
                  f"{loss:.6f} / {loss0:.6f}, worst tensor |dgrad|/max {worst:.3g} (bar {TOL_REMAT:g}), running "
                  f"statistics {stat_gap:.3g} apart (bar 1e-6)")
            if set(grads) != set(grads0) or worst > TOL_REMAT or stat_gap > 1e-6 or not math.isfinite(loss):
                raise AssertionError(f"remat {policy}: loss {loss} / {loss0}, gradients {worst}, statistics {stat_gap}")
            del model, grads
        steps += 3
    finally:
        torch.backends.cudnn.deterministic = False
    del grads0
    torch.cuda.empty_cache()

    gen = torch.Generator().manual_seed(SEED)
    model7 = build_pose_net(base, device="cuda", generator=gen)
    patches = np.random.RandomState(SEED).randint(0, 256, (MAX_BATCH, *base.data.input_shape, 3)).astype(np.uint8)
    with torch.inference_mode():
        image = finalize_patch(torch.from_numpy(patches).cuda(), torch.ones(MAX_BATCH, 3, device="cuda"), base.data)
    _peak_heatmaps(model7, image, gen)
    sd = model7.state_dict()
    sd["backbone.conv1.weight"] = s2d_stem_kernel(sd["backbone.conv1.weight"])
    cfg_s2d = base.replace(model=dataclasses.replace(base.model, s2d_stem=True))
    model_s2d = build_pose_net(cfg_s2d, device="cuda", state_dict=sd)
    servers = [PoseServer(c, m, max_batch=MAX_BATCH, flip_test=True, device="cuda")
               for c, m in ((base, model7), (cfg_s2d, model_s2d))]
    for srv in servers:
        srv.predict_patches(patches)  # warm-up: cuDNN's plans for the s2d stem
    v7, vs = (srv.predict_patches(patches) for srv in servers)
    s2d_err, spread = float(np.abs(vs - v7).max()), float(np.abs(v7 - v7.mean()).max())
    print(f"modes: s2d stem served {MAX_BATCH} patches (flip-test) vs the 7x7 stem on embedded weights: max|dcoords| "
          f"{s2d_err:.3g} voxel (bar {TOL_S2D}; coord spread {spread:.3g})")
    if not (s2d_err <= TOL_S2D and spread > 1.0 and np.isfinite(vs).all()):
        raise AssertionError(f"s2d stem coords {s2d_err} voxel from the 7x7 stem's (spread {spread})")
    k1, k2 = fhi.launches, fhi.bwd_launches
    # ----------------------------------------------
    if (k1, k2) != (steps + 4, steps):
        raise AssertionError(f"modes: K1 / K2 launched {k1} / {k2} times for {steps} steps and 4 dispatches")
    del servers, model7, model_s2d
    torch.cuda.empty_cache()
    print(f"modes: K1 / K2 launches {k1} / {k2} ({steps} steps, 4 dispatches); {time.perf_counter() - t0:.1f} s")
    return k1, k2, errs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Smoke run of ihpr_tpu_torch on one NVIDIA GPU.")
    parser.add_argument("--only", nargs="+",
                        choices=("bn", "fused", "dp", "dp-serve", "device-warp", "serving-bench", "real-data",
                                 "spatial", "spatial-uneven", "accuracy", "fp32-kernels", "fp32-train",
                                 "fp32-fused", "fp32-conv3", "parity-serve", "no-plan", "modes", "jax-init"),
                        help="build the kernels and run only these phases (no JSON lines)")
    only = parser.parse_args(argv).only
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run", file=sys.stderr)
        return 1
    from ihpr_tpu_torch.data import jpeg
    from ihpr_tpu_torch.ops import _build
    from ihpr_tpu_torch.ops import conv_bn as cb
    from ihpr_tpu_torch.ops import fused_head_integral as fhi
    from ihpr_tpu_torch.ops import integral_volume as iv
    from ihpr_tpu_torch.ops import jpeg_color
    from ihpr_tpu_torch.ops import matmul_bn as mm
    from ihpr_tpu_torch.tools import exp_probe as ep
    from ihpr_tpu_torch.tools import mxu_int8_probe as pm

    gpu = _gpu_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    print(subprocess.run([_build.nvcc(), "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[-1])
    torch.backends.cuda.matmul.allow_tf32 = False  # plain fp32 versions are true fp32

    t0 = time.perf_counter()
    libs = _build.build_all([fhi._LIB, fhi._BWD_LIB, fhi._F32_LIB, fhi._F32_BWD_LIB, "tf32x3_selftest",
                             iv._FWD_LIB, iv._BWD_LIB,
                             mm._FWD_LIB, mm._BWD_LIB, cb._FWD_LIB, cb._BWD_LIB, ep._LIB, pm._LIB, jpeg._LIB,
                             jpeg_color._LIB])
    print(f"build: {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        print(lib.with_suffix(".log").read_text().strip())
    draw = _keep_jax_draws()
    if only:
        phases = {"bn": lambda: bn_kernel_phase(mm, cb, gpu), "fused": lambda: fused_train_phase(fhi, iv, mm, cb, gpu),
                  "dp": lambda: dp_phase(fhi, iv, mm, cb, gpu), "dp-serve": lambda: dp_serve_phase(fhi, gpu),
                  "device-warp": lambda: device_warp_phase(fhi, gpu), "serving-bench": lambda: serving_bench_phase(gpu),
                  "real-data": lambda: real_data_phase(fhi, gpu), "spatial": lambda: spatial_phase(fhi, iv, gpu),
                  "spatial-uneven": lambda: spatial_uneven_phase(fhi, iv, gpu),
                  "accuracy": lambda: accuracy_phase(fhi, iv, mm, cb, gpu),
                  "fp32-kernels": lambda: f32_kernel_phase(fhi, iv, gpu),
                  "fp32-train": lambda: fp32_train_phase(fhi, iv, gpu),
                  "fp32-fused": lambda: fp32_fused_phase(fhi, iv, mm, cb, gpu),
                  "fp32-conv3": lambda: fp32_conv3_phase(fhi, iv, mm, cb, gpu),
                  "parity-serve": lambda: parity_serve_phase(fhi, iv, gpu),
                  "no-plan": lambda: noplan_phase(fhi, iv, gpu),
                  "modes": lambda: modes_phase(fhi, gpu), "jax-init": lambda: jax_init_phase(gpu, draw)}
        for name in only:
            phases[name]()
        print(gpu)
        return 0

    jax_init_phase(gpu, draw)
    k1_err, k1_times = kernel_phase(fhi, gpu)
    k1_ms, k1_plain = k1_times[2 * MAX_BATCH]  # the serving shape, as b1 and k1_lib
    k2_err, (k2_ms, k2_plain) = k2_phase(fhi, gpu)
    k1_lib, k1_lib_train, k2_lib = head_library_phase(fhi, iv, gpu)
    f32_n1, f32_n2, f32_k1_err, f32_k2_err, f32_fwd, f32_bwd = f32_kernel_phase(fhi, iv, gpu)
    (k1_train_ms, _), b1_train = k1_times[TRAIN_BATCH], k1_bound(TRAIN_BATCH)[0]
    print(f"K1 at the train batch ({TRAIN_BATCH}, 4096, 256): kernel {k1_train_ms:.4f} ms, library "
          f"{k1_lib_train:.4f} ms, bound {b1_train:.4f} ms; K1 + K2 per train step {k1_train_ms + k2_ms:.4f} "
          f"ms against the library's {k1_lib_train + k2_lib:.4f} ms  [{gpu}]")
    k3_err, k4_err, (k3_ms, k3_plain), (k4_ms, k4_plain) = volume_phase(iv, gpu)
    bn = bn_kernel_phase(mm, cb, gpu)
    serve_k1, r50_server = serve_phase(fhi, gpu)
    export_phase(r50_server, gpu)
    del r50_server
    train_k1, train_k2, head_err = train_phase(fhi, gpu)
    modes_k1, modes_k2, modes_errs = modes_phase(fhi, gpu)
    f32_train_k1, f32_train_k2 = fp32_train_phase(fhi, iv, gpu)
    k5f_n, k6f_n, (k5f_err, k6f_err) = fp32_fused_phase(fhi, iv, mm, cb, gpu)
    conv3_n, (k7f_err, k8f_err) = fp32_conv3_phase(fhi, iv, mm, cb, gpu)
    parity_k1 = parity_serve_phase(fhi, iv, gpu)
    snap_k1, snap_k2 = snapshot_phase(fhi, gpu)
    r152_k1, r152_k2, r152_k1_err, r152_k2_err = r152_phase(fhi, iv, gpu)
    (k5_n, k6_n, k7_n, k8_n), fused_errs = fused_train_phase(fhi, iv, mm, cb, gpu)
    dp_n, dp_errs = dp_phase(fhi, iv, mm, cb, gpu)
    dp_serve_k1 = dp_serve_phase(fhi, gpu)
    warp_k1, warp_k2 = device_warp_phase(fhi, gpu)
    serving_bench_phase(gpu)
    real_k1, real_k2, colour = real_data_phase(fhi, gpu)
    acc_k1f, acc_k2f, acc_colour, acc_colour_err = accuracy_phase(fhi, iv, mm, cb, gpu)
    sp_k3, sp_k4, sp_k3_err, sp_k4_err = spatial_phase(fhi, iv, gpu)
    spu_k3, spu_k4, spu_k3_err, spu_k4_err = spatial_uneven_phase(fhi, iv, gpu)
    hm_k3, hm_k4, hm_err, hm_dv_err = heatmap_phase(fhi, iv, gpu)
    np_k3, np_k4, np_err = noplan_phase(fhi, iv, gpu)
    eval_k1, eval_k3, eval_k1_err, eval_k3_err = eval_phase(fhi, iv, gpu)
    p1 = exp_probe_phase(ep, gpu)
    p2 = probe_mm_phase(pm, gpu)
    b1, b2, b3, b4 = head_bounds()
    kernels = [
        (fhi._LIB, "ihpr_tpu/ops/fused_head_integral.py:133",
         serve_k1 + train_k1 + modes_k1 + snap_k1 + r152_k1 + eval_k1 + dp_n["K1"] + dp_serve_k1 + warp_k1 + real_k1,
         max(k1_err, eval_k1_err, r152_k1_err, dp_errs["K1"], modes_errs["K1"]), k1_ms, k1_plain, *b1, k1_lib),
        (fhi._BWD_LIB, "ihpr_tpu/ops/fused_head_integral.py:153",
         train_k2 + modes_k2 + snap_k2 + r152_k2 + dp_n["K2"] + warp_k2 + real_k2,
         max(k2_err, head_err, r152_k2_err, dp_errs["K2"], modes_errs["K2"]), k2_ms, k2_plain, *b2, k2_lib),
        (iv._FWD_LIB, "ihpr_tpu/ops/integral_pallas.py:201", hm_k3 + np_k3 + eval_k3 + sp_k3 + spu_k3,
         max(k3_err, hm_err, np_err, eval_k3_err, sp_k3_err, spu_k3_err), k3_ms, k3_plain, *b3, None),
        (iv._BWD_LIB, "ihpr_tpu/ops/integral_pallas.py:239", hm_k4 + np_k4 + sp_k4 + spu_k4,
         max(k4_err, hm_dv_err, sp_k4_err, spu_k4_err), k4_ms, k4_plain, *b4, None),
        # K1/K2's fp32 instances, timed at h36m3d_r50_fp32's batch; the
        # library is the no-plan route (cuBLAS fp32 with K3 / K4).
        (fhi._F32_LIB, "ihpr_tpu/ops/fused_head_integral.py:133",
         f32_n1 + f32_train_k1 + parity_k1 + acc_k1f + conv3_n[4],
         max(f32_k1_err, modes_errs["K1f"]), *f32_fwd[F32_TRAIN_BATCH][:2], *f32_bound(F32_TRAIN_BATCH, 1), f32_fwd[F32_TRAIN_BATCH][2]),
        (fhi._F32_BWD_LIB, "ihpr_tpu/ops/fused_head_integral.py:153", f32_n2 + f32_train_k2 + acc_k2f + conv3_n[5],
         max(f32_k2_err, modes_errs["K2f"]), *f32_bwd[F32_TRAIN_BATCH][:2], *f32_bound(F32_TRAIN_BATCH, 3), f32_bwd[F32_TRAIN_BATCH][2]),
    ]
    for (name, replaces, key, launches), err in zip(
        ((mm._FWD_LIB, "ihpr_tpu/ops/matmul_bn.py:127", "k5", k5_n + dp_n["K5"]),
         (mm._BWD_LIB, "ihpr_tpu/ops/matmul_bn.py:151", "k6", k6_n + dp_n["K6"]),
         (cb._FWD_LIB, "ihpr_tpu/ops/conv_bn.py:150", "k7", k7_n),
         (cb._BWD_LIB, "ihpr_tpu/ops/conv_bn.py:177", "k8", k8_n)),
        (max(fused_errs["K5/K6"][0], dp_errs["K5"]), max(fused_errs["K5/K6"][1], dp_errs["K6"]),
         *fused_errs["K7/K8"]),
    ):
        phase_err, ms, plain_ms, lib_ms, bound_ms, bound_by = bn[key]
        kernels.append((name, replaces, launches, max(phase_err, err), ms, plain_ms, bound_ms, bound_by, lib_ms))
    # K5/K6's fp32 instances (csrc/matmul_bn_f32.cuh, behind the same two
    # entry points), timed over a fp32 fused_1x1 step's 16 launches, and
    # K7/K8's (csrc/conv3_f32.cuh), timed over 7n's 5 launches a step; the
    # library is cuBLAS / cuDNN fp32 with TF32 off, and torch sums.
    for name, replaces, key, launches, err in (
        (F32_FWD_NAME, "ihpr_tpu/ops/matmul_bn.py:127", "k5f", k5f_n + conv3_n[0], k5f_err),
        (F32_BWD_NAME, "ihpr_tpu/ops/matmul_bn.py:151", "k6f", k6f_n + conv3_n[1], k6f_err),
        (CONV_F32_FWD_NAME, "ihpr_tpu/ops/conv_bn.py:150", "k7f", conv3_n[2], k7f_err),
        (CONV_F32_BWD_NAME, "ihpr_tpu/ops/conv_bn.py:177", "k8f", conv3_n[3], k8f_err),
    ):
        phase_err, ms, plain_ms, lib_ms, bound_ms, bound_by = bn[key]
        kernels.append((name, replaces, launches, max(phase_err, err), ms, plain_ms, bound_ms, bound_by, lib_ms))
    p1_n, p1_err, p1_ms, p1_plain, p1_lib, p1_bound = p1
    kernels.append((ep._LIB, "tools/exp_probe.py:44", p1_n, p1_err, p1_ms, p1_plain, p1_bound, "bytes", p1_lib))
    p2_n, p2_err, p2_ms, p2_plain, p2_lib, p2_bound, p2_by = p2
    kernels.append((pm._LIB, "tools/mxu_int8_probe.py:110", p2_n, p2_err, p2_ms, p2_plain, p2_bound, p2_by, p2_lib))
    # No Pallas kernel: the JAX package's libjpeg decode on the host, whose
    # upsampling and colour conversion the kernel computes.
    kernels.append((jpeg_color._LIB, "native/warp.cc:379", colour["launches"] + acc_colour,
                    max(colour["err"], acc_colour_err),
                    colour["ms"], colour["plain_ms"], colour["bound_ms"], "bytes", None))
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": SOURCES.get(name, f"ihpr_tpu_torch/ops/csrc/{name}.cu"),
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    } for name, replaces, launches, err, ms, plain_ms, bound_ms, bound_by, library_ms in kernels]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
