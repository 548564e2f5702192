#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--out FILE.json]

Run from the root of the repo.  Phases, each of which either succeeds or
ends the run with a non-zero exit code:

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``mudiff_torch/csrc`` (one nvcc per
   source, all started together), print the build time, and require a
   GMMA (wgmma) instruction in K4's, K1's and both K3 libraries
   (cuobjdump -sass);
3. serve three requests through ``build_sampler``: G1 + G2 at
   ``brats_recipe(num_channels_dae=64, image_size=256)`` with seeded
   non-trivial weights, each request a batch of 4 slices through the
   4-step bf16 sampler with bf16-score attention.  The kernels' launch
   counts are zeroed just before and read just after; each must equal
   what the module structure says (K3 launches 0 times here; every
   GroupNorm / AdaGN runs K5, on its 16-byte-vector path).  A CUDA
   call that records a graph runs through the kernels, forward and
   backward; a second backward through K1, K3 or K5 raises, through K2
   it runs the kernels;
   the int8 leg: the same requests served W8A8 (``use_int8``, K4 on
   every routed conv), with dynamic scales and then with the static
   scales that ``calibrate_sampler`` records over CALIB_BATCHES seeded
   batches, counted as above (K1 and K4 apart, and K4 by path: every
   launch must take the fused wgmma path); best-of-3 slices/s and
   one profiled request of each mode; each mode's sample through the
   kernels against its plain versions (``INT8_SAMPLE_TOL``) and against
   the bf16 sample;
4. whole-volume prediction through the port's CLI
   (``mudiff_torch.cli.test_volume.main``, ``--bf16 --attn flash``) on
   three seeded synthetic 240x240x155 contrasts written as .nii.gz, with
   the same weights saved by ``save_generators``: 25 slices in 4 batches
   of 8, the last one padded.  Counted as in 3 (32 K3 launches); the
   output NIfTI is checked (shape, affine, zeros outside the slices,
   finite and not constant inside) and the phase is timed;
5. the same volume with the plain versions forced (same seed, so the
   same draws), and both again in fp32 (``--no_bf16``): the fp32 volumes
   within ``SAMPLE_TOL["fp32"]``, the bf16 ones within
   ``BF16_VOLUME_TOL`` (``volume_drift.py`` measures what sets it); then
   the CLI's default, W8A8, with the int8 leg's calibration written as
   the sidecars beside the checkpoint, and with ``--int8_dynamic``, each
   counted and checked as in 4 (K4 on its fused path only);
6. training: ``create_train_state`` + ``make_train_step`` at the same
   recipe, batch 2, bf16, ``attn="flash"``, seeded non-trivial weights
   (the critic too, off its zero-init head).  Four iterations on global
   steps 0-3 (``lazy_reg`` 16: R1 on step 0) under cuDNN's fixed choice
   of algorithm (``fixed_cudnn``), counted as in 3 against
   ``kernel_launches_per_iteration``; finite losses, D, G1 and G2 changed,
   ``att_conv`` unchanged.  Then one D (with R1) + G iteration's losses
   and gradients through the kernels against the same iteration under
   ``plain_kernels()`` (same weights, injected draws), in bf16 and fp32,
   both under ``fixed_cudnn``, within ``TRAIN_TOL`` (in bf16 G_mask by
   its factors, ``MASK_TOL``); best-of-N times of an iteration with and
   without R1 and of the D and G steps, training slices/s, peak memory,
   and one iteration under torch.profiler;
7. the training program and the slice test through their CLIs, at the
   same width on seeded synthetic data: LOOP_PATIENTS patients of
   LOOP_VOLUME voxels in four modalities written as .nii.gz, then
   ``python -m mudiff_torch.data.preprocess`` (+-LOOP_HALF slices, a 4 /
   2 / 2 split: 20 train, 10 val, 10 test slices); ``mudiff_torch.cli.
   train`` for LOOP_EPOCHS epochs at batch 2 (``--attn flash``, R1 every
   LOOP_LAZY global steps), its ``content.pt`` restored into a fresh state
   and held against the file tensor for tensor (Adam state, schedule
   counts, step), then ``--resume`` for one more epoch (R1 where the
   restored global step puts it; the history holds every epoch); then
   ``mudiff_torch.cli.test`` int8 (dynamic scales, K4 on its fused path)
   and ``--bf16``: 10 PNG pairs that read back through ``utils/png.py``
   as the codes written, finite metrics.  Every run counted as in 3,
   against the iterations' ``kernel_launches_per_iteration`` and the
   sampling calls' launches; its times, the data-wait share, the
   checkpoint's bytes and save / restore times and the peak memory
   printed beside the card;
8. the shipped experiment through the port's own CLIs, at its width:
   ``experiments/brats.yaml`` copied with only ``data_path`` (phase 7's
   split), ``output_root`` and ``num_epoch`` (30 -> 1) changed, so
   ``synthesize_T1CE`` keeps nf=128, batch 2, remat ``hires``, lazy_reg
   16, bf16; under PyTorch's default cuDNN settings, as a user runs
   them: ``check_pipeline`` (exit 0), ``run`` (one epoch, then the test
   at batch 8: iteration times, peak memory, ``content.pt`` bytes and
   save time, slices/s, metrics), ``metric_calc`` (the run's metrics;
   ``--lpips_rand`` on the card), ``calibrate_int8 --batches 2``, the
   test CLI ``--int8_static`` on those sidecars (K4, fused path only),
   and ``predict_volume_wrapper`` on a phase 7 patient (checked as in
   4).  Then the remat table at the same width and batch: none /
   ``hires`` / ``hires4`` / ``blocks``, and no remat and ``blocks`` with
   flash attention; per leg one D (R1) + G iteration's gradients against
   the no-remat leg's (``TRAIN_TOL["bf16"]``; the no-remat leg against
   its own repeat gives the run-to-run floor) and launches that must
   exceed it for every recomputed kernel, then wall and device-only
   (profiled) medians and the peak memory;
9. at every distinct shape any path gave each kernel (and, for K3 and
   its backward, the nf=128 width and a ragged length; for K2, the
   shapes of ``FIR_EXTRA_SHAPES`` on its one-channel path; for K5, the
   benchmark's ``K5_PATHS``), hold the kernel against its plain PyTorch
   version (bf16 and fp32; K5 in the path's dtypes, as ``K5_ULPS``
   says), and time the kernel, the plain version and one library call
   computing the same function (cuDNN conv, depthwise conv,
   conv-transpose, scaled_dot_product_attention and its backward, NCHW
   ``F.group_norm``) with CUDA events,
   device time only (``time_ms``); K2 also with the L2 cold
   (``time_cold_ms``), and its share of the bound is read on that
   time.  K4 is held bit for bit (the fused kernel's s32 accumulator
   from x and its absmax, the general path's codes and s32 accumulator,
   and the output, in both modes and in bf16 and fp32 compute) at every
   shape the int8 runs gave it and at INT8_EXTRA_SHAPES (one of them on
   the general path), and timed beside the general path (its quantize
   and GEMM apart), ``torch._int_mm`` on the codes' explicit im2col and
   K1 in bf16; the profiled int8 requests split K4 into its absmax and
   conv kernels.  The
   bound is the larger of bytes / HBM rate and operations / peak rate of
   the card.  K1's, K3's and K3's backward rows name their
   design, the path ``k1_path`` / ``k3_path`` picks ("wgmma": bf16 / fp16
   on Hopper's wgmma and TMA; "general": bf16 / fp16 on mma.sync; "fma":
   fp32 on the CUDA cores) and every row and entry its share of the bound
   (bound ms / ms, K2's bound ms / ms_cold).  K3 is held in bf16, fp16
   and fp32; where its path is "wgmma", its 64- and 128-query blocks must
   give the same bits, and the general path's mma.sync kernels are held and
   timed beside it through their entry points (``general_ms``).  K3's
   backward runs twice on the same inputs (each path it runs) and must
   give the same bits.  Every counted run checks K1's and K3's launches
   by path against what ``k1_path`` / ``k3_path`` predict for its calls
   (``k1_path_check``, ``k3_path_check``);
10. the whole sample with the plain versions forced, same weights and
   injected noise: bf16 and fp32 differences against stated tolerances;
11. best-of-N slices/s of one request, and one request under
   torch.profiler (device time by kernel, the device's idle share), then
   one batch-8 sample of the volume phase's sampler (--attn flash) too;
12. every kernel must have launched in 3, 4 or 6, each in 7, K1, K2 and
   K4 in 8's CLI runs, K1-K3 in its remat table, each in 14 and K1,
   K2a, K2b and K4 in 15; the
   kernels summed
   over the volume phase's, the training phase's, the int8 leg's, the
   train-loop phase's and phase 8's two runs' launches, then the
   ``kernels`` JSON line (K1 and K2 over the main
   path's launches, K3 over the volume phase's, K3's backward over the
   training phase's, K4 over the int8 leg's sampler run), then
   ``{"ok": true, "device": ...}``.
13. (run after 8, in its work directory) the distributed path at world
   size 1 over NCCL: (a) one D (R1) + G iteration at 8's width (nf=128,
   batch 2, remat ``hires``, bf16, flash attention) through the mesh's
   collectives on an explicit one-rank group (a TCPStore on localhost),
   against the same iteration without a mesh, from the same weights and
   draws, under ``torch.use_deterministic_algorithms(True,
   warn_only=True)`` and ``cudnn.deterministic``: every op that warned is
   printed; with none the synced gradients and the losses must be the
   plain iteration's bits, else within MESH_FLOOR_FACTOR x the floor two
   plain runs give; the G step's resize backward repeated under the
   defaults through ``F.interpolate`` and through ``bilinear_resize``
   (distinct results each); the plain step twice under PyTorch's
   defaults, with the port's steps (cuDNN deterministic inside them), with
   cuDNN's choice free, and with it free under the deterministic
   algorithms (the tensors that repeat under each); (b) ``python -m torch.distributed.run --standalone
   --nproc_per_node=1`` (torchrun) of the train CLI on 7's split at its
   recipe for one epoch, counted inside the launched process (this
   script's ``--torchrun-train`` mode calls the CLI's ``main``), which
   must join a one-rank NCCL mesh; its ``content.pt`` restored and held
   against the file tensor for tensor; ``--resume`` without torchrun for
   a second epoch, counted; the median iteration beside 7's; (c) the
   test CLI the same way (``--torchrun-test``: its ``main`` under
   torchrun, under ``fixed_cudnn``) on 7's split and checkpoint at its
   recipe, batch 4, flash attention, once in its default W8A8 mode
   (dynamic scales) and once ``--bf16``: the mesh it joined (NCCL, world
   size 1, dp 1), every kernel's launches against the structure (K1,
   K2a, K2b, K3 forward, and K4 in the W8A8 leg), K1, K3 and K4 by
   path, and its predictions and PNG codes bit for bit against
   ``sample_and_test`` in this process at the same seed, also under
   ``fixed_cudnn``; each leg's wall and sample seconds beside 7's.
14. (run after 13, in its work directory) the model branches off the
   recipe at ``brats_recipe(num_channels_dae=64, image_size=256)``'s
   width, seeded non-trivial weights: B1 (one-AdaGN resblocks, the
   output_skip and input_skip pyramids, ``sum``; K1, K2a, K2b, K3, K4)
   and B2 (ddpm resblocks, residual pyramids; K1, K3, K4, and the plain
   FIR convs) each serve three counted batch-4 requests (--attn flash),
   the sample against its plain versions (at the main path's bf16-score
   attention within ``BRANCH_TOL``'s, with flash within
   ``BF16_VOLUME_TOL``), one counted W8A8 dynamic request at bf16-score
   attention (K4's fused path only, its sample within ``BRANCH_TOL``'s,
   and with K4 alone through its kernel the plain versions' bits),
   best-of-2 and one profiled request, one counted bf16 training
   iteration (R1) under ``fixed_cudnn`` and one D (R1) + G iteration
   against the plain versions in bf16 and fp32 as in 6; B3
   (ddpm, ``fir=False``, Fourier, three-channel images, two conditions)
   runs G1 + G2 at t = 1, 2, 3 against the plain versions, and prints
   the t = 0 embedding's non-finite lanes (NaN by the reference's
   construction, not a failure); ``DiscriminatorSmall`` (ngf 64, 32²,
   three channels, batch 64) and ``DiscriminatorImgLarge`` (ngf 64, 256²,
   batch 4) one forward and R1's gradient of a gradient against the
   plain versions; the train CLI for one epoch with B1's flags on 7's
   split and the test CLI (int8) on its checkpoint.  Every run counted
   against the structure; the ``branch_phase_kernels`` line sums each
   kernel over the phase's launches.
15. (run after 14, in its work directory) the phantom quality
   protocol's tools through the port's CLIs, under PyTorch's default
   cuDNN settings: ``python -m mudiff_torch.data.phantom`` on
   PHANTOM_PATIENTS patients of PHANTOM_DEPTH slices at 256² (8 / 2 / 2
   slices), ``run -e flagship64 --train-only`` on
   ``phantom_quality.write_yaml``'s copy of
   ``experiments/phantom_flagship.yaml`` for one epoch (one iteration at
   batch 8, nf=64, bf16, no remat, then its validation and preview),
   ``calibrate_int8`` and ``ab_int8_quality`` in each mode (``bf16``,
   ``int8``, ``int8-static``; ``--lpips_rand``).  Each run counted
   against the structure (K4 on its fused path only); each leg's PNG
   pairs and finite metrics; the ``phase15_kernels`` line sums each
   kernel over the phase's launches, which the per-shape rows of 9 hold
   too.

Exits non-zero, printing no result, when CUDA is unavailable or the
``mudiff_torch`` package is not beside the script.  ``--out`` also
writes the build time, every per-shape row and the nvcc log to a JSON file.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

SEED = 0
DEVICE = "cuda"
BATCH = 4
REQUESTS = 3
NF = 64
IMAGE = 256
# The volume phase: a BraTS-shaped volume, the centre +-12 axial slices
# (25) through the CLI's default batch of 8 (4 batches, the last padded).
VOLUME_SHAPE = (240, 240, 155)
VOLUME_HALF = 12
VOLUME_BATCH = 8
# K3 shapes held and timed beside those the volume phase gives: the
# nf=128 width (C = 512) and a ragged length.
FLASH_EXTRA_SHAPES = ((4, 4096, 512), (2, 1000, 256))
# K2 shapes held and timed beside those the paths give, all on the
# kernels' one-channel path: odd sizes with C = 3 and C = 1, and a view 2
# elements into a larger buffer (C = 64 would take 16-byte vectors, but
# the pointer is off 16-byte alignment).  Each entry is (shape, offset).
FIR_EXTRA_SHAPES = (((2, 7, 5, 3), 0), ((2, 30, 30, 1), 0), ((2, 32, 32, 64), 2))
# The write between the launches of a cold-L2 time: larger than the
# card's 50 MB L2, so no line of the kernel's input is left in it.
FLUSH_BYTES = 256 * 2**20
# The training phase: the recipe's batch, four iterations (R1 on step 0
# of lazy_reg 16).  K3's backward is also held and timed at the nf=128
# width, a ragged length and the two smaller head-dim classes of its
# kernels (64, 128), so that every instance of them launches.
TRAIN_BATCH = 2
TRAIN_ITERS = 4
FLASH_BWD_EXTRA_SHAPES = ((2, 4096, 512), (2, 1000, 256), (2, 1024, 64), (2, 1024, 128))
# The train-loop + slice-test phase: LOOP_PATIENTS synthetic patients of
# LOOP_VOLUME voxels in four modalities, preprocessed to the centre
# +-LOOP_HALF axial slices with a 4 / 2 / 2 patient split (20 train, 10
# val, 10 test slices); the train CLI at batch TRAIN_BATCH for LOOP_EPOCHS
# epochs (10 iterations each, R1 every LOOP_LAZY global steps), then one
# more on --resume; the test CLI at batch LOOP_TEST_BATCH, int8, then bf16.
LOOP_PATIENTS = 8
LOOP_VOLUME = (256, 256, 32)
LOOP_HALF = 2
LOOP_SPLIT = (0.5, 0.25)  # train and val ratios of the patients
LOOP_EPOCHS = 2
LOOP_LAZY = 4
LOOP_TEST_BATCH = 4

# Phase 8: the shipped experiment through the port's own CLIs, at the width
# it ships with: RUN_YAML's RUN_EXPERIMENT (nf=128, ch_mult (1, 2, 4),
# batch 2, remat "hires", lazy_reg 16, bf16) on phase 7's split, its
# data_path, output_root and num_epoch (30 -> RUN_EPOCHS) changed in a
# copy; calibrate_int8 over RUN_CALIB_BATCHES val batches of 4; the volume
# wrapper on one of phase 7's patients, its centre +-WRAPPER_HALF slices.
RUN_YAML = "experiments/brats.yaml"
RUN_EXPERIMENT = "synthesize_T1CE"
RUN_NF = 128  # the experiment's width, held before the run
RUN_EPOCHS = 1
RUN_CALIB_BATCHES = 2
WRAPPER_HALF = 4
# Phase 15: the phantom protocol's tools (phantom_quality.py) on a tiny
# set, PHANTOM_PATIENTS patients of PHANTOM_DEPTH slices at IMAGE (a 4 / 1
# / 1 patient split: 8 / 2 / 2 slices), PHANTOM_EXPERIMENT of
# experiments/phantom_flagship.yaml (nf=64, batch 8, bf16, no remat) for
# PHANTOM_EPOCHS epoch: one iteration.
PHANTOM_EXPERIMENT = "flagship64"
PHANTOM_PATIENTS = 6
PHANTOM_DEPTH = 2
PHANTOM_EPOCHS = 1
PHANTOM_SPLIT = {"train": 8, "val": 2, "test": 2}
# The remat table at the same width and batch: (leg, policy, attention).
# Each leg's gradients (one D (R1) + G iteration at the same weights and
# draws) are held against the no-remat leg of its attention at
# TRAIN_TOL["bf16"]; then REMAT_ITERS wall-timed and REMAT_ITERS profiled
# iterations after a warm-up.
REMAT_LEGS = (("none", None, "einsum"), ("hires", "hires", "einsum"),
              ("hires4", "hires4", "einsum"), ("blocks", "blocks", "einsum"),
              ("none flash", None, "flash"), ("blocks flash", "blocks", "flash"))
REMAT_ITERS = 3
# Phase 13: the mesh step is held within this many times the floor that
# two plain runs of the same iteration give (the bf16 step is not
# deterministic on the card: ROADMAP.md section 3), and the torchrun CLI
# run's time limit
MESH_FLOOR_FACTOR = 2.0
MESH_CLI_TIMEOUT = 480
MESH_TIMED = 4  # timed iterations of phase 13's step, each way
RESIZE_REPEATS = 8  # backward runs of each resize in phase 13's isolation
# the meshes whose collective bytes phase 13 works out (it cannot run them)
MESH_SHAPES = ((2, 1), (4, 1), (8, 1), (1, 2), (1, 4), (2, 2))

# Tolerances, kernel vs plain version on the same inputs.  Both
# accumulate in fp32; in bf16 they round the same fp32 sum once, so a
# sum near a rounding boundary may land one bf16 ulp (2^-8 relative)
# apart.  In fp32 only the summation order differs.
TOL = {"bf16": (1e-2, 1e-2), "fp32": (1e-4, 1e-4)}
FIR_TOL_FP32 = (1e-5, 1e-5)
# A library call is held to the plain version only to show that it
# computes the same function (a wrong formula is off by O(1)).
LIB_TOL = (5e-2, 5e-2)
# Whole 4-step sample (x in about [-1, 1]), kernels vs plain versions:
# in bf16 one-ulp flips (0.0078 at 1.0) propagate through 8 generator
# forwards; in fp32 only summation order differs.
SAMPLE_TOL = {"bf16": 5e-2, "fp32": 1e-3}
# K3 vs its plain version.  bf16: the kernel rounds the unnormalised p =
# exp(s - m) to bf16 before p.v, the plain version the normalised
# weights, so the two differ by about one bf16 ulp (2^-8) of max|v|.
# fp32: only the order of the sums differs.
FLASH_TOL = {"bf16": (2e-2, 2e-2), "fp32": (1e-4, 1e-4)}
# The bf16 volume through the kernels vs the plain bf16 volume, max abs in
# [-1, 1] units.  Not 5e-2 as for one sample: K3 cannot agree with its
# plain version bit for bit (it rounds p where the plain version rounds
# the weights), and the 4-step sampler amplifies each bf16 flip in the
# attention output over 25 slices of 240^2.  volume_drift.py read 0.078,
# 0.054 and 0.071 on seeds 0-2 (K1 and K2 alone: 0.0); the limit is 1.5x
# the largest.  It catches only gross faults: a K3 scale off by 8% read
# 0.085-0.136.  Finer K3 faults are the per-shape and fp32 checks' to
# catch (PERF.md §6).
BF16_VOLUME_TOL = 0.12
# K3's backward vs its plain version, max |diff| <= tol * max |plain| per
# output.  bf16: both round p and ds to bf16 before their products; an
# entry whose fp32 value lies near a rounding boundary lands one bf16 ulp
# (2^-8 relative) apart, and dk, dq sum such entries over 4096 rows.
# fp32: only the order of the sums differs.
FLASH_BWD_TOL = {"bf16": 2e-2, "fp32": 1e-4}
# One D (R1) + G iteration through the kernels vs the same iteration with
# the plain versions forced: (loss, relative; gradient, ||diff|| / ||g||).
# fp32: summation order only.  bf16: K3 rounds p where its plain version
# rounds the weights, one-ulp flips that 2 generators and 3 critic passes
# carry into every gradient.  Tensors whose ||g|| is under 1e-6 of the
# largest of their module are counted, not held: their exact gradient is
# 0 or nearly (the key projection's bias, which softmax ignores; the
# critic's last bias under R1 alone), so their relative error is noise.
# Their norms are read on the fp32 plain run: in bf16 the key bias's
# gradient is rounding noise that can pass 1e-6.  A gradient that bf16
# rounding alone moves a distance d from the fp32 plain run's is held to
# the larger of the tolerance and SPREAD * d: two bf16 runs each d from it
# may lie 2d apart with no fault in either, and the kernels' run lay up to
# 2.3 d from it where the plain run lay d (B1's stem convs, d = 0.02-0.03;
# d reaches 0.08-0.11 on B1's drift seeds, volume_drift.py --branch).
TRAIN_TOL = {"fp32": (1e-4, 1e-3), "bf16": (2e-2, 5e-2)}
TINY_GRAD = 1e-6
SPREAD = 4.0
# The mask loss G_mask = mean(att_g2 * bce_1) + mean(att_g1 * bce_2)
# (``mask_terms``) is 1e-6 on phase 14's B2 weights: the attention logits
# (att_conv of the critic's bf16 features) lie in -36 to -7, where
# sigmoid(l) ~ e^l, so the loss's relative error is a mean of the logits'
# absolute errors weighted to the largest, a fraction of bf16's spacing
# there (0.0625-0.25).  TRAIN_TOL's 2e-2 asked more of it than bf16
# resolves, and at fixed weights it read 1e-4 to 0.028 as cuDNN's choice
# of algorithm moved (PERF.md §6).  So in bf16 the loss is held by
# its two factors, each against what bf16 resolves at these weights (the
# plain bf16 run's distance from the fp32 one, ``mask_ratios``): the
# logits' mean |diff| in bf16 spacings, and each BCE factor's relative
# error.  ``volume_drift.py --iteration`` read the sound kernels at most
# 1.020 (logits) and 1.001 (BCE) over the recipe, B1 and B2 on seeds 0-5
# (NVIDIA H100 80GB HBM3, 700.00 W); each limit is 1.5x that.  K1 with
# tap (0, 0) dropped at the Cout = 1 convs read BCE 21.0-130, 14x over
# its limit or more; its logits read 0.31-26.6: that fault moves the
# posterior samples, and the critic's logits not always past bf16's noise.
MASK_TOL = {"logits": 1.54, "bce": 1.51}

# Published dense peaks of the card (NVIDIA data sheets): bf16 tensor-core
# FLOP/s, fp32 CUDA-core FLOP/s, device-memory bytes/s; and the int8
# tensor-core OP/s.
PEAKS = {
    "H100 SXM": (989e12, 67e12, 3.35e12),
    "H100 PCIe": (756e12, 51e12, 2.0e12),
    "H100 NVL": (835e12, 60e12, 3.9e12),
}
INT8_PEAKS = {"H100 SXM": 1979e12, "H100 PCIe": 1513e12, "H100 NVL": 1671e12}

# The int8 leg: the main path's sampler served W8A8 (K4 on every routed
# conv) with dynamic scales, and with static scales that calibrate_sampler
# records over CALIB_BATCHES seeded synthetic batches.  K4 is also held
# and timed at the nf=128 recipe's widest routed site (the decoder's
# first conv at 64^2: 4nf + 4nf = 1024 -> 512), beside the paths' shapes,
# and at a shape of its general path (Cin % 16 != 0), which no path gives.
CALIB_BATCHES = 2
INT8_EXTRA_SHAPES = (((BATCH, 64, 64, 1024), 512), ((2, 32, 32, 72), 64))
# The int8 sample through the kernels vs the same with every plain version
# forced (same weights, injected noise), max abs in [-1, 1] units.  K4
# gives its plain version's bits (K4 alone through its kernel: 0.0), but
# K1 rounds its bf16 sums in another order than its plain version, and a
# one-ulp change of a routed conv's input moves the values near a code
# boundary to the next of 127 codes: the 4-step sampler carries such flips
# further than bf16 ulps.  volume_drift.py --int8 read 0.0876, 0.0840,
# 0.0816 (dynamic) and 0.0618, 0.0595, 0.0622 (static) on seeds 0-2, all of
# it K1's (K1 alone through its kernel read the same); each limit is 1.5x
# the largest reading.
INT8_SAMPLE_TOL = {"dynamic": 0.131, "static": 0.093}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def sass_count(library, mark: str) -> int:
    """Lines of the library's SASS (cuobjdump -sass, beside nvcc) that hold
    ``mark``."""
    from mudiff_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    return sum(mark in line for line in sass.splitlines())


def peaks_for(name: str):
    variant = ("H100 PCIe" if "PCIe" in name else
               "H100 NVL" if "NVL" in name else "H100 SXM")
    return variant, PEAKS[variant]


def hold_device(seconds: float) -> None:
    """Keep the device busy for about ``seconds`` (one thread spinning on
    the clock) so that the host queues the calls that follow before the
    device reaches them."""
    import torch

    torch.cuda._sleep(int(seconds * 2e9))


def host_ms(fn, reps: int = 20) -> float:
    """Host time to enqueue one call of ``fn`` (no synchronise inside)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def time_ms(fn, target_ms: float = 60.0) -> float:
    """Mean device time of one call, CUDA events around a run of calls.
    The run is queued behind ``hold_device`` for twice the host's time to
    enqueue it, so the events bracket device work only, also where a
    call's kernels take less device time than its wrapper takes host
    time (a run of such calls would otherwise time the host)."""
    import torch

    for _ in range(2):
        fn()
    host_s = host_ms(fn, reps=3) / 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    hold_device(2 * host_s + 1e-3)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    reps = max(3, min(50, math.ceil(target_ms / max(start.elapsed_time(end), 1e-3))))
    hold_device(min(2 * reps * host_s + 1e-3, 0.5))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_cold_ms(fn, flush, write: bool = True, reps: int = 20) -> float:
    """Median device time of one call that finds the L2 cold: CUDA events
    around single calls, each after a pass over ``flush`` (FLUSH_BYTES),
    queued behind ``hold_device``.  ``write``: the pass writes ``flush``,
    which leaves the L2 full of dirty lines that the call's own reads
    must write back; else it reads ``flush``, which leaves clean lines."""
    import torch

    fn()
    host_s = host_ms(fn, reps=3) / 1e3
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    hold_device(min(2 * reps * (host_s + 1e-4) + 1e-3, 0.5))
    for start, end in events:
        if write:
            flush.zero_()
        else:
            flush.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(start.elapsed_time(end) for start, end in events)
    return times[len(times) // 2]


def randomize_(module, generator) -> None:
    """Seeded non-trivial weights: a fresh init puts every resblock's
    Conv_1, NIN_3 and final_conv at ~1e-10 scale, which would make the
    kernel-vs-plain comparison of the whole sample vacuous.  Kernels get
    normals / sqrt(fan_in); vectors their init value (1 for GroupNorm
    scales and the AdaGN gamma half, 0 else) plus 0.1 * normal."""
    import torch

    with torch.no_grad():
        for p in module.parameters():
            noise = torch.randn(p.shape, generator=generator, device=p.device)
            if p.dim() == 4:    # HWIO conv kernel
                p.copy_(noise / math.sqrt(p.shape[0] * p.shape[1] * p.shape[2]))
            elif p.dim() == 2:  # (out, in) dense / 1x1 weight
                p.copy_(noise / math.sqrt(p.shape[1]))
            else:
                p.add_(0.1 * noise)


def conditions(generator, device):
    import torch

    shape = (BATCH, IMAGE, IMAGE, 1)
    return [torch.randn(shape, generator=generator, device=device).tanh()
            for _ in range(3)]


def check_close(what: str, got, want, atol: float, rtol: float) -> float:
    import torch

    err = (got.float() - want.float()).abs()
    limit = atol + rtol * want.float().abs()
    if not bool(torch.isfinite(got).all()) or bool((err > limit).any()):
        raise AssertionError(f"{what}: max abs err {float(err.max()):.3g} "
                             f"beyond atol {atol} + rtol {rtol} * |plain|")
    return float(err.max())


def design_of(dtype, path: str | None = None) -> str:
    """Which kernel a call runs: K1 and K3 (forward, dkv and dq) name their
    path (``k1_path``, ``k3_path``: "wgmma", bf16 / fp16 on Hopper's wgmma
    and TMA; "general", bf16 / fp16 on mma.sync; "fma", fp32 on the CUDA
    cores); a kernel without paths the kernel of its dtype, "tc" or
    "fma"."""
    import torch

    if path is not None:
        return path
    return "fma" if dtype == torch.float32 else "tc"


def k1_expected_paths(log, start: int = 0) -> dict:
    """K1's launches by path that ``k1_path`` predicts for the calls
    ``log`` recorded from ``start`` on (every tensor the port hands K1
    starts on a 16-byte boundary): wide bf16 / fp16 calls on "wgmma", the
    narrow ones (the stems, the heads, their dx) on "general", fp32 on
    "fma"."""
    from mudiff_torch import ops
    from mudiff_torch.ops.conv3x3 import k1_path_for

    want = dict.fromkeys(ops.conv3x3.path_launches, 0)
    for name, key in log[start:]:
        if name == "conv3x3":
            (_, _, _, cin), cout, dtype = key
            want[k1_path_for(cin, cout, dtype)] += 1
    return want


def k1_path_check(tag: str, log, start: int = 0) -> dict:
    """K1's launches by path since the counts were zeroed
    (``ops.conv3x3.path_launches``) against ``k1_expected_paths`` of the
    run's calls, which must all have launched; printed, and raises on a
    difference."""
    from mudiff_torch import ops

    got, want = dict(ops.conv3x3.path_launches), k1_expected_paths(log, start)
    print(json.dumps({"run": tag, "k1_path_launches": got}), flush=True)
    if got != want or sum(got.values()) != ops.conv3x3.launches:
        raise AssertionError(f"{tag}: K1 by path {got} ({ops.conv3x3.launches} launches), "
                             f"its calls' shapes predict {want}")
    return got


K3_WRAPPERS = ("flash_attn", "flash_attn_bwd_dkv", "flash_attn_bwd_dq")


def k3_expected_paths(log, start: int = 0) -> dict:
    """K3's launches by wrapper and path that ``k3_path`` predicts for the
    calls ``log`` recorded from ``start`` on: bf16 / fp16 at C = 256 on
    "wgmma", other head dims on "general", fp32 on "fma"."""
    from mudiff_torch import ops
    from mudiff_torch.ops.flash_attn import k3_path_for

    want = {n: dict.fromkeys(getattr(ops, n).path_launches, 0) for n in K3_WRAPPERS}
    for name, key in log[start:]:
        if name in want:
            _, _, c, dtype = key
            want[name][k3_path_for(c, dtype)] += 1
    return want


def k3_path_check(tag: str, log, start: int = 0) -> dict:
    """K3's launches by wrapper and path since the counts were zeroed
    (``path_launches`` of the forward, dkv and dq) against
    ``k3_expected_paths`` of the run's calls, which must all have
    launched, for each wrapper that launched at all (a run may hold a
    kernel to its plain version, ``kernels_only``); printed when the run
    launched K3, and raises on a difference."""
    from mudiff_torch import ops

    got = {n: dict(getattr(ops, n).path_launches) for n in K3_WRAPPERS}
    want = {n: paths if getattr(ops, n).launches else dict.fromkeys(paths, 0)
            for n, paths in k3_expected_paths(log, start).items()}
    if any(getattr(ops, n).launches for n in K3_WRAPPERS):
        print(json.dumps({"run": tag, "k3_path_launches": got}), flush=True)
    if got != want or any(sum(got[n].values()) != getattr(ops, n).launches
                          for n in K3_WRAPPERS):
        raise AssertionError(f"{tag}: K3 by path {got} "
                             f"({ {n: getattr(ops, n).launches for n in K3_WRAPPERS} }), "
                             f"its calls' shapes predict {want}")
    return got


def with_bound_share(row: dict) -> dict:
    """The row with its share of the bound: bound ms / kernel ms."""
    row["bound_share"] = max(row["flop_ms"], row["byte_ms"]) / row["ms"]
    return row


def conv_rows(shapes, peaks, card):
    """K1 at each shape of any path: checks in bf16, fp16 and fp32, the
    kernel ``k1_path`` picks in the path's dtype (``design``), times,
    bound; at the main path's shapes also the kernel's time in fp16.
    ``shapes`` maps (x shape, Cout, dtype) to its launch counts
    (``shape_counts``)."""
    import torch
    import torch.nn.functional as F

    from mudiff_torch.ops import conv3x3, conv3x3_plain
    from mudiff_torch.ops.conv3x3 import k1_path

    bf16_peak, fp32_peak, hbm = peaks
    g = torch.Generator(DEVICE).manual_seed(SEED + 1)
    rows = []
    for (xshape, cout, dtype), counts in sorted(shapes.items(), key=str):
        b, h, w, cin = xshape
        x = torch.randn(xshape, generator=g, device=DEVICE)
        wt = torch.randn((3, 3, cin, cout), generator=g, device=DEVICE) / math.sqrt(9 * cin)
        bias = 0.1 * torch.randn((cout,), generator=g, device=DEVICE)
        errs = {}
        for tag, dt in (("bf16", torch.bfloat16), ("fp16", torch.float16),
                        ("fp32", torch.float32)):
            xd, wd = x.to(dt), wt.to(dt)
            errs[tag] = check_close(f"conv3x3 {xshape}->{cout} {tag}", conv3x3(xd, wd, bias),
                                    conv3x3_plain(xd, wd, bias),
                                    *TOL["fp32" if tag == "fp32" else "bf16"])
        # timed in the dtype the path gave this shape
        xd, wd = x.to(dtype), wt.to(dtype)
        x_nchw = xd.permute(0, 3, 1, 2)  # a channels_last view, no copy
        w_oihw = wd.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        bias_d = bias.to(dtype)
        lib = F.conv2d(x_nchw, w_oihw, bias_d, padding=1)
        check_close(f"cuDNN conv {xshape}->{cout}", lib.permute(0, 2, 3, 1),
                    conv3x3_plain(xd, wd, bias), *LIB_TOL)
        size = xd.element_size()
        flops = 2.0 * b * h * w * 9 * cin * cout
        nbytes = size * (b * h * w * (cin + cout) + 9 * cin * cout) + 4.0 * cout
        fp16 = {}
        if counts["launches"]:  # the main path's shapes, also in fp16
            x16, w16 = x.to(torch.float16), wt.to(torch.float16)
            fp16["ms_fp16"] = time_ms(lambda: conv3x3(x16, w16, bias))
        rows.append(with_bound_share({
            "kernel": "conv3x3", "x": list(xshape), "cout": cout, "dtype": str(dtype)[6:],
            "design": design_of(dtype, k1_path(xd, wd)), **counts, **fp16,
            "err_bf16": errs["bf16"], "err_fp16": errs["fp16"], "err_fp32": errs["fp32"],
            "ms": time_ms(lambda: conv3x3(xd, wd, bias)),
            "plain_ms": time_ms(lambda: conv3x3_plain(xd, wd, bias)),
            "library_ms": time_ms(lambda: F.conv2d(x_nchw, w_oihw, bias_d, padding=1)),
            "flop_ms": flops / (bf16_peak if size == 2 else fp32_peak) * 1e3,
            "byte_ms": nbytes / hbm * 1e3,
        }))
        print(json.dumps({"card": card, **rows[-1]}), flush=True)
    return rows


def offset_view(x, offset: int):
    """A contiguous copy of ``x`` that starts ``offset`` elements into a
    larger buffer (offset 0: ``x`` itself)."""
    import torch

    if not offset:
        return x
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    buf[offset:].copy_(x.reshape(-1))
    return buf[offset:].view(x.shape)


def fir_rows(shapes, peaks, card):
    """K2a/K2b at each shape of either path and at FIR_EXTRA_SHAPES:
    checks, times, bound.  ``shapes`` maps (name, x shape, dtype, offset)
    to its launch counts.  Each row names the kernel's path ("vector":
    16-byte vectors along C, "scalar": one channel a thread); a path's
    shape must take the vector path when C x itemsize is a multiple of 16
    (the one-channel pyramids take the scalar one), an extra shape the
    scalar one.
    Besides the warm time ``ms``, ``ms_cold`` times single launches
    after a write of FLUSH_BYTES (``ms_cold_clean`` after a read of
    them), and ``bound_share`` is the bound over ``ms_cold``: K2 moves
    each byte once, and a caller's input is not in L2 as a warm run's
    is (K2a's 21 MB main-path shape fits the 50 MB L2 whole)."""
    import torch
    import torch.nn.functional as F

    from mudiff_torch.ops import downsample_2d, fir_down2, fir_up2, setup_fir_kernel, upsample_2d
    from mudiff_torch.ops.fir import vector_path

    _, fp32_peak, hbm = peaks
    k = (1, 3, 3, 1)
    g = torch.Generator(DEVICE).manual_seed(SEED + 2)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=DEVICE)
    rows = []
    for (name, xshape, dtype, offset), counts in sorted(shapes.items(), key=str):
        b, h, w, c = xshape
        x = torch.randn(xshape, generator=g, device=DEVICE)
        down = name == "fir_down2"
        kern, plain = (fir_down2, downsample_2d) if down else (fir_up2, upsample_2d)
        extra = not any(counts.values())
        errs = {}
        for tag, dt, tol in (("bf16", torch.bfloat16, TOL["bf16"]),
                             ("fp32", torch.float32, FIR_TOL_FP32)):
            xd = offset_view(x.to(dt), offset)
            if vector_path(xd) != (not extra and c * xd.element_size() % 16 == 0):
                raise AssertionError(f"{name} {xshape} {tag} offset {offset}: "
                                     f"vector path {vector_path(xd)}")
            errs[tag] = check_close(f"{name} {xshape} {tag} offset {offset}", kern(xd, k),
                                    plain(xd, k, 2), *tol)
        # timed in the dtype the path gave this shape
        xd = offset_view(x.to(dtype), offset)
        x_nchw = xd.permute(0, 3, 1, 2)
        taps = torch.tensor(setup_fir_kernel(k), device=DEVICE)
        if down:  # [1,3,3,1] is symmetric, so correlation == convolution
            wdw = taps.expand(c, 1, 4, 4).to(dtype).contiguous()
            library = lambda: F.conv2d(x_nchw, wdw, stride=2, padding=1, groups=c)
        else:
            wdw = (4.0 * taps).expand(c, 1, 4, 4).to(dtype).contiguous()
            library = lambda: F.conv_transpose2d(x_nchw, wdw, stride=2, padding=1, groups=c)
        check_close(f"library {name} {xshape}", library().permute(0, 2, 3, 1),
                    plain(xd, k, 2), *LIB_TOL)
        out_elems = b * c * (((h - 2) // 2 + 1) * ((w - 2) // 2 + 1) if down else 4 * h * w)
        taps_per_out = 16 if down else 4
        nbytes = xd.element_size() * (b * h * w * c + out_elems)
        row = {
            "kernel": name, "x": list(xshape), "dtype": str(dtype)[6:], "offset": offset,
            "path": "vector" if vector_path(xd) else "scalar",
            **counts, "err_bf16": errs["bf16"], "err_fp32": errs["fp32"],
            "ms": time_ms(lambda: kern(xd, k)),
            "ms_cold": time_cold_ms(lambda: kern(xd, k), flush),
            "ms_cold_clean": time_cold_ms(lambda: kern(xd, k), flush, write=False),
            "host_ms": host_ms(lambda: kern(xd, k)),
            "plain_ms": time_ms(lambda: plain(xd, k, 2)),
            "library_ms": time_ms(library),
            "flop_ms": 2.0 * out_elems * taps_per_out / fp32_peak * 1e3,
            "byte_ms": nbytes / hbm * 1e3,
        }
        row["bound_share"] = max(row["flop_ms"], row["byte_ms"]) / row["ms_cold"]
        rows.append(row)
        print(json.dumps({"card": card, **rows[-1]}), flush=True)
    return rows


def sdpa_call(q, k, v, scale):
    """The library's attention on (B, 1, L, C) views: the first of the
    flash, memory-efficient, cuDNN and math backends that takes the call.
    Returns (backend name, a function that calls it)."""
    import warnings

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q4, k4, v4 = (t[:, None] for t in (q, k, v))
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        def call(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(q4, k4, v4, scale=scale)[:, 0]
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                call()
        except RuntimeError:
            continue
        return backend.name, call
    raise AssertionError("no scaled_dot_product_attention backend takes the call")


def flash_rows(shapes, peaks, card):
    """K3 at each shape: checks, times, bound.  ``shapes`` maps
    (B, L, C, dtype) to its launch counts.  Each row names the kernel that
    ``k3_path`` picks (``design``) and holds it against the plain version
    in bf16, fp16 and fp32; where that is the wgmma path, the two block
    sizes (64 and 128 queries) must give the same bits in bf16 and fp16,
    and the general path's mma.sync kernel (through its entry point) is held and timed
    too (``general_ms``), beside SDPA."""
    import torch

    from mudiff_torch.ops import flash_attn, flash_attn_plain
    from mudiff_torch.ops.flash_attn import flash_attn_path, k3_path

    bf16_peak, fp32_peak, hbm = peaks
    g = torch.Generator(DEVICE).manual_seed(SEED + 3)
    rows = []
    for (b, length, c, dtype), counts in sorted(shapes.items(), key=str):
        scale = float(c) ** -0.5
        # q at twice the scale of k: scores ~ N(0, 4), a peaked softmax
        q = 2.0 * torch.randn((b, length, c), generator=g, device=DEVICE)
        k, v = (torch.randn((b, length, c), generator=g, device=DEVICE) for _ in range(2))
        errs, general = {}, {}
        for tag, dt in (("bf16", torch.bfloat16), ("fp16", torch.float16),
                        ("fp32", torch.float32)):
            qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
            want = flash_attn_plain(qd, kd, vd, scale)
            tol = FLASH_TOL["fp32" if tag == "fp32" else "bf16"]
            what = f"flash_attn {(b, length, c)} {tag}"
            got = flash_attn(qd, kd, vd, scale)
            errs[tag] = check_close(f"{what} ({k3_path(qd)})", got, want, *tol)
            if k3_path(qd) == "wgmma":
                blocks = [flash_attn_path(qd, kd, vd, scale, "wgmma", bq) for bq in (64, 128)]
                if not (torch.equal(blocks[0], blocks[1]) and torch.equal(got, blocks[0])):
                    raise AssertionError(f"{what}: 64- and 128-query blocks differ")
                general[tag] = check_close(f"{what} (general)",
                                           flash_attn_path(qd, kd, vd, scale, "general"),
                                           want, *tol)
        # timed in the dtype the run gave this shape
        qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
        backend, library = sdpa_call(qd, kd, vd, scale)
        check_close(f"SDPA ({backend}) {(b, length, c)}", library(),
                    flash_attn_plain(qd, kd, vd, scale), *LIB_TOL)
        size = qd.element_size()
        path = k3_path(qd)
        extra = {}
        if path == "wgmma":
            extra = {"blocks_same_bits": True, "general_err_bf16": general["bf16"],
                     "general_err_fp16": general["fp16"],
                     "general_ms": time_ms(lambda: flash_attn_path(qd, kd, vd, scale,
                                                                   "general")),
                     "ms_block64": time_ms(lambda: flash_attn_path(qd, kd, vd, scale, "wgmma",
                                                                   64)),
                     "ms_block128": time_ms(lambda: flash_attn_path(qd, kd, vd, scale, "wgmma",
                                                                    128))}
        rows.append(with_bound_share({
            "kernel": "flash_attn", "shape": [b, length, c], "dtype": str(dtype)[6:],
            "design": design_of(dtype, path), **counts,
            "err_bf16": errs["bf16"], "err_fp16": errs["fp16"], "err_fp32": errs["fp32"],
            "ms": time_ms(lambda: flash_attn(qd, kd, vd, scale)), **extra,
            "plain_ms": time_ms(lambda: flash_attn_plain(qd, kd, vd, scale)),
            "library_ms": time_ms(library), "library": f"scaled_dot_product_attention ({backend})",
            "flop_ms": 4.0 * b * length * length * c
                       / (bf16_peak if size == 2 else fp32_peak) * 1e3,
            "byte_ms": 4.0 * b * length * c * size / hbm * 1e3,
        }))
        print(json.dumps({"card": card, **rows[-1]}), flush=True)
    return rows


def sdpa_bwd_call(q, k, v, do, scale):
    """The library's attention backward on (B, 1, L, C) views: the first
    backend whose forward and backward take the call.  Returns (backend
    name, a function that runs the backward only)."""
    import warnings

    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q4, k4, v4 = (t[:, None].detach().requires_grad_(True) for t in (q, k, v))
    do4 = do[:, None]
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with warnings.catch_warnings(), sdpa_kernel(backend):
                warnings.simplefilter("ignore")
                out = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
                torch.autograd.grad(out, (q4, k4, v4), do4, retain_graph=True)
        except RuntimeError:
            continue

        def call(out=out):
            dq, dk, dv = torch.autograd.grad(out, (q4, k4, v4), do4, retain_graph=True)
            return dq[:, 0], dk[:, 0], dv[:, 0]
        return backend.name, call
    raise AssertionError("no scaled_dot_product_attention backend takes the backward")


def check_rel(what: str, got, want, tol: float) -> float:
    """max |got - want| <= tol * max |want|; returns max |got - want|."""
    import torch

    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    if not bool(torch.isfinite(got).all()) or err > tol * scale:
        raise AssertionError(f"{what}: max abs err {err:.3g} > {tol} x max |plain| {scale:.3g}")
    return err


def flash_bwd_rows(shapes, peaks, card):
    """K3's backward kernels at each shape: checks, times, bounds.
    ``shapes`` maps (B, L, C, dtype) to each kernel's launch counts
    (``{"flash_attn_bwd_dkv": {path: n}, "flash_attn_bwd_dq": ...}``).
    dkv must do 4 of the 5 products (s, dp, dv, dk), dq 3 (s, dp, dq);
    the pair does 10 B L^2 C flops once s and dp are shared.  Each dtype
    (bf16, fp16, fp32) runs both kernels that ``k3_path`` picks twice: the
    second run must give the first's bits (one owner per output element,
    no atomics).  Where that is the wgmma path, the general path's mma.sync kernels
    (through their entry points) are held, run twice and timed too
    (``general_ms``)."""
    import torch

    from mudiff_torch.ops import (attn_di, flash_attn_bwd_dkv, flash_attn_bwd_dq,
                                  flash_attn_plain, plain_kernels, row_stats_plain)
    from mudiff_torch.ops.flash_attn import flash_attn_bwd_path, k3_path

    bf16_peak, fp32_peak, hbm = peaks
    g = torch.Generator(DEVICE).manual_seed(SEED + 4)
    names = ("flash_attn_bwd_dkv", "flash_attn_bwd_dq")
    rows = []
    for (b, length, c, dtype), counts in sorted(shapes.items(), key=str):
        scale = float(c) ** -0.5
        q = 2.0 * torch.randn((b, length, c), generator=g, device=DEVICE)
        k, v, do = (torch.randn((b, length, c), generator=g, device=DEVICE) for _ in range(3))
        errs, general = {}, {}
        for tag, dt in (("bf16", torch.bfloat16), ("fp16", torch.float16),
                        ("fp32", torch.float32)):
            qd, kd, vd, dod = (t.to(dt) for t in (q, k, v, do))
            stats = row_stats_plain(qd, kd, scale)
            di = attn_di(flash_attn_plain(qd, kd, vd, scale), dod)
            with plain_kernels():
                pk, pv = flash_attn_bwd_dkv(qd, kd, vd, dod, stats, di, scale)
                pq = flash_attn_bwd_dq(qd, kd, vd, dod, stats, di, scale)
            tol = FLASH_BWD_TOL["fp32" if tag == "fp32" else "bf16"]
            paths = [k3_path(qd)] + (["general"] if k3_path(qd) == "wgmma" else [])
            for path in paths:
                what = f"{(b, length, c)} {tag} ({path})"
                runs = [(*flash_attn_bwd_path(names[0], qd, kd, vd, dod, stats, di, scale, path),
                         flash_attn_bwd_path(names[1], qd, kd, vd, dod, stats, di, scale, path))
                        for _ in range(2)]
                for name, first, second in zip(("dk", "dv", "dq"), *runs):
                    if not torch.equal(first, second):
                        raise AssertionError(f"{name} {what}: two runs on the same inputs "
                                             "differ")
                dk, dv, dq = runs[0]
                err = {"dkv": max(check_rel(f"dk {what}", dk, pk, tol),
                                  check_rel(f"dv {what}", dv, pv, tol)),
                       "dq": check_rel(f"dq {what}", dq, pq, tol)}
                (errs if path == paths[0] else general)[tag] = err
        # timed in the dtype the run gave this shape
        qd, kd, vd, dod = (t.to(dtype) for t in (q, k, v, do))
        stats = row_stats_plain(qd, kd, scale)
        di = attn_di(flash_attn_plain(qd, kd, vd, scale), dod)
        backend, library = sdpa_bwd_call(qd, kd, vd, dod, scale)
        lq, lk, lv = library()
        with plain_kernels():
            pk, pv = flash_attn_bwd_dkv(qd, kd, vd, dod, stats, di, scale)
            pq = flash_attn_bwd_dq(qd, kd, vd, dod, stats, di, scale)
        for what, got, want in (("dq", lq, pq), ("dk", lk, pk), ("dv", lv, pv)):
            check_rel(f"SDPA backward ({backend}) {what} {(b, length, c)}", got, want, 5e-2)
        library_ms = time_ms(library)
        size = qd.element_size()
        peak = bf16_peak if size == 2 else fp32_peak
        flop = 2.0 * b * length * length * c
        elems = b * length * c
        path = k3_path(qd)
        for name, products, outputs, fn in (
                ("flash_attn_bwd_dkv", 4, 2, flash_attn_bwd_dkv),
                ("flash_attn_bwd_dq", 3, 1, flash_attn_bwd_dq)):
            def plain_fn(fn=fn):
                with plain_kernels():
                    return fn(qd, kd, vd, dod, stats, di, scale)
            extra = {}
            if path == "wgmma":
                extra = {"general_err_bf16": general["bf16"][name[15:]],
                         "general_err_fp16": general["fp16"][name[15:]],
                         "general_ms": time_ms(lambda name=name: flash_attn_bwd_path(
                             name, qd, kd, vd, dod, stats, di, scale, "general"))}
            rows.append(with_bound_share({
                "kernel": name, "shape": [b, length, c], "dtype": str(dtype)[6:],
                "design": design_of(dtype, path), "bit_identical_reruns": True,
                **counts[name], "err_bf16": errs["bf16"][name[15:]],
                "err_fp16": errs["fp16"][name[15:]], "err_fp32": errs["fp32"][name[15:]],
                "ms": time_ms(lambda fn=fn: fn(qd, kd, vd, dod, stats, di, scale)), **extra,
                "plain_ms": time_ms(plain_fn),
                "library_ms": library_ms,
                "library": f"scaled_dot_product_attention backward ({backend}), dq dk dv",
                "flop_ms": products * flop / peak * 1e3,
                "byte_ms": (size * elems * (4 + outputs) + 4.0 * 3 * b * length) / hbm * 1e3,
            }))
            print(json.dumps({"card": card, **rows[-1]}), flush=True)
    return rows


def im2col_int8(q):
    """The (B*H*W, 9*Cin) int8 im2col of SAME 3x3 codes, K tap-major."""
    import torch
    import torch.nn.functional as F

    b, h, w, c = q.shape
    padded = F.pad(q.view(torch.uint8), (0, 0, 1, 1, 1, 1)).view(torch.int8)
    taps = [padded[:, dy:dy + h, dx:dx + w, :] for dy in range(3) for dx in range(3)]
    return torch.cat(taps, dim=-1).reshape(b * h * w, 9 * c)


K4_PARTS = (("s8wgmma", "conv"), ("absmax_kernel", "absmax"), ("quantize_kernel", "quantize"),
            ("s8conv", "gemm"), ("memset", "memset"))


def k4_part(kernel_name: str):
    """K4's name for a device kernel (``K4_PARTS``), else None."""
    name = kernel_name.lower()
    return next((label for mark, label in K4_PARTS if mark in name), None)


def int8_rows(shapes, peaks, int8_peak, card):
    """K4 at each shape an int8 path gave it and at INT8_EXTRA_SHAPES.
    ``shapes`` maps the wrapper's key (x shape, Cout, x dtype, compute
    dtype, mode) to its launch counts.  At every shape, in both modes and
    in bf16 and fp32 compute, bit for bit against its plain version: the
    kernel the wrapper takes (``k4_path``) through the wrapper's output;
    the fused kernel's s32 accumulator computed from x (its int32 output)
    and, in dynamic mode, its per-example absmax; and the general path's
    codes, absmax and s32 accumulator.  Timed in the path's dtypes and
    mode: K4 (the wrapper), the general path whole and its quantize and
    GEMM calls apart (the profiled int8 requests split K4's own kernels,
    absmax and conv), the plain
    version, the library's ``torch._int_mm`` on the codes' explicit im2col
    (built outside the timing; the quantize and the epilogue not included)
    and K1 in bf16 at the same shape.  The bound is the larger of the int8
    operations over the int8 peak and the bytes (x in its dtype, the int8
    weight and its scales, the output) over the HBM rate."""
    import torch

    from mudiff_torch.ops import conv3x3, int8_conv3x3, plain_kernels
    from mudiff_torch.ops import int8_conv as k4

    bf16_peak, _, hbm = peaks
    g = torch.Generator(DEVICE).manual_seed(SEED + 6)
    rows = []
    for (xshape, cout, xdtype, cdtype, mode), counts in sorted(shapes.items(), key=str):
        b, h, w, cin = xshape
        # per-channel ranges over two decades, as GroupNorm'd activations
        spread = torch.logspace(-1, 1, cin, device=DEVICE)
        x = (torch.randn(xshape, generator=g, device=DEVICE) * spread).to(xdtype)
        wt = torch.randn((3, 3, cin, cout), generator=g, device=DEVICE) / math.sqrt(9 * cin)
        bias = 0.1 * torch.randn((cout,), generator=g, device=DEVICE)
        absmax_c = tuple((x.float().abs().amax(dim=(0, 1, 2)) * 0.8).tolist())
        qws = {m: k4.quantize_conv_weight(wt, absmax_c if m == "static" else None)
               for m in ("dynamic", "static")}
        what = f"int8_conv3x3 {xshape}->{cout} {str(xdtype)[6:]}"
        path = k4.k4_path(x, qws[mode])
        for m, qw in qws.items():
            if m == "dynamic":
                q_plain, _ = k4.quantize_activation(x)
                absmax_plain = x.float().abs().amax(dim=(1, 2, 3))
            else:
                q_plain = k4.quantize_activation_static(x, qw.inv_a)
            acc_plain = k4.conv_acc_plain(q_plain, qw.wq)
            if path == "wgmma":  # the fused kernel, from x
                acc, absmax = k4.int8_fused_cuda(x, qw, bias, torch.int32)
                if m == "dynamic" and not torch.equal(absmax, absmax_plain):
                    raise AssertionError(f"{what}: fused per-example absmax differs")
                if not torch.equal(acc.double(), acc_plain):
                    raise AssertionError(f"{what} {m}: fused s32 accumulator differs")
            q, absmax = k4.int8_quantize_cuda(x, qw.inv_a)  # the general path
            if m == "dynamic" and not torch.equal(absmax, absmax_plain):
                raise AssertionError(f"{what}: per-example absmax differs")
            if not torch.equal(q, q_plain):
                raise AssertionError(f"{what} {m}: codes differ from the plain version's")
            acc = k4.int8_conv_cuda(q, qw, absmax, bias, torch.int32)
            if not torch.equal(acc.double(), acc_plain):
                raise AssertionError(f"{what} {m}: s32 accumulator differs")
            for dt in (torch.bfloat16, torch.float32):
                got = int8_conv3x3(x, None, bias, compute_dtype=dt, qweight=qw)
                with plain_kernels():
                    want = int8_conv3x3(x, None, bias, compute_dtype=dt, qweight=qw)
                if not torch.equal(got, want):
                    err = float((got.float() - want.float()).abs().max())
                    raise AssertionError(f"{what} {m} -> {dt}: output differs by {err:.3g}")
        # timed in the path's dtypes and mode
        qw = qws[mode]

        def k4_call():
            return int8_conv3x3(x, None, bias, compute_dtype=cdtype, qweight=qw)

        def plain_call():
            with plain_kernels():
                return k4_call()

        def general_call():
            q, absmax = k4.int8_quantize_cuda(x, qw.inv_a)
            return k4.int8_conv_cuda(q, qw, absmax, bias, cdtype)

        q, absmax = k4.int8_quantize_cuda(x, qw.inv_a)
        cols, wmat = im2col_int8(q), qw.wq_nk.t()
        lib = torch._int_mm(cols, wmat)
        if not torch.equal(lib.view(b, h, w, cout),
                           k4.int8_conv_cuda(q, qw, absmax, None, torch.int32)):
            raise AssertionError(f"{what}: torch._int_mm on the im2col differs")
        xb, wb = x.to(torch.bfloat16), wt.to(torch.bfloat16)
        ops = 2.0 * b * h * w * cout * 9 * cin
        nbytes = (x.element_size() * b * h * w * cin + 9 * cin * cout + 8.0 * cout
                  + (4.0 * cin if mode == "static" else 0.0)
                  + torch.empty((), dtype=cdtype).element_size() * b * h * w * cout)
        rows.append(with_bound_share({
            "kernel": "int8_conv3x3", "x": list(xshape), "cout": cout,
            "x_dtype": str(xdtype)[6:], "dtype": str(cdtype)[6:], "mode": mode, "path": path,
            "design": "tc", **counts, "bit_exact": True, "err_bf16": 0.0, "err_fp32": 0.0,
            "ms": time_ms(k4_call),
            "general_ms": time_ms(general_call),
            "general_quantize_ms": time_ms(lambda: k4.int8_quantize_cuda(x, qw.inv_a)),
            "general_gemm_ms": time_ms(lambda: k4.int8_conv_cuda(q, qw, absmax, bias, cdtype)),
            "plain_ms": time_ms(plain_call),
            "library_ms": time_ms(lambda: torch._int_mm(cols, wmat)),
            "library": "torch._int_mm on the explicit int8 im2col (codes to s32 only)",
            "k1_bf16_ms": time_ms(lambda: conv3x3(xb, wb, bias)),
            "k1_bf16_bound_ms": 2.0 * b * h * w * cout * 9 * cin / bf16_peak * 1e3,
            "flop_ms": ops / int8_peak * 1e3, "byte_ms": nbytes / hbm * 1e3,
        }))
        del cols, lib
        print(json.dumps({"card": card, **rows[-1]}), flush=True)
    return rows


# K5 (GroupNorm / AdaGN and its SiLU) against its plain version under
# plain_kernels(), at every shape any path gave it and at the benchmark's
# shapes (K5_PATHS: the recipe at nf and batch, one forward of G1 and G2
# recorded).  Only the statistics' order of sums differs: given K5's own
# mean and rstd the plain chain gives K5's bits at every element, and the
# two paths' means agree within K5_STATS_TOL standard deviations, their
# rstds within K5_STATS_TOL of each other.  Against the plain chain's own
# statistics at least K5_EQUAL of the elements are equal; a 16-bit output
# is at most K5_ULPS ulps off at the scale of the chain's last rounded sum
# (the larger of n w and b, of gamma h and beta, or |n|), beyond what the
# statistics' difference moves it (``k5_ulps_at_scale``): a one-ulp change
# of h that a sum cancels is many ulps of the small result.  The bound: h
# flips one of its ulps (2 at gamma h's scale), gamma h and the sum each
# round once more (1 + 1), SiLU's slope (1.1) and its rounding (1): 5.4;
# an H100 read at most 4.0 over 130 shapes.  An fp32 output
# lies within K5_FP32_TOL of its largest magnitude.  Two runs give the same bits.  ``byte_ms`` counts each input
# and output byte once (the roofline); ``two_pass_ms`` reads the input
# twice, as K5's two passes must (6 bytes an element in bf16).
K5_PATHS = ((128, 8), (64, 32))
K5_EQUAL = 0.999
K5_ULPS = 6
K5_STATS_TOL = 1e-5
K5_FP32_TOL = 1e-5


def ulp_distance(a, b):
    """|a - b| elementwise in units in the last place of their (16- or
    32-bit float) dtype; +0 and -0 are 0 apart."""
    import torch

    bits = 8 * a.element_size()
    view = {16: torch.int16, 32: torch.int32}[bits]

    def ordered(t):
        i = t.contiguous().view(view).to(torch.int64)
        return torch.where(i < 0, -(i & (2 ** (bits - 1) - 1)), i)

    return (ordered(a) - ordered(b)).abs()


def k5_path_keys(nf: int, batch: int) -> list:
    """``group_norm_act``'s record keys of one G1 and one G2 forward of the
    bf16 sampler at brats_recipe(nf) and IMAGE², at ``batch``."""
    import torch

    from mudiff_torch import brats_recipe, build_sampler, ops

    cfg = brats_recipe(num_channels_dae=nf, image_size=IMAGE)
    s = build_sampler(cfg, device=DEVICE, generator=torch.Generator().manual_seed(SEED))
    g = torch.Generator(DEVICE).manual_seed(SEED + 40)
    x = torch.randn((1, IMAGE, IMAGE, 1), generator=g, device=DEVICE)
    t, z = torch.ones((1,), dtype=torch.int64, device=DEVICE), torch.randn((1, cfg.nz), device=DEVICE)
    log = []
    with torch.inference_mode(), ops.record_calls(log):
        s.g1(x, x, x, x, t, z)
        s.g2(x, x, x, x, t, z, pseudo_target=x)
    return sorted({((batch, *key[0][1:]), *key[1:]) for name, key in log
                   if name == "group_norm_act"}, key=str)


def k5_inputs(key, g):
    """x (a channel slice where the key's pixel stride is wider), weight,
    bias and style of a ``group_norm_act`` record key."""
    import torch

    (b, h, w, c), stride, groups, dtype, out_dtype, kind, silu = key
    stride = stride or c
    x = (torch.randn((b, h, w, stride), generator=g, device=DEVICE) * 1.7 + 0.5).to(dtype)
    x = x[..., stride - c:]
    weight = bias = style = None
    if kind == "affine":
        weight = 1 + 0.2 * torch.randn((c,), generator=g, device=DEVICE)
        bias = 0.2 * torch.randn((c,), generator=g, device=DEVICE)
    elif kind == "style":
        style = torch.cat([1 + 0.2 * torch.randn((b, c), generator=g, device=DEVICE),
                           0.2 * torch.randn((b, c), generator=g, device=DEVICE)], dim=-1)
        style = style.to(out_dtype)
    return x, groups, out_dtype, weight, bias, style, silu


def k5_ulps_at_scale(out, ref, x, groups, weight, bias, style, plain_stats, k5_stats) -> float:
    """max |out - ref| in ulps of their 16-bit dtype at the magnitude of
    the chain's last rounded sum (or of ``ref``, if larger): |n| plain,
    max(|n w|, |b|) affine, max(|gamma n|, |beta|) AdaGN, n the input
    normalised by the plain chain's (mean, rstd), each (B, G); less what
    the two paths' statistics move an element to first order (times 1.1,
    SiLU's largest slope): |w or gamma| (|d mean| rstd + |n| |d rstd| /
    rstd), which near n = 0 is many ulps of a small value."""
    import torch

    b, h, w, c = x.shape

    def per_channel(t):  # (B, G) -> (B, 1, 1, C)
        return t.repeat_interleave(c // groups, dim=1)[:, None, None, :]

    mean, rstd = (per_channel(t) for t in plain_stats)
    d_mean, d_rstd = (per_channel((k - p).abs()) for k, p in zip(k5_stats, plain_stats))
    n = (x.float() - mean) * rstd
    if style is not None:
        gamma, beta = (t[:, None, None, :] for t in style.float().chunk(2, dim=-1))
        scale, mag = gamma.abs(), torch.maximum((gamma * n).abs(), beta.abs())
    elif weight is not None:
        scale, mag = weight.abs(), torch.maximum((n * weight).abs(), bias.abs())
    else:
        scale, mag = torch.ones_like(n), n.abs()
    moved = 1.1 * scale * (d_mean * rstd + n.abs() * d_rstd / rstd)
    mag = torch.maximum(mag, ref.float().abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(torch.finfo(out.dtype).tiny))))
    ulp = ulp * torch.finfo(out.dtype).eps  # eps: 2^-(mantissa bits)
    excess = ((out.float() - ref.float()).abs() - moved).clamp_min(0.0)
    return float((excess / ulp).max())


def k5_rows(shapes, peaks, card):
    """K5 at each shape: checks as K5_ULPS says, device times of K5, the
    plain chain and NCHW ``F.group_norm`` (no modulation or SiLU; the port
    never calls it), bound.  ``shapes`` maps record keys to launch
    counts."""
    import torch
    import torch.nn.functional as F

    from mudiff_torch import ops
    from mudiff_torch.ops import group_norm as k5

    _, fp32_peak, hbm = peaks
    g = torch.Generator(DEVICE).manual_seed(SEED + 3)
    rows = []
    for key, counts in sorted(shapes.items(), key=str):
        args = k5_inputs(key, g)
        x, groups, out_dtype, weight, bias, style, silu = args
        b, h, w, c = x.shape
        run = lambda: ops.group_norm_act(*args)

        def plain():
            with ops.plain_kernels():
                return run()

        out, again, ref = run(), run(), plain()
        same_bits = bool((ulp_distance(out, again) == 0).all())
        _, mean, rstd = k5._launch(x, groups, out_dtype, weight, bias, style, silu, k5.EPS)
        given = k5.group_norm_act_plain(*args, stats=(mean, rstd))
        exact = bool((ulp_distance(out, given) == 0).all())
        pm, pr = k5.group_stats_plain(x, groups)
        mean_diff = float(((mean - pm) * pr).abs().max())
        rstd_diff = float(((rstd - pr) / pr).abs().max())
        ulps = ulp_distance(out, ref)
        err = float((out.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        equal = float((ulps == 0).float().mean())
        at_scale = k5_ulps_at_scale(out, ref, x, groups, weight, bias, style, (pm, pr),
                                    (mean, rstd))
        if not (same_bits and exact and bool(torch.isfinite(out).all())
                and max(mean_diff, rstd_diff) <= K5_STATS_TOL and equal >= K5_EQUAL):
            raise AssertionError(f"K5 {key}: same bits {same_bits}, plain chain on K5's "
                                 f"statistics exact {exact}, statistics {mean_diff:.3g} / "
                                 f"{rstd_diff:.3g}, {equal:.6f} equal")
        if out.element_size() == 2 and at_scale > K5_ULPS:
            raise AssertionError(f"K5 {key}: {at_scale:.3g} ulps at the sum's scale")
        if out.element_size() == 4 and err > K5_FP32_TOL * scale:
            raise AssertionError(f"K5 {key}: max abs err {err:.3g} of {scale:.3g}")
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        wl, bl = (None if t is None else t.to(x.dtype) for t in (weight, bias))
        n = x.numel()
        in_size, out_size = x.element_size(), out.element_size()
        extra = 8 * c if weight is not None else (2 * b * c * out_size if style is not None else 0)
        row = {
            "kernel": "group_norm_act", "x": [b, h, w, c], "stride": key[1], "groups": groups,
            "dtype": str(x.dtype)[6:], "out_dtype": str(out_dtype)[6:], "kind": key[5],
            "silu": silu, "path": "vector" if k5.vector_path(x, key[1] or c) else "scalar",
            **counts, "err_bf16": err, "max_ulps": int(ulps.max()), "equal_share": equal,
            "ulps_at_sum_scale": at_scale, "mean_diff_std": mean_diff, "rstd_rel_diff": rstd_diff,
            "ms": time_ms(run), "plain_ms": time_ms(plain),
            "library_ms": time_ms(lambda: F.group_norm(x_nchw, groups, wl, bl, k5.EPS)),
            "flop_ms": 12.0 * n / fp32_peak * 1e3,
            "byte_ms": ((in_size + out_size) * n + extra) / hbm * 1e3,
            "two_pass_ms": ((2 * in_size + out_size) * n + extra) / hbm * 1e3,
        }
        rows.append(with_bound_share(row))
        print(json.dumps({"card": card, **rows[-1]}), flush=True)
        del out, again, ref, given, ulps, x_nchw
    return rows


def int8_samplers(cfg, sampler, seed: int):
    """The int8 leg's samplers: ``sampler``'s G1 and G2 weights served
    W8A8 with dynamic scales, and with the static scales that
    ``calibrate_sampler`` records over CALIB_BATCHES batches of conditions
    made from ``seed``.  Returns (dynamic, static, (calib G1, calib G2))."""
    import torch

    from mudiff_torch import build_sampler
    from mudiff_torch.infer.calibrate import calibrate_sampler

    cfg8 = cfg.replace(use_int8=True)

    def with_weights(s):
        s.g1.load_state_dict(sampler.g1.state_dict())
        s.g2.load_state_dict(sampler.g2.state_dict())
        return s

    dynamic = with_weights(build_sampler(cfg8, device=DEVICE))
    g = torch.Generator(DEVICE).manual_seed(seed + 60)
    batches = [conditions(g, DEVICE) for _ in range(CALIB_BATCHES)]
    calibs = calibrate_sampler(dynamic.g1, dynamic.g2, dynamic.post, batches,
                               cfg.num_timesteps, cfg.nz, generator=g)
    static = with_weights(build_sampler(cfg8, device=DEVICE, int8_calibs=calibs))
    return dynamic, static, calibs


def sample_vs_plain(tag: str, s, conds, x_init, noise, tol: float):
    """One sample of ``s`` through the kernels against the same with the
    plain versions forced (same weights, injected noise), each side's
    launch counts checked.  Returns (sample, max abs diff, launch
    counts); raises beyond ``tol``."""
    from mudiff_torch import ops

    ops.reset_launch_counts()
    got = s(*conds, x_init=x_init, noise=noise)
    with_kernels = ops.launch_counts()
    ops.reset_launch_counts()
    with ops.plain_kernels():
        want = s(*conds, x_init=x_init, noise=noise)
    plain = ops.launch_counts()
    if with_kernels != s.kernel_launches_per_sample() or any(plain.values()):
        raise AssertionError(f"{tag} sample: launches {with_kernels} with kernels, "
                             f"{plain} with plain versions forced")
    diff = float((got - want).abs().max())
    if not diff <= tol:
        raise AssertionError(f"{tag} sample, kernels vs plain: max abs diff {diff:.3g} > {tol}")
    return got, diff, {"launches_kernels": with_kernels, "launches_plain": plain,
                       "max_abs_sample": float(want.abs().max())}


def int8_phase(cfg, sampler, requests, x_init, noise, card) -> dict:
    """The int8 leg's sampler phase: the main path's requests served W8A8,
    with dynamic scales and then with calibrated static ones, in one run
    counted against the module structure (K1 and K4 apart); best-of-3
    slices/s of each mode and one profiled request of each; each mode's
    sample (injected noise) against its plain versions
    (``INT8_SAMPLE_TOL``) and against ``sampler``'s bf16 sample.  The
    int8 samplers are dropped on return: only their calibrations are
    kept."""
    import torch

    from mudiff_torch import ops

    t0 = time.perf_counter()
    dynamic, static, calibs = int8_samplers(cfg, sampler, SEED)
    calib_s = time.perf_counter() - t0
    modes = {"dynamic": dynamic, "static": static}
    ngen = torch.Generator(DEVICE).manual_seed(SEED + 21)
    expected = {k: REQUESTS * (dynamic.kernel_launches_per_sample()[k]
                               + static.kernel_launches_per_sample()[k])
                for k in ops.KERNEL_WRAPPERS}
    log, seconds, outs = [], {m: [] for m in modes}, []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with ops.record_calls(log):
        for mode, s in modes.items():
            for conds in requests:
                t = time.perf_counter()
                outs.append(s(*conds, generator=ngen))
                torch.cuda.synchronize()
                seconds[mode].append(time.perf_counter() - t)
    launches = ops.launch_counts()
    paths = dict(ops.int8_conv3x3.path_launches)
    k1_paths = k1_path_check("int8 sampler", log)
    k3_path_check("int8 sampler", log)
    print(json.dumps({"int8_launch_counts": launches, "expected": expected,
                      "k4_path_launches": paths, "request_s": seconds}), flush=True)
    if launches != expected or not launches["int8_conv3x3"]:
        raise AssertionError(f"int8 launches {launches} != structure's {expected}")
    if paths != {"wgmma": launches["int8_conv3x3"], "general": 0}:
        raise AssertionError(f"the int8 sampler run took K4's general path: {paths}")
    for out in outs:
        if out.shape != (BATCH, IMAGE, IMAGE, 1) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"bad int8 sample: {tuple(out.shape)}")
        if float(out.std()) < 1e-2:
            raise AssertionError("int8 sample is near constant")
    best = {m: best_of(lambda s=s: s(*requests[0], generator=ngen), 3) for m, s in modes.items()}
    profiles = {m: profile_request(s, requests[0], ngen) for m, s in modes.items()}
    for m in modes:  # the device's share of an unprofiled request, as for training
        profiles[m]["idle_share_of_best_request"] = (
            1.0 - profiles[m]["device_busy_ms"] / (1e3 * best[m]))
    bf16 = sampler(*requests[0], x_init=x_init, noise=noise)
    diffs, vs_bf16, runs = {}, {}, {}
    for m, s in modes.items():
        got, diffs[m], runs[m] = sample_vs_plain(f"int8 {m}", s, requests[0], x_init, noise,
                                                 INT8_SAMPLE_TOL[m])
        vs_bf16[m] = float((got - bf16).abs().max())
    print(json.dumps({
        "card": card, "phase": "int8 sampler", "nf": cfg.num_channels_dae, "image": IMAGE,
        "batch": BATCH, "steps": cfg.num_timesteps, "compute": "bf16", "attn": "bf16",
        "sites": {"g1": len(calibs[0].sites), "g2": len(calibs[1].sites)},
        "min_ch": calibs[0].min_ch, "stems": calibs[0].stems,
        "calibration_s": calib_s, "best_request_s": best,
        "slices_per_s": {m: BATCH / v for m, v in best.items()},
        "sample_kernel_vs_plain_max_abs": diffs, "tolerance": INT8_SAMPLE_TOL,
        "sample_vs_bf16_sample_max_abs": vs_bf16, "sample_runs": runs,
        "profile_one_request": profiles}), flush=True)
    return {"launches": launches, "k4_path_launches": paths, "k1_path_launches": k1_paths,
            "log": log, "calibs": calibs,
            "best_request_s": best, "profiles": profiles, "sample_diffs": diffs,
            "sample_vs_bf16": vs_bf16}


SOURCES = {
    "conv3x3": ("mudiff_torch/csrc/conv3x3_kernel.cu", "mudiff_tpu/ops/pallas_conv.py:375"),
    "fir_down2": ("mudiff_torch/csrc/fir_kernels.cu", "mudiff_tpu/ops/pallas_fir.py:271"),
    "fir_up2": ("mudiff_torch/csrc/fir_kernels.cu", "mudiff_tpu/ops/pallas_fir.py:292"),
    # a stock Pallas kernel outside the repo, named by its call site
    "flash_attn": ("mudiff_torch/csrc/flash_attn_kernel.cu", "mudiff_tpu/nn/blocks.py:211"),
    # its backward, in the jax package that the call site imports
    "flash_attn_bwd_dkv": ("mudiff_torch/csrc/flash_attn_bwd_kernel.cu",
                           "jax/experimental/pallas/ops/tpu/flash_attention.py:941"),
    "flash_attn_bwd_dq": ("mudiff_torch/csrc/flash_attn_bwd_kernel.cu",
                          "jax/experimental/pallas/ops/tpu/flash_attention.py:1287"),
    # XLA-lowered on the TPU, not Pallas
    "int8_conv3x3": ("mudiff_torch/csrc/int8_conv_kernel.cu", "mudiff_tpu/ops/int8_conv.py:268"),
    # none: the JAX package leaves GroupNorm to XLA
    "group_norm_act": ("mudiff_torch/csrc/group_norm_kernel.cu", "none (XLA's GroupNorm)"),
}


# The launch counts of each row: the main path's run, the volume phase's
# and the training phase's counted runs, and the int8 leg's sampler and
# volume runs.  The ``kernels`` line sums each kernel over the main path's
# launches, except K3, which the serving path runs only in the volume
# phase, K3's backward, which only training runs, and K4, which only the
# int8 leg runs (its sampler run).
PATHS = ("launches", "volume_launches", "train_launches", "int8_launches",
         "int8_volume_launches", "loop_launches", "run_launches", "remat_launches",
         "branch_launches", "phantom_launches")
COUNTED_IN = {"flash_attn": "volume_launches", "flash_attn_bwd_dkv": "train_launches",
              "flash_attn_bwd_dq": "train_launches", "int8_conv3x3": "int8_launches"}


def shape_counts(logs: dict) -> dict:
    """{kernel: {shape key: {path: launches}}} from the ``record_calls``
    log of each path (``logs`` maps a name of ``PATHS`` to its log)."""
    counts = {}
    for path, log in logs.items():
        for kname, key in log:
            per = counts.setdefault(kname, {}).setdefault(key, dict.fromkeys(PATHS, 0))
            per[path] += 1
    return counts


def run_of(path: str) -> str:
    """The run whose launches the count ``path`` holds."""
    if path == "phantom_launches":
        return (f"phase 15's runs on a {PHANTOM_PATIENTS}-patient phantom set: run -e "
                f"{PHANTOM_EXPERIMENT} ({PHANTOM_EPOCHS} epoch of one iteration at batch 8, "
                "its validation and preview), calibrate_int8, and ab_int8_quality's bf16, "
                "int8 and int8-static legs")
    if path == "branch_launches":
        return (f"phase 14's runs of the model branches at nf={NF}: B1 and B2 each "
                f"{REQUESTS} requests and one W8A8 request of batch {BATCH} (attn flash), "
                f"one training iteration (batch {TRAIN_BATCH}, R1); B3's G1 + G2 at "
                f"t = {list(B3_STEPS)}; the two critics' forward and R1; the train CLI "
                f"(1 epoch) and the test CLI with B1's flags")
    if path == "run_launches":
        return (f"phase 8's CLI runs on {RUN_YAML}'s {RUN_EXPERIMENT} (nf=128): run "
                f"({RUN_EPOCHS} epoch at batch 2, remat hires, then the test at batch 8), "
                f"calibrate_int8 ({RUN_CALIB_BATCHES} batches of 4), the int8 test on the "
                f"sidecars, and the volume wrapper ({2 * WRAPPER_HALF + 1} slices)")
    if path == "remat_launches":
        return ("the remat table's counted iterations: one D (R1) + G iteration at nf=128, "
                "batch 2, per leg: " + ", ".join(leg for leg, _, _ in REMAT_LEGS))
    if path == "int8_launches":
        return (f"the int8 leg's sampler run: {REQUESTS} requests with dynamic scales, then "
                f"{REQUESTS} with static scales, each a 4-step W8A8 sample of batch {BATCH}")
    if path == "int8_volume_launches":
        n = 2 * VOLUME_HALF + 1
        return (f"the int8 leg's volume runs: the CLI without --bf16, with the static "
                f"sidecars and with --int8_dynamic, {n} slices in batches of {VOLUME_BATCH}")
    if path == "loop_launches":
        return (f"the train-loop phase's runs: the train CLI ({LOOP_EPOCHS} epochs of 10 "
                f"iterations at batch {TRAIN_BATCH}, then one more on --resume, each epoch "
                f"with its preview and validation samples, attn flash) and the test CLI "
                f"(10 slices in batches of {LOOP_TEST_BATCH}, int8 then --bf16)")
    if path == "train_launches":
        return (f"the training phase's run: {TRAIN_ITERS} iterations (D step, R1 on the "
                f"first, G step) at batch {TRAIN_BATCH}, bf16, attn flash")
    if path == "volume_launches":
        n = 2 * VOLUME_HALF + 1
        return (f"the volume phase's run: {n} slices of a {VOLUME_SHAPE} volume in "
                f"{math.ceil(n / VOLUME_BATCH)} batches of {VOLUME_BATCH}, each a 4-step "
                f"sample with --attn flash")
    return (f"the main path's run: {REQUESTS} requests, each a 4-step sample "
            f"of batch {BATCH}")


def kernel_summary(name, rows, launches, path=None):
    """One kernel's entry of the ``kernels`` line.  Every time is summed
    over the launches of one run (``path``, by default the one
    ``COUNTED_IN`` names): per-launch time at each shape x that shape's
    launches in the run, so it covers the same work as ``launches``.
    K2's rows carry cold-L2 times, and its ``bound_share`` is the bound
    over the summed ``ms_cold``; every other kernel's is over ``ms``."""
    path = path or COUNTED_IN.get(name, "launches")
    mine = [r for r in rows if r["kernel"] == name]
    if sum(r[path] for r in mine) != launches:
        raise AssertionError(f"{name}: per-shape launches do not add up to {launches}")

    def total(key):
        return sum(r[path] * r[key] for r in mine)

    compute = total("flop_ms")
    memory = total("byte_ms")
    bound = sum(r[path] * max(r["flop_ms"], r["byte_ms"]) for r in mine)
    entry = {
        "name": name, "route": "cuda", "source": SOURCES[name][0],
        "replaces": SOURCES[name][1], "launches": launches,
        "max_abs_err": max(r["err_bf16"] for r in mine),
        "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": bound,
        "bound_by": "operations" if compute >= memory else "bytes",
        "library_ms": total("library_ms"), "per": run_of(path),
        "shapes": sum(1 for r in mine if r[path]),
    }
    entry["bound_share"] = bound / entry["ms"] if entry["ms"] else None
    if all("ms_cold" in r for r in mine):  # K2: the share on the cold-L2 time
        entry["ms_cold"] = total("ms_cold")
        entry["ms_cold_clean"] = total("ms_cold_clean")
        entry["bound_share"] = bound / entry["ms_cold"] if entry["ms_cold"] else None
    designs = sorted({r["design"] for r in mine if r[path] and "design" in r})
    if designs:
        entry["design"] = "+".join(designs)
    if any("general_ms" in r for r in mine):  # the mma.sync kernels beside wgmma (K3, K4)
        entry["general_ms"] = sum(r[path] * r.get("general_ms", r["ms"]) for r in mine)
    if all("general_quantize_ms" in r for r in mine):  # K4: its general path and K1 beside it
        for key in ("general_quantize_ms", "general_gemm_ms", "k1_bf16_ms"):
            entry[key] = total(key)
        entry["paths"] = sorted({r["path"] for r in mine if r[path]})
    return entry


def grad_runs_through_kernels(device) -> dict:
    """A CUDA call that records a graph runs through the kernels, forward
    and backward (K5's backward is plain PyTorch); a second backward
    through K1, K3 or K5 raises (they are once differentiable); one through
    K2 runs the kernels.  Returns the launch counts of the calls."""
    import torch

    from mudiff_torch import ops

    g = torch.Generator(device).manual_seed(SEED + 5)
    x = torch.randn((1, 8, 8, 8), generator=g, device=device, requires_grad=True)
    w = torch.randn((3, 3, 8, 8), generator=g, device=device)
    q = torch.randn((1, 64, 8), generator=g, device=device, requires_grad=True)
    ops.reset_launch_counts()
    for out, inp in ((ops.conv3x3(x, w), x), (ops.flash_attn(q, q, q, 0.5), q),
                     (ops.group_norm_act(x, 4, x.dtype, silu=True), x)):
        (gx,) = torch.autograd.grad(torch.tanh(out).sum(), inp, create_graph=True)
        try:
            gx.square().sum().backward()
        except RuntimeError as err:
            if "once_differentiable" not in str(err):
                raise
        else:
            raise AssertionError("a second backward through K1, K3 or K5 did not raise")
    (gx,) = torch.autograd.grad(torch.tanh(ops.fir_down2(x)).sum(), x, create_graph=True)
    (gxx,) = torch.autograd.grad(gx.square().sum(), x)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = {"conv3x3": 2, "fir_down2": 2, "fir_up2": 2, "flash_attn": 1,
            "flash_attn_bwd_dkv": 1, "flash_attn_bwd_dq": 1, "int8_conv3x3": 0,
            "group_norm_act": 1}
    if counts != want or not bool(torch.isfinite(gxx).all()):
        raise AssertionError(f"graph-recording calls launched {counts}, want {want}")
    return counts


def synthetic_contrasts(seed: int):
    """Three seeded brain-like volumes of VOLUME_SHAPE: an ellipsoid of
    smooth noise on a zero background, so that the percentiles and the
    zero-padding of the volume path are real."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    rng = np.random.RandomState(seed)
    x, y, z = np.meshgrid(*[np.linspace(-1, 1, n, dtype=np.float32) for n in VOLUME_SHAPE],
                          indexing="ij")
    r2 = (x / 0.8) ** 2 + (y / 0.95) ** 2 + (z / 0.9) ** 2
    vols = []
    for i in range(3):
        coarse = torch.from_numpy(rng.randn(1, 1, 12, 12, 8).astype(np.float32))
        smooth = F.interpolate(coarse, size=VOLUME_SHAPE, mode="trilinear",
                               align_corners=False)[0, 0].numpy()
        tissue = (300.0 + 100.0 * i) * (1.5 + 0.5 * np.tanh(smooth) - 0.3 * r2)
        vols.append(np.where(r2 < 1.0, tissue, 0.0).astype(np.float32))
    return vols


def structure_launches(cfg, attn: str) -> dict:
    """Kernel launches of one 4-step sample with ``attn``, from the
    module structure of G1 and G2."""
    import torch

    from mudiff_torch.models import NCSNppGenerator

    with torch.device("meta"):
        gens = [NCSNppGenerator(cfg, adaptive=a, attn=attn, device="meta").eval()
                for a in (False, True)]
    counts = [g.kernel_launches_per_forward() for g in gens]
    return {k: cfg.num_timesteps * (counts[0][k] + counts[1][k]) for k in counts[0]}


def volume_argv(cfg, workdir: str, out_dir: str, int8: bool = False) -> list:
    """The CLI's arguments: cfg's architecture, the three inputs, flash
    attention, and exact bf16 serving (``--bf16``) or, with ``int8``, the
    CLI's default: W8A8."""
    return [
        *([] if int8 else ["--bf16"]), "--attn", "flash", "--image_size", str(cfg.image_size),
        "--num_channels", str(cfg.num_channels), "--num_channels_dae", str(cfg.num_channels_dae),
        "--ch_mult", *map(str, cfg.ch_mult), "--num_res_blocks", str(cfg.num_res_blocks),
        "--attn_resolutions", ",".join(map(str, cfg.attn_resolutions)),
        "--num_timesteps", str(cfg.num_timesteps), "--nz", str(cfg.nz),
        "--z_emb_dim", str(cfg.z_emb_dim), "--n_mlp", str(cfg.n_mlp),
        "--slice_half_range", str(VOLUME_HALF), "--test_batch_size", str(VOLUME_BATCH),
        "--ckpt_dir", os.path.join(workdir, "ckpt"), "--output_dir", out_dir,
        *[arg for m in ("flair", "t2", "t1")
          for arg in (f"--input_{m}", os.path.join(workdir, f"{m}.nii.gz"))],
    ]


AFFINE = ((-1.0, 0.0, 0.0, 120.0), (0.0, -1.0, 0.0, 120.0), (0.0, 0.0, 1.0, -77.0),
          (0.0, 0.0, 0.0, 1.0))


def check_volume(path: str, shape=None, half=None):
    """The predicted NIfTI: input shape (default VOLUME_SHAPE) and affine,
    zeros outside the predicted slices (the centre +-``half``, default
    VOLUME_HALF), finite and not constant inside.  Returns its data."""
    import numpy as np

    from mudiff_torch.utils import nifti

    shape = VOLUME_SHAPE if shape is None else tuple(shape)
    half = VOLUME_HALF if half is None else half
    img = nifti.load(path)
    vol = img.get_fdata()
    mid = shape[2] // 2
    band = vol[:, :, mid - half:mid + half + 1]
    if img.shape != shape or not np.allclose(img.affine, AFFINE):
        raise AssertionError(f"predicted volume {img.shape}, affine {img.affine.tolist()}")
    if vol[:, :, :mid - half].any() or vol[:, :, mid + half + 1:].any():
        raise AssertionError("predicted volume is not zero outside the predicted slices")
    if not np.isfinite(band).all() or float(band.std()) < 1e-3:
        raise AssertionError(f"predicted slices: finite {np.isfinite(band).all()}, "
                             f"std {float(band.std()):.3g}")
    return vol


def write_volume_inputs(workdir: str, sampler, seed: int) -> None:
    """The CLI's inputs in ``workdir``: three synthetic contrasts made
    from ``seed``, and the sampler's weights as its checkpoint."""
    import numpy as np

    from mudiff_torch.infer import save_generators
    from mudiff_torch.utils import nifti

    for name, vol in zip(("flair", "t2", "t1"), synthetic_contrasts(seed)):
        nifti.save(vol, np.array(AFFINE), os.path.join(workdir, f"{name}.nii.gz"))
    save_generators(os.path.join(workdir, "ckpt"), sampler.g1, sampler.g2)


def run_volume(cfg, workdir: str, tag: str, extra=(), plain=False, record=None, int8=False):
    """One CLI run on the inputs in ``workdir``, its launches zeroed just
    before and read just after.  Returns the checked output volume, the
    run's wall seconds and its launch counts."""
    import torch

    from mudiff_torch import ops
    from mudiff_torch.cli import test_volume

    argv = volume_argv(cfg, workdir, os.path.join(workdir, tag), int8) + list(extra)
    log = [] if record is None else record
    start = len(log)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with ops.record_calls(log), (ops.plain_kernels() if plain else contextlib.nullcontext()):
        t = time.perf_counter()
        path = test_volume.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
    if not plain:
        k1_path_check(f"volume {tag}", log, start)
        k3_path_check(f"volume {tag}", log, start)
    return check_volume(path), seconds, ops.launch_counts()


def volume_distance(a, b) -> float:
    """Max abs difference of two predicted volumes in the sampler's
    [-1, 1] units: the NIfTI holds the slices mapped to [0, 1] (clipped,
    resized back to 240^2), so twice a difference there."""
    import numpy as np

    return 2.0 * float(np.abs(a - b).max())


def volume_phases(cfg, sampler, calibs, card) -> dict:
    """Phases 4 and 5: the test_volume CLI at full width with --attn
    flash, counted and timed in bf16; the same volume with the plain
    versions forced; and both again in fp32 (--no_bf16).  Then the int8
    leg's volume: the CLI without --bf16 (W8A8, the static scales of
    ``calibs`` as sidecars beside the checkpoint), and with
    --int8_dynamic."""
    from mudiff_torch import ops
    from mudiff_torch.infer.calibrate import calib_sidecar_paths, save_calib

    n_slices = 2 * VOLUME_HALF + 1
    batches = math.ceil(n_slices / VOLUME_BATCH)
    expected = {k: batches * v for k, v in structure_launches(cfg, "flash").items()}
    expected8 = {k: batches * v for k, v in
                 structure_launches(cfg.replace(use_int8=True), "flash").items()}
    log, log8 = [], []
    runs = {  # tag: (extra flags, plain versions forced, call log, int8)
        "bf16": ((), False, log, False),  # the phase's counted run
        "bf16 warm": ((), False, None, False),  # the same again, timed warm
        "bf16 plain": ((), True, None, False),
        "fp32": (("--no_bf16",), False, None, False),
        "fp32 plain": (("--no_bf16",), True, None, False),
        "int8 static": ((), False, log8, True),
        "int8 dynamic": (("--int8_dynamic",), False, log8, True),
    }
    vols, seconds, counts, paths = {}, {}, {}, {}
    with tempfile.TemporaryDirectory() as workdir:
        write_volume_inputs(workdir, sampler, SEED + 40)
        for calib, path in zip(calibs, calib_sidecar_paths(os.path.join(workdir, "ckpt"))):
            save_calib(path, calib)
        for tag, (extra, plain, record, int8) in runs.items():
            vols[tag], seconds[tag], counts[tag] = run_volume(cfg, workdir, tag, extra,
                                                              plain, record, int8)
            want = dict.fromkeys(expected, 0) if plain else expected8 if int8 else expected
            if counts[tag] != want:
                raise AssertionError(f"volume {tag}: launches {counts[tag]} != {want}")
            if int8:  # K4's launches by path, read after the run as the counts are
                paths[tag] = dict(ops.int8_conv3x3.path_launches)
                if paths[tag] != {"wgmma": counts[tag]["int8_conv3x3"], "general": 0}:
                    raise AssertionError(f"volume {tag} took K4's general path: {paths[tag]}")

    diffs = {"fp32 kernels vs plain": volume_distance(vols["fp32"], vols["fp32 plain"]),
             "bf16 kernels vs plain": volume_distance(vols["bf16"], vols["bf16 plain"]),
             "bf16 kernels vs fp32 plain": volume_distance(vols["bf16"], vols["fp32 plain"]),
             "bf16 plain vs fp32 plain": volume_distance(vols["bf16 plain"], vols["fp32 plain"]),
             "int8 static vs bf16": volume_distance(vols["int8 static"], vols["bf16"]),
             "int8 dynamic vs bf16": volume_distance(vols["int8 dynamic"], vols["bf16"]),
             "int8 static vs dynamic": volume_distance(vols["int8 static"],
                                                       vols["int8 dynamic"])}
    print(json.dumps({
        "card": card, "phase": "volume (test_volume CLI)", "shape": list(VOLUME_SHAPE),
        "slices": n_slices, "batch": VOLUME_BATCH, "batches": batches, "nf": cfg.num_channels_dae,
        "image": cfg.image_size, "dtype": "bf16", "attn": "flash",
        "launch_counts": counts["bf16"], "run_s": seconds,
        "slices_per_s": n_slices / seconds["bf16"],
        "slices_per_s_warm": n_slices / seconds["bf16 warm"],
        "int8_launch_counts": {tag: counts[tag] for tag in ("int8 static", "int8 dynamic")},
        "int8_k4_path_launches": paths,
        "int8_slices_per_s": {tag: n_slices / seconds[tag]
                              for tag in ("int8 static", "int8 dynamic")},
        "max_abs_diff": diffs, "tolerance": {"fp32": SAMPLE_TOL["fp32"], "bf16": BF16_VOLUME_TOL},
    }), flush=True)
    for tag, tol in (("fp32", SAMPLE_TOL["fp32"]), ("bf16", BF16_VOLUME_TOL)):
        if not diffs[f"{tag} kernels vs plain"] <= tol:
            raise AssertionError(f"{tag} volume, kernels vs plain: max abs diff "
                                 f"{diffs[f'{tag} kernels vs plain']:.3g} > {tol}")
    int8_counts = {k: counts["int8 static"][k] + counts["int8 dynamic"][k] for k in expected}
    return {"launches": counts["bf16"], "log": log, "int8_launches": int8_counts,
            "int8_log": log8, "seconds": seconds, "diffs": diffs}


def iteration_grads(state, batch, draws, plain: bool):
    """One D (R1) + G iteration's losses and gradients, before the
    optimizer, through the kernels or with the plain versions forced;
    and the launch counts it made."""
    import torch

    from mudiff_torch import ops
    from mudiff_torch.train import d_loss_and_grads, g_loss_and_grads

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with ops.plain_kernels() if plain else contextlib.nullcontext():
        grads_d, aux_d = d_loss_and_grads(state, batch, draws[0], with_r1=True)
        (grads_g1, grads_g2), aux_g = g_loss_and_grads(state, batch, draws[1])
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        grads_r1 = r1_grads(state, batch, draws[0])
    torch.cuda.synchronize()
    names = [f"{m}.{n}" for m in ("d", "g1", "g2")
             for n, _ in getattr(state, m).named_parameters()]
    names += [f"R1 alone: d.{n}" for n, _ in state.d.named_parameters()]
    losses = {k: float(v) for k, v in {**aux_d, **aux_g}.items()}
    return losses, dict(zip(names, grads_d + grads_g1 + grads_g2 + grads_r1)), counts


def r1_grads(state, batch, draws):
    """The gradient of the R1 penalty alone to D's parameters: in the
    whole D step it is small beside the logit losses', so a fault in the
    double backward (the FIR kernels' adjoints of adjoints) would hide
    there."""
    import torch

    from mudiff_torch.diffusion import q_sample_pairs

    real = batch[3]
    x_t, x_tp1 = q_sample_pairs(state.coeff, real, draws.t, draws.noise_t, draws.noise_tp1)
    x_t.requires_grad_(True)
    logit, _ = state.d(x_t, draws.t, x_tp1)
    (gx,) = torch.autograd.grad(logit.sum(), x_t, create_graph=True)
    penalty = gx.reshape(real.shape[0], -1).square().sum(dim=1).mean()
    params = list(state.d.parameters())
    grads = torch.autograd.grad(penalty, params, allow_unused=True)  # the last bias: none
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


KERNEL_MODULES = ("conv3x3", "fir", "flash_attn", "int8_conv", "group_norm")


@contextlib.contextmanager
def kernels_only(*names):
    """Every wrapper whose kernel is not in ``names`` runs its plain
    version, on CUDA tensors too."""
    saved = {m: m.use_kernel for m in (sys.modules[f"mudiff_torch.ops.{k}"]
                                        for k in KERNEL_MODULES)}
    for m, real in saved.items():
        m.use_kernel = (lambda name, key, *tensors, real=real:
                        real(name, key, *tensors) and name in names)
    try:
        yield
    finally:
        for m, real in saved.items():
            m.use_kernel = real


def grad_errors(grads: dict, plain: dict, exact: dict | None = None):
    """||g - g_plain|| / ||g_plain|| of each named gradient whose norm in
    ``exact`` (the same iteration in fp32 through the plain versions; by
    default ``plain`` itself) is above TINY_GRAD of the largest of its
    group (the name's first part: d, g1, g2, R1 alone); returns (those
    errors, the names below)."""
    ref = plain if exact is None else exact
    norms = {n: float(g.float().norm()) for n, g in ref.items()}
    top = {}
    for n, v in norms.items():
        top[n.split(".")[0]] = max(top.get(n.split(".")[0], 0.0), v)
    errors, tiny = {}, []
    for n, g in grads.items():
        if norms[n] <= TINY_GRAD * top[n.split(".")[0]]:
            tiny.append(n)
            continue
        if not bool(torch_isfinite(g)):
            raise AssertionError(f"the gradient of {n} is not finite")
        errors[n] = rel_err(g, plain[n])
    return errors, tiny


def rel_err(g, ref) -> float:
    """||g - ref|| / ||ref||, in fp32."""
    return float((g.float() - ref.float()).norm()) / max(float(ref.float().norm()), 1e-30)


@contextlib.contextmanager
def fixed_cudnn():
    """cuDNN's heuristic choice among its deterministic algorithms
    (``benchmark`` off, ``steps.deterministic_cudnn``): the same
    algorithms in every process, so a check on fixed weights reads the
    same in every run.  The caller's settings come back after."""
    import torch

    from mudiff_torch.train.steps import deterministic_cudnn

    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        with deterministic_cudnn():
            yield
    finally:
        torch.backends.cudnn.benchmark = saved


def mask_factors(state, batch, draws, plain: bool) -> dict:
    """The G step's forward on ``draws[1]`` without a graph, through the
    kernels or with the plain versions forced: its mask loss's factors
    (``mask_terms``), the critic's features and the posterior samples."""
    import torch

    from mudiff_torch import ops
    from mudiff_torch.train.steps import g_forward, mask_terms

    with torch.no_grad(), ops.plain_kernels() if plain else contextlib.nullcontext():
        fwd = g_forward(state, batch, draws[1])
        terms = mask_terms(state.att_conv, fwd)
    return {**{k: fwd[k] for k in ("pos_g1", "pos_g2", "feat_g1", "feat_g2")}, **terms}


def bf16_spacing(x):
    """bf16's spacing at each |x|, 2^(floor(log2 |x|) - 7), in float32."""
    import torch

    _, exponent = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exponent - 8)


def mask_distance(got: dict, ref: dict) -> dict:
    """How far ``got``'s mask factors lie from ``ref``'s (``mask_factors``):
    both critic passes' attention logits in bf16 spacings (mean signed,
    mean and max absolute difference; the share that differ; ``ref``'s
    range), the relative errors of the BCE factors, the maps, the terms,
    G_mask and the critic's features, and the posterior samples' max
    absolute difference.  The spacing is one for all the logits, at
    their mean magnitude: a logit near 0 is resolved no finer than its
    neighbours, its error coming from the same bf16 features."""
    import torch

    logits = ("att_logit_g1", "att_logit_g2")
    want = torch.cat([ref[k].float().flatten() for k in logits])
    diff = torch.cat([got[k].float().flatten() for k in logits]) - want
    units = diff / bf16_spacing(want.abs().mean())

    def scalar_err(a, b):
        return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)

    return {"logit_mean_abs_spacings": float(units.abs().mean()),
            "logit_mean_signed_spacings": float(units.mean()),
            "logit_max_abs_spacings": float(units.abs().max()),
            "logit_share_differing": float((diff != 0).float().mean()),
            "logit_range": [float(want.min()), float(want.max())],
            "bce_rel_err": max(rel_err(got[k], ref[k]) for k in ("bce_1", "bce_2")),
            **{f"{k}_rel_err": rel_err(got[k], ref[k])
               for k in ("bce_1", "bce_2", "att_g1", "att_g2")},
            **{f"{k}_rel_err": scalar_err(got[k], ref[k]) for k in ("term_1", "term_2")},
            "G_mask_rel_err": scalar_err(got["term_1"] + got["term_2"],
                                         ref["term_1"] + ref["term_2"]),
            "feat_rel_err": max(rel_err(got[k], ref[k]) for k in ("feat_g1", "feat_g2")),
            "pos_max_abs": max(float((got[k].float() - ref[k].float()).abs().max())
                               for k in ("pos_g1", "pos_g2"))}


def mask_ratios(got: dict, rounding: dict) -> dict:
    """``mask_distance`` readings of the kernels against the plain run
    over the plain bf16 run's against the fp32 one: the logits' mean
    |diff| and the larger of the two BCE factors' relative errors."""
    def over(key):
        return got[key] / max(rounding[key], 1e-30)

    return {"logits": over("logit_mean_abs_spacings"),
            "bce": max(over("bce_1_rel_err"), over("bce_2_rel_err"))}


def iteration_verdict(tag: str, state, batch, draws, exact: dict, exact_mask: dict) -> dict:
    """Kernels vs plain versions on one iteration (``compare_iteration``'s
    readings), under ``fixed_cudnn``; ``failed`` lists the checks that
    failed."""
    loss_tol, grad_tol = TRAIN_TOL[tag]
    with fixed_cudnn():
        losses, grads, counts = iteration_grads(state, batch, draws, plain=False)
        p_losses, p_grads, p_counts = iteration_grads(state, batch, draws, plain=True)
        plain_mask = mask_factors(state, batch, draws, plain=True)
        mask = mask_distance(mask_factors(state, batch, draws, plain=False), plain_mask)
    mask_rounding = mask_distance(plain_mask, exact_mask)
    want = state.kernel_launches_per_iteration(with_r1=True)
    if counts != want or any(p_counts.values()):
        raise AssertionError(f"{tag} iteration: launches {counts} with kernels (want {want}), "
                             f"{p_counts} with plain versions forced")
    loss_err = {k: abs(losses[k] - v) / max(abs(v), 1e-12) for k, v in p_losses.items()}
    held = [k for k in loss_err if not (tag == "bf16" and k == "G_mask")]
    loss_worst = max(held, key=loss_err.get)
    grad_err, tiny = grad_errors(grads, p_grads, exact)
    rounding = {n: rel_err(p_grads[n], exact[n]) for n in grad_err}
    limit = {n: max(grad_tol, SPREAD * d) for n, d in rounding.items()}
    share = {n: e / limit[n] for n, e in grad_err.items()}
    worst, nearest = max(grad_err, key=grad_err.get), max(share, key=share.get)
    kernels_far = {n: rel_err(grads[n], exact[n]) for n in grad_err}
    result = {"tag": tag, "losses_kernels": losses, "losses_plain": p_losses,
              "max_loss_rel_err": loss_err[loss_worst], "worst_loss": loss_worst,
              "G_mask_rel_err": loss_err["G_mask"],
              "max_grad_rel_err": grad_err[worst], "worst_tensor": worst,
              "nearest_its_limit": {"tensor": nearest, "err": grad_err[nearest],
                                    "limit": limit[nearest], "share": share[nearest]},
              "tensors_held": len(grad_err), "tensors_below_tiny": len(tiny),
              "tensors_above_tol": sum(v > grad_tol for v in limit.values()),
              "median_grad_rel_err": sorted(grad_err.values())[len(grad_err) // 2],
              "worst_five": [(n, grad_err[n], limit[n]) for n in
                             sorted(grad_err, key=grad_err.get, reverse=True)[:5]],
              "below_tiny": tiny,
              "plain_vs_fp32_plain": {"max": max(rounding.values()),
                                      "median": sorted(rounding.values())[len(rounding) // 2],
                                      f"at_{worst}": rounding[worst]},
              "kernels_vs_fp32_plain": {"max": max(kernels_far.values()),
                                        "median": sorted(kernels_far.values())[
                                            len(kernels_far) // 2],
                                        f"at_{worst}": kernels_far[worst]},
              "mask_vs_plain": mask, "mask_plain_vs_fp32_plain": mask_rounding,
              "mask_ratio": mask_ratios(mask, mask_rounding) if tag == "bf16" else None,
              "tolerance": {"loss": loss_tol, "grad": grad_tol, "spread": SPREAD,
                            **({"mask": MASK_TOL} if tag == "bf16" else {})}}
    failed = []
    if result["max_loss_rel_err"] > loss_tol:
        failed.append(f"loss {loss_worst} rel err {loss_err[loss_worst]:.3g} (limit {loss_tol})")
    if share[nearest] > 1.0:
        failed.append(f"grad rel err {grad_err[nearest]:.3g} ({nearest}) beyond its limit "
                      f"{limit[nearest]:.3g}")
    if tag == "bf16":
        ratio = result["mask_ratio"]
        failed += [f"G_mask's {k} at {ratio[k]:.3g} of bf16's own distance (limit {limit})"
                   for k, limit in MASK_TOL.items() if not ratio[k] <= limit]
    result["failed"] = failed
    return result


def compare_iteration(tag: str, state, batch, draws, exact: dict, exact_mask: dict) -> dict:
    """Kernels vs plain versions on one iteration, both under
    ``fixed_cudnn``, held to TRAIN_TOL[tag] on the losses and on the
    tensors ``grad_errors`` holds, ``exact`` being the fp32 plain run's
    gradients; a gradient whose plain run lies a distance d from
    ``exact`` is held to the larger of the tolerance and SPREAD * d.  In
    bf16 G_mask is held by its factors against ``exact_mask`` (the fp32
    plain run's ``mask_factors``) to ``MASK_TOL``, not relative."""
    result = iteration_verdict(tag, state, batch, draws, exact, exact_mask)
    print(json.dumps({"train_kernels_vs_plain": result}), flush=True)
    if result["failed"]:
        raise AssertionError(f"{tag} iteration, kernels vs plain: " + "; ".join(result["failed"]))
    return result


def fp32_copy(cfg, state):
    """A fp32 train state (``--no_bf16``) holding ``state``'s weights."""
    from mudiff_torch.train import create_train_state

    state32 = create_train_state(cfg.replace(use_bf16=False), seed=SEED, device=DEVICE,
                                 attn="flash")
    for m in ("g1", "g2", "d", "att_conv"):
        getattr(state32, m).load_state_dict(getattr(state, m).state_dict())
    return state32


def fp32_reference(cfg, state, batch, draws):
    """``fp32_copy`` of ``state`` and, under ``fixed_cudnn`` with the
    plain versions forced, its iteration's gradients and mask factors:
    what ``compare_iteration`` holds both dtypes against."""
    state32 = fp32_copy(cfg, state)
    with fixed_cudnn():
        exact = iteration_grads(state32, batch, draws, plain=True)[1]
        exact_mask = mask_factors(state32, batch, draws, plain=True)
    return state32, exact, exact_mask


def torch_isfinite(t) -> bool:
    import torch

    return bool(torch.isfinite(t).all())


def best_of(fn, n: int) -> float:
    """Least wall seconds of ``n`` calls, each ending in a synchronize."""
    import torch

    best = math.inf
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t)
    return best


def training_phase(cfg, card) -> dict:
    """Phase 6: the adversarial training iteration at full width."""
    import torch

    from mudiff_torch import ops
    from mudiff_torch.train import (TrainDraws, create_train_state, make_d_step,
                                    make_g_step, make_train_step)

    state = create_train_state(cfg, seed=SEED, steps_per_epoch=1000, device=DEVICE,
                               attn="flash")
    wgen = torch.Generator(DEVICE).manual_seed(SEED + 50)
    for module in (state.g1, state.g2, state.d):
        randomize_(module, wgen)
    bgen = torch.Generator(DEVICE).manual_seed(SEED + 51)
    shape = (TRAIN_BATCH, IMAGE, IMAGE, 1)
    batch = [torch.randn(shape, generator=bgen, device=DEVICE).tanh() for _ in range(4)]
    before = {m: {k: v.detach().clone() for k, v in getattr(state, m).state_dict().items()}
              for m in ("g1", "g2", "d", "att_conv")}
    train_step = make_train_step(cfg)
    tgen = torch.Generator(DEVICE).manual_seed(SEED + 52)

    # -- counted: global steps 0..TRAIN_ITERS-1, R1 on the lazy schedule
    log, seconds, metrics = [], [], []
    expected = {}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with ops.record_calls(log), fixed_cudnn():  # the compared state repeats its bits
        for _ in range(TRAIN_ITERS):
            with_r1 = cfg.lazy_reg is None or state.step % cfg.lazy_reg == 0
            for k, v in state.kernel_launches_per_iteration(with_r1).items():
                expected[k] = expected.get(k, 0) + v
            t = time.perf_counter()
            m = train_step(state, batch, generator=tgen)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t)
            metrics.append({k: float(v) for k, v in m.items()} | {"R1_step": with_r1})
    launches = ops.launch_counts()
    k1_path_check("training", log)
    k3_path_check("training", log)
    print(json.dumps({"phase": "training", "launch_counts": launches, "expected": expected,
                      "iteration_s": seconds, "losses": metrics}), flush=True)
    if launches != expected:
        raise AssertionError(f"training launches {launches} != structure's {expected}")
    if not all(math.isfinite(v) for m in metrics for k, v in m.items() if k != "R1_step"):
        raise AssertionError("a training loss is not finite")
    if not metrics[0]["R1"] > 0.0:
        raise AssertionError(f"R1 on step 0 is {metrics[0]['R1']}")
    for m in ("g1", "g2", "d"):
        after = getattr(state, m).state_dict()
        if not all(torch_isfinite(v) for v in after.values()):
            raise AssertionError(f"{m}: a parameter is not finite after training")
        if all(torch.equal(before[m][k], after[k]) for k in after):
            raise AssertionError(f"{m}: no parameter changed in {TRAIN_ITERS} iterations")
    for k, v in state.att_conv.state_dict().items():
        if not torch.equal(v, before["att_conv"][k]):
            raise AssertionError("att_conv changed: it must stay frozen")
    del before

    # -- one iteration, kernels vs plain versions, bf16 and fp32 (TF32 off)
    dgen = torch.Generator(DEVICE).manual_seed(SEED + 53)
    draws = tuple(TrainDraws.draw(cfg, batch[3], dgen) for _ in range(2))
    state32, exact, exact_mask = fp32_reference(cfg, state, batch, draws)
    compared = [compare_iteration(tag, st, batch, draws, exact, exact_mask)
                for tag, st in (("bf16", state), ("fp32", state32))]
    del state32, exact, exact_mask

    # -- times, memory, profile
    d_step, g_step = make_d_step(), make_g_step()
    times = {
        "iteration_r1": best_of(lambda: train_step(state, batch, tgen, with_r1=True), 3),
        "iteration_no_r1": best_of(lambda: train_step(state, batch, tgen, with_r1=False), 3),
        "d_step_r1": best_of(lambda: d_step(state, batch, draws[0], True), 3),
        "d_step_no_r1": best_of(lambda: d_step(state, batch, draws[0], False), 3),
        "g_step": best_of(lambda: g_step(state, batch, draws[1]), 3),
    }
    lazy = cfg.lazy_reg or 1
    mean_s = ((lazy - 1) * times["iteration_no_r1"] + times["iteration_r1"]) / lazy
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train_step(state, batch, tgen, with_r1=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    profile = profile_call(lambda: train_step(state, batch, tgen, with_r1=True))
    # the profiler slows the host; the device's share of an unprofiled
    # iteration is its busy time over the best unprofiled wall time
    profile["idle_share_of_best_iteration"] = (
        1.0 - profile["device_busy_ms"] / (1e3 * times["iteration_r1"]))
    print(json.dumps({
        "card": card, "phase": "training", "nf": cfg.num_channels_dae, "image": IMAGE,
        "batch": TRAIN_BATCH, "dtype": "bf16", "attn": "flash", "lazy_reg": cfg.lazy_reg,
        "best_s": times, "slices_per_s_no_r1": TRAIN_BATCH / times["iteration_no_r1"],
        "slices_per_s_r1": TRAIN_BATCH / times["iteration_r1"],
        "slices_per_s_lazy_mix": TRAIN_BATCH / mean_s,
        "max_memory_allocated_bytes": peak,
        "profile_one_iteration_r1": profile}), flush=True)
    return {"launches": launches, "log": log, "losses": metrics, "compared": compared,
            "times": times, "peak_bytes": peak, "profile": profile}


def recipe_argv(cfg) -> list:
    """The CLI flags that give ``cfg``'s model, diffusion and optimiser."""
    return [
        "--image_size", str(cfg.image_size), "--num_channels", str(cfg.num_channels),
        "--num_channels_dae", str(cfg.num_channels_dae), "--ch_mult", *map(str, cfg.ch_mult),
        "--num_res_blocks", str(cfg.num_res_blocks),
        "--attn_resolutions", ",".join(map(str, cfg.attn_resolutions)),
        "--num_timesteps", str(cfg.num_timesteps), "--nz", str(cfg.nz),
        "--z_emb_dim", str(cfg.z_emb_dim), "--t_emb_dim", str(cfg.t_emb_dim),
        "--n_mlp", str(cfg.n_mlp), "--ngf", str(cfg.ngf), "--lr_g", repr(cfg.lr_g),
        "--lr_d", repr(cfg.lr_d), "--r1_gamma", repr(cfg.r1_gamma),
    ]


def write_patients(root: str, seed: int) -> None:
    """LOOP_PATIENTS BraTS-named patient folders of four .nii.gz
    modalities: an ellipsoid of smooth tissue on a zero background, in
    integer intensities as a scanner writes them.  Each file is written
    as .nii and gzipped at level 1 (``nifti.save`` gzips at level 9, 41 s
    for the 32 files on the card's host)."""
    import gzip

    import numpy as np
    import torch
    import torch.nn.functional as F

    from mudiff_torch.utils import nifti

    rng = np.random.RandomState(seed)
    x, y, z = np.meshgrid(*[np.linspace(-1, 1, n, dtype=np.float32) for n in LOOP_VOLUME],
                          indexing="ij")
    r2 = (x / 0.8) ** 2 + (y / 0.9) ** 2 + (z / 1.2) ** 2
    for p in range(LOOP_PATIENTS):
        pdir = os.path.join(root, f"BraTS-{p:05d}")
        os.makedirs(pdir)
        for m, kw in enumerate(("t1n", "t1c", "t2w", "t2f")):
            coarse = torch.from_numpy(rng.randn(1, 1, 10, 10, 4).astype(np.float32))
            smooth = F.interpolate(coarse, size=LOOP_VOLUME, mode="trilinear",
                                   align_corners=False)[0, 0].numpy()
            tissue = (300.0 + 80.0 * m) * (1.5 + 0.5 * np.tanh(smooth) - 0.3 * r2)
            vol = np.round(np.where(r2 < 1.0, tissue, 0.0)).astype(np.float32)
            path = os.path.join(pdir, f"BraTS-{p:05d}-{kw}.nii")
            nifti.save(vol, np.array(AFFINE), path)
            with open(path, "rb") as f, gzip.open(path + ".gz", "wb", compresslevel=1) as g:
                g.write(f.read())
            os.remove(path)


def loop_structure(cfg, attn: str = "flash") -> dict:
    """Kernel launches of one training iteration with and without R1, and
    of one sampling call (``attn``, by default flash), from the module
    structure."""
    from types import SimpleNamespace

    import torch

    from mudiff_torch.models import DiscriminatorLarge, NCSNppGenerator
    from mudiff_torch.train import TrainState

    with torch.device("meta"):
        g1, g2 = (NCSNppGenerator(cfg, adaptive=a, attn=attn, device="meta")
                  for a in (False, True))
        d = DiscriminatorLarge(ngf=cfg.ngf, t_emb_dim=cfg.t_emb_dim, device="meta")
    modules = SimpleNamespace(g1=g1, g2=g2, d=d)  # what the method reads
    return {"r1": TrainState.kernel_launches_per_iteration(modules, True),
            "no_r1": TrainState.kernel_launches_per_iteration(modules, False),
            "sample": structure_launches(cfg, attn),
            "sample_int8": structure_launches(cfg.replace(use_int8=True), attn)}


def combine(parts) -> dict:
    """Sum of ``n x counts`` over ``parts`` [(n, counts), ...]."""
    out = {}
    for n, counts in parts:
        for k, v in counts.items():
            out[k] = out.get(k, 0) + n * v
    return out


def payload_equal(a, b, path="content") -> None:
    """Raise unless two content dicts hold the same tensors and values."""
    import torch

    if torch.is_tensor(a):
        if not (torch.is_tensor(b) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b)):
            raise AssertionError(f"restored {path} differs from content.pt")
    elif isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"restored {path} has other keys than content.pt")
        for k in a:
            payload_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"restored {path} has another length")
        for i, (x, y) in enumerate(zip(a, b)):
            payload_equal(x, y, f"{path}/{i}")
    elif a != b:
        raise AssertionError(f"restored {path}: {a!r} != {b!r}")


def counted(log, fn, tag: str = "counted run"):
    """``fn()`` with the launch counts zeroed just before and read just
    after, K1's by path checked (``k1_path_check``); returns (its result,
    the counts, its wall seconds)."""
    import torch

    from mudiff_torch import ops

    start = len(log)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with ops.record_calls(log):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
    k1_path_check(tag, log, start)
    k3_path_check(tag, log, start)
    return out, ops.launch_counts(), seconds


def loop_phase(cfg, card, work: str) -> dict:
    """Phase 7: preprocess, train, restore, resume and the slice test,
    through the port's CLIs at full width.  The raw patients and the
    split stay in ``work`` (phase 8 reads them)."""
    import json as _json

    import numpy as np
    import torch

    from mudiff_torch import ops
    from mudiff_torch.cli import test as test_cli
    from mudiff_torch.cli import train as train_cli
    from mudiff_torch.cli.args import parse_config
    from mudiff_torch.data import _native, preprocess
    from mudiff_torch.train import checkpoint as ckpt
    from mudiff_torch.train import create_train_state
    from mudiff_torch.utils import png

    struct = loop_structure(cfg)
    log, counts, seconds = [], {}, {}
    raw, npy, out = (os.path.join(work, d) for d in ("raw", "npy", "results"))
    t = time.perf_counter()
    write_patients(raw, SEED + 60)
    seconds["write_nifti"] = time.perf_counter() - t
    t = time.perf_counter()
    preprocess.main(["--input_dir", raw, "--output_dir", npy, "--slice_half_range",
                     str(LOOP_HALF), "--train_ratio", str(LOOP_SPLIT[0]),
                     "--val_ratio", str(LOOP_SPLIT[1])])
    seconds["preprocess"] = time.perf_counter() - t
    sizes = {s: np.load(os.path.join(npy, s, "T1CE.npy"), mmap_mode="r").shape
             for s in ("train", "val", "test")}
    if sizes != {s: (n, IMAGE, IMAGE) for s, n in (("train", 20), ("val", 10),
                                                   ("test", 10))}:
        raise AssertionError(f"preprocessed splits {sizes}")

    argv = recipe_argv(cfg) + [
        "--input_path", npy, "--output_path", out, "--exp", "smoke",
        "--batch_size", str(TRAIN_BATCH), "--lazy_reg", str(LOOP_LAZY), "--log_every", "1",
        "--save_ckpt_every", "1", "--attn", "flash", "--seed", str(SEED)]
    tcfg = parse_config(argv, mode="train")[0]
    for field in ("image_size", "num_channels_dae", "ch_mult", "num_res_blocks",
                  "attn_resolutions", "num_timesteps", "nz", "z_emb_dim", "t_emb_dim",
                  "n_mlp", "ngf", "lr_g", "lr_d", "r1_gamma", "num_channels"):
        if getattr(tcfg, field) != getattr(cfg, field):
            raise AssertionError(f"train CLI's {field}: {getattr(tcfg, field)}")
    steps = 20 // TRAIN_BATCH
    val_batches = math.ceil(10 / TRAIN_BATCH)

    # -- train: LOOP_EPOCHS epochs, counted
    torch.cuda.reset_peak_memory_stats()
    first, counts["train"], seconds["train"] = counted(
        log, lambda: train_cli.main(argv + ["--num_epoch", str(LOOP_EPOCHS)]), "phase 7 train")
    peak = torch.cuda.max_memory_allocated()
    exp = first["exp_dir"]
    n_steps = LOOP_EPOCHS * steps
    want_r1 = [s for s in range(n_steps) if s % LOOP_LAZY == 0]
    previews = sum(1 for e in range(LOOP_EPOCHS) if e % 10 == 0 or e == LOOP_EPOCHS - 1)
    want = combine([(len(want_r1), struct["r1"]), (n_steps - len(want_r1), struct["no_r1"]),
                    (previews + LOOP_EPOCHS * val_batches, struct["sample"])])
    if counts["train"] != want or first["r1_steps"] != want_r1:
        raise AssertionError(f"train launches {counts['train']} != structure's {want}; "
                             f"R1 on {first['r1_steps']}")
    content_bytes = os.path.getsize(os.path.join(exp, ckpt.CONTENT_FILE))

    # -- the restore, held against content.pt tensor for tensor
    state = create_train_state(tcfg.replace(num_epoch=LOOP_EPOCHS + 1), seed=SEED + 61,
                               steps_per_epoch=steps, device=DEVICE, attn="flash")
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, epoch, global_step = ckpt.restore_content(exp, state)
    torch.cuda.synchronize()
    seconds["restore"] = time.perf_counter() - t
    saved = ckpt.load_content(exp)
    payload_equal(ckpt.content_payload(state, epoch, global_step), saved)
    if (epoch, global_step, state.step) != (LOOP_EPOCHS - 1, n_steps, n_steps):
        raise AssertionError(f"content.pt at epoch {epoch}, step {global_step}")
    if state.counts != dict.fromkeys(("g1", "g2", "d"), n_steps):
        raise AssertionError(f"restored schedule counts {state.counts}")
    del state, saved

    # -- resume: one more epoch, counted
    torch.cuda.reset_peak_memory_stats()
    resumed, counts["resume"], seconds["resume"] = counted(
        log, lambda: train_cli.main(argv + ["--num_epoch", str(LOOP_EPOCHS + 1),
                                            "--resume"]))
    want_r1 = [s for s in range(n_steps, n_steps + steps) if s % LOOP_LAZY == 0]
    want = combine([(len(want_r1), struct["r1"]), (steps - len(want_r1), struct["no_r1"]),
                    (1 + val_batches, struct["sample"])])  # the last epoch's preview
    peak_resume = torch.cuda.max_memory_allocated()
    if counts["resume"] != want or resumed["r1_steps"] != want_r1:
        raise AssertionError(f"resume launches {counts['resume']} != structure's {want}; "
                             f"R1 on {resumed['r1_steps']}")
    with open(resumed["history"]) as f:
        history = _json.load(f)
    if [h["epoch"] for h in history] != list(range(LOOP_EPOCHS + 1)):
        raise AssertionError(f"history epochs {[h['epoch'] for h in history]}")
    if not all(math.isfinite(v) for h in history for v in h["losses"].values()) or \
            not all(h["val_psnr"] is not None for h in history):
        raise AssertionError("a loss or a validation PSNR is not finite")
    files = set(os.listdir(exp))
    need = {"content.pt", "gen_diffusive_1.pt", "gen_diffusive_2.pt",
            f"gen_diffusive_1_{LOOP_EPOCHS}.pt", "sample_epoch_0.png",
            f"sample_epoch_{LOOP_EPOCHS}.png", "val_l1_loss.npy", "val_psnr_values.npy",
            "training_history.json", "train_config.json"}
    if not need <= files:
        raise AssertionError(f"missing artifacts {sorted(need - files)}")
    if np.load(os.path.join(exp, "val_psnr_values.npy")).shape != (LOOP_EPOCHS + 2,
                                                                    val_batches):
        raise AssertionError("val_psnr_values.npy has the wrong shape")

    # -- the slice test: int8 (the CLI's default, dynamic scales), then bf16
    tests = {}
    targv = recipe_argv(cfg) + ["--input_path", npy, "--ckpt_dir", exp, "--attn", "flash",
                                "--test_batch_size", str(LOOP_TEST_BATCH)]
    n_batches = math.ceil(10 / LOOP_TEST_BATCH)
    for tag, extra, per in (("int8", [], struct["sample_int8"]),
                            ("bf16", ["--bf16"], struct["sample"])):
        res, counts[f"test {tag}"], seconds[f"test {tag}"] = counted(
            log, lambda: test_cli.main(targv + extra), f"phase 7 test {tag}")
        paths = dict(ops.int8_conv3x3.path_launches)
        want = combine([(n_batches, per)])
        if counts[f"test {tag}"] != want:
            raise AssertionError(f"test {tag} launches {counts[f'test {tag}']} != {want}")
        if paths != {"wgmma": want["int8_conv3x3"], "general": 0}:
            raise AssertionError(f"test {tag}: K4 by path {paths}")
        for kind in ("pred", "gt"):
            names = sorted(os.listdir(res[f"{kind}_dir"]))
            if names != [f"{kind}_{i:05d}.png" for i in range(10)]:
                raise AssertionError(f"test {tag}: {kind} files {names}")
            for i, name in enumerate(names):
                if not np.array_equal(png.read_gray8(os.path.join(res[f"{kind}_dir"], name)),
                                      res[f"{kind}_u8"][i]):
                    raise AssertionError(f"test {tag}: {name} does not read back")
        if res["n_slices"] != 10 or not all(math.isfinite(res[k])
                                            for k in ("psnr", "ssim", "mae")):
            raise AssertionError(f"test {tag}: {res}")
        tests[tag] = {k: v for k, v in res.items() if k not in ("pred_u8", "gt_u8")}
        tests[tag]["k4_path_launches"] = paths

    timings = first["timings"]
    result = {
        "card": card, "phase": "train loop + slice test", "nf": cfg.num_channels_dae,
        "image": IMAGE, "batch": TRAIN_BATCH, "attn": "flash", "lazy_reg": LOOP_LAZY,
        "native_gather": _native.native_available(), "native_build_error": _native.build_error,
        "seconds": seconds,
        "iteration_s_median": float(np.median(timings["iteration_s"])),
        "slices_per_s": TRAIN_BATCH / float(np.median(timings["iteration_s"])),
        "data_wait_share": timings["data_wait_s"] / timings["window_s"],
        "epoch_s": timings["epoch_s"] + resumed["timings"]["epoch_s"],
        "validation_s": timings["val_s"] + resumed["timings"]["val_s"],
        "preview_s": timings["preview_s"] + resumed["timings"]["preview_s"],
        "content_bytes": content_bytes,
        "content_save_s": timings["content_save_s"] + resumed["timings"]["content_save_s"],
        "generators_save_s": timings["generators_save_s"],
        "restore_s": {"loop": resumed["timings"]["restore_s"], "check": seconds["restore"]},
        "max_memory_allocated_bytes": {"train": peak, "resume": peak_resume},
        "r1_steps": first["r1_steps"] + resumed["r1_steps"],
        "history": history, "launch_counts": counts,
        "slice_test": {tag: {"slices_per_s": 10 / seconds[f"test {tag}"],
                             "sample_slices_per_s": 10 / t["seconds"]["sample_s"],
                             "seconds": t["seconds"], "psnr": t["psnr"], "ssim": t["ssim"],
                             "mae": t["mae"], "k4_path_launches": t["k4_path_launches"]}
                       for tag, t in tests.items()},
    }
    print(_json.dumps(result), flush=True)
    totals = combine([(1, c) for c in counts.values()])
    return {"launches": totals, "log": log, "exp_dir": exp, **result}


def write_run_yaml(work: str, npy: str) -> str:
    """A copy of RUN_YAML in ``work`` with only ``data_path`` (phase 7's
    split), ``output_root`` and ``num_epoch`` (RUN_EPOCHS) changed; the
    repo's file is read, never written.  Returns its path."""
    from mudiff_torch.utils import yaml_lite

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), RUN_YAML)
    with open(src) as f:
        text = f.read()
    out = os.path.join(work, "run_results")
    for old, new in (("data_path: /data/BRATS\n", f"data_path: {npy}\n"),
                     ("output_root: ./results\n", f"output_root: {out}\n"),
                     ("    num_epoch: 30\n", f"    num_epoch: {RUN_EPOCHS}\n")):
        if old not in text:
            raise AssertionError(f"{RUN_YAML} no longer holds {old.strip()!r}")
        text = text.replace(old, new)
    path = os.path.join(work, "run.yaml")
    with open(path, "w") as f:
        f.write(text)
    shipped, copy = yaml_lite.load(src), yaml_lite.load(path)
    for a, b in zip(shipped["experiments"], copy["experiments"]):
        if {**a["train_args"], "num_epoch": RUN_EPOCHS} != b["train_args"] or \
                a["test_args"] != b["test_args"]:
            raise AssertionError(f"the copy of {RUN_YAML} changed {a['exp_name']} beyond "
                                 "num_epoch")
    return path


def device_busy_ms(fn) -> float:
    """Device time of one call of ``fn``: the summed durations of its
    device kernels under torch.profiler, CUDA activity alone (cheap to
    collect).  A training iteration makes thousands of launches, more
    than the launch queue holds, so the host cannot run ahead of the
    device for a whole iteration and ``time_ms``'s spin does not hide its
    host time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = sum((evt.time_range.end - evt.time_range.start) / 1e3 for evt in prof.events()
               if evt.device_type == DeviceType.CUDA
               and not getattr(evt, "is_user_annotation", False)
               and not evt.name.startswith("Optimizer."))
    if not busy > 0:
        raise AssertionError("torch.profiler saw no device kernel")
    return busy


def grads_against(tag: str, grads, losses, ref_grads, ref_losses) -> dict:
    """One leg's gradients and losses against its reference leg's, as
    ``compare_iteration`` holds kernels against plain versions (tensors
    whose reference norm is under TINY_GRAD of their group's largest are
    counted, not held), and how many are the same bits."""
    loss_tol, grad_tol = TRAIN_TOL["bf16"]
    out = grad_distance(tag, grads, losses, ref_grads, ref_losses)
    if out["max_loss_rel_err"] > loss_tol or out["max_grad_rel_err"] > grad_tol:
        raise AssertionError(f"remat {tag} vs no remat: loss rel err "
                             f"{out['max_loss_rel_err']:.3g}, grad rel err "
                             f"{out['max_grad_rel_err']:.3g} ({out['worst_tensor']}) beyond "
                             f"{TRAIN_TOL['bf16']}")
    return out


def grad_distance(tag: str, grads, losses, ref_grads, ref_losses) -> dict:
    """``grads_against``'s readings, unchecked: the largest relative loss
    error, the largest relative gradient error over the tensors held, the
    tensors and losses that are the same bits."""
    loss_err = max(abs(losses[k] - v) / max(abs(v), 1e-12) for k, v in ref_losses.items())
    same = sum(int(bool((g == ref_grads[n]).all())) for n, g in grads.items())
    errs, _ = grad_errors(grads, ref_grads)
    worst = max(errs, key=errs.get)
    return {"max_loss_rel_err": loss_err, "max_grad_rel_err": errs[worst],
            "worst_tensor": worst, "tensors_held": len(errs),
            "tensors_bit_identical": same, "tensors": len(grads),
            "losses_bit_identical": sum(losses[k] == v for k, v in ref_losses.items()),
            "losses": len(ref_losses)}


def mesh_step_check(card) -> dict:
    """Phase 13 (a): one D (R1) + G iteration at RUN_YAML's RUN_EXPERIMENT
    width (nf=128, batch 2, remat ``hires``, bf16, flash attention)
    through the mesh's collectives, on an explicit one-rank NCCL group (a
    TCPStore on localhost; no environment), against the same iteration
    without a mesh: the synced gradients and the losses.  Three legs from
    the same weights and draws (plain, mesh, plain again) under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` and
    ``cudnn.deterministic``; every op that warned is printed, beside what
    three controls that PyTorch has flagged give (``histc`` forward,
    ``grid_sample``'s and ``F.interpolate``'s bilinear backward through
    ``autograd.grad``: whether the warnings are caught).  With no
    warning the mesh leg must be the plain leg's bits; else it must lie
    within MESH_FLOOR_FACTOR x the floor the two plain legs give.  The op
    isolated: the G step's resize backward at its shape, RESIZE_REPEATS
    times under the defaults through ``F.interpolate`` (atomics) and
    through ``bilinear_resize`` (matrix products): the distinct results.
    Then MESH_TIMED iterations of each, plain and mesh in turns; then the
    plain one twice apart and MESH_TIMED times under PyTorch's defaults
    with the port's steps (``deterministic_cudnn`` inside them), with
    cuDNN's choice left free (``cudnn_left_free``), and so under the
    deterministic algorithms (which setting makes its bits
    repeat, at what cost): wall medians, and a line with the tensors that
    repeat under each."""
    import socket
    import warnings
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from mudiff_torch import ops
    from mudiff_torch.config import _config_from_yaml, load_experiment
    from mudiff_torch.parallel import init_mesh
    from mudiff_torch.train import TrainDraws, create_train_state, make_d_step, make_g_step
    from mudiff_torch.train import checkpoint as ckpt
    from mudiff_torch.train.steps import bilinear_resize

    doc, exp = load_experiment(RUN_YAML, RUN_EXPERIMENT)
    cfg = _config_from_yaml(exp["train_args"], doc["data_path"], doc["output_root"],
                            RUN_EXPERIMENT, exp["target"])
    shipped = (cfg.num_channels_dae, cfg.batch_size, cfg.use_grad_checkpoint,
               cfg.grad_checkpoint_policy, cfg.use_bf16, cfg.image_size)
    if shipped != (RUN_NF, 2, True, "hires", True, IMAGE):
        raise AssertionError(f"{RUN_YAML}'s {RUN_EXPERIMENT} reads {shipped}")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    store = dist.TCPStore("127.0.0.1", port, 1, True, timeout=timedelta(seconds=120))
    mesh = init_mesh(1, 1, DEVICE, store=store, rank=0, world_size=1)
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    try:
        backend = dist.get_backend()
        plain = create_train_state(cfg, seed=SEED, steps_per_epoch=1000, device=DEVICE,
                                   attn="flash")
        wgen = torch.Generator(DEVICE).manual_seed(SEED + 90)
        for m in ("g1", "g2", "d"):
            randomize_(getattr(plain, m), wgen)
        start = ckpt.content_payload(plain, 0, 0)  # on the CPU
        ours = create_train_state(cfg, seed=SEED, steps_per_epoch=1000, device=DEVICE,
                                  attn="flash", mesh=mesh)
        bgen = torch.Generator(DEVICE).manual_seed(SEED + 91)
        shape = (cfg.batch_size, cfg.image_size, cfg.image_size, 1)
        batch = [torch.randn(shape, generator=bgen, device=DEVICE).tanh() for _ in range(4)]
        dgen = torch.Generator(DEVICE).manual_seed(SEED + 92)
        draws = [TrainDraws.draw(cfg, batch[3], dgen, mesh) for _ in range(2)]
        d_step, g_step = make_d_step(), make_g_step()

        def leg(state):
            """Losses and synced gradients of one iteration from ``start``."""
            ckpt.load_payload(state, start)
            grads, sync = {}, state.sync_grads

            def sync_grads(name, g):
                out = sync(name, g)
                names = [f"{name}.{n}" for n, _ in getattr(state, name).named_parameters()]
                grads.update(zip(names, out))
                return out

            state.sync_grads = sync_grads
            try:
                torch.cuda.synchronize()
                t = time.perf_counter()
                losses = {**d_step(state, batch, draws[0], True),
                          **g_step(state, batch, draws[1])}
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t
            finally:
                del state.sync_grads
            return {k: float(v) for k, v in losses.items()}, grads, seconds

        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False

        def flagged(caught):
            return sorted({str(w.message).splitlines()[0][:240] for w in caught
                           if "deterministic" in str(w.message)})

        x = torch.randn((2, 8, 8, 1), device=DEVICE, requires_grad=True)
        grid = torch.rand((2, 8, 8, 2), device=DEVICE) * 2 - 1
        controls = {
            "histc": lambda: torch.histc(x.detach(), bins=10),
            "grid_sample backward": lambda: torch.autograd.grad(
                F.grid_sample(x.permute(0, 3, 1, 2), grid, align_corners=False).sum(), x),
            "F.interpolate bilinear backward": lambda: torch.autograd.grad(
                F.interpolate(x.permute(0, 3, 1, 2), size=(64, 64), mode="bilinear",
                              align_corners=False).square().sum(), x)}
        control = {}
        for name, fn in controls.items():
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fn()
            control[name] = flagged(caught)
        # the op isolated: the G step's resize of the critic's (B, 32, 32, 1)
        # bf16 map to 256^2, backward RESIZE_REPEATS times under the defaults,
        # through F.interpolate and through bilinear_resize's matrix products
        torch.use_deterministic_algorithms(False)
        resizes = {"F.interpolate": lambda a: F.interpolate(
            a.permute(0, 3, 1, 2), size=(IMAGE, IMAGE), mode="bilinear",
            align_corners=False).permute(0, 2, 3, 1), "bilinear_resize":
            lambda a: bilinear_resize(a, (IMAGE, IMAGE))}
        rgen = torch.Generator(DEVICE).manual_seed(SEED + 93)
        xr = torch.rand((cfg.batch_size, 32, 32, 1), generator=rgen, device=DEVICE)
        xr = xr.to(torch.bfloat16).requires_grad_(True)
        cot = torch.randn((cfg.batch_size, IMAGE, IMAGE, 1), generator=rgen,
                          device=DEVICE).to(torch.bfloat16)
        resize_repeats = {}
        for name, fn in resizes.items():
            outs = [torch.autograd.grad(fn(xr), xr, cot)[0] for _ in range(RESIZE_REPEATS)]
            resize_repeats[name] = {
                "runs": RESIZE_REPEATS,
                "distinct_results": len({o.float().cpu().numpy().tobytes() for o in outs}),
                "max_abs_spread": max(float((o.float() - outs[0].float()).abs().max())
                                      for o in outs)}
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            a_losses, a_grads, a_s = leg(plain)
            k1_log = []
            ops.reset_launch_counts()
            with ops.record_calls(k1_log):
                m_losses, m_grads, m_s = leg(ours)
            k1_path_check("phase 13 mesh step", k1_log)
            k3_path_check("phase 13 mesh step", k1_log)
            b_losses, b_grads, b_s = leg(plain)
        warned = flagged(caught)
        vs_plain = grad_distance("mesh step", m_grads, m_losses, a_grads, a_losses)
        floor = grad_distance("plain step again", b_grads, b_losses, a_grads, a_losses)
        del a_grads, m_grads, b_grads
        timed = {"plain": [], "mesh": []}
        for tag in ("plain", "mesh", "mesh", "plain") * (MESH_TIMED // 2):
            timed[tag].append(leg(plain if tag == "plain" else ours)[2])
        # which setting makes the step deterministic: two plain runs apart,
        # under PyTorch's defaults with the port's steps (cuDNN deterministic
        # inside them) and with cuDNN's choice left free, alone and under the
        # deterministic algorithms
        attribution = {}
        torch.backends.cudnn.deterministic = False
        for tag, free, algorithms in (("the port's defaults", False, False),
                                      ("cuDNN free", True, False),
                                      ("cuDNN free, deterministic algorithms", True, True)):
            torch.use_deterministic_algorithms(algorithms, warn_only=True)
            with cudnn_left_free() if free else contextlib.nullcontext():
                first, second = leg(plain), leg(plain)
                timed[f"plain, {tag}"] = [first[2], second[2]] + [
                    leg(plain)[2] for _ in range(MESH_TIMED - 2)]
            attribution[tag] = grad_distance(tag, second[1], second[0], first[1], first[0])
            del first, second
        result = {"card": card, "phase": "distributed step (NCCL, world size 1)",
                  "backend": backend, "nf": cfg.num_channels_dae, "batch": cfg.batch_size,
                  "remat": cfg.grad_checkpoint_policy, "dtype": "bf16", "attn": "flash",
                  "warned_ops": warned, "control_warned": control,
                  "resize_backward_repeats": resize_repeats,
                  "mesh_vs_plain": vs_plain, "plain_vs_plain_floor": floor,
                  "floor_factor": MESH_FLOOR_FACTOR,
                  "leg_s": {"plain": a_s, "mesh": m_s, "plain again": b_s},
                  "plain_vs_plain_by_setting": attribution, "iteration_s": timed,
                  "iteration_s_median": {k: sorted(v)[len(v) // 2] for k, v in timed.items()}}
        print(json.dumps(result), flush=True)
        print(json.dumps({"card": card, "phase": "determinism of the plain bf16 step",
                          **{tag: f"{a['tensors_bit_identical']} of {a['tensors']} tensors, "
                                  f"{a['losses_bit_identical']} of {a['losses']} losses"
                             for tag, a in attribution.items()}}), flush=True)
        bits = (vs_plain["tensors_bit_identical"] == vs_plain["tensors"]
                and vs_plain["losses_bit_identical"] == vs_plain["losses"])
        if not warned and not bits:
            raise AssertionError("no op warned, yet the mesh step's bits differ from the "
                                 f"plain step's: {vs_plain}")
        for key in ("max_loss_rel_err", "max_grad_rel_err"):
            if vs_plain[key] > MESH_FLOOR_FACTOR * floor[key]:
                raise AssertionError(f"mesh step vs plain step: {key} {vs_plain[key]:.3g} "
                                     f"beyond {MESH_FLOOR_FACTOR} x the plain floor "
                                     f"{floor[key]:.3g}")
        if resize_repeats["bilinear_resize"]["distinct_results"] != 1:
            raise AssertionError("bilinear_resize's backward does not repeat its bits: "
                                 f"{resize_repeats['bilinear_resize']}")
        ours_twice = attribution["the port's defaults"]
        if (ours_twice["tensors_bit_identical"] != ours_twice["tensors"]
                or ours_twice["losses_bit_identical"] != ours_twice["losses"]):
            raise AssertionError("the plain bf16 step does not repeat its bits under the "
                                 f"port's defaults: {ours_twice}")
        return result
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[2:]
        mesh.close()


@contextlib.contextmanager
def cudnn_left_free():
    """The port's training steps with cuDNN's choice of algorithm left
    free: ``steps.deterministic_cudnn`` made a no-op while open (what the
    steps cost and give without it)."""
    from mudiff_torch.train import steps

    saved = steps.deterministic_cudnn
    steps.deterministic_cudnn = contextlib.nullcontext
    try:
        yield
    finally:
        steps.deterministic_cudnn = saved


def torchrun_train(out_path: str, argv) -> int:
    """The process ``mesh_cli_check`` launches with torchrun: the train
    CLI's ``main`` (what ``-m mudiff_torch.cli.train`` runs) with the
    launch counts zeroed before and read after, under the smoke's cuDNN
    settings (phase 7's), and the mesh it joined; all into ``out_path``."""
    import torch
    import torch.distributed as dist

    from mudiff_torch import ops
    from mudiff_torch.cli import train as train_cli

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    joined = {}
    init_mesh = train_cli.init_mesh

    def recording_init_mesh(*a, **k):
        mesh = init_mesh(*a, **k)
        joined.update(backend=dist.get_backend(), rank=mesh.rank, world=mesh.world,
                      dp=mesh.dp, fsdp=mesh.fsdp, device=str(mesh.device))
        return mesh

    train_cli.init_mesh = recording_init_mesh
    log = []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with ops.record_calls(log):
        res = train_cli.main(argv)
    torch.cuda.synchronize()
    with open(out_path, "w") as f:
        json.dump({"launches": ops.launch_counts(), "r1_steps": res["r1_steps"],
                   "k1_path_launches": dict(ops.conv3x3.path_launches),
                   "k1_expected_paths": k1_expected_paths(log),
                   "timings": res["timings"], "exp_dir": res["exp_dir"], "mesh": joined,
                   "torchrun_env": {k: os.environ.get(k) for k in
                                    ("RANK", "LOCAL_RANK", "WORLD_SIZE")}}, f)
    return 0


def mesh_cli_check(cfg, card, work: str, loop: dict) -> dict:
    """Phase 13 (b): ``torchrun --standalone --nproc_per_node=1`` of the
    train CLI on phase 7's split at its recipe (``work``), one epoch,
    counted in the launched process (``torchrun_train``); its
    ``content.pt`` restored and held against the file tensor for tensor;
    then ``--resume`` without torchrun for a second epoch, counted; the
    median iteration beside phase 7's."""
    import numpy as np
    import torch

    from mudiff_torch.cli import train as train_cli
    from mudiff_torch.train import checkpoint as ckpt
    from mudiff_torch.train import create_train_state

    struct = loop_structure(cfg)
    npy, out = os.path.join(work, "npy"), os.path.join(work, "results")
    argv = recipe_argv(cfg) + [
        "--input_path", npy, "--output_path", out, "--exp", "smoke_mesh",
        "--batch_size", str(TRAIN_BATCH), "--lazy_reg", str(LOOP_LAZY), "--log_every", "1",
        "--save_ckpt_every", "1", "--attn", "flash", "--seed", str(SEED)]
    steps, val_batches = 20 // TRAIN_BATCH, math.ceil(10 / TRAIN_BATCH)
    report = os.path.join(work, "torchrun_train.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=1", os.path.abspath(__file__), "--torchrun-train", report,
           *argv, "--num_epoch", "1"]
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=MESH_CLI_TIMEOUT,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    torchrun_s = time.perf_counter() - t
    if proc.returncode:
        raise AssertionError(f"torchrun train exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(report) as f:
        first = json.load(f)
    on_card = DEVICE == "cuda"
    if first["mesh"] != {"backend": "nccl" if on_card else "gloo", "rank": 0, "world": 1,
                         "dp": 1, "fsdp": 1, "device": "cuda:0" if on_card else "cpu"}:
        raise AssertionError(f"torchrun train joined {first['mesh']}")
    want_r1 = [s for s in range(steps) if s % LOOP_LAZY == 0]
    want = combine([(len(want_r1), struct["r1"]), (steps - len(want_r1), struct["no_r1"]),
                    (1 + val_batches, struct["sample"])])
    if first["launches"] != want or first["r1_steps"] != want_r1:
        raise AssertionError(f"torchrun train launches {first['launches']} != structure's "
                             f"{want}; R1 on {first['r1_steps']}")
    print(json.dumps({"run": "torchrun train", "k1_path_launches": first["k1_path_launches"]}),
          flush=True)
    if first["k1_path_launches"] != first["k1_expected_paths"]:
        raise AssertionError(f"torchrun train: K1 by path {first['k1_path_launches']}, its "
                             f"calls' shapes predict {first['k1_expected_paths']}")
    exp = first["exp_dir"]
    tcfg = train_cli.parse_config(argv + ["--num_epoch", "2"], mode="train")[0]
    state = create_train_state(tcfg, seed=SEED + 93, steps_per_epoch=steps, device=DEVICE,
                               attn="flash")
    _, epoch, global_step = ckpt.restore_content(exp, state)
    payload_equal(ckpt.content_payload(state, epoch, global_step), ckpt.load_content(exp))
    if (epoch, global_step, state.step) != (0, steps, steps):
        raise AssertionError(f"torchrun content.pt at epoch {epoch}, step {global_step}")
    del state

    log = []
    resumed, resume_counts, resume_s = counted(
        log, lambda: train_cli.main(argv + ["--num_epoch", "2", "--resume"]))
    want_r1 = [s for s in range(steps, 2 * steps) if s % LOOP_LAZY == 0]
    want = combine([(len(want_r1), struct["r1"]), (steps - len(want_r1), struct["no_r1"]),
                    (1 + val_batches, struct["sample"])])
    if resume_counts != want or resumed["r1_steps"] != want_r1:
        raise AssertionError(f"resume launches {resume_counts} != structure's {want}; "
                             f"R1 on {resumed['r1_steps']}")
    with open(resumed["history"]) as f:
        if [h["epoch"] for h in json.load(f)] != [0, 1]:
            raise AssertionError("the resumed history lacks an epoch")
    median = float(np.median(first["timings"]["iteration_s"]))
    result = {"card": card, "phase": "torchrun train CLI (NCCL, world size 1) + resume",
              "nf": cfg.num_channels_dae, "batch": TRAIN_BATCH, "mesh": first["mesh"],
              "torchrun_env": first["torchrun_env"], "torchrun_s": torchrun_s,
              "resume_s": resume_s, "launches": first["launches"],
              "resume_launches": resume_counts,
              "r1_steps": first["r1_steps"] + resumed["r1_steps"],
              "iteration_s_median": median,
              "iteration_s_median_resume": float(np.median(
                  resumed["timings"]["iteration_s"])),
              "phase7_iteration_s_median": loop["iteration_s_median"],
              "first_iteration_s": first["timings"]["iteration_s"][0]}
    print(json.dumps(result), flush=True)
    return result


def torchrun_test(out_path: str, argv) -> int:
    """The process ``mesh_test_check`` launches with torchrun: the test
    CLI's ``main`` (what ``-m mudiff_torch.cli.test`` runs) under the
    smoke's TF32 settings and ``fixed_cudnn``, with the launch counts
    zeroed before and read after (K1 and K3 by path checked here), the
    mesh it joined and its wall seconds into ``out_path``, and what
    ``sample_and_test`` returned (the predictions and the codes written)
    into ``out_path``.npz.  ``--after FILE`` first in ``argv``: with the
    card initialised, wait until FILE exists (the leg before is done)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from mudiff_torch import ops
    from mudiff_torch.cli import test as test_cli

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if argv[:1] == ["--after"]:
        after, argv = argv[1], argv[2:]
        torch.cuda.init()
        deadline = time.monotonic() + MESH_CLI_TIMEOUT
        while not os.path.exists(after):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{after} was not written")
            time.sleep(0.05)
    joined, sampled = {}, {}
    init_mesh, sample_and_test = test_cli.init_mesh, test_cli.sample_and_test

    def recording_init_mesh(*a, **k):
        mesh = init_mesh(*a, **k)
        joined.update(backend=dist.get_backend(), rank=mesh.rank, world=mesh.world,
                      dp=mesh.dp, fsdp=mesh.fsdp, device=str(mesh.device))
        return mesh

    def recording_sample_and_test(*a, **k):
        sampled.update(sample_and_test(*a, **k))
        return sampled

    test_cli.init_mesh = recording_init_mesh
    test_cli.sample_and_test = recording_sample_and_test
    log = []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with ops.record_calls(log), fixed_cudnn():
        t = time.perf_counter()
        res = test_cli.main(argv)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t
    report = {"launches": ops.launch_counts(),
              "k1_path_launches": k1_path_check("torchrun test", log),
              "k3_path_launches": k3_path_check("torchrun test", log),
              "k4_path_launches": dict(ops.int8_conv3x3.path_launches), "mesh": joined,
              "torchrun_env": {k: os.environ.get(k) for k in
                               ("RANK", "LOCAL_RANK", "WORLD_SIZE")},
              "main_s": main_s, "seconds": res["seconds"], "n_slices": res["n_slices"],
              "batch_size": sampled["batch_size"],
              "metrics": {k: res[k] for k in ("psnr", "ssim", "mae")}}
    np.savez(out_path + ".npz", **{k: sampled[k] for k in ("pred", "pred_u8", "gt_u8")})
    with open(out_path + ".part", "w") as f:
        json.dump(report, f)
    os.replace(out_path + ".part", out_path)  # the next leg waits for this name
    return 0


def mesh_test_check(cfg, card, work: str, loop: dict) -> dict:
    """Phase 13 (c): ``torchrun --standalone --nproc_per_node=1`` of the
    test CLI on phase 7's split and checkpoint (``work``), in its default
    W8A8 mode and with ``--bf16``, counted in the launched processes
    (``torchrun_test``), and held bit for bit against ``sample_and_test``
    in this process at the same seed, all under ``fixed_cudnn``.  Both
    processes start at once and the second samples after the first has
    written its report, so the start-ups overlap and the samplings do
    not; this process samples while they start."""
    import numpy as np
    import torch

    from mudiff_torch.cli.args import parse_config
    from mudiff_torch.infer import sample_and_test

    struct = loop_structure(cfg)
    exp = loop["exp_dir"]
    targv = recipe_argv(cfg) + ["--input_path", os.path.join(work, "npy"), "--ckpt_dir", exp,
                                "--attn", "flash", "--test_batch_size", str(LOOP_TEST_BATCH)]
    legs = (("int8", [], struct["sample_int8"]), ("bf16", ["--bf16"], struct["sample"]))
    reports = {tag: os.path.join(work, f"torchrun_test_{tag}.json") for tag, _, _ in legs}
    procs, after = {}, []
    t0 = time.perf_counter()
    try:
        for tag, extra, _ in legs:
            with open(reports[tag] + ".log", "w") as log:
                procs[tag] = subprocess.Popen(
                    [sys.executable, "-m", "torch.distributed.run", "--standalone",
                     "--nproc_per_node=1", os.path.abspath(__file__), "--torchrun-test",
                     reports[tag], *after, *targv, *extra],
                    stdout=log, stderr=subprocess.STDOUT,
                    cwd=os.path.dirname(os.path.abspath(__file__)))
            after = ["--after", reports[tag]]
        refs, in_process_s = {}, {}
        for tag, extra, _ in legs:
            tcfg, a = parse_config(targv + extra, mode="test")
            torch.cuda.synchronize()
            t = time.perf_counter()
            with fixed_cudnn():
                refs[tag] = sample_and_test(
                    tcfg, ckpt_dir=exp, batch_size=LOOP_TEST_BATCH, seed=tcfg.seed,
                    output_dir=os.path.join(work, f"in_process_test_{tag}"), device=DEVICE,
                    attn=a.attn)
            torch.cuda.synchronize()
            in_process_s[tag] = time.perf_counter() - t
        ended = {}
        for tag, proc in procs.items():
            rc = proc.wait(timeout=max(1.0, MESH_CLI_TIMEOUT - (time.perf_counter() - t0)))
            ended[tag] = time.perf_counter() - t0
            if rc:
                with open(reports[tag] + ".log") as f:
                    raise AssertionError(f"torchrun test {tag} exited {rc}:\n"
                                         f"{f.read()[-6000:]}")
    finally:  # torchrun passes a SIGTERM on to its worker
        for proc in procs.values():
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
    phase_s = time.perf_counter() - t0
    n_batches = math.ceil(10 / LOOP_TEST_BATCH)
    on_card = DEVICE == "cuda"
    out = {}
    for tag, _, per in legs:
        with open(reports[tag]) as f:
            got = json.load(f)
        if got["mesh"] != {"backend": "nccl" if on_card else "gloo", "rank": 0, "world": 1,
                           "dp": 1, "fsdp": 1, "device": "cuda:0" if on_card else "cpu"}:
            raise AssertionError(f"torchrun test {tag} joined {got['mesh']}")
        want = combine([(n_batches, per)])
        need = ["conv3x3", "fir_down2", "fir_up2", "flash_attn"] + (
            ["int8_conv3x3"] if tag == "int8" else [])
        if got["launches"] != want or not all(got["launches"][k] > 0 for k in need):
            raise AssertionError(f"torchrun test {tag} launches {got['launches']} != "
                                 f"structure's {want}")
        if got["k4_path_launches"] != {"wgmma": want["int8_conv3x3"], "general": 0}:
            raise AssertionError(f"torchrun test {tag}: K4 by path {got['k4_path_launches']}")
        if got["batch_size"] != LOOP_TEST_BATCH or got["n_slices"] != 10:
            raise AssertionError(f"torchrun test {tag}: batch {got['batch_size']}, "
                                 f"{got['n_slices']} slices")
        with np.load(reports[tag] + ".npz") as arrays:
            for k in ("pred", "pred_u8", "gt_u8"):
                if not np.array_equal(arrays[k], refs[tag][k]):
                    diff = np.abs(arrays[k].astype(np.float64) - refs[tag][k]).max()
                    raise AssertionError(f"torchrun test {tag}: {k} differs from the "
                                         f"in-process sample_and_test by {diff}")
        out[tag] = {"ended_s": ended[tag], "main_s": got["main_s"], "seconds": got["seconds"],
                    "phase7_sample_s": loop["slice_test"][tag]["seconds"]["sample_s"],
                    "in_process_s": in_process_s[tag], "launches": got["launches"],
                    "k1_path_launches": got["k1_path_launches"],
                    "k3_path_launches": got["k3_path_launches"],
                    "k4_path_launches": got["k4_path_launches"], "metrics": got["metrics"],
                    "bits_equal_in_process": True}
    result = {"card": card, "phase": "torchrun test CLI (NCCL, world size 1) vs in-process",
              "nf": cfg.num_channels_dae, "batch": LOOP_TEST_BATCH, "mesh": got["mesh"],
              "torchrun_env": got["torchrun_env"], "phase_s": phase_s, "legs": out}
    print(json.dumps(result), flush=True)
    return result


def mesh_traffic(cfg) -> dict:
    """Bytes each rank sends in one D (R1) + G iteration on each mesh of
    MESH_SHAPES, worked out from the parameters (fp32) and ``param_spec``
    for ring collectives; not measured (one card).  ``grads``: the fsdp
    reduce-scatter ((F-1)/F of the sharded gradients) and all-reduce of
    the replicated ones (2 (F-1)/F), then the data all-reduce (2 (D-1)/D
    of what a rank then holds); ``params``: the fsdp all-gathers ((F-1)/F
    of a module's sharded bytes for G1, G2 and D before the D step, D
    before the G step, and G1 and G2 after it when EMA is on);
    ``stddev``: one critic pass's feature-map gather over the data group
    (bf16), of which an iteration makes about ten (five forwards, their
    backward's reduce-scatters, R1's)."""
    import torch

    from mudiff_torch.models import DiscriminatorLarge, NCSNppGenerator
    from mudiff_torch.parallel import param_spec

    with torch.device("meta"):
        mods = {"g1": NCSNppGenerator(cfg, device="meta"),
                "g2": NCSNppGenerator(cfg, adaptive=True, device="meta"),
                "d": DiscriminatorLarge(ngf=cfg.ngf, t_emb_dim=cfg.t_emb_dim, device="meta")}
    counts = {n: sum(p.numel() for p in m.parameters()) for n, m in mods.items()}
    total = sum(counts.values())
    rows = []
    for dp, fsdp in MESH_SHAPES:
        sharded = {n: sum(p.numel() for p in m.parameters()
                          if param_spec(p.shape, fsdp) is not None) for n, m in mods.items()}
        shard_b, repl_b = 4 * sum(sharded.values()), 4 * (total - sum(sharded.values()))
        part = (fsdp - 1) / fsdp
        gathered = (sharded["g1"] + sharded["g2"] + 2 * sharded["d"]
                    + (sharded["g1"] + sharded["g2"] if cfg.use_ema else 0))
        rows.append({"dp": dp, "fsdp": fsdp, "sharded_params": sum(sharded.values()),
                     "grad_reduce_scatter_bytes": part * shard_b + 2 * part * repl_b,
                     "grad_all_reduce_bytes": 2 * (dp - 1) / dp * (shard_b / fsdp + repl_b),
                     "param_all_gather_bytes": part * 4 * gathered,
                     "stddev_gather_bytes_per_pass": (dp - 1) / dp * cfg.batch_size * dp
                     * (cfg.image_size // 64) ** 2 * 8 * cfg.ngf * 2})
    return {"nf": cfg.num_channels_dae, "params": counts, "batch_per_rank": cfg.batch_size,
            "use_ema": cfg.use_ema, "per_iteration": rows}


def distributed_phase(cfg, card, work: str, loop: dict) -> dict:
    """Phase 13: the distributed path on the card at world size 1, and
    the collective bytes of larger meshes worked out at nf=64 (phase 7's
    recipe at batch 2) and at RUN_YAML's nf=128."""
    from mudiff_torch.config import _config_from_yaml, load_experiment

    t = time.perf_counter()
    step = mesh_step_check(card)
    cli = mesh_cli_check(cfg, card, work, loop)
    test = mesh_test_check(cfg, card, work, loop)
    doc, exp = load_experiment(RUN_YAML, RUN_EXPERIMENT)
    run_cfg = _config_from_yaml(exp["train_args"], doc["data_path"], doc["output_root"],
                                RUN_EXPERIMENT, exp["target"])
    traffic = [mesh_traffic(cfg.replace(batch_size=TRAIN_BATCH)), mesh_traffic(run_cfg)]
    seconds = time.perf_counter() - t
    print(json.dumps({"card": card, "phase": "distributed", "seconds": seconds,
                      "collective_bytes_worked_out": traffic}), flush=True)
    return {"step": step, "cli": cli, "test": test, "seconds": seconds, "traffic": traffic}


def remat_table(cfg, card, log) -> dict:
    """Phase 8's remat table: each leg of REMAT_LEGS at ``cfg``'s width and
    batch.  Two train states (einsum and flash attention) hold the same
    seeded weights; a leg sets its policy on them (the generators'
    ``remat_regions`` as a generator built for the leg's config selects
    them, and the state's config, which decides the critic's remat).
    First, at the initial weights and the same draws, one D (R1) + G
    iteration per leg, counted (into ``log``) and its gradients held
    against the no-remat leg of its attention, whose own repeat gives the
    run-to-run floor; the counts must exceed the no-remat leg's for every
    kernel the remat recomputes (K1, K2a, K2b; and K3's forward under
    flash).  Then per leg a warm-up, REMAT_ITERS wall-timed iterations (no
    R1; the peak memory above the state's) and REMAT_ITERS profiled ones
    (``device_busy_ms``): wall and device-only medians."""
    import torch

    from mudiff_torch import ops
    from mudiff_torch.models import NCSNppGenerator
    from mudiff_torch.train import TrainDraws, create_train_state, make_train_step

    base = cfg.replace(use_grad_checkpoint=False)
    states = {}
    for attn in ("einsum", "flash"):
        states[attn] = create_train_state(base, seed=SEED, steps_per_epoch=1000, device=DEVICE,
                                          attn=attn)
    wgen = torch.Generator(DEVICE).manual_seed(SEED + 70)
    for m in ("g1", "g2", "d"):
        randomize_(getattr(states["einsum"], m), wgen)
        getattr(states["flash"], m).load_state_dict(getattr(states["einsum"], m).state_dict())
    bgen = torch.Generator(DEVICE).manual_seed(SEED + 71)
    shape = (cfg.batch_size, cfg.image_size, cfg.image_size, 1)
    batch = [torch.randn(shape, generator=bgen, device=DEVICE).tanh() for _ in range(4)]
    dgen = torch.Generator(DEVICE).manual_seed(SEED + 72)
    draws = tuple(TrainDraws.draw(base, batch[3], dgen) for _ in range(2))

    def set_policy(state, policy):
        leg = base if policy is None else base.replace(use_grad_checkpoint=True,
                                                       grad_checkpoint_policy=policy)
        state.config = leg
        with torch.device("meta"):
            for g in (state.g1, state.g2):
                g.remat_regions = NCSNppGenerator(leg, adaptive=g.adaptive,
                                                  device="meta").remat_regions
        return leg

    legs, refs = [], {}
    for tag, policy, attn in REMAT_LEGS:
        state = states[attn]
        leg = set_policy(state, policy)
        start = len(log)
        with ops.record_calls(log):
            losses, grads, counts = iteration_grads(state, batch, draws, plain=False)
        logged = ops.launch_counts()  # the D + G iteration and R1 alone, as ``log``
        k1_path_check(f"remat {tag}", log, start)
        k3_path_check(f"remat {tag}", log, start)
        repeat = None
        if policy is None:  # the floor: the same iteration again, no remat
            r_losses, r_grads, _ = iteration_grads(state, batch, draws, plain=False)
            repeat = grads_against(f"{tag} again", r_grads, r_losses, grads, losses)
            del r_grads
        row = {"leg": tag, "policy": policy or "none", "attn": attn,
               "regions": len(state.g1.remat_regions) + len(state.g2.remat_regions),
               "critic_rematted": leg.use_grad_checkpoint
               and leg.grad_checkpoint_policy == "blocks",
               "launches": counts, "logged_launches": logged}
        if repeat is not None:
            row["repeat_vs_itself"] = repeat
        if policy is None:
            want = state.kernel_launches_per_iteration(with_r1=True)
            if counts != want:
                raise AssertionError(f"remat {tag}: launches {counts} != structure's {want}")
            refs[attn] = (grads, losses, counts)
        else:
            ref_grads, ref_losses, ref_counts = refs[attn]
            row["vs_no_remat"] = grads_against(tag, grads, losses, ref_grads, ref_losses)
            recomputed = ["conv3x3", "fir_down2", "fir_up2"] + (["flash_attn"]
                                                               if attn == "flash" else [])
            fewer = [k for k in recomputed if not counts[k] > ref_counts[k]]
            if fewer:
                raise AssertionError(f"remat {tag}: launches of {fewer} ({counts}) do not "
                                     f"exceed the no-remat leg's ({ref_counts})")
        del grads
        legs.append(row)
    refs.clear()

    tgen = torch.Generator(DEVICE).manual_seed(SEED + 73)
    train_step = make_train_step(base)
    for row in legs:
        state = states[row["attn"]]
        set_policy(state, None if row["policy"] == "none" else row["policy"])
        step = lambda: train_step(state, batch, tgen, with_r1=False)  # noqa: E731
        torch.cuda.synchronize()
        t = time.perf_counter()
        step()  # warm-up: cuDNN picks its algorithms at new shapes
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        walls = []
        for _ in range(REMAT_ITERS):
            t = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated()
        devs = [device_busy_ms(step) for _ in range(REMAT_ITERS)]
        wall = sorted(walls)[len(walls) // 2]
        dev = sorted(devs)[len(devs) // 2]
        row.update({"warmup_s": warm_s, "wall_s": walls, "wall_s_median": wall,
                    "device_ms_median": dev, "device_ms": devs,
                    "idle_share": 1.0 - dev / (1e3 * wall),
                    "peak_bytes": peak, "peak_above_state_bytes": peak - held})
        print(json.dumps({"card": card, "phase": "remat table", **row}), flush=True)
    del states
    table = {"card": card, "phase": "remat table", "nf": cfg.num_channels_dae,
             "image": cfg.image_size, "batch": cfg.batch_size, "dtype": "bf16",
             "iterations": REMAT_ITERS, "legs": [
                 {k: r[k] for k in ("leg", "device_ms_median", "wall_s_median",
                                    "idle_share", "peak_bytes", "peak_above_state_bytes")}
                 | {"launches": {k: r["launches"][k] for k in
                                 ("conv3x3", "fir_down2", "fir_up2", "flash_attn",
                                  "flash_attn_bwd_dkv", "flash_attn_bwd_dq")}}
                 for r in legs]}
    print(json.dumps(table), flush=True)
    return {"legs": legs}


def run_phase(card, work: str) -> dict:
    """Phase 8: the shipped experiment through the port's own CLIs at
    nf=128 on phase 7's split (``work``), then the remat table, under
    PyTorch's default cuDNN settings.  Every CLI run is counted
    (``run_launches``), the table's iterations apart (``remat_launches``)."""
    import torch

    t_phase = time.perf_counter()
    # the CLIs run as a user runs them: PyTorch's defaults (cuDNN picks by
    # heuristic, TF32 in its convs); the smoke's settings come back after
    saved = (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32 = False, True
    try:
        return _run_phase(card, work, t_phase)
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32 = saved


def _run_phase(card, work: str, t_phase: float) -> dict:
    import numpy as np
    import torch

    from mudiff_torch import ops
    from mudiff_torch.cli import calibrate_int8, check_pipeline, metric_calc, \
        predict_volume_wrapper, run
    from mudiff_torch.cli import test as test_cli
    from mudiff_torch.config import _config_from_yaml, load_experiment
    from mudiff_torch.infer import load_generators
    from mudiff_torch.train import checkpoint as ckpt

    npy, raw = os.path.join(work, "npy"), os.path.join(work, "raw")
    path = write_run_yaml(work, npy)
    doc, exp = load_experiment(path, RUN_EXPERIMENT)
    args = (doc["data_path"], doc["output_root"], RUN_EXPERIMENT, exp["target"])
    tcfg = _config_from_yaml(exp["train_args"], *args)
    test_cfg = _config_from_yaml(exp["test_args"], *args)
    shipped = (tcfg.num_channels_dae, tuple(tcfg.ch_mult), tcfg.batch_size,
               tcfg.use_grad_checkpoint, tcfg.grad_checkpoint_policy, tcfg.lazy_reg,
               tcfg.use_bf16, tcfg.image_size, tcfg.num_epoch)
    if shipped != (RUN_NF, (1, 2, 4), 2, True, "hires", 16, True, IMAGE, RUN_EPOCHS):
        raise AssertionError(f"{RUN_YAML}'s {RUN_EXPERIMENT} reads {shipped}")
    log, counts, seconds = [], {}, {}

    # -- pre-flight on the card: deps, CUDA, nvcc, the YAML, the flags, the data
    t = time.perf_counter()
    try:
        check_pipeline.main(["-c", path, "--require-data"])
    except SystemExit as e:
        raise AssertionError(f"check_pipeline failed ({e.code})") from e
    seconds["check_pipeline"] = time.perf_counter() - t

    # -- train one epoch and test, counted
    torch.cuda.reset_peak_memory_stats()
    res, counts["run"], seconds["run"] = counted(
        log, lambda: run.main(["-c", path, "-e", RUN_EXPERIMENT]), "phase 8 run")
    peak = torch.cuda.max_memory_allocated()
    exp_dir = res["exp_dir"]
    timings = res["train"]["timings"]
    files = set(os.listdir(exp_dir))
    need = {"session_metadata.json", "test_metrics.json", ckpt.CONTENT_FILE,
            "gen_diffusive_1.pt", "gen_diffusive_2.pt", "training_history.json",
            "train_config.json", "generated_samples"}
    if not need <= files:
        raise AssertionError(f"run: missing {sorted(need - files)}")
    with open(os.path.join(exp_dir, "test_metrics.json")) as f:
        metrics = json.load(f)
    with open(os.path.join(exp_dir, "session_metadata.json")) as f:
        meta = json.load(f)
    test = res["test"]
    if test["n_slices"] != 10 or not all(math.isfinite(metrics[k])
                                         for k in ("psnr", "ssim", "mae")):
        raise AssertionError(f"run's test: {test['n_slices']} slices, {metrics}")
    if len(timings["iteration_s"]) != 10 * RUN_EPOCHS:
        raise AssertionError(f"run trained {len(timings['iteration_s'])} iterations")
    idle = [k for k in ("conv3x3", "fir_down2", "fir_up2") if not counts["run"][k]]
    if idle or counts["run"]["int8_conv3x3"] or counts["run"]["flash_attn"]:
        raise AssertionError(f"run launches {counts['run']}")

    # -- offline metrics on the run's PNGs: the run's values
    pred_dir, gt_dir = test["pred_dir"], test["gt_dir"]
    t = time.perf_counter()
    offline = metric_calc.main(["--pred_dir", pred_dir, "--gt_dir", gt_dir])
    seconds["metric_calc"] = time.perf_counter() - t
    if any(offline[k] != metrics[k] for k in ("psnr", "ssim", "mae")):
        raise AssertionError(f"metric_calc {offline} != the run's {metrics}")
    t = time.perf_counter()
    offline_rand = metric_calc.main(["--pred_dir", pred_dir, "--gt_dir", gt_dir,
                                     "--lpips_rand"])
    seconds["metric_calc lpips_rand"] = time.perf_counter() - t
    if not math.isfinite(offline_rand["lpips_rand"]):
        raise AssertionError(f"lpips_rand {offline_rand}")

    # -- int8: calibrate, then the test on the sidecars (K4)
    cal, counts["calibrate"], seconds["calibrate"] = counted(
        log, lambda: calibrate_int8.main(["-c", path, "-e", RUN_EXPERIMENT,
                                          "--batches", str(RUN_CALIB_BATCHES)]))
    if not counts["calibrate"]["int8_conv3x3"]:
        raise AssertionError(f"calibrate_int8 launches {counts['calibrate']}")
    g1, g2 = load_generators(test_cfg.replace(use_int8=True), exp_dir, device=DEVICE)
    loaded = {name: {"sites": len(g.int8_calib.sites), "min_ch": g.int8_calib.min_ch}
              for name, g in (("g1", g1), ("g2", g2)) if g.int8_calib is not None}
    del g1, g2
    print(json.dumps({"card": card, "phase": "run: int8 sidecars loaded", "sidecars": loaded,
                      "calibration_batches": cal["indices"]}), flush=True)
    if len(loaded) != 2:
        raise AssertionError("load_generators did not load both sidecars")
    targv = recipe_argv(test_cfg) + ["--input_path", npy, "--ckpt_dir", exp_dir,
                                     "--int8_static", "--test_batch_size", "8"]
    res8, counts["test int8"], seconds["test int8"] = counted(
        log, lambda: test_cli.main(targv), "phase 8 test int8")
    k4_paths = dict(ops.int8_conv3x3.path_launches)
    if not counts["test int8"]["int8_conv3x3"] or \
            k4_paths != {"wgmma": counts["test int8"]["int8_conv3x3"], "general": 0}:
        raise AssertionError(f"int8 test launches {counts['test int8']}, K4 by path {k4_paths}")

    # -- the volume wrapper on one of phase 7's patients
    patient = os.path.join(raw, "BraTS-00000")
    out_dir = os.path.join(work, "wrapper_out")
    vol_path, counts["wrapper"], seconds["wrapper"] = counted(
        log, lambda: predict_volume_wrapper.main(
            ["--patient_dir", patient, "--target_modality", "T1CE", "--config", path,
             "--experiment", RUN_EXPERIMENT, "--ckpt_dir", exp_dir, "--output_dir", out_dir,
             "--slice_half_range", str(WRAPPER_HALF), "--batch_size", "8"]))
    check_volume(vol_path, LOOP_VOLUME, WRAPPER_HALF)
    seconds["clis"] = time.perf_counter() - t_phase

    result = {
        "card": card, "phase": "run (the shipped experiment through the port's CLIs)",
        "yaml": RUN_YAML, "experiment": RUN_EXPERIMENT, "nf": tcfg.num_channels_dae,
        "batch": tcfg.batch_size, "remat": tcfg.grad_checkpoint_policy,
        "epochs": RUN_EPOCHS, "seconds": seconds,
        "iteration_s": timings["iteration_s"],
        "iteration_s_median": float(np.median(timings["iteration_s"])),
        "max_memory_allocated_bytes": peak,
        "content_bytes": os.path.getsize(os.path.join(exp_dir, ckpt.CONTENT_FILE)),
        "content_save_s": timings["content_save_s"], "validation_s": timings["val_s"],
        "test_slices_per_s": test["n_slices"] / test["seconds"]["sample_s"],
        "test_seconds": test["seconds"], "metrics": metrics,
        "metric_calc": offline, "lpips_rand": offline_rand["lpips_rand"],
        "int8_test": {k: res8[k] for k in ("psnr", "ssim", "mae", "n_slices")}
        | {"slices_per_s": res8["n_slices"] / res8["seconds"]["sample_s"],
           "k4_path_launches": k4_paths},
        "session_devices": meta.get("devices"), "launch_counts": counts,
        "cudnn": {"benchmark": torch.backends.cudnn.benchmark,
                  "allow_tf32": torch.backends.cudnn.allow_tf32},
    }
    print(json.dumps(result), flush=True)

    # -- the remat table
    t = time.perf_counter()
    remat_log = []
    table = remat_table(tcfg, card, remat_log)
    seconds["remat_table"] = time.perf_counter() - t
    seconds["phase"] = time.perf_counter() - t_phase
    print(json.dumps({"card": card, "phase": "run", "seconds": seconds}), flush=True)
    remat_counts = combine([(1, r["logged_launches"]) for r in table["legs"]])
    return {"launches": combine([(1, c) for c in counts.values()]), "log": log,
            "remat_launches": remat_counts, "remat_log": remat_log, "table": table,
            **result}


# Device kernels of a request, grouped by the first group one of whose
# marks occurs in the kernel's lower-cased name.
# Phase 14: the generator branches off the recipe, at the recipe's serving
# width (brats_recipe(nf=64), 256², ch_mult (1, 2, 4), two resblocks a
# level), with seeded non-trivial weights.  B1 and B2 serve and train; B3
# (three-channel images, two conditions: no sampler takes it) runs G1 + G2
# forwards; the train and test CLIs run with B1's flags on phase 7's split.
BRANCHES = {
    "B1 pyramid": dict(resblock_type="biggan_oneadagn", progressive="output_skip",
                       progressive_input="input_skip", progressive_combine="sum"),
    "B2 ddpm": dict(resblock_type="ddpm", progressive="residual",
                    progressive_input="residual"),
}
B3 = dict(resblock_type="ddpm", fir=False, embedding_type="fourier", num_channels=3)
B3_STEPS = (1, 2, 3)  # the Fourier embedding reads log(t): NaN at t = 0
# The branch samples through the kernels vs the plain versions (max abs in
# [-1, 1] units), each limit 1.5x the largest sound reading of
# ``volume_drift.py --branch`` over seeds 0-2 and below its smallest
# reading of a K1 fault that drops tap (0, 0) of the Cout = 1 convs
# (NVIDIA H100 80GB HBM3, 700.00 W).  Sound, then that fault: bf16 (bf16
# scores) B1 0.050-0.072 vs 0.658, B2 0.033-0.037 vs 0.512; W8A8 dynamic
# B1 0.165-0.321 vs 0.638, B2 0.098-0.135 vs 0.538.  Scaling those
# convs' weights by 1.08 reads 0.078-0.114 (B1) and 0.066-0.081 (B2) in
# bf16, within B1's sound spread: no limit separates it there.  All of
# the drift is K1's (K1 alone reads the same, K4 alone 0.0), and it is
# not the pyramid's: K1 at B1's three Cout = 1 (output pyramid) convs
# alone reads 0.049-0.073 (int8 0.163-0.282), K1 at every other conv
# 0.046-0.064 (int8 0.157-0.229).  K4 is held apart: the int8 sample with
# K4 alone through its kernel must be the plain versions' bits.
BRANCH_TOL = {"B1 pyramid": {"sample": 0.108, "int8": 0.482},
              "B2 ddpm": {"sample": 0.056, "int8": 0.202}}
# (class, image side, channels, batch): DDGAN's CIFAR-10 critic and the
# image-only large critic at the recipe's image, both at ngf CRITIC_NGF
CRITICS = (("DiscriminatorSmall", 32, 3, 64), ("DiscriminatorImgLarge", IMAGE, 1, BATCH))
CRITIC_NGF = 64


def branch_training_inputs(cfg, seed: int = SEED):
    """Phase 14's training inputs at ``cfg``: a train state whose G1, G2
    and D are randomized from ``seed`` + 84, the batch, and that
    generator, which then draws the rest."""
    import torch

    from mudiff_torch.train import create_train_state

    state = create_train_state(cfg, seed=seed, device=DEVICE, attn="flash")
    tgen = torch.Generator(DEVICE).manual_seed(seed + 84)
    for module in (state.g1, state.g2, state.d):
        randomize_(module, tgen)
    batch = [torch.randn((TRAIN_BATCH, IMAGE, IMAGE, 1), generator=tgen,
                         device=DEVICE).tanh() for _ in range(4)]
    return state, batch, tgen


def branch_phase(card, work: str) -> dict:
    """Phase 14: B1 and B2 through ``build_sampler`` (three counted batch-4
    requests, --attn flash; the sample against the plain versions at the
    main path's bf16-score attention within BRANCH_TOL and with flash
    within BF16_VOLUME_TOL; one counted W8A8 dynamic request at bf16-score
    attention within BRANCH_TOL, and with K4 alone the plain bits; one
    profiled request) and through training (one counted bf16
    ``make_train_step`` iteration with R1, then one D (R1) + G iteration
    against the plain versions in bf16 and in fp32, ``compare_iteration``);
    B3's G1 + G2 forwards at t in B3_STEPS against the plain versions; the two
    critics' forward and R1 gradient-of-gradient (K2a, K2b) against the
    plain versions; the train CLI for one epoch with B1's flags on phase
    7's split (``work``) and the test CLI on its checkpoint.  Every run is
    counted against the module structure (``branch_launches``)."""
    import torch

    from mudiff_torch import brats_recipe, build_sampler, models, ops
    from mudiff_torch.cli import test as test_cli
    from mudiff_torch.cli import train as train_cli
    from mudiff_torch.cli.args import parse_config
    from mudiff_torch.train import TrainDraws, make_train_step

    t_phase = time.perf_counter()
    base = brats_recipe(num_channels_dae=NF, image_size=IMAGE)
    zero = dict.fromkeys(ops.KERNEL_WRAPPERS, 0)
    log, launches, report = [], {}, {}

    def count(tag, fn, want):
        out, got, seconds = counted(log, fn, f"phase 14 {tag}")
        launches[tag] = got
        if got != {**zero, **want}:
            raise AssertionError(f"{tag}: launches {got} != structure's {want}")
        return out, seconds

    cgen = torch.Generator(DEVICE).manual_seed(SEED + 80)
    requests = [conditions(cgen, DEVICE) for _ in range(REQUESTS)]
    zgen = torch.Generator(DEVICE).manual_seed(SEED + 81)
    x_init = torch.randn((BATCH, IMAGE, IMAGE, 1), generator=zgen, device=DEVICE)
    noise = [(torch.randn((BATCH, base.nz), generator=zgen, device=DEVICE),
              torch.randn((BATCH, IMAGE, IMAGE, 1), generator=zgen, device=DEVICE))
             for _ in range(base.num_timesteps)]

    for name, over in BRANCHES.items():
        cfg = base.replace(**over)
        t0 = time.perf_counter()
        wgen = torch.Generator(DEVICE).manual_seed(SEED + 82)
        s = build_sampler(cfg, device=DEVICE, attn="flash",
                          generator=torch.Generator().manual_seed(SEED))
        randomize_(s.g1, wgen)
        randomize_(s.g2, wgen)

        def with_weights(other):
            other.g1.load_state_dict(s.g1.state_dict())
            other.g2.load_state_dict(s.g2.state_dict())
            return other

        ngen = torch.Generator(DEVICE).manual_seed(SEED + 83)

        def serve():
            outs, secs = [], []
            for conds in requests:
                t = time.perf_counter()
                outs.append(s(*conds, generator=ngen))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
            return outs, secs

        (outs, request_s), _ = count(f"{name} requests", serve,
                                     combine([(REQUESTS, s.kernel_launches_per_sample())]))
        for out in outs:
            if out.shape != (BATCH, IMAGE, IMAGE, 1) or not torch_isfinite(out) \
                    or float(out.std()) < 1e-2:
                raise AssertionError(f"{name}: bad sample {tuple(out.shape)}")
        diffs = {}
        plain_attn = with_weights(build_sampler(cfg, device=DEVICE, attn="bf16"))
        _, diffs["bf16_attn"], _ = sample_vs_plain(f"{name} bf16", plain_attn, requests[0],
                                                   x_init, noise, BRANCH_TOL[name]["sample"])
        del plain_attn
        _, diffs["flash_attn"], _ = sample_vs_plain(f"{name} flash", s, requests[0], x_init,
                                                    noise, BF16_VOLUME_TOL)
        # W8A8 at the int8 leg's attention (bf16 scores), as it holds the recipe
        s8 = with_weights(build_sampler(cfg.replace(use_int8=True), device=DEVICE))
        (out8,), _ = count(f"{name} int8 request",
                           lambda: [s8(*requests[0], generator=ngen)],
                           s8.kernel_launches_per_sample())
        paths = dict(ops.int8_conv3x3.path_launches)
        if paths != {"wgmma": launches[f"{name} int8 request"]["int8_conv3x3"], "general": 0} \
                or not paths["wgmma"]:
            raise AssertionError(f"{name} int8: K4 by path {paths}")
        if not torch_isfinite(out8) or float(out8.std()) < 1e-2:
            raise AssertionError(f"{name}: bad int8 sample")
        _, diffs["int8_dynamic"], _ = sample_vs_plain(f"{name} int8", s8, requests[0], x_init,
                                                      noise, BRANCH_TOL[name]["int8"])
        with ops.plain_kernels():
            ref8 = s8(*requests[0], x_init=x_init, noise=noise)
        with kernels_only("int8_conv3x3"):
            diffs["int8_k4_alone"] = float((s8(*requests[0], x_init=x_init, noise=noise)
                                            - ref8).abs().max())
        if diffs["int8_k4_alone"] != 0.0:
            raise AssertionError(f"{name} int8 sample, K4 alone vs plain: "
                                 f"{diffs['int8_k4_alone']}")
        del s8, ref8
        best = best_of(lambda: s(*requests[0], generator=ngen), 2)
        prof = profile_request(s, requests[0], ngen)
        prof["idle_share_of_best_request"] = 1.0 - prof["device_busy_ms"] / (1e3 * best)
        del s

        state, batch, tgen = branch_training_inputs(cfg)
        with fixed_cudnn():  # Adam's first step is sign(g): a flipped bit moves a weight
            metrics, iteration_s = count(
                f"{name} training iteration",
                lambda: make_train_step(cfg)(state, batch, generator=tgen, with_r1=True),
                state.kernel_launches_per_iteration(with_r1=True))
        if not all(math.isfinite(float(v)) for v in metrics.values()):
            raise AssertionError(f"{name}: a training loss is not finite: {metrics}")
        draws = tuple(TrainDraws.draw(cfg, batch[3], tgen) for _ in range(2))
        state32, exact, exact_mask = fp32_reference(cfg, state, batch, draws)
        compared = {"bf16": compare_iteration("bf16", state, batch, draws, exact, exact_mask)}
        del state
        compared["fp32"] = compare_iteration("fp32", state32, batch, draws, exact, exact_mask)
        del state32, exact, exact_mask
        report[name] = {
            "config": over, "request_s": request_s, "best_request_s": best,
            "slices_per_s": BATCH / best, "device_busy_ms": prof["device_busy_ms"],
            "idle_share": prof["idle_share"],
            "idle_share_of_best_request": prof["idle_share_of_best_request"],
            "device_ms_by_group": prof["device_ms_by_group"],
            "sample_kernel_vs_plain_max_abs": diffs,
            "tolerance": {**BRANCH_TOL[name], "flash": BF16_VOLUME_TOL},
            "training_iteration_s": iteration_s,
            "training_vs_plain": {tag: {k: r[k] for k in (
                "max_loss_rel_err", "worst_loss", "G_mask_rel_err", "max_grad_rel_err",
                "worst_tensor", "nearest_its_limit", "tensors_above_tol",
                "kernels_vs_fp32_plain", "plain_vs_fp32_plain", "mask_vs_plain",
                "mask_plain_vs_fp32_plain", "mask_ratio", "tolerance")}
                for tag, r in compared.items()},
            "seconds": time.perf_counter() - t0}
        print(json.dumps({"card": card, "phase": "model branches", name: report[name]}),
              flush=True)

    # -- B3: three-channel images, two conditions, Fourier, naive resampling
    t0 = time.perf_counter()
    cfg3 = base.replace(**B3)
    wgen = torch.Generator(DEVICE).manual_seed(SEED + 85)
    g1, g2 = (models.NCSNppGenerator(cfg3, adaptive=a, num_conditions=2, attn="flash",
                                     dtype=torch.bfloat16, device=DEVICE).eval()
              for a in (False, True))
    randomize_(g1, wgen)
    randomize_(g2, wgen)
    shape3 = (BATCH, IMAGE, IMAGE, cfg3.num_channels)
    x3, c1, c2 = (torch.randn(shape3, generator=wgen, device=DEVICE).tanh() for _ in range(3))
    z3 = torch.randn((BATCH, cfg3.nz), generator=wgen, device=DEVICE)

    def forwards(steps):
        outs = []
        for step in steps:
            t = torch.full((BATCH,), step, dtype=torch.int64, device=DEVICE)
            x0_1 = g1(x3, c1, c2, None, t, z3)
            outs += [x0_1, g2(x3, c1, c2, None, t, z3, x0_1)]
        return outs

    with torch.no_grad():
        got, _ = count("B3 forwards", lambda: forwards(B3_STEPS),
                       combine([(len(B3_STEPS), g1.kernel_launches_per_forward()),
                                (len(B3_STEPS), g2.kernel_launches_per_forward())]))
        with ops.plain_kernels():
            want = forwards(B3_STEPS)
        at_t0 = g1(x3, c1, c2, None, torch.zeros((BATCH,), dtype=torch.int64, device=DEVICE),
                   z3)
        emb_t0 = g1.fourier_emb(torch.log(torch.zeros((BATCH,), device=DEVICE)))
    b3_diff = max(float((a - b).abs().max()) for a, b in zip(got, want))
    if not all(torch_isfinite(a) and a.shape == shape3 for a in got) \
            or not b3_diff <= SAMPLE_TOL["bf16"]:
        raise AssertionError(f"B3 forwards, kernels vs plain: {b3_diff}")
    report["B3 naive"] = {
        "config": B3, "num_conditions": 2, "t": list(B3_STEPS),
        "forward_kernel_vs_plain_max_abs": b3_diff, "tolerance": SAMPLE_TOL["bf16"],
        "t0_embedding_nonfinite": int((~torch.isfinite(emb_t0)).sum()),
        "t0_embedding_lanes": emb_t0.numel(),
        "t0_g1_output_nonfinite": int((~torch.isfinite(at_t0)).sum()),
        "seconds": time.perf_counter() - t0}
    print(json.dumps({"card": card, "phase": "model branches", "B3 naive": report["B3 naive"]}),
          flush=True)
    del g1, g2, got, want, at_t0

    # -- the two critics: forward and R1's gradient of a gradient
    t0 = time.perf_counter()
    report["critics"] = {}
    for cname, side, c, b in CRITICS:
        d = getattr(models, cname)(ngf=CRITIC_NGF, t_emb_dim=256, num_channels=c,
                                   dtype=torch.bfloat16, device=DEVICE)
        randomize_(d, wgen)
        x, xt = (torch.randn((b, side, side, c), generator=wgen, device=DEVICE).tanh()
                 for _ in range(2))
        t = torch.randint(0, base.num_timesteps, (b,), generator=wgen, device=DEVICE)
        names = [f"d.{n}" for n, _ in d.named_parameters()]
        params = list(d.parameters())

        def r1():
            xs = x.clone().requires_grad_(True)
            (gx,) = torch.autograd.grad(d(xs, t, xt).float().sum(), xs, create_graph=True)
            penalty = gx.float().reshape(b, -1).square().sum(dim=1).mean()
            grads = torch.autograd.grad(penalty, params, allow_unused=True)
            return penalty, {n: torch.zeros_like(p) if g is None else g
                             for n, p, g in zip(names, params, grads)}

        n = d.kernel_launches_per_forward()["fir_down2"]
        with torch.no_grad():
            logit, _ = count(f"{cname} forward", lambda: d(x, t, xt), {"fir_down2": n})
        (pen, grads), _ = count(f"{cname} R1", r1, {"fir_down2": 2 * n, "fir_up2": 2 * n})
        with ops.plain_kernels():
            with torch.no_grad():
                logit_p = d(x, t, xt)
            pen_p, grads_p = r1()
        logit_err = float((logit.float() - logit_p.float()).abs().max()) / max(
            float(logit_p.float().abs().max()), 1e-12)
        pen_err = abs(float(pen.detach()) - float(pen_p.detach())) / max(
            abs(float(pen_p.detach())), 1e-12)
        grad_err = max(grad_errors(grads, grads_p)[0].values())
        loss_tol, grad_tol = TRAIN_TOL["bf16"]
        report["critics"][cname] = {
            "image": side, "channels": c, "batch": b, "logit_shape": list(logit.shape),
            "logit_rel_err": logit_err, "r1_rel_err": pen_err, "r1_grad_rel_err": grad_err,
            "tolerance": TRAIN_TOL["bf16"]}
        if not (logit_err <= loss_tol and pen_err <= loss_tol and grad_err <= grad_tol) \
                or not torch_isfinite(pen):
            raise AssertionError(f"{cname} kernels vs plain: {report['critics'][cname]}")
        del d, grads, grads_p
    report["critics"]["seconds"] = time.perf_counter() - t0

    # -- the train CLI with B1's flags on phase 7's split, then the test CLI
    t0 = time.perf_counter()
    b1 = base.replace(**BRANCHES["B1 pyramid"])
    flags = [a for k, v in BRANCHES["B1 pyramid"].items() for a in (f"--{k}", str(v))]
    npy = os.path.join(work, "npy")
    argv = recipe_argv(base) + flags + [
        "--input_path", npy, "--output_path", os.path.join(work, "branch_results"),
        "--exp", "branch", "--batch_size", str(TRAIN_BATCH), "--lazy_reg", str(LOOP_LAZY),
        "--log_every", "1", "--save_ckpt_every", "1", "--attn", "flash",
        "--seed", str(SEED), "--num_epoch", "1"]
    tcfg = parse_config(argv, mode="train")[0]
    if any(getattr(tcfg, k) != v for k, v in BRANCHES["B1 pyramid"].items()):
        raise AssertionError(f"the train CLI's config is not B1's: {tcfg}")
    struct = loop_structure(b1)
    steps = 20 // TRAIN_BATCH
    r1_steps = [i for i in range(steps) if i % LOOP_LAZY == 0]
    res, train_s = count("B1 train CLI", lambda: train_cli.main(argv), combine(
        [(len(r1_steps), struct["r1"]), (steps - len(r1_steps), struct["no_r1"]),
         (1 + math.ceil(10 / TRAIN_BATCH), struct["sample"])]))
    if res["r1_steps"] != r1_steps:
        raise AssertionError(f"B1 train CLI: R1 on {res['r1_steps']}")
    targv = recipe_argv(base) + flags + ["--input_path", npy, "--ckpt_dir", res["exp_dir"],
                                         "--attn", "flash",
                                         "--test_batch_size", str(LOOP_TEST_BATCH)]
    tres, test_s = count("B1 test CLI", lambda: test_cli.main(targv),
                         combine([(math.ceil(10 / LOOP_TEST_BATCH), struct["sample_int8"])]))
    if tres["n_slices"] != 10 or not all(math.isfinite(tres[k]) for k in ("psnr", "ssim",
                                                                           "mae")):
        raise AssertionError(f"B1 test CLI: {tres}")
    report["cli"] = {"flags": flags, "train_s": train_s, "test_s": test_s,
                     "iteration_s_median": sorted(res["timings"]["iteration_s"])[
                         len(res["timings"]["iteration_s"]) // 2],
                     "test": {k: tres[k] for k in ("psnr", "ssim", "mae", "n_slices")},
                     "seconds": time.perf_counter() - t0}

    totals = combine([(1, c) for c in launches.values()])
    idle = [k for k in ops.KERNEL_WRAPPERS if not totals[k]]
    if idle:
        raise AssertionError(f"the branch phase never launched {idle}")
    report["launch_counts"] = launches
    report["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"card": card, "phase": "model branches",
                      **{k: v for k, v in report.items() if not k.startswith("B")}}),
          flush=True)
    return {"launches": totals, "log": log, **report}


def phantom_phase(card, work: str) -> dict:
    """Phase 15: the phantom quality protocol's tools through the port's
    CLIs on a tiny set, under PyTorch's default cuDNN settings (as phase
    8): ``python -m mudiff_torch.data.phantom`` (PHANTOM_PATIENTS patients
    of PHANTOM_DEPTH slices at IMAGE), ``run -e flagship64 --train-only``
    on ``phantom_quality.write_yaml``'s copy of the YAML for
    PHANTOM_EPOCHS epoch (one iteration at batch 8, then its validation
    and preview), ``calibrate_int8`` and ``ab_int8_quality`` in each of
    the three modes (einsum attention, ``--lpips_rand``).  Every run is
    counted (``phantom_launches``) against the module structure (K4 on its
    fused path only); each leg's PNG pairs and finite metrics."""
    import torch

    saved = (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32 = False, True
    try:
        return _phantom_phase(card, work)
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32 = saved


def _phantom_phase(card, work: str) -> dict:
    from mudiff_torch import ops
    from mudiff_torch.cli import ab_int8_quality, calibrate_int8, run
    from mudiff_torch.config import _config_from_yaml, load_experiment
    from mudiff_torch.data import phantom
    from phantom_quality import write_yaml

    t_phase = time.perf_counter()
    root = os.path.join(work, "phantom")
    npy = os.path.join(root, "npy")
    log, launches, seconds, k4_paths = [], {}, {}, {}
    zero = dict.fromkeys(ops.KERNEL_WRAPPERS, 0)

    def count(tag, fn, want):
        out, got, seconds[tag] = counted(log, fn, f"phase 15 {tag}")
        launches[tag] = got
        if want is not None and got != {**zero, **want}:
            raise AssertionError(f"phase 15 {tag}: launches {got} != structure's {want}")
        if got["int8_conv3x3"]:
            k4_paths[tag] = dict(ops.int8_conv3x3.path_launches)
            if k4_paths[tag] != {"wgmma": got["int8_conv3x3"], "general": 0}:
                raise AssertionError(f"phase 15 {tag}: K4 by path {k4_paths[tag]}")
        return out

    t = time.perf_counter()
    split = phantom.main(["--output_dir", npy, "--n_patients", str(PHANTOM_PATIENTS),
                          "--image_size", str(IMAGE), "--slices", str(PHANTOM_DEPTH),
                          "--seed", str(SEED)])
    seconds["phantom"] = time.perf_counter() - t
    if split != PHANTOM_SPLIT:
        raise AssertionError(f"phantom split {split} != {PHANTOM_SPLIT}")
    path = write_yaml(root, npy, seed=1024, resume=False, epochs=PHANTOM_EPOCHS)
    doc, exp = load_experiment(path, PHANTOM_EXPERIMENT)
    args = (doc["data_path"], doc["output_root"], PHANTOM_EXPERIMENT, exp["target"])
    tcfg = _config_from_yaml(exp["train_args"], *args)
    test_cfg = _config_from_yaml(exp["test_args"], *args)
    shipped = (tcfg.num_channels_dae, tcfg.batch_size, tcfg.use_grad_checkpoint,
               tcfg.use_bf16, tcfg.image_size, tcfg.num_epoch, test_cfg.num_channels_dae)
    if shipped != (NF, 8, False, True, IMAGE, PHANTOM_EPOCHS, NF):
        raise AssertionError(f"{PHANTOM_EXPERIMENT} reads {shipped}")

    # -- one epoch of one iteration (R1 on step 0), its validation and preview
    struct = loop_structure(tcfg, "einsum")
    res = count("run", lambda: run.main(["-c", path, "-e", PHANTOM_EXPERIMENT,
                                         "--train-only"]),
                combine([(1, struct["r1"]), (2, struct["sample"])]))
    if len(res["train"]["timings"]["iteration_s"]) != 1 or res["train"]["r1_steps"] != [0]:
        raise AssertionError(f"run trained {res['train']['timings']['iteration_s']}, "
                             f"R1 on {res['train']['r1_steps']}")
    exp_dir = res["exp_dir"]
    need = {"content.pt", "gen_diffusive_1.pt", "gen_diffusive_2.pt",
            "training_history.json"}
    if not need <= set(os.listdir(exp_dir)):
        raise AssertionError(f"run: missing {sorted(need - set(os.listdir(exp_dir)))}")

    # -- the static calibration (the CLI's defaults: one batch of the 2 val slices)
    cal = count("calibrate", lambda: calibrate_int8.main(["-c", path, "-e",
                                                          PHANTOM_EXPERIMENT]), None)
    if not launches["calibrate"]["int8_conv3x3"]:
        raise AssertionError(f"calibrate_int8 launches {launches['calibrate']}")
    sites = [len(c.sites) for c in cal["calibs"]]

    # -- the A/B, one mode a call, so each leg is counted apart
    rows = {}
    for mode in ab_int8_quality.MODES:
        cfg = test_cfg.replace(use_int8=mode != "bf16")
        want = structure_launches(cfg, "einsum")  # one batch of 8: the 2 test slices
        out = count(mode, lambda: ab_int8_quality.main(
            ["-c", path, "-e", PHANTOM_EXPERIMENT, "--out", os.path.join(root, "ab"),
             "--modes", mode, "--lpips_rand"]), want)[PHANTOM_EXPERIMENT]
        row, dirs = out["ab"][mode], out["dirs"][mode]
        pngs = [sorted(f for f in os.listdir(dirs[k]) if f.endswith(".png"))
                for k in ("pred_dir", "gt_dir")]
        if [len(p) for p in pngs] != [PHANTOM_SPLIT["test"]] * 2:
            raise AssertionError(f"ab {mode}: PNG pairs {pngs}")
        if not all(math.isfinite(v) for v in row.values()) or "lpips_rand" not in row:
            raise AssertionError(f"ab {mode}: {row}")
        if any(not launches[mode][k] for k in ("conv3x3", "fir_down2", "fir_up2")) or \
                bool(launches[mode]["int8_conv3x3"]) != (mode != "bf16"):
            raise AssertionError(f"ab {mode}: launches {launches[mode]}")
        rows[mode] = row
    totals = combine([(1, c) for c in launches.values()])
    seconds["phase"] = time.perf_counter() - t_phase
    report = {"card": card, "phase": "phantom protocol tools", "split": split,
              "experiment": PHANTOM_EXPERIMENT, "epochs": PHANTOM_EPOCHS,
              "calibration_sites": sites, "ab": rows, "launch_counts": launches,
              "k4_path_launches": k4_paths, "seconds": seconds}
    print(json.dumps(report), flush=True)
    return {"launches": totals, "log": log, **report}


PROFILE_GROUPS = (
    ("K1 conv3x3", ("conv3x3_kernel",)),
    ("K2a fir_down2", ("fir_down2_kernel",)),
    ("K2b fir_up2", ("fir_up2_kernel",)),
    ("K3 flash_attn", ("flash_attn_kernel",)),
    ("K3 bwd dkv", ("flash_attn_bwd_dkv_kernel",)),
    ("K3 bwd dq", ("flash_attn_bwd_dq_kernel",)),
    ("K4 int8_conv3x3", ("s8wgmma", "s8conv", "absmax_kernel", "quantize_kernel")),
    ("optimizer (Adam, EMA)", ("adam", "multi_tensor", "foreach")),
    ("copies and casts", ("copy", "memcpy", "memset")),
    ("reductions (GroupNorm statistics, means)", ("reduce_kernel",)),
    ("softmax", ("softmax",)),
    ("cuDNN / native conv (pyramid, critic, K1's dw)",
     ("fprop", "wgrad", "dgrad", "conv", "cudnn", "xmma")),
    ("matmul (attention, dense, 1x1)", ("gemm", "cutlass", "nvjet")),
    ("elementwise", ("elementwise",)),
)


def profile_request(sampler, conds, generator) -> dict:
    """One request under torch.profiler (``profile_call``)."""
    return profile_call(lambda: sampler(*conds, generator=generator))


def profile_call(fn) -> dict:
    """One call of ``fn`` under torch.profiler: device time by kernel and
    the device's idle share of the call's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name = {}
    for evt in prof.events():
        # device kernels only: a user range on the device's timeline (the
        # optimizer's "Optimizer.step#Adam.step") would count its kernels twice
        if (evt.device_type == DeviceType.CUDA and not getattr(evt, "is_user_annotation", False)
                and not evt.name.startswith("Optimizer.")):
            us = evt.time_range.end - evt.time_range.start
            by_name[evt.name] = by_name.get(evt.name, 0.0) + us / 1e3
    by_group = {}
    for kname, ms in by_name.items():
        group = next((g for g, marks in PROFILE_GROUPS
                      if any(m in kname.lower() for m in marks)), "other")
        by_group[group] = by_group.get(group, 0.0) + ms
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    k4_parts = {}
    for kname, ms in by_name.items():
        if any(m in kname.lower() for m in dict(PROFILE_GROUPS)["K4 int8_conv3x3"]):
            k4_parts[k4_part(kname)] = k4_parts.get(k4_part(kname), 0.0) + ms
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "k4_parts_ms": k4_parts,
            "idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
            "device_ms_by_group": dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
            "distinct_device_kernels": len(by_name),
            "top_device_ms": [[kname[:80], ms] for kname, ms in top]}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--torchrun-train"]:  # phase 13's processes under torchrun
        return torchrun_train(argv[1], argv[2:])
    if argv[:1] == ["--torchrun-test"]:
        return torchrun_test(argv[1], argv[2:])
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write per-shape rows and the nvcc log here")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's serving path runs on the card",
              file=sys.stderr)
        return 2
    from mudiff_torch import brats_recipe, build_sampler, ops
    from mudiff_torch.ops import _build

    # The plain versions are the references: full fp32, no TF32.  cuDNN
    # picks its fastest algorithm per shape, so no library time or plain
    # time rests on a poor heuristic choice.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True

    card = card_line()
    name = torch.cuda.get_device_name(0)
    variant, peaks = peaks_for(name)
    print(card, flush=True)

    t0 = time.perf_counter()
    built = _build.build()
    build = {"build_s": time.perf_counter() - t0,
             "per_library_s": {k: v["seconds"] for k, v in built.items()},
             "k4_gmma_instructions": sass_count(_build.library_path("int8_conv"), "GMMA"),
             "k1_gmma_instructions": sass_count(_build.library_path("conv3x3"), "GMMA"),
             "k3_gmma_instructions": sass_count(_build.library_path("flash_attn"), "GMMA"),
             "k3_bwd_gmma_instructions": sass_count(_build.library_path("flash_attn_bwd"),
                                                    "GMMA")}
    print(json.dumps(build), flush=True)
    for k in ("K4", "K1", "K3", "K3_bwd"):
        if not build[f"{k.lower()}_gmma_instructions"]:
            raise AssertionError(f"{k}'s library holds no GMMA (wgmma) instruction")

    cfg = brats_recipe(num_channels_dae=NF, image_size=IMAGE)
    sampler = build_sampler(cfg, device=DEVICE, generator=torch.Generator().manual_seed(SEED))
    wgen = torch.Generator(DEVICE).manual_seed(SEED)
    randomize_(sampler.g1, wgen)
    randomize_(sampler.g2, wgen)

    # -- the main path: three requests, counted ------------------------------
    cgen = torch.Generator(DEVICE).manual_seed(SEED + 10)
    requests = [conditions(cgen, DEVICE) for _ in range(REQUESTS)]
    ngen = torch.Generator(DEVICE).manual_seed(SEED + 20)
    log, outs, seconds = [], [], []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with ops.record_calls(log):
        for conds in requests:
            t = time.perf_counter()
            outs.append(sampler(*conds, generator=ngen))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t)
    launches = ops.launch_counts()
    k1_path_check("main path", log)
    k3_path_check("main path", log)
    k5_paths = dict(ops.group_norm_act.path_launches)
    if k5_paths != {"vector": launches["group_norm_act"], "scalar": 0}:
        raise AssertionError(f"main path: K5 by path {k5_paths}")
    per_sample = sampler.kernel_launches_per_sample()
    expected = {k: REQUESTS * v for k, v in per_sample.items()}
    print(json.dumps({"launch_counts": launches, "expected": expected,
                      "k5_path_launches": k5_paths, "request_s": seconds}), flush=True)
    if launches != expected:
        raise AssertionError(f"launches {launches} != structure's {expected}")
    for out in outs:
        if out.shape != (BATCH, IMAGE, IMAGE, 1) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"bad sample: {tuple(out.shape)}")
        if float(out.std()) < 1e-2:
            raise AssertionError("sample is near constant")

    print(json.dumps({"graph_recording_calls": grad_runs_through_kernels(DEVICE)}), flush=True)

    # injected noise of the whole-sample comparisons (phase 10, the int8 leg)
    zgen = torch.Generator(DEVICE).manual_seed(SEED + 30)
    x_init = torch.randn((BATCH, IMAGE, IMAGE, 1), generator=zgen, device=DEVICE)
    noise = [(torch.randn((BATCH, cfg.nz), generator=zgen, device=DEVICE),
              torch.randn((BATCH, IMAGE, IMAGE, 1), generator=zgen, device=DEVICE))
             for _ in range(cfg.num_timesteps)]

    # -- the int8 leg: the same requests served W8A8, K4 on the path ----------
    int8 = int8_phase(cfg, sampler, requests, x_init, noise, card)

    # -- whole-volume prediction through the CLI, K3 on the path --------------
    volume = volume_phases(cfg, sampler, int8["calibs"], card)

    # -- the training iteration, K3's backward on the path ---------------------
    train = training_phase(cfg, card)

    with tempfile.TemporaryDirectory() as work:
        # -- the training program and the slice test through their CLIs --------
        loop = loop_phase(cfg, card, work)
        # -- the shipped experiment through the YAML runner at nf=128, remat ----
        runp = run_phase(card, work)
        # -- the distributed path at world size 1 over NCCL ---------------------
        distp = distributed_phase(cfg, card, work, loop)
        # -- the model branches off the recipe, at the serving width ------------
        branch = branch_phase(card, work)
        # -- the phantom quality protocol's tools through the CLIs ---------------
        phantomp = phantom_phase(card, work)

    counts = shape_counts({"launches": log, "volume_launches": volume["log"],
                           "train_launches": train["log"], "int8_launches": int8["log"],
                           "int8_volume_launches": volume["int8_log"],
                           "loop_launches": loop["log"], "run_launches": runp["log"],
                           "remat_launches": runp["remat_log"],
                           "branch_launches": branch["log"],
                           "phantom_launches": phantomp["log"]})
    fir_shapes = {(kname, *key, 0): c for kname in ("fir_down2", "fir_up2")
                  for key, c in counts[kname].items()}
    fir_shapes.update({(kname, shape, torch.bfloat16, offset): dict.fromkeys(PATHS, 0)
                       for kname in ("fir_down2", "fir_up2")
                       for shape, offset in FIR_EXTRA_SHAPES})
    flash_shapes = {(*shape, torch.bfloat16): dict.fromkeys(PATHS, 0)
                    for shape in FLASH_EXTRA_SHAPES}
    flash_shapes.update(counts["flash_attn"])
    bwd_names = ("flash_attn_bwd_dkv", "flash_attn_bwd_dq")
    bwd_shapes = {(*shape, torch.bfloat16): {n: dict.fromkeys(PATHS, 0) for n in bwd_names}
                  for shape in FLASH_BWD_EXTRA_SHAPES}
    for n in bwd_names:
        for key, c in counts[n].items():
            bwd_shapes.setdefault(key, {m: dict.fromkeys(PATHS, 0) for m in bwd_names})[n] = c

    int8_shapes = {(shape, cout, torch.bfloat16, torch.bfloat16, mode): dict.fromkeys(PATHS, 0)
                   for shape, cout in INT8_EXTRA_SHAPES for mode in ("dynamic", "static")}
    int8_shapes.update(counts["int8_conv3x3"])
    k5_shapes = {key: dict.fromkeys(PATHS, 0) for nf, b in K5_PATHS for key in k5_path_keys(nf, b)}
    k5_shapes.update(counts["group_norm_act"])

    # -- each kernel against its plain version, timed ------------------------
    rows = (conv_rows(counts["conv3x3"], peaks, card) + fir_rows(fir_shapes, peaks, card)
            + flash_rows(flash_shapes, peaks, card) + flash_bwd_rows(bwd_shapes, peaks, card)
            + int8_rows(int8_shapes, peaks, INT8_PEAKS[variant], card)
            + k5_rows(k5_shapes, peaks, card))

    # -- the whole sample, kernels vs plain versions -------------------------
    sampler32 = build_sampler(cfg, device=DEVICE, attn="einsum", compute_dtype=torch.float32)
    sampler32.g1.load_state_dict(sampler.g1.state_dict())
    sampler32.g2.load_state_dict(sampler.g2.state_dict())
    diffs, runs = {}, {}
    for tag, s in (("bf16", sampler), ("fp32", sampler32)):
        _, diffs[tag], runs[tag] = sample_vs_plain(tag, s, requests[0], x_init, noise,
                                                   SAMPLE_TOL[tag])
    print(json.dumps({"sample_kernel_vs_plain_max_abs": diffs, "tolerance": SAMPLE_TOL,
                      "runs": runs}), flush=True)

    # -- throughput ------------------------------------------------------------
    best = math.inf
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        sampler(*requests[0], generator=ngen)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t)
    plain_best = math.inf
    with ops.plain_kernels():
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            sampler(*requests[0], generator=ngen)
            torch.cuda.synchronize()
            plain_best = min(plain_best, time.perf_counter() - t)
    print(json.dumps({"card": card, "peaks_of": variant, "nf": NF, "image": IMAGE,
                      "batch": BATCH, "steps": cfg.num_timesteps, "dtype": "bf16",
                      "attn": "bf16", "best_request_s": best, "slices_per_s": BATCH / best,
                      "plain_slices_per_s": BATCH / plain_best}), flush=True)
    print(json.dumps({"card": card, "profile_one_request":
                      profile_request(sampler, requests[0], ngen)}), flush=True)
    # one batch of the volume phase's sampler (batch 8, --attn flash)
    flash_sampler = build_sampler(cfg, device=DEVICE, attn="flash")
    flash_sampler.g1.load_state_dict(sampler.g1.state_dict())
    flash_sampler.g2.load_state_dict(sampler.g2.state_dict())
    vconds = [torch.cat([c, c])[:VOLUME_BATCH] for c in requests[0]]
    print(json.dumps({"card": card, "profile_one_volume_batch":
                      profile_request(flash_sampler, vconds, ngen)}), flush=True)

    # every kernel ran on a path: the main path, the volume or the training phase
    runs = {"launches": launches, "volume_launches": volume["launches"],
            "train_launches": train["launches"], "int8_launches": int8["launches"]}
    counted = {k: runs[COUNTED_IN.get(k, "launches")][k] for k in ops.KERNEL_WRAPPERS}
    idle = [k for k, n in counted.items() if n <= 0]
    if idle:
        raise AssertionError(f"kernels never launched on a path: {idle}")
    on_volume = [kernel_summary(k, rows, volume["launches"][k], "volume_launches")
                 for k in ops.KERNEL_WRAPPERS if volume["launches"][k]]
    print(json.dumps({"card": card, "volume_phase_kernels": on_volume}), flush=True)
    on_train = [kernel_summary(k, rows, train["launches"][k], "train_launches")
                for k in ops.KERNEL_WRAPPERS if train["launches"][k]]
    print(json.dumps({"card": card, "training_phase_kernels": on_train}), flush=True)
    on_int8 = {path: [kernel_summary(k, rows, n, path) for k, n in run.items() if n]
               for path, run in (("int8_launches", int8["launches"]),
                                 ("int8_volume_launches", volume["int8_launches"]))}
    print(json.dumps({"card": card, "int8_leg_kernels": on_int8}), flush=True)
    on_loop = [kernel_summary(k, rows, loop["launches"][k], "loop_launches")
               for k in ops.KERNEL_WRAPPERS if loop["launches"][k]]
    idle = [k for k in ops.KERNEL_WRAPPERS if not loop["launches"][k]]
    if idle:
        raise AssertionError(f"the train-loop phase never launched {idle}")
    print(json.dumps({"card": card, "loop_phase_kernels": on_loop}), flush=True)
    # phase 8: the CLIs launch K1, K2a, K2b and K4; the remat table K1-K3
    on_run = [kernel_summary(k, rows, runp["launches"][k], "run_launches")
              for k in ops.KERNEL_WRAPPERS if runp["launches"][k]]
    idle = [k for k in ("conv3x3", "fir_down2", "fir_up2", "int8_conv3x3")
            if not runp["launches"][k]]
    if idle:
        raise AssertionError(f"phase 8's CLI runs never launched {idle}")
    print(json.dumps({"card": card, "run_phase_kernels": on_run}), flush=True)
    on_remat = [kernel_summary(k, rows, runp["remat_launches"][k], "remat_launches")
                for k in ops.KERNEL_WRAPPERS if runp["remat_launches"][k]]
    idle = [k for k in ops.KERNEL_WRAPPERS
            if k != "int8_conv3x3" and not runp["remat_launches"][k]]
    if idle:
        raise AssertionError(f"the remat table never launched {idle}")
    print(json.dumps({"card": card, "remat_table_kernels": on_remat}), flush=True)
    on_branch = [kernel_summary(k, rows, branch["launches"][k], "branch_launches")
                 for k in ops.KERNEL_WRAPPERS if branch["launches"][k]]
    print(json.dumps({"card": card, "branch_phase_kernels": on_branch}), flush=True)
    on_phantom = [kernel_summary(k, rows, phantomp["launches"][k], "phantom_launches")
                  for k in ops.KERNEL_WRAPPERS if phantomp["launches"][k]]
    idle = [k for k in ("conv3x3", "fir_down2", "fir_up2", "int8_conv3x3")
            if not phantomp["launches"][k]]
    if idle:
        raise AssertionError(f"phase 15 never launched {idle}")
    print(json.dumps({"card": card, "phase15_kernels": on_phantom}), flush=True)
    kernels = [kernel_summary(k, rows, counted[k]) for k in ops.KERNEL_WRAPPERS]
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "build": build, "rows": rows, "kernels": kernels,
                       "volume_phase_kernels": on_volume, "training_phase_kernels": on_train,
                       "int8_leg_kernels": on_int8, "loop_phase_kernels": on_loop,
                       "run_phase_kernels": on_run, "remat_table_kernels": on_remat,
                       "branch_phase_kernels": on_branch, "phase15_kernels": on_phantom,
                       "phantom": {k: v for k, v in phantomp.items() if k != "log"},
                       "branch": {k: v for k, v in branch.items() if k != "log"},
                       "loop": {k: v for k, v in loop.items() if k != "log"},
                       "run": {k: v for k, v in runp.items() if k not in ("log", "remat_log")},
                       "int8": {k: v for k, v in int8.items() if k != "log"}
                       | {"calibs": [c.to_json_dict() for c in int8["calibs"]]},
                       "volume": {k: v for k, v in volume.items()
                                  if k not in ("log", "int8_log")},
                       "training": {k: v for k, v in train.items() if k != "log"},
                       "distributed": distp,
                       "nvcc": {k: v["log"] for k, v in built.items()}}, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
