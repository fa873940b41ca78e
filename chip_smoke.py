#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dsmnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only corr1d,corr1d_vjp --profile-train dispnetcorr,iresnet
    python3 chip_smoke.py --trainer-workers 1,4,16
    python3 chip_smoke.py --data-parallel
    python3 chip_smoke.py --dp-cards 4
    python3 chip_smoke.py --spatial
    python3 chip_smoke.py --sp-cards 4

The second form runs only the named kernels' checks and timings (step 2)
and one profiled bf16 train step of each named model, and prints no ``ok``
line; copied beside another commit's package it measures that commit.
The third runs one epoch of step 10's trainer for each loader worker
count (``trainer_workers``), and prints no ``ok`` line either.  The
fourth runs step 10's ``trainer_bf16`` and then step 12's data-parallel
phases, with their launch checks but without the kernel rows, and prints
no ``ok`` line; the fifth runs step 12's ``dp2_shared_card`` across that
many cards instead, rank i on card i over NCCL (``dp4_nccl``), no ``ok``
line either.  The sixth runs only step 13's ``sp2_shared_card`` and its
kernel rows, the seventh that phase on a (N/2, 2) mesh across N cards
over NCCL (``sp4_nccl``); neither prints an ``ok`` line.

1. Builds the hand-written CUDA kernels from ``dsmnet_tpu_torch/csrc`` and
   prints the card, the versions and the build time.
2. For each kernel at each shape of its paths: PSMNet serving (384x768,
   maxdisparity 192, batch 1) for the forward kernels A-D, the
   supervised train step (384x768 crop, batch 4) for A-D in their
   forward and backward roles and the weight-gradient kernels E-G, and
   the serving of GCNet (A-D, the cost volume H), PSMNet-basic (A, B, H),
   DispNetC and iResNet (the correlation I) at the same size, the fused
   stem's assembly J on PSMNet's serving and train-step tap maps, and
   every kernel at every shape of the train steps of GCNet (F at
   128 -> 128 for l31/l32 among them), PSMNet-basic, DispNetC and iResNet
   (I and I's VJP kernel, which has no TPU counterpart: JAX's is jnp).
   Each shape's bf16 kernel and its f32 instantiation are held against
   the plain PyTorch version computed in float32 from the same bf16 inputs
   with TF32 off (J: from the same float32 tap maps, written in bf16 and
   in f32; the VJP against the plain VJP summed in float32); E-G and the
   VJP must also give the same bits on two launches, and H, a copy, the
   plain version's bits.  The device time (CUDA graph replays timed with
   CUDA events) of the kernel, the plain version and one PyTorch call
   (cuDNN for the convolutions) beside the card's bound for the work;
   also the kernel's eager wall time per call; for A-G the MB their bf16
   designs move from L2 into shared memory per launch, and for J the map
   MB its blocks read, beside the count for the earlier tiles
   (``l2_to_shared_mb``, ``l2_to_shared_mb_earlier_tiles``).  Small
   ragged-edge shapes (chunks and runs that end ragged, D = 1 and 2, odd
   H, W off every tile) are checked, not timed.  For the stem also the
   whole op (tap maps + J) against the op on the plain assembly, and
   kernel H's volume build beside cuDNN's conv over that volume, which
   the fused stem replaces.
3. Serving: full-width PSMNet with seeded weights and BN statistics
   calibrated by one train-mode forward: a float32 forward through the
   kernels against the plain path (TF32 off), both against float64; then
   a bf16 ``Predictor`` answering requests while the launch counters show
   that every request went through A-D and J (8/12/6/3/1 per request),
   and one profiled request.
4. Gradients: one 384x768 pair through a train-mode float32 forward and
   backward on the kernels, every parameter's gradient held against the
   float64 plain model next to the float32 plain path's own error.
5. Training: ``create_train_state`` + ``make_supervised_train_step``, bf16,
   batch 4, on one fixed batch for TRAIN_STEPS steps: every step's launch
   counts equal TRAIN_LAUNCHES, the loss falls, and the median step
   time, frames/s and peak memory are printed; then one profiled step.
   The same for GCNet at batch 1 (``train_gcnet_bf16``); then GCNet with
   ``remat`` (``train_gcnet_remat_bf16``: three steps, launches against
   REMAT_LAUNCHES, the recomputation in bf16, the first step's loss and
   gradients against the plain step's, a falling loss); then GCNet's
   gradient check as in 4 at the size of 6 (``grad_gcnet_f32``).
6. GCNet in float32 through the kernels against the plain path, both
   against float64, at 192x384 with maxdisparity 96 (``model_gcnet_f32``);
   iResNet likewise at 384x768, maxdisparity 192 (``model_iresnet_f32``).
7. Serving GCNet, PSMNet-basic, DispNetC and iResNet like PSMNet: a bf16
   ``Predictor`` at 384x768, maxdisparity 192, answers N_REQUESTS
   requests, each with the launch counts of SERVE_LAUNCHES; then one
   profiled request each.
8. Training PSMNet-basic, DispNet, DispNetC and iResNet as in 5 at batch 4
   for 4 steps each (``train_*_bf16``); DispNetC and iResNet then profiled
   for one step, with the device time and launches under the correlation's
   backward (``corr_backward``).  Each path's counted launches must equal
   the launches of its rows in 2.
9. Serving PSMNet without the fused stem (``fused_stem=False``,
   ``serve_psmnet_volume_bf16``): the masked concat volume on H, then
   ``dres0_0`` on B; every request launches SERVE_LAUNCHES["psmnet_volume"]
   (H, not J).
10. The trainer through its command line (``trainer_bf16``):
   ``dsmnet_tpu_torch.cli.main`` trains PSMNet (bf16, batch 4, 384x768
   crops, maxdisparity 192) on the synthetic dataset for one epoch of
   TRAINER_STEPS steps and a validation of TRAINER_VAL_BATCHES batches,
   with a profiler trace of steps 10-15; its launches must equal
   TRAINER_STEPS train steps' plus TRAINER_VAL_BATCHES batch-4 eval
   forwards' (path "trainer"), and it must write its checkpoints, history
   and trace.  A second call with ``--epochs 2`` must resume at epoch 1 at
   ``lr_for_epoch``'s rate, run one more epoch with the same launches,
   and end with a lower mean train loss than epoch 0's.  Then ``--mode
   test`` (a finite loss, D1 and EPE) and ``--mode submit`` (uint16 PNGs
   that read back as the disparity x 256) from the best weights; the
   loader's worker threads must have ended.  Printed: each epoch's median
   ``bt`` (whole step) and ``dt`` (waiting for data), frames/s, peak
   memory and losses.
11. The self-supervised path (a -mask loss: the 384x768 pairs cropped by a
   64-pixel border to 256x640 views, colour augmented on the card, two
   weight-shared forwards, the photometric pyramid loss): DispNetC's
   ``Cap_ds-mask`` gradients in float32 through I and its VJP against
   float64, next to the plain path's (``selfsup_grad_f32``, one pair, the
   draws of step 0); bf16 steps at batch 4 on one fixed batch of
   synthetic pairs, DispNetC (``Cap_ds-mask``, 8 steps) and PSMNet
   (``depthmono-mask``, 4 steps), at lr 1e-4 (``train_selfsup_*_bf16``):
   every step launches SELFSUP_LAUNCHES (twice the supervised step's, at
   the views' shapes), the eval step's loss on the batch falls, and one
   profiled step gives the device ms under the loss's ``photometric_loss``
   span; then 10.'s trainer for DispNetC with ``--loss_name Cap_ds-mask``
   (``trainer_selfsup_bf16``: an eval batch is two forwards).
12. Data parallel (``parallel/``): ``dp_cli_nccl_bf16`` drives 10.'s
   command line with ``--mesh-data 1`` under torchrun's environment (RANK
   0 of WORLD_SIZE 1): a real NCCL group through ``env://``, the
   ``Trainer`` on a 1x1 mesh, every reduction over the batch and the
   gradient bucket all-reduced; its launches per epoch must equal
   ``trainer_bf16``'s, and its median ``bt`` and ``dt`` are printed beside
   them.  Then ``dp2_shared_card``: two spawned ranks pinned to the one
   card on a gloo group (NCCL refuses two ranks on one card; gloo moves
   CUDA tensors through the host), (a) full-width PSMNet, one sample per
   rank, float32 with TF32 off: the global loss and every summed gradient
   against the one-process float32 step on the same 2-pair batch and
   weights, each within DP2_GRAD_FACTOR x the one-process path's own
   error against float64 (+ a floor, as in 4.); (b) bf16 steps at 4 per
   rank (global 8): every step's launches equal TRAIN_LAUNCHES (path
   ``dp2_train``), the loss falls, the per-rank step time and the device
   time under the gradient all-reduce (a gloo all-reduce on one shared
   card, not a multi-GPU node's); (c) ``halo_conv2d`` at (2, 96, 192, 32)
   -> 32 in float32, H split over the two ranks, forward and backward
   against ``conv2d_same`` on the whole tensor, through A and E (path
   ``dp2_halo``).  Beside it, whether gloo's send/recv take a CUDA tensor
   (``gloo_p2p_cuda``, two more processes).
13. Spatial sharding (``sp2_shared_card``): two spawned ranks on the one
   card over gloo, a (1, 2) mesh, H split into a band of rows per rank
   (the towers run whole on both; the halo rows cross the host under
   gloo, the phase's transport): (a) full-width PSMNet float32 on one
   pair, its loss and summed gradients against the one-process float32
   step's, within DP2_GRAD_FACTOR x that path's own error against
   float64; (b) SP2_STEPS bf16 PSMNet steps at TRAIN_BATCH pairs, the same
   on both ranks: every rank-step's launches equal the ``sp2_train`` rows
   (A and E at the train shapes, B-D, F, G and J at the band shapes, each
   checked against its plain version in 2.), the loss falls; the median
   rank-step ms, the device ms of a profiled step, under its
   ``halo_exchange`` records (the transport) and its ``halo_pad`` records
   (joining the halo rows to the bands, the adjoint's crops and sums),
   its 25 longest kernels, the device ms of the whole-image tower's
   forward and backward on both ranks at once and on each rank alone, the
   exchanges a step and the peak memory a rank beside
   ``train_bf16``'s; (c) SP2_GCNET_STEPS bf16 GCNet steps at
   batch 1, launches against ``sp2_gcnet`` (H, and B and F at 128 -> 128,
   at band shapes); (d) the self-supervised step (PSMNet as 11.'s
   ``train_selfsup_psmnet_bf16`` trains it: 256x640 views of 384x768
   pairs, the towers whole, the loss on each rank's band of the views) in
   float32 on one pair a data index with step 0's draws, of
   SP2_SELFSUP_LOSS and of ``common-mask`` (whose ``C_ds3`` takes per-image
   means over the model group), its global loss equal on the ranks and its
   summed gradients against the one process's as in (a); (e) SP2_STEPS bf16 self-supervised steps at
   TRAIN_BATCH pairs and one profiled step: launches against the
   ``sp2_selfsup`` rows (A and E at the views' tower shapes, B-D, F, G and J
   at the views' band shapes, two forwards a step), the halo exchanges and
   the per-image sums over the model group (``model_sum``) a step, the
   device ms under ``photometric_loss``, ``halo_exchange`` and
   ``halo_pad``, the median rank-step ms and the peak memory a rank beside
   ``train_selfsup_psmnet_bf16``'s.
14. The script's command time, one ``{"kernels": [...]}`` line (launches
   and times on each kernel's first path, "primary": the train step for
   A-G and J, GCNet's request for H, DispNetC's for I, iResNet's step for
   I's VJP; and per path), the card's
   name and power limit, and last the ``{"ok": true, ...}`` line.  Every
   printed row of 12. and 13. carries the card's name and power limit.

Any failed check raises: the script exits non-zero and prints no result.
It exits non-zero at once when CUDA is not available.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

H, W, MAXDISP = 384, 768, 192
N_REQUESTS = 6
TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 4, 8, 1e-3
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12    # H100 SXM float32 outside the tensor cores (J's adds)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
# bf16 kernel vs f32 reference from the same bf16 inputs: the output's
# bf16 rounding is <= 2^-9 relative and f32 accumulation-order
# differences are ~1e-6, so |kernel - ref| <= 1e-3 + 2^-8 |ref|
BF16_ATOL, BF16_RTOL = 1e-3, 2.0 ** -8
# f32 instantiation vs the same reference: accumulation order only
F32_ATOL, F32_RTOL = 1e-4, 1e-4
# weight gradients (f32 out of both the bf16 and the f32 kernels): dK sums
# up to millions of products of both signs, so the error is measured
# against the same contraction on absolute values, |x|^T |g|; f32
# accumulation in another order moves a sum by ~1e-7 of that scale
DK_ATOL, DK_RTOL = 1e-4, 1e-5
# full float32 PSMNet through the kernels, held against the same model in
# float64 (plain path): its error may be at most MODEL_F32_FACTOR times
# the float32 plain (cuDNN, TF32 off) path's error, plus MODEL_F32_ATOL_PX.
# Both f32 paths round differently and the ~60 conv+BN layers of a random,
# BN-calibrated network amplify rounding (0.012 px between the two f32
# paths at 384x768); a wrong tap or index misses by pixels, not by 4x.
MODEL_F32_FACTOR, MODEL_F32_ATOL_PX = 4.0, 1e-3
# the same rule for each parameter's gradient, as a relative norm against
# float64, with the floor a tenth of the plain path's median relative error
# over all parameters (as 1e-3 px is a tenth of its disparity error): a
# parameter where the plain path happens to round far below that median
# (some of the last head's) is not held below f32 noise, and a wrong tap
# or index misses by O(1)
GRAD_F32_FACTOR, GRAD_F32_FLOOR_SHARE = 4.0, 0.1
# the copy H must give the plain version's bits; the correlation I sums C
# products of both signs, so, as for dK, its f32 error is measured against
# the same sum of absolute values, S = |fL| . |fR|: f32 accumulation in
# another order moves a sum by ~1e-7 S; the bf16 kernel also rounds its
# output to bf16 (<= 2^-9 |ref|)
CORR_SCALE_TOL, CORR_BF16_RTOL = 1e-5, 2.0 ** -8
# the stem's assembly J sums 18 tap-map values of both signs per output in
# f32: the same rule as I's, against the same assembly of |A| and |B| (its
# grouped sums run in another order than the plain version's, so the check
# reports, without requiring, whether its bits match)
REQUEST_LAUNCHES = {"conv2d_k3": 8, "conv3d_k3": 12, "conv3d_k3s2": 6, "deconv3d_k3s2": 3,
                    "fused_costvol": 1}
# launches per request of the other serving paths at 384x768, maxdisparity
# 192: GCNet's tower (16 convs in its residual stack + conv2), the 3-D
# convs l19/l20/l22/l23/l25/l26/l28/l29/l31/l32, the stride-2 l21/l24/l27
# (l30, 64 -> 128, stays plain), the deconv l36 and the volume;
# PSMNet-basic's tower once per view (8 convs each), its ten 32-channel
# 3-D convs and dres0_0 (64 -> 32), and the volume; DispNetC's correlation;
# iResNet's two correlations (D = 81 at 1/4; D = 41, stride 2, at 1/2)
SERVE_LAUNCHES = {
    "gcnet": {"conv2d_k3": 17, "conv3d_k3": 10, "conv3d_k3s2": 3, "deconv3d_k3s2": 1,
              "cost_volume": 1},
    "psmnet_basic": {"conv2d_k3": 16, "conv3d_k3": 11, "cost_volume": 1},
    "dispnetcorr": {"corr1d": 1},
    "iresnet": {"corr1d": 2},
    # PSMNet with fused_stem=False: the volume on H, then dres0_0 (64 -> 32) on B
    "psmnet_volume": {"conv2d_k3": 8, "conv3d_k3": 13, "conv3d_k3s2": 6, "deconv3d_k3s2": 3,
                      "cost_volume": 1},
}
SERVE_PATHS = {"gcnet": "serve_gcnet", "psmnet_basic": "serve_psmnet_basic",
               "dispnetcorr": "serve_dispnetc", "iresnet": "serve_iresnet",
               "psmnet_volume": "serve_psmnet_volume"}
# a served configuration that is not a model's default: (net, create_model kwargs)
SERVE_NETS = {"psmnet_volume": ("psmnet", {"fused_stem": False})}
# model_gcnet_f32 and grad_gcnet_f32: a size whose float64 pass stays short
# (~2 TFLOP per pair at 384x768), whose volume stays even down to l30's
# input and whose l31/l32 (1, 3, 6, 12, 128) still reach F at 128 -> 128
GCNET_F32_H, GCNET_F32_W, GCNET_F32_MAXDISP = 192, 384, 96
# launches per supervised train step, at 384x768, maxdisparity 192:
# PSMNet: A-D forward plus their backward roles (dx of A and B, the
# deconv's d(input) on C, the stride-2 conv's dx on D), the weight
# gradients and the stem's forward assembly (its backward is plain);
# GCNet: the tower's 17 A convs forward and dx and their dK (E), its ten B
# convs (l31/l32 at 128 -> 128) forward and dx and their dK (F), l21/l24/l27
# on C and l36's d(input) on C, their dK and l36's dW on G, l36 on D (the
# stride-2 convs' dx at C = 64 is plain, as in JAX), the volume (H);
# PSMNet-basic: the tower once per view (8 A convs each) forward and dx and
# their dK, its eleven B convs forward and dx and their dK, the volume;
# DispNet: no kernel (JAX runs no Pallas kernel in it); DispNetC and
# iResNet: the correlations' forward (I) and their VJP (JAX's is jnp)
TRAIN_LAUNCHES = {
    "psmnet": {"conv2d_k3": 16, "conv3d_k3": 24, "conv3d_k3s2": 9, "deconv3d_k3s2": 6,
               "conv2d_dk_k3": 8, "conv3d_dk_k3": 12, "conv3d_dk_k3s2": 9, "fused_costvol": 1},
    "gcnet": {"conv2d_k3": 34, "conv2d_dk_k3": 17, "conv3d_k3": 20, "conv3d_dk_k3": 10,
              "conv3d_k3s2": 4, "conv3d_dk_k3s2": 4, "deconv3d_k3s2": 1, "cost_volume": 1},
    "psmnet_basic": {"conv2d_k3": 32, "conv2d_dk_k3": 16, "conv3d_k3": 22, "conv3d_dk_k3": 11,
                     "cost_volume": 1},
    "dispnet": {},
    "dispnetcorr": {"corr1d": 1, "corr1d_vjp": 1},
    "iresnet": {"corr1d": 2, "corr1d_vjp": 2},
}
# GCNet with remat: the backward recomputes each 3-D stage's forward
# kernels (B 10, C 3, D 1) and the volume inside the two stages that read
# it, which the forward also builds twice (H 2 + 2); no gradient role changes
REMAT_LAUNCHES = {"gcnet": {**TRAIN_LAUNCHES["gcnet"], "conv3d_k3": 30, "conv3d_k3s2": 7,
                            "deconv3d_k3s2": 2, "cost_volume": 4}}
# name -> (path, batch, steps, lr): PSMNet at the JAX bench's batch 4 and lr;
# GCNet at its published batch 1, lr 1e-3; the others at batch 4 for fewer
# steps, at the JAX CLI's default lr (dsmnet_tpu/cli.py:45)
TRAIN_RUNS = {"psmnet": ("train", TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR),
              "gcnet": ("train_gcnet", 1, 8, 1e-3),
              "psmnet_basic": ("train_psmnet_basic", 4, 4, 1e-4),
              "dispnet": ("train_dispnet", 4, 4, 1e-4),
              "dispnetcorr": ("train_dispnetc", 4, 4, 1e-4),
              "iresnet": ("train_iresnet", 4, 4, 1e-4)}

# the trainer's command line (trainer_bf16): PSMNet as the train phase runs
# it, on the synthetic dataset (64 training samples, 8 validation samples,
# both 384x768, so no shift: --shift_max 0), one epoch a call
TRAINER_ARGS = ["--net", "psmnet", "--dataset", "synthetic", "--batchsize", str(TRAIN_BATCH),
                "--crop_h", str(H), "--crop_w", str(W), "--maxdisparity", str(MAXDISP),
                "--shift_max", "0", "--dtype", "bfloat16", "--lr", str(TRAIN_LR)]
TRAINER_STEPS, TRAINER_VAL_BATCHES = 64 // TRAIN_BATCH, 8 // TRAIN_BATCH
TRAINER_TEST_SAMPLES = 16  # --mode test and submit: the synthetic set of 16 pairs

# the self-supervised path: a -mask loss crops a border of SELFSUP_NEDGE, so
# a 384x768 pair puts 256x640 views into the model (the KITTI recipes'
# crop, scripts/train_kitti_selfsup.sh); name -> (path, loss name, batch,
# steps, Adam's lr): DispNetC as the KITTI recipe trains it, PSMNet as
# the JAX bench's --selfsup mode (bench.py:102-130)
SELFSUP_NEDGE = 64
SH, SW = H - 2 * SELFSUP_NEDGE, W - 2 * SELFSUP_NEDGE
SELFSUP_RUNS = {"dispnetcorr": ("train_selfsup_dispnetc", "Cap_ds-mask", 4, 8, 1e-4),
                "psmnet": ("train_selfsup_psmnet", "depthmono-mask", 4, 4, 1e-4)}
# launches per self-supervised step: two weight-shared forwards and their
# backward, each the supervised step's kernels at the 256x640 views
SELFSUP_LAUNCHES = {name: {k: 2 * v for k, v in TRAIN_LAUNCHES[name].items()}
                    for name in SELFSUP_RUNS}
SELFSUP_SEED = 1  # the draws of step i: color_aug.selfsup_generator(SELFSUP_SEED, i)
# the trainer's command line for the self-supervised path (trainer_selfsup_bf16)
TRAINER_SELFSUP_ARGS = ["--net", "dispnetcorr", "--loss_name", "Cap_ds-mask", "--dataset",
                        "synthetic", "--batchsize", str(TRAIN_BATCH), "--crop_h", str(H),
                        "--crop_w", str(W), "--maxdisparity", str(MAXDISP), "--shift_max", "0",
                        "--dtype", "bfloat16", "--lr", "1e-4"]

# data parallel on the shared card (dp2_shared_card): bf16 steps at
# TRAIN_BATCH per rank; the summed f32 gradients may differ from the one
# process's by DP2_GRAD_FACTOR x that path's own error against float64
# (+ the floor of check_gradients): the two sum the same terms in another
# order, and a lost or doubled term misses by O(1)
DP2_RANKS, DP2_STEPS, DP2_GRAD_FACTOR = 2, 6, GRAD_F32_FACTOR
DP2_HALO_SHAPE = (2, 96, 192, 32)
DP2_DEVICE = "cuda:0"  # both ranks' card
# spatial sharding on the shared card (sp2_shared_card): H split over the
# two ranks of a (1, 2) mesh, PSMNet's bf16 steps at TRAIN_BATCH on the same
# pairs on both ranks, GCNet's at batch 1; the f32 check's summed gradients
# as dp2's (a)
SP2_RANKS, SP2_STEPS, SP2_GCNET_STEPS = 2, 4, 2
# the self-supervised part of that phase: PSMNet as train_selfsup_psmnet_bf16
# trains it (384x768 pairs, SH x SW views), the loss on each rank's band;
# its f32 check also with common-mask, whose C_ds3 edge weights take
# per-image means over the model group and whose ratio differences read
# the neighbours' rows
SP2_SELFSUP_LOSS = SELFSUP_RUNS["psmnet"][1]
SP2_SELFSUP_F32_LOSSES = (SP2_SELFSUP_LOSS, "common-mask")
# a collective waits this long for a rank before it fails
DP_TIMEOUT_S = 300

SLOW_CALL_MS = 20.0

T_START = time.perf_counter()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, samples: int = 21, reps: int = 10, warmup: int = 3) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph after
    warm-up, the graph's replay timed with CUDA events, median over
    ``samples`` replays.  A replay issues no Python, so this is the card's
    time for the work, not the rate at which the host launches it.  A call
    slower than SLOW_CALL_MS (a plain weight gradient over GCNet's full
    volume takes ~0.4 s) is timed in 5 replays of one call."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    if start.elapsed_time(end) > SLOW_CALL_MS:
        samples, reps, warmup = 5, 1, 0
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def host_ms(fn, samples: int = 21, reps: int = 10, warmup: int = 3) -> float:
    """Wall time per call of ``reps`` back-to-back eager calls, synchronised
    at the end, median over ``samples``: the host's launch rate when it
    exceeds the device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / reps)
    return statistics.median(times)


def kernel_specs():
    """Per kernel: wrapper, plain version, one-call PyTorch yardstick, and
    per path the (first operand shape, second operand shape, launches per
    call, extra arguments) of each shape it takes there: "serve" (PSMNet,
    per request), "train" (PSMNet's train step, per step), "serve_gcnet",
    "serve_psmnet_basic", "serve_dispnetc", "serve_iresnet" (per request),
    "train_gcnet", "train_psmnet_basic", "train_dispnetc", "train_iresnet"
    (per step, at TRAIN_RUNS' batch), "train_selfsup_dispnetc",
    "train_selfsup_psmnet" (per self-supervised step), "trainer" and
    "trainer_selfsup" (per epoch of the trainer phases), "dp2_train" (per
    data-parallel step of one rank) and "dp2_halo" (one rank's halo_conv2d,
    forward and backward).  Every shape a path launches has a
    row, and main() holds the rows' launches to the path's counters.
    "primary" names the path whose launches and times head the kernel's
    entry in the ``{"kernels": ...}`` line.  A conv kernel (kind "conv")
    takes (x, kernel); a weight-gradient kernel (kind "dk") (x, cotangent);
    the volume (kind "copy") and the correlation (kind "corr") (fL, fR,
    *args); the correlation's VJP (kind "corr_vjp") (fL, fR, g, stride),
    its rows naming g's shape; the stem's assembly (kind "stem") the
    float32 tap maps (A, B, D, mask_left[, output dtype, bf16 by
    default])."""
    from dsmnet_tpu_torch.ops import conv2d, conv3d, corr, cost_volume, fused_costvol

    D4, H2, W2, H4, W4 = MAXDISP // 4, H // 2, W // 2, H // 4, W // 4
    D2 = MAXDISP // 2
    SH4, SW4 = SH // 4, SW // 4
    # the batch of each train path
    B, Bg, Bb, Bc, Bi = (TRAIN_RUNS[n][1] for n in ("psmnet", "gcnet", "psmnet_basic",
                                                    "dispnetcorr", "iresnet"))
    Bs = SELFSUP_RUNS["dispnetcorr"][2]
    vol32 = lambda n: (n, D4, H4, W4, 32)
    vol64 = lambda n: (n, D4 // 2, H4 // 2, W4 // 2, 64)
    vol64s = lambda n: (n, D4 // 4, H4 // 4, W4 // 4, 64)
    # GCNet's volume (n, D2, H2, W2, 64) and its levels 1/2 .. 1/16
    gc = lambda lvl, c, n=1: (n, D2 >> lvl, H2 >> lvl, W2 >> lvl, c)
    gt = lambda lvl, c: gc(lvl, c, Bg)
    k3 = lambda c, co: (3, 3, 3, c, co)

    def lib_conv2d(x, k):
        xc, wc = x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        return lambda: F.conv2d(xc, wc, padding=1)

    def lib_conv3d(stride):
        def make(x, k):
            xc = x.permute(0, 4, 1, 2, 3)
            wc = k.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
            return lambda: F.conv3d(xc, wc, stride=stride, padding=1)
        return make

    def lib_deconv(x, k):
        xc = x.permute(0, 4, 1, 2, 3)
        wc = k.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
        return lambda: F.conv_transpose3d(xc, wc, stride=2, padding=1, output_padding=1)

    def lib_wgrad(stride, dims):
        """cuDNN's weight gradient alone (bf16, channels-last)."""
        def make(x, g):
            to_nc = (0, dims + 1, *range(1, dims + 1))
            fmt = torch.channels_last if dims == 2 else torch.channels_last_3d
            w = torch.empty((g.shape[-1], x.shape[-1], *(3,) * dims), dtype=x.dtype,
                            device=x.device).contiguous(memory_format=fmt)
            xc, gc_ = x.permute(*to_nc), g.permute(*to_nc)
            return lambda: torch.ops.aten.convolution_backward(
                gc_, xc, w, None, [stride] * dims, [1] * dims, [1] * dims, False, [0] * dims, 1,
                [False, True, False])
        return make

    def lib_cost_volume(fL, fR, D, mask_left):
        """One torch.cat of fL broadcast over d (masked by a (D, 1, W, 1)
        predicate when mask_left) and the unfolded view of fR padded by D-1
        columns on the left, flipped so that slice d reads fR[w - d]."""
        n, h, w, f = fL.shape
        left = fL[:, None].expand(n, D, h, w, f)
        if mask_left:
            keep = (torch.arange(w, device=fL.device)[None, :, None]
                    >= torch.arange(D, device=fL.device)[:, None, None])[:, None]
            left_fn = lambda: left * keep
        else:
            left_fn = lambda: left
        right = F.pad(fR, (0, 0, D - 1, 0)).unfold(2, D, 1)  # (N, H, W, F, D)
        return lambda: torch.cat([left_fn(), right.flip(-1).permute(0, 4, 1, 2, 3)], -1)

    def lib_corr1d(fL, fR, D, stride):
        """One torch.einsum over the unfolded view of fR padded by (D-1) S
        columns on the left (shift d at window index (D-1-d) S)."""
        view = F.pad(fR, (0, 0, (D - 1) * stride, 0)).unfold(2, (D - 1) * stride + 1, 1)
        view = view[..., ::stride]  # (N, H, W, C, D), shift D-1-e at index e
        return lambda: torch.einsum("nhwc,nhwce->nhwe", fL, view).flip(-1)

    def lib_corr1d_vjp(fL, fR, g, stride):
        """Two torch.einsum, the forward's over the unfolded padded fR against
        the flipped g (dfL), and one over fL padded by (D-1) S columns on the
        right, unfolded, against g read along its band, g[u + d S, d], as a
        strided view of g padded likewise (dfR)."""
        n, h, w, _ = fL.shape
        D, p = g.shape[-1], (g.shape[-1] - 1) * stride
        view_r = F.pad(fR, (0, 0, p, 0)).unfold(2, p + 1, 1)[..., ::stride]
        view_l = F.pad(fL, (0, 0, 0, p)).unfold(2, p + 1, 1)[..., ::stride]
        gp = F.pad(g, (0, 0, 0, p))
        g_band = gp.as_strided((n, h, w, D), (gp.stride(0), gp.stride(1), D, stride * D + 1))
        return lambda: (torch.einsum("nhwe,nhwce->nhwc", g.flip(-1), view_r),
                        torch.einsum("nhwd,nhwcd->nhwc", g_band, view_l))

    def lib_stem_conv(a, b, D, mask_left):
        """cuDNN's 3-D conv (bf16, channels-last) over the (N, D, H, W, 64)
        volume that kernel H builds from 32-channel features: the work the
        fused stem replaces (the volume is built outside the timed call)."""
        n, h, w, o = *a.shape[:3], a.shape[-1] // 9
        g = torch.Generator(device=a.device).manual_seed(1)
        fL, fR = (torch.randn((n, h, w, 32), generator=g, device=a.device).to(torch.bfloat16)
                  for _ in range(2))
        vol = cost_volume.cost_volume_kernel(fL, fR, D, mask_left).permute(0, 4, 1, 2, 3)
        wc = (torch.randn((o, 64, 3, 3, 3), generator=g, device=a.device) * 0.03).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
        return lambda: F.conv3d(vol, wc, padding=1)

    def stem_kernel(a, b, D, mask_left, dtype=torch.bfloat16):
        return fused_costvol.cost_volume_conv3x3_kernel(a, b, D, mask_left, dtype)

    def stem_plain(a, b, D, mask_left, dtype=torch.bfloat16):
        return fused_costvol.assemble_plain(a, b, D, mask_left, dtype)

    def conv_flops(x, k, out, *args):
        taps = math.prod(k[:-2])
        return 2 * math.prod(out[:-1]) * taps * k[-2] * k[-1]

    def dk_flops(taps):
        # every cotangent position meets every tap
        return lambda x, g, out, *args: 2 * math.prod(g[:-1]) * taps * x[-1] * g[-1]

    def corr_flops(x, y, out, D, stride):
        # only the products that land inside the image: sum_d (W - d S)+
        n, h, w, c = x
        return 2 * n * h * c * sum(max(0, w - d * stride) for d in range(D))

    # the correlation's rows and edges: (fL, fR, launches, D, stride); its
    # VJP's the same with g's shape for D
    corr_paths = {
        "serve_dispnetc": [((1, H4, W4, 128), (1, H4, W4, 128), 1, 41, 1)],
        # iResNet: conv2 at 1/4 (D = 81); the shared projection of conv1 at
        # 1/2 (D = 41, stride 2)
        "serve_iresnet": [((1, H4, W4, 128), (1, H4, W4, 128), 1, 81, 1),
                          ((1, H2, W2, 64), (1, H2, W2, 64), 1, 41, 2)],
        "train_dispnetc": [((Bc, H4, W4, 128), (Bc, H4, W4, 128), 1, 41, 1)],
        "train_iresnet": [((Bi, H4, W4, 128), (Bi, H4, W4, 128), 1, 81, 1),
                          ((Bi, H2, W2, 64), (Bi, H2, W2, 64), 1, 41, 2)],
        # the self-supervised step: two forwards of the 256x640 views
        "train_selfsup_dispnetc": [((Bs, SH4, SW4, 128), (Bs, SH4, SW4, 128), 2, 41, 1)]}
    # W not a multiple of the 64-column tile (65 and 130: one past a tile),
    # W < 64, D S >= W (stride 1 and 2), stride 2 at C = 32, batch 2 with odd
    # H, C = 24 (staged as 32, zeros above C), D = 1 and 3, stride 3 (I's
    # kernel for a stride other than 1 and 2)
    corr_edges = [((2, 5, 100, 128), 41, 1), ((1, 3, 20, 64), 41, 1), ((1, 4, 70, 128), 41, 2),
                  ((1, 3, 33, 32), 20, 2), ((1, 2, 65, 128), 41, 1), ((2, 3, 130, 64), 81, 1),
                  ((1, 3, 130, 128), 41, 2), ((2, 5, 65, 32), 41, 2), ((1, 2, 40, 24), 9, 1),
                  ((1, 1, 7, 64), 3, 1), ((1, 2, 70, 64), 1, 1), ((1, 3, 70, 64), 9, 3)]
    g_of = lambda x, D: (*x[:-1], D)
    # the self-supervised trainer's epoch (trainer_selfsup): TRAINER_STEPS
    # steps, two correlations and two VJPs each, and TRAINER_VAL_BATCHES
    # eval batches of two 384x768 forwards (the VJP rows: the first row's)
    trainer_corr = [((Bs, SH4, SW4, 128), (Bs, SH4, SW4, 128), 2 * TRAINER_STEPS, 41, 1),
                    ((Bs, H4, W4, 128), (Bs, H4, W4, 128), 2 * TRAINER_VAL_BATCHES, 41, 1)]

    maps = lambda n, h, w, o=32: (n, h, w, 9 * o)  # a stem tap map: 9 taps of O channels
    # a rank's band of DP2_HALO_SHAPE's rows, padded by a halo row each side
    halo_band = (DP2_HALO_SHAPE[0], DP2_HALO_SHAPE[1] // DP2_RANKS + 2, *DP2_HALO_SHAPE[2:])

    # "edges": small shapes whose H, W (and D) are not multiples of any
    # tile size, so every ragged-edge path of a kernel is held to its plain
    # version as well; checked only, not timed
    specs = [
        dict(name="conv2d_k3", kind="conv", route="cuda", source="dsmnet_tpu_torch/csrc/conv2d_k3.cu",
             replaces="dsmnet_tpu/ops/conv2d_pallas.py:183", primary="train",
             kernel=conv2d.conv2d_k3, plain=conv2d.conv2d_k3_plain, library=lib_conv2d,
             out=lambda x, k, *a: (*x[:-1], k[-1]), flops=conv_flops,
             paths={"serve": [((2, H2, W2, 32), (3, 3, 32, 32), 8)],
                    # forward and dx (the flipped, channel-swapped kernel)
                    "train": [((2 * B, H2, W2, 32), (3, 3, 32, 32), 16)],
                    "serve_gcnet": [((2, H2, W2, 32), (3, 3, 32, 32), 17)],
                    # PSMNet-basic runs its tower once per view
                    "serve_psmnet_basic": [((1, H2, W2, 32), (3, 3, 32, 32), 16)],
                    "train_gcnet": [((2 * Bg, H2, W2, 32), (3, 3, 32, 32), 34)],
                    "train_psmnet_basic": [((Bb, H2, W2, 32), (3, 3, 32, 32), 32)],
                    # halo_conv2d's band with a halo row above and below it,
                    # forward and dx
                    "dp2_halo": [(halo_band, (3, 3, 32, 32), 2)]},
             # A's bf16 walk (128-position row segments, ranges of rows): H =
             # 1, 2, 3; W = 40 and 60 (less than a segment), 130 and 300 (a
             # ragged last segment); ranges of 2 rows crossing images (4 x
             # 97 rows, W = 60) and of 4 crossing segments and images (2 x
             # 150 rows x 3 segments) at 132 SMs
             edges=[((1, 10, 40, 32), (3, 3, 32, 32)), ((2, 1, 40, 32), (3, 3, 32, 32)),
                    ((1, 2, 130, 32), (3, 3, 32, 32)), ((1, 3, 300, 32), (3, 3, 32, 32)),
                    ((4, 97, 60, 32), (3, 3, 32, 32)), ((2, 150, 300, 32), (3, 3, 32, 32))]),
        dict(name="conv3d_k3", kind="conv", route="cuda", source="dsmnet_tpu_torch/csrc/conv3d_k3.cu",
             replaces="dsmnet_tpu/ops/conv3d_pallas.py:220", primary="train",
             kernel=conv3d.conv3d_k3, plain=conv3d.conv3d_plain, library=lib_conv3d(1),
             out=lambda x, k, *a: (*x[:-1], k[-1]), flops=conv_flops,
             paths={"serve": [(vol32(1), k3(32, 32), 6), (vol64(1), k3(64, 64), 3),
                              (vol64s(1), k3(64, 64), 3)],
                    "train": [(vol32(B), k3(32, 32), 12), (vol64(B), k3(64, 64), 6),
                              (vol64s(B), k3(64, 64), 6)],
                    "serve_gcnet": [(gc(0, 64), k3(64, 32), 1), (gc(0, 32), k3(32, 32), 1),
                                    (gc(1, 64), k3(64, 64), 2), (gc(2, 64), k3(64, 64), 2),
                                    (gc(3, 64), k3(64, 64), 2), (gc(4, 128), k3(128, 128), 2)],
                    "serve_psmnet_basic": [((1, D4, H4, W4, 64), k3(64, 32), 1),
                                           (vol32(1), k3(32, 32), 10)],
                    # forward, and dx with the flipped, channel-swapped kernel
                    # (l19's and dres0_0's at 32 -> 64)
                    "train_gcnet": [(gt(0, 64), k3(64, 32), 1), (gt(0, 32), k3(32, 32), 2),
                                    (gt(0, 32), k3(32, 64), 1), (gt(1, 64), k3(64, 64), 4),
                                    (gt(2, 64), k3(64, 64), 4), (gt(3, 64), k3(64, 64), 4),
                                    (gt(4, 128), k3(128, 128), 4)],
                    "train_psmnet_basic": [((Bb, D4, H4, W4, 64), k3(64, 32), 1),
                                           (vol32(Bb), k3(32, 32), 20),
                                           (vol32(Bb), k3(32, 64), 1)]},
             edges=[((1, 5, 10, 40, 32), k3(32, 32)), ((1, 5, 10, 40, 32), k3(32, 64)),
                    ((1, 5, 9, 20, 64), k3(64, 32)), ((1, 5, 9, 20, 64), k3(64, 64)),
                    ((1, 3, 5, 20, 128), k3(128, 128)),
                    # B's bf16 walk, for each (C, Co): D = 1 with odd H and W
                    # = 20 (a 16-column tile and a ragged one); D = 2 at batch
                    # 2; ranges of 2 to 4 items that cross tile boundaries
                    # (odd D) and end in a ragged one (at 132 SMs: 285 items in
                    # ranges of 2 at 32 -> 32, 165 in ranges of 2, 207 in ranges
                    # of 4 per Co tile at 64 -> 64), odd H, W = 72 or 40
                    ((1, 1, 7, 20, 32), k3(32, 32)), ((2, 2, 9, 40, 32), k3(32, 32)),
                    ((1, 19, 17, 72, 32), k3(32, 32)),
                    ((1, 1, 7, 20, 32), k3(32, 64)), ((2, 2, 9, 40, 32), k3(32, 64)),
                    ((1, 11, 17, 72, 32), k3(32, 64)),
                    ((1, 1, 7, 20, 64), k3(64, 32)), ((2, 2, 9, 40, 64), k3(64, 32)),
                    ((1, 11, 17, 72, 64), k3(64, 32)),
                    ((1, 1, 7, 20, 64), k3(64, 64)), ((2, 2, 9, 40, 64), k3(64, 64)),
                    ((1, 23, 17, 40, 64), k3(64, 64)),
                    # 128 -> 128 split: D = 3 at l31's H and W, and batch 2
                    ((1, 3, 12, 24, 128), k3(128, 128)), ((2, 2, 9, 40, 128), k3(128, 128))]),
        dict(name="conv3d_k3s2", kind="conv", route="cuda",
             source="dsmnet_tpu_torch/csrc/conv3d_k3s2.cu",
             replaces="dsmnet_tpu/ops/conv3d_s2_pallas.py:208", primary="train",
             kernel=conv3d.conv3d_k3s2, plain=conv3d.conv3d_s2_plain, library=lib_conv3d(2),
             out=lambda x, k, *a: (x[0], x[1] // 2, x[2] // 2, x[3] // 2, k[-1]),
             flops=conv_flops,
             paths={"serve": [(vol32(1), k3(32, 64), 3), (vol64(1), k3(64, 64), 3)],
                    # conv1 forward and the conv6 deconv's d(input) share a shape
                    "train": [(vol32(B), k3(32, 64), 6), (vol64(B), k3(64, 64), 3)],
                    "serve_gcnet": [(gc(0, 64), k3(64, 64), 1), (gc(1, 64), k3(64, 64), 1),
                                    (gc(2, 64), k3(64, 64), 1)],
                    # l21/l24/l27 forward and l36's d(input)
                    "train_gcnet": [(gt(0, 64), k3(64, 64), 1), (gt(1, 64), k3(64, 64), 1),
                                    (gt(2, 64), k3(64, 64), 1), (gt(0, 32), k3(32, 64), 1)]},
             # C's bf16 walk: one output D-slice (D = 2), runs of 2 ending in a
             # ragged one (D = 10, 18 at 132 SMs), H = 2, batch 2, W/2 not a
             # multiple of the 32-column tile, C = 32 and 64
             edges=[((1, 6, 10, 40, 32), k3(32, 64)), ((1, 6, 10, 36, 64), k3(64, 64)),
                    ((1, 2, 10, 40, 32), k3(32, 64)), ((2, 10, 32, 72, 64), k3(64, 64)),
                    ((2, 18, 10, 200, 32), k3(32, 64)), ((1, 4, 2, 40, 32), k3(32, 64)),
                    ((2, 6, 10, 36, 64), k3(64, 64))]),
        dict(name="deconv3d_k3s2", kind="conv", route="cuda",
             source="dsmnet_tpu_torch/csrc/deconv3d_k3s2.cu",
             replaces="dsmnet_tpu/ops/conv3d_s2_pallas.py:570", primary="train",
             kernel=conv3d.deconv3d_k3s2_kernel, plain=conv3d.deconv3d_k3s2_plain,
             library=lib_deconv,
             out=lambda x, k, *a: (x[0], 2 * x[1], 2 * x[2], 2 * x[3], k[3]),
             # every input voxel meets all 27 taps (the output is exactly 2x)
             flops=lambda x, k, out, *a: 2 * math.prod(x[:-1]) * 27 * k[3] * k[4],
             paths={"serve": [(vol64(1), k3(32, 64), 3)],
                    # conv6 forward and the conv1 stride-2 conv's dx share a shape
                    "train": [(vol64(B), k3(32, 64), 6)],
                    "serve_gcnet": [(gc(1, 64), k3(32, 64), 1)],
                    "train_gcnet": [(gt(1, 64), k3(32, 64), 1)]},
             # D's bf16 walk: odd H, D = 1, D = 2 with W = 40 (a 32-column
             # tile and a ragged one), runs of 6 ending in a ragged one
             # (D = 11 at 132 SMs), batch 2
             edges=[((1, 3, 5, 20, 64), k3(32, 64)), ((1, 1, 5, 20, 64), k3(32, 64)),
                    ((1, 2, 6, 40, 64), k3(32, 64)), ((2, 11, 32, 96, 64), k3(32, 64))]),
        dict(name="conv2d_dk_k3", kind="dk", route="cuda",
             source="dsmnet_tpu_torch/csrc/conv2d_dk_k3.cu",
             replaces="dsmnet_tpu/ops/conv2d_pallas.py:280", primary="train",
             kernel=conv2d.conv2d_dk_k3, plain=conv2d.conv2d_dk_plain,
             library=lib_wgrad(1, 2), out=lambda x, g, *a: (3, 3, x[-1], g[-1]),
             flops=dk_flops(9),
             paths={"train": [((2 * B, H2, W2, 32), (2 * B, H2, W2, 32), 8)],
                    "train_gcnet": [((2 * Bg, H2, W2, 32), (2 * Bg, H2, W2, 32), 17)],
                    "train_psmnet_basic": [((Bb, H2, W2, 32), (Bb, H2, W2, 32), 16)],
                    "dp2_halo": [(halo_band, halo_band, 1)]},
             # E's bf16 walk: W = 40 (one ragged 96-position segment), W =
             # 100 and 200 (a ragged last segment) at batch 1 and 2, odd H,
             # chunks of one row and of two that start inside an oh walk
             edges=[((1, 10, 40, 32), (1, 10, 40, 32)), ((2, 9, 100, 32), (2, 9, 100, 32)),
                    ((1, 7, 200, 32), (1, 7, 200, 32)), ((2, 45, 200, 32), (2, 45, 200, 32))]),
        dict(name="conv3d_dk_k3", kind="dk", route="cuda",
             source="dsmnet_tpu_torch/csrc/conv3d_dk_k3.cu",
             replaces="dsmnet_tpu/ops/conv3d_pallas.py:341", primary="train",
             kernel=conv3d.conv3d_dk_k3, plain=conv3d.conv3d_dk_plain,
             library=lib_wgrad(1, 3), out=lambda x, g, *a: (3, 3, 3, x[-1], g[-1]),
             flops=dk_flops(27),
             paths={"train": [(vol32(B), vol32(B), 6), (vol64(B), vol64(B), 3),
                              (vol64s(B), vol64s(B), 3)],
                    # l19, l20, l22 .. l29 and l31/l32 (128 -> 128)
                    "train_gcnet": [(gt(0, 64), gt(0, 32), 1), (gt(0, 32), gt(0, 32), 1),
                                    (gt(1, 64), gt(1, 64), 2), (gt(2, 64), gt(2, 64), 2),
                                    (gt(3, 64), gt(3, 64), 2), (gt(4, 128), gt(4, 128), 2)],
                    "train_psmnet_basic": [((Bb, D4, H4, W4, 64), vol32(Bb), 1),
                                           (vol32(Bb), vol32(Bb), 10)]},
             edges=[((1, 5, 10, 40, 32), (1, 5, 10, 40, 32)),
                    ((1, 5, 10, 40, 32), (1, 5, 10, 40, 64)),
                    ((1, 5, 9, 20, 64), (1, 5, 9, 20, 32)),
                    ((1, 5, 9, 20, 64), (1, 5, 9, 20, 64)),
                    # F's bf16 walk: chunks of 3 rows that start inside an oh
                    # walk and W = 100 (a 96-position segment and a ragged
                    # one) at 32 -> 32; D = 1 with odd H and W = 50 at 64 ->
                    # 32; D = 2, batch 2, W = 100 at 64 -> 64; W = 70 at 32 -> 64
                    ((1, 4, 30, 100, 32), (1, 4, 30, 100, 32)),
                    ((1, 1, 7, 50, 64), (1, 1, 7, 50, 32)),
                    ((2, 2, 9, 100, 64), (2, 2, 9, 100, 64)),
                    ((1, 3, 11, 70, 32), (1, 3, 11, 70, 64)),
                    # 128 -> 128: W = 8 (one segment, 24 zero-filled
                    # columns), D = 2, W = 24 with odd H, batch 2 with a
                    # ragged second segment (W = 40) and chunks of 10 rows
                    ((1, 2, 3, 8, 128), (1, 2, 3, 8, 128)),
                    ((1, 2, 5, 24, 128), (1, 2, 5, 24, 128)),
                    ((2, 3, 4, 40, 128), (2, 3, 4, 40, 128))]),
        dict(name="conv3d_dk_k3s2", kind="dk", route="cuda",
             source="dsmnet_tpu_torch/csrc/conv3d_dk_k3s2.cu",
             replaces="dsmnet_tpu/ops/conv3d_s2_pallas.py:346", primary="train",
             kernel=conv3d.conv3d_s2_dk_k3, plain=conv3d.conv3d_s2_dk_plain,
             library=lib_wgrad(2, 3), out=lambda x, g, *a: (3, 3, 3, x[-1], g[-1]),
             flops=dk_flops(27),
             # conv1's dK and, roles swapped, the conv6 deconv's dW share a shape
             paths={"train": [(vol32(B), vol64(B), 6), (vol64(B), vol64s(B), 3)],
                    # l21/l24/l27's dK and, roles swapped, l36's dW
                    "train_gcnet": [(gt(0, 64), gt(1, 64), 1), (gt(1, 64), gt(2, 64), 1),
                                    (gt(2, 64), gt(3, 64), 1), (gt(0, 32), gt(1, 64), 1)]},
             # G's bf16 walk: D = 2, an odd D/2, H = 2, batch 2 with three
             # ragged 48-position segments and chunks that start inside a row
             # line (90 rows in 45 chunks at 132 SMs), C = 32 and 64
             edges=[((1, 6, 10, 40, 32), (1, 3, 5, 20, 64)),
                    ((1, 6, 10, 36, 64), (1, 3, 5, 18, 64)),
                    ((1, 2, 10, 40, 32), (1, 1, 5, 20, 64)),
                    ((1, 10, 6, 36, 64), (1, 5, 3, 18, 64)),
                    ((1, 4, 2, 40, 32), (1, 2, 1, 20, 64)),
                    ((2, 6, 10, 200, 32), (2, 3, 5, 100, 64))]),
        dict(name="cost_volume", kind="copy", route="cuda",
             source="dsmnet_tpu_torch/csrc/cost_volume.cu",
             replaces="dsmnet_tpu/ops/cost_volume.py:76", primary="serve_gcnet",
             kernel=cost_volume.cost_volume_kernel,
             plain=cost_volume.concat_cost_volume_reference, library=lib_cost_volume,
             out=lambda x, y, D, mask_left: (x[0], D, x[1], x[2], 2 * x[3]),
             flops=lambda *a: 0,
             paths={"serve_gcnet": [((1, H2, W2, 32), (1, H2, W2, 32), 1, D2, False)],
                    "serve_psmnet_basic": [((1, H4, W4, 32), (1, H4, W4, 32), 1, D4, True)],
                    "train_gcnet": [((Bg, H2, W2, 32), (Bg, H2, W2, 32), 1, D2, False)],
                    "train_psmnet_basic": [((Bb, H4, W4, 32), (Bb, H4, W4, 32), 1, D4, True)]},
             # D >= W, odd H and W, batch 2, both masks
             edges=[((1, 5, 12, 32), (1, 5, 12, 32), 16, True),
                    ((1, 5, 12, 32), (1, 5, 12, 32), 16, False),
                    ((2, 7, 37, 32), (2, 7, 37, 32), 40, True),
                    ((2, 3, 21, 64), (2, 3, 21, 64), 9, False)]),
        dict(name="corr1d", kind="corr", route="cuda", source="dsmnet_tpu_torch/csrc/corr1d.cu",
             replaces="dsmnet_tpu/ops/corr.py:88", primary="serve_dispnetc",
             kernel=corr.corr1d_kernel, plain=corr.corr1d_plain, library=lib_corr1d,
             out=lambda x, y, D, stride: (*x[:-1], D), flops=corr_flops,
             paths={**corr_paths, "trainer_selfsup": trainer_corr},
             edges=[(x, x, D, s) for x, D, s in corr_edges]),
        # the VJP (JAX: jnp, no Pallas kernel) at the forward's train shapes;
        # the wrapper is looked up at the call, so that this table also
        # serves a tree whose correlation has no VJP kernel
        dict(name="corr1d_vjp", kind="corr_vjp", route="cuda",
             source="dsmnet_tpu_torch/csrc/corr1d_vjp.cu",
             replaces="dsmnet_tpu/ops/corr.py:123", primary="train_iresnet",
             kernel=lambda *a: corr.corr1d_vjp_kernel(*a), plain=corr.corr1d_vjp,
             library=lib_corr1d_vjp, out=lambda x, y, g, stride: [x, y],
             # both sides' products: twice the forward's
             flops=lambda x, y, out, gs, stride: 2 * corr_flops(x, y, out, gs[-1], stride),
             paths={path: [(x, y, n, g_of(x, D), s) for x, y, n, D, s in rows]
                    for path, rows in {**corr_paths, "trainer_selfsup": trainer_corr[:1]}.items()
                    if path.startswith("train")},
             edges=[(x, x, g_of(x, D), s) for x, D, s in corr_edges]),
        dict(name="fused_costvol", kind="stem", route="cuda",
             source="dsmnet_tpu_torch/csrc/fused_costvol.cu",
             replaces="dsmnet_tpu/ops/fused_costvol.py:510", primary="train",
             kernel=stem_kernel, plain=stem_plain, library=lib_stem_conv,
             out=lambda a, b, D, mask_left: (a[0], D, a[1], a[2], a[3] // 9),
             # 18 f32 adds per output
             flops=lambda a, b, out, *args: 18 * math.prod(out), peak_flops=PEAK_F32_FLOPS,
             paths={"serve": [(maps(1, H4, W4), maps(1, H4, W4), 1, D4, True)],
                    "train": [(maps(B, H4, W4), maps(B, H4, W4), 1, D4, True)]},
             # D > W, odd W, W < 3, D < 3, batch 2, O != 32, unmasked; D > W
             # + 2 over more than one chunk of columns (W = 70 at O = 32);
             # O = 64 (chunks of 16 columns)
             edges=[(maps(1, 3, 5), maps(1, 3, 5), 12, True),
                    (maps(1, 4, 37), maps(1, 4, 37), 16, True),
                    (maps(1, 3, 2), maps(1, 3, 2), 4, True),
                    (maps(1, 3, 20), maps(1, 3, 20), 2, True),
                    (maps(2, 3, 45), maps(2, 3, 45), 48, True),
                    (maps(1, 3, 40, 16), maps(1, 3, 40, 16), 10, True),
                    (maps(1, 2, 30, 12), maps(1, 2, 30, 12), 7, False),
                    (maps(1, 5, 50), maps(1, 5, 50), 20, False),
                    (maps(1, 3, 6), maps(1, 3, 6), 11, False),
                    (maps(2, 3, 70), maps(2, 3, 70), 96, True),
                    (maps(1, 4, 50, 64), maps(1, 4, 50, 64), 24, True),
                    (maps(2, 3, 37, 64), maps(2, 3, 37, 64), 13, False)]),
    ]
    # spatial sharding (sp2_train: a rank's bf16 PSMNet step at TRAIN_BATCH,
    # sp2_gcnet: its GCNet step at batch 1, sp2_selfsup: its self-supervised
    # PSMNet step at TRAIN_BATCH pairs, two forwards of the SH x SW views and
    # their backward; H over SP2_RANKS ranks): the towers run whole, so A and
    # E take the train paths' shapes; a 3-D op runs on its band padded by its
    # halo rows, ``e`` of them: 2 for a stride-1 conv (1, 1) and a stride-2
    # conv (2, 0), 1 for a deconv's input (0, 1) and a stride-2 conv's output
    # before its first row is dropped; the stem's tap maps on the features'
    # band + 2 rows; H on the band of GCNet's features
    R = SP2_RANKS

    def psmnet_bands(h4, w4, times):
        """A rank's band shapes of PSMNet's step on h4 x w4 features, each
        launched ``times`` as often as in one forward and its backward."""
        sb = lambda lvl, c, e: (B, D4 >> lvl, (h4 >> lvl) // R + e, w4 >> lvl, c)
        t = times
        return {
            "conv3d_k3": [(sb(0, 32, 2), k3(32, 32), 12 * t), (sb(1, 64, 2), k3(64, 64), 6 * t),
                          (sb(2, 64, 2), k3(64, 64), 6 * t)],
            "conv3d_k3s2": [(sb(0, 32, 2), k3(32, 64), 6 * t), (sb(1, 64, 2), k3(64, 64), 3 * t)],
            "deconv3d_k3s2": [(sb(1, 64, 1), k3(32, 64), 6 * t)],
            "conv3d_dk_k3": [(sb(0, 32, 2), sb(0, 32, 2), 6 * t), (sb(1, 64, 2), sb(1, 64, 2), 3 * t),
                             (sb(2, 64, 2), sb(2, 64, 2), 3 * t)],
            "conv3d_dk_k3s2": [(sb(0, 32, 2), sb(1, 64, 1), 6 * t),
                               (sb(1, 64, 2), sb(2, 64, 1), 3 * t)],
            "fused_costvol": [(maps(B, h4 // R + 2, w4), maps(B, h4 // R + 2, w4), t, D4, True)]}

    gb = lambda lvl, c, e: (Bg, D2 >> lvl, (H2 >> lvl) // R + e, W2 >> lvl, c)
    band_paths = {name: {"sp2_train": rows, "sp2_selfsup": psmnet_bands(SH4, SW4, 2)[name]}
                  for name, rows in psmnet_bands(H4, W4, 1).items()}
    for name, rows in {
            "conv3d_k3": [(gb(0, 64, 2), k3(64, 32), 1), (gb(0, 32, 2), k3(32, 32), 2),
                          (gb(0, 32, 2), k3(32, 64), 1), (gb(1, 64, 2), k3(64, 64), 4),
                          (gb(2, 64, 2), k3(64, 64), 4), (gb(3, 64, 2), k3(64, 64), 4),
                          (gb(4, 128, 2), k3(128, 128), 4)],
            "conv3d_k3s2": [(gb(0, 64, 2), k3(64, 64), 1), (gb(1, 64, 2), k3(64, 64), 1),
                            (gb(2, 64, 2), k3(64, 64), 1), (gb(0, 32, 2), k3(32, 64), 1)],
            "deconv3d_k3s2": [(gb(1, 64, 1), k3(32, 64), 1)],
            "conv3d_dk_k3": [(gb(0, 64, 2), gb(0, 32, 2), 1), (gb(0, 32, 2), gb(0, 32, 2), 1),
                             (gb(1, 64, 2), gb(1, 64, 2), 2), (gb(2, 64, 2), gb(2, 64, 2), 2),
                             (gb(3, 64, 2), gb(3, 64, 2), 2), (gb(4, 128, 2), gb(4, 128, 2), 2)],
            "conv3d_dk_k3s2": [(gb(0, 64, 2), gb(1, 64, 1), 1), (gb(1, 64, 2), gb(2, 64, 1), 1),
                               (gb(2, 64, 2), gb(3, 64, 1), 1), (gb(0, 32, 2), gb(1, 64, 1), 1)],
            "cost_volume": [((Bg, H2 // R, W2, 32), (Bg, H2 // R, W2, 32), 1, D2, False)]}.items():
        band_paths.setdefault(name, {})["sp2_gcnet"] = rows
    for spec in specs:
        paths = spec["paths"]
        if spec["name"] in ("conv2d_k3", "conv2d_dk_k3"):  # the towers, whole
            paths["sp2_train"], paths["sp2_gcnet"] = paths["train"], paths["train_gcnet"]
        paths.update(band_paths.get(spec["name"], {}))
        # PSMNet without the fused stem: PSMNet's request, the volume as
        # PSMNet-basic builds it, and dres0_0 (64 -> 32) on B
        if spec["name"] in ("conv2d_k3", "conv3d_k3s2", "deconv3d_k3s2"):
            paths["serve_psmnet_volume"] = paths["serve"]
        elif spec["name"] == "conv3d_k3":
            paths["serve_psmnet_volume"] = paths["serve"] + [
                ((1, D4, H4, W4, 64), k3(64, 32), 1)]
        elif spec["name"] == "cost_volume":
            paths["serve_psmnet_volume"] = paths["serve_psmnet_basic"]
        # PSMNet's self-supervised step: the supervised step's shapes at the
        # 256x640 views (H and W of every activation scaled, D and the
        # kernels kept), twice (two forwards and their backward)
        if "train" in paths:
            paths["train_selfsup_psmnet"] = [
                (selfsup_shape(a), b if spec["kind"] == "conv" else selfsup_shape(b), 2 * n, *args)
                for a, b, n, *args in paths["train"]]
        if spec["name"] in ("conv2d_k3", "conv2d_dk_k3"):  # its towers, whole
            paths["sp2_selfsup"] = paths["train_selfsup_psmnet"]
        # the data-parallel bf16 steps on the shared card: each rank steps on
        # TRAIN_BATCH samples, the train step's shapes
        if "train" in paths:
            paths["dp2_train"] = paths["train"]
        # the trainer's epoch: TRAINER_STEPS train steps and TRAINER_VAL_BATCHES
        # eval forwards at the train batch (a request's shapes at batch B; both
        # operands of the stem's assembly are per sample)
        if "train" in paths:
            per_sample = spec["kind"] == "stem"
            batched = lambda a: (a[0] * B, *a[1:])
            paths["trainer"] = (
                [(a, b, n * TRAINER_STEPS, *args) for a, b, n, *args in paths["train"]]
                + [(batched(a), batched(b) if per_sample else b, n * TRAINER_VAL_BATCHES, *args)
                   for a, b, n, *args in paths.get("serve", [])])
            # the same epoch through the data-parallel CLI on a 1x1 mesh
            paths["dp_cli"] = paths["trainer"]
    return specs


def selfsup_shape(shape):
    """An activation's shape (N,H,W,C) or (N,D,H,W,C) of the supervised
    384x768 step at the self-supervised step's SH x SW views."""
    *lead, h, w, c = shape
    return (*lead, h * SH // H, w * SW // W, c)


def kernel_inputs(spec, a_shape, b_shape, args, dev, gen):
    """bf16 activations ~ N(0, 1); for a conv, a He-scaled bf16 kernel, for
    a weight gradient a bf16 cotangent ~ N(0, 1), for the volume and the
    correlation the second feature map ~ N(0, 1), for the correlation's VJP
    also the bf16 cotangent ~ N(0, 1) whose shape ``args`` names first; for
    the stem's assembly two float32 tap maps ~ N(0, 1).  Returns (a, b,
    args with that shape replaced by the cotangent)."""
    if spec["kind"] == "stem":
        return (torch.randn(a_shape, generator=gen, device=dev),
                torch.randn(b_shape, generator=gen, device=dev), tuple(args))
    a = torch.randn(a_shape, generator=gen, device=dev).to(torch.bfloat16)
    scale = math.sqrt(2.0 / (math.prod(b_shape[:-2]) * b_shape[-1])) \
        if spec["kind"] == "conv" else 1.0
    b = (torch.randn(b_shape, generator=gen, device=dev) * scale).to(torch.bfloat16)
    if spec["kind"] == "corr_vjp":
        g = torch.randn(args[0], generator=gen, device=dev).to(torch.bfloat16)
        return a, b, (g, *args[1:])
    return a, b, tuple(args)


def kernel_errors(spec, a, b, args=()):
    """The bf16 and f32 kernels against the plain version in f32 (TF32 off)
    on the same bf16 inputs: max errors and counts outside the tolerance,
    over every output (the VJP has two)."""
    kind = spec["kind"]
    outs = lambda y: list(y) if isinstance(y, tuple) else [y]
    f32 = lambda xs: tuple(x.float() if torch.is_tensor(x) else x for x in xs)
    absf = lambda xs: tuple(x.float().abs() if torch.is_tensor(x) else x for x in xs)
    flat = lambda ys: torch.cat([y.float().flatten() for y in ys])
    out_shapes = spec["out"](tuple(a.shape), tuple(b.shape), *args)
    out_shapes = out_shapes if isinstance(out_shapes, list) else [out_shapes]
    # the stem's assembly reads float32 maps and writes bf16 or float32
    st = (torch.float32,) if kind == "stem" else ()
    ref = outs(spec["plain"](a.float(), b.float(), *f32(args), *st))
    y = outs(spec["kernel"](a, b, *args))
    y32 = outs(spec["kernel"](a.float(), b.float(), *f32(args), *st))
    want = torch.float32 if kind == "dk" else torch.bfloat16
    torch.cuda.synchronize()
    for out, dt in ((y, want), (y32, torch.float32)):
        for o, shape in zip(out, out_shapes):
            if tuple(o.shape) != tuple(shape) or o.dtype != dt:
                raise RuntimeError(f"{spec['name']}: output {tuple(o.shape)} {o.dtype}, "
                                   f"expected {tuple(shape)} {dt}")
    refc = flat(ref)
    err = (flat(y) - refc).abs()
    err32 = (flat(y32) - refc).abs()
    if kind in ("dk", "corr", "corr_vjp", "stem"):
        scale = flat(outs(spec["plain"](a.float().abs(), b.float().abs(), *absf(args), *st)))
        tol32 = (DK_ATOL + DK_RTOL * scale) if kind == "dk" else CORR_SCALE_TOL * scale
        tol = tol32 if kind == "dk" else tol32 + CORR_BF16_RTOL * refc.abs()
    elif kind == "copy":
        # the copy must give the plain version's bits in either dtype
        scale = refc.abs()
        tol = tol32 = torch.zeros_like(refc)
    else:
        scale = refc.abs()
        tol = BF16_ATOL + BF16_RTOL * scale
        tol32 = F32_ATOL + F32_RTOL * scale
    res = dict(max_abs_err=err.max().item(), ref_max_abs=refc.abs().max().item(),
               n_outside_tol=(err > tol).sum().item(), f32_max_abs_err=err32.max().item(),
               f32_n_outside_tol=(err32 > tol32).sum().item())
    if kind in ("dk", "corr", "corr_vjp", "stem"):
        res["max_err_over_scale"] = (err / scale.clamp(min=1e-30)).max().item()
    if kind == "stem":
        res["same_bits_as_plain"] = bool(torch.equal(y32[0], ref[0])
                                         and torch.equal(y[0], spec["plain"](a, b, *args)))
    if kind == "copy":
        res["bit_exact"] = bool(torch.equal(y[0], spec["plain"](a, b, *args))
                                and torch.equal(y32[0], ref[0]))
    if kind in ("dk", "corr_vjp"):
        # a weight gradient and the VJP are the same bits on every launch
        again = outs(spec["kernel"](a, b, *args))
        torch.cuda.synchronize()
        res["bit_identical"] = all(torch.equal(u, v) for u, v in zip(y, again))
    bad = (res["n_outside_tol"] or res["f32_n_outside_tol"]
           or not res.get("bit_identical", True) or not res.get("bit_exact", True))
    if bad or not all(torch.isfinite(o.float()).all() for o in y):
        emit({"kernel_failure": {"kernel": spec["name"], "a": list(a.shape),
                                 "args": [list(x.shape) if torch.is_tensor(x) else x
                                          for x in args], **res}})
        raise RuntimeError(f"{spec['name']} at {tuple(a.shape)}: {res['n_outside_tol']} "
                           f"bf16 / {res['f32_n_outside_tol']} f32 outputs outside tolerance, "
                           f"bit-identical {res.get('bit_identical', 'n/a')}, "
                           f"bit-exact {res.get('bit_exact', 'n/a')}")
    return res


def tolerance_text(spec) -> str:
    if spec["kind"] == "dk":
        return (f"|dk - ref| <= {DK_ATOL} + {DK_RTOL} (|x|^T |g|), bf16 and f32 kernels; "
                "two launches bit-identical")
    if spec["kind"] == "copy":
        return "bit-exact: the plain version's bits in bf16 and f32"
    if spec["kind"] == "corr":
        return (f"|k - ref| <= {CORR_SCALE_TOL} (|fL| . |fR|) + 2^-8 |ref| (f32: "
                f"{CORR_SCALE_TOL} (|fL| . |fR|))")
    if spec["kind"] == "corr_vjp":
        return (f"|k - ref| <= {CORR_SCALE_TOL} vjp(|fL|, |fR|, |g|) + 2^-8 |ref| against the "
                f"plain VJP summed in float32 on the same inputs (f32: {CORR_SCALE_TOL} "
                "vjp(|fL|, |fR|, |g|)); two launches bit-identical")
    if spec["kind"] == "stem":
        return (f"|k - ref| <= {CORR_SCALE_TOL} assembly(|A|, |B|) + 2^-8 |ref| (f32 output: "
                f"{CORR_SCALE_TOL} assembly(|A|, |B|))")
    return f"|k - ref| <= {BF16_ATOL} + 2^-8 |ref| (f32: {F32_ATOL} + {F32_RTOL} |ref|)"


def check_edges(spec, dev, gen):
    """Ragged-edge shapes: errors only."""
    rows = []
    for a_s, b_s, *args in spec["edges"]:
        a, b, targs = kernel_inputs(spec, a_s, b_s, args, dev, gen)
        rows.append(dict(a=list(a_s), b=list(b_s), args=args,
                         **kernel_errors(spec, a, b, targs)))
    emit({"kernel_edges": {"kernel": spec["name"], "cases": rows}})


def staged_mb(name, a, b, sms, args=()):
    """MB per launch that kernels A-G move from L2 into shared memory at
    operand shapes ``a`` (x) and ``b`` (the kernel or the cotangent): input
    rows and columns with their halo, kernel columns, cotangent rows, each
    copy counted once per block that makes it; in bf16 for the
    s1_fwd_ring.cuh / s2_ring.cuh / s1_dk_ring.cuh / deconv ring designs and
    for the earlier tiles (conv_k3.cuh, dk_k3.cuh, D's output rows: their
    f32 instantiations' design).  For J (``a`` a tap map, ``args`` (D,
    mask_left)) the map bytes its blocks read from L2 into shared memory or
    registers, for the grouped row walk and for the earlier per-tap tiles
    (B staged over tile + D + 3 columns a block).  None for the other
    kernels."""
    from dsmnet_tpu_torch.ops import conv2d, conv3d

    cdiv = lambda p, q: -(-p // q)
    if name not in ("conv2d_k3", "conv3d_k3", "conv2d_dk_k3", "conv3d_k3s2", "conv3d_dk_k3s2",
                    "conv3d_dk_k3", "deconv3d_k3s2", "fused_costvol"):
        return None
    if name == "conv2d_k3":
        n, h, w, c = a
        seg = conv2d.K2_SEGMENT
        items = conv2d.k2_items(n, h, w)
        # per block: its 9 c x 32 kernel rows and each run's input rows
        # max(h0 - 1, 0) .. min(h1, h - 1), one seg + 2-column box each
        new = sum(9 * c * 32 + (seg + 2) * c * sum(
            min(h1, h - 1) - max(h0 - 1, 0) + 1 for _, h0, h1 in runs)
            for runs in conv3d.k3_runs(items, h, conv2d.k2_run(items, sms))) * 2
        # conv_k3.cuh: blocks of 4 rows x 64 columns, each its 6 input rows
        # of 66 columns and the whole 9 c x 32 kernel
        old = n * cdiv(h, 4) * cdiv(w, 64) * (6 * 66 * c + 9 * c * 32) * 2
        return new / 1e6, old / 1e6
    if name == "fused_costvol":
        n, h, w, o9 = a
        D = args[0]
        taps = [(t // 3 - 1, t % 3 - 1) for t in range(9)]
        # the in-image A taps of every column, read once in both designs
        a_cols = sum(1 for v in range(w) for _, dw in taps if 0 <= v + dw < w)
        # grouped walk: the in-image B taps at s = -2 .. w - 1 (u = s + dw - dd)
        new_b = sum(1 for s in range(-2, w) for dd, dw in taps if 0 <= s + dw - dd < w)
        # per-tap tiles: tile columns a block, B's in-image columns of
        # [w0 - D - 1, w0 + tile + 2) staged at all 9 taps
        tile = 256 // (o9 // 36)
        old_b = 9 * sum(max(0, min(w, w0 + tile + 2) - max(0, w0 - D - 1))
                        for w0 in range(0, w, tile))
        per_col = o9 // 9 * 4
        return (n * h * (a_cols + new_b) * per_col / 1e6,
                n * h * (a_cols + old_b) * per_col / 1e6)
    if name == "conv2d_dk_k3":
        n, h, w, c = a
        tw, cob, _ = conv2d.DK_TILE
        rows = conv2d.dk_rows(n, h, w)
        x_b, g_b = (tw + 2) * c * 2, tw * cob * 2
        # each row brings its g segment and x row oh + 1; each line's first
        # row also x row 0, a chunk's first row inside a line x rows oh and
        # oh - 1
        firsts = sum(2 for lo, _ in _f_ranges(rows, conv2d.dk_chunks(rows, sms)) if lo % h)
        new = rows * (x_b + g_b) + (n * cdiv(w, tw) + firsts) * x_b
        # dk_k3.cuh: 3 kh tap groups per 64-position segment, its g segment
        # and one x row of 66 columns each
        old = 3 * n * h * cdiv(w, 64) * (64 * 32 + 66 * c) * 2
        return new / 1e6, old / 1e6
    n, d, h, w, c = a
    if name == "conv3d_k3":
        co = b[-1]
        rh, tm = conv3d.K3_TILE
        cob = conv3d.K3_COB[c, co]
        box = (rh + 2) * (tm + 2) * c * 2
        tiles = n * cdiv(h, rh) * cdiv(w, tm)
        # the input slices that some block's taps read: 3 D - 2 (n, tile,
        # slice, kd) triples (D = 1: one)
        reads = tiles * (3 * d - 2 if d > 1 else 1)
        if c == 128:
            # the split: one box and the 9 c x cob rows of its kd per block
            # that reads a slice, for each Co tile
            new = co // cob * reads * (box + 9 * c * cob * 2)
        else:
            # per Co tile and block: its 27 c x cob kernel columns, and each
            # run's input slices max(d0 - 1, 0) .. min(d1, d - 1)
            items = conv3d.k3_items(n, d, h, w)
            blocks = conv3d.k3_runs(items, d, conv3d.k3_run(items, c, co, sms))
            new = co // cob * sum(27 * c * cob * 2 + box * sum(
                min(d1, d - 1) - max(d0 - 1, 0) + 1 for _, d0, d1 in runs) for runs in blocks)
        # conv_k3.cuh: blocks of rh x tm outputs of one (n, d), per kd that
        # reads a slice its rh + 2 rows of tm + 2 columns and the kd's nine
        # c x co kernel slices
        tm, rh = {(32, 32): (64, 4), (32, 64): (64, 2), (64, 32): (48, 4), (64, 64): (48, 4),
                  (128, 128): (16, 4)}[c, co]
        old = n * cdiv(h, rh) * cdiv(w, tm) * (3 * d - 2 if d > 1 else 1) * (
            (rh + 2) * (tm + 2) * c + 9 * c * co) * 2
        return new / 1e6, old / 1e6
    if name == "conv3d_k3s2":
        do, ho, wo = d // 2, h // 2, w // 2
        rh, tm, ncob = conv3d.S2_FWD_TILES[c]
        runs = conv3d.s2_fwd_runs(do, conv3d.s2_fwd_run(n, do, ho, wo, c, sms))
        cols = n * cdiv(ho, rh) * cdiv(wo, tm) * ncob
        # every run stages its 2 r + 1 slices (both parity planes of
        # tm + 1 pairs) and the block's 27 c x 64 / ncob kernel columns
        new = cols * (sum(2 * (e - b) + 1 for b, e in runs) * (2 * rh + 1) * 2 * (tm + 1) * c
                      + len(runs) * 27 * c * 64 // ncob) * 2
        # conv_k3.cuh: blocks of rh x tm outputs of one (n, d), 3 kd x
        # (2 rh + 1) rows of 2 tm + 1 columns and the whole kernel each
        tm, rh = (32, 8) if c == 32 else (16, 4)
        old = cdiv(wo, tm) * cdiv(ho, rh) * n * do * (
            3 * (2 * rh + 1) * (2 * tm + 1) * c + 27 * c * 64) * 2
        return new / 1e6, old / 1e6
    if name == "conv3d_dk_k3s2":
        dg, tw = d // 2, conv3d.S2_DK_SEGMENT
        rows = conv3d.s2_dk_rows(n, d, h, w)
        chunks = conv3d.s2_dk_chunks(rows, c, sms)
        # 3 kd blocks per row: the g segment, two x rows of both parity planes
        # of tw + 1 pairs (none for slice -1, kd = 0 at od = 0), and two halo
        # rows per chunk
        x_rows = 3 * rows - rows // dg
        new = (3 * rows * tw * 64 + (x_rows + 3 * chunks) * 2 * 2 * (tw + 1) * c) * 2
        # dk_k3.cuh: 9 tap groups per row segment, its g and one x row of
        # 2 tw + 1 columns each
        old = 9 * rows * (tw * 64 + (2 * tw + 1) * c) * 2
        return new / 1e6, old / 1e6
    if name == "conv3d_dk_k3":
        co = b[-1]
        tw, cob, _ = conv3d.DK_K3_TILES[c, co]
        nseg = cdiv(w, tw)
        rows = conv3d.dk_k3_rows(n, d, h, w, c, co)
        x_b, g_b = (tw + 2) * c * 2, tw * cob * 2
        # per Co tile and kd block: each row of a slice in the volume (not
        # kd = 0 at od = 0 nor kd = 2 at od = D - 1) brings its g segment and
        # x row oh + 1; each such line's first row also x row 0; a chunk's
        # first row also x rows oh and oh - 1 (when oh > 0)
        lines = n * nseg * (3 * d - 2)
        firsts = 0
        for lo, _ in _f_ranges(rows, conv3d.dk_k3_chunks(rows, c, co, sms)):
            line, oh = divmod(lo, h)
            od = line // nseg % d
            if oh:
                firsts += 2 * (1 + (od > 0) + (od < d - 1))
        new = co // cob * (lines * h * (x_b + g_b) + (lines + firsts) * x_b)
        # dk_k3.cuh: 9 (kd, kh) tap groups x Co tiles per row segment, its g
        # segment and one x row of tw + 2 columns each
        tw, cob = (32, 32) if c == 128 else (64 if c == 32 else 48, co)
        old = 9 * co // cob * n * d * h * cdiv(w, tw) * (tw * cob + (tw + 2) * c) * 2
        return new / 1e6, old / 1e6
    if name == "deconv3d_k3s2":
        rh, tm = conv3d.DECONV_TILE
        runs = conv3d.deconv_runs(d, conv3d.deconv_run(n, d, h, w, sms))
        cols = n * cdiv(h, rh) * cdiv(w, tm)
        # per block: its slices u0 .. min(u1, D - 1), rh + 1 rows of tm + 1
        # columns each, and the resident kernel (27 x 32 x 64)
        new = cols * sum((min(e + 1, d) - b) * (rh + 1) * (tm + 1) * 64 + 27 * 32 * 64
                         for b, e in runs) * 2
        # one output row per block, 64 input columns: its <= 2 x 2 input
        # rows of 65 columns and a 3 x 32 x 64 kernel slice per row pair
        # (2.25 pairs per output row on average)
        old = n * 2 * d * 2 * h * cdiv(w, 64) * 2.25 * (65 * 64 + 3 * 32 * 64) * 2
        return new / 1e6, old / 1e6


def _f_ranges(rows, chunks):
    """The rows [lo, hi) that each chunk of kernel F or G sums."""
    per = -(-rows // chunks)
    return [(k * per, min(rows, (k + 1) * per)) for k in range(chunks)]


MEASURED = {}  # (kernel, a, b, args) -> its row, for a shape that several paths launch


def check_kernel(spec, a_shape, b_shape, launches, path, dev, gen, *args):
    """Errors of the bf16 and f32 kernels against the plain f32 reference, and
    timings; a shape already measured on another path reuses that row."""
    key = (spec["name"], tuple(a_shape), tuple(b_shape), tuple(args))
    if key in MEASURED:
        row = dict(MEASURED[key], path=path, launches=launches)
        emit({"kernel_check": row})
        return row
    a, b, targs = kernel_inputs(spec, a_shape, b_shape, args, dev, gen)
    out_shape = spec["out"](a_shape, b_shape, *args)
    errs = kernel_errors(spec, a, b, targs)
    flops = spec["flops"](a_shape, b_shape, out_shape, *args)
    # each input read once, each output written once (the VJP's two)
    out_shapes = out_shape if isinstance(out_shape, list) else [out_shape]
    out_bytes = (4 if spec["kind"] == "dk" else 2) * sum(math.prod(o) for o in out_shapes)
    nbytes = a.element_size() * (math.prod(a_shape) + math.prod(b_shape)) + out_bytes + sum(
        t.numel() * t.element_size() for t in targs if torch.is_tensor(t))
    peak = spec.get("peak_flops", PEAK_BF16_FLOPS)
    t_flops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    row = dict(
        kernel=spec["name"], path=path, a=list(a_shape), b=list(b_shape), args=list(args),
        out=[list(o) for o in out_shapes] if isinstance(out_shape, list) else list(out_shape),
        launches=launches, **errs, tolerance=tolerance_text(spec),
        kernel_ms=time_ms(lambda: spec["kernel"](a, b, *targs)),
        kernel_host_ms=host_ms(lambda: spec["kernel"](a, b, *targs)),
        plain_ms=time_ms(lambda: spec["plain"](a, b, *targs)),
        library_ms=time_ms(spec["library"](a, b, *targs)),
        bound_ms=max(t_flops, t_bytes), bound_by="operations" if t_flops >= t_bytes else "bytes",
        gflop=flops / 1e9, mbytes=nbytes / 1e6, measured_on=path,
    )
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    staged = staged_mb(spec["name"], a_shape, b_shape, sms, args)
    if staged is not None:
        row["l2_to_shared_mb"], row["l2_to_shared_mb_earlier_tiles"] = staged
    MEASURED[key] = row
    emit({"kernel_check": row})
    return row


def seeded_model(dev, name: str = "psmnet", maxdisp: int | None = None, **kwargs):
    from dsmnet_tpu_torch.models import create_model

    return create_model(name, maxdisp or MAXDISP, **kwargs).reset_parameters(
        torch.Generator().manual_seed(0)).to(dev)


def request_pairs(n: int, h: int, w: int):
    rng = np.random.RandomState(0)
    return [(rng.rand(h, w, 3).astype(np.float32), rng.rand(h, w, 3).astype(np.float32))
            for _ in range(n)]


def f32_vs_f64(model, iL, iR):
    """A float32 forward through the kernels (their f32 instantiations) and
    one on the plain path, both against the float64 plain path: returns the
    plain float32 outputs, the errors, the kernel launches and whether the
    kernels' error is inside MODEL_F32_FACTOR x the plain one's + ATOL."""
    from dsmnet_tpu_torch import config
    from dsmnet_tpu_torch.ops import _build

    with torch.no_grad():
        with config.implementation("plain"):
            ref = model(iL, iR, clamp=True)[1]
            model64 = copy.deepcopy(model).double()
            ref64 = model64(iL.double(), iR.double(), clamp=True)[1]
            del model64
        _build.reset_launches()
        out = model(iL, iR, clamp=True)[1]
        torch.cuda.synchronize()
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    maxdiff = lambda a, b: [(u.double() - v.double()).abs().max().item() for u, v in zip(a, b)]
    d_kernel, d_plain, d_pair = maxdiff(out, ref64), maxdiff(ref, ref64), maxdiff(out, ref)
    row = {"kernels_vs_f64_px": d_kernel, "plain_vs_f64_px": d_plain,
           "kernels_vs_plain_px": d_pair,
           "tolerance": f"kernels_vs_f64 <= {MODEL_F32_FACTOR} * plain_vs_f64"
                        f" + {MODEL_F32_ATOL_PX} px", "launches": launches}
    ok = all(k <= MODEL_F32_FACTOR * p + MODEL_F32_ATOL_PX for k, p in zip(d_kernel, d_plain))
    return ref, row, ok


def run_model(dev, n_requests: int):
    from dsmnet_tpu_torch import config
    from dsmnet_tpu_torch.images import normalize_imagenet
    from dsmnet_tpu_torch.models.layers import calibrate_batch_stats
    from dsmnet_tpu_torch.ops import _build
    from dsmnet_tpu_torch.serve import Predictor

    model = seeded_model(dev)
    pairs = request_pairs(n_requests + 1, H, W)
    iL, iR = (normalize_imagenet(torch.from_numpy(p)[None].to(dev)) for p in pairs[0])

    t0 = time.perf_counter()
    calibrate_batch_stats(model, iL, iR)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0

    # float32 forward: the four kernels (f32 instantiations) and the plain
    # path, both against the float64 plain path
    ref, row, ok = f32_vs_f64(model, iL, iR)
    emit({"model_f32": {**row, "calibrate_s": calib_s}})
    if row["launches"] != REQUEST_LAUNCHES:
        raise RuntimeError(f"f32 forward launches {row['launches']}, expected {REQUEST_LAUNCHES}")
    if not ok:
        raise RuntimeError(f"f32 kernel path error {row['kernels_vs_f64_px']} px vs plain "
                           f"{row['plain_vs_f64_px']} px")

    # bf16 server: warm-up request, then the counted, timed requests
    server = Predictor(model, device=dev, dtype=torch.bfloat16)
    first = server.predict(*pairs[0])
    with config.implementation("plain"):
        first_plain = server.predict(*pairs[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    latencies = []
    for imL, imR in pairs[1:]:
        t0 = time.perf_counter()
        disp = server.predict(imL, imR)  # host numpy: the request has completed
        latencies.append((time.perf_counter() - t0) * 1e3)
        if disp.shape != (1, H, W) or not np.isfinite(disp).all() \
                or disp.min() < 1e-6 or disp.max() > MAXDISP:
            raise RuntimeError(f"bad answer: shape {disp.shape}, range "
                               f"[{np.nanmin(disp)}, {np.nanmax(disp)}]")
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    expected = {k: v * n_requests for k, v in REQUEST_LAUNCHES.items()}
    med = statistics.median(latencies)
    emit({"serve_bf16": {
        "requests": n_requests, "pair": [H, W], "maxdisparity": MAXDISP,
        "latency_ms": latencies, "median_latency_ms": med, "pairs_per_s": 1e3 / med,
        "launches": launches, "expected_launches": expected,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        # the same request: bf16 through the kernels vs bf16 through the
        # plain path (both round to bf16), and vs the float32 plain path
        "bf16_kernels_vs_bf16_plain_px": {"mean": float(np.abs(first - first_plain).mean()),
                                          "max": float(np.abs(first - first_plain).max())},
        "bf16_vs_f32_plain_mean_abs_px": float(np.abs(first - ref[0][..., 0].cpu().numpy()).mean()),
    }})
    if launches != expected:
        raise RuntimeError(f"serving launches {launches}, expected {expected}")
    profile("serve_profile", lambda: server.predict(*pairs[0]))
    return {k: v // n_requests for k, v in launches.items()}


def check_model_f32(dev, name: str, h: int, w: int, maxdisp: int) -> None:
    """Model ``name`` in float32 through the kernels against the plain path,
    both against float64, at h x w and ``maxdisp``, BN statistics (where it
    has BN) calibrated on the same pair (``model_<name>_f32``)."""
    from dsmnet_tpu_torch.images import normalize_imagenet
    from dsmnet_tpu_torch.models.layers import calibrate_batch_stats

    model = seeded_model(dev, name, maxdisp)
    pair = request_pairs(1, h, w)[0]
    iL, iR = (normalize_imagenet(torch.from_numpy(p)[None].to(dev)) for p in pair)
    calibrate_batch_stats(model, iL, iR)
    t0 = time.perf_counter()
    _, row, ok = f32_vs_f64(model, iL, iR)
    emit({f"model_{name}_f32": {"pair": [h, w], "maxdisparity": maxdisp, **row,
                                "three_passes_s": time.perf_counter() - t0}})
    expected = SERVE_LAUNCHES[name]
    if row["launches"] != expected:
        raise RuntimeError(f"{name} f32 launches {row['launches']}, expected {expected}")
    if not ok:
        raise RuntimeError(f"{name} f32 kernel path error {row['kernels_vs_f64_px']} px vs "
                           f"plain {row['plain_vs_f64_px']} px")


def check_stem_op(dev, gen) -> None:
    """The whole fused stem in bf16 (the float32 tap maps, then J) at
    PSMNet's serving and train-step shapes, next to the same op on the
    plain assembly, to the tap maps alone and to kernel H building the
    (N, D, H, W, 64) volume that the fused stem never builds."""
    from dsmnet_tpu_torch import config
    from dsmnet_tpu_torch.ops import cost_volume, fused_costvol

    D4, H4, W4 = MAXDISP // 4, H // 4, W // 4
    for path, n in (("serve", 1), ("train", TRAIN_BATCH)):
        fL, fR = (torch.randn((n, H4, W4, 32), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        k = (torch.randn((3, 3, 3, 64, 32), generator=gen, device=dev) * 0.03).to(torch.bfloat16)

        def op():
            return fused_costvol.cost_volume_conv3x3(fL, fR, k, D4)

        def plain_op():
            with config.implementation("plain", ops=("fused_costvol",)):
                return op()

        with torch.no_grad():
            err = (op().float() - plain_op().float()).abs().max().item()
            emit({"stem_op": dict(
                path=path, features=[n, H4, W4, 32], D=D4, op_vs_plain_max_abs_err=err,
                op_ms=time_ms(op), op_plain_ms=time_ms(plain_op),
                tap_maps_ms=time_ms(lambda: fused_costvol.tap_maps(fL, fR, k)),
                volume_h_ms=time_ms(lambda: cost_volume.cost_volume_kernel(fL, fR, D4)))})


def serve_model(name: str, dev, n_requests: int) -> dict:
    """A bf16 ``Predictor`` of ``name`` at H x W, maxdisparity MAXDISP, with
    seeded weights and BN statistics calibrated by one float32 train-mode
    forward: a warm-up request, then ``n_requests`` counted, timed requests,
    each of which must launch SERVE_LAUNCHES[name]; then one profiled
    request.  Returns the launches of one request."""
    from dsmnet_tpu_torch.images import normalize_imagenet
    from dsmnet_tpu_torch.models.layers import calibrate_batch_stats
    from dsmnet_tpu_torch.ops import _build
    from dsmnet_tpu_torch.serve import Predictor

    path = SERVE_PATHS[name]
    net, kwargs = SERVE_NETS.get(name, (name, {}))
    model = seeded_model(dev, net, **kwargs)
    pairs = request_pairs(n_requests + 1, H, W)
    iL, iR = (normalize_imagenet(torch.from_numpy(p)[None].to(dev)) for p in pairs[0])
    t0 = time.perf_counter()
    calibrate_batch_stats(model, iL, iR)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    server = Predictor(model, device=dev, dtype=torch.bfloat16)
    server.predict(*pairs[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    latencies, counts = [], []
    for imL, imR in pairs[1:]:
        _build.reset_launches()
        t0 = time.perf_counter()
        disp = server.predict(imL, imR)  # host numpy: the request has completed
        latencies.append((time.perf_counter() - t0) * 1e3)
        counts.append({k: v for k, v in _build.LAUNCHES.items() if v})
        if disp.shape != (1, H, W) or not np.isfinite(disp).all() \
                or disp.min() < 1e-6 or disp.max() > MAXDISP:
            raise RuntimeError(f"{name}: bad answer: shape {disp.shape}, range "
                               f"[{np.nanmin(disp)}, {np.nanmax(disp)}]")
    med = statistics.median(latencies)
    expected = SERVE_LAUNCHES[name]
    emit({f"{path}_bf16": {
        "net": name, "requests": n_requests, "pair": [H, W], "maxdisparity": MAXDISP,
        "latency_ms": latencies, "median_latency_ms": med, "pairs_per_s": 1e3 / med,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "calibrate_s": calib_s,
        "launches_per_request": counts, "expected_launches_per_request": expected,
        "answer_range_px": [float(disp.min()), float(disp.max())]}})
    if any(c != expected for c in counts):
        raise RuntimeError(f"{name} serving launches {counts}, expected {expected} per request")
    profile(f"{path}_profile", lambda: server.predict(*pairs[0]))
    return counts[-1]


def kernel_table(prof) -> list:
    """(name, device ms, count) of a profile's kernels and copies, the
    longest first."""
    kernels = []
    for e in prof.key_averages():
        # a user-annotated range (the optimizer's step) is mirrored on the
        # device timeline and would count the kernels inside it twice
        if e.device_type != torch.autograd.DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        kernels.append((e.key[:80], us / 1e3, e.count))
    return sorted(kernels, key=lambda r: -r[1])


def device_ms(prof) -> float:
    """The device ms of a profile's kernels and copies."""
    return sum(ms for _, ms, _ in kernel_table(prof))


def under(prof, name: str) -> dict:
    """The device ms and kernel launches under each host-side event of a
    profile whose name holds ``name`` (outermost ones only), summed over
    them, and the launches and ms by kernel name: under ``_Corr1dBackward``
    the correlation's backward (its VJP and whatever it runs: the plain
    VJP's elementwise and indexing kernels, or the VJP kernel and a copy of
    a strided cotangent); under the ``photometric_loss`` span of
    ``train.steps.selfsup_loss`` the self-supervised loss's forward."""

    def inside(e):
        p = e.cpu_parent
        while p is not None:
            if name in p.name:
                return True
            p = p.cpu_parent
        return False

    def kernels(e):
        return list(e.kernels) + [k for c in e.cpu_children for k in kernels(c)]

    nodes = [e for e in prof.events() if name in e.name and not inside(e)
             and e.device_type == torch.autograd.DeviceType.CPU]
    by_name = {}
    for k in (k for e in nodes for k in kernels(e)):
        n, ms = by_name.get(k.name[:80], (0, 0.0))
        by_name[k.name[:80]] = (n + 1, ms + k.duration / 1e3)
    return {"nodes": len(nodes), "device_ms": sum(e.device_time_total for e in nodes) / 1e3,
            "launches": sum(n for n, _ in by_name.values()), "kernels": by_name}


def profile(tag: str, fn, top: int = 25) -> None:
    """Where one call's time goes: device time by kernel under
    torch.profiler, the device's busy share of the call's wall time, and
    the correlation's backward (``corr_backward``) and the photometric loss
    (``photometric_loss``) where the call has them."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = kernel_table(prof)
    device_ms = sum(ms for _, ms, _ in kernels)
    ported_ms = sum(ms for name, ms, _ in kernels if any(
        s in name for s in ("conv_k3_kernel", "s1_fwd_kernel", "s1_fwd_split_kernel",
                            "s1_fwd_reduce", "s2_fwd_kernel", "deconv_k3s2_kernel",
                            "deconv_ring_kernel", "dk_k3_kernel", "s1_dk_kernel",
                            "s2_dk_kernel", "dk_reduce",
                            "cost_volume_kernel", "corr1d_", "fused_costvol_kernel")))
    row = {"wall_ms": wall_ms, "device_ms": device_ms, "device_busy_share": device_ms / wall_ms,
           "ported_kernels_ms": ported_ms, "top_kernels_ms_count": kernels[:top]}
    for key, name in (("corr_backward", "_Corr1dBackward"),
                      ("photometric_loss", "photometric_loss")):
        spans = under(prof, name)
        if spans["nodes"]:
            row[key] = spans
    emit({tag: row})


def train_batch(n: int, dev, h: int = H, w: int = W) -> torch.Tensor:
    """A fixed random 7-channel batch as bench.py:84-86 builds it."""
    rng = np.random.RandomState(0)
    b = rng.rand(n, h, w, 7).astype(np.float32)
    b[..., 6] = b[..., 6] * 100 + 1
    return torch.from_numpy(b).to(dev)


def selfsup_batch(n: int, dev, h: int = H, w: int = W) -> torch.Tensor:
    """A fixed batch of ``n`` consistent synthetic h x w pairs with their
    disparity, in [0, 1] as the self-supervised loaders give them
    (``data.SyntheticStereoDataset``, samples 0 .. n - 1)."""
    from dsmnet_tpu_torch.data import SyntheticStereoDataset, selfsup_eval_transform

    ds = SyntheticStereoDataset(n=n, hw=(h, w), transform=selfsup_eval_transform())
    return torch.from_numpy(np.stack([ds[i][0] for i in range(n)])).to(dev)


def loss_weights(model) -> np.ndarray:
    """The curriculum's weights once its sweep is over (1 at full
    resolution, 0.01 at the other scales): one 1 for a one-level model."""
    from dsmnet_tpu_torch.losses import parse_loss_name

    return parse_loss_name("supervised", model.count_levels).weights(1)


def zero_gradient_params(model) -> set[str]:
    """Parameters whose gradient is 0 in exact arithmetic: the bias of a
    conv or deconv that feeds a BN, and GCNet's l37 bias (the soft-argmin is
    shift-invariant).  Their float32 and float64 gradients are rounding
    noise, so their error is measured against the norm of the float64
    gradient of the same layer's kernel."""
    from dsmnet_tpu_torch.models.layers import ConvBN, DeconvBN

    names = {f"{m}.{k}.bias" for m, mod in model.named_modules()
             if isinstance(mod, (ConvBN, DeconvBN)) and mod.BatchNorm_0 is not None
             for k in ("Conv_0", "ConvTranspose_0")
             if getattr(mod, k, None) is not None and getattr(mod, k).bias is not None}
    if type(model).__name__ == "GCNet":
        names.add("layer3d.l37.ConvTranspose_0.bias")
    return names


def check_gradients(dev, name: str = "psmnet", h: int = H, w: int = W,
                    maxdisp: int = MAXDISP, tag: str = "grad_f32",
                    loss_name: str = "supervised") -> None:
    """Every parameter's float32 gradient of ``name`` through the kernels
    against the float64 plain model, next to the float32 plain path's own
    error, on one h x w pair: of the supervised loss, or of a photometric
    ``loss_name``'s self-supervised step (the two forwards, the loss of
    ``train.steps.selfsup_loss``) with the draws of step 0 injected."""
    from dsmnet_tpu_torch import config
    from dsmnet_tpu_torch.losses import parse_loss_name, supervised_pyramid_loss
    from dsmnet_tpu_torch.ops import _build
    from dsmnet_tpu_torch.train import draw_selfsup_params, selfsup_generator, selfsup_loss

    model = seeded_model(dev, name, maxdisp).train()
    spec = parse_loss_name(loss_name, model.count_levels)
    if spec.supervised:
        batch, weights = train_batch(1, dev, h, w), loss_weights(model)
        expected = TRAIN_LAUNCHES[name]
    else:
        batch, weights = selfsup_batch(1, dev, h, w), spec.weights(1)
        draws = draw_selfsup_params(selfsup_generator(SELFSUP_SEED, 0), 1)
        expected = SELFSUP_LAUNCHES[name]

    def grads(m, b):
        m.zero_grad(set_to_none=True)
        if spec.supervised:
            scales, disps = m(b[..., :3], b[..., 3:6])
            loss = supervised_pyramid_loss(b[..., 6:7], disps, scales, weights)
        else:
            loss = selfsup_loss(m, spec.photo, b, SELFSUP_NEDGE if spec.flag_mask else 0,
                                weights, draws.to(b.device))[0]
        loss.backward()
        return loss.item(), {n: p.grad.double() for n, p in m.named_parameters()}

    _build.reset_launches()
    loss_k, g_k = grads(model, batch)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    with config.implementation("plain"):
        loss_p, g_p = grads(model, batch)
        model64 = copy.deepcopy(model).double()
        loss_64, g_64 = grads(model64, batch.double())
        del model64
    zero = zero_gradient_params(model)
    # the norm each error is measured against: the gradient's own, or for a
    # gradient that is 0 in exact arithmetic, its layer's kernel gradient's
    scale = {n: (g_64[n.replace(".bias", ".kernel")] if n in zero else g_64[n]).norm()
             for n in g_64}
    rel = lambda a, b, n: ((a - b).norm() / scale[n].clamp(min=1e-300)).item()
    rows = {n: (rel(g_k[n], g_64[n], n), rel(g_p[n], g_64[n], n)) for n in g_64}
    floor = GRAD_F32_FLOOR_SHARE * statistics.median(r[1] for r in rows.values())
    limit = lambda r: GRAD_F32_FACTOR * r[1] + floor
    bad = {n: r for n, r in rows.items() if not r[0] <= limit(r)}
    worst = sorted(rows.items(), key=lambda kv: -kv[1][0])[:5]
    # the parameters nearest their limit: (kernels, plain, kernels / limit)
    tightest = [(n, (*r, r[0] / limit(r))) for n, r in
                sorted(rows.items(), key=lambda kv: -kv[1][0] / limit(kv[1]))[:5]]
    emit({tag: {
        "net": name, "loss_name": loss_name, "pair": [h, w], "maxdisparity": maxdisp,
        "batch": 1, "params": len(rows),
        "zero_in_exact_arithmetic": len(zero),
        "loss": {"kernels": loss_k, "plain_f32": loss_p, "f64": loss_64},
        "max_rel_err_kernels": max(r[0] for r in rows.values()),
        "max_rel_err_plain": max(r[1] for r in rows.values()),
        "median_rel_err_kernels": statistics.median(r[0] for r in rows.values()),
        "median_rel_err_plain": statistics.median(r[1] for r in rows.values()),
        "worst_kernels": worst, "tightest": tightest, "outside_tol": bad,
        "tolerance": f"per parameter |g - g64| / |g64| (a gradient 0 in exact arithmetic: "
                     f"/ |g64 of its layer's kernel|): kernels <= {GRAD_F32_FACTOR} * plain"
                     f" + {GRAD_F32_FLOOR_SHARE} * median(plain) = {floor:.3g}",
        "launches": launches, "expected_launches": expected}})
    if launches != expected:
        raise RuntimeError(f"{name} f32 gradient launches {launches}, expected {expected}")
    if bad:
        raise RuntimeError(f"{name}: {len(bad)} parameter gradients outside tolerance: {bad}")


TRAIN_ROWS = {}  # path -> the row run_training printed for it


def run_training(dev, name: str = "psmnet") -> dict:
    """The supervised train step of ``name`` (TRAIN_RUNS: path, batch,
    steps, Adam's lr), bf16, at H x W and maxdisparity MAXDISP, on one
    fixed batch: every step's launches must equal
    TRAIN_LAUNCHES[name] and the loss must fall.  PSMNet, GCNet, DispNetC
    and iResNet are also profiled for one step.  Returns the launches of one
    step."""
    from dsmnet_tpu_torch.models.layers import compute_dtype
    from dsmnet_tpu_torch.ops import _build
    from dsmnet_tpu_torch.train import create_train_state, make_supervised_train_step

    path, batch_n, steps, lr = TRAIN_RUNS[name]
    state, opt = create_train_state(seeded_model(dev, name), device=dev)
    step = make_supervised_train_step(state.model, opt)
    batch = train_batch(batch_n, dev)
    weights = loss_weights(state.model)
    expected = TRAIN_LAUNCHES[name]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, counts = [], [], []
    with compute_dtype(torch.bfloat16):
        for _ in range(steps):
            _build.reset_launches()
            t0 = time.perf_counter()
            m = step(state, batch, lr, weights)
            loss = m["loss"].item()  # synchronises: the step has completed
            step_ms.append((time.perf_counter() - t0) * 1e3)
            counts.append({k: v for k, v in _build.LAUNCHES.items() if v})
            losses.append(loss)
        metrics = {k: v.item() for k, v in m.items()}
        peak = torch.cuda.max_memory_allocated() / 1e9
        if name in ("psmnet", "gcnet", "dispnetcorr", "iresnet"):
            profile(f"{path}_profile", lambda: step(state, batch, lr, weights))
    med = statistics.median(step_ms[1:])  # the first step also warms the allocator
    TRAIN_ROWS[path] = {
        "net": name, "batch": batch_n, "crop": [H, W], "maxdisparity": MAXDISP, "steps": steps,
        "lr": lr, "loss": losses, "last_metrics": metrics, "step_ms": step_ms,
        "median_step_ms": med, "frames_per_s": batch_n * 1e3 / med, "peak_mem_gb": peak,
        "launches_per_step": counts[-1], "expected_launches_per_step": expected}
    emit({f"{path}_bf16": TRAIN_ROWS[path]})
    if any(c != expected for c in counts):
        raise RuntimeError(f"{name} train-step launches {counts}, expected {expected} per step")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise RuntimeError(f"{name}: the loss did not fall over {steps} steps: {losses}")
    return counts[-1]


def profile_train_step(dev, name: str) -> None:
    """One bf16 train step of ``name`` (TRAIN_RUNS' batch and lr) profiled
    after two unprofiled ones, launches unchecked: the profile alone, for a
    run with ``--profile-train`` (on this tree or on another commit's)."""
    from dsmnet_tpu_torch.models.layers import compute_dtype
    from dsmnet_tpu_torch.train import create_train_state, make_supervised_train_step

    path, batch_n, _, lr = TRAIN_RUNS[name]
    state, opt = create_train_state(seeded_model(dev, name), device=dev)
    step = make_supervised_train_step(state.model, opt)
    batch = train_batch(batch_n, dev)
    weights = loss_weights(state.model)
    with compute_dtype(torch.bfloat16):
        for _ in range(2):
            step(state, batch, lr, weights)["loss"].item()
        profile(f"{path}_profile", lambda: step(state, batch, lr, weights))


def run_selfsup_training(dev, name: str) -> dict:
    """The self-supervised train step of ``name`` (SELFSUP_RUNS: path, loss
    name, batch, steps, Adam's lr), bf16, on one fixed batch of 384x768
    synthetic pairs (256x640 views into the model), each step with its
    own draws (``selfsup_generator(SELFSUP_SEED, step)``): every step's
    launches must equal SELFSUP_LAUNCHES[name], and the eval step's loss on
    the batch (no jitter, BN on running statistics, first calibrated on the
    batch's views) must fall from before the steps to after them.  Beside
    it are reported the eval's D1 and EPE and its appearance term, the
    loss's 0.425 (1 - SSIM) + 0.15 L1 summed over the heads and both views
    without occlusion weights.  Then one profiled step.  Returns the
    launches of one step."""
    from dsmnet_tpu_torch.losses import PhotoLossConfig, parse_loss_name
    from dsmnet_tpu_torch.models.layers import calibrate_batch_stats, compute_dtype
    from dsmnet_tpu_torch.ops import _build
    from dsmnet_tpu_torch.train import (
        create_train_state,
        draw_selfsup_params,
        make_selfsup_eval_step,
        make_selfsup_train_step,
        normalize_imagenet,
        selfsup_generator,
    )

    path, loss_name, batch_n, steps, lr = SELFSUP_RUNS[name]
    state, opt = create_train_state(seeded_model(dev, name), device=dev)
    spec = parse_loss_name(loss_name, state.model.count_levels)
    nedge = SELFSUP_NEDGE if spec.flag_mask else 0
    batch = selfsup_batch(batch_n, dev)
    views = normalize_imagenet(batch[:, nedge:H - nedge, nedge:W - nedge, :6])
    calibrate_batch_stats(state.model, views[..., :3], views[..., 3:6])
    weights = spec.weights(1)
    step = make_selfsup_train_step(state.model, opt, spec.photo, nedge)
    evaluate = make_selfsup_eval_step(state.model, spec.photo)
    appearance = make_selfsup_eval_step(
        state.model, PhotoLossConfig("cap", False, with_ds=False, with_lr=False))
    metrics_of = lambda m: {k: v.item() for k, v in m.items() if k != "disp"}
    evals = lambda: {**metrics_of(evaluate(state, batch, weights)),
                     "appearance": appearance(state, batch, weights)["loss"].item()}
    draws = lambda i: draw_selfsup_params(selfsup_generator(SELFSUP_SEED, i), batch_n)
    expected = SELFSUP_LAUNCHES[name]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, counts = [], [], []
    with compute_dtype(torch.bfloat16):
        before = evals()
        for i in range(steps):
            d = draws(i)
            _build.reset_launches()
            t0 = time.perf_counter()
            m = step(state, batch, lr, weights, d)
            loss = m["loss"].item()  # synchronises: the step has completed
            step_ms.append((time.perf_counter() - t0) * 1e3)
            counts.append({k: v for k, v in _build.LAUNCHES.items() if v})
            losses.append(loss)
        metrics = {k: v.item() for k, v in m.items()}
        peak = torch.cuda.max_memory_allocated() / 1e9
        after = evals()
        d = draws(steps)
        profile(f"{path}_profile", lambda: step(state, batch, lr, weights, d))
    med = statistics.median(step_ms[1:])  # the first step also warms the allocator
    TRAIN_ROWS[path] = {
        "net": name, "loss_name": loss_name, "batch": batch_n, "pair": [H, W],
        "views": [SH, SW] if nedge else [H, W], "maxdisparity": MAXDISP, "steps": steps,
        "lr": lr, "loss": losses, "last_metrics": metrics, "eval_before": before,
        "eval_after": after, "step_ms": step_ms, "median_step_ms": med,
        "frames_per_s": batch_n * 1e3 / med, "peak_mem_gb": peak,
        "launches_per_step": counts[-1], "expected_launches_per_step": expected}
    emit({f"{path}_bf16": TRAIN_ROWS[path]})
    if any(c != expected for c in counts):
        raise RuntimeError(f"{name} self-supervised launches {counts}, expected {expected} "
                           "per step")
    if not all(math.isfinite(v) for v in losses + [*before.values(), *after.values()]) \
            or not after["loss"] < before["loss"]:
        raise RuntimeError(f"{name}: the eval loss did not fall over {steps} self-supervised "
                           f"steps: {before} -> {after} (train {losses})")
    return counts[-1]


def check_remat(dev, name: str = "gcnet", steps: int = 3) -> None:
    """``remat`` on the card (``train_<name>_remat_bf16``): from the same
    weights and batch, one float32 step and one bf16 step of ``name``
    without remat, then ``steps`` bf16 steps with it.  Every remat step
    must launch REMAT_LAUNCHES[name] (the kernels' autograd Functions run
    again in the recomputation); each 3-D stage's BN must see its conv's
    bf16 output twice a step (the forward and the recomputation: every
    stage is recomputed, in the forward's compute dtype); the first remat
    loss must equal the bf16 step's; the first remat gradients must be as
    close to the float32 step's as the bf16 step's are (``check_gradients``'
    rule with the bf16 step in the plain path's place: remat changes only
    the order in which the tower's feature gradients are summed, as the
    volume is built and back-propagated once in each of the two recomputed
    stages that read it, which moves the bf16 rounding of the tower's
    gradients, by up to 5% on the card, but not their distance from
    float32; a missing or doubled term misses by O(1)); and the loss must
    fall over ``steps``."""
    from dsmnet_tpu_torch.models.layers import ConvBN, DeconvBN, compute_dtype
    from dsmnet_tpu_torch.ops import _build
    from dsmnet_tpu_torch.train import create_train_state, make_supervised_train_step

    path, batch_n, _, lr = TRAIN_RUNS[name]
    batch = train_batch(batch_n, dev)
    runs = {}
    for run, remat, dtype in (("f32", False, None), ("bf16", False, torch.bfloat16),
                              ("remat", True, torch.bfloat16)):
        state, opt = create_train_state(seeded_model(dev, name, remat=remat), device=dev)
        step = make_supervised_train_step(state.model, opt)
        weights = loss_weights(state.model)
        dtypes, stages = [], []
        if remat:
            # a pre-hook: the recomputation stops once it has made what the
            # backward reads, before a stage's own forward hook would run
            stages = [m.BatchNorm_0 for m in state.model.modules()
                      if isinstance(m, (ConvBN, DeconvBN)) and m.dims == 3
                      and m.BatchNorm_0 is not None]
            for m in stages:
                m.register_forward_pre_hook(lambda mod, a: dtypes.append(a[0].dtype))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        r = dict(loss=[], launches=[], step_ms=[], dtypes=dtypes, stages=len(stages))
        with compute_dtype(dtype) if dtype else contextlib.nullcontext():
            for i in range(steps if remat else 1):
                _build.reset_launches()
                t0 = time.perf_counter()
                r["loss"].append(step(state, batch, lr, weights)["loss"].item())
                r["step_ms"].append((time.perf_counter() - t0) * 1e3)
                r["launches"].append({k: v for k, v in _build.LAUNCHES.items() if v})
                if i == 0:
                    r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
                    r["grads"] = {n: p.grad.double() for n, p in state.model.named_parameters()}
        runs[run] = r
        zero = zero_gradient_params(state.model)
        del state, opt, step
    g32, g16, rm = runs["f32"]["grads"], runs["bf16"]["grads"], runs["remat"]
    # the norm each error is measured against, as in check_gradients
    scale = {n: (g32[n.replace(".bias", ".kernel")] if n in zero else g32[n]).norm()
             for n in g32}
    rel = lambda a, b, n: ((a[n] - b[n]).norm() / scale[n].clamp(min=1e-300)).item()
    # per parameter: (remat vs f32, bf16 vs f32, remat vs bf16)
    rows = {n: (rel(rm["grads"], g32, n), rel(g16, g32, n), rel(rm["grads"], g16, n))
            for n in g32}
    floor = GRAD_F32_FLOOR_SHARE * statistics.median(r[1] for r in rows.values())
    limit = lambda r: GRAD_F32_FACTOR * r[1] + floor
    bad = {n: r for n, r in rows.items() if not r[0] <= limit(r)}
    expected = REMAT_LAUNCHES[name]
    dtypes, n_stages = rm["dtypes"], rm["stages"]
    n_bf16 = sum(d == torch.bfloat16 for d in dtypes)
    emit({f"{path}_remat_bf16": {
        "net": name, "batch": batch_n, "crop": [H, W], "maxdisparity": MAXDISP, "lr": lr,
        "loss": rm["loss"], "first_loss": {k: runs[k]["loss"][0] for k in runs},
        "step_ms": rm["step_ms"], "first_step_ms": {k: runs[k]["step_ms"][0] for k in runs},
        "peak_mem_gb_first_step": {k: runs[k]["peak_gb"] for k in runs},
        "max_rel_err_remat": max(r[0] for r in rows.values()),
        "max_rel_err_bf16": max(r[1] for r in rows.values()),
        "median_rel_err_remat": statistics.median(r[0] for r in rows.values()),
        "median_rel_err_bf16": statistics.median(r[1] for r in rows.values()),
        "max_rel_diff_remat_vs_bf16": max(r[2] for r in rows.values()),
        "params_remat_equal_bf16": sum(r[2] == 0 for r in rows.values()), "params": len(rows),
        # the parameters nearest their limit: (remat, bf16, remat vs bf16, remat / limit)
        "tightest": [(n, (*r, r[0] / max(limit(r), 1e-300))) for n, r in
                     sorted(rows.items(), key=lambda kv: -kv[1][0] / max(limit(kv[1]), 1e-300))
                     [:5]],
        "tolerance": f"per parameter against the float32 step, |g - g32| / |g32| (0 in exact "
                     f"arithmetic: / |g32 of its layer's kernel|): remat <= "
                     f"{GRAD_F32_FACTOR} * bf16 + {GRAD_F32_FLOOR_SHARE} * median(bf16) = "
                     f"{floor:.3g}; first remat loss equal to the bf16 step's",
        "stages": n_stages, "stage_conv_outputs": len(dtypes), "stage_conv_outputs_bf16": n_bf16,
        "outside_tol": bad,
        "launches_per_step": rm["launches"], "expected_launches_per_step": expected}})
    if any(c != expected for c in rm["launches"]):
        raise RuntimeError(f"{name} remat launches {rm['launches']}, expected {expected} per step")
    if n_bf16 != len(dtypes) or len(dtypes) != 2 * n_stages * steps or not n_stages:
        raise RuntimeError(f"{name} remat: {n_bf16} bf16 conv outputs of {len(dtypes)} seen by "
                           f"the BNs of {n_stages} 3-D stages in {steps} steps (forward and "
                           "recomputation: 2 a step each)")
    if rm["loss"][0] != runs["bf16"]["loss"][0]:
        raise RuntimeError(f"{name} remat: first loss {rm['loss'][0]}, bf16 step "
                           f"{runs['bf16']['loss'][0]}")
    if bad:
        raise RuntimeError(f"{name} remat: {len(bad)} gradients outside tolerance: {bad}")
    if not all(math.isfinite(v) for v in rm["loss"]) or not rm["loss"][-1] < rm["loss"][0]:
        raise RuntimeError(f"{name} remat: the loss did not fall over {steps} steps: "
                           f"{rm['loss']}")


TRAINER_WORK = Path(__file__).resolve().parent / "_chip_smoke_trainer"


def train_via_cli(args: list[str], epochs: int, *extra: str):
    """``cli.main(["--mode", "train", ...])`` up to ``epochs``: returns the
    trainer, the loss history, the launches counted over the call and a row
    of the last epoch's figures (median ``bt`` and ``dt`` over its steps)."""
    from dsmnet_tpu_torch import cli
    from dsmnet_tpu_torch.ops import _build

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    trainer, hist = cli.main(["--mode", "train", "--epochs", str(epochs), *args, *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    times = {k: statistics.median(v) * 1e3 for k, v in trainer.times.items()}
    return trainer, hist, launches, dict(
        epoch=trainer.epoch, lr=trainer.lr, steps=len(trainer.times["bt"]), wall_s=wall,
        median_bt_ms=times["bt"], median_dt_ms=times["dt"],
        frames_per_s=TRAIN_BATCH * 1e3 / times["bt"],
        bt_ms=[t * 1e3 for t in trainer.times["bt"]],
        dt_ms=[t * 1e3 for t in trainer.times["dt"]],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches)


def trainer_workers(counts: list[int]) -> None:
    """One trainer epoch (``trainer_bf16``'s command, no trace) for each
    loader worker count (``trainer_workers``): how ``bt`` and ``dt`` move
    with the threads that decode batches beside the training thread."""
    for nw in counts:
        shutil.rmtree(TRAINER_WORK, ignore_errors=True)
        _, _, _, row = train_via_cli(TRAINER_ARGS + ["--output", str(TRAINER_WORK / "out"),
                                                     "--num_workers", str(nw)], 1)
        emit({"trainer_workers": {"num_workers": nw, **row}})
    shutil.rmtree(TRAINER_WORK, ignore_errors=True)


def trainer_runs() -> dict:
    """tag -> (command line, launches of a train step, launches of an eval
    batch, Adam's lr, whether the mean train loss must fall from epoch 0
    to 1): PSMNet supervised (``trainer_bf16``: an eval batch is one
    forward) and DispNetC self-supervised (``trainer_selfsup_bf16``: two
    forwards; its train loss, under a new augmentation each step, is
    reported, and the eval loss is checked in ``train_selfsup_*``)."""
    return {"trainer_bf16": (TRAINER_ARGS, TRAIN_LAUNCHES["psmnet"], REQUEST_LAUNCHES,
                             TRAIN_LR, True),
            "trainer_selfsup_bf16": (TRAINER_SELFSUP_ARGS, SELFSUP_LAUNCHES["dispnetcorr"],
                                     {k: 2 * v for k, v in SERVE_LAUNCHES["dispnetcorr"].items()},
                                     1e-4, False)}


def run_trainer(dev, tag: str = "trainer_bf16") -> dict:
    """The trainer through ``dsmnet_tpu_torch.cli.main`` (``trainer_runs()``):
    one epoch with a profiler trace, its launches counted; a resumed second
    epoch; ``--mode test`` and ``--mode submit`` from the best weights.
    Checkpoints and outputs go to a scratch directory beside this file,
    removed at the end.  Returns the first epoch's launches and figures."""
    from dsmnet_tpu_torch import cli
    from dsmnet_tpu_torch.images import read_png16
    from dsmnet_tpu_torch.ops import _build
    from dsmnet_tpu_torch.train import lr_for_epoch

    cmd, step_launches, eval_launches, lr, must_fall = trainer_runs()[tag]
    work = TRAINER_WORK
    shutil.rmtree(work, ignore_errors=True)
    out, trace_dir = work / "out", work / "trace"
    args = cmd + ["--output", str(out)]
    expected = {k: TRAINER_STEPS * step_launches.get(k, 0)
                + TRAINER_VAL_BATCHES * eval_launches.get(k, 0)
                for k in {**step_launches, **eval_launches}}

    t1, _, launches, first = train_via_cli(args, 1, "--profile_dir", str(trace_dir))
    files = {name: (Path(t1.dirpath) / name).is_file() for name in (
        "model_checkpoint.pt", "model_best.pt", "weight_best.pt", "loss_history.json")}
    traces = sorted(p.name for p in trace_dir.glob("*.json"))
    t2, hist, launches2, second = train_via_cli(args, 2)
    weights = str(Path(t2.dirpath) / "weight_best.pt")

    # --mode test on the synthetic set, from the best weights
    _build.reset_launches()
    _, (vloss, vepe, vd1) = cli.main(["--mode", "test", *args, "--path_weight", weights])
    test_launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    test_expected = {k: v * TRAINER_TEST_SAMPLES // TRAIN_BATCH
                     for k, v in eval_launches.items()}

    # --mode submit, batch 1, writing under the scratch directory
    cwd = os.getcwd()
    os.chdir(work)
    try:
        ts, res = cli.main(["--mode", "submit", *args, "--batchsize", "1", "--flag_model",
                            "smoke", "--path_weight", weights])
    finally:
        os.chdir(cwd)
    png_dir = work / "submit" / "synthetic_smoke"
    batches = iter(ts.loader_val)
    batch, names = next(batches)
    batches.close()  # ends the loader's workers
    disp = ts._eval_step(ts.state, torch.from_numpy(batch).to(dev), ts._weights(0))["disp"]
    want = np.clip(disp[0, :, :, 0].float().cpu().numpy() * 256.0, 0, 65535).astype(np.uint16)
    got = read_png16(str(png_dir / (os.path.splitext(names[0])[0] + ".png")))
    png_diff = int(np.abs(got.astype(np.int64) - want).max())
    workers = [t.name for t in threading.enumerate() if t.name.startswith("BatchLoader")]
    shutil.rmtree(work, ignore_errors=True)

    emit({tag: {
        "command": "cli.main(['--mode', 'train', " + ", ".join(repr(a) for a in args) + "])",
        "batch": TRAIN_BATCH, "crop": [H, W], "maxdisparity": MAXDISP,
        "epoch_0": first, "epoch_1": second, "expected_launches_per_epoch": expected,
        "train_loss_by_epoch": hist["loss"], "val_loss_by_epoch": hist["loss_val"],
        "val_d1_by_epoch": hist["d1_val"], "val_epe_by_epoch": hist["epe_val"],
        "files": files, "profiler_traces": traces,
        "test": {"loss": vloss, "epe": vepe, "d1": vd1, "launches": test_launches,
                 "expected_launches": test_expected},
        "submit": {"pngs": len(res["filename"]), "d1": res["D1"][:4], "epe": res["epe"][:4],
                   "png_vs_disparity_x256_max_diff": png_diff},
        "loader_threads_left": workers}})
    if launches != expected or launches2 != expected:
        raise RuntimeError(f"trainer launches {launches} / {launches2}, expected {expected}")
    if not all(files.values()) or not traces:
        raise RuntimeError(f"trainer files {files}, traces {traces}")
    if first["steps"] != TRAINER_STEPS or (second["epoch"], second["steps"]) != (1, TRAINER_STEPS):
        raise RuntimeError(f"epochs ran {first['steps']} and {second['steps']} steps, the "
                           f"second ending at epoch {second['epoch']}")
    if second["lr"] != lr_for_epoch(1, lr, 50, 20) or t2.state.step != 2 * TRAINER_STEPS:
        raise RuntimeError(f"resumed at lr {second['lr']}, step {t2.state.step}")
    losses = hist["loss"] + hist["loss_val"]
    if len(hist["loss"]) != 2 or not all(math.isfinite(v) for v in losses) \
            or (must_fall and not hist["loss"][1] < hist["loss"][0]):
        raise RuntimeError(f"the mean train loss did not fall from epoch 0 to 1: {hist}")
    if not all(math.isfinite(v) for v in (vloss, vepe, vd1)) or test_launches != test_expected:
        raise RuntimeError(f"test mode: loss {vloss}, epe {vepe}, d1 {vd1}, launches "
                           f"{test_launches} (expected {test_expected})")
    # the PNG holds the same disparity, rounded down to 1/256 px, from a
    # second float32 forward on the same weights (a last-bit difference
    # moves it by at most one step)
    if len(res["filename"]) != TRAINER_TEST_SAMPLES or png_diff > 1:
        raise RuntimeError(f"submit wrote {len(res['filename'])} PNGs, max diff {png_diff}")
    if workers:
        raise RuntimeError(f"loader threads still running: {workers}")
    return launches, first


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_dp_cli(trainer_row: dict, card: str) -> dict:
    """``dp_cli_nccl_bf16``: 10.'s command line with ``--mesh-data 1`` under
    torchrun's environment (RANK 0 of WORLD_SIZE 1, ``env://``): a real
    NCCL group, the Trainer on a 1x1 mesh, every reduction over the batch
    and the gradient bucket all-reduced.  Its launches per epoch must equal
    ``trainer_bf16``'s (``trainer_row``), one gradient all-reduce per step;
    it must write its files.  Returns the epoch's launches."""
    from dsmnet_tpu_torch.parallel import context

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(free_port())}
    if "NCCL_SOCKET_IFNAME" not in os.environ:
        env["NCCL_SOCKET_IFNAME"] = "lo"  # one host: the loopback interface
    saved = {k: os.environ.get(k) for k in env}
    shutil.rmtree(TRAINER_WORK, ignore_errors=True)
    context.COLLECTIVES.clear()
    os.environ.update(env)
    try:
        args = TRAINER_ARGS + ["--output", str(TRAINER_WORK / "out"), "--mesh-data", "1"]
        trainer, hist, launches, row = train_via_cli(args, 1)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    files = {name: (Path(trainer.dirpath) / name).is_file() for name in (
        "model_checkpoint.pt", "model_best.pt", "weight_best.pt", "loss_history.json")}
    shutil.rmtree(TRAINER_WORK, ignore_errors=True)
    collectives = dict(context.COLLECTIVES)
    expected = {k: TRAINER_STEPS * TRAIN_LAUNCHES["psmnet"].get(k, 0)
                + TRAINER_VAL_BATCHES * REQUEST_LAUNCHES.get(k, 0)
                for k in {**TRAIN_LAUNCHES["psmnet"], **REQUEST_LAUNCHES}}
    mesh = trainer.mesh
    emit({"dp_cli_nccl_bf16": {
        "card": card, "command": "cli.main(['--mode', 'train', " + ", ".join(
            repr(a) for a in args) + "]) with RANK=0 WORLD_SIZE=1 LOCAL_RANK=0",
        "mesh": None if mesh is None else [list(mesh.shape), mesh.device_type],
        "device": str(trainer.device), "epoch_0": row,
        "median_bt_ms": row["median_bt_ms"], "median_dt_ms": row["median_dt_ms"],
        "trainer_bf16_median_bt_ms": trainer_row["median_bt_ms"],
        "trainer_bf16_median_dt_ms": trainer_row["median_dt_ms"],
        "bt_minus_trainer_bf16_ms": row["median_bt_ms"] - trainer_row["median_bt_ms"],
        "all_reduces_by_site": collectives, "expected_launches_per_epoch": expected,
        "train_loss": hist["loss"], "val_loss": hist["loss_val"], "files": files}})
    if mesh is None or list(mesh.shape) != [1, 1] or mesh.device_type != "cuda":
        raise RuntimeError(f"dp_cli: no NCCL 1x1 mesh ({mesh})")
    if launches != expected or launches != trainer_row["launches"]:
        raise RuntimeError(f"dp_cli launches {launches}, expected {expected} "
                           f"(trainer_bf16: {trainer_row['launches']})")
    if collectives.get("grad_bucket") != TRAINER_STEPS or not collectives.get("bn_moments") \
            or not collectives.get("data_sum"):
        raise RuntimeError(f"dp_cli all-reduces {collectives}")
    if not all(files.values()) or not all(math.isfinite(v) for v in hist["loss"]
                                          + hist["loss_val"]):
        raise RuntimeError(f"dp_cli files {files}, history {hist}")
    return launches


def _gloo_p2p_probe(rank: int, port: int, queue) -> None:
    """Whether gloo's send/recv move a CUDA tensor: rank 0 sends one to rank 1."""
    import datetime

    from dsmnet_tpu_torch.parallel import init_distributed

    init_distributed(f"localhost:{port}", 2, rank, backend="gloo",
                     timeout=datetime.timedelta(seconds=60))
    t = torch.full((1024,), float(rank + 1), device="cuda")
    try:
        if rank == 0:
            torch.distributed.send(t, 1)
            queue.put((rank, "sent"))
        else:
            torch.distributed.recv(t, 0)
            torch.cuda.synchronize()
            queue.put((rank, f"received {t[0].item()} (expected 1.0)"))
    except Exception as exc:  # noqa: BLE001 -- the probe reports what gloo raised
        queue.put((rank, f"{type(exc).__name__}: {str(exc)[:200]}"))


def _spawn(target, ranks: int, args_of, timeout: float) -> tuple[list, list]:
    """``target(rank, *args_of(rank), queue)`` in ``ranks`` spawned
    processes: (what they put on the queue, their exit codes); a process
    still running at ``timeout`` is killed."""
    import multiprocessing as mp
    import queue as queue_module

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(rank, *args_of(rank), q), daemon=True)
             for rank in range(ranks)]
    for p in procs:
        p.start()
    deadline, got = time.monotonic() + timeout, []
    while len(got) < ranks and time.monotonic() < deadline:
        try:
            got.append(q.get(timeout=1.0))
        except queue_module.Empty:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
    for p in procs:
        p.join(timeout=max(1.0, deadline - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join()
    return got, [p.exitcode for p in procs]


def _dp2_rank(rank: int, ranks: int, port: int, backend: str, queue) -> None:
    """One of ``ranks`` ranks of the data-parallel phase: on DP2_DEVICE over
    gloo (``dp2_shared_card``), or on card ``rank`` over NCCL (``--dp-cards``):
    (a) a float32 step on its pair of the global batch, (b) DP2_STEPS bf16
    steps on its TRAIN_BATCH pairs and one profiled step, (c) its band of
    ``halo_conv2d``, forward and backward; everything to the parent."""
    import datetime
    import traceback

    from torch.profiler import ProfilerActivity, profile as torch_profile

    try:
        from dsmnet_tpu_torch.models.layers import compute_dtype
        from dsmnet_tpu_torch.ops import _build
        from dsmnet_tpu_torch.parallel import (
            ShardingContext, activate, halo_conv2d, init_distributed, make_mesh, replicate,
            shard_batch)
        from dsmnet_tpu_torch.train import create_train_state, make_supervised_train_step

        os.environ["LOCAL_RANK"] = str(rank if backend == "nccl" else 0)
        dev = torch.device("cuda", rank) if backend == "nccl" else torch.device(DP2_DEVICE)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        init_distributed(f"localhost:{port}", ranks, rank, backend=backend,
                         timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
        _build.lib()  # the parent built it
        data_mesh = make_mesh(data=ranks)
        ctx = ShardingContext(data_mesh)
        out = {"rank": rank}

        # (a) float32, one sample per rank: the applied (summed) gradients
        state, opt = create_train_state(seeded_model(dev), device=dev)
        replicate(state, data_mesh)
        step = make_supervised_train_step(state.model, opt)
        weights = loss_weights(state.model)
        with activate(ctx):
            m = step(state, shard_batch(train_batch(ranks, dev), data_mesh), 0.0, weights)
        # numpy: a queue passes a torch tensor as a file descriptor that dies
        # with this process
        out["a"] = {"loss": m["loss"].item(), "grads": {
            n: p.grad.detach().float().cpu().numpy() for n, p in
            state.model.named_parameters()}}
        del state, opt, step
        torch.cuda.empty_cache()

        # (b) bf16 steps, TRAIN_BATCH a rank
        state, opt = create_train_state(seeded_model(dev), device=dev)
        replicate(state, data_mesh)
        step = make_supervised_train_step(state.model, opt)
        batch = shard_batch(train_batch(ranks * TRAIN_BATCH, dev), data_mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms, counts = [], [], []
        with activate(ctx), compute_dtype(torch.bfloat16):
            for _ in range(DP2_STEPS):
                _build.reset_launches()
                t0 = time.perf_counter()
                loss = step(state, batch, TRAIN_LR, weights)["loss"].item()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                counts.append({k: v for k, v in _build.LAUNCHES.items() if v})
                losses.append(loss)
            peak = torch.cuda.max_memory_allocated() / 1e9
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step(state, batch, TRAIN_LR, weights)["loss"].item()
                wall = (time.perf_counter() - t0) * 1e3
        allreduce = under(prof, "grad_allreduce")
        out["b"] = {"losses": losses, "step_ms": step_ms, "counts": counts, "peak_mem_gb": peak,
                    "profiled_wall_ms": wall, "profiled_device_ms": device_ms(prof),
                    "grad_allreduce": {k: allreduce[k] for k in ("nodes", "device_ms",
                                                                 "launches")},
                    "grad_elements": sum(p.numel() for p in state.model.parameters())}
        del state, opt, step, batch, prof
        torch.cuda.empty_cache()

        # (c) halo_conv2d, float32, H split over the ranks
        model_mesh = make_mesh(data=1, model=ranks)
        x, k, g = halo_inputs(dev)
        rows = x.shape[1] // ranks
        band = x[:, rank * rows:(rank + 1) * rows].clone().requires_grad_(True)
        kk = k.clone().requires_grad_(True)
        _build.reset_launches()
        y = halo_conv2d(band, kk, model_mesh)
        (y * g[:, rank * rows:(rank + 1) * rows]).sum().backward()
        torch.cuda.synchronize()
        out["c"] = {"y": y.detach().cpu().numpy(), "dx": band.grad.cpu().numpy(),
                    "dk": kk.grad.cpu().numpy(),
                    "launches": {k_: v for k_, v in _build.LAUNCHES.items() if v}}
        queue.put(out)
    except BaseException:
        queue.put({"rank": rank, "error": traceback.format_exc()})
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def halo_inputs(dev):
    """DP2_HALO_SHAPE's input, a 3x3 32 -> 32 kernel and a cotangent, float32."""
    g = torch.Generator().manual_seed(2)
    n, h, w, c = DP2_HALO_SHAPE
    x = torch.randn((n, h, w, c), generator=g)
    k = torch.randn((3, 3, c, c), generator=g) * (2.0 / (9 * c)) ** 0.5
    cot = torch.randn((n, h, w, c), generator=g)
    return x.to(dev), k.to(dev), cot.to(dev)


def one_process_grads(dev, n_pairs: int, loss_name: str = "supervised") -> dict:
    """The one-process references of a parallel phase's float32 check: the
    loss and every parameter's gradient of full-width PSMNet on the first
    ``n_pairs`` pairs of ``train_batch`` through the kernels (float32), and
    the same on the float64 plain path; with a photometric ``loss_name``,
    of the self-supervised loss (``selfsup_loss``: two forwards of the
    SH x SW views) on ``selfsup_batch``'s pairs with step 0's draws."""
    from dsmnet_tpu_torch import config
    from dsmnet_tpu_torch.losses import parse_loss_name, supervised_pyramid_loss
    from dsmnet_tpu_torch.train import draw_selfsup_params, selfsup_generator, selfsup_loss

    model = seeded_model(dev).train()
    spec = parse_loss_name(loss_name, model.count_levels)
    if spec.supervised:
        batch, weights = train_batch(n_pairs, dev), loss_weights(model)
    else:
        batch, weights = selfsup_batch(n_pairs, dev), spec.weights(1)
        draws = draw_selfsup_params(selfsup_generator(SELFSUP_SEED, 0), n_pairs).to(dev)

    def grads(m, b):
        m.zero_grad(set_to_none=True)
        if spec.supervised:
            scales, disps = m(b[..., :3], b[..., 3:6])
            loss = supervised_pyramid_loss(b[..., 6:7], disps, scales, weights)
        else:
            nedge = SELFSUP_NEDGE if spec.flag_mask else 0
            loss = selfsup_loss(m, spec.photo, b, nedge, weights, draws)[0]
        loss.backward()
        return loss.item(), {n: p.grad.double().cpu() for n, p in m.named_parameters()}

    loss_1, g_1 = grads(model, batch)
    with config.implementation("plain"):
        model64 = copy.deepcopy(model).double()
        loss_64, g_64 = grads(model64, batch.double())
    out = {"loss_1": loss_1, "g_1": g_1, "loss_64": loss_64, "g_64": g_64,
           "zero": zero_gradient_params(model)}
    del model, model64, batch
    torch.cuda.empty_cache()
    return out


def check_summed_grads(ranks_a: list, refs: dict) -> tuple[dict, bool]:
    """Each rank's float32 loss and summed gradients (``ranks_a``: per rank
    {"loss", "grads"}) against the one process's (``one_process_grads``):
    each parameter within DP2_GRAD_FACTOR x the one process's own error
    against float64 (+ the floor of check_gradients), the loss likewise,
    every rank the same bits.  Returns (the printed row, whether it passed)."""
    g_1, g_64, zero = refs["g_1"], refs["g_64"], refs["zero"]
    loss_1, loss_64 = refs["loss_1"], refs["loss_64"]
    scale = {n: (g_64[n.replace(".bias", ".kernel")] if n in zero else g_64[n]).norm()
             for n in g_64}
    rel = lambda a, b, n: ((a.double() - b).norm() / scale[n].clamp(min=1e-300)).item()
    plain = {n: rel(g_1[n], g_64[n], n) for n in g_64}
    floor = GRAD_F32_FLOOR_SHARE * statistics.median(plain.values())
    rows = {n: (rel(ranks_a[0]["grads"][n], g_1[n], n), plain[n]) for n in g_64}
    bad = {n: v for n, v in rows.items() if not v[0] <= DP2_GRAD_FACTOR * v[1] + floor}
    ranks_equal = all(torch.equal(ranks_a[0]["grads"][n], o["grads"][n])
                      for o in ranks_a[1:] for n in g_64)
    loss_err, loss_tol = abs(ranks_a[0]["loss"] - loss_1), DP2_GRAD_FACTOR * abs(
        loss_1 - loss_64) + 1e-6 * abs(loss_64)
    row = {
        "loss": {"ranks": [o["loss"] for o in ranks_a], "one_process_f32": loss_1,
                 "f64": loss_64, "abs_err": loss_err, "tolerance": loss_tol},
        "params": len(rows), "ranks_same_bits": ranks_equal,
        "max_rel_err_vs_one_process": max(v[0] for v in rows.values()),
        "median_rel_err_vs_one_process": statistics.median(v[0] for v in rows.values()),
        "median_rel_err_one_process_vs_f64": statistics.median(plain.values()),
        "tightest": sorted(((n, v[0] / (DP2_GRAD_FACTOR * v[1] + floor)) for n, v in
                            rows.items()), key=lambda kv: -kv[1])[:5],
        "outside_tol": bad,
        "tolerance": f"per parameter |g_ranks - g_1| / |g64| <= {DP2_GRAD_FACTOR} x "
                     f"|g_1 - g64| / |g64| + {GRAD_F32_FLOOR_SHARE} x median = {floor:.3g}"}
    return row, not bad and loss_err <= loss_tol and ranks_equal


def run_data_parallel(dev, card: str, ranks: int = DP2_RANKS, backend: str = "gloo") -> dict:
    """``dp2_shared_card`` (see the module's step 12; gloo, every rank on
    DP2_DEVICE), or with ``backend="nccl"`` ``dp<ranks>_nccl``, rank i on card
    i: the one-process references first (on ``dev``), then the ranks, then
    the checks.  Returns the launches of a rank's bf16 step (``dp2_train``)
    and of its halo convolution (``dp2_halo``)."""
    from dsmnet_tpu_torch.ops.conv2d import conv2d_same

    probe = None
    if backend == "gloo":  # gloo's send/recv of a CUDA tensor, in two processes of their own
        port = free_port()
        probe = dict(zip(("results", "exit_codes"),
                         _spawn(_gloo_p2p_probe, 2, lambda r: (port,), 120)))

    refs = one_process_grads(dev, ranks)
    # (c)'s reference: conv2d_same on the whole tensor, forward and backward
    x, k, cot = halo_inputs(dev)
    x.requires_grad_(True)
    k.requires_grad_(True)
    y_full = conv2d_same(x, k)
    (y_full * cot).sum().backward()
    y_full, dx_full, dk_full = y_full.detach().cpu(), x.grad.cpu(), k.grad.cpu()
    del x, k, cot
    torch.cuda.empty_cache()

    port = free_port()
    got, codes = _spawn(_dp2_rank, ranks, lambda r: (ranks, port, backend), DP_TIMEOUT_S + 300)
    errors = [o["error"] for o in got if "error" in o]
    if errors or len(got) != ranks or any(codes):
        raise RuntimeError(f"dp2 ranks: exit codes {codes}, {len(got)} results, "
                           f"errors {errors}")
    r = sorted(got, key=lambda o: o["rank"])
    for o in r:
        o["a"]["grads"] = {n: torch.from_numpy(g) for n, g in o["a"]["grads"].items()}
        o["c"].update({k: torch.from_numpy(o["c"][k]) for k in ("y", "dx", "dk")})

    # (a): each rank's global loss and summed gradients against the one process's
    a_row, a_ok = check_summed_grads([o["a"] for o in r], refs)
    # (b)
    bs = [o["b"] for o in r]
    expected = TRAIN_LAUNCHES["psmnet"]
    # (c)
    y = torch.cat([o["c"]["y"] for o in r], dim=1)
    dx = torch.cat([o["c"]["dx"] for o in r], dim=1)
    dk = sum(o["c"]["dk"] for o in r)
    y_err = ((y - y_full).abs() - F32_RTOL * y_full.abs()).max().item()
    dx_err = ((dx - dx_full).abs() - F32_RTOL * dx_full.abs()).max().item()
    dk_err = ((dk - dk_full).abs().max() / dk_full.abs().max()).item()
    halo_expected = {"conv2d_k3": 2, "conv2d_dk_k3": 1}
    shared = backend == "gloo"
    emit({"dp2_shared_card" if shared else f"dp{ranks}_nccl": {
        "card": card, "ranks": ranks, "backend": backend,
        "device": f"{DP2_DEVICE}, every rank" if shared else "cuda:<rank>",
        "note": "ranks on one card over gloo, which moves CUDA tensors through the host: these "
                "times measure gloo on one shared card, not a multi-GPU node" if shared else
                "one rank per card over NCCL",
        "gloo_p2p_cuda": probe,
        "a_f32_one_sample_per_rank": a_row,
        "b_bf16_steps": {
            "batch_per_rank": TRAIN_BATCH, "global_batch": ranks * TRAIN_BATCH,
            "steps": DP2_STEPS, "losses": bs[0]["losses"],
            "step_ms_per_rank": [b["step_ms"] for b in bs],
            "median_step_ms_per_rank": [statistics.median(b["step_ms"][1:]) for b in bs],
            "peak_mem_gb_per_rank": [b["peak_mem_gb"] for b in bs],
            "profiled_step": {k: [b[k] for b in bs] for k in (
                "profiled_wall_ms", "profiled_device_ms", "grad_allreduce")},
            "grad_elements": bs[0]["grad_elements"],
            "launches_per_step": bs[0]["counts"][-1], "expected_launches_per_step": expected},
        "c_halo_conv2d_f32": {
            "shape": list(DP2_HALO_SHAPE), "max_abs_err_out": (y - y_full).abs().max().item(),
            "max_abs_err_dx": (dx - dx_full).abs().max().item(), "dk_rel_err": dk_err,
            "same_bits_out": torch.equal(y, y_full),
            "tolerance": f"out, dx: |err| <= {F32_ATOL} + {F32_RTOL} |ref|; dk: 1e-5 of max|dk|",
            "launches": [o["c"]["launches"] for o in r], "expected_launches": halo_expected}}})
    if not a_ok:
        raise RuntimeError(f"dp2 (a): {a_row}")
    if any(c != expected for b in bs for c in b["counts"]):
        raise RuntimeError(f"dp2 (b) launches {[b['counts'] for b in bs]}, "
                           f"expected {expected}")
    losses = bs[0]["losses"]
    if any(b["losses"] != losses for b in bs) or not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0]:
        raise RuntimeError(f"dp2 (b): the global loss did not fall alike on every rank: "
                           f"{[b['losses'] for b in bs]}")
    if y_err > F32_ATOL or dx_err > F32_ATOL or dk_err > 1e-5 \
            or any(o["c"]["launches"] != halo_expected for o in r):
        raise RuntimeError(f"dp2 (c): out {y_err}, dx {dx_err}, dk {dk_err} over tolerance, "
                           f"launches {[o['c']['launches'] for o in r]}")
    return {"dp2_train": bs[0]["counts"][-1], "dp2_halo": r[0]["c"]["launches"]}


def _sp2_rank(rank: int, ranks: int, port: int, backend: str, queue) -> None:
    """One of ``ranks`` ranks of the spatial phase, on a (ranks / 2, 2) mesh
    (H split over ``model``): on DP2_DEVICE over gloo (``sp2_shared_card``),
    or on card ``rank`` over NCCL (``--sp-cards``): (a) a float32 PSMNet
    step on its data index's pair, its band of rows; (b) SP2_STEPS bf16
    PSMNet steps on its data index's TRAIN_BATCH pairs and one profiled
    step; (c) SP2_GCNET_STEPS bf16 GCNet steps at batch 1; (d) a float32
    self-supervised PSMNet step of each SP2_SELFSUP_F32_LOSSES (step 0's
    draws) on its data index's pair, the loss on its band of the views;
    (e) SP2_STEPS
    bf16 self-supervised steps at TRAIN_BATCH pairs and one profiled step;
    everything to the parent."""
    import datetime
    import traceback

    from torch.profiler import ProfilerActivity, profile as torch_profile

    try:
        from dsmnet_tpu_torch.losses import parse_loss_name
        from dsmnet_tpu_torch.models.layers import compute_dtype, siamese
        from dsmnet_tpu_torch.ops import _build
        from dsmnet_tpu_torch.parallel import (
            ShardingContext, activate, context, init_distributed, make_mesh, replicate,
            shard_batch)
        from dsmnet_tpu_torch.parallel.mesh import axis_index
        from dsmnet_tpu_torch.train import (
            create_train_state, draw_selfsup_params, make_selfsup_train_step,
            make_supervised_train_step, selfsup_generator)

        os.environ["LOCAL_RANK"] = str(rank if backend == "nccl" else 0)
        dev = torch.device("cuda", rank) if backend == "nccl" else torch.device(DP2_DEVICE)
        torch.cuda.set_device(dev)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        init_distributed(f"localhost:{port}", ranks, rank, backend=backend,
                         timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
        _build.lib()  # the parent built it
        data = ranks // 2
        mesh = make_mesh(data=data, model=2)
        ctx = ShardingContext(mesh, "data", "model")
        out = {"rank": rank}

        # (a) float32, one pair a data index, H banded
        state, opt = create_train_state(seeded_model(dev), device=dev)
        replicate(state, mesh)
        step = make_supervised_train_step(state.model, opt)
        weights = loss_weights(state.model)
        with activate(ctx):
            m = step(state, shard_batch(train_batch(data, dev), mesh), 0.0, weights)
        out["a"] = {"loss": m["loss"].item(), "grads": {
            n: p.grad.detach().float().cpu().numpy() for n, p in
            state.model.named_parameters()}}
        del state, opt, step
        torch.cuda.empty_cache()

        def tower_ms(model, batch):
            with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                feats = siamese(model.feature_extraction, batch[..., :3], batch[..., 3:6])
                torch.autograd.backward(feats, [torch.ones_like(f) for f in feats])
                torch.cuda.synchronize()
            return device_ms(prof)

        index = axis_index(mesh, "data")

        def steps_of(name, n, loss_name):
            """(the train state of seeded ``name``, ``run(i, lr)``: its step
            i on the data index's n pairs, supervised or of the photometric
            ``loss_name`` with step i's draws, returning the metrics)."""
            state, opt = create_train_state(seeded_model(dev, name), device=dev)
            replicate(state, mesh)
            if loss_name is None:
                step = make_supervised_train_step(state.model, opt)
                batch = shard_batch(train_batch(data * n, dev), mesh)
                weights = loss_weights(state.model)
                return state, lambda i, lr: step(state, batch, lr, weights)
            spec = parse_loss_name(loss_name, state.model.count_levels)
            step = make_selfsup_train_step(state.model, opt, spec.photo,
                                           SELFSUP_NEDGE if spec.flag_mask else 0)
            batch = shard_batch(selfsup_batch(data * n, dev), mesh)
            weights = spec.weights(1)
            # every model rank of a data index draws its rows of the global draws
            draws = lambda i: draw_selfsup_params(selfsup_generator(SELFSUP_SEED, i),
                                                  data * n).rows(index * n, (index + 1) * n)
            return state, lambda i, lr: step(state, batch, lr, weights, draws(i))

        # (d) float32, self-supervised, one pair a data index: the loss on
        # the bands of its views, the gradients summed over the mesh (lr 0)
        out["d"] = {}
        for loss_name in SP2_SELFSUP_F32_LOSSES:
            state, run = steps_of("psmnet", 1, loss_name)
            before = dict(context.COLLECTIVES)
            with activate(ctx):
                m = run(0, 0.0)
            out["d"][loss_name] = {"loss": m["loss"].item(), "grads": {
                n: p.grad.detach().float().cpu().numpy() for n, p in
                state.model.named_parameters()}, "collectives": {
                k: v - before.get(k, 0) for k, v in context.COLLECTIVES.items()
                if v != before.get(k, 0)}}
            del state, run, m
            torch.cuda.empty_cache()

        def bf16_steps(name, n, steps, lr, prof_step, loss_name=None):
            state, run = steps_of(name, n, loss_name)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            row = {"losses": [], "step_ms": [], "counts": [], "exchanges": [],
                   "model_sums": []}
            with activate(ctx), compute_dtype(torch.bfloat16):
                for i in range(steps):
                    _build.reset_launches()
                    before = dict(context.COLLECTIVES)
                    t0 = time.perf_counter()
                    loss = run(i, lr)["loss"].item()
                    row["step_ms"].append((time.perf_counter() - t0) * 1e3)
                    row["counts"].append({k: v for k, v in _build.LAUNCHES.items() if v})
                    made = lambda k: context.COLLECTIVES.get(k, 0) - before.get(k, 0)
                    row["exchanges"].append(made("halo_exchange"))
                    row["model_sums"].append(made("model_sum"))
                    row["losses"].append(loss)
                row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
                if prof_step:
                    with torch_profile(activities=[ProfilerActivity.CPU,
                                                   ProfilerActivity.CUDA]) as prof:
                        t0 = time.perf_counter()
                        run(steps, lr)["loss"].item()
                        row["profiled_wall_ms"] = (time.perf_counter() - t0) * 1e3
                    table = kernel_table(prof)
                    row["profiled_device_ms"] = sum(ms for _, ms, _ in table)
                    # NCCL's kernels wait for the peers: the rank's own work without them
                    row["profiled_device_ms_without_nccl"] = sum(
                        ms for name, ms, _ in table if "nccl" not in name.lower())
                    row["top_kernels_ms_count"] = table[:25]
                    for key in ("halo_exchange", "halo_pad", "grad_allreduce",
                                "photometric_loss"):
                        spans = under(prof, key)
                        row[key] = {k: spans[k] for k in ("nodes", "device_ms", "launches")}
                    del prof
                if prof_step and loss_name is None:
                    # the whole-image tower's share: its forward and backward,
                    # on every rank at once as in the step, then on each
                    # rank alone (outside the context: no peer to reduce with)
                    batch = shard_batch(train_batch(data * n, dev), mesh)
                    row["tower_device_ms"] = tower_ms(state.model, batch)
                    for r in range(ranks):
                        torch.distributed.barrier()
                        if r == rank:
                            with activate(None):
                                row["tower_device_ms_alone"] = tower_ms(state.model, batch)
                    torch.distributed.barrier()
                    del batch
            del state, run
            torch.cuda.empty_cache()
            return row

        # (b) PSMNet, bf16, TRAIN_BATCH pairs a data index; (c) GCNet at batch 1;
        # (e) PSMNet's self-supervised step at TRAIN_BATCH pairs
        out["b"] = bf16_steps("psmnet", TRAIN_BATCH, SP2_STEPS, TRAIN_LR, True)
        out["c"] = bf16_steps("gcnet", TRAIN_RUNS["gcnet"][1], SP2_GCNET_STEPS,
                              TRAIN_RUNS["gcnet"][3], False)
        out["e"] = bf16_steps("psmnet", TRAIN_BATCH, SP2_STEPS, SELFSUP_RUNS["psmnet"][4], True,
                              SP2_SELFSUP_LOSS)
        queue.put(out)
    except BaseException:
        queue.put({"rank": rank, "error": traceback.format_exc()})
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def run_spatial(dev, card: str, ranks: int = SP2_RANKS, backend: str = "gloo") -> dict:
    """``sp2_shared_card`` (the module's step 13: two ranks on DP2_DEVICE
    over gloo, a (1, 2) mesh, H banded over them), or with
    ``backend="nccl"`` ``sp<ranks>_nccl``, rank i on card i, a (ranks / 2,
    2) mesh: the one-process references first (on ``dev``), then the
    ranks, then the checks.  Returns the launches of a rank's bf16 PSMNet
    step (``sp2_train``), GCNet step (``sp2_gcnet``) and self-supervised
    PSMNet step (``sp2_selfsup``)."""
    data = ranks // 2
    refs = one_process_grads(dev, data)
    refs_d = {name: one_process_grads(dev, data, name) for name in SP2_SELFSUP_F32_LOSSES}
    port = free_port()
    got, codes = _spawn(_sp2_rank, ranks, lambda r: (ranks, port, backend), DP_TIMEOUT_S + 300)
    errors = [o["error"] for o in got if "error" in o]
    if errors or len(got) != ranks or any(codes):
        raise RuntimeError(f"sp ranks: exit codes {codes}, {len(got)} results, "
                           f"errors {errors}")
    r = sorted(got, key=lambda o: o["rank"])
    for o in r:
        for part in [o["a"], *o["d"].values()]:
            part["grads"] = {n: torch.from_numpy(g) for n, g in part["grads"].items()}
    a_row, a_ok = check_summed_grads([o["a"] for o in r], refs)
    d_rows, d_ok = {}, True
    for name in SP2_SELFSUP_F32_LOSSES:  # every rank reports the one global loss
        row, ok = check_summed_grads([o["d"][name] for o in r], refs_d[name])
        row["collectives_per_rank"] = [o["d"][name]["collectives"] for o in r]
        d_rows[name] = row
        d_ok = d_ok and ok and len({o["d"][name]["loss"] for o in r}) == 1
    bs, cs, es = [o["b"] for o in r], [o["c"] for o in r], [o["e"] for o in r]
    train, train_gcnet = TRAIN_ROWS.get("train", {}), TRAIN_ROWS.get("train_gcnet", {})
    train_selfsup = TRAIN_ROWS.get(SELFSUP_RUNS["psmnet"][0], {})
    expected = {path: kernel_launches(path) for path in ("sp2_train", "sp2_gcnet", "sp2_selfsup")}
    med = lambda row: statistics.median(row["step_ms"][1:])
    shared = backend == "gloo"
    emit({"sp2_shared_card" if shared else f"sp{ranks}_nccl": {
        "card": card, "ranks": ranks, "mesh": [data, 2], "backend": backend,
        "device": f"{DP2_DEVICE}, every rank" if shared else "cuda:<rank>",
        "halo_transport": "gloo point-to-point through host memory: each exchange copies its "
                          "rows from the card, sends them and copies what it receives back"
                          if shared else "NCCL point-to-point, card to card",
        "note": "both ranks share one card and its compute: a rank-step's time is not a "
                "2-card step's" if shared else "one rank per card",
        "a_f32_psmnet_one_pair_per_data_index": a_row,
        "b_bf16_psmnet": {
            "batch_per_data_index": TRAIN_BATCH, "steps": SP2_STEPS, "losses": bs[0]["losses"],
            "step_ms_per_rank": [b["step_ms"] for b in bs],
            "median_step_ms_per_rank": [med(b) for b in bs],
            "train_bf16_median_step_ms": train.get("median_step_ms"),
            "peak_mem_gb_per_rank": [b["peak_mem_gb"] for b in bs],
            "train_bf16_peak_mem_gb": train.get("peak_mem_gb"),
            "halo_exchanges_per_step": bs[0]["exchanges"][-1],
            "profiled_step": {k: [b[k] for b in bs] for k in (
                "profiled_wall_ms", "profiled_device_ms", "profiled_device_ms_without_nccl",
                "tower_device_ms",
                "tower_device_ms_alone", "halo_exchange", "halo_pad", "grad_allreduce",
                "top_kernels_ms_count")},
            "launches_per_step": bs[0]["counts"][-1],
            "expected_launches_per_step": expected["sp2_train"]},
        "c_bf16_gcnet": {
            "batch_per_data_index": TRAIN_RUNS["gcnet"][1], "steps": SP2_GCNET_STEPS,
            "losses": cs[0]["losses"], "step_ms_per_rank": [c["step_ms"] for c in cs],
            "train_gcnet_bf16_median_step_ms": train_gcnet.get("median_step_ms"),
            "peak_mem_gb_per_rank": [c["peak_mem_gb"] for c in cs],
            "train_gcnet_bf16_peak_mem_gb": train_gcnet.get("peak_mem_gb"),
            "halo_exchanges_per_step": cs[0]["exchanges"][-1],
            "launches_per_step": cs[0]["counts"][-1],
            "expected_launches_per_step": expected["sp2_gcnet"]},
        "d_f32_psmnet_selfsup_one_pair_per_data_index": {
            "pair": [H, W], "views": [SH, SW], "by_loss_name": d_rows},
        "e_bf16_psmnet_selfsup": {
            "loss_name": SP2_SELFSUP_LOSS, "batch_per_data_index": TRAIN_BATCH, "pair": [H, W],
            "views": [SH, SW], "steps": SP2_STEPS, "lr": SELFSUP_RUNS["psmnet"][4],
            "losses": es[0]["losses"], "step_ms_per_rank": [e["step_ms"] for e in es],
            "median_step_ms_per_rank": [med(e) for e in es],
            "train_selfsup_psmnet_bf16_median_step_ms": train_selfsup.get("median_step_ms"),
            "peak_mem_gb_per_rank": [e["peak_mem_gb"] for e in es],
            "train_selfsup_psmnet_bf16_peak_mem_gb": train_selfsup.get("peak_mem_gb"),
            "halo_exchanges_per_step": es[0]["exchanges"][-1],
            "model_sums_per_step": es[0]["model_sums"][-1],
            "profiled_step": {k: [e[k] for e in es] for k in (
                "profiled_wall_ms", "profiled_device_ms", "profiled_device_ms_without_nccl",
                "photometric_loss", "halo_exchange", "halo_pad", "grad_allreduce",
                "top_kernels_ms_count")},
            "launches_per_step": es[0]["counts"][-1],
            "expected_launches_per_step": expected["sp2_selfsup"]}}})
    if not a_ok:
        raise RuntimeError(f"sp (a): {a_row}")
    if not d_ok:
        raise RuntimeError(f"sp (d): {d_rows}")
    for path, rows in (("sp2_train", bs), ("sp2_gcnet", cs), ("sp2_selfsup", es)):
        if any(c != expected[path] for row in rows for c in row["counts"]):
            raise RuntimeError(f"sp {path} launches {[row['counts'] for row in rows]}, "
                               f"expected {expected[path]}")
        losses = rows[0]["losses"]
        if any(row["losses"] != losses for row in rows) \
                or not all(math.isfinite(v) for v in losses):
            raise RuntimeError(f"sp {path}: the global loss differs between the ranks or is "
                               f"not finite: {[row['losses'] for row in rows]}")
    if not bs[0]["losses"][-1] < bs[0]["losses"][0]:
        raise RuntimeError(f"sp2_train: the loss did not fall: {bs[0]['losses']}")
    return {"sp2_train": bs[0]["counts"][-1], "sp2_gcnet": cs[0]["counts"][-1],
            "sp2_selfsup": es[0]["counts"][-1]}


def kernel_launches(path: str) -> dict:
    """The launches per call of ``path`` that kernel_specs' rows add up to,
    by kernel."""
    out = {}
    for spec in kernel_specs():
        n = sum(row[2] for row in spec["paths"].get(path, []))
        if n:
            out[spec["name"]] = n
    return out


def ptxas_report(log: str) -> dict:
    """Registers and spills per kernel entry from nvcc's ``-Xptxas=-v`` log:
    mangled entry name -> "N registers; X bytes spill stores; Y bytes spill
    loads" (the ring designs of B (and A, its last template argument KH =
    1), C, D, F (and E) and G are s1_fwd_kernel (128 -> 128:
    s1_fwd_split_kernel), s2_fwd_kernel, deconv_ring_kernel, s1_dk_kernel
    and s2_dk_kernel; J's grouped walk is fused_costvol_kernel)."""
    out, entry = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln.strip()
        elif entry and ("spill" in ln or "registers" in ln):
            out[entry] = (out.get(entry, "") + "; " + ln.split(":", 1)[-1].strip()).strip("; ")
    return out


def main(argv: list[str] | None = None) -> int:
    """The whole run; ``--only K1,K2`` checks and times only those kernels
    (edges and every path's rows), ``--profile-train N1,N2`` profiles one
    train step of each net, ``--trainer-workers 1,4`` runs one trainer
    epoch for each loader worker count, ``--data-parallel`` trainer_bf16
    and the data-parallel phases, ``--dp-cards N`` the data-parallel
    phase over N cards, ``--spatial`` the spatial phase and its kernel rows
    and ``--sp-cards N`` the spatial phase over N cards, and with any of
    them the run stops there
    (no ``ok`` line): the pieces that can also be run from another commit's
    tree, beside which this file is copied."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="", help="kernel names, comma-separated")
    ap.add_argument("--profile-train", default="", help="model names, comma-separated")
    ap.add_argument("--trainer-workers", default="",
                    help="loader worker counts, comma-separated: one trainer epoch each")
    ap.add_argument("--data-parallel", action="store_true",
                    help="only trainer_bf16 and the data-parallel phases")
    ap.add_argument("--dp-cards", default=0, type=int,
                    help="only the data-parallel phase over this many cards, NCCL")
    ap.add_argument("--spatial", action="store_true",
                    help="only the spatial phase (sp2_shared_card) and its kernel rows")
    ap.add_argument("--sp-cards", default=0, type=int,
                    help="only the spatial phase over this many cards, NCCL, a (N/2, 2) mesh")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from dsmnet_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    so = _build.build()
    build_s = time.perf_counter() - t0
    _build.lib()
    log = so.with_suffix(".log")
    ptxas = ptxas_report(log.read_text()) if log.is_file() else {}
    emit({"env": {"gpu": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
                  "device": torch.cuda.get_device_name(0), "build_s": build_s,
                  "ptxas": ptxas}})

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False          # the f32 references are true f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    gen = torch.Generator(device=dev).manual_seed(0)

    specs = kernel_specs()
    for flag, n in (("--dp-cards", opts.dp_cards), ("--sp-cards", opts.sp_cards)):
        if n and torch.cuda.device_count() < n:
            raise RuntimeError(f"{flag} {n}: {torch.cuda.device_count()} cards")
    if opts.dp_cards:
        run_data_parallel(dev, smi, opts.dp_cards, "nccl")
        emit({"script_s": time.perf_counter() - T_START})
        return 0
    if opts.sp_cards:
        if opts.sp_cards % 2:
            raise RuntimeError(f"--sp-cards {opts.sp_cards}: the mesh is (N / 2, 2)")
        run_spatial(dev, smi, opts.sp_cards, "nccl")
        emit({"script_s": time.perf_counter() - T_START})
        return 0
    if opts.spatial:
        launches = run_spatial(dev, smi)
        for s in specs:
            for path in launches:
                for a, b, n, *args in s["paths"].get(path, []):
                    check_kernel(s, a, b, n, path, dev, gen, *args)
        emit({"script_s": time.perf_counter() - T_START})
        return 0
    if opts.data_parallel:
        _, trainer_row = run_trainer(dev)
        run_dp_cli(trainer_row, smi)
        run_data_parallel(dev, smi)
        emit({"script_s": time.perf_counter() - T_START})
        return 0
    if opts.only or opts.profile_train or opts.trainer_workers:
        for s in specs:
            if s["name"] in opts.only.split(","):
                check_edges(s, dev, gen)
                for path, shapes in s["paths"].items():
                    for a, b, n, *args in shapes:
                        check_kernel(s, a, b, n, path, dev, gen, *args)
        for name in filter(None, opts.profile_train.split(",")):
            profile_train_step(dev, name)
        trainer_workers([int(n) for n in filter(None, opts.trainer_workers.split(","))])
        emit({"script_s": time.perf_counter() - T_START})
        return 0
    for s in specs:
        check_edges(s, dev, gen)
    rows = {(s["name"], path): [check_kernel(s, a, b, n, path, dev, gen, *args)
                                for a, b, n, *args in shapes]
            for s in specs for path, shapes in s["paths"].items()}
    check_stem_op(dev, gen)
    launches = {"serve": run_model(dev, N_REQUESTS)}
    check_gradients(dev)
    launches["train"] = run_training(dev)
    launches["train_gcnet"] = run_training(dev, "gcnet")
    check_remat(dev)
    check_gradients(dev, "gcnet", GCNET_F32_H, GCNET_F32_W, GCNET_F32_MAXDISP, "grad_gcnet_f32")
    check_model_f32(dev, "gcnet", GCNET_F32_H, GCNET_F32_W, GCNET_F32_MAXDISP)
    check_model_f32(dev, "iresnet", H, W, MAXDISP)
    for name, path in SERVE_PATHS.items():
        launches[path] = serve_model(name, dev, N_REQUESTS)
    for name in ("psmnet_basic", "dispnet", "dispnetcorr", "iresnet"):
        launches[TRAIN_RUNS[name][0]] = run_training(dev, name)
    launches["trainer"], trainer_row = run_trainer(dev)
    check_gradients(dev, "dispnetcorr", tag="selfsup_grad_f32",
                    loss_name=SELFSUP_RUNS["dispnetcorr"][1])
    for name, (path, *_) in SELFSUP_RUNS.items():
        launches[path] = run_selfsup_training(dev, name)
    launches["trainer_selfsup"], _ = run_trainer(dev, "trainer_selfsup_bf16")
    launches["dp_cli"] = run_dp_cli(trainer_row, smi)
    launches.update(run_data_parallel(dev, smi))
    launches.update(run_spatial(dev, smi))
    # the shapes' launches in kernel_specs must add up to what each path launched
    for s in specs:
        for path in launches:
            table = sum(e[2] for e in s["paths"].get(path, []))
            if table != launches[path].get(s["name"], 0):
                raise RuntimeError(f"{s['name']} on {path}: kernel_specs counts {table} "
                                   f"launches, the run {launches[path].get(s['name'], 0)}")

    def path_row(name, path):
        # per call of the path: each shape's median per launch x its launches, summed
        total = lambda key: sum(r[key] * r["launches"] for r in rows[(name, path)])
        return dict(launches=launches[path][name], ms=total("kernel_ms"),
                    plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
                    library_ms=total("library_ms"))

    kernels = []
    for s in specs:
        name, primary = s["name"], s["primary"]
        paths = {path: path_row(name, path) for path in s["paths"]}
        head = rows[(name, primary)]
        kernels.append(dict(
            name=name, route=s["route"], source=s["source"], replaces=s["replaces"],
            **paths[primary],
            max_abs_err=max(r["max_abs_err"] for path in s["paths"] for r in rows[(name, path)]),
            bound_by=max(head, key=lambda r: r["bound_ms"] * r["launches"])["bound_by"],
            primary=primary,
            per_call_note=f"launches and ms per call of {primary} (train: a bf16 batch-4 step; "
                          "serve*: a bf16 384x768 request): each shape's median per launch x "
                          "its launches, summed; 'paths' holds every path of the kernel",
            paths=paths))
    emit({"script_s": time.perf_counter() - T_START})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
