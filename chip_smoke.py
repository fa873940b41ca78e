#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dsmnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the hand-written CUDA kernels from ``dsmnet_tpu_torch/csrc`` and
   prints the card, the versions and the build time.
2. For each kernel at each shape of its paths: PSMNet serving (384x768,
   maxdisparity 192, batch 1) for the forward kernels A-D, and the
   supervised train step (384x768 crop, batch 4) for A-D in their
   forward and backward roles and the weight-gradient kernels E-G.  Each
   shape's bf16 kernel and its f32 instantiation are held against the
   plain PyTorch version computed in float32 from the same bf16 inputs
   with TF32 off; E-G must also give the same bits on two launches.  The
   device time (CUDA graph replays timed with CUDA events) of the kernel,
   the plain version and one cuDNN call beside the card's bound for the
   work; also the kernel's eager wall time per call.  Small ragged-edge
   shapes are checked, not timed.
3. Serving: full-width PSMNet with seeded weights and BN statistics
   calibrated by one train-mode forward: a float32 forward through the
   kernels against the plain path (TF32 off), both against float64; then
   a bf16 ``Predictor`` answering requests while the launch counters show
   that every request went through A-D (8/12/6/3 per request), and one
   profiled request.
4. Gradients: one 384x768 pair through a train-mode float32 forward and
   backward on the kernels, every parameter's gradient held against the
   float64 plain model next to the float32 plain path's own error.
5. Training: ``create_train_state`` + ``make_supervised_train_step``, bf16,
   batch 4, on one fixed batch for TRAIN_STEPS steps: every step's launch
   counts equal the table below, the loss falls, and the median step
   time, frames/s and peak memory are printed; then one profiled step.
6. One ``{"kernels": [...]}`` line (launches and times per train step; A-D
   also per request), the card's name and power limit, and last the
   ``{"ok": true, ...}`` line.

Any failed check raises: the script exits non-zero and prints no result.
It exits non-zero at once when CUDA is not available.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

H, W, MAXDISP = 384, 768, 192
N_REQUESTS = 6
TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 4, 8, 1e-3
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
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
REQUEST_LAUNCHES = {"conv2d_k3": 8, "conv3d_k3": 12, "conv3d_k3s2": 6, "deconv3d_k3s2": 3}
# A-D forward plus their backward roles (dx of A and B, the deconv's
# d(input) on C, the stride-2 conv's dx on D) and the weight gradients
STEP_LAUNCHES = {"conv2d_k3": 16, "conv3d_k3": 24, "conv3d_k3s2": 9, "deconv3d_k3s2": 6,
                 "conv2d_dk_k3": 8, "conv3d_dk_k3": 12, "conv3d_dk_k3s2": 9}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, samples: int = 21, reps: int = 10, warmup: int = 3) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph after
    warm-up, the graph's replay timed with CUDA events, median over
    ``samples`` replays.  A replay issues no Python, so this is the card's
    time for the work, not the rate at which the host launches it."""
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
    """Per kernel: wrapper, plain version, one-call cuDNN yardstick, and the
    (first operand shape, second operand shape, launches) of each shape on
    the serving path ("shapes", launches per request) and on the train
    step ("train", launches per step).  A conv kernel (kind "conv") takes
    (x, kernel); a weight-gradient kernel (kind "dk") takes (x, cotangent)."""
    from dsmnet_tpu_torch.ops import conv2d, conv3d

    D4, H2, W2, H4, W4 = MAXDISP // 4, H // 2, W // 2, H // 4, W // 4
    B = TRAIN_BATCH
    vol32 = lambda n: (n, D4, H4, W4, 32)
    vol64 = lambda n: (n, D4 // 2, H4 // 2, W4 // 2, 64)
    vol64s = lambda n: (n, D4 // 4, H4 // 4, W4 // 4, 64)
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
            xc, gc = x.permute(*to_nc), g.permute(*to_nc)
            return lambda: torch.ops.aten.convolution_backward(
                gc, xc, w, None, [stride] * dims, [1] * dims, [1] * dims, False, [0] * dims, 1,
                [False, True, False])
        return make

    def conv_flops(x, k, out):
        taps = math.prod(k[:-2])
        return 2 * math.prod(out[:-1]) * taps * k[-2] * k[-1]

    def dk_flops(taps):
        # every cotangent position meets every tap
        return lambda x, g, out: 2 * math.prod(g[:-1]) * taps * x[-1] * g[-1]

    # "edges": small shapes whose H, W (and D) are not multiples of any
    # tile size, so every ragged-edge path of a kernel is held to its plain
    # version as well; checked only, not timed
    return [
        dict(name="conv2d_k3", kind="conv", route="cuda", source="dsmnet_tpu_torch/csrc/conv2d_k3.cu",
             replaces="dsmnet_tpu/ops/conv2d_pallas.py:183",
             kernel=conv2d.conv2d_k3, plain=conv2d.conv2d_k3_plain, library=lib_conv2d,
             out=lambda x, k: (*x[:-1], k[-1]), flops=conv_flops,
             shapes=[((2, H2, W2, 32), (3, 3, 32, 32), 8)],
             # forward and dx (the flipped, channel-swapped kernel)
             train=[((2 * B, H2, W2, 32), (3, 3, 32, 32), 16)],
             edges=[((1, 10, 40, 32), (3, 3, 32, 32))]),
        dict(name="conv3d_k3", kind="conv", route="cuda", source="dsmnet_tpu_torch/csrc/conv3d_k3.cu",
             replaces="dsmnet_tpu/ops/conv3d_pallas.py:220",
             kernel=conv3d.conv3d_k3, plain=conv3d.conv3d_plain, library=lib_conv3d(1),
             out=lambda x, k: (*x[:-1], k[-1]), flops=conv_flops,
             shapes=[(vol32(1), k3(32, 32), 6), (vol64(1), k3(64, 64), 3),
                     (vol64s(1), k3(64, 64), 3)],
             train=[(vol32(B), k3(32, 32), 12), (vol64(B), k3(64, 64), 6),
                    (vol64s(B), k3(64, 64), 6)],
             edges=[((1, 5, 10, 40, 32), k3(32, 32)), ((1, 5, 10, 40, 32), k3(32, 64)),
                    ((1, 5, 9, 20, 64), k3(64, 32)), ((1, 5, 9, 20, 64), k3(64, 64))]),
        dict(name="conv3d_k3s2", kind="conv", route="cuda",
             source="dsmnet_tpu_torch/csrc/conv3d_k3s2.cu",
             replaces="dsmnet_tpu/ops/conv3d_s2_pallas.py:208",
             kernel=conv3d.conv3d_k3s2, plain=conv3d.conv3d_s2_plain, library=lib_conv3d(2),
             out=lambda x, k: (x[0], x[1] // 2, x[2] // 2, x[3] // 2, k[-1]), flops=conv_flops,
             shapes=[(vol32(1), k3(32, 64), 3), (vol64(1), k3(64, 64), 3)],
             # conv1 forward and the conv6 deconv's d(input) share a shape
             train=[(vol32(B), k3(32, 64), 6), (vol64(B), k3(64, 64), 3)],
             edges=[((1, 6, 10, 40, 32), k3(32, 64)), ((1, 6, 10, 36, 64), k3(64, 64))]),
        dict(name="deconv3d_k3s2", kind="conv", route="cuda",
             source="dsmnet_tpu_torch/csrc/deconv3d_k3s2.cu",
             replaces="dsmnet_tpu/ops/conv3d_s2_pallas.py:570",
             kernel=conv3d.deconv3d_k3s2_kernel, plain=conv3d.deconv3d_k3s2_plain,
             library=lib_deconv,
             out=lambda x, k: (x[0], 2 * x[1], 2 * x[2], 2 * x[3], k[3]),
             # every input voxel meets all 27 taps (the output is exactly 2x)
             flops=lambda x, k, out: 2 * math.prod(x[:-1]) * 27 * k[3] * k[4],
             shapes=[(vol64(1), k3(32, 64), 3)],
             # conv6 forward and the conv1 stride-2 conv's dx share a shape
             train=[(vol64(B), k3(32, 64), 6)],
             edges=[((1, 3, 5, 20, 64), k3(32, 64))]),
        dict(name="conv2d_dk_k3", kind="dk", route="cuda",
             source="dsmnet_tpu_torch/csrc/conv2d_dk_k3.cu",
             replaces="dsmnet_tpu/ops/conv2d_pallas.py:280",
             kernel=conv2d.conv2d_dk_k3, plain=conv2d.conv2d_dk_plain,
             library=lib_wgrad(1, 2), out=lambda x, g: (3, 3, x[-1], g[-1]), flops=dk_flops(9),
             train=[((2 * B, H2, W2, 32), (2 * B, H2, W2, 32), 8)],
             edges=[((1, 10, 40, 32), (1, 10, 40, 32))]),
        dict(name="conv3d_dk_k3", kind="dk", route="cuda",
             source="dsmnet_tpu_torch/csrc/conv3d_dk_k3.cu",
             replaces="dsmnet_tpu/ops/conv3d_pallas.py:341",
             kernel=conv3d.conv3d_dk_k3, plain=conv3d.conv3d_dk_plain,
             library=lib_wgrad(1, 3), out=lambda x, g: (3, 3, 3, x[-1], g[-1]), flops=dk_flops(27),
             train=[(vol32(B), vol32(B), 6), (vol64(B), vol64(B), 3), (vol64s(B), vol64s(B), 3)],
             edges=[((1, 5, 10, 40, 32), (1, 5, 10, 40, 32)),
                    ((1, 5, 10, 40, 32), (1, 5, 10, 40, 64)),
                    ((1, 5, 9, 20, 64), (1, 5, 9, 20, 32)),
                    ((1, 5, 9, 20, 64), (1, 5, 9, 20, 64))]),
        dict(name="conv3d_dk_k3s2", kind="dk", route="cuda",
             source="dsmnet_tpu_torch/csrc/conv3d_dk_k3s2.cu",
             replaces="dsmnet_tpu/ops/conv3d_s2_pallas.py:346",
             kernel=conv3d.conv3d_s2_dk_k3, plain=conv3d.conv3d_s2_dk_plain,
             library=lib_wgrad(2, 3), out=lambda x, g: (3, 3, 3, x[-1], g[-1]), flops=dk_flops(27),
             # conv1's dK and, roles swapped, the conv6 deconv's dW share a shape
             train=[(vol32(B), vol64(B), 6), (vol64(B), vol64s(B), 3)],
             edges=[((1, 6, 10, 40, 32), (1, 3, 5, 20, 64)),
                    ((1, 6, 10, 36, 64), (1, 3, 5, 18, 64))]),
    ]


def kernel_inputs(spec, a_shape, b_shape, dev, gen):
    """bf16 activations ~ N(0, 1); for a conv, a He-scaled bf16 kernel, for
    a weight gradient a bf16 cotangent ~ N(0, 1)."""
    a = torch.randn(a_shape, generator=gen, device=dev).to(torch.bfloat16)
    scale = 1.0 if spec["kind"] == "dk" else math.sqrt(
        2.0 / (math.prod(b_shape[:-2]) * b_shape[-1]))
    b = (torch.randn(b_shape, generator=gen, device=dev) * scale).to(torch.bfloat16)
    return a, b


def kernel_errors(spec, a, b):
    """The bf16 and f32 kernels against the plain version in f32 (TF32 off)
    on the same bf16 inputs: max errors and counts outside the tolerance."""
    out_shape = spec["out"](tuple(a.shape), tuple(b.shape))
    ref = spec["plain"](a.float(), b.float()).float()
    y = spec["kernel"](a, b)
    y32 = spec["kernel"](a.float(), b.float())
    dk = spec["kind"] == "dk"
    want = torch.float32 if dk else torch.bfloat16
    torch.cuda.synchronize()
    for out, dt in ((y, want), (y32, torch.float32)):
        if tuple(out.shape) != tuple(out_shape) or out.dtype != dt:
            raise RuntimeError(f"{spec['name']}: output {tuple(out.shape)} {out.dtype}, "
                               f"expected {out_shape} {dt}")
    err = (y.float() - ref).abs()
    err32 = (y32 - ref).abs()
    if dk:
        scale = spec["plain"](a.float().abs(), b.float().abs()).float()
        tol = DK_ATOL + DK_RTOL * scale
        tol32 = tol
    else:
        scale = ref.abs()
        tol = BF16_ATOL + BF16_RTOL * scale
        tol32 = F32_ATOL + F32_RTOL * scale
    res = dict(max_abs_err=err.max().item(), ref_max_abs=ref.abs().max().item(),
               n_outside_tol=(err > tol).sum().item(), f32_max_abs_err=err32.max().item(),
               f32_n_outside_tol=(err32 > tol32).sum().item())
    if dk:
        res["max_err_over_scale"] = (err / scale.clamp(min=1e-30)).max().item()
        # a weight gradient is the same bits on every launch
        again = spec["kernel"](a, b)
        torch.cuda.synchronize()
        res["bit_identical"] = bool(torch.equal(y, again))
    bad = res["n_outside_tol"] or res["f32_n_outside_tol"] or not res.get("bit_identical", True)
    if bad or not torch.isfinite(y.float()).all():
        emit({"kernel_failure": {"kernel": spec["name"], "a": list(a.shape), **res}})
        raise RuntimeError(f"{spec['name']} at {tuple(a.shape)}: {res['n_outside_tol']} bf16 / "
                           f"{res['f32_n_outside_tol']} f32 outputs outside tolerance, "
                           f"bit-identical {res.get('bit_identical', 'n/a')}")
    return res


def tolerance_text(spec) -> str:
    if spec["kind"] == "dk":
        return (f"|dk - ref| <= {DK_ATOL} + {DK_RTOL} (|x|^T |g|), bf16 and f32 kernels; "
                "two launches bit-identical")
    return f"|k - ref| <= {BF16_ATOL} + 2^-8 |ref| (f32: {F32_ATOL} + {F32_RTOL} |ref|)"


def check_edges(spec, dev, gen):
    """Ragged-edge shapes: errors only."""
    rows = [dict(a=list(a_s), b=list(b_s),
                 **kernel_errors(spec, *kernel_inputs(spec, a_s, b_s, dev, gen)))
            for a_s, b_s in spec["edges"]]
    emit({"kernel_edges": {"kernel": spec["name"], "cases": rows}})


def check_kernel(spec, a_shape, b_shape, launches, path, dev, gen):
    """Errors of the bf16 and f32 kernels against the plain f32 reference, and timings."""
    a, b = kernel_inputs(spec, a_shape, b_shape, dev, gen)
    out_shape = spec["out"](a_shape, b_shape)
    errs = kernel_errors(spec, a, b)
    flops = spec["flops"](a_shape, b_shape, out_shape)
    out_bytes = (4 if spec["kind"] == "dk" else 2) * math.prod(out_shape)
    nbytes = 2 * (math.prod(a_shape) + math.prod(b_shape)) + out_bytes
    t_flops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    row = dict(
        kernel=spec["name"], path=path, a=list(a_shape), b=list(b_shape), out=list(out_shape),
        launches=launches, **errs, tolerance=tolerance_text(spec),
        kernel_ms=time_ms(lambda: spec["kernel"](a, b)),
        kernel_host_ms=host_ms(lambda: spec["kernel"](a, b)),
        plain_ms=time_ms(lambda: spec["plain"](a, b)),
        library_ms=time_ms(spec["library"](a, b)),
        bound_ms=max(t_flops, t_bytes), bound_by="operations" if t_flops >= t_bytes else "bytes",
        gflop=flops / 1e9, mbytes=nbytes / 1e6,
    )
    emit({"kernel_check": row})
    return row


def seeded_model(dev):
    from dsmnet_tpu_torch.models import create_model

    return create_model("psmnet", MAXDISP).reset_parameters(
        torch.Generator().manual_seed(0)).to(dev)


def run_model(dev, n_requests: int):
    from dsmnet_tpu_torch import config
    from dsmnet_tpu_torch.images import normalize_imagenet
    from dsmnet_tpu_torch.models.layers import calibrate_batch_stats
    from dsmnet_tpu_torch.ops import _build
    from dsmnet_tpu_torch.serve import Predictor

    model = seeded_model(dev)
    rng = np.random.RandomState(0)
    pairs = [(rng.rand(H, W, 3).astype(np.float32), rng.rand(H, W, 3).astype(np.float32))
             for _ in range(n_requests + 1)]
    iL, iR = (normalize_imagenet(torch.from_numpy(p)[None].to(dev)) for p in pairs[0])

    t0 = time.perf_counter()
    calibrate_batch_stats(model, iL, iR)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0

    # float32 forward: the four kernels (f32 instantiations) and the plain
    # path, both against the float64 plain path
    with torch.no_grad():
        with config.implementation("plain"):
            ref = model(iL, iR, clamp=True)[1]
            model64 = copy.deepcopy(model).double()
            ref64 = model64(iL.double(), iR.double(), clamp=True)[1]
            del model64
        _build.reset_launches()
        out = model(iL, iR, clamp=True)[1]
        torch.cuda.synchronize()
    f32_launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    maxdiff = lambda a, b: [(u.double() - v.double()).abs().max().item() for u, v in zip(a, b)]
    d_kernel, d_plain, d_pair = maxdiff(out, ref64), maxdiff(ref, ref64), maxdiff(out, ref)
    emit({"model_f32": {"kernels_vs_f64_px": d_kernel, "plain_vs_f64_px": d_plain,
                        "kernels_vs_plain_px": d_pair,
                        "tolerance": f"kernels_vs_f64 <= {MODEL_F32_FACTOR} * plain_vs_f64"
                                     f" + {MODEL_F32_ATOL_PX} px",
                        "launches": f32_launches, "calibrate_s": calib_s}})
    if f32_launches != REQUEST_LAUNCHES:
        raise RuntimeError(f"f32 forward launches {f32_launches}, expected {REQUEST_LAUNCHES}")
    if not all(k <= MODEL_F32_FACTOR * p + MODEL_F32_ATOL_PX for k, p in zip(d_kernel, d_plain)):
        raise RuntimeError(f"f32 kernel path error {d_kernel} px vs plain {d_plain} px")

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


def profile(tag: str, fn, top: int = 25) -> None:
    """Where one call's time goes: device time by kernel under
    torch.profiler, and the device's busy share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
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
    kernels.sort(key=lambda r: -r[1])
    device_ms = sum(ms for _, ms, _ in kernels)
    ported_ms = sum(ms for name, ms, _ in kernels if any(
        s in name for s in ("conv_k3_kernel", "deconv_k3s2_kernel", "dk_k3_kernel", "dk_reduce")))
    emit({tag: {"wall_ms": wall_ms, "device_ms": device_ms,
                "device_busy_share": device_ms / wall_ms, "ported_kernels_ms": ported_ms,
                "top_kernels_ms_count": kernels[:top]}})


def train_batch(n: int, dev) -> torch.Tensor:
    """A fixed random 7-channel batch as bench.py:84-86 builds it."""
    rng = np.random.RandomState(0)
    b = rng.rand(n, H, W, 7).astype(np.float32)
    b[..., 6] = b[..., 6] * 100 + 1
    return torch.from_numpy(b).to(dev)


def check_gradients(dev) -> None:
    """Every parameter's float32 gradient through the kernels against the
    float64 plain model, next to the float32 plain path's own error."""
    from dsmnet_tpu_torch import config
    from dsmnet_tpu_torch.losses import supervised_pyramid_loss
    from dsmnet_tpu_torch.ops import _build

    model = seeded_model(dev).train()
    batch = train_batch(1, dev)

    def grads(m, b):
        m.zero_grad(set_to_none=True)
        scales, disps = m(b[..., :3], b[..., 3:6])
        loss = supervised_pyramid_loss(b[..., 6:7], disps, scales, np.ones(1))
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
    rel = lambda a, b: ((a - b).norm() / b.norm().clamp(min=1e-300)).item()
    rows = {n: (rel(g_k[n], g_64[n]), rel(g_p[n], g_64[n])) for n in g_64}
    floor = GRAD_F32_FLOOR_SHARE * statistics.median(r[1] for r in rows.values())
    limit = lambda r: GRAD_F32_FACTOR * r[1] + floor
    bad = {n: r for n, r in rows.items() if not r[0] <= limit(r)}
    worst = sorted(rows.items(), key=lambda kv: -kv[1][0])[:5]
    # the parameters nearest their limit: (kernels, plain, kernels / limit)
    tightest = [(n, (*r, r[0] / limit(r))) for n, r in
                sorted(rows.items(), key=lambda kv: -kv[1][0] / limit(kv[1]))[:5]]
    emit({"grad_f32": {
        "pair": [H, W], "batch": 1, "params": len(rows),
        "loss": {"kernels": loss_k, "plain_f32": loss_p, "f64": loss_64},
        "max_rel_err_kernels": max(r[0] for r in rows.values()),
        "max_rel_err_plain": max(r[1] for r in rows.values()),
        "median_rel_err_kernels": statistics.median(r[0] for r in rows.values()),
        "median_rel_err_plain": statistics.median(r[1] for r in rows.values()),
        "worst_kernels": worst, "tightest": tightest, "outside_tol": bad,
        "tolerance": f"per parameter |g - g64| / |g64|: kernels <= {GRAD_F32_FACTOR} * plain"
                     f" + {GRAD_F32_FLOOR_SHARE} * median(plain) = {floor:.3g}",
        "launches": launches}})
    if launches != STEP_LAUNCHES:
        raise RuntimeError(f"f32 gradient launches {launches}, expected {STEP_LAUNCHES}")
    if bad:
        raise RuntimeError(f"{len(bad)} parameter gradients outside tolerance: {bad}")


def run_training(dev):
    """The supervised train step, bf16, batch TRAIN_BATCH, on one fixed batch."""
    from dsmnet_tpu_torch.models.layers import compute_dtype
    from dsmnet_tpu_torch.ops import _build
    from dsmnet_tpu_torch.train import create_train_state, make_supervised_train_step

    state, opt = create_train_state(seeded_model(dev), device=dev)
    step = make_supervised_train_step(state.model, opt)
    batch = train_batch(TRAIN_BATCH, dev)
    weights = np.ones(1, np.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, counts = [], [], []
    with compute_dtype(torch.bfloat16):
        for _ in range(TRAIN_STEPS):
            _build.reset_launches()
            t0 = time.perf_counter()
            m = step(state, batch, TRAIN_LR, weights)
            loss = m["loss"].item()  # synchronises: the step has completed
            step_ms.append((time.perf_counter() - t0) * 1e3)
            counts.append({k: v for k, v in _build.LAUNCHES.items() if v})
            losses.append(loss)
        metrics = {k: v.item() for k, v in m.items()}
        peak = torch.cuda.max_memory_allocated() / 1e9
        profile("train_profile", lambda: step(state, batch, TRAIN_LR, weights))
    med = statistics.median(step_ms[1:])  # the first step also warms the allocator
    emit({"train_bf16": {
        "batch": TRAIN_BATCH, "crop": [H, W], "maxdisparity": MAXDISP, "steps": TRAIN_STEPS,
        "lr": TRAIN_LR, "loss": losses, "last_metrics": metrics, "step_ms": step_ms,
        "median_step_ms": med, "frames_per_s": TRAIN_BATCH * 1e3 / med, "peak_mem_gb": peak,
        "launches_per_step": counts[-1], "expected_launches_per_step": STEP_LAUNCHES}})
    if any(c != STEP_LAUNCHES for c in counts):
        raise RuntimeError(f"train-step launches {counts}, expected {STEP_LAUNCHES} per step")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise RuntimeError(f"the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    return counts[-1]


def main() -> int:
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
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.is_file() else []
    emit({"env": {"gpu": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
                  "device": torch.cuda.get_device_name(0), "build_s": build_s,
                  "ptxas": ptxas}})

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False          # the f32 references are true f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    gen = torch.Generator(device=dev).manual_seed(0)

    specs = kernel_specs()
    for s in specs:
        check_edges(s, dev, gen)
    rows = {(s["name"], path): [check_kernel(s, a, b, n, path, dev, gen)
                                for a, b, n in s.get(key, [])]
            for s in specs for path, key in (("serve", "shapes"), ("train", "train"))}
    serve_launches = run_model(dev, N_REQUESTS)
    check_gradients(dev)
    step_launches = run_training(dev)

    def per_call(name, path, key):
        # sum over the path's shapes of the median per launch x its launches
        return sum(r[key] * r["launches"] for r in rows[(name, path)])

    kernels = []
    for s in specs:
        train = rows[(s["name"], "train")]
        entry = dict(
            name=s["name"], route=s["route"], source=s["source"], replaces=s["replaces"],
            launches=step_launches[s["name"]],
            max_abs_err=max(r["max_abs_err"] for r in train + rows[(s["name"], "serve")]),
            ms=per_call(s["name"], "train", "kernel_ms"),
            plain_ms=per_call(s["name"], "train", "plain_ms"),
            bound_ms=per_call(s["name"], "train", "bound_ms"),
            bound_by=max(train, key=lambda r: r["bound_ms"] * r["launches"])["bound_by"],
            library_ms=per_call(s["name"], "train", "library_ms"),
            per_call_note="launches and ms per train step (bf16, batch 4): each shape's "
                          "median per launch x its launches per step, summed",
        )
        if s.get("shapes"):
            entry.update(serve_launches=serve_launches[s["name"]],
                         serve_ms=per_call(s["name"], "serve", "kernel_ms"),
                         serve_plain_ms=per_call(s["name"], "serve", "plain_ms"),
                         serve_bound_ms=per_call(s["name"], "serve", "bound_ms"),
                         serve_library_ms=per_call(s["name"], "serve", "library_ms"))
        kernels.append(entry)
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
