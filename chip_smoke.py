#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dsmnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the hand-written CUDA kernels from ``dsmnet_tpu_torch/csrc`` and
   prints the card, the versions and the build time.
2. For each kernel at each shape of PSMNet's serving path (384x768,
   maxdisparity 192, batch 1, bf16): its error against the plain PyTorch
   version computed in float32 from the same bf16 inputs with TF32 off,
   its f32 instantiation against the same reference, and the device time
   (CUDA graph replays timed with CUDA events) of the kernel, the plain
   version and one cuDNN call (bf16, channels-last) beside the card's
   bound for the work; also the kernel's eager wall time per call.
3. Full-width PSMNet with seeded weights and BN statistics calibrated by
   one train-mode forward: a float32 forward through the four kernels
   against the plain path (TF32 off), then a bf16 ``Predictor`` answering
   requests while the launch counters show that every request went
   through the kernels.
4. One ``{"kernels": [...]}`` line, the card's name and power limit, and
   last the ``{"ok": true, ...}`` line.

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
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
# bf16 kernel vs f32 reference from the same bf16 inputs: the output's
# bf16 rounding is <= 2^-9 relative and f32 accumulation-order
# differences are ~1e-6, so |kernel - ref| <= 1e-3 + 2^-8 |ref|
BF16_ATOL, BF16_RTOL = 1e-3, 2.0 ** -8
# f32 instantiation vs the same reference: accumulation order only
F32_ATOL, F32_RTOL = 1e-4, 1e-4
# full float32 PSMNet through the kernels, held against the same model in
# float64 (plain path): its error may be at most MODEL_F32_FACTOR times
# the float32 plain (cuDNN, TF32 off) path's error, plus MODEL_F32_ATOL_PX.
# Both f32 paths round differently and the ~60 conv+BN layers of a random,
# BN-calibrated network amplify rounding (0.012 px between the two f32
# paths at 384x768); a wrong tap or index misses by pixels, not by 4x.
MODEL_F32_FACTOR, MODEL_F32_ATOL_PX = 4.0, 1e-3
REQUEST_LAUNCHES = {"conv2d_k3": 8, "conv3d_k3": 12, "conv3d_k3s2": 6, "deconv3d_k3s2": 3}


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
    (input shape, kernel shape, launches per request) of each serving shape."""
    from dsmnet_tpu_torch.ops import conv2d, conv3d

    D4, H2, W2, H4, W4 = MAXDISP // 4, H // 2, W // 2, H // 4, W // 4

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

    def conv_flops(x, k, out):
        taps = math.prod(k[:-2])
        return 2 * math.prod(out[:-1]) * taps * k[-2] * k[-1]

    # "edges": small shapes whose H, W (and D) are not multiples of any
    # tile size, so every ragged-edge path of a kernel is held to its plain
    # version as well; checked only, not timed
    return [
        dict(name="conv2d_k3", route="cuda", source="dsmnet_tpu_torch/csrc/conv2d_k3.cu",
             replaces="dsmnet_tpu/ops/conv2d_pallas.py:183",
             kernel=conv2d.conv2d_k3, plain=conv2d.conv2d_k3_plain, library=lib_conv2d,
             out=lambda x, k: (*x[:-1], k[-1]), flops=conv_flops,
             shapes=[((2, H2, W2, 32), (3, 3, 32, 32), 8)],
             edges=[((1, 10, 40, 32), (3, 3, 32, 32))]),
        dict(name="conv3d_k3", route="cuda", source="dsmnet_tpu_torch/csrc/conv3d_k3.cu",
             replaces="dsmnet_tpu/ops/conv3d_pallas.py:220",
             kernel=conv3d.conv3d_k3, plain=conv3d.conv3d_plain, library=lib_conv3d(1),
             out=lambda x, k: (*x[:-1], k[-1]), flops=conv_flops,
             shapes=[((1, D4, H4, W4, 32), (3, 3, 3, 32, 32), 6),
                     ((1, D4 // 2, H4 // 2, W4 // 2, 64), (3, 3, 3, 64, 64), 3),
                     ((1, D4 // 4, H4 // 4, W4 // 4, 64), (3, 3, 3, 64, 64), 3)],
             edges=[((1, 5, 10, 40, 32), (3, 3, 3, 32, 32)),
                    ((1, 5, 10, 40, 32), (3, 3, 3, 32, 64)),
                    ((1, 5, 9, 20, 64), (3, 3, 3, 64, 32)),
                    ((1, 5, 9, 20, 64), (3, 3, 3, 64, 64))]),
        dict(name="conv3d_k3s2", route="cuda", source="dsmnet_tpu_torch/csrc/conv3d_k3s2.cu",
             replaces="dsmnet_tpu/ops/conv3d_s2_pallas.py:208",
             kernel=conv3d.conv3d_k3s2, plain=conv3d.conv3d_s2_plain, library=lib_conv3d(2),
             out=lambda x, k: (x[0], x[1] // 2, x[2] // 2, x[3] // 2, k[-1]), flops=conv_flops,
             shapes=[((1, D4, H4, W4, 32), (3, 3, 3, 32, 64), 3),
                     ((1, D4 // 2, H4 // 2, W4 // 2, 64), (3, 3, 3, 64, 64), 3)],
             edges=[((1, 6, 10, 40, 32), (3, 3, 3, 32, 64)),
                    ((1, 6, 10, 36, 64), (3, 3, 3, 64, 64))]),
        dict(name="deconv3d_k3s2", route="cuda",
             source="dsmnet_tpu_torch/csrc/deconv3d_k3s2.cu",
             replaces="dsmnet_tpu/ops/conv3d_s2_pallas.py:570",
             kernel=conv3d.deconv3d_k3s2_kernel, plain=conv3d.deconv3d_k3s2_plain,
             library=lib_deconv,
             out=lambda x, k: (x[0], 2 * x[1], 2 * x[2], 2 * x[3], k[3]),
             # every input voxel meets all 27 taps (the output is exactly 2x)
             flops=lambda x, k, out: 2 * math.prod(x[:-1]) * 27 * k[3] * k[4],
             shapes=[((1, D4 // 2, H4 // 2, W4 // 2, 64), (3, 3, 3, 32, 64), 3)],
             edges=[((1, 3, 5, 20, 64), (3, 3, 3, 32, 64))]),
    ]


def kernel_inputs(x_shape, k_shape, dev, gen):
    """bf16 activations ~ N(0, 1) and a He-scaled bf16 kernel."""
    x = torch.randn(x_shape, generator=gen, device=dev).to(torch.bfloat16)
    fan = math.prod(k_shape[:-2]) * k_shape[-1]
    k = (torch.randn(k_shape, generator=gen, device=dev) * math.sqrt(2.0 / fan)).to(
        torch.bfloat16)
    return x, k


def kernel_errors(spec, x, k):
    """The bf16 and f32 kernels against the plain version in f32 (TF32 off)
    on the same bf16 inputs: max errors and counts outside the tolerance."""
    out_shape = spec["out"](tuple(x.shape), tuple(k.shape))
    ref = spec["plain"](x.float(), k.float()).float()
    y = spec["kernel"](x, k)
    y32 = spec["kernel"](x.float(), k.float())
    torch.cuda.synchronize()
    for out, dt in ((y, torch.bfloat16), (y32, torch.float32)):
        if tuple(out.shape) != tuple(out_shape) or out.dtype != dt:
            raise RuntimeError(f"{spec['name']}: output {tuple(out.shape)} {out.dtype}, "
                               f"expected {out_shape} {dt}")
    err = (y.float() - ref).abs()
    err32 = (y32 - ref).abs()
    res = dict(max_abs_err=err.max().item(), ref_max_abs=ref.abs().max().item(),
               n_outside_tol=(err > BF16_ATOL + BF16_RTOL * ref.abs()).sum().item(),
               f32_max_abs_err=err32.max().item(),
               f32_n_outside_tol=(err32 > F32_ATOL + F32_RTOL * ref.abs()).sum().item())
    if res["n_outside_tol"] or res["f32_n_outside_tol"] or not torch.isfinite(y.float()).all():
        emit({"kernel_failure": {"kernel": spec["name"], "x": list(x.shape), **res}})
        raise RuntimeError(f"{spec['name']} at {tuple(x.shape)}: {res['n_outside_tol']} bf16 / "
                           f"{res['f32_n_outside_tol']} f32 outputs outside tolerance")
    return res


def check_edges(spec, dev, gen):
    """Ragged-edge shapes: errors only."""
    rows = [dict(x=list(xs), k=list(ks), **kernel_errors(spec, *kernel_inputs(xs, ks, dev, gen)))
            for xs, ks in spec["edges"]]
    emit({"kernel_edges": {"kernel": spec["name"], "cases": rows}})


def check_kernel(spec, x_shape, k_shape, dev, gen):
    """Error of the bf16 and f32 kernels against the plain f32 reference, and timings."""
    x, k = kernel_inputs(x_shape, k_shape, dev, gen)
    out_shape = spec["out"](x_shape, k_shape)
    errs = kernel_errors(spec, x, k)

    flops = spec["flops"](x_shape, k_shape, out_shape)
    nbytes = 2 * (math.prod(x_shape) + math.prod(k_shape) + math.prod(out_shape))
    t_flops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    row = dict(
        kernel=spec["name"], x=list(x_shape), k=list(k_shape), out=list(out_shape), **errs,
        tolerance=f"|k - ref| <= {BF16_ATOL} + 2^-8 |ref| (f32: {F32_ATOL} + {F32_RTOL} |ref|)",
        kernel_ms=time_ms(lambda: spec["kernel"](x, k)),
        kernel_host_ms=host_ms(lambda: spec["kernel"](x, k)),
        plain_ms=time_ms(lambda: spec["plain"](x, k)),
        library_ms=time_ms(spec["library"](x, k)),
        bound_ms=max(t_flops, t_bytes), bound_by="operations" if t_flops >= t_bytes else "bytes",
        gflop=flops / 1e9, mbytes=nbytes / 1e6,
    )
    emit({"kernel_check": row})
    return row


def run_model(dev, n_requests: int):
    from dsmnet_tpu_torch import config
    from dsmnet_tpu_torch.images import normalize_imagenet
    from dsmnet_tpu_torch.models import create_model
    from dsmnet_tpu_torch.models.layers import calibrate_batch_stats
    from dsmnet_tpu_torch.ops import _build
    from dsmnet_tpu_torch.serve import Predictor

    model = create_model("psmnet", MAXDISP).reset_parameters(
        torch.Generator().manual_seed(0)).to(dev)
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
    f32_launches = dict(_build.LAUNCHES)
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
    launches = dict(_build.LAUNCHES)
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
    profile_request(server, pairs[0])
    return launches


def profile_request(server, pair, top: int = 25) -> None:
    """Where one request's time goes: device time by kernel under
    torch.profiler, and the device's busy share of the request's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.predict(*pair)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        kernels.append((e.key[:80], us / 1e3, e.count))
    kernels.sort(key=lambda r: -r[1])
    device_ms = sum(ms for _, ms, _ in kernels)
    ported_ms = sum(ms for name, ms, _ in kernels if "conv_k3_kernel" in name
                    or "deconv_k3s2_kernel" in name)
    emit({"serve_profile": {"wall_ms": wall_ms, "device_ms": device_ms,
                            "device_busy_share": device_ms / wall_ms,
                            "ported_kernels_ms": ported_ms,
                            "top_kernels_ms_count": kernels[:top]}})


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
    rows = {s["name"]: [check_kernel(s, xs, ks, dev, gen) for xs, ks, _ in s["shapes"]]
            for s in specs}
    launches = run_model(dev, N_REQUESTS)

    kernels = []
    for s in specs:
        per_req = [n for _, _, n in s["shapes"]]
        # times per request: each shape's median per launch x its launches per request
        tot = lambda key: sum(r[key] * n for r, n in zip(rows[s["name"]], per_req))
        kernels.append(dict(
            name=s["name"], route=s["route"], source=s["source"], replaces=s["replaces"],
            launches=launches[s["name"]],
            max_abs_err=max(r["max_abs_err"] for r in rows[s["name"]]),
            ms=tot("kernel_ms"), plain_ms=tot("plain_ms"), bound_ms=tot("bound_ms"),
            bound_by=max(zip(rows[s["name"]], per_req),
                         key=lambda rn: rn[0]["bound_ms"] * rn[1])[0]["bound_by"],
            library_ms=tot("library_ms"),
            per_request_ms_note="ms fields sum each serving shape's median x launches per request",
        ))
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
