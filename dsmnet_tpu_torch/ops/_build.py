"""Build and bind the port's hand-written CUDA kernels.

``csrc/*.cu`` compile at first use with ``nvcc`` for ``sm_90a`` (one
process per source, all started together), link into one shared library
with a plain C interface, and bind with ``ctypes``.  The build goes to
``dsmnet_tpu_torch/_build/``, keyed by a hash of the sources and flags,
so an edited source rebuilds.  A missing ``nvcc`` or a failed compile
raises; there is no fallback.

Every C entry point takes device pointers, a dtype code, the shape and
the CUDA stream, launches on that stream without synchronising, and
returns ``cudaGetLastError()``; :func:`check` raises on a non-zero code.
``LAUNCHES`` counts, per kernel, the launches its wrapper made.

A wrapper returns a tensor with no autograd history, so it refuses
operands that require grad while grad mode is on (:func:`require_no_grad`):
the ops reach the wrappers only inside their ``torch.autograd.Function``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"  # listed in .gitignore
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

# kernel name -> (C entry point, device pointers, int arguments).  Forward
# conv kernels take (x, w, y, dtype, N, [D,] H, W, C, Co), kernels C and D
# also the D-slices per block of their bf16 walks, kernels A and B the work
# items per block of theirs, B a workspace after y (its bf16 128 -> 128
# partials); the
# weight-gradient kernels take (x, g, dk, workspace, dtype, N, D, H, W, C,
# Co, chunks); the cost volume takes (fL, fR, out, dtype, N, H, W, F, D,
# mask_left), the correlation (fL, fR, out, dtype, N, H, W, C, D, stride),
# its VJP (fL, fR, g, dfL, dfR, dtype, N, H, W, C, D, stride),
# the stem's assembly (A, B, out, dtype of out, N, H, W, O, D, mask_left).
ENTRY_POINTS = {
    "conv2d_k3": ("dsm_conv2d_k3", 3, 7),
    "conv3d_k3": ("dsm_conv3d_k3", 4, 8),
    "conv3d_k3s2": ("dsm_conv3d_k3s2", 3, 8),
    "deconv3d_k3s2": ("dsm_deconv3d_k3s2", 3, 8),
    "conv2d_dk_k3": ("dsm_conv2d_dk_k3", 4, 8),
    "conv3d_dk_k3": ("dsm_conv3d_dk_k3", 4, 8),
    "conv3d_dk_k3s2": ("dsm_conv3d_dk_k3s2", 4, 8),
    "cost_volume": ("dsm_cost_volume", 3, 7),
    "corr1d": ("dsm_corr1d", 3, 7),
    "corr1d_vjp": ("dsm_corr1d_vjp", 5, 7),
    "fused_costvol": ("dsm_fused_costvol", 3, 7),
}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# A weight-gradient kernel splits the positions into at most DK_CHUNKS
# chunks (kernels F and G in bf16: as many as their wrappers plan), each
# summed into its own float32 partial dK; a second pass adds the partials
# in a fixed order, so dK is the same bits on every run.
DK_CHUNKS = 128

LAUNCHES: dict[str, int] = {name: 0 for name in ENTRY_POINTS}

_lib: ctypes.CDLL | None = None
_entry: dict[str, ctypes._CFuncPtr] = {}  # kernel name -> bound C entry point


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built with the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu into the shared library (if not built yet); returns its path."""
    digest = _digest()
    so = BUILD_DIR / f"libdsmnet_kernels_{digest}.so"
    if so.is_file():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest}.{os.getpid()}"
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name} (rc {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    so.with_suffix(".log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = BUILD_DIR / f"libdsmnet_kernels.{tag}.so"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in jobs]],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernel library failed:\n{link.stdout}")
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use; binds every entry point once."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, (fn, n_ptr, n_int) in ENTRY_POINTS.items():
            f = getattr(handle, fn)
            # pointers and the stream as c_void_p, the dtype and sizes as c_int
            f.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
            f.restype = ctypes.c_int
            _entry[name] = f
        _lib = handle
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def require_no_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would need a gradient through this wrapper's result:
    the wrapper's output carries no history, so outside its op's
    ``autograd.Function`` it would silently cut the graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"kernel {name} got an operand that requires grad outside its "
                           "autograd.Function; call the op (conv2d_same, conv3d_same, "
                           "conv3d_s2, deconv3d_k3s2, concat_cost_volume, corr1d, "
                           "cost_volume_conv3x3) so that "
                           "the gradient is kept")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of one kernel dtype."""
    dt = tensors[0].dtype
    for t in tensors:
        if not t.is_cuda:
            raise RuntimeError(f"kernel {name} runs on CUDA tensors; got one on {t.device}")
        if t.dtype != dt or dt not in DTYPE_CODES:
            raise TypeError(f"kernel {name} takes float32 or bfloat16 operands of one "
                            f"dtype; got {[u.dtype for u in tensors]}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"kernel {name} needs contiguous operands aligned to 16 bytes")
        if t.device != tensors[0].device:
            raise RuntimeError(f"kernel {name} operands lie on different devices")


def launch_dk(name: str, x: torch.Tensor, g: torch.Tensor, taps: int,
              dims: tuple[int, int, int, int, int, int], rows: int,
              chunks: int | None = None) -> torch.Tensor:
    """Launch weight-gradient kernel ``name`` on x and the cotangent g:
    ``dims`` = (N, D, H, W, C, Co) of x (D = 1 for 2-D) and g's channels,
    ``rows`` the number of cotangent rows (one W line each); ``chunks``
    partials (default: one per row, at most DK_CHUNKS).  Returns dK flat,
    ``taps * C * Co`` float32."""
    if chunks is None:
        chunks = max(1, min(DK_CHUNKS, rows))
    c, co = dims[4], dims[5]
    ws = torch.empty((chunks, taps * c * co), dtype=torch.float32, device=x.device)
    dk = torch.empty((taps * c * co,), dtype=torch.float32, device=x.device)
    launch(name, x.device, x.data_ptr(), g.data_ptr(), dk.data_ptr(), ws.data_ptr(),
           DTYPE_CODES[x.dtype], *dims, chunks)
    return dk


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``: what a launch plan fills."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel ``name``'s entry point on ``device``'s current stream and count it."""
    if _lib is None:
        lib()
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return launch(name, device, *args)
    check(_entry[name](*args, torch.cuda.current_stream(device).cuda_stream), name)
    LAUNCHES[name] += 1
