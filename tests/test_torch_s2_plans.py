"""Launch plans of kernels C and G (the stride-2 3x3x3 conv and its dK),
and of kernel F (the stride-1 dK) at 128 -> 128 (its other widths:
``tests/test_torch_k3_plans.py``).

The wrappers in ``dsmnet_tpu_torch/ops/conv3d.py`` size kernel C's D-runs
and kernel G's and F's partials in Python; the CUDA kernels cut their
grids by the same formulas.  These tests hold the plans at PSMNet's and GCNet's
main-path shapes and at ``chip_smoke.py``'s ragged edge shapes: every
output voxel of C and every cotangent position of G is covered exactly
once, and the wrappers pass the planned arguments (G: as many partials as
``launch_dk`` allocates).  No kernel runs here: the launch is replaced.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dsmnet_tpu_torch import config
from dsmnet_tpu_torch.ops import _build, conv3d


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


# x shapes (N, D, H, W, C): train conv1/conv3 at batch 4, the same at
# batch 1 (PSMNet serving), GCNet l21/l24/l27, then chip_smoke's edges
_C_SHAPES = [(4, 48, 96, 192, 32), (4, 24, 48, 96, 64), (1, 48, 96, 192, 32),
             (1, 24, 48, 96, 64), (1, 96, 192, 384, 64), (1, 48, 96, 192, 64),
             (1, 6, 10, 40, 32), (1, 6, 10, 36, 64), (1, 2, 10, 40, 32), (2, 10, 32, 72, 64),
             (2, 18, 10, 200, 32), (1, 4, 2, 40, 32), (2, 6, 10, 36, 64)]
_G_SHAPES = [(4, 48, 96, 192, 32), (4, 24, 48, 96, 64), (1, 6, 10, 40, 32), (1, 6, 10, 36, 64),
             (1, 2, 10, 40, 32), (1, 10, 6, 36, 64), (1, 4, 2, 40, 32), (2, 6, 10, 200, 32)]


def _shape_id(s):
    return "x".join(map(str, s))


def _chunk_ranges(rows: int, chunks: int) -> list[tuple[int, int]]:
    """The rows [lo, hi) that each of kernel G's chunks sums, as
    launch_s2_dk (csrc/s2_ring.cuh) cuts them."""
    per = -(-rows // chunks)
    return [(b * per, min(rows, (b + 1) * per)) for b in range(chunks)]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape", _C_SHAPES, ids=_shape_id)
def test_s2_fwd_blocks_cover_every_output_once(shape, sms):
    """Kernel C's grid (Co blocks x w tiles, h tiles, N x runs), each block a
    run [d0, d1) of output slices, covers each output voxel and channel
    exactly once."""
    n, d, h, w, c = shape
    do, ho, wo = d // 2, h // 2, w // 2
    run = conv3d.s2_fwd_run(n, do, ho, wo, c, sms)
    assert 1 <= run <= do
    runs = conv3d.s2_fwd_runs(do, run)
    assert runs[0][0] == 0 and runs[-1][1] == do
    assert all(a < b and b == nxt for (a, b), (nxt, _) in zip(runs, runs[1:] + [(do, 0)]))
    rh, tm, ncob = conv3d.S2_FWD_TILES[c]
    cob = 64 // ncob
    seen = np.zeros((n, do, ho, wo, 64), np.uint8)
    for bz in range(n * len(runs)):
        d0, d1 = runs[bz % len(runs)]
        for by in range(-(-ho // rh)):
            for bx in range(ncob * -(-wo // tm)):
                j, wt = bx % ncob, bx // ncob
                seen[bz // len(runs), d0:d1, by * rh:by * rh + rh, wt * tm:wt * tm + tm,
                     j * cob:(j + 1) * cob] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape", _G_SHAPES, ids=_shape_id)
def test_s2_dk_chunks_cover_every_row_once(shape, sms):
    """Kernel G's chunks are contiguous, non-empty ranges of its rows (n, od,
    48-position segment, oh), oh fastest, that cover every cotangent
    position exactly once."""
    n, d, h, w, c = shape
    dg, hg, wg = d // 2, h // 2, w // 2
    rows = conv3d.s2_dk_rows(n, d, h, w)
    chunks = conv3d.s2_dk_chunks(rows, c, sms)
    assert 1 <= chunks <= max(1, sms * conv3d.S2_DK_BLOCKS_PER_SM[c] // 3)
    ranges = _chunk_ranges(rows, chunks)
    assert len(ranges) == chunks and ranges[0][0] == 0 and ranges[-1][1] == rows
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    seg = conv3d.S2_DK_SEGMENT
    nseg = -(-wg // seg)
    seen = np.zeros((n, dg, hg, wg), np.uint8)
    for lo, hi in ranges:
        for it in range(lo, hi):
            line, oh = divmod(it, hg)
            nd, s = divmod(line, nseg)
            seen[nd // dg, nd % dg, oh, s * seg:(s + 1) * seg] += 1
    assert (seen == 1).all()


def _forced_launch(monkeypatch):
    """Route the wrappers to their launch on CPU tensors and record it."""
    calls = []
    monkeypatch.setattr(config, "launches_kernel", lambda op, x: True)
    monkeypatch.setattr(_build, "require_cuda", lambda name, *t: None)
    monkeypatch.setattr(_build, "sm_count", lambda index: 132)
    monkeypatch.setattr(_build, "launch", lambda name, dev, *args: calls.append((name, args)))
    return calls


@pytest.mark.parametrize("shape", [(4, 48, 96, 192, 32), (2, 10, 32, 72, 64)], ids=_shape_id)
def test_s2_fwd_wrapper_passes_planned_run(shape, monkeypatch):
    calls = _forced_launch(monkeypatch)
    n, d, h, w, c = shape
    x = torch.zeros(shape, dtype=torch.bfloat16)
    k = torch.zeros((3, 3, 3, c, 64), dtype=torch.bfloat16)
    with torch.no_grad():
        y = conv3d.conv3d_k3s2(x, k)
    assert tuple(y.shape) == (n, d // 2, h // 2, w // 2, 64)
    (name, args), = calls
    assert name == "conv3d_k3s2"
    assert args[-1] == conv3d.s2_fwd_run(n, d // 2, h // 2, w // 2, c, 132)


@pytest.mark.parametrize("shape", [(4, 48, 96, 192, 32), (2, 6, 10, 200, 32),
                                   (1, 10, 6, 36, 64)], ids=_shape_id)
def test_s2_dk_wrapper_allocates_one_partial_per_chunk(shape, monkeypatch):
    """The wrapper passes the planned chunk count, and launch_dk allocates
    exactly that many partials of 27 C 64 floats."""
    calls = _forced_launch(monkeypatch)
    empties = []
    real_empty = torch.empty

    def spy_empty(*a, **kw):
        t = real_empty(*a, **kw)
        empties.append(tuple(t.shape))
        return t

    monkeypatch.setattr(torch, "empty", spy_empty)
    n, d, h, w, c = shape
    x = torch.zeros(shape, dtype=torch.bfloat16)
    g = torch.zeros((n, d // 2, h // 2, w // 2, 64), dtype=torch.bfloat16)
    with torch.no_grad():
        dk = conv3d.conv3d_s2_dk_k3(x, g)
    assert tuple(dk.shape) == (3, 3, 3, c, 64)
    (name, args), = calls
    chunks = conv3d.s2_dk_chunks(conv3d.s2_dk_rows(n, d, h, w), c, 132)
    assert name == "conv3d_dk_k3s2" and args[-1] == chunks
    assert (chunks, 27 * c * 64) in empties


# kernel F at 128 -> 128: GCNet's l31/l32 at 384x768 (batch 1 and 2) and
# at chip_smoke's grad_gcnet_f32 size, then chip_smoke's edges
_F128_SHAPES = [(1, 6, 12, 24, 128), (2, 6, 12, 24, 128), (1, 3, 6, 12, 128),
                (1, 2, 3, 8, 128), (1, 2, 5, 24, 128), (2, 3, 4, 40, 128)]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape", _F128_SHAPES, ids=_shape_id)
def test_dk_k3_128_chunks_cover_every_row_once(shape, sms):
    """Kernel F's bf16 chunks at 128 -> 128 are contiguous, non-empty ranges
    of the cotangent's (n, d, 32-position segment, h) rows that cover each
    row exactly once, and its 24 blocks a chunk (3 kd x 8 Co tiles of 16)
    fill the SMs once where the rows allow."""
    n, d, h, w, c = shape
    rows = conv3d.dk_k3_rows(n, d, h, w, c, c)
    assert rows == n * d * -(-w // 32) * h
    chunks = conv3d.dk_k3_chunks(rows, c, c, sms)
    ranges = _chunk_ranges(rows, chunks)
    assert len(ranges) == chunks and ranges[0][0] == 0 and ranges[-1][1] == rows
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    # as many chunks as put one block on every SM, at most, each of the
    # fewest rows that lets that many chunks cover the rows
    target = max(1, sms // 24)
    assert chunks <= target and -(-rows // chunks) == -(-rows // target)


@pytest.mark.parametrize("shape", [(1, 6, 12, 24, 128), (1, 2, 3, 8, 128)], ids=_shape_id)
def test_dk_k3_128_wrapper_allocates_one_partial_per_chunk(shape, monkeypatch):
    calls = _forced_launch(monkeypatch)
    empties = []
    real_empty = torch.empty

    def spy_empty(*a, **kw):
        t = real_empty(*a, **kw)
        empties.append(tuple(t.shape))
        return t

    monkeypatch.setattr(torch, "empty", spy_empty)
    n, d, h, w, c = shape
    x = torch.zeros(shape, dtype=torch.bfloat16)
    with torch.no_grad():
        dk = conv3d.conv3d_dk_k3(x, x)
    assert tuple(dk.shape) == (3, 3, 3, 128, 128)
    (name, args), = calls
    chunks = conv3d.dk_k3_chunks(conv3d.dk_k3_rows(n, d, h, w, c, c), c, c, 132)
    assert name == "conv3d_dk_k3" and args[-1] == chunks
    assert (chunks, 27 * 128 * 128) in empties
