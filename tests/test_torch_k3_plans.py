"""Launch plans and schedules of kernels F, E and D in bf16.

Kernel F (the stride-1 3x3x3 dK, ``csrc/s1_dk_ring.cuh``), kernel E (the
3x3 2-D dK: F's ring at KD = 1) and kernel D (the k3 s2 transposed conv,
``csrc/deconv3d_k3s2.cu``) walk their rows and slices as
``dsmnet_tpu_torch/ops/conv3d.py`` and ``conv2d.py`` plan them
(``dk_k3_rows``, ``dk_k3_chunks``, ``dk_rows``, ``dk_chunks``,
``deconv_run``).  These tests hold the plans at PSMNet's,
GCNet's and PSMNet-basic's main-path shapes and at ``chip_smoke.py``'s
ragged edge shapes for 132 and 114 SMs, check that the wrappers pass the
planned arguments, and run a float64 emulation of each kernel's schedule
(which rows and slices each block stages through its ring, where its TMA
boxes land, which taps each staged row feeds) against the plain versions
at tiny shapes.  No kernel runs here: the launch is replaced.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dsmnet_tpu_torch import config
from dsmnet_tpu_torch.ops import _build, conv2d, conv3d


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _cdiv(a, b):
    return -(-a // b)


def _shape_id(s):
    return "x".join(map(str, s))


def _ranges(rows, chunks):
    """The rows [lo, hi) of each chunk, as launch_s1_dk cuts them."""
    per = _cdiv(rows, chunks)
    return [(b * per, min(rows, (b + 1) * per)) for b in range(chunks)]


# (x shape (N, D, H, W, C), cotangent channels): PSMNet's train step,
# GCNet's, PSMNet-basic's, then chip_smoke's edges
_F_SHAPES = [((4, 48, 96, 192, 32), 32), ((4, 24, 48, 96, 64), 64), ((4, 12, 24, 48, 64), 64),
             ((1, 96, 192, 384, 64), 32), ((1, 96, 192, 384, 32), 32),
             ((1, 48, 96, 192, 64), 64), ((1, 24, 48, 96, 64), 64), ((1, 12, 24, 48, 64), 64),
             ((1, 6, 12, 24, 128), 128), ((4, 48, 96, 192, 64), 32),
             ((1, 5, 10, 40, 32), 32), ((1, 5, 10, 40, 32), 64), ((1, 5, 9, 20, 64), 32),
             ((1, 5, 9, 20, 64), 64), ((1, 4, 30, 100, 32), 32), ((1, 1, 7, 50, 64), 32),
             ((2, 2, 9, 100, 64), 64), ((1, 3, 11, 70, 32), 64), ((1, 2, 3, 8, 128), 128),
             ((1, 2, 5, 24, 128), 128), ((2, 3, 4, 40, 128), 128)]
_F_IDS = [f"{_shape_id(s)}to{co}" for s, co in _F_SHAPES]

# x shapes (N, D, H, W, 64): PSMNet's conv6 / conv1 dx at batch 4 and 1,
# GCNet's l36, then chip_smoke's edges
_D_SHAPES = [(4, 24, 48, 96, 64), (1, 24, 48, 96, 64), (1, 48, 96, 192, 64), (1, 3, 5, 20, 64),
             (1, 1, 5, 20, 64), (1, 2, 6, 40, 64), (2, 11, 32, 96, 64)]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape,co", _F_SHAPES, ids=_F_IDS)
def test_dk_k3_chunks_cover_every_row_once(shape, co, sms):
    """Kernel F's chunks are contiguous, non-empty ranges of its rows (n, od,
    segment, oh), oh fastest, that cover every cotangent position exactly
    once; at most one chunk per 3 kd x Co-tile blocks that run at once."""
    n, d, h, w, c = shape
    seg, cob, per_sm = conv3d.DK_K3_TILES[c, co]
    rows = conv3d.dk_k3_rows(n, d, h, w, c, co)
    chunks = conv3d.dk_k3_chunks(rows, c, co, sms)
    assert 1 <= chunks <= max(1, sms * per_sm // (3 * (co // cob)))
    ranges = _ranges(rows, chunks)
    assert ranges[0][0] == 0 and ranges[-1][1] == rows
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    # the rows' (n d, segment, oh) and their columns cover (n, d, h, w) once
    nseg = _cdiv(w, seg)
    line, oh = np.divmod(np.arange(rows), h)
    nd, s = np.divmod(line, nseg)
    seen = np.zeros((n * d, h, nseg * seg), np.uint8)
    for j in range(seg):
        np.add.at(seen, (nd, oh, s * seg + j), 1)
    assert (seen[..., :w] == 1).all()


def _forced_launch(monkeypatch):
    """Route the wrappers to their launch on CPU tensors and record it and
    the shapes that torch.empty allocates."""
    calls, empties = [], []
    real_empty = torch.empty

    def spy_empty(*a, **kw):
        t = real_empty(*a, **kw)
        empties.append(tuple(t.shape))
        return t

    monkeypatch.setattr(config, "launches_kernel", lambda op, x: True)
    monkeypatch.setattr(_build, "require_cuda", lambda name, *t: None)
    monkeypatch.setattr(_build, "sm_count", lambda index: 132)
    monkeypatch.setattr(_build, "launch", lambda name, dev, *args: calls.append((name, args)))
    monkeypatch.setattr(torch, "empty", spy_empty)
    return calls, empties


_F_WRAP = [((4, 48, 96, 192, 32), 32), ((1, 5, 9, 20, 64), 64), ((1, 3, 11, 70, 32), 64)]


@pytest.mark.parametrize("shape,co", _F_WRAP, ids=[f"{_shape_id(s)}to{co}" for s, co in _F_WRAP])
def test_dk_k3_wrapper_allocates_one_partial_per_chunk(shape, co, monkeypatch):
    """In bf16 the wrapper passes the planned chunk count and launch_dk
    allocates that many partials of 27 C Co floats; in float32 (the
    dk_k3.cuh tiles) one per row, at most DK_CHUNKS."""
    calls, empties = _forced_launch(monkeypatch)
    n, d, h, w, c = shape
    with torch.no_grad():
        for dt in (torch.bfloat16, torch.float32):
            x = torch.zeros(shape, dtype=dt)
            g = torch.zeros((n, d, h, w, co), dtype=dt)
            assert tuple(conv3d.conv3d_dk_k3(x, g).shape) == (3, 3, 3, c, co)
    (n16, a16), (n32, a32) = calls
    chunks = conv3d.dk_k3_chunks(conv3d.dk_k3_rows(n, d, h, w, c, co), c, co, 132)
    assert n16 == n32 == "conv3d_dk_k3"
    assert a16[4] == _build.DTYPE_CODES[torch.bfloat16] and a16[5:] == (n, d, h, w, c, co, chunks)
    assert a32[5:] == (n, d, h, w, c, co, min(_build.DK_CHUNKS, n * d * h))
    assert (chunks, 27 * c * co) in empties
    assert (min(_build.DK_CHUNKS, n * d * h), 27 * c * co) in empties


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape", _D_SHAPES, ids=_shape_id)
def test_deconv_blocks_cover_every_output_once(shape, sms):
    """Kernel D's grid (w tiles, h tiles, N x runs), each block a run
    [u0, u1) of input slices writing output slices 2 u0 .. 2 u1 - 1 through
    TMA stores of its 8 x 64 tile, writes each output voxel exactly once,
    and stages slices u0 .. min(u1, D - 1)."""
    n, d, h, w, c = shape
    run = conv3d.deconv_run(n, d, h, w, sms)
    assert 1 <= run <= d
    runs = conv3d.deconv_runs(d, run)
    assert runs[0][0] == 0 and runs[-1][1] == d
    assert all(a < b and b == nxt for (a, b), (nxt, _) in zip(runs, runs[1:] + [(d, 0)]))
    rh, tm = conv3d.DECONV_TILE
    seen = np.zeros((n, 2 * d, 2 * h, 2 * w), np.uint8)
    staged = 0
    for bz in range(n * len(runs)):
        u0, u1 = runs[bz % len(runs)]
        staged += min(u1 + 1, d) - u0
        for by in range(_cdiv(h, rh)):
            for bx in range(_cdiv(w, tm)):
                # the TMA store clips the tile at the volume's edge
                seen[bz // len(runs), 2 * u0:2 * u1, 2 * rh * by:2 * rh * (by + 1),
                     2 * tm * bx:2 * tm * (bx + 1)] += 1
    assert (seen == 1).all()
    assert staged == n * sum(min(u1 + 1, d) - u0 for u0, u1 in runs)


def test_deconv_edges_reach_a_ragged_run():
    """chip_smoke's D edge (2, 11, 32, 96, 64) ends in a ragged run at 132
    SMs (runs of 6: slices 0..5 and 6..10), and D = 1 has one run."""
    assert conv3d.deconv_runs(11, conv3d.deconv_run(2, 11, 32, 96, 132)) == [(0, 6), (6, 11)]
    assert conv3d.deconv_run(1, 1, 5, 20, 132) == 1


def test_deconv_wrapper_passes_planned_run(monkeypatch):
    calls, _ = _forced_launch(monkeypatch)
    shape = (4, 24, 48, 96, 64)
    x = torch.zeros(shape, dtype=torch.bfloat16)
    k = torch.zeros((3, 3, 3, 32, 64), dtype=torch.bfloat16)
    with torch.no_grad():
        y = conv3d.deconv3d_k3s2_kernel(x, k)
    assert tuple(y.shape) == (4, 48, 96, 192, 32)
    (name, args), = calls
    assert name == "deconv3d_k3s2" and args[4:] == (*shape, 32, conv3d.deconv_run(*shape[:4], 132))


# ------------------------------------------------------- schedule emulations

_NS_F = 5  # kernel F's ring slots (s1_dk_ring.cuh S1Dk::NS)


def _x_row(x, nd, d_dim, hh, w0, tw):
    """x row hh of slice nd's d as TMA boxes deliver it: columns w0 - 1 ..
    w0 + tw, zero outside the volume."""
    n_, d = divmod(nd, d_dim)
    out = torch.zeros((tw + 2, x.shape[-1]), dtype=x.dtype)
    if 0 <= hh < x.shape[2]:
        lo, hi = max(0, w0 - 1), min(x.shape[3], w0 + tw + 1)
        out[lo - (w0 - 1):hi - (w0 - 1)] = x[n_, d, hh, lo:hi]
    return out


def _emulate_f(x, g, sms, kds=(0, 1, 2)):
    """Kernel F's bf16 schedule in float64: per chunk and per (kd, Co tile)
    block, the ring of NS slots (x rows oh and oh + 1, the g segment) and
    the halo row as the producer fills them, each warp's tap reading the
    buffer the consumer picks, and the partials summed in chunk order.
    ``kds=(1,)``: kernel E, the 2-D conv's x and g viewed as (N, 1, H, W,
    C), only the centre kd's blocks, planned by conv2d.dk_rows / dk_chunks."""
    n, d, h, w, c = x.shape
    co = g.shape[-1]
    if kds == (1,):
        assert d == 1
        tw, cob, _ = conv2d.DK_TILE
        rows = conv2d.dk_rows(n, h, w)
        chunks = conv2d.dk_chunks(rows, sms)
    else:
        tw, cob, _ = conv3d.DK_K3_TILES[c, co]
        rows = conv3d.dk_k3_rows(n, d, h, w, c, co)
        chunks = conv3d.dk_k3_chunks(rows, c, co, sms)
    nseg = _cdiv(w, tw)
    lead = _NS_F - 2
    gp = torch.zeros((n, d, h, nseg * tw, co), dtype=g.dtype)
    gp[:, :, :, :w] = g
    partials = []
    for lo, hi in _ranges(rows, chunks):
        part = torch.zeros((3, 3, 3, c, co), dtype=torch.float64)
        for kd in kds:
            for o0 in range(0, co, cob):
                ring = [None] * _NS_F
                halo = None

                def issue(it):
                    nonlocal halo
                    line, oh = divmod(it, h)
                    nd, s = divmod(line, nseg)
                    dd = nd % d + kd - 1
                    slot = {"row": (nd, dd, oh)}
                    if 0 <= dd < d:
                        xd = nd // d * d + dd
                        first = it == lo
                        slot["x1"] = (dd, oh + 1, _x_row(x, xd, d, oh + 1, s * tw, tw))
                        if first or oh == 0:
                            slot["x0"] = (dd, oh, _x_row(x, xd, d, oh, s * tw, tw))
                        if first and oh > 0:
                            halo = (dd, oh - 1, _x_row(x, xd, d, oh - 1, s * tw, tw))
                        slot["g"] = gp[nd // d, nd % d, oh, s * tw:(s + 1) * tw, o0:o0 + cob]
                    ring[(it - lo) % _NS_F] = slot

                for it in range(lo, min(hi, lo + lead)):
                    issue(it)
                for it in range(lo, hi):
                    k = it - lo
                    cur, prev, prev2 = (ring[(k - j) % _NS_F] for j in range(3))
                    nd, dd, oh = cur["row"]
                    for kh in range(3):
                        if not 0 <= dd < d or (kh == 0 and oh == 0):
                            continue
                        if kh == 2:
                            buf = cur["x1"]
                        elif kh == 1:
                            buf = cur["x0"] if (k == 0 or oh == 0) else prev["x1"]
                        else:
                            buf = halo if k == 0 else prev["x0"] if (k == 1 or oh == 1) \
                                else prev2["x1"]
                        # the buffer holds the row this tap reads
                        assert buf[:2] == (dd, oh - 1 + kh)
                        for kw in range(3):
                            part[kd, kh, kw, :, o0:o0 + cob] += buf[2][kw:kw + tw].T @ cur["g"]
                    if it + lead < hi:
                        issue(it + lead)
        partials.append(part)
    dk = torch.zeros_like(partials[0])
    for p in partials:  # dk_reduce: chunk order
        dk += p
    return dk


# tiny shapes: one segment and several, chunks that start inside an oh walk
# (few SMs), D = 1 and 2, odd H, a ragged last segment, every width pair
_F_EMU = [((1, 3, 5, 40, 32), 32, 132), ((1, 3, 5, 40, 32), 32, 4), ((1, 1, 7, 20, 64), 32, 5),
          ((2, 2, 3, 100, 64), 64, 3), ((1, 2, 4, 70, 32), 64, 6), ((1, 2, 3, 40, 128), 128, 48),
          ((1, 3, 5, 100, 32), 32, 9)]


@pytest.mark.parametrize("shape,co,sms", _F_EMU, ids=[f"{_shape_id(s)}to{co}_sms{m}"
                                                      for s, co, m in _F_EMU])
def test_dk_k3_schedule_emulation_matches_plain_f64(shape, co, sms):
    rng = np.random.default_rng(sum(shape) + co + sms)
    x = torch.from_numpy(rng.standard_normal(shape))
    g = torch.from_numpy(rng.standard_normal((*shape[:4], co)))
    np.testing.assert_allclose(_emulate_f(x, g, sms).numpy(),
                               conv3d.conv3d_dk_plain(x, g).numpy(), rtol=1e-12, atol=1e-12)


def _emulate_d(x, k, sms):
    """Kernel D's bf16 schedule in float64: per block (w tile, h tile, n,
    run) the ring of staged input boxes (RH + 1 rows, TM + 1 columns, zero
    past the edge), output slice 2u from slice u through kd = 1, 2u + 1
    from slice u through kd = 2 and slice u + 1 through kd = 0, each tap
    reading the box shifted by (kh == 0, kw == 0) into the output parity
    (kh != 1, kw != 1), each finished slice stored once (clipped)."""
    n, d, h, w, c = x.shape
    rh, tm = conv3d.DECONV_TILE
    runs = conv3d.deconv_runs(d, conv3d.deconv_run(n, d, h, w, sms))
    y = torch.full((n, 2 * d, 2 * h, 2 * w, 32), float("nan"), dtype=torch.float64)
    xp = torch.zeros((n, d, _cdiv(h, rh) * rh + 1, _cdiv(w, tm) * tm + 1, c), dtype=x.dtype)
    xp[:, :, :h, :w] = x

    def taps(box, kd, tile):
        for kh in range(3):
            for kw in range(3):
                sh, sw = int(kh == 0), int(kw == 0)
                a = box[sh:sh + rh, sw:sw + tm]  # (rh, tm, 64)
                ph, pw = int(kh != 1), int(kw != 1)
                tile[ph::2, pw::2] += a @ k[kd, kh, kw].T

    for bz in range(n * len(runs)):
        nn, (u0, u1) = bz // len(runs), runs[bz % len(runs)]
        for by in range(_cdiv(h, rh)):
            for bx in range(_cdiv(w, tm)):
                h0, w0 = by * rh, bx * tm
                staged = {u: xp[nn, u, h0:h0 + rh + 1, w0:w0 + tm + 1]
                          for u in range(u0, min(u1 + 1, d))}
                for u in range(u0, u1):
                    for od, parts in ((2 * u, [(u, 1)]), (2 * u + 1, [(u, 2), (u + 1, 0)])):
                        tile = torch.zeros((2 * rh, 2 * tm, 32), dtype=torch.float64)
                        for uu, kd in parts:
                            if uu < d:
                                taps(staged[uu], kd, tile)
                        dst = y[nn, od, 2 * h0:2 * h0 + 2 * rh, 2 * w0:2 * w0 + 2 * tm]
                        assert torch.isnan(dst).all()  # no output is written twice
                        dst.copy_(tile[:dst.shape[0], :dst.shape[1]])
    return y


# tiny shapes: runs of one slice, D = 1, runs that end ragged, one run of D = 7
_D_EMU = [((1, 2, 5, 20, 64), 132, [(0, 1), (1, 2)]), ((1, 1, 3, 40, 64), 132, [(0, 1)]),
          ((2, 5, 6, 36, 64), 16, [(0, 3), (3, 5)]), ((1, 7, 9, 70, 64), 6, [(0, 4), (4, 7)]),
          ((1, 7, 9, 70, 64), 3, [(0, 7)])]


@pytest.mark.parametrize("shape,sms,runs", _D_EMU,
                         ids=[f"{_shape_id(s)}_sms{m}" for s, m, _ in _D_EMU])
def test_deconv_schedule_emulation_matches_plain_f64(shape, sms, runs):
    rng = np.random.default_rng(sum(shape) + sms)
    x = torch.from_numpy(rng.standard_normal(shape))
    k = torch.from_numpy(rng.standard_normal((3, 3, 3, 32, 64)))
    assert conv3d.deconv_runs(shape[1], conv3d.deconv_run(*shape[:4], sms)) == runs
    y = _emulate_d(x, k, sms)
    np.testing.assert_allclose(y.numpy(), conv3d.deconv3d_k3s2_plain(x, k).numpy(),
                               rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------ kernel E

# x shapes (N, H, W, 32): PSMNet's, GCNet's and PSMNet-basic's train steps,
# then chip_smoke's edges
_E_SHAPES = [(8, 192, 384, 32), (2, 192, 384, 32), (4, 192, 384, 32), (1, 10, 40, 32),
             (2, 9, 100, 32), (1, 7, 200, 32), (2, 45, 200, 32)]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape", _E_SHAPES, ids=_shape_id)
def test_dk2_chunks_cover_every_row_once(shape, sms):
    """Kernel E's chunks are contiguous, non-empty ranges of its rows (n,
    segment, oh), oh fastest, that cover every cotangent position exactly
    once; at most one chunk per block that runs at once (one block of all
    nine taps per chunk)."""
    n, h, w, c = shape
    seg, cob, per_sm = conv2d.DK_TILE
    rows = conv2d.dk_rows(n, h, w)
    chunks = conv2d.dk_chunks(rows, sms)
    assert 1 <= chunks <= sms * per_sm
    ranges = _ranges(rows, chunks)
    assert ranges[0][0] == 0 and ranges[-1][1] == rows
    assert all(lo < hi for lo, hi in ranges)
    nseg = _cdiv(w, seg)
    line, oh = np.divmod(np.arange(rows), h)
    nn, s = np.divmod(line, nseg)
    seen = np.zeros((n, h, nseg * seg), np.uint8)
    for j in range(seg):
        np.add.at(seen, (nn, oh, s * seg + j), 1)
    assert (seen[..., :w] == 1).all()


def test_dk2_wrapper_allocates_one_partial_per_chunk(monkeypatch):
    """In bf16 kernel E's wrapper passes the planned chunk count and
    launch_dk allocates that many partials of 9 x 32 x 32 floats; in
    float32 (the dk_k3.cuh tiles) one per row, at most DK_CHUNKS."""
    calls, empties = _forced_launch(monkeypatch)
    n, h, w, c = shape = (8, 192, 384, 32)
    with torch.no_grad():
        for dt in (torch.bfloat16, torch.float32):
            x = torch.zeros(shape, dtype=dt)
            assert tuple(conv2d.conv2d_dk_k3(x, x).shape) == (3, 3, 32, 32)
    (n16, a16), (n32, a32) = calls
    chunks = conv2d.dk_chunks(conv2d.dk_rows(n, h, w), 132)
    assert n16 == n32 == "conv2d_dk_k3" and chunks == 256
    assert a16[4] == _build.DTYPE_CODES[torch.bfloat16] and a16[5:] == (n, 1, h, w, c, 32, chunks)
    assert a32[5:] == (n, 1, h, w, c, 32, min(_build.DK_CHUNKS, n * h))
    assert (chunks, 9 * c * 32) in empties


# tiny shapes: one segment and several with a ragged last one, chunks that
# start inside an oh walk (few SMs), odd H, batch 2
_E_EMU = [((1, 5, 40, 32), 132), ((2, 7, 100, 32), 5), ((1, 9, 200, 32), 4),
          ((2, 3, 96, 32), 132)]


@pytest.mark.parametrize("shape,sms", _E_EMU, ids=[f"{_shape_id(s)}_sms{m}" for s, m in _E_EMU])
def test_dk2_schedule_emulation_matches_plain_f64(shape, sms):
    rng = np.random.default_rng(sum(shape) + sms)
    x = torch.from_numpy(rng.standard_normal(shape))
    g = torch.from_numpy(rng.standard_normal(shape))
    dk = _emulate_f(x[:, None], g[:, None], sms, kds=(1,))
    assert not dk[0].any() and not dk[2].any()
    np.testing.assert_allclose(dk[1].numpy(), conv2d.conv2d_dk_plain(x, g).numpy(),
                               rtol=1e-12, atol=1e-12)
