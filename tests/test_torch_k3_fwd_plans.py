"""Launch plans and schedule of kernel B (the stride-1 3x3x3 conv) in bf16.

Kernel B (``csrc/s1_fwd_ring.cuh``) walks D as
``dsmnet_tpu_torch/ops/conv3d.py`` plans it: contiguous ranges of work
items (n, h tile, w tile, output slice d), d fastest (``k3_items``,
``k3_run``, ``k3_runs``); at 128 -> 128 it splits kd and the Co tiles over
blocks and adds three partials (``k3_split_partials``).  These tests hold
the plans at PSMNet's, GCNet's and PSMNet-basic's main-path shapes and at
``chip_smoke.py``'s edge shapes for 132 and 114 SMs, check that the
wrapper passes the planned arguments, and run a float64 emulation of the
schedule against ``conv3d_plain`` at tiny shapes: which input slice sits
in which ring slot, where each TMA box lands in the swizzled slot, the byte
address each lane's shifted ldmatrix row starts at, which kd taps each
slice feeds, and when each output slice is stored.  No kernel runs here:
the launch is replaced.
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


def _cdiv(a, b):
    return -(-a // b)


def _shape_id(s):
    return "x".join(map(str, s))


# (x shape (N, D, H, W, C), Co): PSMNet's serving and train step, GCNet's
# (l19, l20, the dx of l19, l22 .. l29), PSMNet-basic's, then chip_smoke's
# edges
_B_SHAPES = [((1, 48, 96, 192, 32), 32), ((4, 48, 96, 192, 32), 32),
             ((1, 24, 48, 96, 64), 64), ((4, 24, 48, 96, 64), 64),
             ((1, 12, 24, 48, 64), 64), ((4, 12, 24, 48, 64), 64),
             ((1, 96, 192, 384, 64), 32), ((1, 96, 192, 384, 32), 32),
             ((1, 96, 192, 384, 32), 64), ((1, 48, 96, 192, 64), 64),
             ((1, 48, 96, 192, 64), 32), ((4, 48, 96, 192, 64), 32), ((4, 48, 96, 192, 32), 64),
             ((1, 5, 10, 40, 32), 32), ((1, 5, 10, 40, 32), 64), ((1, 5, 9, 20, 64), 32),
             ((1, 5, 9, 20, 64), 64), ((1, 1, 7, 20, 32), 32), ((2, 2, 9, 40, 32), 32),
             ((1, 19, 17, 72, 32), 32), ((1, 1, 7, 20, 32), 64), ((2, 2, 9, 40, 32), 64),
             ((1, 11, 17, 72, 32), 64), ((1, 1, 7, 20, 64), 32), ((2, 2, 9, 40, 64), 32),
             ((1, 11, 17, 72, 64), 32), ((1, 1, 7, 20, 64), 64), ((2, 2, 9, 40, 64), 64),
             ((1, 23, 17, 40, 64), 64)]
_B_IDS = [f"{_shape_id(s)}to{co}" for s, co in _B_SHAPES]
# 128 -> 128 (the split): GCNet's l31/l32, then the edges
_SPLIT_SHAPES = [(1, 6, 12, 24, 128), (1, 3, 5, 20, 128), (1, 3, 12, 24, 128),
                 (2, 2, 9, 40, 128)]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape,co", _B_SHAPES, ids=_B_IDS)
def test_k3_ranges_cover_every_item_once(shape, co, sms):
    """Kernel B's blocks take contiguous, non-empty ranges of ``per`` work
    items that cover every (n, tile, output slice) of each Co tile exactly
    once, in one wave of the SMs; each range is cut into runs of one tile's
    consecutive output slices, and a run stages its input slices max(d0 -
    1, 0) .. min(d1, D - 1) once."""
    n, d, h, w, c = shape
    rh, tm = conv3d.K3_TILE
    ncob = co // conv3d.K3_COB[c, co]
    items = conv3d.k3_items(n, d, h, w)
    assert items == n * _cdiv(h, rh) * _cdiv(w, tm) * d
    per = conv3d.k3_run(items, c, co, sms)
    blocks = conv3d.k3_runs(items, d, per)
    assert len(blocks) == _cdiv(items, per)
    assert ncob * len(blocks) <= sms * conv3d.K3_BLOCKS_PER_SM[c, co]
    seen = np.zeros(items, np.uint8)
    for b, runs in enumerate(blocks):
        assert runs and sum(d1 - d0 for _, d0, d1 in runs) == min(per, items - b * per)
        for tile, d0, d1 in runs:
            assert 0 <= d0 < d1 <= d
            seen[tile * d + d0:tile * d + d1] += 1
        # consecutive runs of a range: the next tile, from its first slice
        for (t0, _, e0), (t1, s1, _) in zip(runs, runs[1:]):
            assert t1 == t0 + 1 and e0 == d and s1 == 0
    assert (seen == 1).all()


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape", _SPLIT_SHAPES, ids=_shape_id)
def test_k3_split_fills_the_card_at_gcnet_shape(shape, sms):
    """At 128 -> 128 the split launches 3 kd x 2 Co tiles per (tile, n, d):
    at GCNet's l31/l32 (1, 6, 12, 24) that is 144 blocks, more than the
    SMs; its partials are one f32 output per kd."""
    n, d, h, w, c = shape
    rh, tm = conv3d.K3_TILE
    blocks = 3 * (128 // conv3d.K3_COB[128, 128]) * _cdiv(h, rh) * _cdiv(w, tm) * n * d
    if shape == (1, 6, 12, 24, 128):
        assert blocks == 144 and blocks >= sms
    assert conv3d.k3_split_partials(n, d, h, w) == 3 * n * d * h * w * 128


def _forced_launch(monkeypatch):
    """Route the wrapper to its launch on CPU tensors and record it and the
    shapes that torch.empty allocates."""
    calls, empties = [], []
    real_empty = torch.empty

    def spy_empty(*a, **kw):
        t = real_empty(*a, **kw)
        empties.append((tuple(t.shape), t.dtype))
        return t

    monkeypatch.setattr(config, "launches_kernel", lambda op, x: True)
    monkeypatch.setattr(_build, "require_cuda", lambda name, *t: None)
    monkeypatch.setattr(_build, "sm_count", lambda index: 132)
    monkeypatch.setattr(_build, "launch", lambda name, dev, *args: calls.append((name, args)))
    monkeypatch.setattr(torch, "empty", spy_empty)
    return calls, empties


_WRAP = [((4, 48, 96, 192, 32), 32), ((1, 23, 17, 40, 64), 64), ((1, 3, 5, 20, 128), 128)]


@pytest.mark.parametrize("shape,co", _WRAP, ids=[f"{_shape_id(s)}to{co}" for s, co in _WRAP])
def test_k3_wrapper_passes_planned_arguments(shape, co, monkeypatch):
    """In bf16 the wrapper passes the planned items per block (no
    workspace), at 128 -> 128 a workspace of the three kd partials (and no
    run); in float32 (the conv_k3.cuh tiles) neither."""
    calls, empties = _forced_launch(monkeypatch)
    n, d, h, w, c = shape
    with torch.no_grad():
        for dt in (torch.bfloat16, torch.float32):
            x = torch.zeros(shape, dtype=dt)
            k = torch.zeros((3, 3, 3, c, co), dtype=dt)
            assert tuple(conv3d.conv3d_k3(x, k).shape) == (n, d, h, w, co)
    (n16, a16), (n32, a32) = calls
    assert n16 == n32 == "conv3d_k3"
    assert a16[4:] == (_build.DTYPE_CODES[torch.bfloat16], n, d, h, w, c, co,
                       0 if c == 128 else conv3d.k3_run(conv3d.k3_items(n, d, h, w), c, co, 132))
    assert a32[3] == 0 and a32[4:] == (_build.DTYPE_CODES[torch.float32], n, d, h, w, c, co, 0)
    split = ((conv3d.k3_split_partials(n, d, h, w),), torch.float32)
    assert (split in empties) == (c == 128) and (a16[3] != 0) == (c == 128)


# ------------------------------------------------------- schedule emulation

_NS = 4  # kernel B's ring slots (s1_fwd_ring.cuh S1Fwd::NS)


class _Cfg:
    """S1Fwd's constants for (C, Co)."""

    def __init__(self, c, co):
        self.rh, self.tm = conv3d.K3_TILE
        self.c, self.co, self.cob = c, co, conv3d.K3_COB[c, co]
        self.kc = min(c, 64)
        self.xp = c // self.kc
        self.lb = self.kc * 2
        self.rows, self.cols = self.rh + 2, self.tm + 2
        self.pitch = _cdiv(self.rows * self.cols * self.lb, 1024) * 1024
        self.ks = self.kc // 16


def _swz_chunk(line, q, lb):
    """swz_chunk<LB>: the address of 16-byte chunk q of the lb-byte line at
    `line`, under the TMA's 64- or 128-byte swizzle."""
    return line + ((q ^ ((line >> 7) & (lb // 16 - 1))) << 4)


def _stage(cfg, x, n, di, h0, w0):
    """The slot as the TMA fills it: per plane p, the box (rows h0 - 1 ..,
    columns w0 - 1 .., channels p KC ..), zero outside the volume, element
    (r, j, c) at chunk _swz_chunk(p pitch + (r cols + j) lb, c // 8) / 16,
    lane c % 8.  Returns the slot as (chunks, 8)."""
    _, d, h, w, c = x.shape
    box = torch.zeros((cfg.rows, cfg.cols, c), dtype=x.dtype)
    if 0 <= di < d:
        hs, ws = slice(max(h0 - 1, 0), min(h, h0 - 1 + cfg.rows)), \
            slice(max(w0 - 1, 0), min(w, w0 - 1 + cfg.cols))
        box[hs.start - (h0 - 1):hs.stop - (h0 - 1), ws.start - (w0 - 1):ws.stop - (w0 - 1)] = \
            x[n, di, hs, ws]
    slot = torch.full((cfg.xp * cfg.pitch // 16, 8), float("nan"), dtype=x.dtype)
    r, j, q = np.meshgrid(np.arange(cfg.rows), np.arange(cfg.cols), np.arange(c // 8),
                          indexing="ij")
    p, qq = divmod(q, cfg.kc // 8)
    addr = _swz_chunk(p * cfg.pitch + (r * cfg.cols + j) * cfg.lb, qq, cfg.lb)
    slot[torch.from_numpy(addr.ravel() // 16)] = box.reshape(-1, 8)
    return slot


def _w_smem(cfg, k, r0, rows, co0):
    """The resident kernel rows r0 .. r0 + rows - 1 of the (27 C, Co)
    kernel, columns co0 .., as the TMA places them (a box of the (Co, C, 9,
    3) view per kd, COB * 2-byte rows swizzled in their width): row r's
    chunk q at r COB / 8 + (q ^ w_swz(r)), w_swz = r & 7 (Co tile 64) or
    (r >> 1) & 3 (32), the same bits as _swz_chunk's."""
    kf = k.reshape(27 * cfg.c, cfg.co)[r0:r0 + rows, co0:co0 + cfg.cob]
    nq = cfg.cob // 8
    r, q = np.meshgrid(np.arange(rows), np.arange(nq), indexing="ij")
    swz = (r & 7) if cfg.cob == 64 else ((r >> 1) & 3)
    smem = torch.full((rows * nq, 8), float("nan"), dtype=k.dtype)
    smem[torch.from_numpy((r * nq + (q ^ swz)).ravel())] = kf.reshape(-1, 8)
    return smem


def _w_rows(cfg, smem, row0):
    """The 16 x COB B operand that wgmma's descriptor reads from resident
    row row0 on (the inverse of the placement)."""
    nq = cfg.cob // 8
    r, q = np.meshgrid(np.arange(row0, row0 + 16), np.arange(nq), indexing="ij")
    swz = (r & 7) if cfg.cob == 64 else ((r >> 1) & 3)
    return smem[torch.from_numpy(r * nq + (q ^ swz))].reshape(16, cfg.cob)


def _slice_taps(cfg, slot, smem, wk, accs, mask):
    """s1_fwd_slice: for each (plane, tap) unit, each warp's A fragment from
    the slot at the lanes' ldmatrix addresses (position (warp, lane & 15)
    shifted by (kh, kw), chunk 2 ks + (lane >> 4)), times the kernel rows
    at wk[kd] + (t C + p KC + 16 ks), into accs[kd] for each kd in mask."""
    warp, lane = np.meshgrid(np.arange(8), np.arange(32), indexing="ij")
    a_line = (warp * cfg.cols + (lane & 15)) * cfg.lb
    for u in range(cfg.xp * 9):
        p, t = divmod(u, 9)
        kh, kw = divmod(t, 3)
        line = a_line + p * cfg.pitch + (kh * cfg.cols + kw) * cfg.lb
        a = torch.empty((8, 16, cfg.kc), dtype=slot.dtype)  # (warp, position, k)
        for ks in range(cfg.ks):
            addr = _swz_chunk(line, 2 * ks + (lane >> 4), cfg.lb) // 16
            chunks = slot[torch.from_numpy(addr)]          # (8 warps, 32 lanes, 8)
            a[:, :, ks * 16:ks * 16 + 8] = chunks[:, :16]
            a[:, :, ks * 16 + 8:ks * 16 + 16] = chunks[:, 16:]
        assert not torch.isnan(a).any()  # every read lands inside the box
        for kd in range(3):
            if mask >> kd & 1:
                b = torch.cat([_w_rows(cfg, smem, wk[kd] + t * cfg.c + p * cfg.kc + 16 * ks)
                               for ks in range(cfg.ks)])
                accs[kd].add_(a @ b)


def _store(cfg, y, acc, n, d, h0, w0, co0, staged=True):
    """The walk's s1_fwd_stage_out and TMA store: each lane writes its
    accumulator pairs (warp w, columns g and g + 8, channels 8 ni + 2 tq)
    into the staging tile at swz_chunk(line (w TM + j), ni) + 4 tq, and
    the TMA store reads the tile as its (COB, TM, RH) box, clipped at the
    volume's edge.  (The split writes its f32 partial straight from the
    registers: staged=False.)  No output is written twice."""
    _, _, h, w, _ = y.shape
    if staged:
        lbo = cfg.cob * 2
        tile = torch.full((cfg.rh * cfg.tm * cfg.cob,), float("nan"), dtype=acc.dtype)
        warp, g, tq, ni = np.meshgrid(np.arange(cfg.rh), np.arange(8), np.arange(4),
                                      np.arange(cfg.cob // 8), indexing="ij")
        for half in (0, 1):
            addr = _swz_chunk((warp * cfg.tm + g + 8 * half) * lbo, ni, lbo) + 4 * tq
            for e in (0, 1):  # the bf16 pair of one 4-byte store
                tile[torch.from_numpy((addr // 2 + e).ravel())] = acc[
                    warp.ravel(), (g + 8 * half).ravel(), (8 * ni + 2 * tq + e).ravel()]
        # the TMA box: line r TM + j, chunk q of channels 8 q .. 8 q + 7
        r, j, q, e = np.meshgrid(np.arange(cfg.rh), np.arange(cfg.tm), np.arange(cfg.cob // 8),
                                 np.arange(8), indexing="ij")
        addr = _swz_chunk((r * cfg.tm + j) * lbo, q, lbo) // 2 + e
        acc = tile[torch.from_numpy(addr)].reshape(cfg.rh, cfg.tm, cfg.cob)
        assert not torch.isnan(acc).any()  # every staged element was written
    hh, ww = min(h, h0 + cfg.rh) - h0, min(w, w0 + cfg.tm) - w0
    dst = y[n, d, h0:h0 + hh, w0:w0 + ww, co0:co0 + cfg.cob]
    assert torch.isnan(dst).all()
    dst.copy_(acc[:hh, :ww])


def _emulate_walk(x, k, sms):
    """s1_fwd_kernel in float64: per Co tile and block, the producer fills
    the four-slot ring with the k-th staged slice of the block's runs (its
    `locate`), the consumer walks the runs, checks that the slot holds the
    slice it expects, feeds it to the kd taps of the mask, stores output di
    - 1 after slice di (and output D - 1 at a run's end at D) and rotates
    the three accumulator sets."""
    n, d, h, w, c = x.shape
    co = k.shape[-1]
    cfg = _Cfg(c, co)
    ntw, nth = _cdiv(w, cfg.tm), _cdiv(h, cfg.rh)
    items = conv3d.k3_items(n, d, h, w)
    per = conv3d.k3_run(items, c, co, sms)
    y = torch.full((n, d, h, w, co), float("nan"), dtype=torch.float64)
    zeros = lambda: torch.zeros((cfg.rh, cfg.tm, cfg.cob), dtype=torch.float64)
    for cob in range(co // cfg.cob):
        smem = _w_smem(cfg, k, 0, 27 * c, cob * cfg.cob)
        wk = (0, 9 * c, 18 * c)
        for runs in conv3d.k3_runs(items, d, per):
            staged = [(tile, di) for tile, d0, d1 in runs
                      for di in range(max(d0 - 1, 0), min(d1, d - 1) + 1)]
            ring = [None] * _NS

            def issue(kk):
                if kk < len(staged):
                    tile, di = staged[kk]
                    tw, th, nn = tile % ntw, tile // ntw % nth, tile // (ntw * nth)
                    ring[kk % _NS] = ((tile, di), _stage(cfg, x, nn, di, th * cfg.rh,
                                                         tw * cfg.tm))

            for kk in range(_NS):
                issue(kk)
            kk = 0
            for tile, d0, d1 in runs:
                tw, th, nn = tile % ntw, tile // ntw % nth, tile // (ntw * nth)
                h0, w0 = th * cfg.rh, tw * cfg.tm
                a0, a1, a2 = zeros(), zeros(), zeros()
                for di in range(max(d0 - 1, 0), min(d1, d - 1) + 1):
                    tag, slot = ring[kk % _NS]
                    assert tag == (tile, di)
                    mask = (int(d0 <= di + 1 < d1) | int(d0 <= di < d1) << 1
                            | int(d0 <= di - 1 < d1) << 2)
                    assert mask in (1, 2, 3, 4, 6, 7)
                    _slice_taps(cfg, slot, smem, wk, (a0, a1, a2), mask)
                    if mask & 4:
                        _store(cfg, y, a2, nn, di - 1, h0, w0, cob * cfg.cob)
                    a2, a1, a0 = a1, a0, zeros()
                    issue(kk + _NS)
                    kk += 1
                if d1 == d:
                    _store(cfg, y, a2, nn, d - 1, h0, w0, cob * cfg.cob)
            assert kk == len(staged)
    return y


def _emulate_split(x, k):
    """s1_fwd_split_kernel and s1_fwd_reduce in float64: per (kd, Co tile,
    tile, n, d) block, input slice d + kd - 1 (two 64-channel planes) and
    the nine taps of kd into ws[kd]; y = (ws[0] + ws[1]) + ws[2]."""
    n, d, h, w, c = x.shape
    cfg = _Cfg(c, k.shape[-1])
    ws = torch.full((3, n, d, h, w, cfg.co), float("nan"), dtype=torch.float64)
    for kd in range(3):
        for cob in range(cfg.co // cfg.cob):
            smem = _w_smem(cfg, k, kd * 9 * c, 9 * c, cob * cfg.cob)
            for th in range(_cdiv(h, cfg.rh)):
                for tw in range(_cdiv(w, cfg.tm)):
                    for nn in range(n):
                        for dd in range(d):
                            acc = torch.zeros((cfg.rh, cfg.tm, cfg.cob), dtype=torch.float64)
                            di = dd + kd - 1
                            if 0 <= di < d:
                                slot = _stage(cfg, x, nn, di, th * cfg.rh, tw * cfg.tm)
                                _slice_taps(cfg, slot, smem, (0, 0, 0), (None, acc, None), 2)
                            _store(cfg, ws[kd], acc, nn, dd, th * cfg.rh, tw * cfg.tm,
                                   cob * cfg.cob, staged=False)
    return (ws[0] + ws[1]) + ws[2]


# tiny shapes: ranges of one item and of several that cross tile boundaries
# (few SMs), one range of the whole volume, D = 1 and 2, odd H, W off the
# 16-column tile, batch 2, every (C, Co), the 128 -> 128 split
_EMU = [((1, 3, 9, 20, 32), 32, 132), ((1, 5, 9, 20, 32), 32, 3), ((1, 5, 4, 18, 32), 64, 1),
        ((2, 2, 9, 16, 32), 64, 5), ((1, 1, 7, 20, 64), 32, 132), ((1, 4, 5, 36, 64), 32, 4),
        ((1, 7, 3, 24, 64), 64, 6), ((1, 2, 9, 20, 128), 128, 132)]


@pytest.mark.parametrize("shape,co,sms", _EMU, ids=[f"{_shape_id(s)}to{co}_sms{m}"
                                                    for s, co, m in _EMU])
def test_k3_schedule_emulation_matches_plain_f64(shape, co, sms):
    rng = np.random.default_rng(sum(shape) + co + sms)
    x = torch.from_numpy(rng.standard_normal(shape))
    k = torch.from_numpy(rng.standard_normal((3, 3, 3, shape[-1], co)))
    y = _emulate_split(x, k) if co == 128 else _emulate_walk(x, k, sms)
    np.testing.assert_allclose(y.numpy(), conv3d.conv3d_plain(x, k).numpy(),
                               rtol=1e-12, atol=1e-12)
