"""Launch plans and schedules of kernel A (the 3x3 2-D conv) in bf16 and of
kernel J (the fused stem's assembly).

Kernel A (``csrc/conv2d_k3.cu``) runs kernel B's walk (``csrc/s1_fwd_ring.cuh``)
at KH = 1 as ``dsmnet_tpu_torch/ops/conv2d.py`` plans it: contiguous
ranges of work items (n, 128-position row segment, output row h), h
fastest (``k2_items``, ``k2_run``), cut into runs as B's are
(``conv3d.k3_runs``).  Kernel J (``csrc/fused_costvol.cu``) walks one
(n, h) row per block in chunks of ``stem_columns`` columns, with the
grouped right sums G in a ring of ``stem_ring`` columns.  These tests hold
A's plan at its main-path shapes (PSMNet, GCNet, PSMNet-basic, serving and
training) and at ``chip_smoke.py``'s edge shapes for 132 and 114 SMs,
check that A's wrapper passes the planned arguments, and run float64
emulations of both schedules against ``conv2d_k3_plain`` and
``assemble_plain`` at tiny shapes: for A which input row sits in which ring
slot, where its TMA box lands in the swizzled slot, each lane's ldmatrix
address, which kh taps each row feeds and when each output row is staged
and stored; for J the chunks, the ring columns each read finds (while the
next chunk's writes have already landed), the suffix sums of the grouped
left taps and the tap-by-tap edge slices.  No kernel runs here: the launch
is replaced.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dsmnet_tpu_torch import config
from dsmnet_tpu_torch.ops import _build, conv2d, conv3d, fused_costvol


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _cdiv(a, b):
    return -(-a // b)


def _shape_id(s):
    return "x".join(map(str, s))


# x (N, H, W) of kernel A (32 -> 32): the main paths' (PSMNet and GCNet
# requests, PSMNet-basic's request, the PSMNet, GCNet and PSMNet-basic train
# steps), then chip_smoke's edges
_A_SHAPES = [(2, 192, 384), (1, 192, 384), (8, 192, 384), (4, 192, 384),
             (1, 10, 40), (2, 1, 40), (1, 2, 130), (1, 3, 300), (4, 97, 60), (2, 150, 300)]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape", _A_SHAPES, ids=_shape_id)
def test_k2_ranges_cover_every_item_once(shape, sms):
    """Kernel A's blocks take contiguous, non-empty ranges of ``per`` work
    items that cover every (n, segment, output row) once, in one wave of
    K2_BLOCKS_PER_SM blocks per SM; each range is cut into runs of one
    segment's consecutive rows, and a run stages its input rows max(h0 - 1,
    0) .. min(h1, H - 1) once."""
    n, h, w = shape
    seg = conv2d.K2_SEGMENT
    items = conv2d.k2_items(n, h, w)
    assert items == n * _cdiv(w, seg) * h
    per = conv2d.k2_run(items, sms)
    blocks = conv3d.k3_runs(items, h, per)
    assert len(blocks) == _cdiv(items, per) <= sms * conv2d.K2_BLOCKS_PER_SM
    seen = np.zeros(items, np.uint8)
    for b, runs in enumerate(blocks):
        assert runs and sum(h1 - h0 for _, h0, h1 in runs) == min(per, items - b * per)
        for tile, h0, h1 in runs:
            assert 0 <= h0 < h1 <= h and tile < n * _cdiv(w, seg)
            seen[tile * h + h0:tile * h + h1] += 1
        for (t0, _, e0), (t1, s1, _) in zip(runs, runs[1:]):
            assert t1 == t0 + 1 and e0 == h and s1 == 0
    assert (seen == 1).all()


def test_k2_plan_crosses_images_and_segments_at_the_edges():
    """The edges that chip_smoke.py checks reach ranges that cross images
    (4 x 97 rows at W = 60: ranges of 2) and segments and images (2 x 150
    rows x 3 segments: ranges of 4) at 132 SMs."""
    for (n, h, w), per in (((4, 97, 60), 2), ((2, 150, 300), 4)):
        items = conv2d.k2_items(n, h, w)
        assert conv2d.k2_run(items, 132) == per
        runs = conv3d.k3_runs(items, h, per)
        assert any(len(r) > 1 for r in runs)
        nseg = _cdiv(w, conv2d.K2_SEGMENT)
        assert any(r[0][0] // nseg != r[-1][0] // nseg for r in runs)


def _forced_launch(monkeypatch):
    calls = []
    monkeypatch.setattr(config, "launches_kernel", lambda op, x: True)
    monkeypatch.setattr(_build, "require_cuda", lambda name, *t: None)
    monkeypatch.setattr(_build, "sm_count", lambda index: 132)
    monkeypatch.setattr(_build, "launch", lambda name, dev, *args: calls.append((name, args)))
    return calls


@pytest.mark.parametrize("shape", [(8, 192, 384), (1, 3, 300)], ids=_shape_id)
def test_k2_wrapper_passes_planned_arguments(shape, monkeypatch):
    """In bf16 the wrapper passes the planned items per block; in float32
    (the conv_k3.cuh tiles) 0."""
    calls = _forced_launch(monkeypatch)
    n, h, w = shape
    with torch.no_grad():
        for dt in (torch.bfloat16, torch.float32):
            y = conv2d.conv2d_k3(torch.zeros((n, h, w, 32), dtype=dt),
                                 torch.zeros((3, 3, 32, 32), dtype=dt))
            assert tuple(y.shape) == (n, h, w, 32) and y.dtype == dt
    (n16, a16), (n32, a32) = calls
    assert n16 == n32 == "conv2d_k3"
    assert len(a16) == _build.ENTRY_POINTS["conv2d_k3"][1] + _build.ENTRY_POINTS["conv2d_k3"][2]
    assert a16[3:] == (_build.DTYPE_CODES[torch.bfloat16], n, h, w, 32, 32,
                       conv2d.k2_run(conv2d.k2_items(n, h, w), 132))
    assert a32[3:] == (_build.DTYPE_CODES[torch.float32], n, h, w, 32, 32, 0)


# ------------------------------------------------------- A's schedule

_NS = 4                  # ring slots (csrc/conv2d_k3.cu: launch_s1_fwd<.., 4, 2, 1>)
_C = _CO = _COB = 32     # channels, output channels, Co tile
_TM = conv2d.K2_SEGMENT  # a tile: one row of 128 positions
_COLS = _TM + 2          # a slot's positions, with the halo
_LB = _C * 2             # bytes of a staged line (SWIZZLE_64B)
_PITCH = _cdiv(_COLS * _LB, 1024) * 1024


def _swz_chunk(line, q, lb=_LB):
    """swz_chunk<LB>: 16-byte chunk q of the lb-byte line at `line`."""
    return line + ((q ^ ((line >> 7) & (lb // 16 - 1))) << 4)


def _stage(x, n, hi, w0):
    """The slot as the TMA fills it: the box (one row, columns w0 - 1 ..
    w0 + TM, 32 channels) of input row hi, zero outside the image, element
    (j, c) at chunk _swz_chunk(j lb, c // 8) / 16, lane c % 8."""
    _, h, w, c = x.shape
    box = torch.zeros((_COLS, c), dtype=x.dtype)
    if 0 <= hi < h:
        lo, hi_w = max(w0 - 1, 0), min(w, w0 - 1 + _COLS)
        box[lo - (w0 - 1):hi_w - (w0 - 1)] = x[n, hi, lo:hi_w]
    slot = torch.full((_PITCH // 16, 8), float("nan"), dtype=x.dtype)
    j, q = np.meshgrid(np.arange(_COLS), np.arange(c // 8), indexing="ij")
    slot[torch.from_numpy(_swz_chunk(j * _LB, q).ravel() // 16)] = box.reshape(-1, 8)
    return slot


def _w_smem(k):
    """The resident kernel: the (3, 3, 32, 32) kernel as 9 C rows (kh, kw,
    c), one TMA box of the (Co, C, 3, 3) view per kh, 64-byte rows swizzled
    in their width: row r's chunk q at 4 r + (q ^ ((r >> 1) & 3))."""
    kf = k.reshape(9 * _C, _CO)
    r, q = np.meshgrid(np.arange(9 * _C), np.arange(_COB // 8), indexing="ij")
    smem = torch.full((9 * _C * 4, 8), float("nan"), dtype=k.dtype)
    smem[torch.from_numpy((r * 4 + (q ^ ((r >> 1) & 3))).ravel())] = kf.reshape(-1, 8)
    return smem


def _w_rows(smem, row0):
    """The 16 x 32 B operand that wgmma's descriptor reads from row row0 on."""
    r, q = np.meshgrid(np.arange(row0, row0 + 16), np.arange(_COB // 8), indexing="ij")
    return smem[torch.from_numpy(r * 4 + (q ^ ((r >> 1) & 3)))].reshape(16, _COB)


def _row_taps(slot, smem, accs, mask):
    """s1_fwd_slice at KH = 1: for each kw tap, each warp's A fragment from
    the slot at the lanes' ldmatrix addresses (position 16 warp + (lane &
    15) shifted by kw, chunk 2 ks + (lane >> 4)), times the kernel rows at
    kh (3 kh + kw) C + 16 ks, into accs[kh] for each kh in mask."""
    warp, lane = np.meshgrid(np.arange(8), np.arange(32), indexing="ij")
    a_line = (warp * 16 + (lane & 15)) * _LB
    for kw in range(3):
        a = torch.empty((8, 16, _C), dtype=slot.dtype)  # (warp, position, k)
        for ks in range(_C // 16):
            chunks = slot[torch.from_numpy(_swz_chunk(a_line + kw * _LB, 2 * ks + (lane >> 4))
                                           // 16)]
            a[:, :, ks * 16:ks * 16 + 8] = chunks[:, :16]
            a[:, :, ks * 16 + 8:ks * 16 + 16] = chunks[:, 16:]
        assert not torch.isnan(a).any()  # every read lands inside the box
        for kh in range(3):
            if mask >> kh & 1:
                b = torch.cat([_w_rows(smem, (3 * kh + kw) * _C + 16 * ks)
                               for ks in range(_C // 16)])
                accs[kh].add_(a @ b)


def _store(y, acc, n, h, w0):
    """s1_fwd_stage_out and the TMA store: lane (warp, g, tq) writes its
    accumulator pairs of positions 16 warp + g (+ 8) and channels 8 ni + 2
    tq into staging line 16 warp + g (+ 8) at swz_chunk(line, ni) + 4 tq;
    the store reads the tile as its (32, 128, 1) box, clipped at W.  No
    output is written twice."""
    lbo = _COB * 2
    tile = torch.full((_TM * _COB,), float("nan"), dtype=acc.dtype)
    warp, g, tq, ni = np.meshgrid(np.arange(8), np.arange(8), np.arange(4),
                                  np.arange(_COB // 8), indexing="ij")
    for half in (0, 1):
        addr = _swz_chunk((warp * 16 + g + 8 * half) * lbo, ni, lbo) + 4 * tq
        for e in (0, 1):
            tile[torch.from_numpy((addr // 2 + e).ravel())] = acc[
                warp.ravel(), (g + 8 * half).ravel(), (8 * ni + 2 * tq + e).ravel()]
    j, q, e = np.meshgrid(np.arange(_TM), np.arange(_COB // 8), np.arange(8), indexing="ij")
    staged = tile[torch.from_numpy(_swz_chunk(j * lbo, q, lbo) // 2 + e)].reshape(_TM, _COB)
    assert not torch.isnan(staged).any()
    ww = min(y.shape[2], w0 + _TM) - w0
    dst = y[n, h, w0:w0 + ww]
    assert torch.isnan(dst).all()
    dst.copy_(staged[:ww])


def _emulate_k2(x, k, sms):
    """s1_fwd_kernel at KH = 1 in float64: per block, the producer fills the
    four-slot ring with the k-th staged row of its runs, the consumer walks
    the runs, checks that the slot holds the row it expects, feeds it to
    the kh taps of its mask (kh = 0: output hi + 1, 1: hi, 2: hi - 1),
    stores output row hi - 1 after row hi (and row H - 1 at a run's end at
    H) and rotates the three accumulator sets."""
    n, h, w, _ = x.shape
    ntw = _cdiv(w, _TM)
    items = conv2d.k2_items(n, h, w)
    y = torch.full((n, h, w, _CO), float("nan"), dtype=torch.float64)
    smem = _w_smem(k)
    zeros = lambda: torch.zeros((8, 16, _COB), dtype=torch.float64)
    for runs in conv3d.k3_runs(items, h, conv2d.k2_run(items, sms)):
        staged = [(tile, hi) for tile, h0, h1 in runs
                  for hi in range(max(h0 - 1, 0), min(h1, h - 1) + 1)]
        ring = [None] * _NS

        def issue(kk):
            if kk < len(staged):
                tile, hi = staged[kk]
                ring[kk % _NS] = ((tile, hi), _stage(x, tile // ntw, hi, tile % ntw * _TM))

        for kk in range(_NS):
            issue(kk)
        kk = 0
        for tile, h0, h1 in runs:
            nn, w0 = tile // ntw, tile % ntw * _TM
            a0, a1, a2 = zeros(), zeros(), zeros()
            for hi in range(max(h0 - 1, 0), min(h1, h - 1) + 1):
                tag, slot = ring[kk % _NS]
                assert tag == (tile, hi)
                mask = (int(h0 <= hi + 1 < h1) | int(h0 <= hi < h1) << 1
                        | int(h0 <= hi - 1 < h1) << 2)
                assert mask in (1, 2, 3, 4, 6, 7)
                _row_taps(slot, smem, (a0, a1, a2), mask)
                if mask & 4:
                    _store(y, a2, nn, hi - 1, w0)
                a2, a1, a0 = a1, a0, zeros()
                issue(kk + _NS)
                kk += 1
            if h1 == h:
                _store(y, a2, nn, h - 1, w0)
        assert kk == len(staged)
    return y


# tiny shapes: H = 1, 2, 3; W less than a segment, one segment, a ragged
# last one; one range per block (132 SMs) and ranges that cross segments
# and images (few SMs)
_EMU = [((1, 1, 40), 132), ((2, 1, 40), 1), ((1, 2, 128), 132), ((1, 3, 300), 2),
        ((2, 5, 60), 3), ((2, 7, 200), 4), ((1, 6, 20), 1)]


@pytest.mark.parametrize("shape,sms", _EMU, ids=[f"{_shape_id(s)}_sms{m}" for s, m in _EMU])
def test_k2_schedule_emulation_matches_plain_f64(shape, sms):
    rng = np.random.default_rng(sum(shape) + sms)
    x = torch.from_numpy(rng.standard_normal((*shape, _C)))
    k = torch.from_numpy(rng.standard_normal((3, 3, _C, _CO)))
    np.testing.assert_allclose(_emulate_k2(x, k, sms).numpy(),
                               conv2d.conv2d_k3_plain(x, k).numpy(), rtol=1e-12, atol=1e-12)


# ------------------------------------------------------- J's schedule

_TAP_DD = [t // 3 - 1 for t in range(9)]
_TAP_DW = [t % 3 - 1 for t in range(9)]


def _emulate_stem(a, b, D, mask_left):
    """fused_costvol_kernel in float64, every (n, h) row at once: chunk by
    chunk, each column's B taps at s = w (and s = -2, -1 in the first chunk)
    give G[s] and slice D - 1's right half of column s + D - 1 (the rings,
    slot (s + 2) % R) and GW[W - 1 - s]; after the barrier each column adds
    its suffix sums P_k of the grouped left taps to G[w - d].  The next
    chunk's ring writes land before this chunk's reads, as the fastest warps
    may make them, and every read checks the column its slot holds."""
    n, h, w, o9 = a.shape
    o = o9 // 9
    cw, R = fused_costvol.stem_columns(o), fused_costvol.stem_ring(D, o)
    A, B = a.reshape(n * h, w, 9, o), b.reshape(n * h, w, 9, o)
    zero = torch.zeros((n * h, o), dtype=a.dtype)
    out = torch.full((n * h, D, w, o), float("nan"), dtype=a.dtype)
    g_ring, g_tag = torch.full((R, n * h, o), float("nan"), dtype=a.dtype), [None] * R
    l_ring, l_tag = g_ring.clone(), [None] * R
    gw = torch.full((D, n * h, o), float("nan"), dtype=a.dtype)
    first = {}

    def right(s):
        bt = [B[:, s + _TAP_DW[t] - _TAP_DD[t], t] if 0 <= s + _TAP_DW[t] - _TAP_DD[t] < w
              else zero for t in range(9)]
        wl = s + D - 1
        slot = (s + 2) % R
        g_ring[slot], g_tag[slot] = sum(bt), s
        if D >= 2 and wl < w:
            l_ring[slot] = sum(bt[t] for t in range(9)
                               if _TAP_DD[t] <= 0 and 0 <= wl + _TAP_DW[t] < w)
            l_tag[slot] = s
        if 1 <= w - 1 - s <= D - 2:
            gw[w - 1 - s] = sum(bt[t] for t in range(9) if _TAP_DW[t] <= 0)
        return sum(bt[t] for t in range(9)
                   if 0 <= _TAP_DD[t] < D and 0 <= s + _TAP_DW[t] < w)

    def phase1(c0):
        for s in range(c0, min(w, c0 + cw)):
            first[s] = right(s)
        if c0 == 0:
            for s in range(-2, 0):
                right(s)

    def phase2(c0):
        for wc in range(c0, min(w, c0 + cw)):
            at = [A[:, wc + _TAP_DW[t], t] if 0 <= wc + _TAP_DW[t] < w else zero
                  for t in range(9)]
            p2 = at[2]
            p1 = p2 + at[1] + at[5]
            p0 = p1 + at[0] + at[4] + at[8]
            pm1 = p0 + at[3] + at[7]
            pm2 = pm1 + at[6]
            f, last = first.pop(wc), zero
            for t in range(9):
                dd, e = _TAP_DD[t], _TAP_DW[t] - _TAP_DD[t]
                if 0 <= dd < D and (not mask_left or wc + e >= 0):
                    f = f + at[t]
                if dd <= 0 and (not mask_left or wc - (D - 1) + e >= 0):
                    last = last + at[t]
            out[:, 0, wc] = f
            for d in range(1, D - 1):
                k = d - wc
                v = pm2 if not mask_left or k <= -2 else \
                    {-1: pm1, 0: p0, 1: p1, 2: p2}.get(k, zero)
                if k <= 2:
                    if wc == w - 1:
                        assert not torch.isnan(gw[d]).any()
                        v = v + gw[d]
                    else:
                        slot = (wc - d + 2) % R
                        assert g_tag[slot] == wc - d
                        v = v + g_ring[slot]
                out[:, d, wc] = v
            if D >= 2:
                sl = wc - D + 1
                if sl >= -2:
                    assert l_tag[(sl + 2) % R] == sl
                    last = last + l_ring[(sl + 2) % R]
                out[:, D - 1, wc] = last

    phase1(0)
    for c0 in range(0, w, cw):
        if c0 + cw < w:
            phase1(c0 + cw)
        phase2(c0)
    assert not first
    return out.reshape(n, h, D, w, o).permute(0, 2, 1, 3, 4)


# (N, H, W, O, D, mask_left): chip_smoke's edges (D > W + 2, W < 3, D < 3,
# batch 2, O = 12, 16, 64, unmasked, several chunks), W = 1, D = 1, and two
# rows at PSMNet's W and D
_STEM = [(1, 3, 5, 32, 12, True), (1, 4, 37, 32, 16, True), (1, 3, 2, 32, 4, True),
         (1, 3, 20, 32, 2, True), (2, 3, 45, 32, 48, True), (1, 3, 40, 16, 10, True),
         (1, 2, 30, 12, 7, False), (1, 5, 50, 32, 20, False), (1, 3, 6, 32, 11, False),
         (2, 3, 70, 32, 96, True), (1, 4, 50, 64, 24, True), (2, 3, 37, 64, 13, False),
         (1, 2, 1, 32, 5, True), (1, 2, 7, 12, 1, False), (1, 2, 192, 32, 48, True)]


@pytest.mark.parametrize("n,h,w,o,D,mask_left", _STEM,
                         ids=[f"{n}x{h}x{w}o{o}D{D}{'m' if m else 'u'}"
                              for n, h, w, o, D, m in _STEM])
def test_stem_grouped_emulation_matches_plain_f64(n, h, w, o, D, mask_left):
    rng = np.random.default_rng(n + h + w + o + D)
    a = torch.from_numpy(rng.standard_normal((n, h, w, 9 * o)))
    b = torch.from_numpy(rng.standard_normal((n, h, w, 9 * o)))
    assert fused_costvol.stem_smem(D, o) <= fused_costvol.STEM_MAX_SMEM
    np.testing.assert_allclose(
        _emulate_stem(a, b, D, mask_left).numpy(),
        fused_costvol.assemble_plain(a, b, D, mask_left, torch.float64).numpy(),
        rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("o", [12, 16, 32, 64])
def test_stem_block_fits_at_psmnet_shapes(o):
    """A chunk is one thread per column and four channels of the 256; the
    rings hold D + 2 chunks; at PSMNet's D = 48 (maxdisparity 192) the block
    takes a quarter of the H100's shared memory or less, so the two blocks
    per SM of its launch bounds fit with room to spare."""
    cw = fused_costvol.stem_columns(o)
    assert cw * (o // 4) <= fused_costvol.STEM_THREADS < (cw + 1) * (o // 4)
    assert fused_costvol.stem_ring(48, o) == 48 + 2 * cw
    assert fused_costvol.stem_smem(48, o) <= fused_costvol.STEM_MAX_SMEM // 4
