"""Launch plans and float64 emulations of kernel I (the 1-D correlation)
and of its VJP kernel, in bf16.

Kernel I (``csrc/corr1d.cu``) forms, per item of ``CORR_TILE`` = 64 output
columns of one (n, h) row, the band of the Gram matrix G = fL fR^T: strip
i, the rows 16 i .. 16 i + 15, forms G's columns from 16 i on, ``CORR_NB``
n8 tiles a pass, two warps a strip (each half of every pass's tiles),
keeps from the m16n8 fragments the values on
the band, stages them in the output's element order (shifted so that its
16-byte words line up with the output's) and stores the item's run in a
head, whole words and a tail.  The VJP kernel (``csrc/corr1d_vjp.cu``)
multiplies, per 64-column tile and side, a band matrix built from g's rows
(Bg for dfL, Cg for dfR) by the staged feature rows, two warps a strip
(each half of the channels).  ``ops/corr.py``
``band_plan`` and ``vjp_plan`` mirror what each stages.  These tests hold
both plans at the main paths' parameters (DispNetC's D = 41, iResNet's D =
81 and D = 41 at stride 2; C = 128 and 64) and run float64 emulations of
both schedules, fragment by fragment and tile by tile, against
``corr1d_plain`` and ``corr1d_vjp`` at those parameters and at the edges
(W not a multiple of 64, W < 64, D S >= W, odd H, batch 2, C = 32 and 24).
No kernel runs here: the launch is replaced.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from dsmnet_tpu_torch import config
from dsmnet_tpu_torch.ops import _build, corr

T = corr.CORR_TILE
_WARPS = 8  # warps a block of either kernel: two a strip (kBandThreads / 32, kVjpThreads / 32)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _case_id(case):
    return "x".join(map(str, case[:4])) + f"_D{case[4]}_S{case[5]}"


# (C, D, stride) of the main paths -> band_plan's (cp, ni, passes, rows,
# smem) and vjp_plan's (ks, rows, smem)
_PATHS = {
    (128, 41, 1): ((128, 7, 2, 112, 53136), (4, 112, 45824)),
    (128, 81, 1): ((128, 12, 3, 144, 66960), (6, 144, 58624)),
    (64, 41, 2): ((64, 12, 3, 144, 35216), (6, 144, 40192)),
}


@pytest.mark.parametrize("cds", sorted(_PATHS), ids=lambda k: "C%d_D%d_S%d" % k)
def test_plans_at_path_shapes(cds):
    """Both plans at the paths' (C, D, stride): a strip's band fits its n8
    tiles and k16 steps, the staged rows reach the last strip's band (every
    fR / feature column a tile meets), and shared memory admits two blocks
    an SM or more."""
    c, D, s = cds
    (cp, ni, passes, rows, smem), (ks, vrows, vsmem) = _PATHS[cds]
    b = corr.band_plan(c, D, s)
    assert (b["cp"], b["ni"], b["passes"], b["rows"], b["smem"]) == (cp, ni, passes, rows, smem)
    assert 8 * b["ni"] >= (D - 1) * s + 16 and b["passes"] * corr.CORR_NB >= b["ni"]
    assert b["rows"] >= T + (D - 1) * s and b["rows"] == 48 + 8 * corr.CORR_NB * b["passes"]
    assert b["pitch"] * 2 % 32 == 16  # an odd multiple of 16 bytes: ldmatrix without conflicts
    v = corr.vjp_plan(c, D, s)
    assert (v["ks"], v["rows"], v["smem"]) == (ks, vrows, vsmem)
    assert 16 * v["ks"] >= (D - 1) * s + 16 and v["rows"] >= T + (D - 1) * s
    assert v["pitch"] * 2 % 32 == 16 and v["bpitch"] * 2 % 32 == 16
    assert 2 * max(b["smem"], v["smem"]) <= 228 * 1024


def test_plans_mirror_the_sources():
    """The tile, the passes' width and the VJP's channel limit are the
    .cu files' constants."""
    src = {n: (_build.CSRC / n).read_text() for n in ("corr1d.cu", "corr1d_vjp.cu")}
    const = lambda n, name: int(re.search(rf"constexpr int {name} = (\d+);", src[n]).group(1))
    assert const("corr1d.cu", "kTile") == const("corr1d_vjp.cu", "kTile") == T
    assert const("corr1d.cu", "kNB") == corr.CORR_NB
    assert const("corr1d.cu", "kBandThreads") == const("corr1d_vjp.cu", "kVjpThreads") \
        == 32 * _WARPS
    assert const("corr1d_vjp.cu", "kMaxC") == corr.VJP_MAX_C
    assert "rows = 48 + 8 * kNB * p.passes" in src["corr1d.cu"]
    assert "rows = 48 + 16 * p.ks" in src["corr1d_vjp.cu"]


# ---------------------------------------------------------------- I's schedule

_LANE = np.arange(32)
_G, _T4 = _LANE >> 2, _LANE & 3


def _emulate_band(fL, fR, D, S):
    """Kernel I's bf16 schedule in float64: per item the staged rows, each
    warp's passes of G, the band taken from the fragments into the staging
    tile (each element once), and the head / words / tail store."""
    n, h, w, c = fL.shape
    p = corr.band_plan(c, D, S)
    out = np.full(n * h * w * D, np.nan)
    for nn in range(n):
        for hh in range(h):
            row = (nn * h + hh) * w
            for w0 in range(0, w, T):
                cols = min(T, w - w0)
                s_l = np.zeros((T, p["cp"]))
                s_l[:cols, :c] = fL[nn, hh, w0:w0 + cols]
                s_r = np.zeros((p["rows"], p["cp"]))
                lo = w0 - (D - 1) * S
                for j in range(p["rows"]):
                    if 0 <= lo + j < w:
                        s_r[j, :c] = fR[nn, hh, lo + j]
                first = (row + w0) * D
                shift = first % 8
                tile = np.full(T * D + 8, np.nan)
                writes = np.zeros(T * D + 8, int)
                half = corr.CORR_NB // 2
                for warp in range(_WARPS):
                    m0, n0 = 16 * (warp % 4), warp // 4 * half
                    for ps in range(p["passes"]):
                        j0 = m0 + 8 * corr.CORR_NB * ps + 8 * n0
                        assert j0 + 8 * half <= p["rows"]
                        g = s_l[m0:m0 + 16] @ s_r[j0:j0 + 8 * half].T
                        for ni in range(half):
                            for v in range(4):
                                r = _G + (v >> 1) * 8
                                col = 8 * ni + 2 * _T4 + (v & 1)
                                delta = 8 * corr.CORR_NB * ps + 8 * n0 + col - r
                                ok = (delta >= 0) & (delta % S == 0) & (delta // S <= D - 1)
                                idx = shift + (m0 + r[ok]) * D + D - 1 - delta[ok] // S
                                tile[idx] = g[r[ok], col[ok]]
                                np.add.at(writes, idx, 1)
                assert (writes[shift:shift + T * D] == 1).all()
                assert writes.sum() == T * D
                total = cols * D
                head = min(total, (8 - shift) & 7)
                words = (total - head) // 8
                if words:
                    assert (first + head) % 8 == 0 and (shift + head) % 8 == 0
                tail0 = head + 8 * words
                for a, b in ((0, head), (head, tail0), (tail0, total)):
                    out[first + a:first + b] = tile[shift + a:shift + b]
    return out.reshape(n, h, w, D)


# (N, H, W, C, D, stride): the main paths' parameters at one or two rows,
# then the edges: W not a multiple of 64 (100, 65, 130: one past a tile),
# W < 64 with D S >= W, D S >= W at stride 2, odd H and batch 2, C = 32
# and 24, D = 1 and 3, stride 3
_CASES = [(1, 1, 192, 128, 41, 1), (1, 1, 192, 128, 81, 1), (1, 1, 384, 64, 41, 2),
          (2, 3, 100, 128, 41, 1), (1, 2, 65, 128, 41, 1), (2, 3, 130, 64, 81, 1),
          (1, 3, 20, 64, 41, 1), (2, 5, 65, 32, 41, 2), (1, 3, 33, 32, 20, 2),
          (1, 2, 130, 128, 41, 2), (1, 2, 40, 24, 9, 1), (1, 1, 7, 64, 3, 1),
          (1, 2, 70, 64, 1, 1), (1, 3, 70, 64, 9, 3)]


def _inputs(case, seed):
    n, h, w, c, D, _ = case
    rng = np.random.RandomState(seed)
    return rng.randn(n, h, w, c), rng.randn(n, h, w, c), rng.randn(n, h, w, D)


@pytest.mark.parametrize("case", _CASES, ids=_case_id)
def test_band_schedule_matches_plain_f64(case):
    """Every output is written once from the band of its item's G, and
    the result is the plain correlation."""
    fL, fR, _ = _inputs(case, 0)
    D, s = case[4], case[5]
    out = _emulate_band(fL, fR, D, s)
    ref = corr.corr1d_plain(torch.from_numpy(fL), torch.from_numpy(fR), D, s).numpy()
    assert not np.isnan(out).any()
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12)


# -------------------------------------------------------------- the VJP's schedule

def _band_matrix(g, nn, hh, w0, rows, left, D, S):
    """Bg (left) or Cg of one tile by their definitions: Bg[m, j] =
    g[w0 + m, D-1-(j-m)/S], Cg[m, j] = g[w0 + j, (j-m)/S], where (j - m)
    is a multiple of S in [0, (D-1) S] and the row lies in the image."""
    w = g.shape[2]
    band = np.zeros((T, rows))
    for m in range(T):
        for j in range(rows):
            delta = j - m
            if delta < 0 or delta % S or delta // S > D - 1:
                continue
            r, d = (m, D - 1 - delta // S) if left else (j, delta // S)
            if w0 + r < w:
                band[m, j] = g[nn, hh, w0 + r, d]
    return band


def _emulate_vjp(fL, fR, g, S, check_bands=False):
    """The VJP kernel's bf16 schedule in float64: per tile and side the
    staged feature rows, the band scattered from g's rows (read as the
    16-byte words inside them and the elements at their ends: each element
    once, onto each band element once), each warp's strip over its k16
    steps, the rows inside W stored."""
    n, h, w, c = fL.shape
    D = g.shape[-1]
    p = corr.vjp_plan(c, D, S)
    dfL, dfR = np.full(fL.shape, np.nan), np.full(fR.shape, np.nan)
    for nn in range(n):
        for hh in range(h):
            for w0 in range(0, w, T):
                for left in (True, False):
                    lo = w0 - (D - 1) * S if left else w0
                    feat = np.zeros((p["rows"], p["cp"]))
                    for j in range(p["rows"]):
                        if 0 <= lo + j < w:
                            feat[j, :c] = (fR if left else fL)[nn, hh, lo + j]
                    band = np.zeros((T, p["bpitch"]))
                    seen = np.zeros((T, p["bpitch"]), int)
                    grows = min(w - w0, T if left else T + (D - 1) * S)
                    # g's elements e0 .. e1 - 1: the 16-byte words inside the
                    # range, then the partial words' elements at its ends
                    e0 = ((nn * h + hh) * w + w0) * D
                    e1 = e0 + grows * D
                    wa, wb = -(-e0 // 8), e1 // 8
                    h1 = min(e1, 8 * wa)
                    t0 = max(h1, 8 * wb)
                    e = np.concatenate([np.arange(8 * wa, 8 * max(wa, wb)), np.arange(e0, h1),
                                        np.arange(t0, e1)])
                    np.testing.assert_array_equal(np.sort(e), np.arange(e0, e1))
                    i = e - e0
                    r, d = i // D, i % D
                    m = r if left else r - d * S
                    j = r + (D - 1 - d) * S if left else r
                    ok = (m >= 0) & (m < T)
                    assert (j[ok] < p["rows"]).all()
                    band[m[ok], j[ok]] = g[nn, hh, w0 + r[ok], d[ok]]
                    np.add.at(seen, (m[ok], j[ok]), 1)
                    assert seen.max() <= 1
                    if check_bands:
                        np.testing.assert_array_equal(
                            band[:, :p["rows"]],
                            _band_matrix(g, nn, hh, w0, p["rows"], left, D, S))
                    acc = np.full((T, p["cp"]), np.nan)
                    per = (p["cp"] // 16 + 1) // 2
                    for warp in range(_WARPS):
                        # strip warp % 4, pairs of n8 tiles [q0, q0 + npairs)
                        m0, q0 = 16 * (warp % 4), warp // 4 * per
                        cols = slice(16 * q0, 16 * (q0 + min(p["cp"] // 16 - q0, per)))
                        k = slice(m0, m0 + 16 * p["ks"])
                        # the strip's band lies in its k16 steps
                        assert not band[m0:m0 + 16, :m0].any()
                        assert not band[m0:m0 + 16, m0 + 16 * p["ks"]:].any()
                        acc[m0:m0 + 16, cols] = band[m0:m0 + 16, k] @ feat[k, cols]
                    cols = min(T, w - w0)
                    (dfL if left else dfR)[nn, hh, w0:w0 + cols] = acc[:cols, :c]
    return dfL, dfR


@pytest.mark.parametrize("case", _CASES, ids=_case_id)
def test_vjp_schedule_matches_plain_f64(case):
    """Bg and Cg built by scattering g's rows are the band matrices of
    their definitions (checked at W <= 100), and their products with the
    staged rows are the plain VJP."""
    fL, fR, g = _inputs(case, 1)
    s = case[5]
    dfL, dfR = _emulate_vjp(fL, fR, g, s, check_bands=case[2] <= 100)
    ref = corr.corr1d_vjp(*(torch.from_numpy(a) for a in (fL, fR, g)), s)
    for out, r in zip((dfL, dfR), ref):
        assert not np.isnan(out).any()
        np.testing.assert_allclose(out, r.numpy(), rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------------ wrappers

def _forced_launch(monkeypatch):
    calls = []
    monkeypatch.setattr(config, "launches_kernel", lambda op, x: True)
    monkeypatch.setattr(_build, "require_cuda", lambda name, *t: None)
    monkeypatch.setattr(_build, "launch", lambda name, dev, *args: calls.append((name, args)))
    return calls


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=str)
def test_wrappers_pass_shapes(dt, monkeypatch):
    """Both wrappers pass the dtype code and (N, H, W, C, D, stride) after
    their pointers, as many as the entry points take, and return outputs
    of the inputs' dtype."""
    calls = _forced_launch(monkeypatch)
    fL, fR, g = torch.zeros(2, 3, 65, 32, dtype=dt), torch.zeros(2, 3, 65, 32, dtype=dt), \
        torch.zeros(2, 3, 65, 41, dtype=dt)
    with torch.no_grad():
        out = corr.corr1d_kernel(fL, fR, 41, 2)
        dfL, dfR = corr.corr1d_vjp_kernel(fL, fR, g, 2)
    assert out.shape == (2, 3, 65, 41) and out.dtype == dt
    assert dfL.shape == dfR.shape == fL.shape and dfL.dtype == dfR.dtype == dt
    (n1, a1), (n2, a2) = calls
    assert (n1, n2) == ("corr1d", "corr1d_vjp")
    for name, args in calls:
        assert len(args) == sum(_build.ENTRY_POINTS[name][1:])
        assert args[-7:] == (_build.DTYPE_CODES[dt], 2, 3, 65, 32, 41, 2)


def test_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch):
    """bf16 shapes whose plans exceed shared memory, a bf16 VJP above 128
    channels and C not a multiple of 16 bytes raise before any launch; the
    f32 VJP takes C = 256."""
    calls = _forced_launch(monkeypatch)
    z = lambda *s, dt=torch.bfloat16: torch.zeros(s, dtype=dt)
    with torch.no_grad():
        with pytest.raises(ValueError, match="band_plan"):
            corr.corr1d_kernel(z(1, 1, 8, 128), z(1, 1, 8, 128), 400, 2)
        with pytest.raises(ValueError, match="vjp_plan"):
            corr.corr1d_vjp_kernel(z(1, 1, 8, 256), z(1, 1, 8, 256), z(1, 1, 8, 4))
        with pytest.raises(ValueError, match="vjp_plan"):
            corr.corr1d_vjp_kernel(z(1, 1, 8, 128), z(1, 1, 8, 128), z(1, 1, 8, 900), 2)
        with pytest.raises(ValueError, match="16 bytes"):
            corr.corr1d_vjp_kernel(z(1, 1, 8, 12), z(1, 1, 8, 12), z(1, 1, 8, 4))
        assert calls == []
        corr.corr1d_vjp_kernel(z(1, 1, 8, 256, dt=torch.float32),
                               z(1, 1, 8, 256, dt=torch.float32),
                               z(1, 1, 8, 4, dt=torch.float32))
    assert [n for n, _ in calls] == ["corr1d_vjp"]
