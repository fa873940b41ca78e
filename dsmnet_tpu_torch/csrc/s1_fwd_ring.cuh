// The bf16 design of kernel B on the H100: the 3x3x3 stride-1 SAME
// convolution (C -> Co in {32, 64}, and 128 -> 128), an implicit GEMM with
// M = output positions, N = Co and K = 27 taps x C.
//
// s1_fwd_kernel walks D input-stationary.  A block keeps all 27 taps of
// its COB output channels resident in shared memory (27 C COB bf16: 55.3
// KB at 32 -> 32, 110.6 KB at 64 -> 32, 32 -> 64 and at 64 -> 64 in Co
// tiles of 32), in the swizzled MN-major layout that wgmma reads as its B
// operand (kernel C's, s2_ring.cuh), loaded by one TMA box per kd on its
// own mbarrier, so the first slice's taps start once their kd has
// arrived.  It owns a contiguous range of work items (n, h tile, w tile,
// output slice d), d fastest: one or a few runs of output slices d0 .. d1
// - 1 of an 8 x 16 (h, w) tile.  One thread streams the input slices d0 -
// 1 .. d1 of each run through a TMA ring (an (8 + 2) x (16 + 2) box of C
// channels, the halo and the padding zero-filled by the TMA, lines
// swizzled in their width), two or three slices in flight while the
// warpgroups compute, across the run boundaries too.  Each input slice
// reaches shared memory once per block and feeds the three output slices
// it reaches: slice di adds its taps kd = 0, 1, 2 into the outputs di + 1,
// di and di - 1, held in three accumulator sets, and output di - 1 is
// complete once slice di has run.
//
// The A operand of tap (kh, kw) is the slot shifted by kh rows and kw
// positions: each warp owns one row of the tile (16 positions) and loads
// the shifted rows into registers with ldmatrix (the next tap's while the
// current tap's wgmmas run); one A fragment then feeds the wgmmas of all
// three kd taps (m64 x COB x k16 each, N = Co tile), so shared memory
// delivers A once for three MMAs and B once per MMA: at Co = 32 that is
// 2 + 3 x 1 KB per three m64n32k16, ~39 FLOP per byte read against the 32
// that an SM's 128 bytes per clock need to keep its tensor cores fed.  A
// finished output slice goes to one of two staging tiles in bf16 and
// leaves as one TMA store (clipped at the edge), so every output line is
// written whole (4-byte stores from the accumulator registers would write
// each 32-byte sector in pieces).
//
// s1_fwd_split_kernel runs 128 -> 128 (GCNet's l31/l32, a (1, 6, 12, 24)
// volume: 1728 positions, too few for a D-walk to fill 132 SMs, and a
// 885 KB kernel that no block can keep): a block owns one tile, one output
// slice, one kd and 64 of the 128 output channels, stages the one input
// slice it reads (two 64-channel planes) and the 9 x 128 x 64 kernel rows
// of its kd, and writes an f32 partial; s1_fwd_reduce adds the three kd
// partials in a fixed order (kd = 0, 1, 2) and rounds to bf16: the same
// bits on every run, no float atomics.
//
// Kernel A (the 3x3 2-D conv, 32 -> 32, csrc/conv2d_k3.cu) runs the same
// walk at KH = 1: the walked dim is H, the tile one row segment of 128
// positions (two warpgroups of 64), a slot one input row of 130 positions,
// and kh takes kd's part: each staged row feeds the output rows h + 1, h
// and h - 1 through its three kh tap groups of three kw taps.
#pragma once

#include "s2_ring.cuh"

namespace dsm {

// C input channels in planes of KC = min(C, 64) (one TMA box each), COB of
// the CO output channels per block; WALK: the walk, all 3 KT taps resident,
// else one kd group of KT taps (the split); NSLOT ring slots; KH kernel rows
// inside a slot (3: the 3-D conv, KT = 9 taps (kh, kw) per kd; 1: the 2-D
// conv, KT = 3 taps kw per kh, kh walked as kd).  A tile: RH x TM output
// positions of one (n, d), 8 x 16 at KH = 3 (warp w owns row w), 1 x 128
// at KH = 1 (warp w owns positions 16 w ..), two warpgroups of 64.  A slot:
// one input slice's RH + KH - 1 rows of TM + 2 positions, XP planes of
// LB-byte lines.  The walk stages finished output slices in two bf16 tiles
// of RH x TM lines of COB * 2 bytes (one TMA store box each).
template <int C, int CO, int COB, bool WALK, int NSLOT = 4, int KH = 3>
struct S1Fwd {
  static constexpr int kC = C, kCO = CO, kCOB = COB;
  static constexpr int KT = 3 * KH;                       // taps of a kd group
  static constexpr int TAPS = WALK ? 3 * KT : KT;         // resident taps
  static constexpr int RH = KH == 3 ? 8 : 1, TM = 128 / RH;
  static constexpr int NT = 256;                          // 2 warpgroups
  static constexpr int NCOB = CO / COB;                   // Co tiles
  static constexpr int KC = C < 64 ? C : 64;              // channels of an x plane
  static constexpr int XP = C / KC;                       // planes of a slot
  static constexpr int LB = KC * 2;                       // bytes of a staged line
  static constexpr int ROWS = RH + KH - 1, COLS = TM + 2; // with the halo
  static constexpr int PLANE_BYTES = ROWS * COLS * LB;    // one TMA box
  static constexpr int PLANE_PITCH = (PLANE_BYTES + 1023) / 1024 * 1024;
  static constexpr int SLOT = XP * PLANE_PITCH;
  static constexpr int NS = WALK ? NSLOT : 1;             // ring slots
  static constexpr int KS = KC / 16;                      // k16 steps of a tap and plane
  static constexpr int NI = COB / 8;                      // n8 tiles of an accumulator set
  static constexpr int W_BYTES = TAPS * C * COB * 2;      // the resident kernel rows
  static constexpr int OUT_TILE = RH * TM * COB * 2;       // a staged output slice
  static constexpr int NOUT = WALK ? 2 : 0;                // staged output tiles
  static constexpr size_t SMEM =
      static_cast<size_t>(W_BYTES) + NS * SLOT + NOUT * OUT_TILE + 64;  // + mbarriers
  static_assert(RH * TM == 16 * NT / 32, "a warp owns 16 positions of one row");
  static_assert(KH == 3 || KH == 1, "a 3x3x3 or a 3x3 kernel");
  static_assert(C % 16 == 0 && (C <= 64 || C % 64 == 0) && (COB == 32 || COB == 64) &&
                    CO % COB == 0 && KT * C * COB * 2 % 1024 == 0,
                "widths");
  static_assert(SMEM <= 232448, "shared memory");
};

// One staged input slice (the slot at `slot`) into the accumulators: for
// every plane p and tap t = (kh, kw) of a kd group (kh = 0 at KH = 1), the
// warp's A fragment is the slot's plane p shifted by kh rows and kw
// positions, and each kd in MASK (bit kd) adds it times the kernel rows
// (kd, t, p KC ..) at wk[kd] into acc kd: a0 (output di + 1), a1 (output
// di), a2 (output di - 1).  Each (plane, tap) unit is one group of
// asynchronous wgmmas; the next unit's A fragments are loaded while the
// current one runs, into a third buffer, so a wait only covers the unit
// before.
template <typename Cfg, int MASK>
__device__ __forceinline__ void s1_fwd_slice(float (&a0)[Cfg::NI][4], float (&a1)[Cfg::NI][4],
                                             float (&a2)[Cfg::NI][4], uint32_t slot,
                                             uint32_t wk0, uint32_t wk1, uint32_t wk2) {
  constexpr int KS = Cfg::KS, KT = Cfg::KT, NU = Cfg::XP * KT;
  constexpr int ROW_B = Cfg::kCOB * 2;  // bytes of a resident kernel row
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  // lane's A row: position (r, j + (lane & 15)) of the tile, at kh = kw = 0
  const int r = warp * 16 / Cfg::TM, j = warp * 16 - r * Cfg::TM;
  const uint32_t a_line = slot + (r * Cfg::COLS + j + (lane & 15)) * Cfg::LB;
  auto load = [&](uint32_t (&a)[KS][4], int u) {
    const int p = u / KT, t = u % KT, kh = t / 3, kw = t % 3;
    const uint32_t line = a_line + p * Cfg::PLANE_PITCH + (kh * Cfg::COLS + kw) * Cfg::LB;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) reg_fence(a[ks][e]);  // its last wgmma has retired
      ldsm_x4(a[ks], swz_chunk<Cfg::LB>(line, 2 * ks + (lane >> 4)));
    }
  };
  auto issue = [&](const uint32_t (&a)[KS][4], int u) {
    const int p = u / KT, t = u % KT;
    const uint32_t row = (t * Cfg::kC + p * Cfg::KC) * ROW_B;
    wgmma_fence();
    // k16 step outermost: consecutive wgmmas write different accumulators
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t off = row + ks * 16 * ROW_B;
      if constexpr (MASK & 1) wgmma_bf16<Cfg::kCOB>(a0, a[ks], w_desc<Cfg::kCOB>(wk0 + off));
      if constexpr (MASK & 2) wgmma_bf16<Cfg::kCOB>(a1, a[ks], w_desc<Cfg::kCOB>(wk1 + off));
      if constexpr (MASK & 4) wgmma_bf16<Cfg::kCOB>(a2, a[ks], w_desc<Cfg::kCOB>(wk2 + off));
    }
    wgmma_commit();
  };
  uint32_t a[3][KS][4];
  load(a[0], 0);
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    if (u + 1 < NU) load(a[(u + 1) % 3], u + 1);  // its buffer's unit u - 2 has retired
    issue(a[u % 3], u);
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) reg_fence(a[i][ks][e]);
  if constexpr (MASK & 1) fence_tile(a0);
  if constexpr (MASK & 2) fence_tile(a1);
  if constexpr (MASK & 4) fence_tile(a2);
}

// The accumulator set c (an output slice of the tile) into the staging
// tile at `tile` in bf16: line r TM + j holds position (r, j) of the tile,
// its COB channels (LBO bytes, the TMA's swizzle of that width).  Warp w
// writes its 16 positions, lines 16 w .., its lanes g and g + 8 (the wgmma
// accumulator layout); the swizzle puts the eight lines of a store in
// eight bank groups.
template <typename Cfg>
__device__ __forceinline__ void s1_fwd_stage_out(const float (&c)[Cfg::NI][4], uint32_t tile) {
  constexpr int LBO = Cfg::kCOB * 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const uint32_t l0 = tile + (warp * 16 + g) * LBO, l1 = l0 + 8 * LBO;
#pragma unroll
  for (int ni = 0; ni < Cfg::NI; ++ni) {
    st_shared_u32(swz_chunk<LBO>(l0, ni) + 4 * tq, pack_bf16x2(c[ni][0], c[ni][1]));
    st_shared_u32(swz_chunk<LBO>(l1, ni) + 4 * tq, pack_bf16x2(c[ni][2], c[ni][3]));
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the TMA store reads it
}

// The kernel rows of tap group kd (its KT taps, C rows each) and Co tile
// cob into shared memory at `dst`: one TMA box of the (CO, C, KT, 3) view of
// the kernel, completing on `bar`.  Its COB * 2-byte rows land swizzled in
// their width, which is w_swz's layout (row r's chunk q at q ^ (r & 7) for
// 128-byte rows, q ^ ((r >> 1) & 3) for 64-byte ones): wgmma's B.
template <typename Cfg>
__device__ __forceinline__ void s1_fwd_weights(uint32_t dst, const CUtensorMap* wmap, int kd,
                                               int cob, uint32_t bar) {
  mbar_arrive_tx(bar, Cfg::KT * Cfg::kC * Cfg::kCOB * 2);
  tma_load_4d(dst, wmap, cob * Cfg::kCOB, 0, 0, kd, bar);
}

// grid (NCOB x blocks); block b of Co tile cob (b = blockIdx.x / NCOB)
// takes the work items [b per, (b + 1) per) of the `items` items (n, h
// tile, w tile, output slice d), d fastest.  `xmap`: x as (C, W, H, N D),
// box (KC, TM + 2, RH + KH - 1, 1), lines swizzled in their width; `wmap`:
// the kernel as (CO, C, KT, 3), box (COB, C, KT, 1); `ymap`: y as (CO, W,
// H, N D), box (COB, TM, RH, 1).  At KH = 1 (kernel A) D is the 2-D
// conv's H and H is 1.
template <int C, int CO, int COB, int NSLOT, int MINB, int KH>
__global__ void __launch_bounds__(256, MINB)
    s1_fwd_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap ymap, int D, int H, int W, int items,
                  int per) {
  using Cfg = S1Fwd<C, CO, COB, true, NSLOT, KH>;
  constexpr int NS = Cfg::NS, RH = Cfg::RH, TM = Cfg::TM, NI = Cfg::NI;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t w_base = smem_u32(smem);
  const uint32_t s_in = w_base + Cfg::W_BYTES;
  const uint32_t s_out = s_in + NS * Cfg::SLOT;           // two staged output tiles
  const uint32_t s_bar = s_out + 2 * Cfg::OUT_TILE;       // NS slot mbarriers
  const uint32_t w_bar = s_bar + NS * 8;                  // 3 mbarriers: the kernel rows of kd

  // the Co tiles of a range are neighbours in launch order, so the second
  // one finds the range's input slices in L2
  const int cob = blockIdx.x % Cfg::NCOB;
  const int lo = blockIdx.x / Cfg::NCOB * per, hi = min(items, lo + per);
  const int ntw = (W + TM - 1) / TM, nth = (H + RH - 1) / RH;

  // The block's k-th staged slice: its items form runs [s, e), one per
  // tile s / D, of output slices d0 .. d1 - 1, and a run stages the input
  // slices max(d0 - 1, 0) .. min(d1, D - 1) (slices -1 and D are padding).
  auto locate = [&](int k, int& tile, int& di) -> bool {
    for (int s = lo; s < hi;) {
      tile = s / D;
      const int d0 = s - tile * D, e = min(hi, (tile + 1) * D), d1 = d0 + (e - s);
      const int s_lo = max(d0 - 1, 0), n_sl = min(d1, D - 1) - s_lo + 1;
      if (k < n_sl) {
        di = s_lo + k;
        return true;
      }
      k -= n_sl;
      s = e;
    }
    return false;
  };
  // slice k into slot k % NS: one TMA box per plane, rows h0 - KH / 2 .. h0
  // + RH + KH / 2 - 1 and columns w0 - 1 .. w0 + TM of input slice di, zero
  // outside the volume
  auto issue = [&](int k) {
    int tile, di;
    if (!locate(k, tile, di)) return;
    const int tw = tile % ntw, th = tile / ntw % nth, n = tile / (ntw * nth);
    const uint32_t bar = s_bar + (k % NS) * 8, dst = s_in + (k % NS) * Cfg::SLOT;
    mbar_arrive_tx(bar, Cfg::XP * Cfg::PLANE_BYTES);
#pragma unroll
    for (int p = 0; p < Cfg::XP; ++p)
      tma_load_4d(dst + p * Cfg::PLANE_PITCH, &xmap, p * Cfg::KC, tw * TM - 1,
                  th * RH - KH / 2, n * D + di, bar);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS + 3; ++s) mbar_init(s_bar + s * 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the first slice and the kernel rows first: a run's first slice needs kd
  // = 0 (or, at d0 = 0, kd = 0 and 1), and each kd is waited for at its
  // first use, so the rest of the kernel arrives while the first taps run
  constexpr int KD_BYTES = Cfg::KT * C * COB * 2;  // the kernel rows of one kd
  if (threadIdx.x == 0) {
    issue(0);
    for (int kd = 0; kd < 3; ++kd)
      s1_fwd_weights<Cfg>(w_base + kd * KD_BYTES, &wmap, kd, cob, w_bar + kd * 8);
    for (int k = 1; k < NS; ++k) issue(k);
  }

  // the kernel rows of kd = 0, 1, 2
  const uint32_t wk0 = w_base, wk1 = w_base + KD_BYTES, wk2 = w_base + 2 * KD_BYTES;
  float a0[NI][4], a1[NI][4], a2[NI][4];
  int k = 0;
  int w_ready = 0;  // the kd whose kernel rows have arrived (bit kd)
  // Output slice m leaves through staging tile m % 2 as one TMA store,
  // issued by thread 0 after a barrier; thread 0 waits, before every
  // barrier, until the stores it issued earlier have read their tiles.  So
  // after a barrier only the latest store may still read its tile, and the
  // next slice is written to the other one.
  int m = 0;
#pragma unroll 1
  for (int s = lo; s < hi;) {
    const int tile = s / D;
    const int d0 = s - tile * D, e = min(hi, (tile + 1) * D), d1 = d0 + (e - s);
    const int tw = tile % ntw, th = tile / ntw % nth, n = tile / (ntw * nth);
    const int nd = n * D;
    zero_tile(a0);
    zero_tile(a1);
    zero_tile(a2);
#pragma unroll 1
    for (int di = max(d0 - 1, 0); di <= min(d1, D - 1); ++di, ++k) {
      while (!mbar_try_wait(s_bar + (k % NS) * 8, (k / NS) & 1)) {
      }
      const uint32_t slot = s_in + (k % NS) * Cfg::SLOT;
      // kd = 0 feeds output di + 1, kd = 1 output di, kd = 2 output di - 1
      const int mask = (d0 <= di + 1 && di + 1 < d1) | (d0 <= di && di < d1) << 1 |
                       (d0 <= di - 1 && di - 1 < d1) << 2;
      for (int kd = 0; kd < 3; ++kd)
        if ((mask & ~w_ready) >> kd & 1)
          while (!mbar_try_wait(w_bar + kd * 8, 0)) {
          }
      w_ready |= mask;
      switch (mask) {
        case 1: s1_fwd_slice<Cfg, 1>(a0, a1, a2, slot, wk0, wk1, wk2); break;
        case 2: s1_fwd_slice<Cfg, 2>(a0, a1, a2, slot, wk0, wk1, wk2); break;
        case 3: s1_fwd_slice<Cfg, 3>(a0, a1, a2, slot, wk0, wk1, wk2); break;
        case 4: s1_fwd_slice<Cfg, 4>(a0, a1, a2, slot, wk0, wk1, wk2); break;
        case 6: s1_fwd_slice<Cfg, 6>(a0, a1, a2, slot, wk0, wk1, wk2); break;
        case 7: s1_fwd_slice<Cfg, 7>(a0, a1, a2, slot, wk0, wk1, wk2); break;
        default: break;  // a run's slices are contiguous: no other mask occurs
      }
      // output di - 1 has all its slices
      if (mask & 4) s1_fwd_stage_out<Cfg>(a2, s_out + (m & 1) * Cfg::OUT_TILE);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a2[ni][q] = a1[ni][q];
          a1[ni][q] = a0[ni][q];
          a0[ni][q] = 0.0f;
        }
      // every warp is done with slot k % NS: refill it with slice k + NS
      if (threadIdx.x == 0) tma_store_wait<true>();
      __syncthreads();
      if (threadIdx.x == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue(k + NS);
        if (mask & 4)
          tma_store_4d(&ymap, s_out + (m & 1) * Cfg::OUT_TILE, cob * COB, tw * TM, th * RH,
                       nd + di - 1);
      }
      m += mask >> 2;
    }
    // a run that ends at the last slice: output D - 1 has no slice D
    if (d1 == D) {
      s1_fwd_stage_out<Cfg>(a2, s_out + (m & 1) * Cfg::OUT_TILE);
      if (threadIdx.x == 0) tma_store_wait<true>();
      __syncthreads();
      if (threadIdx.x == 0)
        tma_store_4d(&ymap, s_out + (m & 1) * Cfg::OUT_TILE, cob * COB, tw * TM, th * RH,
                     nd + D - 1);
      ++m;
    }
    s = e;
  }
  if (threadIdx.x == 0) tma_store_wait<false>();  // the tiles stay until written
}

// grid (3 kd x NCOB, h tiles x w tiles, N D); the block of (kd, Co tile
// cob, tile, n, d) adds input slice d + kd - 1's nine taps of kd into an
// f32 partial: ws[kd] (N, D, H, W, CO), channels cob COB ..; a padding
// slice gives zeros.
template <int C, int CO, int COB>
__global__ void __launch_bounds__(256, 1)
    s1_fwd_split_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap, float* __restrict__ ws, int D,
                        int H, int W, long long total) {
  using Cfg = S1Fwd<C, CO, COB, false>;
  constexpr int RH = Cfg::RH, TM = Cfg::TM, NI = Cfg::NI;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t w_base = smem_u32(smem);
  const uint32_t s_in = w_base + Cfg::W_BYTES;
  const uint32_t s_bar = s_in + Cfg::SLOT;  // the slice's mbarrier, then the kernel rows'

  const int kd = blockIdx.x % 3, cob = blockIdx.x / 3;
  const int ntw = (W + TM - 1) / TM;
  const int th = blockIdx.y / ntw, tw = blockIdx.y - th * ntw;
  const int nd = blockIdx.z, n = nd / D, di = nd - n * D + kd - 1;
  const bool valid = di >= 0 && di < D;
  if (threadIdx.x == 0) {
    mbar_init(s_bar, 1);
    mbar_init(s_bar + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  float acc[NI][4], unused[NI][4];
  zero_tile(acc);
  if (valid) {
    if (threadIdx.x == 0) {
      mbar_arrive_tx(s_bar, Cfg::XP * Cfg::PLANE_BYTES);
#pragma unroll
      for (int p = 0; p < Cfg::XP; ++p)
        tma_load_4d(s_in + p * Cfg::PLANE_PITCH, &xmap, p * Cfg::KC, tw * TM - 1, th * RH - 1,
                    n * D + di, s_bar);
      s1_fwd_weights<Cfg>(w_base, &wmap, kd, cob, s_bar + 8);
    }
    while (!mbar_try_wait(s_bar, 0) || !mbar_try_wait(s_bar + 8, 0)) {
    }
    s1_fwd_slice<Cfg, 2>(unused, acc, unused, s_in, w_base, w_base, w_base);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int h = th * RH + warp, wa = tw * TM + g, wb = wa + 8;
  if (h >= H) return;
  float* row = ws + kd * total + (static_cast<long long>(nd) * H + h) * W * CO + cob * COB + 2 * tq;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    if (wa < W)
      *reinterpret_cast<float2*>(row + static_cast<long long>(wa) * CO + ni * 8) =
          make_float2(acc[ni][0], acc[ni][1]);
    if (wb < W)
      *reinterpret_cast<float2*>(row + static_cast<long long>(wb) * CO + ni * 8) =
          make_float2(acc[ni][2], acc[ni][3]);
  }
}

// y = bf16(ws[0] + ws[1] + ws[2]), added in that order: the same bits on
// every run
static __global__ void s1_fwd_reduce(const float* __restrict__ ws, bf16* __restrict__ y,
                              long long total) {
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 2;
  if (i >= total) return;
  const float2 p0 = *reinterpret_cast<const float2*>(ws + i);
  const float2 p1 = *reinterpret_cast<const float2*>(ws + total + i);
  const float2 p2 = *reinterpret_cast<const float2*>(ws + 2 * total + i);
  *reinterpret_cast<uint32_t*>(y + i) = pack_bf16x2((p0.x + p1.x) + p2.x, (p0.y + p1.y) + p2.y);
}

// x as (C, W, H, N D) with boxes of (KC, TM + 2, RH + KH - 1, 1); the
// kernel w (3, 3, 3, C, CO) (KH = 1: (3, 3, C, CO)) as (CO, C, KT, 3) with
// boxes of (COB, C, KT, 1); y (the walk's output) as (CO, W, H, N D) with
// boxes of (COB, TM, RH, 1)
template <typename Cfg>
inline bool s1_fwd_maps(CUtensorMap* xmap, CUtensorMap* wmap, CUtensorMap* ymap, const void* x,
                        const void* w, const void* y, int N, int D, int H, int W) {
  constexpr int C = Cfg::kC, CO = Cfg::kCO;
  const cuuint64_t dims[4] = {C, static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(N) * static_cast<cuuint64_t>(D)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C) * 2,
                                 static_cast<cuuint64_t>(W) * C * 2,
                                 static_cast<cuuint64_t>(H) * W * C * 2};
  const cuuint32_t box[4] = {Cfg::KC, Cfg::COLS, Cfg::ROWS, 1};
  constexpr int KT = Cfg::KT;
  const cuuint64_t wdims[4] = {CO, C, KT, 3};
  const cuuint64_t wstrides[3] = {CO * 2, C * CO * 2, KT * C * CO * 2};
  const cuuint32_t wbox[4] = {Cfg::kCOB, C, KT, 1};
  const cuuint64_t ydims[4] = {CO, dims[1], dims[2], dims[3]};
  const cuuint64_t ystrides[3] = {static_cast<cuuint64_t>(CO) * 2,
                                  static_cast<cuuint64_t>(W) * CO * 2,
                                  static_cast<cuuint64_t>(H) * W * CO * 2};
  const cuuint32_t ybox[4] = {Cfg::kCOB, Cfg::TM, Cfg::RH, 1};
  return make_map(xmap, x, dims, strides, box, swizzle_for<Cfg::LB>()) &&
         make_map(wmap, w, wdims, wstrides, wbox, swizzle_for<Cfg::kCOB * 2>()) &&
         (ymap == nullptr ||
          make_map(ymap, y, ydims, ystrides, ybox, swizzle_for<Cfg::kCOB * 2>()));
}

// x (N, D, H, W, C) bf16, w (3, 3, 3, C, CO), y (N, D, H, W, CO); `per`
// work items per block (ops/conv3d.py k3_run).  KH = 1: x (N, D, 1, W, C),
// w (3, 3, C, CO), the 2-D conv of (N, D, W, C) (ops/conv2d.py k2_run).
template <int C, int CO, int COB, int NSLOT, int MINB, int KH = 3>
cudaError_t launch_s1_fwd(const void* x, const void* w, void* y, int N, int D, int H, int W,
                          int per, cudaStream_t stream) {
  using Cfg = S1Fwd<C, CO, COB, true, NSLOT, KH>;
  auto kernel = s1_fwd_kernel<C, CO, COB, NSLOT, MINB, KH>;
  static std::atomic<uint32_t> smem_set{0};
  cudaError_t err = set_smem_once(kernel, Cfg::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  if (N < 1 || D < 1 || H < 1 || W < 1 || per < 1) return cudaErrorInvalidValue;
  const long long items64 = static_cast<long long>(N) * ((H + Cfg::RH - 1) / Cfg::RH) *
                            ((W + Cfg::TM - 1) / Cfg::TM) * D;
  const long long blocks = (items64 + per - 1) / per;
  if (items64 > 0x7fffffff || blocks * Cfg::NCOB > 0x7fffffff) return cudaErrorInvalidValue;
  CUtensorMap xmap, wmap, ymap;
  if (!s1_fwd_maps<Cfg>(&xmap, &wmap, &ymap, x, w, y, N, D, H, W)) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks * Cfg::NCOB), Cfg::NT, Cfg::SMEM, stream>>>(
      xmap, wmap, ymap, D, H, W, static_cast<int>(items64), per);
  return cudaGetLastError();
}

// the same at 128 -> 128: the split kernel into ws (3 N D H W CO floats),
// then s1_fwd_reduce into y
template <int C, int CO, int COB>
cudaError_t launch_s1_fwd_split(const void* x, const void* w, void* y, void* ws, int N, int D,
                                int H, int W, cudaStream_t stream) {
  using Cfg = S1Fwd<C, CO, COB, false>;
  auto kernel = s1_fwd_split_kernel<C, CO, COB>;
  static std::atomic<uint32_t> smem_set{0};
  cudaError_t err = set_smem_once(kernel, Cfg::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const int tiles = ((H + Cfg::RH - 1) / Cfg::RH) * ((W + Cfg::TM - 1) / Cfg::TM);
  if (N < 1 || D < 1 || H < 1 || W < 1 || ws == nullptr || tiles > 65535 ||
      static_cast<long long>(N) * D > 65535)
    return cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  if (!s1_fwd_maps<Cfg>(&xmap, &wmap, nullptr, x, w, nullptr, N, D, H, W))
    return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(N) * D * H * W * CO;
  kernel<<<dim3(3 * Cfg::NCOB, tiles, N * D), Cfg::NT, Cfg::SMEM, stream>>>(
      xmap, wmap, static_cast<float*>(ws), D, H, W, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  s1_fwd_reduce<<<static_cast<unsigned>((total / 2 + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<bf16*>(y), total);
  return cudaGetLastError();
}

}  // namespace dsm
