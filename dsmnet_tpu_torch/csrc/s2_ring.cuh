// The bf16 designs of kernels C and G on the H100: the 3x3x3 stride-2
// pad-1 convolution (C in {32, 64}, Co = 64, even D/H/W) and its weight
// gradient.  Both are implicit GEMMs whose operands reach shared memory
// through TMA boxes of the (N D, H, W/2, 2C) view of x: a column pair's
// channels are contiguous, so the even columns of a row are one box at
// channel offset 0 and the odd ones one at offset C (the parity planes
// that the TPU kernel folds into its lanes, conv3d_s2_pallas.py:201-205),
// and the TMA zero-fills the padding at -1 and past the edge.  Each ring
// slot completes on an mbarrier; one thread issues the boxes, so no warp
// spends its issue slots on copies.  The TMA, mbarrier and wgmma helpers
// below also serve kernel F's ring (s1_dk_ring.cuh), kernel D's
// (deconv3d_k3s2.cu) and kernel B's (s1_fwd_ring.cuh).
//
// Kernel C (s2_fwd_kernel) walks D input-stationary, as the TPU kernel's
// parity rings do (conv3d_s2_pallas.py:129-182).  A block owns a 4 x 32
// output tile of (h, w), COB of the 64 output channels and a run of
// output D-slices d0 .. d1 - 1.  It keeps all 27 taps of its kernel
// columns resident in shared memory for the whole run (27 C COB bf16 =
// 110.6 KB at C = 32, COB = 64 and at C = 64, COB = 32), in the swizzled
// MN-major layout that wgmma reads as its B operand, and streams the input
// slices 2 d0 - 1 .. 2 d1 - 1 through a three-slot ring (C = 64: each
// slice as two 32-channel halves).  Each input slice is staged once and
// feeds every output slice it reaches: even slice 2d feeds output d
// through kd = 1; odd slice 2d + 1 feeds output d through kd = 2 and
// output d + 1 through kd = 0, both from the same A fragments.  The A
// operand of tap (kh, kw) is a shifted view of the slot, which no wgmma
// shared-memory layout describes, so each warp loads it into registers
// with ldmatrix (the next tap's while the current tap's wgmmas run) and
// issues wgmma m64nCOBk16 with A from registers.  Two accumulator tiles
// per thread; an output slice is stored from registers as soon as its
// last slice has run.  The run length comes from the wrapper
// (ops/conv3d.py s2_fwd_run), sized so the grid fills the card.
//
// Kernel G (s2_dk_kernel) computes dK as M = taps x C, N = 64, K =
// positions.  A block owns one kd and all nine (kh, kw) taps (one warp
// per tap, its C x 64 accumulators in registers, mma.sync) and a
// contiguous range of cotangent rows (n, od, w-segment, oh), walked with
// oh fastest.  For each row a slot holds the g segment and the two x rows
// 2 oh and 2 oh + 1 of slice 2 od - 1 + kd; the row 2 oh - 1 that kh = 0
// reads is the previous row's 2 oh + 1, still in the four-slot ring (or,
// at the first row of the block's range, a halo box).  So every staged row
// feeds all the taps that read it inside the block: g reaches shared
// memory 3 times (once per kd block), x 1.5 times (odd slices feed kd = 0
// and kd = 2).  The grid is (3 kd, chunks), chunks sized by the wrapper to
// the blocks that run at once; each block writes one f32 partial of its
// kd's taps and dk_reduce adds the chunks in a fixed order: the same bits
// on every run, no float atomics.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "conv_common.cuh"

namespace dsm {

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ inline uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ inline void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ inline void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ inline bool mbar_try_wait(uint32_t bar, uint32_t phase) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(phase)
      : "memory");
  return ok != 0;
}

// one TMA box of a 4-D tensor map into shared memory, completing on `bar`
__device__ inline void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2,
                                   int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, "
      "%3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ inline void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// one TMA store of a 4-D box from shared memory (clipped at the tensor's edge)
__device__ inline void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2,
                                    int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the issuing thread's TMA stores have read (READ) or written their source
template <bool READ>
__device__ inline void tma_store_wait() {
  if constexpr (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------- kernel C

// A block: RH x TM = 4 x 32 outputs of one (n, d) and COB output
// channels, two warpgroups of 64 outputs x COB (wgmma m64nCOBk16; a warp
// owns 16 outputs).  A ring slot holds one input slice's 2 RH + 1 rows as
// two parity planes of PAIRS column pairs x KC = 32 channels, each one TMA
// box of the (N D, H, W/2, 2C) view of x (the even columns at channel
// offset 0 of a pair, the odd ones at C), 64-byte rows swizzled by the TMA
// (SWIZZLE_64B).  C = 64 streams each slice as two channel halves, so the
// slot, and the tile, stay the same size.
template <int C, int COB>
struct S2Fwd {
  static constexpr int RH = 4, TM = 32, KC = 32;
  static constexpr int NT = 256;                      // 8 warps, 2 warpgroups
  static constexpr int NCOB = 64 / COB;               // column blocks of the 64 outputs
  static constexpr int NH = C / KC;                   // channel halves of a slice
  static constexpr int NR = 2 * RH + 1;               // input rows of one slice
  static constexpr int PAIRS = TM + 1;                // column pairs of a parity plane
  static constexpr int PLANE_BYTES = NR * PAIRS * KC * 2;           // one TMA box
  static constexpr int PLANE_PITCH = (PLANE_BYTES + 1023) / 1024 * 1024;
  static constexpr int STAGE_BYTES = 2 * PLANE_PITCH;
  static constexpr int NS = 3;                        // ring slots
  static constexpr int W_BYTES = 27 * C * COB * 2;    // resident kernel columns
  static constexpr int NI = COB / 8;                  // n8 tiles of a warp's accumulators
  static constexpr int KS = KC / 16;                  // k16 steps per tap and stage
  static constexpr size_t SMEM = static_cast<size_t>(W_BYTES) + NS * STAGE_BYTES + 64;
  static_assert(RH * TM == 16 * NT / 32, "a warp owns 16 outputs");
  static_assert(C % KC == 0 && (COB == 64 || COB == 32) && W_BYTES % 1024 == 0, "widths");
  static_assert(SMEM <= 232448, "shared memory");
};

// XOR swizzle of 16-byte chunk q in row r of the resident kernel, the
// 128-byte (COB = 64) and 64-byte (COB = 32) swizzles of wgmma's
// MN-major canonical layouts: rows of 128 bytes take r & 7, rows of 64
// bytes (two per 128-byte line) (r >> 1) & 3
template <int COB>
__device__ inline int w_swz(int r) {
  return COB == 64 ? (r & 7) : ((r >> 1) & 3);
}

__device__ inline void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ inline void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep a register's value where the async wgmma reads or writes it
__device__ inline void reg_fence(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ inline void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// d (m64 x N, f32, the mma.sync fragment layout per n8 tile) += a (the
// warp's m16 x k16 rows, registers) x b (k16 x N, shared memory, MN-major)
template <int N>
__device__ inline void wgmma_bf16(float (&d)[N / 8][4], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ inline void wgmma_bf16<64>(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

template <>
__device__ inline void wgmma_bf16<32>(float (&d)[4][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

template <int NI>
__device__ inline void fence_tile(float (&c)[NI][4]) {
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) reg_fence(c[ni][e]);
}

// wgmma descriptor of the resident kernel's 16 rows from shared address
// `addr`: MN-major, 8-row groups SBO bytes apart, swizzled as w_swz
template <int COB>
__device__ inline uint64_t w_desc(uint32_t addr) {
  constexpr uint64_t sbo = COB == 64 ? 1024 : 512;
  constexpr uint64_t layout = COB == 64 ? 1 : 2;  // SWIZZLE_128B, SWIZZLE_64B
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | ((sbo >> 4) << 32) | (layout << 62);
}

// One staged slice (channel half `half`, slot at shared address `slab`)
// into the accumulators: taps (kd0, kh, kw) into c0 and, when TWO, (kd1,
// kh, kw) into c1, from the same A fragments.  Each tap is one group of
// asynchronous wgmmas (KS k16 steps); the next tap's A fragments
// (ldmatrix of the shifted view) are loaded while the current one runs,
// into a third buffer, so that a wait only ever covers the tap before.
template <typename Cfg, int C, int COB, bool TWO>
__device__ __forceinline__ void s2_fwd_stage(float (&c0)[Cfg::NI][4], float (&c1)[Cfg::NI][4],
                                             uint32_t slab, uint32_t w_base, int half, int kd0,
                                             int kd1) {
  constexpr int KS = Cfg::KS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  // this warp's 16 outputs: row r, columns j0 .. j0 + 15 of the tile; the
  // 64-byte line (row 2 r + kh, pair j + (kw >> 1)) of a plane that lane's
  // A row reads at kh = kw = 0
  const int r = warp * 16 / Cfg::TM, j0 = warp * 16 - r * Cfg::TM;
  const int a_line = r * 2 * Cfg::PAIRS + j0 + (lane & 15);
  const uint32_t b_rows = w_base + half * Cfg::KC * COB * 2;

  auto load = [&](uint32_t (&a)[KS][4], int t) {
    const int kh = t / 3, kw = t - kh * 3;
    // SWIZZLE_64B: 16-byte chunk q of a 64-byte line sits at q ^ (address
    // bits 7-8)
    const uint32_t line = slab + (kw & 1) * Cfg::PLANE_PITCH +
                          (a_line + kh * Cfg::PAIRS + (kw >> 1)) * 64;
    const uint32_t swz = (line >> 7) & 3;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) reg_fence(a[ks][e]);  // its last wgmma has retired
      ldsm_x4(a[ks], line + ((((lane >> 4) + 2 * ks) ^ swz) << 4));
    }
  };
  auto issue = [&](const uint32_t (&a)[KS][4], int t) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      wgmma_bf16<COB>(c0, a[ks],
                      w_desc<COB>(b_rows + ((kd0 * 9 + t) * C + ks * 16) * COB * 2));
      if constexpr (TWO)
        wgmma_bf16<COB>(c1, a[ks], w_desc<COB>(b_rows + ((kd1 * 9 + t) * C + ks * 16) * COB * 2));
    }
    wgmma_commit();
  };
  uint32_t a[3][KS][4];
  load(a[0], 0);
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    if (t + 1 < 9) load(a[(t + 1) % 3], t + 1);  // its buffer's tap t - 2 has retired
    issue(a[t % 3], t);
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) reg_fence(a[i][ks][e]);
  fence_tile(c0);
  if constexpr (TWO) fence_tile(c1);
}

// grid (NCOB * ceil(Wo / TM), ceil(Ho / RH), N * runs); block NT threads.
// `xmap` is the TMA map of x as (2C, W/2, H, N D), box (KC, PAIRS, NR, 1).
template <int C, int COB>
__global__ void __launch_bounds__(S2Fwd<C, COB>::NT, 1)
    s2_fwd_kernel(const __grid_constant__ CUtensorMap xmap, const bf16* __restrict__ w,
                  bf16* __restrict__ y, int Di, int Do, int Ho, int Wo, int run, int runs) {
  using Cfg = S2Fwd<C, COB>;
  constexpr int NT = Cfg::NT, NH = Cfg::NH, NS = Cfg::NS, RH = Cfg::RH, TM = Cfg::TM;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* s_w = reinterpret_cast<bf16*>(smem);
  const uint32_t s_in = smem_u32(smem + Cfg::W_BYTES);
  const uint32_t s_bar = s_in + NS * Cfg::STAGE_BYTES;      // NS mbarriers

  // the Co blocks of a tile are neighbours in launch order, so the second
  // one finds the tile's input slices in L2
  const int cob = blockIdx.x % Cfg::NCOB;
  const int wo0 = blockIdx.x / Cfg::NCOB * TM, ho0 = blockIdx.y * RH;
  const int n = blockIdx.z / runs;
  const int d0 = (blockIdx.z - n * runs) * run;
  const int d1 = min(Do, d0 + run);
  const int nst = (2 * (d1 - d0) + 1) * NH;  // stages: input slices 2 d0 - 1 .. 2 d1 - 1, halves
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;

  // stage u: input slice 2 d0 - 1 + u / NH, channel half u % NH, into slot
  // u % NS: two TMA boxes (odd columns from pair wo0 - 1, even ones from
  // pair wo0), zero outside the volume; slice -1 (padding) only arrives
  auto issue = [&](int u) {
    const int di = 2 * d0 - 1 + u / NH, half = u % NH;
    const uint32_t bar = s_bar + (u % NS) * 8;
    if (di < 0) {
      mbar_arrive_tx(bar, 0);
      return;
    }
    const uint32_t dst = s_in + (u % NS) * Cfg::STAGE_BYTES;
    mbar_arrive_tx(bar, 2 * Cfg::PLANE_BYTES);
    const int nd = n * Di + di, h0 = 2 * ho0 - 1;
    tma_load_4d(dst, &xmap, C + half * Cfg::KC, wo0 - 1, h0, nd, bar);
    tma_load_4d(dst + Cfg::PLANE_PITCH, &xmap, half * Cfg::KC, wo0, h0, nd, bar);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(s_bar + s * 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int u = 0; u < min(NS, nst); ++u) issue(u);
  // the block's kernel columns, all 27 taps (row r = tap * C + c, COB wide)
  {
    constexpr int Q = COB / 8;
    const bf16* src = w + cob * COB;
    for (int i = threadIdx.x; i < 27 * C * Q; i += NT) {
      const int r = i / Q, q = i - (i / Q) * Q;
      cp_async16(s_w + r * COB + ((q ^ w_swz<COB>(r)) * 8),
                 src + static_cast<long long>(r) * 64 + q * 8, true);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  float c0[Cfg::NI][4], c1[Cfg::NI][4];
  zero_tile(c0);
  zero_tile(c1);
  const uint32_t w_base = smem_u32(s_w);
  const int g = lane >> 2, tq = lane & 3;

#pragma unroll 1
  for (int u = 0; u < nst; ++u) {
    while (!mbar_try_wait(s_bar + (u % NS) * 8, (u / NS) & 1)) {
    }
    const uint32_t slab = s_in + (u % NS) * Cfg::STAGE_BYTES;
    const int i = u / NH, half = u % NH;
    const bool last = u + NH >= nst;
    if (i == 0) {
      if (d0 > 0) s2_fwd_stage<Cfg, C, COB, false>(c0, c1, slab, w_base, half, 0, 0);
    } else if (i & 1) {
      s2_fwd_stage<Cfg, C, COB, false>(c0, c1, slab, w_base, half, 1, 1);
    } else {
      if (!last)
        s2_fwd_stage<Cfg, C, COB, true>(c0, c1, slab, w_base, half, 2, 0);
      else
        s2_fwd_stage<Cfg, C, COB, false>(c0, c1, slab, w_base, half, 2, 2);
      if (half == NH - 1) {
        // output slice d0 + i / 2 - 1 is complete: store it from registers
        const int d = d0 + i / 2 - 1;
        bf16* ys = y + (static_cast<long long>(n) * Do + d) * Ho * Wo * 64 + cob * COB + 2 * tq;
        const int r = warp * 16 / TM;
        const int ho = ho0 + r;
        const int wa = wo0 + warp * 16 - r * TM + g, wb = wa + 8;
#pragma unroll
        for (int ni = 0; ni < Cfg::NI; ++ni) {
          if (ho < Ho && wa < Wo)
            *reinterpret_cast<uint32_t*>(ys + (static_cast<long long>(ho) * Wo + wa) * 64 +
                                         ni * 8) = pack_bf16x2(c0[ni][0], c0[ni][1]);
          if (ho < Ho && wb < Wo)
            *reinterpret_cast<uint32_t*>(ys + (static_cast<long long>(ho) * Wo + wb) * 64 +
                                         ni * 8) = pack_bf16x2(c0[ni][2], c0[ni][3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            c0[ni][e] = c1[ni][e];
            c1[ni][e] = 0.0f;
          }
        }
      }
    }
    // every warp is done with slot u % NS: refill it with stage u + NS
    __syncthreads();
    if (threadIdx.x == 0 && u + NS < nst) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(u + NS);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// x (N, Di, Hi, Wi, C) bf16, w (3, 3, 3, C, 64), y (N, Di/2, Hi/2, Wi/2, 64);
// `run` output D-slices per block
template <int C, int COB>
cudaError_t launch_s2_fwd(const void* x, const void* w, void* y, int N, int Di, int Hi, int Wi,
                          int run, cudaStream_t stream) {
  using Cfg = S2Fwd<C, COB>;
  auto kernel = s2_fwd_kernel<C, COB>;
  static std::atomic<uint32_t> smem_set{0};
  cudaError_t err = set_smem_once(kernel, Cfg::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const int Do = Di / 2, Ho = Hi / 2, Wo = Wi / 2;
  if (run < 1 || N < 1 || Do < 1) return cudaErrorInvalidValue;
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  // x as (2C, W/2, H, N D): a column pair's channels, pairs, rows, slices
  CUtensorMap xmap;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(2 * C), static_cast<cuuint64_t>(Wi / 2),
                              static_cast<cuuint64_t>(Hi),
                              static_cast<cuuint64_t>(N) * static_cast<cuuint64_t>(Di)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(2 * C) * 2,
                                 static_cast<cuuint64_t>(Wi) * C * 2,
                                 static_cast<cuuint64_t>(Hi) * Wi * C * 2};
  const cuuint32_t box[4] = {Cfg::KC, Cfg::PAIRS, Cfg::NR, 1};
  const cuuint32_t estrides[4] = {1, 1, 1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box,
             estrides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const int runs = (Do + run - 1) / run;
  const dim3 grid(Cfg::NCOB * ((Wo + Cfg::TM - 1) / Cfg::TM), (Ho + Cfg::RH - 1) / Cfg::RH,
                  N * runs);
  kernel<<<grid, Cfg::NT, Cfg::SMEM, stream>>>(xmap, static_cast<const bf16*>(w),
                                                static_cast<bf16*>(y), Di, Do, Ho, Wo, run, runs);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- kernel G

// A block: one kd, nine warps (one per (kh, kw) tap, its C x 64
// accumulators in registers).  A ring slot holds one cotangent row: the x
// rows 2 oh and 2 oh + 1 of slice 2 od - 1 + kd as two parity planes of
// PAIRS column pairs x C channels (TMA boxes of the (N D, H, W/2, 2C) view,
// as kernel C's, swizzled in C * 2-byte lines), and the g segment of TW
// positions x 64 channels (a TMA box of the (N Dg, Hg, Wg, 64) view,
// SWIZZLE_128B).
template <int C, int TW>
struct S2Dk {
  static constexpr int kTW = TW;
  static constexpr int NT = 9 * 32;
  static constexpr int CO = 64;
  static constexpr int PAIRS = TW + 1;                // column pairs a segment reads
  static constexpr int LB = C * 2;                    // bytes of an x line (one column)
  static constexpr int PLANE_BYTES = 2 * PAIRS * LB;  // x rows 2 oh, 2 oh + 1 of one parity
  static constexpr int PLANE_PITCH = (PLANE_BYTES + 1023) / 1024 * 1024;
  static constexpr int G_BYTES = TW * CO * 2;
  static constexpr int STAGE_BYTES = 2 * PLANE_PITCH + G_BYTES;
  static constexpr int NS = 4;                        // ring slots
  static constexpr int LEAD = NS - 1;                 // rows in flight
  static constexpr int MI = C / 16;
  static constexpr int NI = CO / 8;
  static constexpr int TOTAL = 27 * C * CO;
  // the ring, the halo planes (rows 2 oh - 1, 2 oh of the first row), NS
  // mbarriers
  static constexpr size_t SMEM = static_cast<size_t>(NS) * STAGE_BYTES + 2 * PLANE_PITCH + 64;
  static_assert(TW % 16 == 0 && (C == 32 || C == 64) && G_BYTES % 1024 == 0, "widths");
};

// 16-byte chunk q of the `lb`-byte line at shared address `line`, under the
// TMA's SWIZZLE_64B (lb = 64) or SWIZZLE_128B (lb = 128)
template <int LB>
__device__ inline uint32_t swz_chunk(uint32_t line, int q) {
  return line + ((q ^ ((line >> 7) & (LB / 16 - 1))) << 4);
}

// One staged row into a warp's tap: c += x_tap (C x TW, k-major; plane at
// `xp`, its line 0 the segment's first pair of the right x row) g (TW x 64)
template <typename Cfg>
__device__ __forceinline__ void s2_dk_row(float (&c)[Cfg::MI][Cfg::NI][4], uint32_t xp,
                                          uint32_t sg, int kw) {
  const int lane = threadIdx.x & 31;
  // ldmatrix.x4.trans as in dk_k3.cuh: matrix j covers m offset (j & 1) * 8
  // and k offset (j >> 1) * 8 of the m16 x k16 A fragment
  const int a_row = (lane & 7) + (lane >> 4) * 8 + (kw >> 1);
  const int a_chunk = (lane >> 3) & 1;
  // all of a step's fragments are loaded before its MMAs are issued
#pragma unroll
  for (int k0 = 0; k0 < Cfg::kTW; k0 += 16) {
    uint32_t bf[Cfg::NI / 2][4];
    const uint32_t g_line = sg + (k0 + (lane & 15)) * 128;
#pragma unroll
    for (int np = 0; np < Cfg::NI / 2; ++np)
      ldsm_x4_trans(bf[np], swz_chunk<128>(g_line, 2 * np + (lane >> 4)));
    uint32_t af[Cfg::MI][4];
    const uint32_t x_line = xp + (k0 + a_row) * Cfg::LB;
#pragma unroll
    for (int mi = 0; mi < Cfg::MI; ++mi)
      ldsm_x4_trans(af[mi], swz_chunk<Cfg::LB>(x_line, 2 * mi + a_chunk));
#pragma unroll
    for (int mi = 0; mi < Cfg::MI; ++mi)
#pragma unroll
      for (int np = 0; np < Cfg::NI / 2; ++np) {
        mma_bf16(c[mi][2 * np], af[mi], bf[np][0], bf[np][1]);
        mma_bf16(c[mi][2 * np + 1], af[mi], bf[np][2], bf[np][3]);
      }
  }
}

// grid (3 kd, chunks); chunk b sums cotangent rows [b * per, (b + 1) * per)
// of the `items` rows (n, od, segment, oh), oh fastest, into ws[b].  Thread
// 0 keeps the next LEAD rows' TMA boxes in flight.  `xmap`: x as (2C,
// Wx/2, Hx, N Dx), box (C, PAIRS, 2, 1); `gmap`: g as (64, Wg, Hg, N Dg),
// box (64, TW, 1, 1).
template <int C, int TW, int MINB>
__global__ void __launch_bounds__(S2Dk<C, TW>::NT, MINB)
    s2_dk_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap gmap,
                 float* __restrict__ ws, int Dx, int Dg, int Hg, int nseg, int items, int per) {
  using Cfg = S2Dk<C, TW>;
  constexpr int NS = Cfg::NS, LEAD = Cfg::LEAD;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t s_ring = smem_u32(smem);
  const uint32_t s_halo = s_ring + NS * Cfg::STAGE_BYTES;   // rows 2 oh - 1, 2 oh
  const uint32_t s_bar = s_halo + 2 * Cfg::PLANE_PITCH;

  const int kd = blockIdx.x;
  const int i_lo = blockIdx.y * per;
  const int i_hi = min(items, i_lo + per);
  const int tap = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int kh = tap / 3, kw = tap - kh * 3;

  // both parity planes of x rows h, h + 1 of slice di (odd columns from
  // pair w0 - 1, even ones from pair w0), zeros outside the volume
  auto x_planes = [&](uint32_t dst, int n, int di, int h, int w0, uint32_t bar) {
    tma_load_4d(dst, &xmap, C, w0 - 1, h, n * Dx + di, bar);
    tma_load_4d(dst + Cfg::PLANE_PITCH, &xmap, 0, w0, h, n * Dx + di, bar);
  };
  // row it into slot (it - i_lo) % NS (the first row also brings the halo)
  auto issue = [&](int it) {
    const int slot = (it - i_lo) % NS;
    const uint32_t bar = s_bar + slot * 8, dst = s_ring + slot * Cfg::STAGE_BYTES;
    // row it is (n, od, w-segment, oh), oh fastest
    const int line = it / Hg, oh = it - line * Hg;
    const int nd = line / nseg, w0 = (line - nd * nseg) * TW;
    const int n = nd / Dg, od = nd - n * Dg;
    const int di = 2 * od - 1 + kd;  // slice -1 is padding: its rows are skipped
    const bool halo = it == i_lo && oh > 0 && di >= 0;
    mbar_arrive_tx(bar, (di >= 0 ? 2 * Cfg::PLANE_BYTES : 0) + (halo ? 2 * Cfg::PLANE_BYTES : 0) +
                            Cfg::G_BYTES);
    if (di >= 0) x_planes(dst, n, di, 2 * oh, w0, bar);
    if (halo) x_planes(s_halo, n, di, 2 * oh - 1, w0, bar);
    tma_load_4d(dst + 2 * Cfg::PLANE_PITCH, &gmap, 0, w0, oh, n * Dg + od, bar);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(s_bar + s * 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int it = i_lo; it < min(i_hi, i_lo + LEAD); ++it) issue(it);

  float c[Cfg::MI][Cfg::NI][4];
#pragma unroll
  for (int mi = 0; mi < Cfg::MI; ++mi) zero_tile(c[mi]);

#pragma unroll 1
  for (int it = i_lo; it < i_hi; ++it) {
    const int k = it - i_lo;
    while (!mbar_try_wait(s_bar + (k % NS) * 8, (k / NS) & 1)) {
    }
    const int line = it / Hg;
    const int oh = it - line * Hg;
    const int od = (line / nseg) % Dg;
    const uint32_t cur = s_ring + (k % NS) * Cfg::STAGE_BYTES;
    // the plane (kw & 1) holding x row 2 oh - 1 + kh, at its first pair:
    // kh = 1, 2 this row's rows; kh = 0 the previous row's 2 oh + 1 (or
    // the halo's row 0 at the start of the range); padding at oh = 0
    const uint32_t par = (kw & 1) * Cfg::PLANE_PITCH;
    const uint32_t row_bytes = Cfg::PAIRS * Cfg::LB;
    const uint32_t xp = kh == 1 ? cur + par
                        : kh == 2 ? cur + par + row_bytes
                        : k == 0  ? s_halo + par
                                  : s_ring + ((k + NS - 1) % NS) * Cfg::STAGE_BYTES + par + row_bytes;
    if (2 * od - 1 + kd >= 0 && (kh > 0 || oh > 0))
      s2_dk_row<Cfg>(c, xp, cur + 2 * Cfg::PLANE_PITCH, kw);
    // every warp is done with row it - 1's slot: refill it with row it + LEAD
    __syncthreads();
    if (threadIdx.x == 0 && it + LEAD < i_hi) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(it + LEAD);
    }
  }

  // this block's partial: rows (kd, kh, kw, c), columns o
  const int gq = lane >> 2, tq = lane & 3;
  float* out = ws + static_cast<long long>(blockIdx.y) * Cfg::TOTAL + (kd * 9 + tap) * C * 64;
#pragma unroll
  for (int mi = 0; mi < Cfg::MI; ++mi) {
    const int m = mi * 16 + gq;
#pragma unroll
    for (int ni = 0; ni < Cfg::NI; ++ni) {
      const int o = ni * 8 + 2 * tq;
      *reinterpret_cast<float2*>(out + m * 64 + o) = make_float2(c[mi][ni][0], c[mi][ni][1]);
      *reinterpret_cast<float2*>(out + (m + 8) * 64 + o) = make_float2(c[mi][ni][2], c[mi][ni][3]);
    }
  }
}

// the TMA swizzle of LB-byte lines (LB = 32, 64 or 128)
template <int LB>
constexpr CUtensorMapSwizzle swizzle_for() {
  return LB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                   : LB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
}

// a 4-D bf16 tensor map (dims innermost first, strides of dims 1-3 in
// bytes) with box `box` and the given swizzle; false if it cannot be made
inline bool make_map(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[4],
                     const cuuint64_t (&strides)[3], const cuuint32_t (&box)[4],
                     CUtensorMapSwizzle swizzle) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  const cuuint32_t estrides[4] = {1, 1, 1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// x (N, Dx, Hx, Wx, C) and g (N, Dx/2, Hx/2, Wx/2, 64) bf16; ws holds
// `chunks` partials of 27 C 64 floats; `reduce` adds them into dk.
template <int C, int TW, int MINB, typename Reduce>
cudaError_t launch_s2_dk(const void* x, const void* g, void* dk, void* ws, int N, int Dx, int Hx,
                         int Wx, int chunks, Reduce reduce, cudaStream_t stream) {
  using Cfg = S2Dk<C, TW>;
  auto kernel = s2_dk_kernel<C, TW, MINB>;
  static std::atomic<uint32_t> smem_set{0};
  cudaError_t err = set_smem_once(kernel, Cfg::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const int Dg = Dx / 2, Hg = Hx / 2, Wg = Wx / 2;
  const int nseg = (Wg + TW - 1) / TW;
  const int items = N * Dg * nseg * Hg;
  if (items <= 0 || chunks <= 0 || chunks > items) return cudaErrorInvalidValue;
  const int per = (items + chunks - 1) / chunks;
  CUtensorMap xmap, gmap;
  const cuuint64_t xdims[4] = {static_cast<cuuint64_t>(2 * C), static_cast<cuuint64_t>(Wg),
                               static_cast<cuuint64_t>(Hx),
                               static_cast<cuuint64_t>(N) * static_cast<cuuint64_t>(Dx)};
  const cuuint64_t xstrides[3] = {static_cast<cuuint64_t>(2 * C) * 2,
                                  static_cast<cuuint64_t>(Wx) * C * 2,
                                  static_cast<cuuint64_t>(Hx) * Wx * C * 2};
  const cuuint32_t xbox[4] = {C, Cfg::PAIRS, 2, 1};
  const cuuint64_t gdims[4] = {64, static_cast<cuuint64_t>(Wg), static_cast<cuuint64_t>(Hg),
                               static_cast<cuuint64_t>(N) * static_cast<cuuint64_t>(Dg)};
  const cuuint64_t gstrides[3] = {64 * 2, static_cast<cuuint64_t>(Wg) * 64 * 2,
                                  static_cast<cuuint64_t>(Hg) * Wg * 64 * 2};
  const cuuint32_t gbox[4] = {64, TW, 1, 1};
  if (!make_map(&xmap, x, xdims, xstrides, xbox,
                C == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&gmap, g, gdims, gstrides, gbox, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  kernel<<<dim3(3, chunks), Cfg::NT, Cfg::SMEM, stream>>>(xmap, gmap, static_cast<float*>(ws), Dx,
                                                          Dg, Hg, nseg, items, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce<<<(Cfg::TOTAL + 255) / 256, 256, 0, stream>>>(static_cast<const float*>(ws),
                                                       static_cast<float*>(dk), Cfg::TOTAL, chunks);
  return cudaGetLastError();
}

}  // namespace dsm
