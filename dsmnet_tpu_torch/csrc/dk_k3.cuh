// The weight gradient of the 3x3 (2-D, KD = 1) and 3x3x3 (3-D, KD = 3)
// convolutions of kernels A, B and C, stride S, pad 1: kernels E, F, G.
// Its instantiations: the float32 ones of E (conv2d_dk_k3.cu), F
// (conv3d_dk_k3.cu) and G (conv3d_dk_k3s2.cu), kept for the checks; E and
// F in bf16 run on s1_dk_ring.cuh, G on s2_ring.cuh.
//
//   dK[kd, kh, kw, c, o] = sum over the cotangent's positions p of
//                          x[S p + (kd, kh, kw) - 1, c] * g[p, o]
//
// x (N, Dx, Hx, Wx, C), g (N, Dg, Hg, Wg, CO), dK (KD, 3, 3, C, CO) in
// float32; a 2-D conv is the case Dx = Dg = 1.  As a GEMM: M = taps * C,
// N = CO, K = positions.
//
// A block owns one tap group (kd, kh) and one tile of COB of the CO
// output channels (COB = CO but at 128 -> 128, where 3 C CO accumulators
// would not fit the registers), so 3 C COB accumulators, and one chunk of
// the cotangent's rows (a row is one (n, d, h) line of Wg positions).  It walks its rows in segments of TW positions, RS segments
// per stage: for each segment it stages the g row segment and the x row
// segment its three kw taps read (TW + 2 columns with the halo, or, for
// S = 2, 2 TW + 1 columns split into even and odd parity planes as in
// conv_k3.cuh), zero-filled outside the volume (a ragged last segment
// stages zero cotangent columns, which add nothing), then runs the MMAs.  The
// A operand (x as M x K) lies in shared memory k-major, so it is read with
// ldmatrix.trans, and tap kw is the staged rows shifted by kw (parity
// plane and offset for S = 2): no im2col buffer.  Warps split M x N 2 x 2.
//
// Each block writes its f32 partial dK (its tap group's slice) to its own
// slot of a workspace; dk_reduce then adds the chunks' partials in chunk
// order.  No float atomics: dK is the same bits on every run.  Blocks of
// one chunk have neighbouring indices (the tap group varies fastest, then
// the Co tile), so the 3 or 9 tap groups and the Co tiles that re-read the
// same rows find them in L2.
#pragma once

#include <algorithm>

#include "conv_common.cuh"

namespace dsm {

template <typename T, int KD, int S, int C, int CO, int TW, int RS, int COB = CO>
struct DkK3 {
  static constexpr int kS = S, kC = C, kTW = TW;
  static constexpr int NCOB = CO / COB;                  // Co tiles per tap group
  static constexpr int P = pitch<T>(C);                  // staged x row pitch
  static constexpr int PB = pitch<T>(COB);               // staged g row pitch
  static constexpr int PLANE = TW + 1;                   // stride 2: slots per parity plane
  static constexpr int XLEN = (TW - 1) * S + 3;          // x columns a segment reads
  static constexpr int XROW = (S == 1 ? XLEN : 2 * PLANE) * P;
  static constexpr int GROW = TW * PB;
  static constexpr int WM = 2, WN = 2;                   // warp grid over M x N
  static constexpr int MI = 3 * C / 16 / WM;             // m16 tiles per warp
  static constexpr int NI = COB / 8 / WN;                // n8 tiles per warp
  static constexpr int TAPS = KD * 9;
  static constexpr int TOTAL = TAPS * C * CO;            // elements of dK
  static constexpr size_t SMEM = static_cast<size_t>(RS) * (XROW + GROW) * sizeof(T);
  static_assert(WM * WN == kWarps && (3 * C / 16) % WM == 0 && NI % 2 == 0,
                "tile does not fit the warps");
  static_assert(TW % 16 == 0 && C % 16 == 0 && COB % 16 == 0 && CO % COB == 0,
                "unsupported widths");
};

// column slot of tap kw's first input column in a staged x segment
template <int S, int PLANE>
__device__ inline int tap_slot(int kw) {
  return S == 1 ? kw : (kw & 1) * PLANE + (kw >> 1);
}

// One staged segment: c[MI][NI] += A (x, k-major, pitch P) x B (g, k-major,
// pitch PB).  Warp tile: m16 tiles wm * MI .. + MI - 1 of the 3 C rows
// (row m = kw * C + c), n8 tiles from g's first column, which the caller
// has offset to the warp's columns.
template <typename Cfg>
__device__ __forceinline__ void dk_tile(float (&c)[Cfg::MI][Cfg::NI][4], const bf16* sx, const bf16* sg,
                               int wm) {
  constexpr int C = Cfg::kC;
  const int lane = threadIdx.x & 31;
  // ldmatrix.x4.trans: lanes 8j..8j+7 address the 8 k-rows of matrix j,
  // whose m offset is (j & 1) * 8 and k offset (j >> 1) * 8; transposed,
  // they give the m16 x k16 A fragment.  B: ldmatrix.x4.trans of its
  // k-major rows, two n8 tiles a load.
  const int a_row = (lane & 7) + (lane >> 4) * 8;
  const int a_col = ((lane >> 3) & 1) * 8;
  const uint32_t b_addr = smem_u32(sg + (lane & 15) * Cfg::PB + (lane >> 4) * 8);
#pragma unroll 1
  for (int k0 = 0; k0 < Cfg::kTW; k0 += 16) {
    uint32_t bf[Cfg::NI][2];
#pragma unroll
    for (int np = 0; np < Cfg::NI / 2; ++np) {
      uint32_t r[4];
      ldsm_x4_trans(r, b_addr + (k0 * Cfg::PB + np * 16) * 2);
      bf[2 * np][0] = r[0];
      bf[2 * np][1] = r[1];
      bf[2 * np + 1][0] = r[2];
      bf[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < Cfg::MI; ++mi) {
      const int m = (wm * Cfg::MI + mi) * 16;
      const int kw = m / C;
      const bf16* a =
          sx + (tap_slot<Cfg::kS, Cfg::PLANE>(kw) + k0 + a_row) * Cfg::P + (m - kw * C) + a_col;
      uint32_t af[4];
      ldsm_x4_trans(af, smem_u32(a));
#pragma unroll
      for (int ni = 0; ni < Cfg::NI; ++ni) mma_bf16(c[mi][ni], af, bf[ni][0], bf[ni][1]);
    }
  }
}

// f32: the same tile as FMAs, in the fragment layout.
template <typename Cfg>
__device__ __forceinline__ void dk_tile(float (&c)[Cfg::MI][Cfg::NI][4], const float* sx, const float* sg,
                               int wm) {
  constexpr int C = Cfg::kC;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll 1
  for (int k = 0; k < Cfg::kTW; ++k) {
    const float* gk = sg + k * Cfg::PB + 2 * tq;
#pragma unroll
    for (int mi = 0; mi < Cfg::MI; ++mi) {
      const int m = (wm * Cfg::MI + mi) * 16;
      const int kw = m / C;
      const float* xk = sx + (tap_slot<Cfg::kS, Cfg::PLANE>(kw) + k) * Cfg::P + (m - kw * C) + gq;
      const float x0 = xk[0], x1 = xk[8];
#pragma unroll
      for (int ni = 0; ni < Cfg::NI; ++ni) {
        const float b0 = gk[ni * 8], b1 = gk[ni * 8 + 1];
        c[mi][ni][0] = fmaf(x0, b0, c[mi][ni][0]);
        c[mi][ni][1] = fmaf(x0, b1, c[mi][ni][1]);
        c[mi][ni][2] = fmaf(x1, b0, c[mi][ni][2]);
        c[mi][ni][3] = fmaf(x1, b1, c[mi][ni][3]);
      }
    }
  }
}

// Grid: (KD * 3 tap groups x NCOB Co tiles, chunks).  ws: chunks x TOTAL
// f32 partials.
template <typename T, int KD, int S, int C, int CO, int TW, int RS, int COB>
__global__ void __launch_bounds__(kThreads)
    dk_k3_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ ws, int Dx,
                 int Hx, int Wx, int Dg, int Hg, int Wg, int rows, int rows_per_chunk) {
  using Cfg = DkK3<T, KD, S, C, CO, TW, RS, COB>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* s_x = reinterpret_cast<T*>(smem);                  // [RS][XROW]
  T* s_g = s_x + RS * Cfg::XROW;                        // [RS][TW][PB]

  const int tg = blockIdx.x % (KD * 3);
  const int o0 = blockIdx.x / (KD * 3) * COB;           // the block's first output channel
  const int kd = tg / 3, kh = tg - kd * 3;
  const int r_lo = blockIdx.y * rows_per_chunk;
  const int r_hi = min(rows, r_lo + rows_per_chunk);
  const int nseg = (Wg + TW - 1) / TW;
  const int items = max(0, r_hi - r_lo) * nseg;
  const int warp = threadIdx.x / 32;
  const int wm = warp % Cfg::WM, wn = warp / Cfg::WM;

  float c[Cfg::MI][Cfg::NI][4];
#pragma unroll
  for (int mi = 0; mi < Cfg::MI; ++mi) zero_tile(c[mi]);

  for (int it0 = 0; it0 < items; it0 += RS) {
    const int cnt = min(RS, items - it0);
    for (int s = 0; s < cnt; ++s) {
      const int it = it0 + s;
      const int r = r_lo + it / nseg;
      const int w0 = (it - (it / nseg) * nseg) * TW;
      const int n = r / (Dg * Hg);
      const int dh = r - n * Dg * Hg;
      const int od = dh / Hg, oh = dh - od * Hg;
      const int di = KD == 1 ? 0 : od * S - 1 + kd;
      const int hi = oh * S - 1 + kh;
      const bool valid = di >= 0 && di < Dx && hi >= 0 && hi < Hx;
      const T* xrow = valid ? x + ((static_cast<long long>(n) * Dx + di) * Hx + hi) * Wx * C : x;
      stage_row<T, C, S, Cfg::PLANE>(s_x + s * Cfg::XROW, xrow, valid, w0 * S - 1, Cfg::XLEN, Wx);
      stage_row<T, COB, 1, 0, CO>(s_g + s * Cfg::GROW, g + static_cast<long long>(r) * Wg * CO + o0,
                                  true, w0, TW, Wg);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int s = 0; s < cnt; ++s)
      dk_tile<Cfg>(c, s_x + s * Cfg::XROW, s_g + s * Cfg::GROW + wn * Cfg::NI * 8, wm);
    __syncthreads();
  }

  // this block's partial: rows kw * C + c of tap group tg, columns o0 + o
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  float* out = ws + static_cast<long long>(blockIdx.y) * Cfg::TOTAL + tg * 3 * C * CO + o0;
#pragma unroll
  for (int mi = 0; mi < Cfg::MI; ++mi) {
    const int m = (wm * Cfg::MI + mi) * 16 + gq;
#pragma unroll
    for (int ni = 0; ni < Cfg::NI; ++ni) {
      const int o = (wn * Cfg::NI + ni) * 8 + 2 * tq;
      *reinterpret_cast<float2*>(out + m * CO + o) = make_float2(c[mi][ni][0], c[mi][ni][1]);
      *reinterpret_cast<float2*>(out + (m + 8) * CO + o) = make_float2(c[mi][ni][2], c[mi][ni][3]);
    }
  }
}

// dk[i] = sum over chunks, in chunk order, of ws[chunk][i] (static: each
// source that includes this header has its own copy)
static __global__ void __launch_bounds__(256)
    dk_reduce(const float* __restrict__ ws, float* __restrict__ dk, int total, int chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.0f;
  for (int c = 0; c < chunks; ++c) s += ws[static_cast<long long>(c) * total + i];
  dk[i] = s;
}

// x (N, Dx, Hx, Wx, C) and g (N, Dg, Hg, Wg, CO) with Dg = Dx, ... for S = 1
// and Dg = Dx / 2, ... for S = 2 (Dx = Dg = 1 for a 2-D conv); ws holds
// `chunks` partials of TOTAL floats.
template <typename T, int KD, int S, int C, int CO, int TW, int RS, int COB = CO>
cudaError_t launch_dk_k3(const void* x, const void* g, void* dk, void* ws, int N, int Dx, int Hx,
                         int Wx, int Dg, int Hg, int Wg, int chunks, cudaStream_t stream) {
  using Cfg = DkK3<T, KD, S, C, CO, TW, RS, COB>;
  auto kernel = dk_k3_kernel<T, KD, S, C, CO, TW, RS, COB>;
  static std::atomic<uint32_t> smem_set{0};
  cudaError_t err = set_smem_once(kernel, Cfg::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const int rows = N * Dg * Hg;
  if (rows <= 0 || chunks <= 0) return cudaErrorInvalidValue;
  chunks = std::min(chunks, rows);
  const int rows_per_chunk = (rows + chunks - 1) / chunks;
  kernel<<<dim3(KD * 3 * Cfg::NCOB, chunks), kThreads, Cfg::SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<float*>(ws), Dx, Hx, Wx, Dg,
      Hg, Wg, rows, rows_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dk_reduce<<<(Cfg::TOTAL + 255) / 256, 256, 0, stream>>>(static_cast<const float*>(ws),
                                                          static_cast<float*>(dk), Cfg::TOTAL,
                                                          chunks);
  return cudaGetLastError();
}

}  // namespace dsm
