// The 3x3 (2-D, KD = 1) and 3x3x3 (3-D, KD = 3) convolution of the float32
// A, B and C (their bf16 designs are s1_fwd_ring.cuh and s2_ring.cuh):
// stride S in every spatial dim, pad 1, no bias.
// x (N, Di, Hi, Wi, C), w (KD, 3, 3, C, CO), y (N, Do, Ho, Wo, CO); a 2-D
// conv is the case Di = Do = 1.
//
// A block owns RH output rows (H) x TM output columns (W) of one (n, d)
// slice and all CO channels: M = RH * TM GEMM rows, m = r * TM + j.  Warp
// w owns the m16 tiles w, w + 4, ... and all CO channels.  For each kd the
// block stages the NR input rows its outputs read (TM outputs read
// (TM - 1) * S + 3 columns), then the kernel slices TG taps at a time (9 =
// the whole kd slice, 3 = one kh row, 1 = one tap, for wide C and CO), and
// runs the taps: the A operand of tap (kh, kw) is a shifted view of the
// staged rows, so no im2col buffer is built.  A stride-2 row is staged in
// two parity planes (even columns, then odd), which keeps every tap's
// rows consecutive in shared memory.
#pragma once

#include "conv_common.cuh"

namespace dsm {

template <typename T, int KD, int S, int C, int CO, int TM, int RH, int TG>
struct ConvK3 {
  static constexpr int P = pitch<T>(C);
  static constexpr int PB = pitch<T>(CO);
  static constexpr int OP = CO + 4;                      // f32 output tile pitch
  static constexpr int LW = (TM - 1) * S + 3;            // input columns staged per row
  static constexpr int PLANE = TM + 1;                   // stride 2: slots per parity plane
  static constexpr int ROW = (S == 1 ? LW : 2 * PLANE) * P;
  static constexpr int NR = (RH - 1) * S + 3;            // input rows staged per kd
  static constexpr int IN_ELEMS = NR * ROW;
  static constexpr int W_ELEMS = TG * C * PB;
  static constexpr int M = RH * TM;
  static constexpr int MI = M / 16 / kWarps;             // m16 tiles per warp
  static constexpr int NI = CO / 8;                      // n8 tiles per warp
  static constexpr size_t SMEM = max_size((IN_ELEMS + W_ELEMS) * sizeof(T),
                                          static_cast<size_t>(M) * OP * sizeof(float));
  static_assert(TM % 16 == 0 && M % (16 * kWarps) == 0, "tile does not fit the warps");
  static_assert(C % 16 == 0 && CO % 16 == 0 && 9 % TG == 0, "unsupported widths");
};

template <typename T, int KD, int S, int C, int CO, int TM, int RH, int TG>
__global__ void __launch_bounds__(kThreads)
    conv_k3_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int Di,
                   int Hi, int Wi, int Do, int Ho, int Wo) {
  using Cfg = ConvK3<T, KD, S, C, CO, TM, RH, TG>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* s_in = reinterpret_cast<T*>(smem);
  T* s_w = s_in + Cfg::IN_ELEMS;
  float* s_out = reinterpret_cast<float*>(smem);

  const int m0 = blockIdx.x * TM;
  const int ho0 = blockIdx.y * RH;
  const int n = blockIdx.z / Do;
  const int dout = blockIdx.z - n * Do;
  const int warp = threadIdx.x / 32;

  float c[Cfg::MI][Cfg::NI][4];
#pragma unroll
  for (int mi = 0; mi < Cfg::MI; ++mi) zero_tile(c[mi]);

  for (int kd = 0; kd < KD; ++kd) {
    const int di = KD == 1 ? 0 : dout * S - 1 + kd;
    if (di < 0 || di >= Di) continue;  // the whole kd slice is zero padding
    for (int r = 0; r < Cfg::NR; ++r) {
      const int hi = ho0 * S - 1 + r;
      const bool valid = hi >= 0 && hi < Hi;
      const T* row = valid ? x + ((static_cast<long long>(n) * Di + di) * Hi + hi) * Wi * C : x;
      stage_row<T, C, S, Cfg::PLANE>(s_in + r * Cfg::ROW, row, valid, m0 * S - 1, Cfg::LW, Wi);
    }
#pragma unroll 1
    for (int t0 = 0; t0 < 9; t0 += TG) {
      stage_matrix<T, CO>(s_w, w + static_cast<long long>(kd * 9 + t0) * C * CO, TG * C);
      cp_async_wait_all();
      __syncthreads();
#pragma unroll 1
      for (int t = 0; t < TG; ++t) {
        const int kh = (t0 + t) / 3;
        const int kw = (t0 + t) % 3;
        const int col = S == 1 ? kw : (kw & 1) * Cfg::PLANE + (kw >> 1);
        const T* b = s_w + t * C * Cfg::PB;
#pragma unroll
        for (int mi = 0; mi < Cfg::MI; ++mi) {
          const int mt = (warp + mi * kWarps) * 16;
          const int r = mt / TM;
          const T* a = s_in + (r * S + kh) * Cfg::ROW + (mt - r * TM + col) * Cfg::P;
          tile_mma<C, Cfg::P, Cfg::PB, Cfg::NI, true>(c[mi], a, b);
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int mi = 0; mi < Cfg::MI; ++mi)
    store_tile<Cfg::NI, Cfg::OP>(s_out, c[mi], (warp + mi * kWarps) * 16, 1, 0);
  __syncthreads();
  T* yslice = y + (static_cast<long long>(n) * Do + dout) * Ho * Wo * CO;
  write_rows<T, CO, Cfg::OP>(s_out, Cfg::M, [&](int m) -> T* {
    const int r = m / TM;
    const int ho = ho0 + r, wo = m0 + m - r * TM;
    return ho < Ho && wo < Wo ? yslice + (static_cast<long long>(ho) * Wo + wo) * CO : nullptr;
  });
}

template <typename T, int KD, int S, int C, int CO, int TM, int RH, int TG>
cudaError_t launch_conv_k3(const void* x, const void* w, void* y, int N, int Di, int Hi, int Wi,
                           int Do, int Ho, int Wo, cudaStream_t stream) {
  using Cfg = ConvK3<T, KD, S, C, CO, TM, RH, TG>;
  auto kernel = conv_k3_kernel<T, KD, S, C, CO, TM, RH, TG>;
  static std::atomic<uint32_t> smem_set{0};
  const cudaError_t err = set_smem_once(kernel, Cfg::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((Wo + TM - 1) / TM, (Ho + RH - 1) / RH, N * Do);
  kernel<<<grid, kThreads, Cfg::SMEM, stream>>>(static_cast<const T*>(x),
                                                 static_cast<const T*>(w), static_cast<T*>(y),
                                                 Di, Hi, Wi, Do, Ho, Wo);
  return cudaGetLastError();
}

}  // namespace dsm
