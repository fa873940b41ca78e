// Kernel D: 3x3x3 stride-2 transposed 3-D convolution with torch geometry
// padding 1, output_padding 1 (an exact 2x upsample), no bias,
// Cin = 64 -> Cout = 32, on the flax transpose kernel k (3, 3, 3, Cout, Cin).
//
// Replaces the TPU kernel conv3d_s2_dx_pallas_folded
// (dsmnet_tpu/ops/conv3d_s2_pallas.py:570), which PSMNet's inference runs
// as the hourglass conv6 deconv (dsmnet_tpu/ops/folded.py:319-330):
// (N, 24, 48, 96, 64) -> (N, 48, 96, 192, 32) at 384x768, D = 192.
//
// Semantics (lax.conv_transpose with pads (1, 2) and transpose_kernel,
// dsmnet_tpu/ops/conv3d.py:433): y[2u + s - 1] += k[s] . x[u] per axis,
// i.e. per output parity p and m = o // 2
//     p = 0:  y[2m]     = k[1] . x[m]
//     p = 1:  y[2m + 1] = k[2] . x[m] + k[0] . x[m + 1]   (x[m + 1] = 0 past the end)
// and the 3-D tap set of an output is the product of its three axes'
// sets.  The kernel is output-stationary: a block owns one output row
// (od, oh), whose D and H parities fix its <= 2 x 2 input rows, and the
// 2 TM outputs of input columns m0 .. m0 + TM - 1 in both W parities.
// Each warp computes both W parities of its 16 input columns, so the
// x[m] operand is loaded once for k[1] (p = 0) and k[2] (p = 1) and the
// warps stay balanced.  Nothing is scattered: no output is written
// twice and no atomics are needed.  Input columns past the ragged W edge
// are staged as zeros and their outputs are not written.
//
// What bounds it on the H100: the output has 8x the input's voxels, so
// 2 * 27 * 64 * 32 FLOP per input voxel against 1 input and 8 output
// voxels of bf16 is ~170 FLOP/byte, below the ~295 FLOP/byte ridge: the
// memory traffic bounds it.  A block's 2 TM outputs form one contiguous
// run of the output row, written once with 16-byte stores.
#include "conv_common.cuh"

namespace {

using dsm::bf16;
using dsm::kWarps;

template <typename T, int CI, int CO, int TM>
struct DeconvK3S2 {
  static constexpr int P = dsm::pitch<T>(CI);
  static constexpr int PB = dsm::pitch<T>(CI);  // kernel slices are [Cout][Cin]
  static constexpr int OP = CO + 4;
  static constexpr int ROW = (TM + 1) * P;      // TM columns and the x[m + 1] halo
  static constexpr int IN_ELEMS = 4 * ROW;
  static constexpr int W_ELEMS = 3 * CO * PB;
  static constexpr int JT = TM / 16;             // warps along the input columns
  static constexpr int WN = kWarps / JT;         // warps along the output channels
  static constexpr int NI = CO / WN / 8;
  static constexpr size_t SMEM = dsm::max_size((IN_ELEMS + W_ELEMS) * sizeof(T),
                                               static_cast<size_t>(2 * TM) * OP * sizeof(float));
  static_assert(TM % 16 == 0 && JT * WN == kWarps && NI % 2 == 0, "tile does not fit the warps");
};

// kernel index of tap j (0: input m, 1: input m + 1) of an output of parity p
__device__ inline int tap_index(int p, int j) { return p == 0 ? 1 : (j == 0 ? 2 : 0); }

// Grid: (ceil(Wi / TM), Ho, N * Do).
template <typename T, int CI, int CO, int TM>
__global__ void __launch_bounds__(dsm::kThreads)
    deconv_k3s2_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int Di,
                       int Hi, int Wi) {
  using Cfg = DeconvK3S2<T, CI, CO, TM>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* s_in = reinterpret_cast<T*>(smem);  // [a * 2 + b][TM + 1][P]
  T* s_w = s_in + Cfg::IN_ELEMS;         // [w tap][Cout][PB]
  float* s_out = reinterpret_cast<float*>(smem);

  const int Do = 2 * Di, Ho = 2 * Hi, Wo = 2 * Wi;
  const int m0 = blockIdx.x * TM;
  const int oh = blockIdx.y;
  const int n = blockIdx.z / Do;
  const int od = blockIdx.z - n * Do;
  const int pd = od & 1, md = od >> 1;
  const int ph = oh & 1, mh = oh >> 1;
  const int nd = pd + 1, nh = ph + 1;
  const int warp = threadIdx.x / 32;
  const int jt = warp % Cfg::JT, wn = warp / Cfg::JT;

  for (int a = 0; a < nd; ++a) {
    for (int b = 0; b < nh; ++b) {
      const int ud = md + a, uh = mh + b;
      const bool valid = ud < Di && uh < Hi;
      const T* row = valid ? x + ((static_cast<long long>(n) * Di + ud) * Hi + uh) * Wi * CI : x;
      dsm::stage_row<T, CI, 1, 0>(s_in + (a * 2 + b) * Cfg::ROW, row, valid, m0, TM + 1, Wi);
    }
  }

  float c0[Cfg::NI][4], c1[Cfg::NI][4];  // W parity 0 and 1
  dsm::zero_tile(c0);
  dsm::zero_tile(c1);
#pragma unroll 1
  for (int ab = 0; ab < nd * nh; ++ab) {
    const int a = ab / nh, b = ab - a * nh;
    const int s = tap_index(pd, a) * 3 + tap_index(ph, b);
    dsm::stage_matrix<T, CI>(s_w, w + static_cast<long long>(s) * 3 * CO * CI, 3 * CO);
    dsm::cp_async_wait_all();
    __syncthreads();
    const T* xm = s_in + (a * 2 + b) * Cfg::ROW + jt * 16 * Cfg::P;  // x[m]; x[m + 1] one row on
    const T* wk = s_w + wn * (CO / Cfg::WN) * Cfg::PB;                 // k[.][.][kw] at kw * CO * PB
    dsm::tile_mma<CI, Cfg::P, Cfg::PB, Cfg::NI, false>(c0, xm, wk + 1 * CO * Cfg::PB);
    dsm::tile_mma<CI, Cfg::P, Cfg::PB, Cfg::NI, false>(c1, xm, wk + 2 * CO * Cfg::PB);
    dsm::tile_mma<CI, Cfg::P, Cfg::PB, Cfg::NI, false>(c1, xm + Cfg::P, wk);
    __syncthreads();
  }
  // s_out row 2 j + p is output column 2 (m0 + j) + p
  const int n0 = wn * (CO / Cfg::WN);
  dsm::store_tile<Cfg::NI, Cfg::OP>(s_out, c0, 2 * jt * 16, 2, n0);
  dsm::store_tile<Cfg::NI, Cfg::OP>(s_out, c1, 2 * jt * 16 + 1, 2, n0);
  __syncthreads();
  T* yrow = y + ((static_cast<long long>(n) * Do + od) * Ho + oh) * Wo * CO;
  dsm::write_rows<T, CO, Cfg::OP>(s_out, 2 * TM, [&](int m) -> T* {
    const int wo = 2 * m0 + m;
    return wo < Wo ? yrow + static_cast<long long>(wo) * CO : nullptr;
  });
}

template <typename T, int CI, int CO, int TM>
cudaError_t launch_deconv(const void* x, const void* w, void* y, int N, int Di, int Hi, int Wi,
                          cudaStream_t stream) {
  using Cfg = DeconvK3S2<T, CI, CO, TM>;
  auto kernel = deconv_k3s2_kernel<T, CI, CO, TM>;
  static std::atomic<uint32_t> smem_set{0};
  const cudaError_t err = dsm::set_smem_once(kernel, Cfg::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((Wi + TM - 1) / TM, 2 * Hi, N * 2 * Di);
  kernel<<<grid, dsm::kThreads, Cfg::SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), Di, Hi, Wi);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dsm_deconv3d_k3s2(const void* x, const void* w, void* y, int dtype, int N, int D,
                                 int H, int W, int Cin, int Cout, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Cin != 64 || Cout != 32) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == dsm::kBFloat16)
    return static_cast<int>(launch_deconv<bf16, 64, 32, 64>(x, w, y, N, D, H, W, st));
  if (dtype == dsm::kFloat32)
    return static_cast<int>(launch_deconv<float, 64, 32, 64>(x, w, y, N, D, H, W, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
