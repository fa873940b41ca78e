// Kernel H: the concatenation cost volume of GCNet and PSMNet-basic.
//
// Replaces the TPU kernel _cost_volume_pallas_fwd
// (dsmnet_tpu/ops/cost_volume.py:76).  From (N, H, W, F) features it
// writes the (N, D, H, W, 2F) volume
//   out[n, d, h, w, :F] = fL[n, h, w]      (0 where w < d when mask_left)
//   out[n, d, h, w, F:] = fR[n, h, w - d]  (0 where w < d)
// so a slice with d >= W has a zero right half, and its left half stays
// dense unless mask_left.  GCNet builds it unmasked from (1, 192, 384, 32)
// with D = 96 (0.91 GB in bf16); PSMNet-basic masked from (1, 96, 192, 32)
// with D = 48.
//
// What bounds it on the H100: it is a copy that writes D times the bytes
// it reads, so the bytes written bound it (~0.27 ms for GCNet's bf16
// volume at 3.35 TB/s).  A block stages one (n, h) row of fL, and of fR
// behind D zero columns, in shared memory, and writes kSlices disparity
// slices of that row from there with 16-byte stores, consecutive threads
// on consecutive words; the zero columns are the w < d region, so the
// right half needs no branch.  The D / kSlices blocks of a row each read
// it once (all but the first from L2).  Words move as they are, whatever
// the dtype: the volume holds the inputs' bits.
#include "conv_common.cuh"

namespace {

constexpr int kCvThreads = 256;
constexpr int kSlices = 16;  // disparity slices per block

__global__ void __launch_bounds__(kCvThreads)
    cost_volume_kernel(const uint4* __restrict__ fL, const uint4* __restrict__ fR,
                       uint4* __restrict__ out, int H, int W, int V, int D, int mask_left) {
  extern __shared__ uint4 s_words[];
  uint4* s_l = s_words;          // W * V words: the fL row
  uint4* s_r = s_words + W * V;  // (D + W) * V words: D zero columns, then the fR row
  const int nh = blockIdx.x;     // n * H + h
  const int n = nh / H;
  const int h = nh - n * H;
  const long long row = static_cast<long long>(nh) * W * V;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < W * V; i += kCvThreads) {
    s_l[i] = fL[row + i];
    s_r[D * V + i] = fR[row + i];
  }
  for (int i = threadIdx.x; i < D * V; i += kCvThreads) s_r[i] = zero;
  __syncthreads();

  const int v2 = 2 * V;  // words per output column: V of fL, then V of fR
  const int slice = W * v2;
  const int d0 = static_cast<int>(blockIdx.y) * kSlices;
  const int d1 = min(D, d0 + kSlices);
  for (int d = d0; d < d1; ++d) {
    uint4* o = out + ((static_cast<long long>(n) * D + d) * H + h) * slice;
    for (int i = threadIdx.x; i < slice; i += kCvThreads) {
      const int w = i / v2;
      const int q = i - w * v2;
      if (q < V)
        o[i] = mask_left && w < d ? zero : s_l[w * V + q];
      else
        o[i] = s_r[(w - d + D) * V + q - V];
    }
  }
}

}  // namespace

extern "C" int dsm_cost_volume(const void* fL, const void* fR, void* out, int dtype, int N, int H,
                               int W, int F, int D, int mask_left, void* stream) {
  const int elem = dtype == dsm::kBFloat16 ? 2 : dtype == dsm::kFloat32 ? 4 : 0;
  if (elem == 0 || N < 1 || H < 1 || W < 1 || D < 1 || F < 1 || (F * elem) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int V = F * elem / 16;
  const size_t smem = static_cast<size_t>(2 * W + D) * V * sizeof(uint4);
  constexpr size_t kMaxSmem = 232448;  // the H100's opt-in limit per block
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<uint32_t> smem_set{0};
  const cudaError_t err = dsm::set_smem_once(cost_volume_kernel, kMaxSmem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(N * H, (D + kSlices - 1) / kSlices);
  cost_volume_kernel<<<grid, kCvThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(fL), static_cast<const uint4*>(fR), static_cast<uint4*>(out), H,
      W, V, D, mask_left);
  return static_cast<int>(cudaGetLastError());
}
