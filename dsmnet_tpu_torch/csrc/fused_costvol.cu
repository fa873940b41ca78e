// Kernel J: the assembly of PSMNet's fused cost-volume stem.
//
// Replaces the TPU kernel _fused_pallas_fwd (dsmnet_tpu/ops/fused_costvol.py:510)
// together with the boundary patches it leaves to XLA (:559-570): this
// kernel writes every voxel, so nothing is patched afterwards.  The 3x3x3
// SAME convolution of the concat volume [fL masked | fR shifted by d]
// collapses into 2-D tap maps (ops/fused_costvol.py, tap_maps): A and B,
// the 3-tap H-convolutions of fL and fR against the kernel's left and
// right channel halves, each (N, H, W, 9 O) float32 with tap
// t = 3 (dd + 1) + (dw + 1) in channels [t O, (t + 1) O).  From them it
// writes the (N, D, H, W, O) output
//   out[n,d,h,w,o] = sum_t [0 <= d+dd < D] ( A_t[n,h,w+dw,o] [0 <= w+dw < W] lmask
//                                          + B_t[n,h,u,o] [0 <= w+dw < W] [u >= 0] ),
//   u = w + dw - (d + dd),  lmask = [u >= 0] when mask_left, else 1,
// summed in f32 tap by tap, A before B, as the plain version sums, and
// rounded once to the output dtype (bf16 or f32).  D > W, W < 3 and D < 3
// need no special path: the bracketed conditions cover them.
//
// What bounds it on the H100: bytes.  It writes the output once and reads
// each map element about once (18 N H W O floats): ~99 MB for PSMNet's bf16
// request (0.030 ms at 3.35 TB/s), against 18 f32 adds per output.  A block
// owns one (n, h) row and `tile` output columns and loops over all D.
// Thread (c, q) holds output column w0 + c and channels 4q..4q+3: it keeps
// its nine A taps (at w + dw, so the shift by dw is an index) in
// registers, read once from global memory, and reads B from shared memory,
// where the block stages the columns [w0 - D - 1, w0 + tile + 1] that its
// taps meet, zero outside the image, as rows padded by 16 bytes (so the
// two columns a bf16 warp phase may touch fall in different banks).
// Consecutive threads hold consecutive channels of consecutive columns, so
// each d slice is stored as one contiguous run per warp.  Offsets into the
// output are 64-bit: a batch-4 f32 output is 453 MB.
#include "conv_common.cuh"

namespace {

using dsm::bf16;

constexpr int kStemThreads = 256;
constexpr int kTaps = 9;

__device__ inline void add4(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

__device__ inline void store4(float* p, const float4& v) { *reinterpret_cast<float4*>(p) = v; }

__device__ inline void store4(bf16* p, const float4& v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 words;
  words.x = *reinterpret_cast<const uint32_t*>(&lo);
  words.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = words;
}

template <typename T>
__global__ void __launch_bounds__(kStemThreads)
    fused_costvol_kernel(const float* __restrict__ A, const float* __restrict__ B,
                         T* __restrict__ out, int H, int W, int O, int D, int mask_left,
                         int tile) {
  extern __shared__ __align__(16) float s_b[];
  const int C9 = kTaps * O;        // channels of a map column
  const int P = C9 + 4;            // staged column pitch (floats)
  const int V = C9 / 4;            // 16-byte words per column
  const int Q = O / 4;             // 4-channel groups per output column
  const int span = tile + D + 3;   // staged B columns
  const int w0 = blockIdx.x * tile;
  const int lo = w0 - D - 1;       // map column of staged row 0
  const int h = blockIdx.y, n = blockIdx.z;
  const long long row = (static_cast<long long>(n) * H + h) * W;  // column index of (n, h, 0)
  for (int i = threadIdx.x; i < span * V; i += kStemThreads) {
    const int e = i / V, k = i - e * V;
    const int w = lo + e;
    const bool ok = w >= 0 && w < W;
    dsm::cp_async16(s_b + e * P + k * 4, ok ? B + (row + w) * C9 + k * 4 : B, ok);
  }

  const int c = threadIdx.x / Q, q = threadIdx.x - c * Q;
  const int w = w0 + c;
  const bool active = c < tile && w < W;
  float4 a[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    const int wa = w + t % 3 - 1;
    a[t] = active && wa >= 0 && wa < W
               ? __ldg(reinterpret_cast<const float4*>(A + (row + wa) * C9 + t * O) + q)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  dsm::cp_async_wait_all();
  __syncthreads();
  if (!active) return;

  const long long slice = static_cast<long long>(H) * W * O;  // elements of one d
  T* o = out + ((static_cast<long long>(n) * D * H + h) * W + w) * O + 4 * q;
  for (int d = 0; d < D; ++d) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      const int dv = d + t / 3 - 1;
      if (dv < 0 || dv >= D) continue;
      const int wv = w + t % 3 - 1;
      const int u = wv - dv;
      if (!mask_left || u >= 0) add4(acc, a[t]);  // a[t] is zero outside the image
      if (u >= 0 && wv < W)
        add4(acc, reinterpret_cast<const float4*>(s_b + (u - lo) * P + t * O)[q]);
    }
    store4(o + d * slice, acc);
  }
}

template <typename T>
cudaError_t launch_fused_costvol(const void* A, const void* B, void* out, int N, int H, int W,
                                 int O, int D, int mask_left, cudaStream_t st) {
  constexpr size_t kMaxSmem = 232448;  // the H100's opt-in limit per block
  const int tile = kStemThreads / (O / 4);
  const size_t smem = static_cast<size_t>(tile + D + 3) * (kTaps * O + 4) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static std::atomic<uint32_t> smem_set{0};
  const cudaError_t err = dsm::set_smem_once(fused_costvol_kernel<T>, kMaxSmem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + tile - 1) / tile, H, N);
  fused_costvol_kernel<T><<<grid, kStemThreads, smem, st>>>(
      static_cast<const float*>(A), static_cast<const float*>(B), static_cast<T*>(out), H, W, O,
      D, mask_left, tile);
  return cudaGetLastError();
}

}  // namespace

// A, B: the float32 tap maps (N, H, W, 9 O); out: (N, D, H, W, O) in `dtype`.
extern "C" int dsm_fused_costvol(const void* A, const void* B, void* out, int dtype, int N, int H,
                                 int W, int O, int D, int mask_left, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || H < 1 || W < 1 || D < 1 || O < 4 || O % 4 != 0 || O > 4 * kStemThreads ||
      H > 65535 || N > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == dsm::kBFloat16)
    return static_cast<int>(launch_fused_costvol<bf16>(A, B, out, N, H, W, O, D, mask_left, st));
  if (dtype == dsm::kFloat32)
    return static_cast<int>(launch_fused_costvol<float>(A, B, out, N, H, W, O, D, mask_left, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
