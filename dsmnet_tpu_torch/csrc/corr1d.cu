// Kernel I: 1-D horizontal correlation (DispNetC; iResNet takes stride 2).
//
// Replaces the TPU kernel _corr1d_pallas_fwd (dsmnet_tpu/ops/corr.py:88).
// From (N, H, W, C) features it writes the (N, H, W, D) correlation
//   out[n, h, w, d] = sum_c fL[n, h, w, c] * fR[n, h, w - d * S, c]
// and 0 where w - d * S < 0 (so channel d is all zero when d * S >= W),
// summed in f32 and written in the inputs' dtype.  DispNetC correlates
// (1, 96, 192, 128) at D = 41.
//
// What bounds it on the H100: 2 C FLOP per output against 2 C input bytes
// read per output column is ~80 FLOP/byte at DispNetC's bf16 shape, below
// the ridge; but its ~11 MB of traffic take ~3.3 us, less than a launch,
// so it is sized to be right, not tuned.  A block owns kTile columns of
// one (n, h) row.  It stages those columns of fL and the kTile + (D - 1) S
// columns of fR they meet (zeros left of column 0: the w < d S region)
// with cp.async, as rows padded by 16 bytes.  Thread i forms output
// (w, d) = (i / D, i % D) of the tile: neighbouring threads read
// neighbouring fR rows, which the padding puts in different banks, and
// store to neighbouring addresses.
#include "conv_common.cuh"

namespace {

using dsm::bf16;

constexpr int kCorrThreads = 256;
constexpr int kTile = 64;  // output columns per block

__device__ inline void fma_pair(float& acc, uint32_t a, uint32_t b) {
  const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a));
  const float2 fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b));
  acc = fmaf(fa.x, fb.x, acc);
  acc = fmaf(fa.y, fb.y, acc);
}

// acc += the dot product of two 16-byte words of T (4 floats or 8 bf16)
template <typename T>
__device__ inline void fma_words(float& acc, uint4 a, uint4 b) {
  if constexpr (std::is_same<T, float>::value) {
    acc = fmaf(__uint_as_float(a.x), __uint_as_float(b.x), acc);
    acc = fmaf(__uint_as_float(a.y), __uint_as_float(b.y), acc);
    acc = fmaf(__uint_as_float(a.z), __uint_as_float(b.z), acc);
    acc = fmaf(__uint_as_float(a.w), __uint_as_float(b.w), acc);
  } else {
    fma_pair(acc, a.x, b.x);
    fma_pair(acc, a.y, b.y);
    fma_pair(acc, a.z, b.z);
    fma_pair(acc, a.w, b.w);
  }
}

__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(bf16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kCorrThreads)
    corr1d_kernel(const T* __restrict__ fL, const T* __restrict__ fR, T* __restrict__ out, int H,
                  int W, int C, int D, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kVec = dsm::vec<T>();
  const int P = C + kVec;           // staged row pitch (elements)
  const int V = C / kVec;           // 16-byte words per row
  const int span = kTile + (D - 1) * S;
  T* s_l = reinterpret_cast<T*>(smem);
  T* s_r = s_l + kTile * P;
  const int w0 = blockIdx.x * kTile;
  const long long row = (static_cast<long long>(blockIdx.z) * H + blockIdx.y) * W;
  const int lo = w0 - (D - 1) * S;  // fR column of staged row 0
  for (int i = threadIdx.x; i < kTile * V; i += kCorrThreads) {
    const int e = i / V, q = i - e * V;
    const bool ok = w0 + e < W;
    dsm::cp_async16(s_l + e * P + q * kVec, ok ? fL + (row + w0 + e) * C + q * kVec : fL, ok);
  }
  for (int i = threadIdx.x; i < span * V; i += kCorrThreads) {
    const int e = i / V, q = i - e * V;
    const int w = lo + e;
    const bool ok = w >= 0 && w < W;
    dsm::cp_async16(s_r + e * P + q * kVec, ok ? fR + (row + w) * C + q * kVec : fR, ok);
  }
  dsm::cp_async_wait_all();
  __syncthreads();

  const int cols = min(kTile, W - w0);
  for (int i = threadIdx.x; i < cols * D; i += kCorrThreads) {
    const int e = i / D, d = i - e * D;
    // fR column w0 + e - d S is staged row e + (D - 1 - d) S
    const uint4* a = reinterpret_cast<const uint4*>(s_l + e * P);
    const uint4* b = reinterpret_cast<const uint4*>(s_r + (e + (D - 1 - d) * S) * P);
    float acc = 0.0f;
    for (int q = 0; q < V; ++q) fma_words<T>(acc, a[q], b[q]);
    store(out + (row + w0 + e) * D + d, acc);
  }
}

template <typename T>
cudaError_t launch_corr1d(const void* fL, const void* fR, void* out, int N, int H, int W, int C,
                          int D, int S, cudaStream_t st) {
  constexpr size_t kMaxSmem = 232448;  // the H100's opt-in limit per block
  if (C % dsm::vec<T>() != 0) return cudaErrorInvalidValue;
  const size_t smem =
      static_cast<size_t>(2 * kTile + (D - 1) * S) * (C + dsm::vec<T>()) * sizeof(T);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static std::atomic<uint32_t> smem_set{0};
  const cudaError_t err = dsm::set_smem_once(corr1d_kernel<T>, kMaxSmem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kTile - 1) / kTile, H, N);
  corr1d_kernel<T><<<grid, kCorrThreads, smem, st>>>(
      static_cast<const T*>(fL), static_cast<const T*>(fR), static_cast<T*>(out), H, W, C, D, S);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dsm_corr1d(const void* fL, const void* fR, void* out, int dtype, int N, int H,
                          int W, int C, int D, int stride, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || H < 1 || W < 1 || C < 1 || D < 1 || stride < 1 || H > 65535 || N > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == dsm::kBFloat16)
    return static_cast<int>(launch_corr1d<bf16>(fL, fR, out, N, H, W, C, D, stride, st));
  if (dtype == dsm::kFloat32)
    return static_cast<int>(launch_corr1d<float>(fL, fR, out, N, H, W, C, D, stride, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
