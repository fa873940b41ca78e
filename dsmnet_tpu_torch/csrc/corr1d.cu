// Kernel I: 1-D horizontal correlation (DispNetC; iResNet takes stride 2).
//
// Replaces the TPU kernel _corr1d_pallas_fwd (dsmnet_tpu/ops/corr.py:88).
// From (N, H, W, C) features it writes the (N, H, W, D) correlation
//   out[n, h, w, d] = sum_c fL[n, h, w, c] * fR[n, h, w - d * S, c]
// and 0 where w - d * S < 0 (so channel d is all zero when d * S >= W),
// summed in f32 and written in the inputs' dtype.  DispNetC correlates
// (1, 96, 192, 128) at D = 41, iResNet (1, 96, 192, 128) at D = 81 and
// (1, 192, 384, 64) at D = 41, S = 2.
//
// What bounds it on the H100: bytes.  It reads both maps once and writes
// the output once, 2 N H W (2 C + D) bytes in bf16: 11 MB, 0.0033 ms at
// 3.35 TB/s, for DispNetC's request; its 2 C D FLOP per output column are
// ~0.5 GFLOP there, nothing for the tensor cores.
//
// bf16: a banded Gram product on tensor cores.  For one (n, h) row,
// out[w, d] = G[w, w - d S] with G = fL_row fR_row^T (depth C), both
// operands K-major ([w][c]), the layout mma.sync row.col takes without a
// transpose.  A block owns an item: kTile = 64 output columns w0 .. w0 + 63
// of one row.  It stages those fL columns and the fR columns from lo = w0 -
// (D - 1) S on (zeros left of column 0, which makes the w < d S region 0,
// and right of W; zeros also in the channels from C up to Cp, C rounded up
// to 16) with cp.async, as rows padded by 16 bytes, so that ldmatrix reads
// them without bank conflicts.  Strip i, the rows m = 16 i .. 16 i + 15,
// has its band in G's columns 16 i .. 16 i + 15 + (D - 1) S and forms them
// kNB n8 tiles a pass (m16n8k16, f32 accumulators, K = Cp): two warps a
// strip, each kNB / 2 tiles of every pass.
// From the fragments it keeps the band, G[m, m + (D - 1 - d) S] for d < D,
// rounds it to bf16 into a staging tile in the output's order (m D + d),
// and the block writes the item's run of 64 D contiguous elements (fewer at
// the ragged right edge) with 16-byte stores.  The staging tile has shared
// memory of its own: other warps still read a strip's staged fR rows.
// Products of bf16 are exact in f32, so only the summation order differs
// from the plain version.
// ops/corr.py band_plan mirrors the staging plan; the wrapper refuses what
// exceeds shared memory.
//
// f32: the CUDA-core design.  A block owns kTile columns of one (n, h)
// row, stages them and the kTile + (D - 1) S fR columns they meet, and
// thread i forms output (w, d) = (i / D, i % D) of the tile as a C-long
// dot product from shared memory: neighbouring threads read neighbouring
// fR rows, which the padding puts in different banks, and store to
// neighbouring addresses.
#include "conv_common.cuh"

namespace {

using dsm::bf16;

constexpr int kTile = 64;            // output columns per block
constexpr size_t kMaxSmem = 232448;  // the H100's opt-in limit per block

// ---------------------------------------------------------------------------
// bf16: the band of G on tensor cores
// ---------------------------------------------------------------------------
constexpr int kBandThreads = 256;  // 8 warps: warp w the strip w % 4, half w / 4 of a pass
constexpr int kNB = 4;             // n8 tiles of G a strip forms per pass, kNB / 2 per warp

// The staging plan (ops/corr.py band_plan): channels Cp staged per row,
// the row pitch, the passes of a strip, the fR rows staged (the last
// strip's reach) and the shared memory (the staged rows, then the output
// tile of 64 D elements and up to 7 of alignment shift).
struct BandPlan {
  int cp, pitch, passes, rows;
  size_t smem;
};

__host__ __device__ inline BandPlan band_plan(int C, int D, int S) {
  BandPlan p;
  p.cp = (C + 15) / 16 * 16;
  p.pitch = p.cp + 8;
  const int ni = ((D - 1) * S + 16 + 7) / 8;  // n8 tiles that hold a strip's band
  p.passes = (ni + kNB - 1) / kNB;
  p.rows = 48 + 8 * kNB * p.passes;
  p.smem = static_cast<size_t>(kTile + p.rows) * p.pitch * sizeof(bf16) +
           (static_cast<size_t>(kTile) * D + 8) * sizeof(bf16);
  return p;
}

// SC: the stride when it is known at compile time (1, 2), else 0 and S_
template <int SC>
__global__ void __launch_bounds__(kBandThreads)
    corr1d_band_kernel(const bf16* __restrict__ fL, const bf16* __restrict__ fR,
                       bf16* __restrict__ out, int H, int W, int C, int D, int S_) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = SC ? SC : S_;
  const BandPlan p = band_plan(C, D, S);
  bf16* s_l = reinterpret_cast<bf16*>(smem);
  bf16* s_r = s_l + kTile * p.pitch;
  bf16* s_o = s_r + p.rows * p.pitch;  // the output tile
  const int w0 = blockIdx.x * kTile;
  const long long row = (static_cast<long long>(blockIdx.z) * H + blockIdx.y) * W;
  const int lo = w0 - (D - 1) * S;     // fR column of staged row 0
  const int V = p.cp / 8, VC = C / 8;  // 16-byte words staged / present per row
  for (int i = threadIdx.x; i < kTile * V; i += kBandThreads) {
    const int e = i / V, q = i - e * V;
    const bool ok = w0 + e < W && q < VC;
    dsm::cp_async16(s_l + e * p.pitch + q * 8, ok ? fL + (row + w0 + e) * C + q * 8 : fL, ok);
  }
  for (int i = threadIdx.x; i < p.rows * V; i += kBandThreads) {
    const int e = i / V, q = i - e * V;
    const int w = lo + e;
    const bool ok = w >= 0 && w < W && q < VC;
    dsm::cp_async16(s_r + e * p.pitch + q * 8, ok ? fR + (row + w) * C + q * 8 : fR, ok);
  }
  dsm::cp_async_wait_all();
  __syncthreads();

  // the tile holds the item's outputs in their order, element m D + d at
  // shift + m D + d, so that its 16-byte words line up with the output's
  const long long first = (row + w0) * D;
  const int shift = static_cast<int>(first & 7);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp & 3) * 16;        // the strip
  const int n0 = (warp >> 2) * kNB / 2;  // the warp's first n8 tile of a pass
  // ldmatrix rows: A (fL, [m][k]) row lane & 15, k half lane >> 4; B (fR,
  // [n][k]) row (lane & 7) + 8 (lane >> 4), k half (lane >> 3) & 1
  const uint32_t a_addr = dsm::smem_u32(s_l + (m0 + (lane & 15)) * p.pitch + (lane >> 4) * 8);
  const uint32_t b_addr = dsm::smem_u32(
      s_r + (m0 + 8 * n0 + (lane & 7) + ((lane >> 4) << 3)) * p.pitch + ((lane >> 3) & 1) * 8);
  for (int pass = 0; pass < p.passes; ++pass) {
    // G[m0 .. m0 + 15, m0 + 8 kNB pass + 8 (n0 + ni) + (0 .. 7)] in acc[ni]
    float acc[kNB / 2][4];
#pragma unroll
    for (int ni = 0; ni < kNB / 2; ++ni) acc[ni][0] = acc[ni][1] = acc[ni][2] = acc[ni][3] = 0.0f;
    const uint32_t b_pass = b_addr + pass * 8 * kNB * p.pitch * 2;
    for (int k0 = 0; k0 < p.cp; k0 += 16) {
      uint32_t a[4], b[4];
      dsm::ldsm_x4(a, a_addr + k0 * 2);
      dsm::ldsm_x4(b, b_pass + k0 * 2);
      dsm::mma_bf16(acc[0], a, b[0], b[1]);
      dsm::mma_bf16(acc[1], a, b[2], b[3]);
    }
    // the band: value (row r, column c) of n-tile n0 + ni lies at m = m0 +
    // r, staged fR row j = m0 + 8 kNB pass + 8 (n0 + ni) + c, so j - m =
    // (D - 1 - d) S
#pragma unroll
    for (int ni = 0; ni < kNB / 2; ++ni)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = g + (v >> 1) * 8;
        const int delta = 8 * kNB * pass + 8 * (n0 + ni) + 2 * t + (v & 1) - r;
        if (delta < 0 || delta % S != 0) continue;
        const int d = D - 1 - delta / S;
        if (d < 0) continue;
        s_o[shift + (m0 + r) * D + d] = __float2bfloat16(acc[ni][v]);
      }
  }
  __syncthreads();

  // the item's run of cols D elements: a head up to the first 16-byte
  // word of the output, whole words, a tail
  const int n = min(kTile, W - w0) * D;
  bf16* dst = out + first;
  const int head = min(n, (8 - shift) & 7);
  const int words = (n - head) / 8;
  for (int i = threadIdx.x; i < words; i += kBandThreads)
    reinterpret_cast<uint4*>(dst + head)[i] =
        reinterpret_cast<const uint4*>(s_o + shift + head)[i];
  const int tail0 = head + 8 * words;
  for (int i = threadIdx.x; i < head + (n - tail0); i += kBandThreads) {
    const int k = i < head ? i : tail0 + (i - head);
    dst[k] = s_o[shift + k];
  }
}

template <int SC>
cudaError_t launch_band(const void* fL, const void* fR, void* out, int N, int H, int W, int C,
                        int D, int S, size_t smem, cudaStream_t st) {
  static std::atomic<uint32_t> smem_set{0};
  const cudaError_t err = dsm::set_smem_once(corr1d_band_kernel<SC>, kMaxSmem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kTile - 1) / kTile, H, N);
  corr1d_band_kernel<SC><<<grid, kBandThreads, smem, st>>>(
      static_cast<const bf16*>(fL), static_cast<const bf16*>(fR), static_cast<bf16*>(out), H, W,
      C, D, S);
  return cudaGetLastError();
}

cudaError_t launch_corr1d_band(const void* fL, const void* fR, void* out, int N, int H, int W,
                               int C, int D, int S, cudaStream_t st) {
  if (C % 8 != 0) return cudaErrorInvalidValue;
  const size_t smem = band_plan(C, D, S).smem;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto launch = S == 1 ? &launch_band<1> : S == 2 ? &launch_band<2> : &launch_band<0>;
  return launch(fL, fR, out, N, H, W, C, D, S, smem, st);
}

// ---------------------------------------------------------------------------
// f32: dot products on the CUDA cores
// ---------------------------------------------------------------------------
constexpr int kCorrThreads = 256;

// acc += the dot product of two 16-byte words of floats
__device__ inline void fma_words(float& acc, uint4 a, uint4 b) {
  acc = fmaf(__uint_as_float(a.x), __uint_as_float(b.x), acc);
  acc = fmaf(__uint_as_float(a.y), __uint_as_float(b.y), acc);
  acc = fmaf(__uint_as_float(a.z), __uint_as_float(b.z), acc);
  acc = fmaf(__uint_as_float(a.w), __uint_as_float(b.w), acc);
}

__global__ void __launch_bounds__(kCorrThreads)
    corr1d_kernel(const float* __restrict__ fL, const float* __restrict__ fR,
                  float* __restrict__ out, int H, int W, int C, int D, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kVec = dsm::vec<float>();
  const int P = C + kVec;           // staged row pitch (elements)
  const int V = C / kVec;           // 16-byte words per row
  const int span = kTile + (D - 1) * S;
  float* s_l = reinterpret_cast<float*>(smem);
  float* s_r = s_l + kTile * P;
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
    for (int q = 0; q < V; ++q) fma_words(acc, a[q], b[q]);
    out[(row + w0 + e) * D + d] = acc;
  }
}

cudaError_t launch_corr1d_f32(const void* fL, const void* fR, void* out, int N, int H, int W,
                              int C, int D, int S, cudaStream_t st) {
  if (C % dsm::vec<float>() != 0) return cudaErrorInvalidValue;
  const size_t smem =
      static_cast<size_t>(2 * kTile + (D - 1) * S) * (C + dsm::vec<float>()) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static std::atomic<uint32_t> smem_set{0};
  const cudaError_t err = dsm::set_smem_once(corr1d_kernel, kMaxSmem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kTile - 1) / kTile, H, N);
  corr1d_kernel<<<grid, kCorrThreads, smem, st>>>(static_cast<const float*>(fL),
                                                  static_cast<const float*>(fR),
                                                  static_cast<float*>(out), H, W, C, D, S);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dsm_corr1d(const void* fL, const void* fR, void* out, int dtype, int N, int H,
                          int W, int C, int D, int stride, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || H < 1 || W < 1 || C < 1 || D < 1 || stride < 1 || H > 65535 || N > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == dsm::kBFloat16)
    return static_cast<int>(launch_corr1d_band(fL, fR, out, N, H, W, C, D, stride, st));
  if (dtype == dsm::kFloat32)
    return static_cast<int>(launch_corr1d_f32(fL, fR, out, N, H, W, C, D, stride, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
