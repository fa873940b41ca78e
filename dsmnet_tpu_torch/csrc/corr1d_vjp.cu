// The VJP of kernel I (the 1-D correlation, corr1d.cu).
//
// Replaces _corr1d_vjp_bwd (dsmnet_tpu/ops/corr.py:123), which JAX runs as
// jnp (XLA; there is no Pallas kernel for it).  Given the features fL, fR
// (N, H, W, C) and the cotangent g (N, H, W, D) it writes
//   dfL[n, h, w] = sum_d g[n, h, w, d] fR[n, h, w - d S]          (w - d S >= 0)
//   dfR[n, h, u] = sum_d g[n, h, u + d S, d] fL[n, h, u + d S]    (u + d S < W)
// summed in f32 and written once in the inputs' dtype.  There are no
// atomics: a run gives the same bits as the last.
//
// What bounds it on the H100: bytes.  It reads fL, fR and g once and writes
// dfL and dfR once, 2 N H W (4 C + D) bytes in bf16: 82 MB (0.024 ms at
// 3.35 TB/s) for DispNetC's batch-4 step, 87 + 175 MB (0.078 ms) for
// iResNet's two correlations.  Its 4 C D FLOP per column are nothing for
// the tensor cores.
//
// bf16: two banded products on tensor cores.  A block owns one side (dfL or
// dfR) of a tile of 64 columns w0 .. w0 + 63 of one (n, h) row:
//   dfL tile = Bg F, F = fR's columns lo + j (lo = w0 - (D - 1) S), and the
//     band Bg[m, j] = g[w0 + m, d] where j = m + (D - 1 - d) S;
//   dfR tile = Cg F', F' = fL's columns w0 + j, and Cg[m, j] = g[w0 + j, d]
//     where j = m + d S,
// 0 elsewhere.  It stages the rows of F with cp.async (zeros outside [0, W)
// and in the channels from C up to Cp, C rounded up to 16), builds the band
// in shared memory from g's contiguous rows (zeros, then g's elements
// scattered onto the band), and multiplies strip i, the rows m = 16 i .. 16
// i + 15, whose band lies in columns 16 i .. 16 i + 15 + (D - 1) S, into
// f32 accumulators, two warps a strip, each half of the Cp <= 128
// channels: A is the band (ldmatrix), B the staged rows ([k][n],
// ldmatrix.trans), m16n8k16.  The tile goes back to bf16 through shared
// memory and out with 16-byte stores.  Products of bf16
// are exact in f32, so the result differs from the plain VJP summed in f32
// only by the order of the sum and the one rounding to bf16; the plain VJP
// as the port runs it on bf16 tensors rounds after every shift.
// ops/corr.py vjp_plan mirrors the plan; the wrapper refuses what exceeds
// shared memory or C > 128.
//
// f32: one thread per column and 4 channels sums its D terms of each side
// with f32 FMAs on the CUDA cores (no TF32), reading through the L1.
#include "conv_common.cuh"

namespace {

using dsm::bf16;

constexpr int kTile = 64;            // columns per block
constexpr int kVjpThreads = 256;     // 8 warps: warp w the strip w % 4, channel half w / 4
constexpr int kMaxC = 128;           // channels the accumulators hold
constexpr int kBatch = 8;            // 16-byte words of g a thread loads at once
constexpr size_t kMaxSmem = 232448;  // the H100's opt-in limit per block

// The plan (ops/corr.py vjp_plan): channels Cp staged per row and the row
// pitch; k16 steps of a strip, rows of F staged (the last strip's reach)
// and the band's pitch; shared memory (F, then the band; the output tile
// reuses F).
struct VjpPlan {
  int cp, pitch, ks, rows, bpitch;
  size_t smem;
};

__host__ __device__ inline VjpPlan vjp_plan(int C, int D, int S) {
  VjpPlan p;
  p.cp = (C + 15) / 16 * 16;
  p.pitch = p.cp + 8;
  p.ks = ((D - 1) * S + 16 + 15) / 16;
  p.rows = 48 + 16 * p.ks;
  p.bpitch = p.rows + 8;
  p.smem = (static_cast<size_t>(p.rows) * p.pitch + static_cast<size_t>(kTile) * p.bpitch) *
           sizeof(bf16);
  return p;
}

__global__ void __launch_bounds__(kVjpThreads)
    corr1d_vjp_band_kernel(const bf16* __restrict__ fL, const bf16* __restrict__ fR,
                           const bf16* __restrict__ g, bf16* __restrict__ dfL,
                           bf16* __restrict__ dfR, int H, int W, int C, int D, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const VjpPlan p = vjp_plan(C, D, S);
  bf16* s_f = reinterpret_cast<bf16*>(smem);
  bf16* s_b = s_f + p.rows * p.pitch;  // the band, 64 x rows
  const bool left = (blockIdx.x & 1) == 0;
  const int w0 = (blockIdx.x >> 1) * kTile;
  const long long row = (static_cast<long long>(blockIdx.z) * H + blockIdx.y) * W;
  const int lo = left ? w0 - (D - 1) * S : w0;  // column of staged row 0
  const bf16* feat = left ? fR : fL;
  const int V = p.cp / 8, VC = C / 8;  // 16-byte words staged / present per row
  for (int i = threadIdx.x; i < p.rows * V; i += kVjpThreads) {
    const int e = i / V, q = i - e * V;
    const int w = lo + e;
    const bool ok = w >= 0 && w < W && q < VC;
    dsm::cp_async16(s_f + e * p.pitch + q * 8, ok ? feat + (row + w) * C + q * 8 : feat, ok);
  }
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < kTile * p.bpitch / 8; i += kVjpThreads)
    reinterpret_cast<uint4*>(s_b)[i] = zero;
  __syncthreads();
  // g's rows w0 .. w0 + grows - 1 (dfL: the tile's; dfR: those of the fL
  // columns the tile meets), elements e0 .. e1 - 1, scattered onto the
  // band: the 16-byte words inside the range kBatch a thread at a time, the
  // elements of the partial words at its ends one by one
  const int grows = min(W - w0, left ? kTile : kTile + (D - 1) * S);
  const long long e0 = (row + w0) * D, e1 = e0 + static_cast<long long>(grows) * D;
  const long long wa = (e0 + 7) / 8, wb = e1 / 8;  // whole words [wa, wb)
  // element (r, d) of the rows: band row m, column j
  auto put = [&](int r, int d, bf16 v) {
    const int m = left ? r : r - d * S;
    const int j = left ? r + (D - 1 - d) * S : r;
    if (m >= 0 && m < kTile) s_b[m * p.bpitch + j] = v;
  };
  const uint4* g4 = reinterpret_cast<const uint4*>(g);
  for (long long k0 = wa + threadIdx.x; k0 < wb; k0 += kBatch * kVjpThreads) {
    uint4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long k = k0 + u * kVjpThreads;
      if (k < wb) v[u] = __ldg(g4 + k);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long k = k0 + u * kVjpThreads;
      if (k < wb) {
        const bf16* e = reinterpret_cast<const bf16*>(&v[u]);
        const int i = static_cast<int>(8 * k - e0);
        int r = i / D, d = i - r * D;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          put(r, d, e[q]);
          if (++d == D) d = 0, ++r;
        }
      }
    }
  }
  const long long h1 = min(e1, 8 * wa);  // the head [e0, h1) and the tail [t0, e1)
  const long long t0 = max(h1, 8 * wb);
  for (int i = threadIdx.x; i < static_cast<int>(h1 - e0 + e1 - t0); i += kVjpThreads) {
    const int k = i < h1 - e0 ? i : static_cast<int>(t0 - e0) + i - static_cast<int>(h1 - e0);
    put(k / D, k % D, g[e0 + k]);
  }
  dsm::cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = (warp & 3) * 16;  // the strip
  // the warp's pairs of n8 tiles (16 channels each): [q0, q1) of Cp / 16
  const int per = (p.cp / 16 + 1) / 2;
  const int q0 = (warp >> 2) * per, npairs = min(p.cp / 16 - q0, per);
  // ldmatrix rows: A (the band, [m][k]) row m0 + (lane & 15), k from m0 in
  // halves lane >> 4; B (F, [k][n], transposed) row m0 + (lane & 15), n
  // chunk lane >> 4 of each pair of n8 tiles
  const uint32_t a_addr =
      dsm::smem_u32(s_b + (m0 + (lane & 15)) * p.bpitch + m0 + (lane >> 4) * 8);
  const uint32_t b_addr =
      dsm::smem_u32(s_f + (m0 + (lane & 15)) * p.pitch + q0 * 16 + (lane >> 4) * 8);
  float acc[kMaxC / 16][4];
#pragma unroll
  for (int nt = 0; nt < kMaxC / 16; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  for (int kk = 0; kk < p.ks; ++kk) {
    uint32_t a[4];
    dsm::ldsm_x4(a, a_addr + kk * 16 * 2);
#pragma unroll
    for (int np = 0; np < kMaxC / 32; ++np) {
      if (np < npairs) {
        uint32_t b[4];
        dsm::ldsm_x4_trans(b, b_addr + (kk * 16 * p.pitch + np * 16) * 2);
        dsm::mma_bf16(acc[2 * np], a, b[0], b[1]);
        dsm::mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
  __syncthreads();  // every warp is done with F and the band

  // the tile in bf16 over F's rows 0 .. 63, then out: rows w0 + m < W
  const int gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kMaxC / 16; ++nt) {
    if (nt < 2 * npairs) {
      bf16* r0 = s_f + (m0 + gq) * p.pitch + q0 * 16 + nt * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(r0) = __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<__nv_bfloat162*>(r0 + 8 * p.pitch) =
          __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
    }
  }
  __syncthreads();
  bf16* dst = (left ? dfL : dfR) + (row + w0) * C;
  const int cols = min(kTile, W - w0);
  for (int i = threadIdx.x; i < cols * VC; i += kVjpThreads) {
    const int m = i / VC, q = i - m * VC;
    *reinterpret_cast<uint4*>(dst + m * C + q * 8) =
        *reinterpret_cast<const uint4*>(s_f + m * p.pitch + q * 8);
  }
}

cudaError_t launch_vjp_band(const void* fL, const void* fR, const void* g, void* dfL, void* dfR,
                            int N, int H, int W, int C, int D, int S, cudaStream_t st) {
  if (C % 8 != 0 || C > kMaxC) return cudaErrorInvalidValue;
  const VjpPlan p = vjp_plan(C, D, S);
  if (p.smem > kMaxSmem) return cudaErrorInvalidValue;
  static std::atomic<uint32_t> smem_set{0};
  const cudaError_t err = dsm::set_smem_once(corr1d_vjp_band_kernel, kMaxSmem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(2 * ((W + kTile - 1) / kTile), H, N);
  corr1d_vjp_band_kernel<<<grid, kVjpThreads, p.smem, st>>>(
      static_cast<const bf16*>(fL), static_cast<const bf16*>(fR), static_cast<const bf16*>(g),
      static_cast<bf16*>(dfL), static_cast<bf16*>(dfR), H, W, C, D, S);
  return cudaGetLastError();
}

constexpr int kF32Threads = 256;

// thread (position, 4 channels): both sides' D terms in f32 FMAs
__global__ void __launch_bounds__(kF32Threads)
    corr1d_vjp_kernel(const float4* __restrict__ fL, const float4* __restrict__ fR,
                      const float* __restrict__ g, float4* __restrict__ dfL,
                      float4* __restrict__ dfR, long long positions, int W, int V, int D,
                      int S) {
  const long long i = static_cast<long long>(blockIdx.x) * kF32Threads + threadIdx.x;
  if (i >= positions * V) return;
  const long long pos = i / V;
  const int q = static_cast<int>(i - pos * V);
  const int w = static_cast<int>(pos % W);
  float4 l = make_float4(0.f, 0.f, 0.f, 0.f), r = l;
  for (int d = 0; d < D && d * S < W; ++d) {
    const int s = d * S;
    if (w - s >= 0) {
      const float gd = __ldg(g + pos * D + d);
      const float4 f = __ldg(fR + (pos - s) * V + q);
      l.x = fmaf(gd, f.x, l.x), l.y = fmaf(gd, f.y, l.y);
      l.z = fmaf(gd, f.z, l.z), l.w = fmaf(gd, f.w, l.w);
    }
    if (w + s < W) {
      const float gd = __ldg(g + (pos + s) * D + d);
      const float4 f = __ldg(fL + (pos + s) * V + q);
      r.x = fmaf(gd, f.x, r.x), r.y = fmaf(gd, f.y, r.y);
      r.z = fmaf(gd, f.z, r.z), r.w = fmaf(gd, f.w, r.w);
    }
  }
  dfL[pos * V + q] = l;
  dfR[pos * V + q] = r;
}

cudaError_t launch_vjp_f32(const void* fL, const void* fR, const void* g, void* dfL, void* dfR,
                           int N, int H, int W, int C, int D, int S, cudaStream_t st) {
  if (C % 4 != 0) return cudaErrorInvalidValue;
  const long long positions = static_cast<long long>(N) * H * W;
  const long long threads = positions * (C / 4);
  const long long blocks = (threads + kF32Threads - 1) / kF32Threads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  corr1d_vjp_kernel<<<static_cast<unsigned>(blocks), kF32Threads, 0, st>>>(
      static_cast<const float4*>(fL), static_cast<const float4*>(fR),
      static_cast<const float*>(g), static_cast<float4*>(dfL), static_cast<float4*>(dfR),
      positions, W, C / 4, D, S);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dsm_corr1d_vjp(const void* fL, const void* fR, const void* g, void* dfL,
                              void* dfR, int dtype, int N, int H, int W, int C, int D,
                              int stride, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || H < 1 || W < 1 || C < 1 || D < 1 || stride < 1 || H > 65535 || N > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == dsm::kBFloat16)
    return static_cast<int>(launch_vjp_band(fL, fR, g, dfL, dfR, N, H, W, C, D, stride, st));
  if (dtype == dsm::kFloat32)
    return static_cast<int>(launch_vjp_f32(fL, fR, g, dfL, dfR, N, H, W, C, D, stride, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
