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
// summed in f32 and rounded once to the output dtype (bf16 or f32).
//
// What bounds it on the H100: bytes.  It writes the output once and reads
// each map element once (18 N H W O floats): ~99 MB for PSMNet's bf16
// request (0.030 ms at 3.35 TB/s), 396 MB for its batch-4 train step.
//
// The design groups the taps as the TPU kernel does (:526-533).  Write s =
// w - d and e = dw - dd, so u = s + e.  In the interior (0 < d < D - 1, 0
// < w < W - 1) every tap is in range and
//   the right half is G[s] = sum_t B_t[s + e_t] [s + e_t >= 0], a function
//     of s alone;
//   the left half is sum_{e >= -s} Ag_e[w] with Ag_e[w] = sum_{t: e_t = e}
//     A_t[w + dw_t]: with mask_left the suffix sum P_k[w] = sum_{e >= k}
//     Ag_e[w] at k = d - w (P_-2, the whole sum, for k < -2; 0 for k > 2),
//     else P_-2,
// so an interior output reads two values, where the per-tap sum reads 18.
// Column 0 needs nothing more (its dw = -1 taps meet u < 0 and an A that
// is zero outside the image); column W - 1 takes GW[d], the sum of its dw
// <= 0 taps at s = W - 1 - d; slices 0 and D - 1 are summed tap by tap over
// their valid taps, their left halves from the column's A taps, their
// right halves from the B taps at s = w (slice 0) and s = w - D + 1 (slice
// D - 1).  D > W, W < 3 and D < 3 need no other path.
//
// A block owns one (n, h) row across W, thread (c, q) column c of each
// chunk of CW = 256 / (O / 4) columns and channels 4q .. 4q + 3.  Per
// chunk a thread holds the nine B taps at s = c0 + c and the nine A taps
// of column w = c0 + c, read from global memory (the B taps at s = -2, -1
// before the first chunk), so each element of a row's maps is read once;
// it writes G[s], slice D - 1's right half of column s + D - 1 and GW to
// shared memory (G and that half in rings of D + 2 CW columns, which no
// thread overwrites while a thread of this chunk still reads them) and
// keeps the five P_k and slice 0's and slice D - 1's sums in registers.
// After one barrier it issues the next chunk's 18 tap loads and, while
// they are in flight, streams its column's D slices: the interior as P_k
// + G[w - d], one 16-byte shared load per four outputs, each d a
// contiguous run per warp.  (At PSMNet's request, 96 rows for 132 SMs, a
// block has its SM to itself, and without that overlap its loads and
// stores took turns.)  The grouped sums run in another order than the
// plain version's; no atomics, so the same bits on every run.  Offsets
// into the output are 64-bit: a batch-4 f32 output is 453 MB.
#include "conv_common.cuh"

namespace {

using dsm::bf16;

constexpr int kStemThreads = 256;
constexpr int kTaps = 9;

__device__ inline float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ inline void add4(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

__device__ inline float4 sum4(float4 a, const float4& b) {
  add4(a, b);
  return a;
}

__device__ inline float4 ld_global4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ inline float4 ld_shared4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ inline void st_shared4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
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

// tap t = 3 (dd + 1) + (dw + 1)
__device__ constexpr int tap_dd(int t) { return t / 3 - 1; }
__device__ constexpr int tap_dw(int t) { return t % 3 - 1; }

// grid N H (block n H + h); `cw` columns per chunk (kStemThreads / (O / 4))
template <typename T>
__global__ void __launch_bounds__(kStemThreads, 2)
    fused_costvol_kernel(const float* __restrict__ A, const float* __restrict__ B,
                         T* __restrict__ out, int H, int W, int O, int D, int mask_left,
                         int cw) {
  extern __shared__ __align__(16) float smem[];
  const int C9 = kTaps * O;        // channels of a map column
  const int Q = O / 4;             // 4-channel groups per output column
  const int R = D + 2 * cw;        // ring columns
  float* s_g = smem;               // G[s] at ring column (s + 2) % R
  float* s_last = s_g + R * O;     // slice D - 1's right half of column s + D - 1, likewise
  float* s_gw = s_last + R * O;    // GW[d], column W - 1's right half, d in [1, D - 2]
  const int n = blockIdx.x / H, h = blockIdx.x - n * H;
  const long long row = (static_cast<long long>(n) * H + h) * W;  // column index of (n, h, 0)
  const int c = threadIdx.x / Q, q = threadIdx.x - c * Q;
  const bool lane_ok = c < cw;

  // the nine B taps that meet s (u = s + e_t) and the nine A taps of
  // column w (w + dw_t), zero outside [0, W)
  auto load_b = [&](int s, bool ok, float4 (&b)[kTaps]) {
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      const int u = s + tap_dw(t) - tap_dd(t);
      b[t] = ok && u >= 0 && u < W ? ld_global4(B + (row + u) * C9 + t * O + 4 * q) : zero4();
    }
  };
  auto load_a = [&](int w, bool ok, float4 (&a)[kTaps]) {
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      const int wa = w + tap_dw(t);
      a[t] = ok && wa >= 0 && wa < W ? ld_global4(A + (row + wa) * C9 + t * O + 4 * q)
                                     : zero4();
    }
  };
  // From the B taps at s: G[s], slice D - 1's right half of column s + D -
  // 1 and GW[W - 1 - s] into shared memory; returns slice 0's right half
  // of column s.
  auto right = [&](int s, const float4 (&b)[kTaps]) -> float4 {
    const int wl = s + D - 1;  // the column whose slice D - 1 meets these taps
    float4 g = zero4(), gw = zero4(), last = zero4(), first = zero4();
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      const int dd = tap_dd(t), dw = tap_dw(t);
      add4(g, b[t]);
      if (dw <= 0) add4(gw, b[t]);
      if (dd <= 0 && wl + dw >= 0 && wl + dw < W) add4(last, b[t]);
      if (dd >= 0 && dd < D && s + dw >= 0 && s + dw < W) add4(first, b[t]);
    }
    const int slot = (s + 2) % R;
    st_shared4(s_g + slot * O + 4 * q, g);
    if (D >= 2 && wl < W) st_shared4(s_last + slot * O + 4 * q, last);
    const int dg = W - 1 - s;
    if (dg >= 1 && dg <= D - 2) st_shared4(s_gw + dg * O + 4 * q, gw);
    return first;
  };

  const long long slice = static_cast<long long>(H) * W * O;  // elements of one d
  T* base = out + (static_cast<long long>(n) * D * H + h) * W * O + 4 * q;
  float4 a[kTaps], b[kTaps];
  if (lane_ok && c < 2) {  // s = -2, -1: their B taps meet columns 0 and 1
    load_b(c - 2, true, b);
    right(c - 2, b);
  }
  load_b(c, lane_ok && c < W, b);
  load_a(c, lane_ok && c < W, a);
#pragma unroll 1
  for (int c0 = 0; c0 < W; c0 += cw) {
    const int w = c0 + c;
    const bool col = lane_ok && w < W;
    float4 first = col ? right(w, b) : zero4();
    // the suffix sums P_k over the groups e = dw - dd: e = 2 is tap 2; 1:
    // taps 1, 5; 0: taps 0, 4, 8; -1: taps 3, 7; -2: tap 6
    const float4 p2 = a[2];
    const float4 p1 = sum4(sum4(p2, a[1]), a[5]);
    const float4 p0 = sum4(sum4(sum4(p1, a[0]), a[4]), a[8]);
    const float4 pm1 = sum4(sum4(p0, a[3]), a[7]);
    const float4 pm2 = sum4(pm1, a[6]);
    // slices 0 and D - 1 tap by tap: their valid dd, each tap's mask u >= 0
    float4 last = zero4();
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      const int dd = tap_dd(t), e = tap_dw(t) - dd;
      if (dd >= 0 && dd < D && (!mask_left || w + e >= 0)) add4(first, a[t]);
      if (dd <= 0 && (!mask_left || w - (D - 1) + e >= 0)) add4(last, a[t]);
    }
    __syncthreads();
    // the next chunk's taps in flight while this chunk's slices are stored
    const int wn = w + cw;
    load_b(wn, lane_ok && wn < W, b);
    load_a(wn, lane_ok && wn < W, a);
    if (!col) continue;
    T* o = base + static_cast<long long>(w) * O;
    store4(o, first);
    int slot = (w + 1) % R;  // G[w - d] at d = 1
#pragma unroll 4
    for (int d = 1; d < D - 1; ++d) {
      const int k = d - w;
      float4 v = !mask_left || k <= -2 ? pm2
                 : k == -1            ? pm1
                 : k == 0             ? p0
                 : k == 1             ? p1
                 : k == 2             ? p2
                                      : zero4();
      if (k <= 2)  // s = w - d >= -2: G (column W - 1: GW) may be nonzero
        add4(v, ld_shared4(w == W - 1 ? s_gw + d * O + 4 * q : s_g + slot * O + 4 * q));
      store4(o + d * slice, v);
      slot = slot == 0 ? R - 1 : slot - 1;
    }
    if (D >= 2) {
      const int sl = w - D + 1;  // the s whose B taps slice D - 1 meets
      if (sl >= -2) add4(last, ld_shared4(s_last + ((sl + 2) % R) * O + 4 * q));
      store4(o + (D - 1) * slice, last);
    }
  }
}

template <typename T>
cudaError_t launch_fused_costvol(const void* A, const void* B, void* out, int N, int H, int W,
                                 int O, int D, int mask_left, cudaStream_t st) {
  constexpr size_t kMaxSmem = 232448;  // the H100's opt-in limit per block
  const int cw = kStemThreads / (O / 4);
  // the rings of G and of slice D - 1's right halves, and GW
  const size_t smem = static_cast<size_t>(2 * (D + 2 * cw) + D) * O * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static std::atomic<uint32_t> smem_set{0};
  const cudaError_t err = dsm::set_smem_once(fused_costvol_kernel<T>, kMaxSmem, smem_set);
  if (err != cudaSuccess) return err;
  fused_costvol_kernel<T><<<N * H, kStemThreads, smem, st>>>(
      static_cast<const float*>(A), static_cast<const float*>(B), static_cast<T*>(out), H, W, O,
      D, mask_left, cw);
  return cudaGetLastError();
}

}  // namespace

// A, B: the float32 tap maps (N, H, W, 9 O); out: (N, D, H, W, O) in `dtype`.
extern "C" int dsm_fused_costvol(const void* A, const void* B, void* out, int dtype, int N, int H,
                                 int W, int O, int D, int mask_left, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || H < 1 || W < 1 || D < 1 || O < 4 || O % 4 != 0 || O > 4 * kStemThreads ||
      static_cast<long long>(N) * H > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == dsm::kBFloat16)
    return static_cast<int>(launch_fused_costvol<bf16>(A, B, out, N, H, W, O, D, mask_left, st));
  if (dtype == dsm::kFloat32)
    return static_cast<int>(launch_fused_costvol<float>(A, B, out, N, H, W, O, D, mask_left, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
