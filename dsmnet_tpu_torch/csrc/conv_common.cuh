// Shared building blocks of the port's hand-written Hopper convolution
// kernels: the forward tiles of conv_k3.cuh (the float32 conv2d_k3.cu,
// conv3d_k3.cu and conv3d_k3s2.cu), the weight gradients of dk_k3.cuh (the
// float32 conv2d_dk_k3.cu, conv3d_dk_k3.cu and conv3d_dk_k3s2.cu), the
// bf16 rings of s2_ring.cuh (conv3d_k3s2.cu, conv3d_dk_k3s2.cu),
// s1_dk_ring.cuh (conv3d_dk_k3.cu, conv2d_dk_k3.cu) and s1_fwd_ring.cuh
// (conv3d_k3.cu, conv2d_k3.cu), and deconv3d_k3s2.cu.
//
// The description below is that of conv_k3.cuh's design; the rings keep a
// block's kernel resident or its partial in registers and walk D or H
// instead.
//
// Every kernel is an implicit GEMM: a block owns a tile of output voxels
// (rows of the GEMM's M) and all Cout channels (N), stages the input rows
// its taps read and the kernel slices of those taps in shared memory with
// cp.async (zero-filled outside the volume: the convolution's padding),
// and reduces taps x Cin (K) in f32 registers, as FMAs in the fragment
// layout of mma.sync m16n8k16; the bf16 designs are the rings.
//
// Shared-memory rows are padded by 16 bytes: a row pitch that is an odd
// multiple of 16 bytes puts the 8 rows that one ldmatrix phase reads in 8
// different bank groups, so the operand loads run without bank conflicts.
// The f32 accumulator tile goes back through shared memory so that each
// output row is written once, with 16-byte stores, in the output dtype.
//
// Layouts are channels-last: activations NHWC / NDHWC, kernels HWIO /
// DHWIO (the flax (3,3,3,Cout,Cin) transpose kernel for the deconv).
// No bias, BN or ReLU: those stay outside the kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

namespace dsm {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// dtype codes shared with the Python wrappers (ops/_build.py)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__host__ __device__ constexpr size_t max_size(size_t a, size_t b) { return a > b ? a : b; }

// Raise `kernel`'s dynamic shared-memory limit to `smem` bytes on the
// current device, once per device: `done` (a static of the caller's
// instantiation) keeps one bit per device, so later launches skip the call.
template <typename Kernel>
inline cudaError_t set_smem_once(Kernel kernel, size_t smem, std::atomic<uint32_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint32_t bit = 1u << (dev & 31);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// elements of T in 16 bytes: one cp.async, and the padding of a staged row
template <typename T>
__host__ __device__ constexpr int vec() { return 16 / static_cast<int>(sizeof(T)); }

// padded pitch (elements) of a staged row of n elements
template <typename T>
__host__ __device__ constexpr int pitch(int n) { return n + vec<T>(); }

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills the destination when !valid
// (src must still be a valid address; no byte of it is read then)
__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ inline void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// Stage `len` columns (C channels each) of one input row, starting at
// column w_lo, as rows of pitch pitch<T>(C).  Column e goes to slot e
// (S == 1) or, for a stride-2 conv, to slot (e & 1) * PLANE + (e >> 1):
// even and odd columns in two planes, so that every stride-2 tap reads
// consecutive slots.  Columns outside [0, W), and every column of a row
// that is not valid, are zeros.  Columns lie LD elements apart in `row`
// (LD > C: the C channels from `row` on of each LD-channel column).
template <typename T, int C, int S, int PLANE, int LD = C>
__device__ inline void stage_row(T* dst, const T* row, bool valid, int w_lo, int len, int W) {
  constexpr int V = C / vec<T>();
  constexpr int P = pitch<T>(C);
  for (int i = threadIdx.x; i < len * V; i += kThreads) {
    const int e = i / V;
    const int q = i - e * V;
    const int w = w_lo + e;
    const bool ok = valid && w >= 0 && w < W;
    const int slot = S == 1 ? e : (e & 1) * PLANE + (e >> 1);
    cp_async16(dst + slot * P + q * vec<T>(),
               ok ? row + static_cast<long long>(w) * LD + q * vec<T>() : row, ok);
  }
}

// Stage `rows` rows of COLS contiguous elements as rows of pitch pitch<T>(COLS).
template <typename T, int COLS>
__device__ inline void stage_matrix(T* dst, const T* src, int rows) {
  constexpr int V = COLS / vec<T>();
  constexpr int P = pitch<T>(COLS);
  for (int i = threadIdx.x; i < rows * V; i += kThreads) {
    const int r = i / V;
    const int q = i - r * V;
    cp_async16(dst + r * P + q * vec<T>(), src + static_cast<long long>(r) * COLS + q * vec<T>(),
               true);
  }
}

// ---------------------------------------------------------------------------
// One warp's 16 x (8 NI) accumulator tile: c[ni] holds, in the m16n8
// fragment layout of mma.sync, rows g and g + 8 and columns 2t, 2t + 1 of
// n-tile ni (g = lane / 4, t = lane % 4).
//
// tile_mma<K, P, PB, NI, BKN>(c, a, b) adds A (16 x K, rows of pitch P in
// shared memory, row 0 at a) times B (K x 8 NI).  B is stored k-major
// ([k][n], pitch PB, BKN) or n-major ([n][k], pitch PB), with b at its
// (k = 0, n = 0) element.
// ---------------------------------------------------------------------------
__device__ inline void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ inline void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The tile as FMAs, element by element, in the fragment layout.
template <int K, int P, int PB, int NI, bool BKN>
__device__ inline void tile_mma(float (&c)[NI][4], const float* a, const float* b) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* a0 = a + g * P;
  const float* a1 = a + (g + 8) * P;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float x0 = a0[k], x1 = a1[k];
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int n = ni * 8 + 2 * t;
      const float b0 = BKN ? b[k * PB + n] : b[n * PB + k];
      const float b1 = BKN ? b[k * PB + n + 1] : b[(n + 1) * PB + k];
      c[ni][0] = fmaf(x0, b0, c[ni][0]);
      c[ni][1] = fmaf(x0, b1, c[ni][1]);
      c[ni][2] = fmaf(x1, b0, c[ni][2]);
      c[ni][3] = fmaf(x1, b1, c[ni][3]);
    }
  }
}

template <int NI>
__device__ inline void zero_tile(float (&c)[NI][4]) {
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) c[ni][0] = c[ni][1] = c[ni][2] = c[ni][3] = 0.0f;
}

// Write a warp's tile into the f32 tile in shared memory (pitch OP
// floats): fragment row i goes to row m0 + i * mstride, column n to n0 + n.
template <int NI, int OP>
__device__ inline void store_tile(float* out, const float (&c)[NI][4], int m0, int mstride,
                                  int n0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* r0 = out + (m0 + g * mstride) * OP + n0 + 2 * t;
  float* r1 = out + (m0 + (g + 8) * mstride) * OP + n0 + 2 * t;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    *reinterpret_cast<float2*>(r0 + ni * 8) = make_float2(c[ni][0], c[ni][1]);
    *reinterpret_cast<float2*>(r1 + ni * 8) = make_float2(c[ni][2], c[ni][3]);
  }
}

// Copy rows of the f32 tile (pitch OP) to y (T = float), 8 channels per
// store.  row_ptr(m) is row m's address in y, or nullptr for a row
// outside the output.
template <typename T, int CO, int OP, typename RowPtr>
__device__ inline void write_rows(const float* tile, int nrows, RowPtr row_ptr) {
  static_assert(std::is_same<T, float>::value, "the tiles write float32");
  constexpr int Q = CO / 8;
  for (int i = threadIdx.x; i < nrows * Q; i += kThreads) {
    const int m = i / Q;
    const int q = i - m * Q;
    T* d = row_ptr(m);
    if (d == nullptr) continue;
    d += q * 8;
    const float* s = tile + m * OP + q * 8;
    float4* d4 = reinterpret_cast<float4*>(d);
    d4[0] = make_float4(s[0], s[1], s[2], s[3]);
    d4[1] = make_float4(s[4], s[5], s[6], s[7]);
  }
}

}  // namespace dsm
