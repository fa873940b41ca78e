// Kernel D: 3x3x3 stride-2 transposed 3-D convolution with torch geometry
// padding 1, output_padding 1 (an exact 2x upsample), no bias,
// Cin = 64 -> Cout = 32, on the flax transpose kernel k (3, 3, 3, Cout, Cin).
//
// Replaces the TPU kernel conv3d_s2_dx_pallas_folded
// (dsmnet_tpu/ops/conv3d_s2_pallas.py:570).  Three roles: the forward of
// PSMNet's hourglass conv6 deconv (dsmnet_tpu/ops/folded.py:319-330),
// (N, 24, 48, 96, 64) -> (N, 48, 96, 192, 32) at 384x768, D = 192; the dx
// of the C = 32 stride-2 conv (the same shape at batch 4 in training); and
// the forward of GCNet's 64 -> 32 deconv l36, (1, 48, 96, 192, 64).
//
// Semantics (lax.conv_transpose with pads (1, 2) and transpose_kernel,
// dsmnet_tpu/ops/conv3d.py:433): y[2u + s - 1] += k[s] . x[u] per axis,
// i.e. per output parity p and m = o // 2
//     p = 0:  y[2m]     = k[1] . x[m]
//     p = 1:  y[2m + 1] = k[2] . x[m] + k[0] . x[m + 1]   (x[m + 1] = 0 past the end)
// and the 3-D tap set of an output is the product of its three axes'
// sets.
//
// What bounds it on the H100: the output has 8x the input's voxels, so
// 2 * 27 * 64 * 32 FLOP per input voxel against 1 input and 8 output
// voxels of bf16 is ~170 FLOP/byte, below the ~295 FLOP/byte ridge: the
// memory traffic bounds it (0.0845 ms at the train shape).
//
// The bf16 design (deconv_ring_kernel) walks D as kernel C's mirror.  A
// block owns a 4 x 32 tile of input (h, w) positions (all four output
// parities of each: an 8 x 64 output tile) and a run of input slices
// u0 .. u1 - 1; it keeps all 27 kernel taps resident in shared memory
// (110.6 KB, in the 128-byte-swizzled K-major layout that wgmma reads as
// its B operand) and streams the input slices u0 .. u1 through a
// three-slot TMA ring, with the h + 1 / w + 1 halo zero-filled by the TMA.
// Input slice u feeds output slice 2u through kd = 1 and slices 2u + 1
// and 2u - 1 through kd = 2 and kd = 0; output slice 2u is finished from
// slice u alone, 2u + 1 from slices u and u + 1, both in the same step, so
// one accumulator set per thread suffices (4 parities x m64n32).  The A
// operand of tap (kh, kw) is the slot shifted by (kh == 0, kw == 0) rows
// and columns, loaded into registers with ldmatrix once per shift and kd
// and used by every tap with that shift (wgmma m64n32k16 with A from
// registers; the next shift's loads overlap the current wgmmas).  A
// finished output slice goes through shared memory and leaves as one TMA
// store of the 8 x 64 x 32 tile (clipped at the ragged edge): every output
// byte is written once, coalesced.  The run length comes from the wrapper
// (ops/conv3d.py deconv_run), sized so the grid fills the card.
//
// The float32 instantiation keeps the design below (deconv_k3s2_kernel,
// for the checks): output-stationary over one output row, <= 4 input rows
// and the kernel slices of their taps staged with cp.async per block.
#include "s2_ring.cuh"

namespace {

using namespace dsm;

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

// ------------------------------------------------------------ bf16: the ring

// A block: RH x TM = 4 x 32 input positions of one n (two warpgroups of 64:
// warp w owns input row w / 2, columns 16 (w % 2) .. + 15) and their 8 x 64
// outputs per output slice.  A ring slot holds one input slice's RH + 1
// rows of TM + 1 columns x 64 channels, one TMA box of the (N Di, Hi, Wi,
// 64) view swizzled in 128-byte lines.  The resident kernel holds row
// r = tap * 32 + co of 64 input channels (128 bytes, 16-byte chunk q at
// q ^ (r & 7)).  The output tile is staged as (oh, ow) lines of 32 bf16
// channels (64 bytes, the TMA's 64-byte swizzle).
struct DeconvRing {
  static constexpr int CI = 64, CO = 32, RH = 4, TM = 32;
  static constexpr int NT = 256;                           // 2 warpgroups
  static constexpr int ROWS = RH + 1, COLS = TM + 1;       // with the h + 1 / w + 1 halo
  static constexpr int SLOT_BOX = ROWS * COLS * CI * 2;
  static constexpr int SLOT_PITCH = (SLOT_BOX + 1023) / 1024 * 1024;
  static constexpr int NS = 3;                             // ring slots
  static constexpr int W_BYTES = 27 * CO * CI * 2;         // the resident kernel
  static constexpr int OUT_BYTES = 2 * RH * 2 * TM * CO * 2;
  static constexpr int KS = CI / 16;                       // k16 steps of a tap
  static constexpr size_t SMEM = static_cast<size_t>(W_BYTES) + NS * SLOT_PITCH + OUT_BYTES + 64;
  static_assert(RH * TM == 16 * NT / 32 && W_BYTES % 1024 == 0, "a warp owns 16 positions");
  static_assert(SMEM <= 232448, "shared memory");
};

// wgmma descriptor of 8-row groups of 128-byte K-major lines, 128-byte
// swizzle, from shared address `addr` (a k16 step is 32 bytes on)
__device__ inline uint64_t kmajor_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// d (m64 x 32, f32) += a (the warp's m16 x k16 rows, registers) x b (k16 x
// 32, shared memory, K-major)
__device__ inline void wgmma_n32_kmajor(float (&d)[4][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

// Taps of kd_a on the slice at `slot_a` and, when TWO, of kd_b on the slice
// at `slot_b`, into the four parity tiles acc[2 ph + pw].  Group j is one
// (slice, A shift): shift s = (sh, sw) reads the slot sh rows and sw
// columns on, the x[m + 1] of the taps kh = 0 (sh) and kw = 0 (sw); its
// taps are kh in {0} or {1, 2} times kw in {0} or {1, 2}.  Each group is
// one commit of wgmmas; the next group's A fragments are loaded while the
// current one runs, into a third buffer, so a wait only covers the group
// before.
template <bool TWO>
__device__ __forceinline__ void deconv_taps(float (&acc)[4][4][4], uint32_t w_base, uint32_t slot_a,
                                            int kd_a, uint32_t slot_b, int kd_b) {
  using R = DeconvRing;
  constexpr int G = TWO ? 8 : 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int line0 = (warp >> 1) * R::COLS + (warp & 1) * 16 + (lane & 15);
  auto load = [&](uint32_t (&a)[R::KS][4], int j) {
    const int s = j & 3;
    const uint32_t line =
        (j < 4 ? slot_a : slot_b) + (line0 + (s >> 1) * R::COLS + (s & 1)) * (R::CI * 2);
#pragma unroll
    for (int ks = 0; ks < R::KS; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) reg_fence(a[ks][e]);  // its last wgmma has retired
      ldsm_x4(a[ks], swz_chunk<128>(line, 2 * ks + (lane >> 4)));
    }
  };
  auto issue = [&](const uint32_t (&a)[R::KS][4], int j) {
    const int s = j & 3, sh = s >> 1, sw = s & 1;
    const int kd = j < 4 ? kd_a : kd_b;
    wgmma_fence();
    // k16 step outermost: consecutive wgmmas write different parity tiles
#pragma unroll
    for (int ks = 0; ks < R::KS; ++ks)
#pragma unroll
      for (int ih = 0; ih < 2 - sh; ++ih)
#pragma unroll
        for (int iw = 0; iw < 2 - sw; ++iw) {
          const int kh = sh ? 0 : 1 + ih, kw = sw ? 0 : 1 + iw;
          const uint32_t b = w_base + (kd * 9 + kh * 3 + kw) * R::CO * (R::CI * 2) + ks * 32;
          wgmma_n32_kmajor(acc[(kh != 1) * 2 + (kw != 1)], a[ks], kmajor_desc(b));
        }
    wgmma_commit();
  };
  uint32_t a[3][R::KS][4];
  load(a[0], 0);
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j + 1 < G) load(a[(j + 1) % 3], j + 1);  // its buffer's group j - 2 has retired
    issue(a[j % 3], j);
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int ks = 0; ks < R::KS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) reg_fence(a[i][ks][e]);
#pragma unroll
  for (int c = 0; c < 4; ++c) fence_tile(acc[c]);
}

// Output slice `ys` (of the (N Do, Ho, Wo, 32) view) of the block's tile:
// the accumulators to the staged tile in bf16, then one TMA store from it
// (rows and columns past the edge are not written).  The tile is reused
// once the previous store has read it.
__device__ __forceinline__ void deconv_store(float (&acc)[4][4][4], uint32_t s_out,
                                             const CUtensorMap* ymap, int ow0, int oh0, int ys) {
  using R = DeconvRing;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  if (threadIdx.x == 0) tma_store_wait<true>();
  __syncthreads();
#pragma unroll
  for (int cls = 0; cls < 4; ++cls) {
    const int ph = cls >> 1, pw = cls & 1;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      // input position (warp / 2, 16 (warp % 2) + g + 8 hf) -> output (2 r + ph, 2 c + pw)
      const int oh = 2 * (warp >> 1) + ph, ow = 2 * ((warp & 1) * 16 + g + 8 * hf) + pw;
      const uint32_t line = s_out + (oh * 2 * R::TM + ow) * (R::CO * 2);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        st_shared_u32(swz_chunk<64>(line, ni) + 4 * t,
                      pack_bf16x2(acc[cls][ni][2 * hf], acc[cls][ni][2 * hf + 1]));
        acc[cls][ni][2 * hf] = acc[cls][ni][2 * hf + 1] = 0.0f;
      }
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) tma_store_4d(ymap, s_out, 0, ow0, oh0, ys);
}

// grid (ceil(Wi / TM), ceil(Hi / RH), N * runs); a block takes input slices
// u0 .. u1 - 1 of its run (and slice u1 for output 2 u1 - 1) and writes
// output slices 2 u0 .. 2 u1 - 1.  `xmap`: x as (64, Wi, Hi, N Di), box
// (64, TM + 1, RH + 1, 1); `ymap`: y as (32, Wo, Ho, N Do), box (32, 2 TM,
// 2 RH, 1).
__global__ void __launch_bounds__(DeconvRing::NT, 1)
    deconv_ring_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap ymap, const bf16* __restrict__ w, int Di,
                       int run, int runs) {
  using R = DeconvRing;
  constexpr int NS = R::NS;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t w_base = smem_u32(smem);
  const uint32_t s_in = w_base + R::W_BYTES;
  const uint32_t s_out = s_in + NS * R::SLOT_PITCH;
  const uint32_t s_bar = s_out + R::OUT_BYTES;   // NS mbarriers

  const int mw0 = blockIdx.x * R::TM, mh0 = blockIdx.y * R::RH;
  const int n = blockIdx.z / runs;
  const int u0 = (blockIdx.z - n * runs) * run;
  const int u1 = min(Di, u0 + run);
  const int nsl = min(u1 + 1, Di) - u0;  // slices staged: u0 .. min(u1, Di - 1)

  // slice u0 + i into slot i % NS
  auto issue = [&](int i) {
    const uint32_t bar = s_bar + (i % NS) * 8;
    mbar_arrive_tx(bar, R::SLOT_BOX);
    tma_load_4d(s_in + (i % NS) * R::SLOT_PITCH, &xmap, 0, mw0, mh0, n * Di + u0 + i, bar);
  };
  auto wait_slot = [&](int i) {
    while (!mbar_try_wait(s_bar + (i % NS) * 8, (i / NS) & 1)) {
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(s_bar + s * 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < min(NS, nsl); ++i) issue(i);
  for (int i = threadIdx.x; i < 27 * R::CO * 8; i += R::NT) {
    const int r = i >> 3, q = i & 7;
    cp_async16(smem + r * 128 + ((q ^ (r & 7)) << 4), w + static_cast<long long>(r) * R::CI + q * 8,
               true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // wgmma reads it
  __syncthreads();

  float acc[4][4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) zero_tile(acc[c]);
  const int Do = 2 * Di;
#pragma unroll 1
  for (int i = 0; i < u1 - u0; ++i) {
    const int u = u0 + i;
    const uint32_t cur = s_in + (i % NS) * R::SLOT_PITCH;
    wait_slot(i);
    // output slice 2u: x[u] through kd = 1
    deconv_taps<false>(acc, w_base, cur, 1, 0, 0);
    deconv_store(acc, s_out, &ymap, 2 * mw0, 2 * mh0, n * Do + 2 * u);
    // output slice 2u + 1: x[u] through kd = 2, x[u + 1] (zero past the end) through kd = 0
    if (u + 1 < Di) {
      wait_slot(i + 1);
      deconv_taps<true>(acc, w_base, cur, 2, s_in + ((i + 1) % NS) * R::SLOT_PITCH, 0);
    } else {
      deconv_taps<false>(acc, w_base, cur, 2, 0, 0);
    }
    deconv_store(acc, s_out, &ymap, 2 * mw0, 2 * mh0, n * Do + 2 * u + 1);
    // every warp is done with slot i (deconv_store synchronised): refill it
    if (threadIdx.x == 0 && i + NS < nsl) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(i + NS);
    }
  }
  if (threadIdx.x == 0) tma_store_wait<false>();
}

// x (N, Di, Hi, Wi, 64) bf16, w (3, 3, 3, 32, 64), y (N, 2Di, 2Hi, 2Wi, 32);
// `run` input slices per block
cudaError_t launch_deconv_ring(const void* x, const void* w, void* y, int N, int Di, int Hi, int Wi,
                               int run, cudaStream_t stream) {
  using R = DeconvRing;
  static std::atomic<uint32_t> smem_set{0};
  cudaError_t err = dsm::set_smem_once(deconv_ring_kernel, R::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  if (run < 1 || N < 1 || Di < 1 || Hi < 1 || Wi < 1) return cudaErrorInvalidValue;
  CUtensorMap xmap, ymap;
  const cuuint64_t xdims[4] = {R::CI, static_cast<cuuint64_t>(Wi), static_cast<cuuint64_t>(Hi),
                               static_cast<cuuint64_t>(N) * static_cast<cuuint64_t>(Di)};
  const cuuint64_t xstrides[3] = {R::CI * 2, static_cast<cuuint64_t>(Wi) * R::CI * 2,
                                  static_cast<cuuint64_t>(Hi) * Wi * R::CI * 2};
  const cuuint32_t xbox[4] = {R::CI, R::COLS, R::ROWS, 1};
  const cuuint64_t ydims[4] = {R::CO, static_cast<cuuint64_t>(2 * Wi),
                               static_cast<cuuint64_t>(2 * Hi),
                               static_cast<cuuint64_t>(N) * static_cast<cuuint64_t>(2 * Di)};
  const cuuint64_t ystrides[3] = {R::CO * 2, static_cast<cuuint64_t>(2 * Wi) * R::CO * 2,
                                  static_cast<cuuint64_t>(4) * Hi * Wi * R::CO * 2};
  const cuuint32_t ybox[4] = {R::CO, 2 * R::TM, 2 * R::RH, 1};
  if (!dsm::make_map(&xmap, x, xdims, xstrides, xbox, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !dsm::make_map(&ymap, y, ydims, ystrides, ybox, CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;
  const int runs = (Di + run - 1) / run;
  const dim3 grid((Wi + R::TM - 1) / R::TM, (Hi + R::RH - 1) / R::RH, N * runs);
  deconv_ring_kernel<<<grid, R::NT, R::SMEM, stream>>>(xmap, ymap, static_cast<const bf16*>(w), Di,
                                                      run, runs);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dsm_deconv3d_k3s2(const void* x, const void* w, void* y, int dtype, int N, int D,
                                 int H, int W, int Cin, int Cout, int run, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Cin != 64 || Cout != 32) return static_cast<int>(cudaErrorInvalidValue);
  // bf16: the ring, 4 x 32 input tiles (W = 96 and 192 without a ragged
  // tile), mirrored in ops/conv3d.py (DECONV_TILE); float32: one output row
  // per block, 64 input columns
  if (dtype == dsm::kBFloat16)
    return static_cast<int>(launch_deconv_ring(x, w, y, N, D, H, W, run, st));
  if (dtype == dsm::kFloat32)
    return static_cast<int>(launch_deconv<float, 64, 32, 64>(x, w, y, N, D, H, W, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
