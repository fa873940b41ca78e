// The bf16 design of kernel F on the H100: the weight gradient of the
// 3x3x3 stride-1 SAME convolution,
//
//   dK[kd, kh, kw, c, o] = sum over positions p of x[p + (kd, kh, kw) - 1, c] * g[p, o],
//
// as M = 27 taps x C, N = Co, K = positions, on G's row ring
// (s2_ring.cuh).  A block owns one kd, all nine (kh, kw) taps and COB of
// the Co output channels, and walks a contiguous range of cotangent rows
// (n, od, w-segment, oh) with oh fastest.  The slot of row oh holds the g
// row segment (TW positions x COB channels) and the x row oh + 1 of slice
// od + kd - 1 (TW + 2 columns with the halo, C channels); x row oh is the
// previous slot's, x row oh - 1 the one before.  So a staged x row feeds
// kh = 2, 1 and 0 for oh = h - 1, h and h + 1 while it sits in the
// five-slot ring, and x and g reach shared memory three times a launch
// (once per kd block), not nine.  The rows a row's taps read that are not
// in the ring come with it: at a line's first row (oh = 0) the slot also
// holds x row 0, at the block's first row also x row oh, and a halo buffer
// x row oh - 1.  Row -1 and slices -1 and D are padding: their taps are
// skipped; rows and columns past the edge arrive as zeros from the TMA.
//
// Every operand reaches shared memory as a TMA box completing on the slot's
// mbarrier: x as (C, W, H, N D) in boxes of min(C, 64) channels (C = 128:
// two channel planes), g as (Co, W, H, N D) in boxes of COB channels, each
// swizzled in its line width (32, 64 or 128 bytes).  One thread keeps three
// rows in flight while the warps run mma.sync on the slots that have
// arrived.  Tap kw is the staged x row shifted by kw positions, read with
// ldmatrix.trans at the shifted address, so no shared-memory layout has to
// describe the shift.  A warp owns one tap, or the three kw taps of one
// kh, which then share the g fragments it loads; a tap's C channels may be
// split over warps (MS).
//
// Each block writes one f32 partial of its kd's taps and its Co tile; the
// chunks (ops/conv3d.py dk_k3_chunks, one per block that runs at once) are
// added in a fixed order by dk_reduce: the same bits on every run, no
// float atomics.
//
// Kernel E (conv2d_dk_k3.cu), the 3x3 2-D conv's dK, runs the same ring at
// KD = 1: x and g viewed as (N, 1, H, W, C), only the centre kd's blocks,
// so each block takes all nine (kh, kw) taps and x and g reach shared
// memory once a launch.
#pragma once

#include "s2_ring.cuh"

namespace dsm {

// C input channels, CO output channels in tiles of COB, segments of TW
// positions, TPW taps per warp (1: one per (kh, kw); 3: the three kw taps
// of one kh, which share the g fragments), each tap's C channels split
// over MS warps.  A slot: x rows
// oh (loaded at a line's or the block's first row) and oh + 1, each XP
// planes of TW + 2 lines of LBX bytes, then the g segment, TW lines of LBG
// bytes.
template <int C, int CO, int COB, int TW, int TPW, int MS, int KD = 3>
struct S1Dk {
  static constexpr int kTW = TW, kTPW = TPW;
  static constexpr int NT = 9 / TPW * MS * 32;
  static constexpr int NCOB = CO / COB;               // Co tiles
  static constexpr int CP = C < 64 ? C : 64;          // channels of an x plane (one TMA box)
  static constexpr int XP = C / CP;                   // planes of an x row
  static constexpr int LBX = CP * 2;                  // bytes of an x line
  static constexpr int LBG = COB * 2;                 // bytes of a g line
  static constexpr int XCOLS = TW + 2;                // x columns of a segment, with the halo
  static constexpr int X_BOX = XCOLS * LBX;           // bytes of one x box
  static constexpr int PLANE_PITCH = (X_BOX + 1023) / 1024 * 1024;
  static constexpr int XROW = XP * PLANE_PITCH;       // one staged x row
  static constexpr int G_BYTES = TW * LBG;
  static constexpr int STAGE_BYTES = 2 * XROW + G_BYTES;
  static constexpr int NS = 5;                        // ring slots
  static constexpr int LEAD = NS - 2;                 // rows in flight (two slots are read back)
  static constexpr int MI = C / 16;
  static constexpr int MIW = MI / MS;                 // m16 tiles of a warp
  static constexpr int NI = COB / 8;
  static constexpr int TOTAL = KD * 9 * C * CO;       // KD = 1: the 2-D conv's nine taps
  // the ring, the halo row, NS mbarriers
  static constexpr size_t SMEM = static_cast<size_t>(NS) * STAGE_BYTES + XROW + 64;
  static_assert(TW % 16 == 0 && XCOLS <= 256 && C % 16 == 0 && (C <= 64 || C % 64 == 0) &&
                    CO % COB == 0 && NI % 2 == 0 && G_BYTES % 1024 == 0 &&
                    (TPW == 1 || TPW == 3) && MI % MS == 0 && (KD == 1 || KD == 3),
                "widths");
  static_assert(LBG == 32 || LBG == 64 || LBG == 128, "g line");
  static_assert(SMEM <= 232448, "shared memory");
};

// One staged row into a warp's taps kw0 .. kw0 + TPW - 1 of one kh, its
// channels 16 mi0 .. 16 (mi0 + MIW) - 1: c[t] += x_tap (k-major; the x row
// at `xr`, its line 0 the segment's column -1) g (TW x COB at `sg`); the g
// fragments are loaded once for all TPW taps.  A k16 step moves every
// lane's ldmatrix address by 16 lines, two periods of the line's swizzle (8
// lines), so each address is swizzled once per row and then only offset.
template <typename Cfg>
__device__ __forceinline__ void s1_dk_row(float (&c)[Cfg::kTPW][Cfg::MIW][Cfg::NI][4], uint32_t xr,
                                          uint32_t sg, int kw0, int mi0) {
  const int lane = threadIdx.x & 31;
  // ldmatrix.x4.trans as in dk_k3.cuh: matrix j covers m offset (j & 1) * 8
  // and k offset (j >> 1) * 8 of the m16 x k16 A fragment; tap kw reads
  // column j + kw for position j
  const int a_row = (lane & 7) + (lane >> 4) * 8 + kw0;
  const int a_chunk = (lane >> 3) & 1;
  uint32_t g_addr[Cfg::NI / 2], x_addr[Cfg::kTPW][Cfg::MIW];
#pragma unroll
  for (int np = 0; np < Cfg::NI / 2; ++np)
    g_addr[np] = swz_chunk<Cfg::LBG>(sg + (lane & 15) * Cfg::LBG, 2 * np + (lane >> 4));
#pragma unroll
  for (int t = 0; t < Cfg::kTPW; ++t)
#pragma unroll
    for (int mi = 0; mi < Cfg::MIW; ++mi) {
      const int m = (mi0 + mi) * 16, plane = m / Cfg::CP, q = m % Cfg::CP / 8;
      x_addr[t][mi] = swz_chunk<Cfg::LBX>(xr + plane * Cfg::PLANE_PITCH + (a_row + t) * Cfg::LBX,
                                          q + a_chunk);
    }
#pragma unroll
  for (int k0 = 0; k0 < Cfg::kTW; k0 += 16) {
    uint32_t bf[Cfg::NI / 2][4];
#pragma unroll
    for (int np = 0; np < Cfg::NI / 2; ++np) ldsm_x4_trans(bf[np], g_addr[np] + k0 * Cfg::LBG);
#pragma unroll
    for (int t = 0; t < Cfg::kTPW; ++t) {
      uint32_t af[Cfg::MIW][4];
#pragma unroll
      for (int mi = 0; mi < Cfg::MIW; ++mi) ldsm_x4_trans(af[mi], x_addr[t][mi] + k0 * Cfg::LBX);
#pragma unroll
      for (int mi = 0; mi < Cfg::MIW; ++mi)
#pragma unroll
        for (int np = 0; np < Cfg::NI / 2; ++np) {
          mma_bf16(c[t][mi][2 * np], af[mi], bf[np][0], bf[np][1]);
          mma_bf16(c[t][mi][2 * np + 1], af[mi], bf[np][2], bf[np][3]);
        }
    }
  }
}

// grid (KD kd x NCOB Co tiles, chunks), kd fastest; chunk b sums the
// cotangent rows [b * per, (b + 1) * per) of the `items` rows (n, od,
// w-segment, oh), oh fastest, into ws[b].  `xmap`: x as (C, W, H, N D),
// box (CP, TW + 2, 1, 1); `gmap`: g as (CO, W, H, N D), box (COB, TW, 1, 1).
template <int C, int CO, int COB, int TW, int TPW, int MS, int MINB, int KD>
__global__ void __launch_bounds__(S1Dk<C, CO, COB, TW, TPW, MS, KD>::NT, MINB)
    s1_dk_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap gmap,
                 float* __restrict__ ws, int D, int H, int nseg, int items, int per) {
  using Cfg = S1Dk<C, CO, COB, TW, TPW, MS, KD>;
  constexpr int NS = Cfg::NS, LEAD = Cfg::LEAD;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t s_ring = smem_u32(smem);
  const uint32_t s_halo = s_ring + NS * Cfg::STAGE_BYTES;   // x row oh - 1 of the first row
  const uint32_t s_bar = s_halo + Cfg::XROW;

  // KD = 1 (the 2-D conv, D = 1): only the centre kd's blocks run
  const int kd = KD == 3 ? blockIdx.x % 3 : 1;
  const int o0 = blockIdx.x / KD * COB;
  const int i_lo = blockIdx.y * per;
  const int i_hi = min(items, i_lo + per);
  const int lane = threadIdx.x & 31;

  // every plane of x row h of slice nd (columns w0 - 1 .. w0 + TW)
  auto x_row = [&](uint32_t dst, int nd, int h, int w0, uint32_t bar) {
#pragma unroll
    for (int p = 0; p < Cfg::XP; ++p)
      tma_load_4d(dst + p * Cfg::PLANE_PITCH, &xmap, p * Cfg::CP, w0 - 1, h, nd, bar);
  };
  // row it into slot (it - i_lo) % NS; a row of padding slice only arrives
  auto issue = [&](int it) {
    const int slot = (it - i_lo) % NS;
    const uint32_t bar = s_bar + slot * 8, dst = s_ring + slot * Cfg::STAGE_BYTES;
    const int line = it / H, oh = it - line * H;
    const int nd = line / nseg, w0 = (line - nd * nseg) * TW;
    const int n = nd / D, d = nd - n * D + kd - 1;
    if (d < 0 || d >= D) {
      mbar_arrive_tx(bar, 0);
      return;
    }
    const bool first = it == i_lo;
    const bool extra = first || oh == 0;   // x row oh is not in the ring
    const bool halo = first && oh > 0;     // nor is x row oh - 1
    mbar_arrive_tx(bar, Cfg::XP * Cfg::X_BOX * (1 + extra + halo) + Cfg::G_BYTES);
    const int xd = n * D + d;
    x_row(dst + Cfg::XROW, xd, oh + 1, w0, bar);
    if (extra) x_row(dst, xd, oh, w0, bar);
    if (halo) x_row(s_halo, xd, oh - 1, w0, bar);
    tma_load_4d(dst + 2 * Cfg::XROW, &gmap, o0, w0, oh, nd, bar);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(s_bar + s * 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int it = i_lo; it < min(i_hi, i_lo + LEAD); ++it) issue(it);

  // the x row that taps kh read for the block's k-th row, oh: kh = 2 this
  // slot's; kh = 1 this slot's extra row at a line's or the block's first
  // row, else the previous slot's; kh = 0 the halo at the block's first
  // row, the previous slot's extra row at the second (or at oh = 1), else
  // the slot before's (none at oh = 0: padding)
  auto x_row_of = [&](int kh, int k, int oh) -> uint32_t {
    const uint32_t cur = s_ring + (k % NS) * Cfg::STAGE_BYTES;
    const uint32_t prev = s_ring + ((k + NS - 1) % NS) * Cfg::STAGE_BYTES;
    const uint32_t prev2 = s_ring + ((k + NS - 2) % NS) * Cfg::STAGE_BYTES;
    if (kh == 2) return cur + Cfg::XROW;
    if (kh == 1) return (k == 0 || oh == 0) ? cur : prev + Cfg::XROW;
    return k == 0 ? s_halo : (k == 1 || oh == 1) ? prev : prev2 + Cfg::XROW;
  };
  float* out = ws + static_cast<long long>(blockIdx.y) * Cfg::TOTAL +
               (KD == 3 ? kd : 0) * 9 * C * CO + o0;
  const int gq = lane >> 2, tq = lane & 3;

  // this warp's taps (kh, kw0 .. kw0 + TPW - 1) and m16 tiles mi0 ..
  const int warp = threadIdx.x / 32, group = warp / MS, mi0 = warp % MS * Cfg::MIW;
  const int kh = TPW == 1 ? group / 3 : group, kw0 = TPW == 1 ? group % 3 : 0;
  float c[TPW][Cfg::MIW][Cfg::NI][4];
#pragma unroll
  for (int t = 0; t < TPW; ++t)
#pragma unroll
    for (int mi = 0; mi < Cfg::MIW; ++mi) zero_tile(c[t][mi]);
#pragma unroll 1
  for (int it = i_lo; it < i_hi; ++it) {
    const int k = it - i_lo;
    while (!mbar_try_wait(s_bar + (k % NS) * 8, (k / NS) & 1)) {
    }
    const int line = it / H, oh = it - line * H;
    const int d = (line / nseg) % D + kd - 1;
    if (d >= 0 && d < D && (kh > 0 || oh > 0))
      s1_dk_row<Cfg>(c, x_row_of(kh, k, oh), s_ring + (k % NS) * Cfg::STAGE_BYTES + 2 * Cfg::XROW,
                     kw0, mi0);
    // every warp is done with row it - 2's slot: refill it with row it + LEAD
    __syncthreads();
    if (threadIdx.x == 0 && it + LEAD < i_hi) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(it + LEAD);
    }
  }
  // this block's partial: rows (kh, kw, c) of its kd, columns o0 ..
#pragma unroll
  for (int t = 0; t < TPW; ++t)
#pragma unroll
    for (int mi = 0; mi < Cfg::MIW; ++mi) {
      float* o = out + ((kh * 3 + kw0 + t) * C + (mi0 + mi) * 16 + gq) * CO + 2 * tq;
#pragma unroll
      for (int ni = 0; ni < Cfg::NI; ++ni) {
        *reinterpret_cast<float2*>(o + ni * 8) = make_float2(c[t][mi][ni][0], c[t][mi][ni][1]);
        *reinterpret_cast<float2*>(o + 8 * CO + ni * 8) =
            make_float2(c[t][mi][ni][2], c[t][mi][ni][3]);
      }
    }
}

// x (N, D, H, W, C) and g (N, D, H, W, CO) bf16; ws holds `chunks`
// partials of KD 9 C CO floats; `reduce` adds them into dk.  KD = 1: the
// 3x3 2-D conv's dK (kernel E), x and g viewed as (N, 1, H, W, C), D = 1.
template <int C, int CO, int COB, int TW, int TPW, int MS, int MINB, int KD = 3, typename Reduce>
cudaError_t launch_s1_dk(const void* x, const void* g, void* dk, void* ws, int N, int D, int H,
                         int W, int chunks, Reduce reduce, cudaStream_t stream) {
  using Cfg = S1Dk<C, CO, COB, TW, TPW, MS, KD>;
  auto kernel = s1_dk_kernel<C, CO, COB, TW, TPW, MS, MINB, KD>;
  static std::atomic<uint32_t> smem_set{0};
  cudaError_t err = set_smem_once(kernel, Cfg::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const int nseg = (W + TW - 1) / TW;
  const long long items64 = static_cast<long long>(N) * D * nseg * H;
  if (items64 <= 0 || items64 > 0x7fffffff || chunks <= 0 || chunks > items64 ||
      (KD == 1 && D != 1))
    return cudaErrorInvalidValue;
  const int items = static_cast<int>(items64);
  const int per = (items + chunks - 1) / chunks;
  const cuuint64_t nd = static_cast<cuuint64_t>(N) * static_cast<cuuint64_t>(D);
  CUtensorMap xmap, gmap;
  const cuuint64_t xdims[4] = {C, static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H), nd};
  const cuuint64_t xstrides[3] = {static_cast<cuuint64_t>(C) * 2,
                                  static_cast<cuuint64_t>(W) * C * 2,
                                  static_cast<cuuint64_t>(H) * W * C * 2};
  const cuuint32_t xbox[4] = {Cfg::CP, Cfg::XCOLS, 1, 1};
  const cuuint64_t gdims[4] = {CO, static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H), nd};
  const cuuint64_t gstrides[3] = {static_cast<cuuint64_t>(CO) * 2,
                                  static_cast<cuuint64_t>(W) * CO * 2,
                                  static_cast<cuuint64_t>(H) * W * CO * 2};
  const cuuint32_t gbox[4] = {COB, TW, 1, 1};
  if (!make_map(&xmap, x, xdims, xstrides, xbox, swizzle_for<Cfg::LBX>()) ||
      !make_map(&gmap, g, gdims, gstrides, gbox, swizzle_for<Cfg::LBG>()))
    return cudaErrorInvalidValue;
  kernel<<<dim3(KD * Cfg::NCOB, chunks), Cfg::NT, Cfg::SMEM, stream>>>(
      xmap, gmap, static_cast<float*>(ws), D, H, nseg, items, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce<<<(Cfg::TOTAL + 255) / 256, 256, 0, stream>>>(static_cast<const float*>(ws),
                                                       static_cast<float*>(dk), Cfg::TOTAL, chunks);
  return cudaGetLastError();
}

}  // namespace dsm
