// Kernel F: weight gradient of the 3x3x3 stride-1 SAME 3-D convolution,
// C, Co in {32, 64} and 128 -> 128: dK (3, 3, 3, C, Co) float32 from
// x (N, D, H, W, C) and the cotangent g (N, D, H, W, Co).
//
// Replaces the TPU kernel conv3d_dk_pallas_folded
// (dsmnet_tpu/ops/conv3d_pallas.py:341).  On PSMNet's train step it runs
// the dK of dres0_1, dres1_0/1, the classifier c0 convs (32 -> 32 at
// (4, 48, 96, 192)) and the hourglass conv2/conv4 (64 -> 64 at
// (4, 24, 48, 96) and (4, 12, 24, 48)) at batch 4; on GCNet's the dK of
// l19/l20, l22/l23, l25/l26, l28/l29 and, at 128 -> 128, of l31/l32
// ((1, 6, 12, 24, 128) at 384x768).
//
// What bounds it on the H100: 2 * 27 * C * Co FLOP per position against
// (C + Co) bf16 read is ~860 FLOP/byte at 32 -> 32, above the ~295
// FLOP/byte ridge: the tensor cores bound it (196 GFLOP, 0.198 ms at the
// 32 -> 32 shape).  The design (dk_k3.cuh) runs mma.sync from ldmatrix of
// shifted views of the staged rows; each of the 9 (kd, kh) tap groups has
// its own blocks, so a row is read 9 times, mostly from L2.  Staging does
// not overlap the MMAs inside a block (no cp.async ring, TMA or wgmma):
// resident blocks hide each other's loads, and that is the gap to the
// bound.
//
// At 128 -> 128 a block of all 128 output channels would hold 3 * 128 *
// 128 accumulators (384 a thread), so each tap group splits Co into four
// tiles of 32 (96 a thread), and the x rows are read 36 times, from L2.
// GCNet's l31/l32 are small (1.53 GFLOP, 0.44 MB of x, 0.44 MB of g, 1.77
// MB of dK at batch 1): launch and the partials' pass bound them, not the
// tensor cores.  Their W = 24 is one 32-column segment whose last 8
// cotangent columns are zero-filled.  The wrapper plans the chunks
// (ops/conv3d.py dk_k3_128_chunks): two blocks per SM.
#include "dk_k3.cuh"

using dsm::bf16;

template <typename T>
static cudaError_t conv3d_dk(const void* x, const void* g, void* dk, void* ws, int N, int D, int H,
                             int W, int C, int Co, int chunks, cudaStream_t st) {
  // segments of 64 positions at C = 32 (W = 192), 48 at C = 64 (W = 96 and
  // 48 without a ragged segment); 4 segments per stage
#define DSM_CASE(CI_, CO_, TW_)                                                              \
  if (C == CI_ && Co == CO_)                                                                 \
    return dsm::launch_dk_k3<T, 3, 1, CI_, CO_, TW_, 4>(x, g, dk, ws, N, D, H, W, D, H, W, \
                                                        chunks, st);
  DSM_CASE(32, 32, 64)
  DSM_CASE(32, 64, 64)
  DSM_CASE(64, 32, 48)
  DSM_CASE(64, 64, 48)
#undef DSM_CASE
  // 128 -> 128: 32-column segments, 4 per stage, Co tiles of 32
  if (C == 128 && Co == 128)
    return dsm::launch_dk_k3<T, 3, 1, 128, 128, 32, 4, 32>(x, g, dk, ws, N, D, H, W, D, H, W,
                                                           chunks, st);
  return cudaErrorInvalidValue;
}

extern "C" int dsm_conv3d_dk_k3(const void* x, const void* g, void* dk, void* ws, int dtype, int N,
                                int D, int H, int W, int C, int Co, int chunks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == dsm::kBFloat16)
    return static_cast<int>(conv3d_dk<bf16>(x, g, dk, ws, N, D, H, W, C, Co, chunks, st));
  if (dtype == dsm::kFloat32)
    return static_cast<int>(conv3d_dk<float>(x, g, dk, ws, N, D, H, W, C, Co, chunks, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
