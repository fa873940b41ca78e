// Kernel B: 3x3x3 stride-1 SAME 3-D convolution, no bias, C, Co in
// {32, 64}, and 128 -> 128.
//
// Replaces the TPU kernel conv3d_fwd_pallas_folded
// (dsmnet_tpu/ops/conv3d_pallas.py:220).  On PSMNet's serving path it
// runs dres0_1, dres1_0/1, the hourglass conv2/conv4 and the classifier
// c0 convs: (N, 48, 96, 192, 32 -> 32), (N, 24, 48, 96, 64 -> 64) and
// (N, 12, 24, 48, 64 -> 64) at 384x768, D = 192.  On GCNet's it runs
// the skip and refine convs l19/l20 (1, 96, 192, 384, 64 -> 32 -> 32),
// l22/l23, l25/l26, l28/l29 (64 -> 64 at 1/2, 1/4, 1/8 of that volume)
// and l31/l32 (1, 6, 12, 24, 128 -> 128); on PSMNet-basic's the ten
// regularizer convs (1, 48, 96, 192, 64 -> 32 and 32 -> 32).
//
// What bounds it on the H100: 2 * 27 * C FLOP per output channel against
// 4 bytes of bf16 in and out is ~430 FLOP/byte at C = 32 (~860 at 64),
// above the ~295 FLOP/byte ridge, so the tensor cores bound it
// (48.9 GFLOP, ~0.05 ms at the 32 -> 32 shape).  The design feeds
// mma.sync from conflict-free ldmatrix loads of shifted views of the
// staged input rows, keeps the whole 27 x C reduction in f32 registers,
// and gives each block 192 or 256 outputs, so each kernel slice it
// stages is reused that often.  It does not overlap staging with the MMAs inside a
// block (no cp.async ring, no TMA, no wgmma): several resident blocks
// per SM hide each other's loads instead, and that is where the gap to
// the bound lies.
#include "conv_k3.cuh"

using dsm::bf16;

template <typename T>
static cudaError_t conv3d_k3(const void* x, const void* w, void* y, int N, int D, int H, int W,
                             int C, int Co, cudaStream_t st) {
  // C = 32: blocks of 4 rows x 64 columns (2 x 64 for Co = 64, to bound
  // the accumulator registers), all 9 taps of a kd staged at once;
  // C = 64: 4 rows x 48 columns (W = 48 and 96 without a ragged tile),
  // 3 taps at a time to keep the staged kernel slice small.  The sizes
  // are the fastest of a sweep at the serving shapes on an H100.  128 ->
  // 128: 4 rows x 16 columns and one tap at a time (a 128 x 128 slice is
  // 66 KB in f32), sized to fit, not swept: GCNet's l31/l32 are 1.5 GFLOP.
#define DSM_CASE(CI_, CO_, TM_, RH_, TG_)                                                      \
  if (C == CI_ && Co == CO_)                                                                  \
    return dsm::launch_conv_k3<T, 3, 1, CI_, CO_, TM_, RH_, TG_>(x, w, y, N, D, H, W, D, H, W, \
                                                                 st);
  DSM_CASE(32, 32, 64, 4, 9)
  DSM_CASE(32, 64, 64, 2, 9)
  DSM_CASE(64, 32, 48, 4, 3)
  DSM_CASE(64, 64, 48, 4, 3)
  DSM_CASE(128, 128, 16, 4, 1)
#undef DSM_CASE
  return cudaErrorInvalidValue;
}

extern "C" int dsm_conv3d_k3(const void* x, const void* w, void* y, int dtype, int N, int D, int H,
                             int W, int C, int Co, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == dsm::kBFloat16) return static_cast<int>(conv3d_k3<bf16>(x, w, y, N, D, H, W, C, Co, st));
  if (dtype == dsm::kFloat32) return static_cast<int>(conv3d_k3<float>(x, w, y, N, D, H, W, C, Co, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
