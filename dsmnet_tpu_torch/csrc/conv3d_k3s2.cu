// Kernel C: 3x3x3 stride-2 pad-1 3-D convolution, no bias, even D/H/W,
// C in {32, 64}, Co = 64.
//
// Replaces the TPU kernel conv3d_s2_fwd_pallas_padded
// (dsmnet_tpu/ops/conv3d_s2_pallas.py:208).  On PSMNet's serving path it
// runs the hourglass down-convs conv1 (N, 48, 96, 192, 32) ->
// (N, 24, 48, 96, 64) and conv3 (N, 24, 48, 96, 64) -> (N, 12, 24, 48, 64).
//
// What bounds it on the H100: the input is 8x the output's voxels, so
// 2 * 27 * C * 64 FLOP per output voxel against 8 input and 1 output
// voxels of bf16 is ~170 FLOP/byte at conv1, below the ~295 FLOP/byte
// ridge: the memory traffic bounds it.  A block stages its input rows
// once, split into even and odd columns, so each stride-2 tap is a run
// of consecutive staged columns: the even/odd parity split that the TPU
// kernel folds into its lanes is a staging order here.
#include "conv_k3.cuh"

using dsm::bf16;

template <typename T>
static cudaError_t conv3d_k3s2(const void* x, const void* w, void* y, int N, int D, int H, int W,
                               int C, int Co, cudaStream_t st) {
  const int Do = D / 2, Ho = H / 2, Wo = W / 2;
  // blocks of 8 rows x 32 columns at C = 32 (Wo = 96) and 4 rows x 16
  // columns at C = 64 (Wo = 48), 3 taps of the kernel staged at a time:
  // the fastest of a sweep at the serving shapes on an H100
#define DSM_CASE(CI_, CO_, TM_, RH_)                                                           \
  if (C == CI_ && Co == CO_)                                                                   \
    return dsm::launch_conv_k3<T, 3, 2, CI_, CO_, TM_, RH_, 3>(x, w, y, N, D, H, W, Do, Ho, Wo, \
                                                               st);
  DSM_CASE(32, 64, 32, 8)
  DSM_CASE(64, 64, 16, 4)
#undef DSM_CASE
  return cudaErrorInvalidValue;
}

extern "C" int dsm_conv3d_k3s2(const void* x, const void* w, void* y, int dtype, int N, int D,
                               int H, int W, int C, int Co, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((D | H | W) & 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == dsm::kBFloat16) return static_cast<int>(conv3d_k3s2<bf16>(x, w, y, N, D, H, W, C, Co, st));
  if (dtype == dsm::kFloat32) return static_cast<int>(conv3d_k3s2<float>(x, w, y, N, D, H, W, C, Co, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
