// Kernel G: weight gradient of the 3x3x3 stride-2 pad-1 3-D convolution,
// C in {32, 64}, Co = 64: dK (3, 3, 3, C, 64) float32 from x (N, D, H, W,
// C), even D/H/W, and the cotangent g (N, D/2, H/2, W/2, 64).
//
// Replaces the TPU kernel conv3d_s2_dk_pallas_padded
// (dsmnet_tpu/ops/conv3d_s2_pallas.py:346).  On PSMNet's train step it
// runs the dK of the hourglass down-convs conv1 (x (4, 48, 96, 192, 32))
// and conv3 (x (4, 24, 48, 96, 64)), and, with the roles swapped (x = the
// cotangent of the conv6 deconv's output, g = the deconv's input), the
// conv6 deconv's dW (3, 3, 3, 32, 64), as folded.py:347-361 does.
//
// What bounds it on the H100: x has 8x the cotangent's positions, so
// 2 * 27 * C * 64 FLOP per cotangent position against 8 C + 64 bf16 read
// is ~170 FLOP/byte at C = 32, below the ~295 FLOP/byte ridge: reading x
// and g once bounds it (283 MB, 0.084 ms at the conv1 shape).  x rows are
// staged split into even and odd columns (dk_k3.cuh), so each stride-2
// tap is a run of consecutive staged rows for ldmatrix.
#include "dk_k3.cuh"

using dsm::bf16;

template <typename T>
static cudaError_t conv3d_s2_dk(const void* x, const void* g, void* dk, void* ws, int N, int D,
                                int H, int W, int C, int chunks, cudaStream_t st) {
  // segments of 48 output positions (W/2 = 96 and 48 without a ragged
  // segment); 4 segments per stage at C = 32, 2 at C = 64 (shared memory)
#define DSM_CASE(CI_, RS_)                                                                       \
  if (C == CI_)                                                                                  \
    return dsm::launch_dk_k3<T, 3, 2, CI_, 64, 48, RS_>(x, g, dk, ws, N, D, H, W, D / 2, H / 2, \
                                                        W / 2, chunks, st);
  DSM_CASE(32, 4)
  DSM_CASE(64, 2)
#undef DSM_CASE
  return cudaErrorInvalidValue;
}

extern "C" int dsm_conv3d_dk_k3s2(const void* x, const void* g, void* dk, void* ws, int dtype,
                                  int N, int D, int H, int W, int C, int Co, int chunks,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (((D | H | W) & 1) || Co != 64) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == dsm::kBFloat16)
    return static_cast<int>(conv3d_s2_dk<bf16>(x, g, dk, ws, N, D, H, W, C, chunks, st));
  if (dtype == dsm::kFloat32)
    return static_cast<int>(conv3d_s2_dk<float>(x, g, dk, ws, N, D, H, W, C, chunks, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
