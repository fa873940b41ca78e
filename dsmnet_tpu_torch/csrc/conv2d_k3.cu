// Kernel A: 3x3 stride-1 SAME 2-D convolution, no bias, C = Co = 32.
//
// Replaces the TPU kernel conv2d_fwd_pallas_folded
// (dsmnet_tpu/ops/conv2d_pallas.py:183).  On PSMNet's serving path it
// runs firstconv1/2 and the six layer1 convs on the half-resolution
// tower, x (2N, H/2, W/2, 32) -> (2N, H/2, W/2, 32).
//
// What bounds it on the H100: 2 * 9 * 32 FLOP per output channel against
// 4 bytes of bf16 in and out per channel pair is ~150 FLOP/byte, below
// the card's ~295 FLOP/byte ridge, so the memory traffic bounds it.  A
// block computes 4 output rows x 64 columns from 6 staged input rows, so
// an input row is fetched 1.5 times (the rest from L2), each
// output is written once with 16-byte stores, and the 18 KB kernel is
// staged once per block.  The TPU version's 128-lane W folding and VMEM
// slab ring are not carried over.
#include "conv_k3.cuh"

using dsm::bf16;

extern "C" int dsm_conv2d_k3(const void* x, const void* w, void* y, int dtype, int N, int H,
                             int W, int C, int Co, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C != 32 || Co != 32) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == dsm::kBFloat16)
    return static_cast<int>(
        dsm::launch_conv_k3<bf16, 1, 1, 32, 32, 64, 4, 9>(x, w, y, N, 1, H, W, 1, H, W, st));
  if (dtype == dsm::kFloat32)
    return static_cast<int>(
        dsm::launch_conv_k3<float, 1, 1, 32, 32, 64, 4, 9>(x, w, y, N, 1, H, W, 1, H, W, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
