// Kernel E: weight gradient of the 3x3 stride-1 SAME 2-D convolution,
// C = Co = 32: dK (3, 3, 32, 32) float32 from x and the cotangent g,
// both (N, H, W, 32).
//
// Replaces the TPU kernel conv2d_dk_pallas_folded
// (dsmnet_tpu/ops/conv2d_pallas.py:280).  On PSMNet's train step it runs
// the dK of firstconv1/2 and the six layer1 convs, x and g (2N, H/2, W/2,
// 32) = (8, 192, 384, 32) at batch 4.
//
// What bounds it on the H100: 2 * 9 * 32 * 32 FLOP per position against
// 2 * 32 bf16 read per position (x and g) is ~144 FLOP/byte, below the
// ~295 FLOP/byte ridge: reading x and g once bounds it (75.5 MB, 0.023
// ms).  The design (dk_k3.cuh) gives each of the 3 kh tap groups its own
// blocks, which re-read the rows of their chunk from L2; a block keeps
// its 3 x 32 x 32 partial in registers and writes it once.
#include "dk_k3.cuh"

using dsm::bf16;

extern "C" int dsm_conv2d_dk_k3(const void* x, const void* g, void* dk, void* ws, int dtype, int N,
                                int D, int H, int W, int C, int Co, int chunks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != 1 || C != 32 || Co != 32) return static_cast<int>(cudaErrorInvalidValue);
  // segments of 64 positions (W = 384 is 6 of them), 4 segments per stage
  if (dtype == dsm::kBFloat16)
    return static_cast<int>(dsm::launch_dk_k3<bf16, 1, 1, 32, 32, 64, 4>(
        x, g, dk, ws, N, 1, H, W, 1, H, W, chunks, st));
  if (dtype == dsm::kFloat32)
    return static_cast<int>(dsm::launch_dk_k3<float, 1, 1, 32, 32, 64, 4>(
        x, g, dk, ws, N, 1, H, W, 1, H, W, chunks, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
