// Kernel E: weight gradient of the 3x3 stride-1 SAME 2-D convolution,
// C = Co = 32: dK (3, 3, 32, 32) float32 from x and the cotangent g,
// both (N, H, W, 32).
//
// Replaces the TPU kernel conv2d_dk_pallas_folded
// (dsmnet_tpu/ops/conv2d_pallas.py:280).  On PSMNet's train step it runs
// the dK of firstconv1/2 and the six layer1 convs, x and g (2N, H/2, W/2,
// 32) = (8, 192, 384, 32) at batch 4; on GCNet's step the tower's 17 at
// (2, 192, 384, 32), on PSMNet-basic's 16 at (4, 192, 384, 32).
//
// What bounds it on the H100: 2 * 9 * 32 * 32 FLOP per position against
// 2 * 32 bf16 read per position (x and g) is ~144 FLOP/byte, below the
// ~295 FLOP/byte ridge: reading x and g once bounds it (75.5 MB, 0.023
// ms at (8, 192, 384, 32)).
//
// The bf16 design is kernel F's row ring (s1_dk_ring.cuh) at KD = 1: x and
// g viewed as (N, 1, H, W, 32), a block owns all nine (kh, kw) taps and
// walks a contiguous range of cotangent rows (n, w-segment of 96, oh) with
// oh fastest through a five-slot TMA ring, so each staged x row feeds the
// three kh taps that read it and x and g reach shared memory once a
// launch (the dk_k3.cuh tiles gave each kh its own blocks: three times).
// Its partials are one per block that runs at once (ops/conv2d.py
// dk_rows / dk_chunks), added in a fixed order by dk_reduce: the same bits
// on every run.
//
// The float32 instantiation keeps dk_k3.cuh's design (one kh tap group per
// block, cp.async staging, FMAs), for the checks.
#include "dk_k3.cuh"
#include "s1_dk_ring.cuh"

using dsm::bf16;

extern "C" int dsm_conv2d_dk_k3(const void* x, const void* g, void* dk, void* ws, int dtype, int N,
                                int D, int H, int W, int C, int Co, int chunks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != 1 || C != 32 || Co != 32) return static_cast<int>(cudaErrorInvalidValue);
  // bf16: F's 32 -> 32 ring (segments of 96 positions, the three kw taps of
  // one kh per warp, C split over two warps, two blocks per SM; mirrored in
  // ops/conv2d.py DK_TILE) at KD = 1
  if (dtype == dsm::kBFloat16)
    return static_cast<int>(dsm::launch_s1_dk<32, 32, 32, 96, 3, 2, 2, 1>(
        x, g, dk, ws, N, 1, H, W, chunks, dsm::dk_reduce, st));
  // float32: segments of 64 positions (W = 384 is 6 of them), 4 per stage
  if (dtype == dsm::kFloat32)
    return static_cast<int>(dsm::launch_dk_k3<float, 1, 1, 32, 32, 64, 4>(
        x, g, dk, ws, N, 1, H, W, 1, H, W, chunks, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
