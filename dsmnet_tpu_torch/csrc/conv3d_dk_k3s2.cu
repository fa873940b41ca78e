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
// and g once bounds it (283 MB, 0.084 ms at the conv1 shape).
//
// The bf16 design (s2_ring.cuh): a block owns one kd and all nine (kh,
// kw) taps, walks a contiguous range of cotangent rows with oh fastest and
// passes each staged x row to every tap that reads it, through a four-slot
// TMA ring (parity-plane boxes of x, a box of g) that keeps three rows in
// flight.  Per launch at the conv1 shape, from shared memory's point of
// view (chip_smoke.py's l2_to_shared_mb): g 3 times and x 1.5 times with
// its column halo, 515 MB against the bound's 283 MB (dk_k3.cuh's tiles,
// the f32 instantiation's, stage 1025 MB: g 9 times, x 2.25 times).  The partials are one per
// block that runs (ops/conv3d.py s2_dk_chunks: 88 chunks x 3 kd at C = 32,
// 43 x 3 at C = 64; 19.5 and 19.0 MB of f32, against 28 and 57 MB for 128
// chunks), added in chunk order by dk_reduce.  The MMAs stay mma.sync, one
// warp per tap (C = 32 rows of M at C = 32, which a 64-row wgmma tile does
// not fit).  The float32 instantiation stays on dk_k3.cuh's design.
#include "dk_k3.cuh"
#include "s2_ring.cuh"

using dsm::bf16;

// float32: segments of 48 output positions; 4 segments per stage at
// C = 32, 2 at C = 64
template <int C, int RS>
static cudaError_t dk_f32(const void* x, const void* g, void* dk, void* ws, int N, int D, int H,
                          int W, int chunks, cudaStream_t st) {
  return dsm::launch_dk_k3<float, 3, 2, C, 64, 48, RS>(x, g, dk, ws, N, D, H, W, D / 2, H / 2,
                                                        W / 2, chunks, st);
}

extern "C" int dsm_conv3d_dk_k3s2(const void* x, const void* g, void* dk, void* ws, int dtype,
                                  int N, int D, int H, int W, int C, int Co, int chunks,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (((D | H | W) & 1) || Co != 64) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  // bf16: segments of 48 positions (W/2 = 96 and 48 without a ragged
  // segment), mirrored in ops/conv3d.py (S2_DK_SEGMENT); two blocks per SM
  // at C = 32 (94 KB of shared memory), one at C = 64 (154 KB), mirrored
  // in S2_DK_BLOCKS_PER_SM
  if (dtype == dsm::kBFloat16 && C == 32)
    err = dsm::launch_s2_dk<32, 48, 2>(x, g, dk, ws, N, D, H, W, chunks, dsm::dk_reduce, st);
  else if (dtype == dsm::kBFloat16 && C == 64)
    err = dsm::launch_s2_dk<64, 48, 1>(x, g, dk, ws, N, D, H, W, chunks, dsm::dk_reduce, st);
  else if (dtype == dsm::kFloat32 && C == 32)
    err = dk_f32<32, 4>(x, g, dk, ws, N, D, H, W, chunks, st);
  else if (dtype == dsm::kFloat32 && C == 64)
    err = dk_f32<64, 2>(x, g, dk, ws, N, D, H, W, chunks, st);
  return static_cast<int>(err);
}
