// Kernel A: 3x3 stride-1 SAME 2-D convolution, no bias, C = Co = 32.
//
// Replaces the TPU kernel conv2d_fwd_pallas_folded
// (dsmnet_tpu/ops/conv2d_pallas.py:183).  On PSMNet's serving path it
// runs firstconv1/2 and the six layer1 convs on the half-resolution
// tower, x (2N, H/2, W/2, 32) -> (2N, H/2, W/2, 32); in training also
// their dx (the flipped, channel-swapped kernel).
//
// What bounds it on the H100: 2 * 9 * 32 FLOP per output channel against
// 4 bytes of bf16 in and out per channel pair is ~150 FLOP/byte, below
// the card's ~295 FLOP/byte ridge, so the memory traffic bounds it: each
// input read once and each output written once (75.5 MB, 0.0225 ms at
// 3.35 TB/s for PSMNet's train shape (8, 192, 384, 32)).
//
// The bf16 design is kernel B's walk (s1_fwd_ring.cuh) at KH = 1, with
// output rows in the part of B's output slices.  A block owns a
// contiguous range of work items (n, 128-position row segment, output row
// h), h fastest (ops/conv2d.py k2_items, k2_run: one wave of two blocks
// per SM).  It keeps the 9 taps of the kernel resident (18 KB, the
// swizzled MN-major layout that wgmma reads as B, one TMA box per kh),
// and one thread streams each run's input rows h0 - 1 .. h1 through a
// four-slot TMA ring (130 positions x 32 channels a row, the halo and the
// padding zero-filled by the TMA).  Each staged row feeds the three output
// rows it reaches: its kh = 0, 1, 2 tap groups go into three rotating
// accumulator sets, and one ldmatrix A fragment per kw tap feeds the three
// kh wgmmas (m64n32k16).  A finished output row leaves through a swizzled
// bf16 staging tile as one TMA store.  So a block stages its kernel once
// and each input row about once (the two halo rows per run aside), where
// the earlier design (conv_k3.cuh) staged the kernel and 6 input rows per
// 4 x 64 outputs and overlapped no copy with an MMA.
//
// The float32 instantiation keeps that earlier design, for the checks:
// blocks of 4 output rows x 64 columns that stage their 6 input rows and
// the whole 9-tap kernel with cp.async and run mma-shaped FMAs.
#include "conv_k3.cuh"
#include "s1_fwd_ring.cuh"

// x (N, H, W, 32), w (3, 3, 32, 32), y (N, H, W, 32); per: work items per
// block of the bf16 walk (unused in float32)
extern "C" int dsm_conv2d_k3(const void* x, const void* w, void* y, int dtype, int N, int H,
                             int W, int C, int Co, int per, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C != 32 || Co != 32) return static_cast<int>(cudaErrorInvalidValue);
  // the 2-D conv of (N, H, W) is the walk over D = H of (N, H, 1, W)
  if (dtype == dsm::kBFloat16)
    return static_cast<int>(
        dsm::launch_s1_fwd<32, 32, 32, 4, 2, 1>(x, w, y, N, H, 1, W, per, st));
  if (dtype == dsm::kFloat32)
    return static_cast<int>(
        dsm::launch_conv_k3<float, 1, 1, 32, 32, 64, 4, 9>(x, w, y, N, 1, H, W, 1, H, W, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
