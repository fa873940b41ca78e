// Kernel C: 3x3x3 stride-2 pad-1 3-D convolution, no bias, even D/H/W,
// C in {32, 64}, Co = 64.
//
// Replaces the TPU kernel conv3d_s2_fwd_pallas_padded
// (dsmnet_tpu/ops/conv3d_s2_pallas.py:208).  It runs the hourglass
// down-convs conv1 (N, 48, 96, 192, 32) -> (N, 24, 48, 96, 64) and conv3
// (N, 24, 48, 96, 64) -> (N, 12, 24, 48, 64) of PSMNet's serving path and
// train step, the conv6 deconv's d(input) in the train step (conv1's
// shape), and GCNet's l21/l24/l27 (1, 96, 192, 384, 64) and its halves.
//
// What bounds it on the H100: the input has 8x the output's voxels, so
// 2 * 27 * C * 64 FLOP per output voxel against 8 C + 64 bf16 moved is
// ~170 FLOP/byte at C = 32 and ~195 at C = 64, below the ~295 FLOP/byte
// ridge: reading x once and writing y once bounds it (283 MB, 0.085 ms
// at train conv1; 1.02 GB, 0.30 ms at GCNet l21).
//
// The bf16 design (s2_ring.cuh) stages each input D-slice into shared
// memory once per output tile with TMA (two parity-plane boxes, a
// three-slot mbarrier ring) and feeds it to both output slices it reaches,
// keeps the block's 27 C x COB kernel columns resident for a whole run of
// output slices as wgmma's B operand, and runs the taps as wgmma with A
// (the shifted view of the slot) loaded into registers by ldmatrix.  Per
// launch, from shared memory's point of view (input rows with their halo,
// the resident kernel once per block; chip_smoke.py's l2_to_shared_mb), at
// the runs ops/conv3d.py plans for 132 SMs: train conv1 348 MB against a
// bound of 283 MB (conv_k3.cuh's tiles, the f32 instantiation's, stage
// 558 MB); GCNet l21 2.32 GB (both Co halves read x; their blocks are
// neighbours in launch order, so the second read finds it in L2) against
// 1.02 GB (conv_k3.cuh: 4.63 GB).  What remains: at C = 32 the copies
// and the wgmmas take about as long as each other; at C = 64 the copies
// set the pace (two reads of x, one of them from L2).  The float32 instantiation stays on conv_k3.cuh's tiles.
#include "conv_k3.cuh"
#include "s2_ring.cuh"

using dsm::bf16;

// float32: blocks of 8 rows x 32 columns at C = 32 and 4 x 16 at C = 64,
// 3 taps of the kernel staged at a time
static cudaError_t conv3d_k3s2_f32(const void* x, const void* w, void* y, int N, int D, int H,
                                   int W, int C, int Co, cudaStream_t st) {
  const int Do = D / 2, Ho = H / 2, Wo = W / 2;
#define DSM_CASE(CI_, CO_, TM_, RH_)                                                          \
  if (C == CI_ && Co == CO_)                                                                  \
    return dsm::launch_conv_k3<float, 3, 2, CI_, CO_, TM_, RH_, 3>(x, w, y, N, D, H, W, Do, Ho, \
                                                                   Wo, st);
  DSM_CASE(32, 64, 32, 8)
  DSM_CASE(64, 64, 16, 4)
#undef DSM_CASE
  return cudaErrorInvalidValue;
}

// bf16: blocks of 4 x 32 outputs, two warpgroups; C = 32 keeps all 64
// output channels per block, C = 64 half of them and streams each input
// slice as two 32-channel halves, so that the resident kernel is 110.6 KB
// and a ring slot 38 KB in both cases.  The tiles are mirrored in
// ops/conv3d.py (S2_FWD_TILES), which sizes the D-runs.
static cudaError_t conv3d_k3s2_bf16(const void* x, const void* w, void* y, int N, int D, int H,
                                    int W, int C, int Co, int run, cudaStream_t st) {
  if (Co != 64) return cudaErrorInvalidValue;
  if (C == 32) return dsm::launch_s2_fwd<32, 64>(x, w, y, N, D, H, W, run, st);
  if (C == 64) return dsm::launch_s2_fwd<64, 32>(x, w, y, N, D, H, W, run, st);
  return cudaErrorInvalidValue;
}

extern "C" int dsm_conv3d_k3s2(const void* x, const void* w, void* y, int dtype, int N, int D,
                               int H, int W, int C, int Co, int run, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((D | H | W) & 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == dsm::kBFloat16)
    return static_cast<int>(conv3d_k3s2_bf16(x, w, y, N, D, H, W, C, Co, run, st));
  if (dtype == dsm::kFloat32)
    return static_cast<int>(conv3d_k3s2_f32(x, w, y, N, D, H, W, C, Co, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
