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
// above the ~295 FLOP/byte ridge, so the tensor cores bound it (196 GFLOP,
// 0.198 ms at PSMNet's train shape (4, 48, 96, 192, 32 -> 32)).  At Co =
// 32 a second ceiling sits above that bound: an m64n32k16 that reads both
// operands from shared memory moves 3 KB for 64 KFLOP, 21 FLOP per byte
// against the 32 an SM needs (128 B and ~4096 FLOP a clock), so such a
// design caps at ~2/3 of the tensor-core rate there.
//
// The bf16 design (s1_fwd_ring.cuh) walks D input-stationary: a block keeps
// its 27 kernel taps resident (55.3 KB at 32 -> 32, 110.6 KB at C + Co =
// 96 and at 64 -> 64 in Co tiles of 32), streams each input slice of its
// runs once through a TMA ring while the warpgroups compute, and feeds
// every A fragment (ldmatrix of the slot shifted by the tap, in registers)
// to the three kd taps, wgmma m64 x Co tile: A leaves shared memory once
// for three MMAs, fewer bytes per MMA than the Co = 32 ceiling assumes
// (PERF.md has where it lands); each finished output
// slice leaves as one TMA store of a staged bf16 tile.  Its work items
// and runs are planned by ops/conv3d.py (k3_items, k3_run).  128 -> 128
// (GCNet's l31/l32) splits the kd taps and two Co tiles over 3 x 2 blocks
// per tile and slice to fill the card, and adds the three kd partials in
// a fixed order (s1_fwd_split_kernel, s1_fwd_reduce).
//
// The float32 instantiation keeps the design below (conv_k3.cuh), for the
// checks: output-stationary blocks of 192 or 256 positions that stage each
// kd's input rows and kernel slices with cp.async and run mma-shaped FMAs.
#include "conv_k3.cuh"
#include "s1_fwd_ring.cuh"

using dsm::bf16;

static cudaError_t conv3d_k3_f32(const void* x, const void* w, void* y, int N, int D, int H,
                                 int W, int C, int Co, cudaStream_t st) {
  // C = 32: blocks of 4 rows x 64 columns (2 x 64 for Co = 64, to bound
  // the accumulator registers), all 9 taps of a kd staged at once;
  // C = 64: 4 rows x 48 columns (W = 48 and 96 without a ragged tile),
  // 3 taps at a time to keep the staged kernel slice small.  The sizes
  // are the fastest of a sweep at the serving shapes on an H100.  128 ->
  // 128: 4 rows x 16 columns and one tap at a time (a 128 x 128 slice is
  // 66 KB in f32), sized to fit, not swept: GCNet's l31/l32 are 1.5 GFLOP.
#define DSM_CASE(CI_, CO_, TM_, RH_, TG_)                                                      \
  if (C == CI_ && Co == CO_)                                                                  \
    return dsm::launch_conv_k3<float, 3, 1, CI_, CO_, TM_, RH_, TG_>(x, w, y, N, D, H, W, D, H, \
                                                                     W, st);
  DSM_CASE(32, 32, 64, 4, 9)
  DSM_CASE(32, 64, 64, 2, 9)
  DSM_CASE(64, 32, 48, 4, 3)
  DSM_CASE(64, 64, 48, 4, 3)
  DSM_CASE(128, 128, 16, 4, 1)
#undef DSM_CASE
  return cudaErrorInvalidValue;
}

// bf16: (C, Co) -> Co tile, ring slots, blocks per SM; the tile (8 x 16
// positions), the Co tile and the blocks per SM are mirrored in
// ops/conv3d.py (K3_TILE, K3_COB, K3_BLOCKS_PER_SM).  64 -> 64 in two Co
// tiles of 32, so the block's 27 taps stay resident (110.6 KB); 32 -> 32
// with three slots, so two blocks fit an SM; 128 -> 128 split.
static cudaError_t conv3d_k3_bf16(const void* x, const void* w, void* y, void* ws, int N, int D,
                                  int H, int W, int C, int Co, int per, cudaStream_t st) {
#define DSM_CASE(CI_, CO_, COB_, NS_, MINB_) \
  if (C == CI_ && Co == CO_)                 \
    return dsm::launch_s1_fwd<CI_, CO_, COB_, NS_, MINB_>(x, w, y, N, D, H, W, per, st);
  DSM_CASE(32, 32, 32, 3, 2)
  DSM_CASE(32, 64, 64, 4, 1)
  DSM_CASE(64, 32, 32, 4, 1)
  DSM_CASE(64, 64, 32, 4, 1)
#undef DSM_CASE
  if (C == 128 && Co == 128)
    return dsm::launch_s1_fwd_split<128, 128, 64>(x, w, y, ws, N, D, H, W, st);
  return cudaErrorInvalidValue;
}

// ws: 3 N D H W 128 floats for the bf16 128 -> 128 partials, else unused;
// per: work items per block of the bf16 walk (unused in float32 and at
// 128 -> 128)
extern "C" int dsm_conv3d_k3(const void* x, const void* w, void* y, void* ws, int dtype, int N,
                             int D, int H, int W, int C, int Co, int per, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == dsm::kBFloat16)
    return static_cast<int>(conv3d_k3_bf16(x, w, y, ws, N, D, H, W, C, Co, per, st));
  if (dtype == dsm::kFloat32)
    return static_cast<int>(conv3d_k3_f32(x, w, y, N, D, H, W, C, Co, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
