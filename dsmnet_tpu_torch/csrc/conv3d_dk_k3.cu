// Kernel F: weight gradient of the 3x3x3 stride-1 SAME 3-D convolution,
// C, Co in {32, 64} and 128 -> 128: dK (3, 3, 3, C, Co) float32 from
// x (N, D, H, W, C) and the cotangent g (N, D, H, W, Co).
//
// Replaces the TPU kernel conv3d_dk_pallas_folded
// (dsmnet_tpu/ops/conv3d_pallas.py:341).  On PSMNet's train step it runs
// the dK of dres0_1, dres1_0/1, the classifier c0 convs (32 -> 32 at
// (4, 48, 96, 192)) and the hourglass conv2/conv4 (64 -> 64 at
// (4, 24, 48, 96) and (4, 12, 24, 48)) at batch 4; on GCNet's the dK of
// l19 (64 -> 32 at (1, 96, 192, 384)), l20 (32 -> 32), l22/l23, l25/l26,
// l28/l29 (64 -> 64) and, at 128 -> 128, of l31/l32 ((1, 6, 12, 24, 128)
// at 384x768).
//
// What bounds it on the H100: 2 * 27 * C * Co FLOP per position against
// (C + Co) bf16 read is ~860 FLOP/byte at 32 -> 32, above the ~295
// FLOP/byte ridge: the tensor cores bound it (196 GFLOP, 0.198 ms at the
// 32 -> 32 shape).
//
// The bf16 design (s1_dk_ring.cuh): a block owns one kd, all nine (kh, kw)
// taps and a Co tile, and walks a range of cotangent rows with oh fastest
// through a five-slot TMA ring, so each staged x row feeds the three kh
// taps that read it: x and g reach shared memory 3 times a launch (once
// per kd block) instead of 9 times (chip_smoke.py's l2_to_shared_mb).  The
// copies overlap the MMAs (one thread keeps three rows in flight).  The
// MMAs are mma.sync from ldmatrix of the shifted x row: wgmma with A from
// registers ran slower at these shapes (N = Co = 32 or 64: too little work
// per instruction; PERF.md's kernel F findings).  At 32 -> 32 and 64 -> 64
// a warp owns the three kw taps of one kh (and part of C) and loads the g
// fragments once for them.  The partials are one per block that runs
// (ops/conv3d.py dk_k3_chunks), added in a fixed order.
//
// 128 -> 128 (GCNet's l31/l32: 1.53 GFLOP, 0.44 MB of x and of g at batch
// 1): one warp per tap, eight Co tiles of 16 (64 accumulators a thread), x
// as two 64-channel planes, segments of 32 positions (W = 24 is one
// segment whose last 8 cotangent columns arrive as zeros); the wrapper
// plans the partials to fill the card: 5 at 132 SMs, 8.8 MB of f32, where
// the dk_k3.cuh tiles (36 blocks a chunk) needed 8 to fill it, 14.2 MB.
//
// The float32 instantiation stays on dk_k3.cuh's design (one (kd, kh) tap
// group per block, cp.async staging, FMAs), for the checks.
#include "dk_k3.cuh"
#include "s1_dk_ring.cuh"

// float32: segments of 64 positions at C = 32, 48 at C = 64, 4 per stage;
// 128 -> 128 in 32-column segments with Co tiles of 32
static cudaError_t conv3d_dk_f32(const void* x, const void* g, void* dk, void* ws, int N, int D,
                                 int H, int W, int C, int Co, int chunks, cudaStream_t st) {
#define DSM_CASE(CI_, CO_, TW_)                                                                  \
  if (C == CI_ && Co == CO_)                                                                     \
    return dsm::launch_dk_k3<float, 3, 1, CI_, CO_, TW_, 4>(x, g, dk, ws, N, D, H, W, D, H, W, \
                                                            chunks, st);
  DSM_CASE(32, 32, 64)
  DSM_CASE(32, 64, 64)
  DSM_CASE(64, 32, 48)
  DSM_CASE(64, 64, 48)
#undef DSM_CASE
  if (C == 128 && Co == 128)
    return dsm::launch_dk_k3<float, 3, 1, 128, 128, 32, 4, 32>(x, g, dk, ws, N, D, H, W, D, H, W,
                                                               chunks, st);
  return cudaErrorInvalidValue;
}

// bf16: (C, Co) -> Co tile, segment positions, taps per warp, warps per
// tap, blocks per SM; the segment, Co tile and blocks per SM are mirrored in
// ops/conv3d.py (DK_K3_TILES).  Segments of 96 positions at 32 -> 32 (W =
// 192, 384), 64 at 32 -> 64, 48 at C = 64 (W = 384 .. 48).  At 32 -> 32 and
// 64 -> 64 a warp takes the three kw taps of one kh and 16 of the C
// channels (six and twelve warps, 48 and 96 accumulators a thread), so the
// g fragments are loaded once for three taps; at 64 -> 64 all 64 output
// channels stay in one block, which stages x once per kd (two Co tiles of
// 32 ran 9% faster and staged x twice as often).  At 64 -> 32 and 32 -> 64
// one warp per tap (64 accumulators), two blocks per SM.
static cudaError_t conv3d_dk_bf16(const void* x, const void* g, void* dk, void* ws, int N, int D,
                                  int H, int W, int C, int Co, int chunks, cudaStream_t st) {
#define DSM_CASE(CI_, CO_, COB_, TW_, TPW_, MS_, MINB_)                                    \
  if (C == CI_ && Co == CO_)                                                               \
    return dsm::launch_s1_dk<CI_, CO_, COB_, TW_, TPW_, MS_, MINB_>(x, g, dk, ws, N, D, H, W, \
                                                                    chunks, dsm::dk_reduce, st);
  DSM_CASE(32, 32, 32, 96, 3, 2, 2)
  DSM_CASE(32, 64, 64, 64, 1, 1, 2)
  DSM_CASE(64, 32, 32, 48, 1, 1, 2)
  DSM_CASE(64, 64, 64, 48, 3, 4, 1)
  DSM_CASE(128, 128, 16, 32, 1, 1, 1)
#undef DSM_CASE
  return cudaErrorInvalidValue;
}

extern "C" int dsm_conv3d_dk_k3(const void* x, const void* g, void* dk, void* ws, int dtype, int N,
                                int D, int H, int W, int C, int Co, int chunks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == dsm::kBFloat16)
    return static_cast<int>(conv3d_dk_bf16(x, g, dk, ws, N, D, H, W, C, Co, chunks, st));
  if (dtype == dsm::kFloat32)
    return static_cast<int>(conv3d_dk_f32(x, g, dk, ws, N, D, H, W, C, Co, chunks, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
