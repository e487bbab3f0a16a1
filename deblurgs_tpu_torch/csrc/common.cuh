// Shared constants of the hand-written kernels (built for sm_90a by
// deblurgs_tpu_torch/ops/kernels.py, no fast-math, -fmad=false).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Field rows of the staged pair array [NFIELD, max_pairs] (same layout as
// deblurgs_tpu/ops/pallas_blend.py): 0 x, 1 y, 2-4 conic a/b/c, 5 opacity,
// 6-8 rgb, 9 depth, 10 tile id, 11-12 tile origin (exact f32 values).
constexpr int NFIELD = 16;
constexpr int NBLEND = 10;  // rows the compositor reads (0-9)

// Reduce-scatter of ten per-lane values over a full warp, for the
// deterministic sums of K2 and K4: each round halves the set of sums a lane
// carries (10 → 5 by lane bit 4, → 3 or 2 by bit 3, → 2 or 1 by bit 2,
// → 1 by bits 1 and 0), 12 shuffles in all. Lanes are paired by bit 4,
// then 3, 2, 1, 0, as in a shuffle-down tree, and float addition commutes,
// so each sum is bit for bit that tree's. Returns the sum that ends in this
// lane: sum number scatter10_index(lane), stored by the lanes where
// scatter10_writer(lane) holds (one lane a sum).
__device__ __forceinline__ float warp_reduce_scatter10(const float (&acc)[10], int lane) {
  constexpr unsigned kFull = 0xffffffffu;
  const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4, h1 = lane & 2;
  float a[5];
#pragma unroll
  for (int j = 0; j < 5; ++j)
    a[j] = (h4 ? acc[5 + j] : acc[j]) + __shfl_xor_sync(kFull, h4 ? acc[j] : acc[5 + j], 16);
  float b[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float hi_keep = j < 2 ? a[3 + j] : 0.0f;
    b[j] = (h3 ? hi_keep : a[j]) + __shfl_xor_sync(kFull, h3 ? a[j] : hi_keep, 8);
  }
  // lanes without bit 3 hold 3 sums, split 2 / 1; the others 2, split 1 / 1
  const float c0 = (h2 ? (h3 ? b[1] : b[2]) : b[0]) +
                   __shfl_xor_sync(kFull, h2 ? b[0] : (h3 ? b[1] : b[2]), 4);
  const float c1 = (!h3 && !h2 ? b[1] : 0.0f) +
                   __shfl_xor_sync(kFull, !h3 && h2 ? b[1] : 0.0f, 4);
  const bool two = !h3 && !h2;
  const float d = (two && h1 ? c1 : c0) + __shfl_xor_sync(kFull, two && !h1 ? c1 : c0, 2);
  return d + __shfl_xor_sync(kFull, d, 1);
}

__device__ __forceinline__ int scatter10_index(int lane) {
  return (lane & 16 ? 5 : 0) + (lane & 8 ? (lane & 4 ? 4 : 3) : (lane & 4 ? 2 : (lane & 2 ? 1 : 0)));
}

__device__ __forceinline__ bool scatter10_writer(int lane) {
  return !(lane & 1) && (!(lane & 2) || !(lane & 12));
}
