// Shared constants of the hand-written kernels (built for sm_90a by
// deblurgs_tpu_torch/ops/kernels.py, no fast-math, -fmad=false).
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

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

// The warp cull of K1 and K2 on uncut lists (the staging's tile cull off):
// a pixel box (x0, x1, y0, y1) that holds every pixel at which the pair can
// pass the alpha gate, computed once a pair and a block by the thread that
// stages it (cuda_blend_mixed.cull_box repeats it in float32). The pair
// composites only where power >= thr - margin, thr = -ln(255 opacity) and
// _tile_visible's margin 0.05 + 0.01 |thr| (it covers the rounding of expf,
// the product with the opacity and the 1/255 compare). The float32 power
// lies within 1e-6 (|a| dx² + |c| dy²)/2 + 1e-6 |b dx dy| of the exact one,
// at most e |d|² / 2 with e = 1e-6 (max(|a|, |c|) + |b|), so the pair
// composites only inside the ellipse d' (Q - e I) d <= 2 (margin - thr),
// Q = [[a, b], [b, c]]: half-extents sqrt(2 k c' / det') and
// sqrt(2 k a' / det'), widened by 0.1% and 0.01 + 1e-6 |mean| pixels for
// the box's own rounding. A pair with a non-finite field, or whose shifted
// conic is not clearly positive definite (det' <= 1e-3 a' c', where det'
// itself would round too coarsely), is never culled; one whose opacity
// cannot reach 1/255 (k < 0, or no k at all for opacity <= 0) is culled
// everywhere.
__device__ __forceinline__ float4 cull_box(const float (&v)[NBLEND]) {
  bool finite = true;
#pragma unroll
  for (int q = 0; q < NBLEND; ++q) finite = finite && isfinite(v[q]);
  const float mx = v[0], my = v[1], a = v[2], b = v[3], c = v[4], op = v[5];
  const float thr = -logf(255.0f * op);
  const float k = (0.05f + 0.01f * fabsf(thr)) - thr;
  const float e = 1e-6f * (fmaxf(fabsf(a), fabsf(c)) + fabsf(b));
  const float a2 = a - e, c2 = c - e;
  const float det = a2 * c2 - b * b;
  if (!finite || !(a2 > 0.0f) || !(c2 > 0.0f) || !(det > 1e-3f * (a2 * c2)))
    return make_float4(-CUDART_INF_F, CUDART_INF_F, -CUDART_INF_F, CUDART_INF_F);
  if (!(k >= 0.0f))
    return make_float4(CUDART_INF_F, -CUDART_INF_F, CUDART_INF_F, -CUDART_INF_F);
  const float k2 = 2.0f * k;
  const float hx = sqrtf(k2 * c2 / det) * 1.001f + (0.01f + 1e-6f * fabsf(mx));
  const float hy = sqrtf(k2 * a2 / det) * 1.001f + (0.01f + 1e-6f * fabsf(my));
  return make_float4(mx - hx, mx + hx, my - hy, my + hy);
}

// A warp's pixel rectangle in image pixels (x0, x1, y0, y1) from its lanes'
// pixels (tile-local x, y; present where x < tile_w and y < tile_h): a warp
// skips a pair whose cull box misses it. Empty (x0 > x1) for a warp with no
// pixels.
template <int PPT>
__device__ __forceinline__ float4 warp_rect(const int (&px)[PPT], const int (&py)[PPT],
                                            int tile_w, int tile_h, float tx0, float ty0) {
  int x0 = INT_MAX, x1 = INT_MIN, y0 = INT_MAX, y1 = INT_MIN;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    if (px[k] < tile_w && py[k] < tile_h) {
      x0 = min(x0, px[k]);
      x1 = max(x1, px[k]);
      y0 = min(y0, py[k]);
      y1 = max(y1, py[k]);
    }
  }
  constexpr unsigned kFull = 0xffffffffu;
  x0 = __reduce_min_sync(kFull, x0);
  x1 = __reduce_max_sync(kFull, x1);
  y0 = __reduce_min_sync(kFull, y0);
  y1 = __reduce_max_sync(kFull, y1);
  if (x0 > x1) return make_float4(CUDART_INF_F, -CUDART_INF_F, CUDART_INF_F, -CUDART_INF_F);
  return make_float4(tx0 + static_cast<float>(x0), tx0 + static_cast<float>(x1),
                     ty0 + static_cast<float>(y0), ty0 + static_cast<float>(y1));
}

// Whether a pair's cull box misses a warp's rectangle (both x0, x1, y0, y1).
__device__ __forceinline__ bool box_misses(float4 box, float4 rect) {
  return box.y < rect.x || box.x > rect.y || box.w < rect.z || box.z > rect.w;
}
