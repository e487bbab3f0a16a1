// The per-(pixel, pair) gate of the lockstep kernels K5 (forward_lockstep.cu)
// and K6 (backward_lockstep.cu). One inline function for both, so K6 replays
// K5's float32 sequence exactly and its freeze falls on the same pair.
#pragma once

#include "common.cuh"

namespace lockstep {

constexpr int THREADS = 256;          // one thread per pixel of a 16×16 tile
constexpr int MAX_TILE_PX = 1024;     // 32×32 tiles: four pixels a thread
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;

enum Gate { kSkip = 0, kComposite = 1, kFreeze = 2 };

// Gates of deblurgs_tpu/ops/pallas_blend.py::_chunk_core (:526-563):
//   power = -0.5 (a dx² + c dy²) - b dx dy,  dx = x - px, dy = y - py
//   skip unless power <= 0 (so expf never sees a positive power: the TPU's
//   NaN, pallas_blend.py:536-546; a NaN power is skipped too, as JAX's
//   elig mask and the plain version skip it);  alpha = min(0.99, opacity·exp(power));
//   skip if alpha < 1/255;  freeze BEFORE the pair whose T·(1 - alpha)
//   would fall below 1e-4.
// On kComposite and kFreeze, G = expf(power), alpha and test_T are set.
__device__ __forceinline__ Gate gate(float mx, float my, float ca, float cbq, float cc,
                                     float op, float px, float py, float T, float& dx,
                                     float& dy, float& G, float& alpha, float& test_T) {
  dx = mx - px;
  dy = my - py;
  const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cbq * dx * dy;
  if (!(power <= 0.0f)) return kSkip;
  G = expf(power);
  alpha = fminf(0.99f, op * G);
  if (alpha < ALPHA_MIN) return kSkip;
  test_T = T * (1.0f - alpha);
  return test_T < T_EPS ? kFreeze : kComposite;
}

// Pixels per thread for a tile of px_n pixels (0 if the tile is too large).
inline int pixels_per_thread(int px_n) {
  if (px_n <= 0 || px_n > MAX_TILE_PX) return 0;
  return px_n <= THREADS ? 1 : px_n <= 2 * THREADS ? 2 : 4;
}

}  // namespace lockstep
