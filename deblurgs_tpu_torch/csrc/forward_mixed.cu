// K1: front-to-back alpha compositing of each tile's depth-sorted pairs;
// K5 on one view's tiles (layout="lockstep").
//
// Replaces deblurgs_tpu/ops/pallas_blend_mixed.py::forward_mixed
// (_forward_kernel, _forward_chunk_body, _mixed_core; pallas_blend_mixed.py:
// 295-589) and, on one view, deblurgs_tpu/ops/pallas_blend.py::forward
// (_forward_kernel, _chunk_core; pallas_blend.py:765-821). The TPU
// kernels re-derived the sequential transmittance recurrence as segmented
// prefix products on the MXU over 128-pair chunks, with one-hot output
// routing. On Hopper the reference design fits (forward.cu:273-392): one
// thread block per stacked tile, a per-pixel front-to-back loop, the tile's
// pair range staged through shared memory in batches.
//
// Per pixel and pair (gates of _mixed_core :314-361 and forward.cu:337-341):
//   power = -0.5 (a dx² + c dy²) - b dx dy,   dx = x - px, dy = y - py
//   skip if power > 0;  alpha = min(0.99, opacity · exp(power));
//   skip if alpha < 1/255;
//   stop BEFORE compositing the pair whose T·(1-alpha) would fall below 1e-4
//   (FAST drops only this freeze gate);
//   C += w rgb, D += w depth, T *= 1 - alpha,  w = alpha T (0 where skipped).
// final_T is the last composited T; n_con the 1-based position in the
// tile's list of the last composited pair. An empty tile gives C = D = 0,
// T = 1, n = 0.
//
// Design for this card. What bounds it: issued instructions, not the ~12
// f32 operations of the gate that the bound counts. An evaluation issues
// ~36 (the gate, a full-precision expf without FMA contraction, the
// accumulation and its selects), and on the train step's lists the
// per-warp exit leaves 1.01× the visits the evaluations need at 128 pixels
// a warp (PERF.md has the SASS and visit counts). So the design cuts the
// instructions a (pair, warp) visit:
// - Each warp owns a compact patch of the tile (K2's layout,
//   cuda_blend_mixed.forward_layout): patch_w × (32 / patch_w · PPT) pixels,
//   lane l taking column l % patch_w and rows l / patch_w + k·(32 / patch_w).
//   A thread's pixels share dx, so dx, (a dx)·dx and b dx are computed once
//   a pair, not once a pixel (the same products in the same order).
// - A warp whose pixels have all frozen stops walking; it still stages its
//   share of each batch and meets the barriers, and the block ends when
//   every warp has stopped. A warp takes its vote every second pair.
// - A frozen pixel keeps no flag: its alpha threshold goes from 1/255 to
//   +inf, so the gate itself refuses every later pair.
// - Pairs are staged pair-major and read as two 16 B and one 8 B broadcast
//   loads, not ten 4 B loads.
// - The pixel loop has no branches: each value is selected where a pixel's
//   gates skip it, so the PPT chains interleave.
// - n_con's bookkeeping is compiled in only where it is written (NEED_N).
// - Pixels a thread by tile size (1, 2 or 4, as K5): a 16×16 tile keeps
//   all eight warps busy with 16×2 patches.
// - __launch_bounds__ for five blocks (40 warps) an SM: 48 registers and a
//   few spilled bytes, faster than four blocks at 64 registers.
// - CULL, where the staging left the lists uncut (need_n_contrib on, or the
//   tile cull off; evaluation): the thread that stages a pair also stages
//   its cull box (common.cuh::cull_box), and a warp skips each pair whose
//   box misses its pixels' rectangle. No pixel of the warp could have
//   composited that pair, so T, C, D and n_con are what the plain version
//   gives (it adds w = 0 there). The warp takes 32 pairs at a time: each
//   lane tests one box, a ballot marks the pairs to walk, and a skipped
//   pair costs the warp nothing more; its exit vote comes once a chunk.
//   On the train step's tile-culled lists most visits composite
//   something, and the cull stays compiled out.
// A tile the patches cannot cover with eight warps (a very wide, flat or
// odd tile) takes the row strips p = t + 256 k, with dx a pixel.
//
// Numerics: expf (not __expf), no fast-math, and the build's -fmad=false,
// so each product and sum rounds as in the plain PyTorch version
// (deblurgs_tpu_torch/ops/cuda_blend_mixed.py::forward_ref), which adds
// w·rgb with w = 0 where a pixel skips, as here.

#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BATCH = THREADS;  // pairs staged per round, one per thread
constexpr int SROW = 12;        // floats a staged pair: rows 0-9, padded to 16 B
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
constexpr unsigned FULL = 0xffffffffu;

// COLUMN: warp patches of patch_w × (32 / patch_w · PPT) pixels, nx across
// the tile; else row strips p = t + 256 k.
template <int PPT, bool COLUMN, bool FAST, bool NEED_N, bool CULL>
__global__ void __launch_bounds__(THREADS, 5) forward_mixed_kernel(
    const float* __restrict__ fields, int64_t max_pairs,
    const int32_t* __restrict__ tile_start, const int32_t* __restrict__ tile_stop,
    int num_tiles, int tiles_x, int tile_w, int tile_h, int patch_w, int nx,
    float* __restrict__ out_c, float* __restrict__ out_d, float* __restrict__ out_t,
    int32_t* __restrict__ out_n) {
  __shared__ __align__(16) float s_f[BATCH][SROW];
  __shared__ float4 s_box[CULL ? BATCH : 1];

  const int tile = blockIdx.x;
  const int img_tile = tile % num_tiles;        // stacked views: per-image tile
  const float tx0 = static_cast<float>((img_tile % tiles_x) * tile_w);
  const float ty0 = static_cast<float>((img_tile / tiles_x) * tile_h);
  const int px_n = tile_w * tile_h;
  const int start = tile_start[tile];
  const int stop = tile_stop[tile];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // this thread's pixels (x, y in the tile); a warp past the tile's patches
  // has none
  int px[PPT], py[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    if constexpr (COLUMN) {
      const int step = 32 / patch_w;
      px[k] = (warp % nx) * patch_w + lane % patch_w;
      py[k] = (warp / nx) * step * PPT + lane / patch_w + k * step;
    } else {
      const int p = threadIdx.x + k * THREADS;
      px[k] = p % tile_w;
      py[k] = p < px_n ? p / tile_w : tile_h;
    }
  }
  constexpr int NX = COLUMN ? 1 : PPT;   // distinct dx values a thread
  // amin: the alpha gate's threshold, 1/255 while the pixel composites and
  // +inf once it has frozen or where there is no pixel
  float T[PPT], cr[PPT], cg[PPT], cb[PPT], dd[PPT], amin[PPT], pxf[NX], pyf[PPT];
  int last[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    T[k] = 1.0f;
    cr[k] = cg[k] = cb[k] = dd[k] = 0.0f;
    last[k] = 0;
    amin[k] = px[k] >= tile_w || py[k] >= tile_h ? CUDART_INF_F : ALPHA_MIN;
    if (k < NX) pxf[k] = tx0 + static_cast<float>(px[k]);
    pyf[k] = ty0 + static_cast<float>(py[k]);
  }
  float4 rect;
  if constexpr (CULL) rect = warp_rect<PPT>(px, py, tile_w, tile_h, tx0, ty0);
  auto live_now = [&]() {
    bool live = false;
#pragma unroll
    for (int k = 0; k < PPT; ++k) live |= amin[k] < CUDART_INF_F;
    return live;
  };

  for (int base = start; base < stop; base += BATCH) {
    const bool live = live_now();
    // block-wide exit; also the barrier that keeps the previous batch's
    // reads ahead of the overwrite below
    if (__syncthreads_count(live) == 0) break;
    const int n = min(BATCH, stop - base);
    if (static_cast<int>(threadIdx.x) < n) {
      const int64_t j = base + threadIdx.x;
      float v[NBLEND];
#pragma unroll
      for (int q = 0; q < NBLEND; ++q) v[q] = fields[q * max_pairs + j];
      float4* dst = reinterpret_cast<float4*>(&s_f[threadIdx.x][0]);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      *reinterpret_cast<float2*>(&s_f[threadIdx.x][8]) = make_float2(v[8], v[9]);
      if constexpr (CULL) s_box[threadIdx.x] = cull_box(v);
    }
    __syncthreads();

    auto visit = [&](int i) {
      const float4 f0 = *reinterpret_cast<const float4*>(&s_f[i][0]);
      const float4 f1 = *reinterpret_cast<const float4*>(&s_f[i][4]);
      const float2 f2 = *reinterpret_cast<const float2*>(&s_f[i][8]);
      const float mx = f0.x, my = f0.y, ca = f0.z, cbq = f0.w;
      const float cc = f1.x, op = f1.y, r = f1.z, g = f1.w, b = f2.x, dep = f2.y;
      // (a dx)·dx and b dx, once a distinct column
      float adxdx[NX], bdx[NX];
#pragma unroll
      for (int k = 0; k < NX; ++k) {
        const float dx = mx - pxf[k];
        adxdx[k] = ca * dx * dx;
        bdx[k] = cbq * dx;
      }
      const int pos = base + i - start + 1;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int h = COLUMN ? 0 : k;
        const float dy = my - pyf[k];
        const float power = -0.5f * (adxdx[h] + cc * dy * dy) - bdx[h] * dy;
        const float alpha = fminf(0.99f, op * expf(power));
        const float test_T = T[k] * (1.0f - alpha);
        bool c = !(power > 0.0f) && !(alpha < amin[k]);
        if constexpr (!FAST) {
          const bool freeze = c && test_T < T_EPS;
          amin[k] = freeze ? CUDART_INF_F : amin[k];
          c = c && !freeze;
        }
        const float w = c ? alpha * T[k] : 0.0f;
        cr[k] = cr[k] + w * r;
        cg[k] = cg[k] + w * g;
        cb[k] = cb[k] + w * b;
        dd[k] = dd[k] + w * dep;
        T[k] = c ? test_T : T[k];
        if constexpr (NEED_N) last[k] = c ? pos : last[k];
      }
    };

    if constexpr (CULL) {
      // 32 pairs at a time: each lane tests one pair's box against the
      // warp's rectangle, and the warp walks the pairs whose box meets it;
      // it stops once its pixels have all frozen, checked before every
      // chunk (cuda_blend_mixed.forward_schedule's count)
      for (int c0 = 0; c0 < n && __any_sync(FULL, live_now()); c0 += 32) {
        const int j = c0 + lane;
        unsigned meet = __ballot_sync(FULL, j < n && !box_misses(s_box[j], rect));
        while (meet) {
          visit(c0 + __ffs(meet) - 1);
          meet &= meet - 1;
        }
      }
    } else {
      // a warp walks until its pixels have all frozen, checked before every
      // second pair of the batch (cuda_blend_mixed.forward_schedule's count)
      bool warp_live = __any_sync(FULL, live);
      for (int i = 0; i < n && warp_live; i += 2) {
        visit(i);
        if (i + 1 < n) visit(i + 1);
        if constexpr (!FAST) warp_live = __any_sync(FULL, live_now());
      }
    }
  }

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    if (px[k] >= tile_w || py[k] >= tile_h) continue;
    const int64_t o = static_cast<int64_t>(tile) * px_n + py[k] * tile_w + px[k];
    out_c[3 * o + 0] = cr[k];
    out_c[3 * o + 1] = cg[k];
    out_c[3 * o + 2] = cb[k];
    out_d[o] = dd[k];
    out_t[o] = T[k];
    if constexpr (NEED_N) out_n[o] = last[k];
  }
}

template <int PPT, bool COLUMN, bool CULL>
int launch(bool fast, bool need_n, dim3 grid, cudaStream_t s, const float* fields,
           int64_t max_pairs, const int32_t* start, const int32_t* stop, int num_tiles,
           int tiles_x, int tile_w, int tile_h, int patch_w, int nx, float* c, float* d,
           float* t, int32_t* n) {
  auto kernel = fast ? (need_n ? forward_mixed_kernel<PPT, COLUMN, true, true, CULL>
                               : forward_mixed_kernel<PPT, COLUMN, true, false, CULL>)
                     : (need_n ? forward_mixed_kernel<PPT, COLUMN, false, true, CULL>
                               : forward_mixed_kernel<PPT, COLUMN, false, false, CULL>);
  kernel<<<grid, THREADS, 0, s>>>(fields, max_pairs, start, stop, num_tiles, tiles_x, tile_w,
                                  tile_h, patch_w, nx, c, d, t, n);
  return static_cast<int>(cudaGetLastError());
}

template <int PPT, bool COLUMN>
int launch(bool cull, bool fast, bool need_n, dim3 grid, cudaStream_t s, const float* fields,
           int64_t max_pairs, const int32_t* start, const int32_t* stop, int num_tiles,
           int tiles_x, int tile_w, int tile_h, int patch_w, int nx, float* c, float* d,
           float* t, int32_t* n) {
  return (cull ? launch<PPT, COLUMN, true> : launch<PPT, COLUMN, false>)(
      fast, need_n, grid, s, fields, max_pairs, start, stop, num_tiles, tiles_x, tile_w, tile_h,
      patch_w, nx, c, d, t, n);
}

}  // namespace

// fields [16, max_pairs] f32; tile_start/tile_stop [total_tiles] i32;
// outputs C [total_tiles, px, 3], D and T [total_tiles, px] f32, n_con
// [total_tiles, px] i32 or null (written where not null). The layout is
// cuda_blend_mixed.forward_layout's: ppt pixels a thread (1, 2 or 4) in
// warp patches patch_w wide, nx across the tile, or row strips at four
// pixels a thread where patch_w is 0. Needs tile_w * tile_h <= 256 * ppt.
// cull: the lists are uncut, and each warp skips the pairs whose cull box
// misses it (CULL above).
extern "C" int deblurgs_forward_mixed(const void* fields, int64_t max_pairs,
                                      const void* tile_start, const void* tile_stop,
                                      int total_tiles, int num_tiles, int tiles_x,
                                      int tile_w, int tile_h, int ppt, int patch_w, int nx,
                                      int fast, int cull, void* out_c, void* out_d, void* out_t,
                                      void* out_n, void* stream) {
  if (tile_w <= 0 || tile_h <= 0 || (ppt != 1 && ppt != 2 && ppt != 4) ||
      tile_w * tile_h > THREADS * ppt)
    return static_cast<int>(cudaErrorInvalidValue);
  if (patch_w != 0) {
    const int patch_h = (patch_w > 0 && patch_w <= 32 && 32 % patch_w == 0) ? 32 / patch_w * ppt : 0;
    if (patch_h == 0 || nx != (tile_w + patch_w - 1) / patch_w ||
        nx * ((tile_h + patch_h - 1) / patch_h) > THREADS / 32)
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (ppt != 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total_tiles <= 0) return 0;
  const dim3 grid(total_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const float*>(fields);
  const auto* a = static_cast<const int32_t*>(tile_start);
  const auto* b = static_cast<const int32_t*>(tile_stop);
  auto* c = static_cast<float*>(out_c);
  auto* d = static_cast<float*>(out_d);
  auto* t = static_cast<float*>(out_t);
  auto* n = static_cast<int32_t*>(out_n);
  const bool need_n = out_n != nullptr;
  if (patch_w == 0)
    return launch<4, false>(cull, fast, need_n, grid, s, f, max_pairs, a, b, num_tiles, tiles_x,
                            tile_w, tile_h, 0, 0, c, d, t, n);
  if (ppt == 1)
    return launch<1, true>(cull, fast, need_n, grid, s, f, max_pairs, a, b, num_tiles, tiles_x,
                           tile_w, tile_h, patch_w, nx, c, d, t, n);
  if (ppt == 2)
    return launch<2, true>(cull, fast, need_n, grid, s, f, max_pairs, a, b, num_tiles, tiles_x,
                           tile_w, tile_h, patch_w, nx, c, d, t, n);
  return launch<4, true>(cull, fast, need_n, grid, s, f, max_pairs, a, b, num_tiles, tiles_x,
                         tile_w, tile_h, patch_w, nx, c, d, t, n);
}
