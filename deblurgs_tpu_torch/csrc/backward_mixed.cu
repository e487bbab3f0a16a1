// K2: per-pair gradients of the front-to-back composite.
//
// Replaces deblurgs_tpu/ops/pallas_blend_mixed.py::backward_mixed
// (_backward_kernel, _backward_chunk_body; pallas_blend_mixed.py:592-789).
// The TPU kernel re-derived the transmittance recurrence as segmented prefix
// products on the MXU over 128-pair chunks that span tiles, routed per-tile
// cotangents with one-hot matmuls and took the pixel sums as moment matmuls.
// Here it is K1's design run again with the cotangents: one thread block per
// stacked tile, four pixels a thread, the tile's pair range staged through
// shared memory in batches.
//
// Per pixel, for the pairs j of its tile in depth order (K1's gates, replayed
// front to back with K1's exact float32 sequence, so the freeze at
// T < 1e-4 falls on the same pair as in the forward):
//   G = exp(power),  a_raw = opacity·G,  alpha = min(0.99, a_raw)
//   w_j      = alpha_j · T_{j-1}
//   dl·c_j   = dL/dr·r + dL/dg·g + dL/db·b + dL/dd·depth
//   prefix_j = Σ_{i≤j} w_i (dl·c_i)
//   S_j      = total - prefix_j,   total = dl·C + final_T·(dl·bg + z_far·dL/dd)
//   dL/dalpha_j = (dl·c_j) T_{j-1} - S_j / (1 - alpha_j)
// and the pair's gradients are sums over the tile's pixels of
//   d mean2d  = N·(-(a dx + b dy), -(c dy + b dx)),  N = a_raw·dL/dalpha
//               (the 0.99 clamp is ignored, as in the JAX package),
//   d conic   = N·(-dx²/2, -dx·dy, -dy²/2)   (the full b gradient),
//   d opacity = G·dL/dalpha,  d rgb = w·dL/dpix,  d depth = w·dL/dd.
//
// Each pair's 10 sums are reduced without atomics: each thread adds its four
// pixels in order, the warp adds its 32 lanes by a shuffle tree, and the
// eight warp partials (shared memory) are added in warp order; the result is
// written to the pair's own slot, so two calls give bitwise-equal output.
// A warp none of whose pixels composite the pair skips its shuffles. Rows
// 10-15 of every slot are written as zero. Blocks past the last tile zero
// the slots that no tile range covers (the sentinel tail of the sorted list),
// so no slot is left as uninitialised memory.
//
// What bounds it: the per (pixel, pair) arithmetic (K1's ~14 f32 operations
// and one expf, plus ~30 for the gradient terms of a composited pair) and the
// warp reductions (50 shuffles per pair and warp that has a contributing
// pixel); the early exit stops a block whose pixels are all frozen, after
// zeroing its remaining slots. Shared memory: 5,120 B of staged fields and
// 40,960 B of warp partials per block.
//
// Numerics: expf, no fast-math, -fmad=false; the plain PyTorch version
// (deblurgs_tpu_torch/ops/cuda_blend_mixed.py::backward_ref) repeats every
// product and sum in the same order, the pixel sums included.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PPT = 4;        // pixels per thread: tiles up to 1024 pixels
constexpr int BATCH = 128;    // pairs staged per round
constexpr int NGRAD = 10;     // gradient rows 0-9
constexpr int TAIL_BLOCKS = 264;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
constexpr unsigned FULL = 0xffffffffu;

template <bool FAST>
__global__ void __launch_bounds__(THREADS) backward_mixed_kernel(
    const float* __restrict__ fields, int64_t max_pairs,
    const int32_t* __restrict__ tile_start, const int32_t* __restrict__ tile_stop,
    int total_tiles, int num_tiles, int tiles_x, int tile_w, int tile_h,
    const float* __restrict__ dl_pix, const float* __restrict__ dl_depth,
    const float* __restrict__ total, float* __restrict__ out) {
  if (static_cast<int>(blockIdx.x) >= total_tiles) {
    // the uncovered tail: every slot at or past the last tile's stop
    const int64_t tail0 = total_tiles > 0 ? tile_stop[total_tiles - 1] : 0;
    const int64_t stride = static_cast<int64_t>(gridDim.x - total_tiles) * THREADS;
    const int64_t first = static_cast<int64_t>(blockIdx.x - total_tiles) * THREADS + threadIdx.x;
    for (int f = 0; f < NFIELD; ++f)
      for (int64_t s = tail0 + first; s < max_pairs; s += stride) out[f * max_pairs + s] = 0.0f;
    return;
  }

  __shared__ float s_f[NBLEND][BATCH];
  __shared__ float s_part[WARPS][NGRAD][BATCH];

  const int tile = blockIdx.x;
  const int img_tile = tile % num_tiles;
  const float tx0 = static_cast<float>((img_tile % tiles_x) * tile_w);
  const float ty0 = static_cast<float>((img_tile / tiles_x) * tile_h);
  const int px_n = tile_w * tile_h;
  const int start = tile_start[tile];
  const int stop = tile_stop[tile];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float T[PPT], prefix[PPT], tot[PPT], dlr[PPT], dlg[PPT], dlb[PPT], dld[PPT];
  float pxf[PPT], pyf[PPT];
  bool done[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = threadIdx.x + k * THREADS;
    done[k] = p >= px_n;
    const int64_t o = static_cast<int64_t>(tile) * px_n + (done[k] ? 0 : p);
    T[k] = 1.0f;
    prefix[k] = 0.0f;
    tot[k] = done[k] ? 0.0f : total[o];
    dlr[k] = done[k] ? 0.0f : dl_pix[3 * o + 0];
    dlg[k] = done[k] ? 0.0f : dl_pix[3 * o + 1];
    dlb[k] = done[k] ? 0.0f : dl_pix[3 * o + 2];
    dld[k] = done[k] ? 0.0f : dl_depth[o];
    pxf[k] = tx0 + static_cast<float>(p % tile_w);
    pyf[k] = ty0 + static_cast<float>(p / tile_w);
  }

  int base = start;
  for (; base < stop; base += BATCH) {
    bool live = false;
#pragma unroll
    for (int k = 0; k < PPT; ++k) live |= !done[k];
    // also the barrier that keeps the previous batch's reads of s_f and
    // s_part ahead of the overwrites below
    if (__syncthreads_count(live) == 0) break;
    const int n = min(BATCH, stop - base);
    if (threadIdx.x < n) {
#pragma unroll
      for (int f = 0; f < NBLEND; ++f)
        s_f[f][threadIdx.x] = fields[f * max_pairs + base + threadIdx.x];
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float mx = s_f[0][i], my = s_f[1][i];
      const float ca = s_f[2][i], cbq = s_f[3][i], cc = s_f[4][i];
      const float op = s_f[5][i];
      const float r = s_f[6][i], g = s_f[7][i], b = s_f[8][i], dep = s_f[9][i];
      float acc[NGRAD];
#pragma unroll
      for (int q = 0; q < NGRAD; ++q) acc[q] = 0.0f;
      bool any = false;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (done[k]) continue;
        const float dx = mx - pxf[k];
        const float dy = my - pyf[k];
        const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cbq * dx * dy;
        if (power > 0.0f) continue;
        const float G = expf(power);
        const float araw = op * G;
        const float alpha = fminf(0.99f, araw);
        if (alpha < ALPHA_MIN) continue;
        const float test_T = T[k] * (1.0f - alpha);
        if (!FAST && test_T < T_EPS) {
          done[k] = true;
          continue;
        }
        const float w = alpha * T[k];
        const float dlc = dlr[k] * r + dlg[k] * g + dlb[k] * b + dld[k] * dep;
        prefix[k] = prefix[k] + w * dlc;
        const float S = tot[k] - prefix[k];
        const float dla = dlc * T[k] - S / (1.0f - alpha);
        const float N = araw * dla;
        const float gx = ca * dx + cbq * dy;
        const float gy = cc * dy + cbq * dx;
        acc[0] = acc[0] + -N * gx;
        acc[1] = acc[1] + -N * gy;
        acc[2] = acc[2] + -0.5f * N * dx * dx;
        acc[3] = acc[3] + -N * dx * dy;
        acc[4] = acc[4] + -0.5f * N * dy * dy;
        acc[5] = acc[5] + G * dla;
        acc[6] = acc[6] + w * dlr[k];
        acc[7] = acc[7] + w * dlg[k];
        acc[8] = acc[8] + w * dlb[k];
        acc[9] = acc[9] + w * dld[k];
        T[k] = test_T;
        any = true;
      }
      if (__any_sync(FULL, any)) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
          for (int q = 0; q < NGRAD; ++q)
            acc[q] = acc[q] + __shfl_down_sync(FULL, acc[q], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < NGRAD; ++q) s_part[warp][q][i] = acc[q];
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < NFIELD * BATCH; idx += THREADS) {
      const int row = idx / BATCH;
      const int i = idx % BATCH;
      if (i >= n) continue;
      float v = 0.0f;
      if (row < NGRAD) {
        v = s_part[0][row][i];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) v = v + s_part[w][row][i];
      }
      out[row * max_pairs + base + i] = v;
    }
  }
  // early exit: the pairs after the block froze get zero gradients
  for (int f = 0; f < NFIELD; ++f)
    for (int s = base + threadIdx.x; s < stop; s += THREADS) out[f * max_pairs + s] = 0.0f;
}

}  // namespace

// fields [16, max_pairs] f32; tile_start/tile_stop [total_tiles] i32;
// dl_pix [total_tiles, px, 3], dl_depth and total [total_tiles, px] f32;
// out [16, max_pairs] f32, every slot written. Needs tile_w * tile_h <= 1024.
extern "C" int deblurgs_backward_mixed(const void* fields, int64_t max_pairs,
                                       const void* tile_start, const void* tile_stop,
                                       int total_tiles, int num_tiles, int tiles_x,
                                       int tile_w, int tile_h, int fast, const void* dl_pix,
                                       const void* dl_depth, const void* total, void* out,
                                       void* stream) {
  if (tile_w * tile_h > THREADS * PPT) return static_cast<int>(cudaErrorInvalidValue);
  if (max_pairs <= 0) return 0;
  auto kernel = fast ? backward_mixed_kernel<true> : backward_mixed_kernel<false>;
  kernel<<<total_tiles + TAIL_BLOCKS, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fields), max_pairs,
      static_cast<const int32_t*>(tile_start), static_cast<const int32_t*>(tile_stop),
      total_tiles, num_tiles, tiles_x, tile_w, tile_h, static_cast<const float*>(dl_pix),
      static_cast<const float*>(dl_depth), static_cast<const float*>(total),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
