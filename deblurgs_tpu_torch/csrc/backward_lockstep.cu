// K6: per-pair gradients of one view's front-to-back composite
// (layout="lockstep").
//
// Replaces deblurgs_tpu/ops/pallas_blend.py::backward (_backward_kernel;
// pallas_blend.py:655-762, 951-1038). The TPU kernel runs the forward's
// prefix-product grid again with the cotangents, takes the pixel sums as
// moment matmuls ([1, p, q, p², q², pq]ᵀ @ N) and, for window > 1, selects
// each slot's value from its owning sub-tile's output (:1014-1026). All of
// that is grid bookkeeping of the TPU. Here K5's layout runs again: one block
// per tile, one thread per pixel of a 16×16 tile (PPT = 2 or 4 for larger
// tiles), the tile's pair range staged through shared memory.
//
// Per pixel, for the pairs j of its tile in depth order (K5's gates replayed
// front to back with K5's exact float32 sequence through lockstep.cuh, so the
// freeze at T < 1e-4 falls on the same pair as in the forward; dividing back
// to front would drift and could move it):
//   w_j        = alpha_j · T_{j-1},  dl·c_j = dL/drgb·rgb_j + dL/dd·depth_j
//   prefix_j   = Σ_{i≤j} w_i (dl·c_i),  S_j = total - prefix_j
//   dL/dalpha_j = (dl·c_j) T_{j-1} - S_j / (1 - alpha_j)        (:706-712)
// with total = dl·C + final_T·(dl·bg + z_far·dL/dd) computed by the wrapper.
// A pair's gradients are sums over the tile's pixels of
//   d mean2d = N·(-(a dx + b dy), -(c dy + b dx)),  N = opacity·G·dL/dalpha
//   d conic  = N·(-dx²/2, -dx·dy, -dy²/2),  d opacity = G·dL/dalpha,
//   d rgb    = w·dL/drgb,  d depth = w·dL/dd.
//
// The sums go to the pair's own slot in a fixed order, with no atomics: a
// thread adds its PPT pixels in turn, the warp adds its lanes by a shuffle
// tree, then the eight warp partials are added in warp order. A warp none of
// whose pixels composite the pair skips its shuffles. The output is
// slot-major [max_pairs, 16] (K2's layout, the one K4 reads), rows 10-15 of
// each slot written as zero. Blocks past the last tile zero the slots no tile range covers (the
// sentinel tail), and a block that exits early zeroes the rest of its range,
// so K4 never reads uninitialised memory. Two calls give bitwise-equal output.
//
// What bounds it: K5's gate work per (pixel, pair) plus ~30 f32 operations per
// composited (pixel, pair) and 50 shuffles per pair and warp with a
// contributing pixel. Shared memory: 5,120 B of staged fields and 40,960 B of
// warp partials per block.
//
// Numerics: expf, no fast-math, -fmad=false; the plain version
// (deblurgs_tpu_torch/ops/cuda_blend_lockstep.py::backward_lockstep_ref)
// repeats every product and sum in the same order, pixel sums included.

#include "lockstep.cuh"

namespace {

using namespace lockstep;
constexpr int WARPS = THREADS / 32;
constexpr int BATCH = 128;        // pairs staged per round
constexpr int NGRAD = 10;         // gradient rows 0-9
constexpr int TAIL_BLOCKS = 264;
constexpr unsigned FULL = 0xffffffffu;

template <int PPT>
__global__ void __launch_bounds__(THREADS) backward_lockstep_kernel(
    const float* __restrict__ fields, int64_t max_pairs,
    const int32_t* __restrict__ tile_start, const int32_t* __restrict__ tile_stop,
    int num_tiles, int tiles_x, int tile_w, int tile_h, const float* __restrict__ dl_pix,
    const float* __restrict__ dl_depth, const float* __restrict__ total,
    float* __restrict__ out) {
  if (static_cast<int>(blockIdx.x) >= num_tiles) {
    // the uncovered tail: every slot at or past the last tile's stop
    const int64_t tail0 = tile_stop[num_tiles - 1];
    const int64_t stride = static_cast<int64_t>(gridDim.x - num_tiles) * THREADS;
    const int64_t first = static_cast<int64_t>(blockIdx.x - num_tiles) * THREADS + threadIdx.x;
    for (int64_t e = tail0 * NFIELD + first; e < max_pairs * NFIELD; e += stride) out[e] = 0.0f;
    return;
  }

  __shared__ float s_f[NBLEND][BATCH];
  __shared__ float s_part[WARPS][NGRAD][BATCH];

  const int tile = blockIdx.x;
  const float tx0 = static_cast<float>((tile % tiles_x) * tile_w);
  const float ty0 = static_cast<float>((tile / tiles_x) * tile_h);
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
        float dx, dy, G, alpha, test_T;
        const Gate gt = gate(mx, my, ca, cbq, cc, op, pxf[k], pyf[k], T[k], dx, dy, G, alpha,
                             test_T);
        if (gt == kSkip) continue;
        if (gt == kFreeze) {
          done[k] = true;
          continue;
        }
        const float araw = op * G;
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
    // slot-major rows: consecutive threads write consecutive columns
    for (int idx = threadIdx.x; idx < NFIELD * n; idx += THREADS) {
      const int row = idx % NFIELD;
      const int i = idx / NFIELD;
      float v = 0.0f;
      if (row < NGRAD) {
        v = s_part[0][row][i];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) v = v + s_part[w][row][i];
      }
      out[static_cast<int64_t>(base + i) * NFIELD + row] = v;
    }
  }
  // early exit: the pairs after the block froze get zero gradients
  for (int64_t e = static_cast<int64_t>(base) * NFIELD + threadIdx.x;
       e < static_cast<int64_t>(stop) * NFIELD; e += THREADS)
    out[e] = 0.0f;
}

}  // namespace

// fields [16, max_pairs] f32; tile_start/tile_stop [num_tiles] i32 (one view);
// dl_pix [num_tiles, px, 3], dl_depth and total [num_tiles, px] f32; out
// [max_pairs, 16] f32, every slot written. Needs 0 < tile_w * tile_h <= 1024.
extern "C" int deblurgs_backward_lockstep(const void* fields, int64_t max_pairs,
                                          const void* tile_start, const void* tile_stop,
                                          int num_tiles, int tiles_x, int tile_w, int tile_h,
                                          const void* dl_pix, const void* dl_depth,
                                          const void* total, void* out, void* stream) {
  const int ppt = pixels_per_thread(tile_w * tile_h);
  if (ppt == 0 || num_tiles <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (max_pairs <= 0) return 0;
  auto kernel = ppt == 1   ? backward_lockstep_kernel<1>
                : ppt == 2 ? backward_lockstep_kernel<2>
                           : backward_lockstep_kernel<4>;
  kernel<<<num_tiles + TAIL_BLOCKS, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fields), max_pairs, static_cast<const int32_t*>(tile_start),
      static_cast<const int32_t*>(tile_stop), num_tiles, tiles_x, tile_w, tile_h,
      static_cast<const float*>(dl_pix), static_cast<const float*>(dl_depth),
      static_cast<const float*>(total), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
