// K5: front-to-back alpha compositing of one view's tiles (layout="lockstep").
//
// Replaces deblurgs_tpu/ops/pallas_blend.py::forward (_forward_kernel,
// _chunk_core; pallas_blend.py:512-566, 585-653, 765-821). The TPU kernel walks
// a (window × 128-pair chunk) grid driven by scalar-prefetched step maps, and
// turns the transmittance recurrence into MXU prefix products of log(1 - α)
// in split bf16. None of that carries over. Here one thread block walks one
// tile's range of the depth-sorted pair list front to back, the pairs staged
// through shared memory 256 at a time, one thread per pixel of a 16×16 tile
// (PPT = 2 or 4 pixels a thread for tiles up to 32×32), and the block stops
// once every pixel has frozen (JAX's max(U) >= T_EPS chunk skip, :622).
//
// What the card sees on this path, and the design's answer:
// - 16×16 tiles by default: K1's 256 threads × 4 pixels would leave three of
//   every four pixel slots idle, so PPT is a template parameter (1 here).
// - uncut lists: evaluation renders with need_n_contrib on, which switches
//   the exact tile cull off, so a tile's list is its full rect list. What
//   bounds K5 is the gate arithmetic per (pixel, pair) evaluation (~12 f32
//   operations and one expf); the early exit cuts it for saturated tiles.
// - one view: 8,160 blocks at 1920×1080 with 16×16 tiles, about eight waves
//   of the card's 132 SMs × 8 blocks of 256 threads.
//
// Gates (lockstep.cuh): skip at power > 0 or alpha < 1/255, alpha clamped at
// 0.99, freeze before the pair that would take T below 1e-4. final_T is the
// last composited T; n_con the 1-based position in the tile's list of the
// last composited pair. An empty tile gives C = D = 0, T = 1, n = 0.
//
// Numerics: expf, no fast-math, -fmad=false: the plain version
// (deblurgs_tpu_torch/ops/cuda_blend_lockstep.py::forward_lockstep_ref)
// repeats each product and sum, so the two agree bit for bit.

#include "lockstep.cuh"

namespace {

using namespace lockstep;
constexpr int BATCH = THREADS;   // pairs staged per round, one per thread

template <int PPT>
__global__ void __launch_bounds__(THREADS) forward_lockstep_kernel(
    const float* __restrict__ fields, int64_t max_pairs,
    const int32_t* __restrict__ tile_start, const int32_t* __restrict__ tile_stop,
    int tiles_x, int tile_w, int tile_h, float* __restrict__ out_c,
    float* __restrict__ out_d, float* __restrict__ out_t, int32_t* __restrict__ out_n) {
  __shared__ float s_f[NBLEND][BATCH];

  const int tile = blockIdx.x;
  const float tx0 = static_cast<float>((tile % tiles_x) * tile_w);
  const float ty0 = static_cast<float>((tile / tiles_x) * tile_h);
  const int px_n = tile_w * tile_h;
  const int start = tile_start[tile];
  const int stop = tile_stop[tile];

  float T[PPT], cr[PPT], cg[PPT], cb[PPT], dd[PPT], pxf[PPT], pyf[PPT];
  int last[PPT];
  bool done[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = threadIdx.x + k * THREADS;
    T[k] = 1.0f;
    cr[k] = cg[k] = cb[k] = dd[k] = 0.0f;
    last[k] = 0;
    done[k] = p >= px_n;
    pxf[k] = tx0 + static_cast<float>(p % tile_w);
    pyf[k] = ty0 + static_cast<float>(p / tile_w);
  }

  for (int base = start; base < stop; base += BATCH) {
    bool live = false;
#pragma unroll
    for (int k = 0; k < PPT; ++k) live |= !done[k];
    // block-wide early exit; also the barrier that keeps the previous
    // batch's reads ahead of the overwrite below
    if (__syncthreads_count(live) == 0) break;
    const int j = base + threadIdx.x;
    if (j < stop) {
#pragma unroll
      for (int f = 0; f < NBLEND; ++f) s_f[f][threadIdx.x] = fields[f * max_pairs + j];
    }
    __syncthreads();
    const int n = min(BATCH, stop - base);
    for (int i = 0; i < n; ++i) {
      const float mx = s_f[0][i], my = s_f[1][i];
      const float ca = s_f[2][i], cbq = s_f[3][i], cc = s_f[4][i];
      const float op = s_f[5][i];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (done[k]) continue;
        float dx, dy, G, alpha, test_T;
        const Gate g = gate(mx, my, ca, cbq, cc, op, pxf[k], pyf[k], T[k], dx, dy, G, alpha,
                            test_T);
        if (g == kSkip) continue;
        if (g == kFreeze) {
          done[k] = true;
          continue;
        }
        const float w = alpha * T[k];
        cr[k] = cr[k] + w * s_f[6][i];
        cg[k] = cg[k] + w * s_f[7][i];
        cb[k] = cb[k] + w * s_f[8][i];
        dd[k] = dd[k] + w * s_f[9][i];
        T[k] = test_T;
        last[k] = base + i - start + 1;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = threadIdx.x + k * THREADS;
    if (p >= px_n) continue;
    const int64_t o = static_cast<int64_t>(tile) * px_n + p;
    out_c[3 * o + 0] = cr[k];
    out_c[3 * o + 1] = cg[k];
    out_c[3 * o + 2] = cb[k];
    out_d[o] = dd[k];
    out_t[o] = T[k];
    if (out_n != nullptr) out_n[o] = last[k];
  }
}

}  // namespace

// fields [16, max_pairs] f32; tile_start/tile_stop [num_tiles] i32 (one
// view); outputs C [num_tiles, px, 3], D and T [num_tiles, px] f32, n_con
// [num_tiles, px] i32 or null. Needs 0 < tile_w * tile_h <= 1024.
extern "C" int deblurgs_forward_lockstep(const void* fields, int64_t max_pairs,
                                         const void* tile_start, const void* tile_stop,
                                         int num_tiles, int tiles_x, int tile_w, int tile_h,
                                         void* out_c, void* out_d, void* out_t, void* out_n,
                                         void* stream) {
  const int ppt = pixels_per_thread(tile_w * tile_h);
  if (ppt == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles <= 0) return 0;
  auto kernel = ppt == 1   ? forward_lockstep_kernel<1>
                : ppt == 2 ? forward_lockstep_kernel<2>
                           : forward_lockstep_kernel<4>;
  kernel<<<num_tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fields), max_pairs, static_cast<const int32_t*>(tile_start),
      static_cast<const int32_t*>(tile_stop), tiles_x, tile_w, tile_h,
      static_cast<float*>(out_c), static_cast<float*>(out_d), static_cast<float*>(out_t),
      static_cast<int32_t*>(out_n));
  return static_cast<int>(cudaGetLastError());
}
