// K2: per-pair gradients of the front-to-back composite; K6 on one view's
// tiles (layout="lockstep").
//
// Replaces deblurgs_tpu/ops/pallas_blend_mixed.py::backward_mixed
// (_backward_kernel, _backward_chunk_body; pallas_blend_mixed.py:592-789)
// and, on one view, deblurgs_tpu/ops/pallas_blend.py::backward
// (_backward_kernel; pallas_blend.py:655-762, 951-1038). The TPU kernels
// re-derived the transmittance recurrence as segmented prefix products on
// the MXU over 128-pair chunks, routed per-tile cotangents with one-hot
// matmuls and took the pixel sums as moment matmuls. Here it is K1's design
// run again with the cotangents: one thread block per stacked tile, K1's
// pixel layout, the tile's pair range staged through shared memory in
// batches of 128.
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
// Design for this card. What bounds it: issued instructions, ~90 a (pixel,
// pair) evaluation (K1's gate with its expf, an IEEE divide, the gradient
// terms, all without FMA contraction) and ~85 a (pair, warp) visit for the
// warp's reduction and stores, not the ~12 f32 operations of the gate that
// the bound counts (PERF.md has the count from the SASS). The design:
// - Four pixels a thread in compact warp patches (cuda_blend_mixed.
//   backward_layout): patch_w × (32 / patch_w · 4) pixels, lane l taking
//   column l % patch_w and rows l / patch_w + k·(32 / patch_w), k < 4:
//   16×8 patches, eight in a 32×32 tile, two in a 16×16 tile. A block has
//   one warp a patch, so no warp idles: at 16×16, 64-thread blocks. (K1's
//   layout, one pixel a thread in eight 16×2 patches at 16×16, was slower
//   on the evaluation lists: the warp's ~85-instruction reduction is then
//   shared by 32 evaluations, not 128; PERF.md has the times.) A thread's pixels
//   share dx, so rows 0-4 come from three per-thread moments (ΣN, ΣN·dy,
//   Σ(N·dy)·dy) and a few products by dx after its pixels, not ten terms a
//   pixel. A tile no eight patches cover takes K1's row strips
//   p = t + 256 k (eight warps), with moments a pixel, summed over the
//   thread's pixels in turn.
// - A warp whose pixels have all frozen stops walking; it still meets the
//   block's barriers, and the block exits when every warp has stopped.
// - A warp none of whose pixels composites a pair skips the reduction and
//   writes zero partials.
// - CULL, where the staging left the lists uncut (evaluation): the thread
//   that stages a pair also stages its cull box (common.cuh::cull_box), and
//   a warp skips each pair whose box misses its pixels' rectangle, writing
//   the zero partials of a warp that composites nothing. T, prefix and the
//   freeze do not move: no pixel of the warp could have composited the pair.
//   On the train step's tile-culled lists the splats cover most of a tile,
//   and the cull stays compiled out (measured there, it cost more than it
//   saved).
// - The warp reduction is a reduce-scatter (common.cuh::
//   warp_reduce_scatter10): 12 shuffles for the 10 sums instead of 50, each
//   sum ending in its own lane, bit for bit the shuffle-down tree's sums
//   that cuda_blend_mixed._patch_pair_sums mirrors.
// - __launch_bounds__ for three 256-thread blocks (24 warps) an SM: 80
//   registers. The warp partials take dynamic shared memory by the block's
//   warps.
// - The pixels are walked without branches (values selected where a pixel
//   does not composite), so their chains interleave.
// - total = dl·C + final_T·(dl·bg + z_far·dL/dd) is computed in the
//   prologue from K1's outputs, not by a separate pass over the pixels.
// - Output is slot-major [max_pairs, 16], one 64 B row a slot written as
//   four 16 B stores; rows 10-15 are zero. Blocks past the last tile zero the
//   rows no tile range covers (the sentinel tail), a block that stops early
//   zeroes the rest of its range, so no slot is left uninitialised and K4
//   can read every slot's row.
// A per-warp record of the composited pairs was tried and dropped: it cost
// more than it saved (PERF.md).
//
// Numerics: expf, no fast-math, -fmad=false; the plain PyTorch version
// (deblurgs_tpu_torch/ops/cuda_blend_mixed.py::backward_ref) repeats every
// product and sum in the same order, the pixel sums included. Two calls give
// bitwise-equal output; there are no atomics.

#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int PPT = 4;        // pixels a thread: tiles up to 1024 pixels
constexpr int BATCH = 128;    // pairs staged per round
constexpr int SPAD = BATCH + 1;  // partial row stride: the ten writer lanes hit ten banks
constexpr int NGRAD = 10;     // gradient rows 0-9
constexpr int TAIL_BLOCKS = 264;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
constexpr unsigned FULL = 0xffffffffu;

// The block's threads and warps, read where they are used rather than held
// in registers across the pair loop: held, they moved the tile-32 loop's
// schedule by three instructions and K2 by 1.5% (PERF.md).
__device__ __forceinline__ int block_threads() { return static_cast<int>(blockDim.x); }
__device__ __forceinline__ int block_warps() { return static_cast<int>(blockDim.x) >> 5; }

// COLUMN: warp patches of patch_w × (32 / patch_w · 4) pixels, nx across
// the tile, one warp a patch; else row strips p = t + 256 k.
template <bool COLUMN, bool FAST, bool CULL>
__global__ void __launch_bounds__(MAX_THREADS, 3)
    backward_mixed_kernel(
    const float* __restrict__ fields, int64_t max_pairs,
    const int32_t* __restrict__ tile_start, const int32_t* __restrict__ tile_stop,
    int total_tiles, int num_tiles, int tiles_x, int tile_w, int tile_h, int patch_w, int nx,
    const float* __restrict__ dl_pix, const float* __restrict__ dl_depth,
    const float* __restrict__ out_c, const float* __restrict__ out_d,
    const float* __restrict__ final_t, const float* __restrict__ bg, float z_far,
    float4* __restrict__ out) {
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (static_cast<int>(blockIdx.x) >= total_tiles) {
    // the uncovered tail: every row at or past the last tile's stop
    const int64_t tail0 = total_tiles > 0 ? tile_stop[total_tiles - 1] : 0;
    const int64_t stride = static_cast<int64_t>(gridDim.x - total_tiles) * block_threads();
    const int64_t first =
        static_cast<int64_t>(blockIdx.x - total_tiles) * block_threads() + threadIdx.x;
    for (int64_t e = tail0 * 4 + first; e < max_pairs * 4; e += stride) out[e] = zero4;
    return;
  }

  __shared__ __align__(16) float s_f[BATCH][12];   // a pair's rows 0-9, read as 16 B
  __shared__ float4 s_box[CULL ? BATCH : 1];
  extern __shared__ float s_part[];                // [warps][NGRAD][SPAD]

  const int tile = blockIdx.x;
  const int img_tile = tile % num_tiles;
  const float tx0 = static_cast<float>((img_tile % tiles_x) * tile_w);
  const float ty0 = static_cast<float>((img_tile / tiles_x) * tile_h);
  const int px_n = tile_w * tile_h;
  const float bg0 = bg[0], bg1 = bg[1], bg2 = bg[2];
  const int start = tile_start[tile];
  const int stop = tile_stop[tile];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* part = s_part + warp * NGRAD * SPAD;

  // this thread's pixels (x, y in the tile); a warp past the tile's patches
  // or a lane past the tile has none
  int px[PPT], py[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    if constexpr (COLUMN) {
      const int step = 32 / patch_w;
      px[k] = (warp % nx) * patch_w + lane % patch_w;
      py[k] = (warp / nx) * step * PPT + lane / patch_w + k * step;
    } else {
      const int p = threadIdx.x + k * MAX_THREADS;
      px[k] = p % tile_w;
      py[k] = p < px_n ? p / tile_w : tile_h;
    }
  }
  constexpr int NX = COLUMN ? 1 : PPT;   // distinct dx values a thread
  float T[PPT], prefix[PPT], tot[PPT], dlr[PPT], dlg[PPT], dlb[PPT], dld[PPT], pyf[PPT];
  float pxf[NX];
  bool done[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    done[k] = px[k] >= tile_w || py[k] >= tile_h;
    const int64_t o = static_cast<int64_t>(tile) * px_n + (done[k] ? 0 : py[k] * tile_w + px[k]);
    T[k] = 1.0f;
    prefix[k] = 0.0f;
    dlr[k] = done[k] ? 0.0f : dl_pix[3 * o + 0];
    dlg[k] = done[k] ? 0.0f : dl_pix[3 * o + 1];
    dlb[k] = done[k] ? 0.0f : dl_pix[3 * o + 2];
    dld[k] = done[k] ? 0.0f : dl_depth[o];
    // total = dl·C + final_T·(dl·bg + z_far·dL/dd), in
    // cuda_blend_mixed.backward_total's order
    if (done[k]) {
      tot[k] = 0.0f;
    } else {
      const float sig = ((out_c[3 * o] * dlr[k] + out_c[3 * o + 1] * dlg[k]) +
                         out_c[3 * o + 2] * dlb[k]) + out_d[o] * dld[k];
      const float bgd = ((dlr[k] * bg0 + dlg[k] * bg1) + dlb[k] * bg2) + z_far * dld[k];
      tot[k] = sig + final_t[o] * bgd;
    }
    if (k < NX) pxf[k] = tx0 + static_cast<float>(px[k]);
    pyf[k] = ty0 + static_cast<float>(py[k]);
  }
  float4 rect;
  if constexpr (CULL) rect = warp_rect<PPT>(px, py, tile_w, tile_h, tx0, ty0);
  // the reduce-scatter leaves sum my_q in this lane; one lane per sum writes it
  const int my_q = scatter10_index(lane);
  const bool writer = scatter10_writer(lane);

  int base = start;
  for (; base < stop; base += BATCH) {
    bool live = false;
#pragma unroll
    for (int k = 0; k < PPT; ++k) live |= !done[k];
    // also the barrier that keeps the previous batch's reads of the shared
    // arrays ahead of the overwrites below
    if (__syncthreads_count(live) == 0) break;
    const int n = min(BATCH, stop - base);
    for (int j = threadIdx.x; j < n; j += block_threads()) {
      float v[NBLEND];
#pragma unroll
      for (int q = 0; q < NBLEND; ++q) v[q] = fields[q * max_pairs + base + j];
#pragma unroll
      for (int q = 0; q < NBLEND; ++q) s_f[j][q] = v[q];
      if constexpr (CULL) s_box[j] = cull_box(v);
    }
    __syncthreads();

    bool warp_live = __any_sync(FULL, live);
    int i = 0;
    for (; i < n && warp_live; ++i) {
      if constexpr (CULL) {
        if (box_misses(s_box[i], rect)) {
          if (writer) part[my_q * SPAD + i] = 0.0f;
          continue;
        }
      }
      const float4 f0 = *reinterpret_cast<const float4*>(&s_f[i][0]);
      const float4 f1 = *reinterpret_cast<const float4*>(&s_f[i][4]);
      const float2 f2 = *reinterpret_cast<const float2*>(&s_f[i][8]);
      const float mx = f0.x, my = f0.y, ca = f0.z, cbq = f0.w;
      const float cc = f1.x, op = f1.y, r = f1.z, g = f1.w, b = f2.x, dep = f2.y;
      float dx[NX], cadx[NX], cadxdx[NX], cbdx[NX];
#pragma unroll
      for (int h = 0; h < NX; ++h) {
        dx[h] = mx - pxf[h];
        cadx[h] = ca * dx[h];
        cadxdx[h] = cadx[h] * dx[h];
        cbdx[h] = cbq * dx[h];
      }
      // rows 0-4 from three moments of each column's pixels (a column's
      // pixels share dx): ΣN, ΣN·dy, Σ(N·dy)·dy; rows 5-9 directly
      float acc[NGRAD];
      float sN[NX], sNdy[NX], sNdy2[NX];
#pragma unroll
      for (int h = 0; h < NX; ++h) sN[h] = sNdy[h] = sNdy2[h] = 0.0f;
#pragma unroll
      for (int q = 5; q < NGRAD; ++q) acc[q] = 0.0f;
      bool any = false;
      // the pixels without branches: each value is selected where the
      // pixel's gates would skip, so their chains interleave
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int h = COLUMN ? 0 : k;
        const float dy = my - pyf[k];
        const float ccdy = cc * dy;
        const float power = -0.5f * (cadxdx[h] + ccdy * dy) - cbdx[h] * dy;
        const float G = expf(power);
        const float araw = op * G;
        const float alpha = fminf(0.99f, araw);
        const float test_T = T[k] * (1.0f - alpha);
        bool c = !done[k] && !(power > 0.0f) && !(alpha < ALPHA_MIN);
        if constexpr (!FAST) {
          const bool freeze = c && test_T < T_EPS;
          done[k] = done[k] || freeze;
          c = c && !freeze;
        }
        const float w = alpha * T[k];
        const float dlc = dlr[k] * r + dlg[k] * g + dlb[k] * b + dld[k] * dep;
        const float pre = prefix[k] + w * dlc;
        const float S = tot[k] - pre;
        const float dla = dlc * T[k] - S / (1.0f - alpha);
        // a pixel that does not composite adds zeros (finite factors times a
        // selected 0), as the plain version's masked terms do
        const float N = c ? araw * dla : 0.0f;
        const float wz = c ? w : 0.0f;
        const float nd = N * dy;
        sN[h] = sN[h] + N;
        sNdy[h] = sNdy[h] + nd;
        sNdy2[h] = sNdy2[h] + nd * dy;
        acc[5] = acc[5] + (c ? G * dla : 0.0f);
        acc[6] = acc[6] + wz * dlr[k];
        acc[7] = acc[7] + wz * dlg[k];
        acc[8] = acc[8] + wz * dlb[k];
        acc[9] = acc[9] + wz * dld[k];
        prefix[k] = c ? pre : prefix[k];
        T[k] = c ? test_T : T[k];
        any = any || c;
      }
      // d mean2d = -Σ N·(a dx + b dy, c dy + b dx), d conic = -Σ N·(dx²/2,
      // dx dy, dy²/2), each column's term added in turn
#pragma unroll
      for (int h = 0; h < NX; ++h) {
        const float t0 = -(cadx[h] * sN[h] + cbq * sNdy[h]);
        const float t1 = -(cc * sNdy[h] + cbdx[h] * sN[h]);
        const float t2 = -0.5f * dx[h] * dx[h] * sN[h];
        const float t3 = -(dx[h] * sNdy[h]);
        const float t4 = -0.5f * sNdy2[h];
        acc[0] = h ? acc[0] + t0 : t0;
        acc[1] = h ? acc[1] + t1 : t1;
        acc[2] = h ? acc[2] + t2 : t2;
        acc[3] = h ? acc[3] + t3 : t3;
        acc[4] = h ? acc[4] + t4 : t4;
      }
      if (__any_sync(FULL, any)) {
        const float d = warp_reduce_scatter10(acc, lane);
        if (writer) part[my_q * SPAD + i] = d;
      } else if (writer) {
        part[my_q * SPAD + i] = 0.0f;
      }
      if constexpr (!FAST) {
        bool still = false;
#pragma unroll
        for (int k = 0; k < PPT; ++k) still |= !done[k];
        warp_live = __any_sync(FULL, still);
      }
    }
    // a warp that stopped early: zero partials for the pairs it left
    const int rest = n - i;
    for (int e = lane; e < rest * NGRAD; e += 32) part[(e / rest) * SPAD + i + e % rest] = 0.0f;
    __syncthreads();
    // cross-warp sums in warp order, one 16 B quarter of a 64 B row per item
    for (int e = threadIdx.x; e < n * 4; e += block_threads()) {
      const int j = e >> 2, quarter = e & 3;
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (quarter < 3) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int q = quarter * 4 + c;
          if (q >= NGRAD) continue;
          float s = s_part[q * SPAD + j];
#pragma unroll
          for (int w = 1; w < MAX_WARPS; ++w)
            if (w < block_warps()) s = s + s_part[(w * NGRAD + q) * SPAD + j];
          v[c] = s;
        }
      }
      out[static_cast<int64_t>(base + j) * 4 + quarter] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  // early exit: the pairs after the block froze get zero gradients
  for (int64_t e = static_cast<int64_t>(base) * 4 + threadIdx.x; e < static_cast<int64_t>(stop) * 4;
       e += block_threads())
    out[e] = zero4;
}

template <bool COLUMN>
int launch(bool fast, bool cull, int blocks, int threads, cudaStream_t s, const float* fields,
           int64_t max_pairs, const int32_t* start, const int32_t* stop, int total_tiles,
           int num_tiles, int tiles_x, int tile_w, int tile_h, int patch_w, int nx,
           const float* dl_pix, const float* dl_depth, const float* c, const float* d,
           const float* t, const float* bg, float z_far, float4* out) {
  auto kernel = fast ? (cull ? backward_mixed_kernel<COLUMN, true, true>
                             : backward_mixed_kernel<COLUMN, true, false>)
                     : (cull ? backward_mixed_kernel<COLUMN, false, true>
                             : backward_mixed_kernel<COLUMN, false, false>);
  // the warp partials: eight warps with the cull's boxes pass the 48 KB
  // that a block gets without asking
  const size_t smem = static_cast<size_t>(threads / 32) * NGRAD * SPAD * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, threads, smem, s>>>(fields, max_pairs, start, stop, total_tiles, num_tiles,
                                       tiles_x, tile_w, tile_h, patch_w, nx, dl_pix, dl_depth, c,
                                       d, t, bg, z_far, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fields [16, max_pairs] f32; tile_start/tile_stop [total_tiles] i32;
// dl_pix and C [total_tiles, px, 3], dl_depth, D and final_T [total_tiles,
// px] f32 (K1's outputs, pre-background); bg [3] f32; out [max_pairs, 16] f32
// (16 B aligned), every row written. The layout is
// cuda_blend_mixed.backward_layout's: four pixels a thread in warp patches
// patch_w wide, nx across the tile, one warp a patch (at most 8), or row
// strips in eight warps where patch_w is 0. cull: the lists are uncut, and
// each warp skips the pairs whose cull box misses it (CULL above).
extern "C" int deblurgs_backward_mixed(const void* fields, int64_t max_pairs,
                                       const void* tile_start, const void* tile_stop,
                                       int total_tiles, int num_tiles, int tiles_x,
                                       int tile_w, int tile_h, int patch_w, int nx, int fast,
                                       int cull, const void* dl_pix, const void* dl_depth,
                                       const void* out_c, const void* out_d,
                                       const void* final_t, const void* bg, float z_far,
                                       void* out, void* stream) {
  if (tile_w <= 0 || tile_h <= 0 || tile_w * tile_h > MAX_THREADS * PPT)
    return static_cast<int>(cudaErrorInvalidValue);
  int threads = MAX_THREADS;
  if (patch_w != 0) {
    const int patch_h =
        (patch_w > 0 && patch_w <= 32 && 32 % patch_w == 0) ? 32 / patch_w * PPT : 0;
    const int patches = patch_h ? nx * ((tile_h + patch_h - 1) / patch_h) : 0;
    if (patch_h == 0 || nx != (tile_w + patch_w - 1) / patch_w || patches > MAX_WARPS)
      return static_cast<int>(cudaErrorInvalidValue);
    threads = 32 * patches;
  }
  if (max_pairs <= 0) return 0;
  const int blocks = total_tiles + TAIL_BLOCKS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const float*>(fields);
  const auto* a = static_cast<const int32_t*>(tile_start);
  const auto* b = static_cast<const int32_t*>(tile_stop);
  const auto* gp = static_cast<const float*>(dl_pix);
  const auto* gd = static_cast<const float*>(dl_depth);
  const auto* c = static_cast<const float*>(out_c);
  const auto* d = static_cast<const float*>(out_d);
  const auto* t = static_cast<const float*>(final_t);
  const auto* bgp = static_cast<const float*>(bg);
  auto* o = static_cast<float4*>(out);
  return (patch_w ? launch<true> : launch<false>)(
      fast, cull, blocks, threads, s, f, max_pairs, a, b, total_tiles, num_tiles, tiles_x,
      tile_w, tile_h, patch_w, nx, gp, gd, c, d, t, bgp, z_far, o);
}
