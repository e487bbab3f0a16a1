// K2: per-pair gradients of the front-to-back composite.
//
// Replaces deblurgs_tpu/ops/pallas_blend_mixed.py::backward_mixed
// (_backward_kernel, _backward_chunk_body; pallas_blend_mixed.py:592-789).
// The TPU kernel re-derived the transmittance recurrence as segmented prefix
// products on the MXU over 128-pair chunks that span tiles, routed per-tile
// cotangents with one-hot matmuls and took the pixel sums as moment matmuls.
// Here it is K1's design run again with the cotangents: one thread block per
// stacked tile, 256 threads at four pixels each, the tile's pair range
// staged through shared memory in batches of 128.
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
// - Each warp owns a compact patch of the tile, patch_w × (32 / patch_w · 4)
//   pixels (16×8 in a 32×32 tile): lane l takes column l % patch_w and rows
//   l / patch_w + k·(32 / patch_w), k < 4. A thread's four pixels share dx,
//   so rows 0-4 come from three per-thread moments (ΣN, ΣN·dy, Σ(N·dy)·dy)
//   and a few products by dx after its pixels, not ten terms a pixel.
// - A warp whose pixels have all frozen stops walking; it still meets the
//   block's barriers, and the block exits when every warp has stopped.
// - A warp none of whose pixels composites a pair skips the reduction and
//   writes zero partials.
// - The warp reduction is a reduce-scatter (common.cuh::
//   warp_reduce_scatter10): 12 shuffles for the 10 sums instead of 50, each
//   sum ending in its own lane, bit for bit the shuffle-down tree's sums
//   that cuda_blend_mixed._patch_pair_sums mirrors.
// - __launch_bounds__ for three blocks (24 warps) an SM: 80 registers.
// - The four pixels are walked without branches (values selected where a
//   pixel does not composite), so their chains interleave.
// - total = dl·C + final_T·(dl·bg + z_far·dL/dd) is computed in the
//   prologue from K1's outputs, not by a separate pass over the pixels.
// - Output is slot-major [max_pairs, 16], one 64 B row a slot written as
//   four 16 B stores; rows 10-15 are zero. Blocks past the last tile zero the
//   rows no tile range covers (the sentinel tail), a block that stops early
//   zeroes the rest of its range, so no slot is left uninitialised and K4
//   can read every slot's row.
// A warp cull against the patch box and a per-warp record of the composited
// pairs were tried and dropped: on the train step's lists the splats cover
// most of a tile, so they skipped few visits and cost more than they saved
// (PERF.md, PR 4's series).
//
// Numerics: expf, no fast-math, -fmad=false; the plain PyTorch version
// (deblurgs_tpu_torch/ops/cuda_blend_mixed.py::backward_ref) repeats every
// product and sum in the same order, the pixel sums included. Two calls give
// bitwise-equal output; there are no atomics.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PPT = 4;        // pixels per thread: tiles up to 1024 pixels
constexpr int BATCH = 128;    // pairs staged per round
constexpr int SPAD = BATCH + 1;  // partial row stride: the ten writer lanes hit ten banks
constexpr int NGRAD = 10;     // gradient rows 0-9
constexpr int TAIL_BLOCKS = 264;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
constexpr unsigned FULL = 0xffffffffu;

struct Patches {
  int patch_w, patch_h, nx, n;  // patch size, patches across, patches in the tile
};

template <bool FAST>
__global__ void __launch_bounds__(THREADS, 3)
    backward_mixed_kernel(
    const float* __restrict__ fields, int64_t max_pairs,
    const int32_t* __restrict__ tile_start, const int32_t* __restrict__ tile_stop,
    int total_tiles, int num_tiles, int tiles_x, int tile_w, int tile_h, Patches pt,
    const float* __restrict__ dl_pix, const float* __restrict__ dl_depth,
    const float* __restrict__ out_c, const float* __restrict__ out_d,
    const float* __restrict__ final_t, const float* __restrict__ bg, float z_far,
    float4* __restrict__ out) {
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (static_cast<int>(blockIdx.x) >= total_tiles) {
    // the uncovered tail: every row at or past the last tile's stop
    const int64_t tail0 = total_tiles > 0 ? tile_stop[total_tiles - 1] : 0;
    const int64_t stride = static_cast<int64_t>(gridDim.x - total_tiles) * THREADS;
    const int64_t first = static_cast<int64_t>(blockIdx.x - total_tiles) * THREADS + threadIdx.x;
    for (int64_t e = tail0 * 4 + first; e < max_pairs * 4; e += stride) out[e] = zero4;
    return;
  }

  __shared__ __align__(16) float s_f[BATCH][12];   // a pair's rows 0-9, read as 16 B
  __shared__ float s_part[WARPS][NGRAD][SPAD];

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

  // this thread's pixels: one column of the warp's patch, rows `step` apart
  // (a warp past the tile's patches gets rows past the tile: no pixels)
  const int step = 32 / pt.patch_w;
  const int lx = (warp % pt.nx) * pt.patch_w + lane % pt.patch_w;
  const int ly = (warp / pt.nx) * pt.patch_h + lane / pt.patch_w;
  const float pxf = tx0 + static_cast<float>(lx);
  float T[PPT], prefix[PPT], tot[PPT], dlr[PPT], dlg[PPT], dlb[PPT], dld[PPT], pyf[PPT];
  bool done[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int y = ly + k * step;
    done[k] = lx >= tile_w || y >= tile_h;
    const int64_t o = static_cast<int64_t>(tile) * px_n + (done[k] ? 0 : y * tile_w + lx);
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
    pyf[k] = ty0 + static_cast<float>(y);
  }
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
    if (threadIdx.x < n) {
#pragma unroll
      for (int q = 0; q < NBLEND; ++q) s_f[threadIdx.x][q] = fields[q * max_pairs + base + threadIdx.x];
    }
    __syncthreads();

    bool warp_live = __any_sync(FULL, live);
    int i = 0;
    for (; i < n && warp_live; ++i) {
      const float4 f0 = *reinterpret_cast<const float4*>(&s_f[i][0]);
      const float4 f1 = *reinterpret_cast<const float4*>(&s_f[i][4]);
      const float2 f2 = *reinterpret_cast<const float2*>(&s_f[i][8]);
      const float mx = f0.x, my = f0.y, ca = f0.z, cbq = f0.w;
      const float cc = f1.x, op = f1.y, r = f1.z, g = f1.w, b = f2.x, dep = f2.y;
      const float dx = mx - pxf;
      const float cadx = ca * dx;
      const float cadxdx = cadx * dx;
      const float cbdx = cbq * dx;
      // rows 0-4 from three moments of the thread's pixels (they share dx):
      // ΣN, ΣN·dy, Σ(N·dy)·dy; rows 5-9 directly
      float acc[NGRAD];
      float sN = 0.0f, sNdy = 0.0f, sNdy2 = 0.0f;
#pragma unroll
      for (int q = 0; q < NGRAD; ++q) acc[q] = 0.0f;
      bool any = false;
      // the four pixels without branches: each value is selected where the
      // pixel's gates would skip, so the four chains interleave
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float dy = my - pyf[k];
        const float ccdy = cc * dy;
        const float power = -0.5f * (cadxdx + ccdy * dy) - cbdx * dy;
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
        sN = sN + N;
        sNdy = sNdy + nd;
        sNdy2 = sNdy2 + nd * dy;
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
      // dx dy, dy²/2)
      acc[0] = -(cadx * sN + cbq * sNdy);
      acc[1] = -(cc * sNdy + cbdx * sN);
      acc[2] = -0.5f * dx * dx * sN;
      acc[3] = -(dx * sNdy);
      acc[4] = -0.5f * sNdy2;
      if (__any_sync(FULL, any)) {
        const float d = warp_reduce_scatter10(acc, lane);
        if (writer) s_part[warp][my_q][i] = d;
      } else if (writer) {
        s_part[warp][my_q][i] = 0.0f;
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
    for (int e = lane; e < rest * NGRAD; e += 32) s_part[warp][e / rest][i + e % rest] = 0.0f;
    __syncthreads();
    // cross-warp sums in warp order, one 16 B quarter of a 64 B row per item
    for (int e = threadIdx.x; e < n * 4; e += THREADS) {
      const int j = e >> 2, part = e & 3;
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (part < 3) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int q = part * 4 + c;
          if (q >= NGRAD) continue;
          float s = s_part[0][q][j];
#pragma unroll
          for (int w = 1; w < WARPS; ++w) s = s + s_part[w][q][j];
          v[c] = s;
        }
      }
      out[static_cast<int64_t>(base + j) * 4 + part] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  // early exit: the pairs after the block froze get zero gradients
  for (int64_t e = static_cast<int64_t>(base) * 4 + threadIdx.x; e < static_cast<int64_t>(stop) * 4;
       e += THREADS)
    out[e] = zero4;
}

}  // namespace

// fields [16, max_pairs] f32; tile_start/tile_stop [total_tiles] i32;
// dl_pix and C [total_tiles, px, 3], dl_depth, D and final_T [total_tiles,
// px] f32 (K1's outputs, pre-background); bg [3] f32; out [max_pairs, 16] f32
// (16 B aligned), every row written. patch_w in {1, 2, 4, 8, 16, 32}; the
// tile must split into at most 8 patches of patch_w × (32 / patch_w · 4)
// pixels.
extern "C" int deblurgs_backward_mixed(const void* fields, int64_t max_pairs,
                                       const void* tile_start, const void* tile_stop,
                                       int total_tiles, int num_tiles, int tiles_x,
                                       int tile_w, int tile_h, int patch_w, int fast,
                                       const void* dl_pix, const void* dl_depth,
                                       const void* out_c, const void* out_d,
                                       const void* final_t, const void* bg, float z_far,
                                       void* out, void* stream) {
  if (patch_w <= 0 || patch_w > 32 || 32 % patch_w || tile_w <= 0 || tile_h <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Patches pt;
  pt.patch_w = patch_w;
  pt.patch_h = 32 / patch_w * PPT;
  pt.nx = (tile_w + patch_w - 1) / patch_w;
  pt.n = pt.nx * ((tile_h + pt.patch_h - 1) / pt.patch_h);
  if (pt.n > WARPS) return static_cast<int>(cudaErrorInvalidValue);
  if (max_pairs <= 0) return 0;
  const int blocks = total_tiles + TAIL_BLOCKS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = fast ? backward_mixed_kernel<true> : backward_mixed_kernel<false>;
  kernel<<<blocks, THREADS, 0, s>>>(
      static_cast<const float*>(fields), max_pairs, static_cast<const int32_t*>(tile_start),
      static_cast<const int32_t*>(tile_stop), total_tiles, num_tiles, tiles_x, tile_w, tile_h,
      pt, static_cast<const float*>(dl_pix), static_cast<const float*>(dl_depth),
      static_cast<const float*>(out_c), static_cast<const float*>(out_d),
      static_cast<const float*>(final_t), static_cast<const float*>(bg), z_far,
      static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
