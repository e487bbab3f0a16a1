// K3: segmented broadcast of the compact per-Gaussian table into slot space.
//
// Replaces deblurgs_tpu/ops/pallas_blend.py::broadcast_fields
// (_broadcast_kernel, pallas_blend.py:179-233). There, 128 slots at a time
// were expanded by a one-hot [256, 128] matmul on the MXU because a TPU
// gather pays per row. Here it is a plain gather:
//
//     out[f, s] = ctable[gauss_c[s], f]      f < 16, s < max_pairs
//
// and a rank outside [0, n_rows) writes 0 instead of reading out of
// bounds, as JAX's one-hot matmul over zero-padded rows gives
// (pallas_blend.py:187-196). The broadcast moves bytes and does no
// arithmetic: it is bound by the 64 B it writes a slot (plus 4 B of gauss_c
// and the [P, 16] table read once). Values are copied bit for bit, so the
// result equals ctable[gauss_c].T exactly.
//
// Design for this card: one thread a run of four consecutive slots reads
// their ranks as one 16 B load and each distinct 64 B table row once, as
// four 16 B loads through the read-only path (gauss_c is non-decreasing,
// so neighbouring slots mostly share a row: runs average ~25 slots on the
// train step's lists). It then writes, for each of the 16 output rows, the
// four slots as one 16 B vector, so a warp stores 512 contiguous bytes a
// row. gauss_c and the table are read once, not once a field. Where
// max_pairs is not a multiple of four the rows are not 16 B aligned, and
// the same threads load and store scalars.
//
// The key epilogue: while a thread holds its four slots' table rows it
// also works out what the staging's stable (tile, depth) sort reads, which
// the JAX package computes slot by slot over the broadcast rows
// (pallas_blend.py:314-342) and cuda_blend.slot_keys_ref repeats in
// PyTorch: the slot's tile id from its offset in the owner's rect and rows
// 10-13, the exact tile cull (cuda_blend._tile_visible, CULL) and, for a
// slot past min(total, max_pairs) or culled, tile id total_tiles, the 3e37
// depth sentinel and rank n_rows; then the packed key (tile << 32) | the
// depth's order-preserving bits. It follows the plain version's float32 operations
// in their order (the library builds with -fmad=false and IEEE division
// and logf), propagates NaN through max, min and clamp as torch.maximum,
// torch.minimum and torch.clamp do (fmaxf and fminf drop it), and maps
// -0.0 to +0.0 in the key only. -log(255 opacity) is computed once a
// distinct row. `total` is read on the device, so the host waits for
// nothing. The epilogue reads 8 B a slot (the offset) and writes 28 (key,
// tile id, rank, depth key): with K3's 68 B, 104 B a slot in one pass, in
// place of the ~120 slot-sized PyTorch passes of the plain version.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SPT = 4;   // consecutive slots a thread
constexpr float DEPTH_SENTINEL = 3e37f;

// What the key epilogue reads and writes besides K3's own arguments.
struct SlotKeyArgs {
  const int64_t* local;   // [max_pairs] the slot's offset within its owner's rect
  const int64_t* total;   // [] pairs emitted (> max_pairs on overflow)
  int64_t* key;           // [max_pairs] (tile << 32) | depth order bits
  int64_t* tile;          // [max_pairs] tile id; total_tiles where not kept
  int64_t* gc_sent;       // [max_pairs] compact rank; n_rows where not kept
  float* depth_key;       // [max_pairs] depth; DEPTH_SENTINEL where not kept
  int tile_w, tile_h, tiles_x;
  int64_t total_tiles;
};

// torch.maximum, torch.minimum and torch.clamp's bound: NaN in, NaN out
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// cuda_blend._tile_visible for one pair (mean mx, my, conic a, b, c) over
// the tile box at tile coordinates (tcx, tcy), thresh = -log(clamp(255
// opacity)), in the plain version's operation order.
__device__ __forceinline__ bool tile_visible(float mx, float my, float a, float b, float c,
                                             float tcx, float tcy, float thresh,
                                             const SlotKeyArgs& k) {
  const float x0 = tcx * static_cast<float>(k.tile_w);
  const float x1 = x0 + static_cast<float>(k.tile_w - 1);
  const float y0 = tcy * static_cast<float>(k.tile_h);
  const float y1 = y0 + static_cast<float>(k.tile_h - 1);
  const bool inside = (mx >= x0) & (mx <= x1) & (my >= y0) & (my <= y1);
  const auto q = [&](float dx, float dy) {
    return -0.5f * (a * dx * dx + c * dy * dy) - b * dx * dy;
  };
  const float cc = max_nan(c, 1e-12f), ca = max_nan(a, 1e-12f);
  const auto edge_x = [&](float xe) {
    const float dx = mx - xe;
    const float py = min_nan(max_nan(my + b * dx / cc, y0), y1);
    return q(dx, my - py);
  };
  const auto edge_y = [&](float ye) {
    const float dy = my - ye;
    const float px = min_nan(max_nan(mx + b * dy / ca, x0), x1);
    return q(mx - px, dy);
  };
  float pmax = max_nan(max_nan(edge_x(x0), edge_x(x1)), max_nan(edge_y(y0), edge_y(y1)));
  if (inside) pmax = 0.0f;
  return pmax >= thresh - (0.05f + 0.01f * fabsf(thresh));
}

// binning.depth_order_bits: f32 -> [0, 2^32) in the same order, -0.0 as +0.0
__device__ __forceinline__ int64_t depth_order_bits(float depth) {
  const int64_t bits = __float_as_int(depth + 0.0f);
  return bits < 0 ? -bits - 1 : bits + (int64_t{1} << 31);
}

// The key epilogue for slots s0 .. s0 + cnt - 1, whose ranks are row[] and
// whose table rows (0 for a rank out of range) are f[][].
template <bool VEC, bool CULL>
__device__ __forceinline__ void slot_keys(const float (&f)[SPT][NFIELD], const int64_t (&row)[SPT],
                                          int64_t s0, int cnt, int64_t n_rows, int64_t max_pairs,
                                          const SlotKeyArgs& k) {
  const int64_t lim = min(__ldg(k.total), max_pairs);
  int64_t local[SPT];
  if (VEC && cnt == SPT) {
    const longlong2 l01 = __ldg(reinterpret_cast<const longlong2*>(k.local + s0));
    const longlong2 l23 = __ldg(reinterpret_cast<const longlong2*>(k.local + s0) + 1);
    local[0] = l01.x;
    local[1] = l01.y;
    local[2] = l23.x;
    local[3] = l23.y;
  } else {
#pragma unroll
    for (int j = 0; j < SPT; ++j) local[j] = j < cnt ? __ldg(k.local + s0 + j) : 0;
  }
  int64_t key[SPT], tile[SPT], gc[SPT];
  float depth[SPT];
  float thresh = 0.0f;
  int64_t thresh_row = -1;
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    tile[j] = k.total_tiles;
    depth[j] = DEPTH_SENTINEL;
    gc[j] = n_rows;
    if (j < cnt && s0 + j < lim) {
      // the tile id (float32 arithmetic exact: values < 2^24)
      const float localf = static_cast<float>(local[j]);
      const float dy = floorf(localf / f[j][12]);
      const float dx = localf - dy * f[j][12];
      const float tcx = f[j][10] + dx;
      const float tcy = f[j][11] + dy;
      const int64_t t =
          static_cast<int64_t>(f[j][13] + tcy * static_cast<float>(k.tiles_x) + tcx);
      bool keep = true;
      if (CULL) {
        if (row[j] != thresh_row) {
          thresh = -logf(max_nan(255.0f * f[j][5], 1e-12f));
          thresh_row = row[j];
        }
        keep = tile_visible(f[j][0], f[j][1], f[j][2], f[j][3], f[j][4], tcx, tcy, thresh, k);
      }
      if (keep) {
        tile[j] = t;
        depth[j] = f[j][9];
        gc[j] = row[j];
      }
    }
    key[j] = (tile[j] << 32) | depth_order_bits(depth[j]);
  }
  if (VEC && cnt == SPT) {
    reinterpret_cast<longlong2*>(k.key + s0)[0] = make_longlong2(key[0], key[1]);
    reinterpret_cast<longlong2*>(k.key + s0)[1] = make_longlong2(key[2], key[3]);
    reinterpret_cast<longlong2*>(k.tile + s0)[0] = make_longlong2(tile[0], tile[1]);
    reinterpret_cast<longlong2*>(k.tile + s0)[1] = make_longlong2(tile[2], tile[3]);
    reinterpret_cast<longlong2*>(k.gc_sent + s0)[0] = make_longlong2(gc[0], gc[1]);
    reinterpret_cast<longlong2*>(k.gc_sent + s0)[1] = make_longlong2(gc[2], gc[3]);
    *reinterpret_cast<float4*>(k.depth_key + s0) = make_float4(depth[0], depth[1], depth[2],
                                                               depth[3]);
  } else {
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      if (j < cnt) {
        k.key[s0 + j] = key[j];
        k.tile[s0 + j] = tile[j];
        k.gc_sent[s0 + j] = gc[j];
        k.depth_key[s0 + j] = depth[j];
      }
    }
  }
}

template <bool VEC, bool CULL>
__global__ void __launch_bounds__(THREADS) broadcast_fields_kernel(
    const float4* __restrict__ ctable, const int32_t* __restrict__ gauss_c,
    float* __restrict__ out, int64_t n_rows, int64_t max_pairs, SlotKeyArgs keys) {
  const int64_t s0 = (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) * SPT;
  if (s0 >= max_pairs) return;
  const int cnt = static_cast<int>(min(static_cast<int64_t>(SPT), max_pairs - s0));
  int64_t row[SPT];
  bool ok[SPT];
  if (VEC && cnt == SPT) {
    const int4 g = __ldg(reinterpret_cast<const int4*>(gauss_c + s0));
    row[0] = g.x;
    row[1] = g.y;
    row[2] = g.z;
    row[3] = g.w;
  } else {
#pragma unroll
    for (int j = 0; j < SPT; ++j) row[j] = j < cnt ? __ldg(gauss_c + s0 + j) : -1;
  }
#pragma unroll
  for (int j = 0; j < SPT; ++j) ok[j] = row[j] >= 0 && row[j] < n_rows;

  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float* dst = out + s0;
  float f[SPT][NFIELD];   // the rows the key epilogue reads
#pragma unroll
  for (int q = 0; q < NFIELD / 4; ++q) {
    // fields 4q..4q+3 of the four slots; a row equal to the previous
    // slot's is not loaded again
    float4 v[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      if (!ok[j])
        v[j] = zero4;
      else if (j > 0 && ok[j - 1] && row[j] == row[j - 1])
        v[j] = v[j - 1];
      else
        v[j] = __ldg(ctable + row[j] * (NFIELD / 4) + q);
      f[j][4 * q] = v[j].x;
      f[j][4 * q + 1] = v[j].y;
      f[j][4 * q + 2] = v[j].z;
      f[j][4 * q + 3] = v[j].w;
    }
    const float4 o[4] = {make_float4(v[0].x, v[1].x, v[2].x, v[3].x),
                         make_float4(v[0].y, v[1].y, v[2].y, v[3].y),
                         make_float4(v[0].z, v[1].z, v[2].z, v[3].z),
                         make_float4(v[0].w, v[1].w, v[2].w, v[3].w)};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float* d = dst + static_cast<int64_t>(4 * q + c) * max_pairs;
      if (VEC && cnt == SPT) {
        *reinterpret_cast<float4*>(d) = o[c];
      } else {
        const float e[4] = {o[c].x, o[c].y, o[c].z, o[c].w};
#pragma unroll
        for (int j = 0; j < SPT; ++j)
          if (j < cnt) d[j] = e[j];
      }
    }
  }
  slot_keys<VEC, CULL>(f, row, s0, cnt, n_rows, max_pairs, keys);
}

template <bool CULL>
int launch(const void* ctable, const void* gauss_c, void* out, int64_t n_rows,
           int64_t max_pairs, const SlotKeyArgs& keys, bool vec, void* stream) {
  const int64_t threads = (max_pairs + SPT - 1) / SPT;
  const dim3 grid(static_cast<unsigned>((threads + THREADS - 1) / THREADS));
  auto kernel = vec ? broadcast_fields_kernel<true, CULL> : broadcast_fields_kernel<false, CULL>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(ctable), static_cast<const int32_t*>(gauss_c),
      static_cast<float*>(out), n_rows, max_pairs, keys);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" const char* deblurgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K3 and its key epilogue. ctable [n_rows, 16] f32 (16 B aligned), gauss_c
// [max_pairs] i32, out [16, max_pairs] f32 (16 B aligned), local
// [max_pairs] i64, total [] i64, and the outputs key, tile, gc_sent
// [max_pairs] i64 and depth_key [max_pairs] f32, all contiguous on one
// device; tile_w, tile_h, tiles_x and total_tiles of the stacked tile grid;
// cull selects the exact tile cull; launches on `stream`. Slots are read
// and written as 16 B vectors where max_pairs is a multiple of four and
// every per-slot array is 16 B aligned.
extern "C" int deblurgs_broadcast_fields_keys(const void* ctable, const void* gauss_c, void* out,
                                              int64_t n_rows, int64_t max_pairs,
                                              const void* local, const void* total, void* key,
                                              void* tile, void* gc_sent, void* depth_key,
                                              int tile_w, int tile_h, int tiles_x,
                                              int64_t total_tiles, int cull, void* stream) {
  if (!aligned16(ctable) || !aligned16(out) || tile_w <= 0 || tile_h <= 0 || tiles_x <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (max_pairs <= 0) return 0;
  const SlotKeyArgs keys{static_cast<const int64_t*>(local), static_cast<const int64_t*>(total),
                         static_cast<int64_t*>(key), static_cast<int64_t*>(tile),
                         static_cast<int64_t*>(gc_sent), static_cast<float*>(depth_key),
                         tile_w, tile_h, tiles_x, total_tiles};
  const bool vec = max_pairs % SPT == 0 && aligned16(gauss_c) && aligned16(local) &&
                   aligned16(key) && aligned16(tile) && aligned16(gc_sent) && aligned16(depth_key);
  return cull ? launch<true>(ctable, gauss_c, out, n_rows, max_pairs, keys, vec, stream)
              : launch<false>(ctable, gauss_c, out, n_rows, max_pairs, keys, vec, stream);
}
