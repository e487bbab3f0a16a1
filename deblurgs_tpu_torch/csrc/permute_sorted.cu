// K7: the staging's sorted pair list, written in one pass after the sort.
//
// Replaces no Pallas kernel: it is the post-sort half of the JAX package's
// _sort_stage (deblurgs_tpu/ops/pallas_blend.py:344-361, the operands that
// lax.sort carries and the jnp.stack of `fields`), which XLA fuses on the
// TPU and which cuda_blend.permute_sorted_ref repeats in PyTorch as index
// gathers, int64 passes and a torch.cat over every slot. For each sorted
// position i, with o = order[i] and k = sorted_key[i] (torch.sort's
// indices and values of the packed (tile << 32) | depth-bits key):
//
//     s_tile[i]       = k >> 32          (the tile id, below 2^31: exact)
//     s_gc[i]         = gc_sent[o]
//     fields[0:9, i]  = fslot[0:9, o]    (K3's slot-space rows)
//     fields[9, i]    = depth_key[o]     (not decoded from the key, whose
//                                         bits hold -0.0 as +0.0)
//     fields[10, i]   = float(s_tile[i])
//     fields[11:13,i] = the per-image tile's origin (tx0, ty0): the tile id
//                       modulo num_tiles for stacked views only, as the
//                       plain version takes it, so a single view's
//                       sentinel rows keep their values
//     fields[13:16,i] = 0
//     inv[o]          = i
//
// Rows 0-9 of a kept slot (rank g = gc_sent[o] inside [0, n_rows)) are
// read from the compact table instead, ctable[g, 0:10]: the staging makes
// them equal bit for bit, since K3 copies fslot[:, o] = ctable[gauss_c[o]]
// and its key epilogue sets gc_sent[o] = gauss_c[o] and depth_key[o] =
// fslot[9, o] exactly where it keeps the slot. Every value is copied or
// computed as the plain version does (int64 to float32 rounds to nearest in
// both; the floor division and modulo follow torch's), so the outputs are
// bit for bit the plain version's.
//
// What bounds it: bytes. A slot reads 8 B of order and 8 B of key in
// order, and at o 8 B of rank and 40 B of rows (a kept slot: the table
// row), and writes 64 B of fields, 8 B of tile id, 8 B of rank and 4 B of
// inverse: 148 B, 5.9 ms at 2^27 slots on 3.35 TB/s. Design: one thread a
// run of four sorted positions loads their order and keys as 16 B vectors
// and writes each of the 16 field rows, the tile ids and the ranks as 16 B
// vectors, so a warp stores 512 contiguous bytes a row. The reads at o are
// scattered only for the kept slots: the culled and padding slots share one
// tile id (total_tiles) and the stable sort leaves them in ascending slot
// order, so there neighbouring threads read neighbouring slots of fslot.
// A kept slot, whose o is random, reads one 8 B rank and one 64 B table row
// (three 16 B loads, the row shared by the Gaussian's other pairs) rather
// than ten scattered 4 B values in ten arrays 512 MB apart: on an H100 at
// 2^27 slots with 47M kept, 10.1 ms against 17.8 for a version that read
// the ten values at o. Where max_pairs is not a multiple of four, or a
// pointer is not 16 B aligned, the same threads load and store scalars.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SPT = 4;        // consecutive sorted positions a thread
constexpr int NROW = 10;      // rows 0-9 read at o (fslot and depth, or the table)

struct PermuteArgs {
  const float4* ctable;       // [n_rows, 16] compact table (16 B aligned)
  const float* fslot;         // [16, max_pairs] slot-space rows
  const float* depth_key;     // [max_pairs] depth; the sentinel where not kept
  const int64_t* gc_sent;     // [max_pairs] compact rank; n_rows where not kept
  const int64_t* sorted_key;  // [max_pairs] the sort's values
  const int64_t* order;       // [max_pairs] the sort's indices
  float* fields;              // [16, max_pairs]
  int64_t* s_tile;            // [max_pairs]
  int64_t* s_gc;              // [max_pairs]
  int32_t* inv;               // [max_pairs]
  int64_t n_rows, max_pairs;
  int num_tiles, tiles_x, tile_w, tile_h;
  bool per_image;             // stacked views: the tile id modulo num_tiles
};

// torch's // on integers: floor division (b > 0 here)
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS) permute_sorted_kernel(PermuteArgs p) {
  const int64_t i0 = (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) * SPT;
  if (i0 >= p.max_pairs) return;
  const int cnt = static_cast<int>(min(static_cast<int64_t>(SPT), p.max_pairs - i0));
  int64_t o[SPT], k[SPT];
  if (VEC && cnt == SPT) {
    const longlong2 o01 = __ldg(reinterpret_cast<const longlong2*>(p.order + i0));
    const longlong2 o23 = __ldg(reinterpret_cast<const longlong2*>(p.order + i0) + 1);
    const longlong2 k01 = __ldg(reinterpret_cast<const longlong2*>(p.sorted_key + i0));
    const longlong2 k23 = __ldg(reinterpret_cast<const longlong2*>(p.sorted_key + i0) + 1);
    o[0] = o01.x;
    o[1] = o01.y;
    o[2] = o23.x;
    o[3] = o23.y;
    k[0] = k01.x;
    k[1] = k01.y;
    k[2] = k23.x;
    k[3] = k23.y;
  } else {
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      o[j] = j < cnt ? __ldg(p.order + i0 + j) : 0;
      k[j] = j < cnt ? __ldg(p.sorted_key + i0 + j) : 0;
    }
  }

  // the ranks at o, then rows 0-9: the table row of a kept slot, else
  // fslot's rows and the depth key at o
  int64_t gc[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) gc[j] = j < cnt ? __ldg(p.gc_sent + o[j]) : p.n_rows;
  float v[SPT][NROW];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    if (gc[j] >= 0 && gc[j] < p.n_rows) {
      const float4* row = p.ctable + gc[j] * (NFIELD / 4);
      const float4 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2);
      v[j][0] = a.x;
      v[j][1] = a.y;
      v[j][2] = a.z;
      v[j][3] = a.w;
      v[j][4] = b.x;
      v[j][5] = b.y;
      v[j][6] = b.z;
      v[j][7] = b.w;
      v[j][8] = c.x;
      v[j][9] = c.y;
    } else if (j < cnt) {
#pragma unroll
      for (int f = 0; f < NROW - 1; ++f) v[j][f] = __ldg(p.fslot + f * p.max_pairs + o[j]);
      v[j][NROW - 1] = __ldg(p.depth_key + o[j]);
    } else {
#pragma unroll
      for (int f = 0; f < NROW; ++f) v[j][f] = 0.0f;
    }
  }
#pragma unroll
  for (int j = 0; j < SPT; ++j)
    if (j < cnt) p.inv[o[j]] = static_cast<int32_t>(i0 + j);

  // rows 10-12 from the tile id
  int64_t tile[SPT];
  float r10[SPT], r11[SPT], r12[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    tile[j] = k[j] >> 32;
    const int t = static_cast<int>(tile[j]);   // exact: k >> 32 lies in int32
    const int ti = p.per_image ? t - floor_div(t, p.num_tiles) * p.num_tiles : t;
    const int tyi = floor_div(ti, p.tiles_x);
    r10[j] = static_cast<float>(tile[j]);
    r11[j] = static_cast<float>(static_cast<int64_t>(ti - tyi * p.tiles_x) * p.tile_w);
    r12[j] = static_cast<float>(static_cast<int64_t>(tyi) * p.tile_h);
  }

  float* dst = p.fields + i0;
  const auto store_row = [&](int row, float a, float b, float c, float d) {
    float* r = dst + static_cast<int64_t>(row) * p.max_pairs;
    if (VEC && cnt == SPT) {
      *reinterpret_cast<float4*>(r) = make_float4(a, b, c, d);
    } else {
      const float e[SPT] = {a, b, c, d};
#pragma unroll
      for (int j = 0; j < SPT; ++j)
        if (j < cnt) r[j] = e[j];
    }
  };
#pragma unroll
  for (int f = 0; f < NROW; ++f) store_row(f, v[0][f], v[1][f], v[2][f], v[3][f]);
  store_row(10, r10[0], r10[1], r10[2], r10[3]);
  store_row(11, r11[0], r11[1], r11[2], r11[3]);
  store_row(12, r12[0], r12[1], r12[2], r12[3]);
#pragma unroll
  for (int f = 13; f < NFIELD; ++f) store_row(f, 0.0f, 0.0f, 0.0f, 0.0f);

  if (VEC && cnt == SPT) {
    reinterpret_cast<longlong2*>(p.s_tile + i0)[0] = make_longlong2(tile[0], tile[1]);
    reinterpret_cast<longlong2*>(p.s_tile + i0)[1] = make_longlong2(tile[2], tile[3]);
    reinterpret_cast<longlong2*>(p.s_gc + i0)[0] = make_longlong2(gc[0], gc[1]);
    reinterpret_cast<longlong2*>(p.s_gc + i0)[1] = make_longlong2(gc[2], gc[3]);
  } else {
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      if (j < cnt) {
        p.s_tile[i0 + j] = tile[j];
        p.s_gc[i0 + j] = gc[j];
      }
    }
  }
}

bool aligned16(const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; }

}  // namespace

// K7. ctable [n_rows, 16] f32 (16 B aligned), fslot [16, max_pairs] f32,
// depth_key [max_pairs] f32, gc_sent, sorted_key and order [max_pairs] i64
// (order a permutation of [0, max_pairs)), and the outputs fields
// [16, max_pairs] f32, s_tile and s_gc [max_pairs] i64 and inv [max_pairs]
// i32, all contiguous on one device, as the staging makes them (K3's rows
// and keys of that table); num_tiles, tiles_x, tile_w and tile_h of one
// view's tile grid; per_image for stacked views; launches on `stream`.
// Slots are read and written as 16 B vectors where max_pairs is a multiple
// of four and every array that is read or written in order is 16 B aligned.
extern "C" int deblurgs_permute_sorted(const void* ctable, int64_t n_rows, const void* fslot,
                                       const void* depth_key, const void* gc_sent,
                                       const void* sorted_key, const void* order, void* fields,
                                       void* s_tile, void* s_gc, void* inv, int64_t max_pairs,
                                       int num_tiles, int tiles_x, int tile_w, int tile_h,
                                       int per_image, void* stream) {
  if (!aligned16(ctable) || num_tiles <= 0 || tiles_x <= 0 || tile_w <= 0 || tile_h <= 0 ||
      max_pairs >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (max_pairs <= 0) return 0;
  const PermuteArgs p{static_cast<const float4*>(ctable), static_cast<const float*>(fslot),
                      static_cast<const float*>(depth_key), static_cast<const int64_t*>(gc_sent),
                      static_cast<const int64_t*>(sorted_key), static_cast<const int64_t*>(order),
                      static_cast<float*>(fields), static_cast<int64_t*>(s_tile),
                      static_cast<int64_t*>(s_gc), static_cast<int32_t*>(inv), n_rows, max_pairs,
                      num_tiles, tiles_x, tile_w, tile_h, per_image != 0};
  const bool vec = max_pairs % SPT == 0 && aligned16(sorted_key) && aligned16(order) &&
                   aligned16(fields) && aligned16(s_tile) && aligned16(s_gc);
  const int64_t threads = (max_pairs + SPT - 1) / SPT;
  const dim3 grid(static_cast<unsigned>((threads + THREADS - 1) / THREADS));
  auto kernel = vec ? permute_sorted_kernel<true> : permute_sorted_kernel<false>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
