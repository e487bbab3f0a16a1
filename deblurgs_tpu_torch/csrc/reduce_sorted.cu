// K4: deterministic segmented sum of the per-pair gradients by compact rank.
//
// Replaces deblurgs_tpu/ops/pallas_blend.py::_reduce_sorted (_reduce_kernel,
// pallas_blend.py:827-926) and the scatter of reduce_pair_grads
// (:929-948). There, after a sort by rank, each 128-slot chunk was routed
// into two adjacent 128-rank output blocks by one-hot matmuls on the MXU,
// accumulated in VMEM across the sequential grid. Here one warp sums one
// rank's run of slots:
//
//     out[row(r), f] = Σ_{k in [seg[r], seg[r+1])} grads[idx[k], f]   f < 10
//
// with grads slot-major [n_slots, 16] (K2's and K6's output rows, 64 B a
// slot). On the main path the runs need no sort: before the staging sort
// the slots already lie in runs by compact rank (ops/binning.py::
// expand_compact), so seg holds those runs and idx[k] is the sorted
// position of pre-sort slot k (the inverse of the staging sort's order);
// row(r) = ids[r], the Gaussian's original row, so the sum lands where the
// caller wants it and no scatter pass follows. Culled slots of a run sit in
// the zeroed tail of K2's output and add +0.0. For an arbitrary rank array
// the wrapper sorts, and then idx is the sort's permutation and row(r) = r.
//
// Lane l adds the run's slots l, l+32, ... in order, and the warp adds its
// lanes by a fixed reduce-scatter (common.cuh), so the sum order depends
// only on the run: two calls give bitwise-equal output, with no atomics. A
// rank with an empty run writes nothing (the output is zeroed by the
// wrapper), which also skips the padding ranks past the emitters.
//
// What bounds it: bytes. Per run slot 4 B of idx (coalesced) and its
// gradient row (three 16 B loads, 48 of the row's 64 B, two 32 B sectors);
// per rank 8 B of bounds, 4 B of id and 40 B of output.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NGRAD = 10;

__global__ void __launch_bounds__(THREADS) reduce_runs_kernel(
    const float4* __restrict__ grads, const int32_t* __restrict__ idx,
    const int32_t* __restrict__ seg, const int32_t* __restrict__ ids, int64_t n_ranks,
    float* __restrict__ out) {
  const int64_t r = (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= n_ranks) return;   // whole warps leave together
  const int lo = seg[r];
  const int hi = seg[r + 1];
  if (hi <= lo) return;
  float acc[NGRAD];
#pragma unroll
  for (int q = 0; q < NGRAD; ++q) acc[q] = 0.0f;
  for (int k = lo + lane; k < hi; k += 32) {
    const float4* row = grads + static_cast<int64_t>(idx[k]) * 4;
    const float4 a = row[0], b = row[1], c = row[2];
    acc[0] = acc[0] + a.x;
    acc[1] = acc[1] + a.y;
    acc[2] = acc[2] + a.z;
    acc[3] = acc[3] + a.w;
    acc[4] = acc[4] + b.x;
    acc[5] = acc[5] + b.y;
    acc[6] = acc[6] + b.z;
    acc[7] = acc[7] + b.w;
    acc[8] = acc[8] + c.x;
    acc[9] = acc[9] + c.y;
  }
  const float s = warp_reduce_scatter10(acc, lane);
  const int64_t row_out = ids != nullptr ? ids[r] : r;
  if (scatter10_writer(lane)) out[row_out * NFIELD + scatter10_index(lane)] = s;
}

}  // namespace

// grads [n_slots, 16] f32 (16 B aligned; columns 0-9 read); idx [*] i32 slot
// of each run position; seg [n_ranks + 1] i32 run bounds into idx; ids
// [n_ranks] i32 output row of each rank, or null for row r; out [*, 16] f32,
// zeroed by the caller: columns 0-9 of the rows of non-empty runs written.
extern "C" int deblurgs_reduce_sorted(const void* grads, const void* idx, const void* seg,
                                      const void* ids, int64_t n_ranks, void* out,
                                      void* stream) {
  if (n_ranks <= 0) return 0;
  const int64_t blocks = (n_ranks * 32 + THREADS - 1) / THREADS;
  reduce_runs_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(grads), static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(seg), static_cast<const int32_t*>(ids), n_ranks,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
