// K4: deterministic segmented sum of the per-pair gradients by compact rank.
//
// Replaces deblurgs_tpu/ops/pallas_blend.py::_reduce_sorted (_reduce_kernel,
// pallas_blend.py:827-926). There, after a sort by rank, each 128-slot chunk
// was routed into two adjacent 128-rank output blocks by one-hot matmuls on
// the MXU, accumulated in VMEM across the sequential grid. Here the sort is
// the wrapper's (a stable sort of the ranks, so each rank's slots form one
// run, in slot order) and the kernel is one warp per rank:
//
//     out[r, f] = Σ_{k in [seg[r], seg[r+1])} grads[f, perm[k]]   f < 10
//     out[r, f] = 0                                                f >= 10
//
// Lane l adds the run's slots l, l+32, ... in order, and the warp adds its
// lanes by a fixed shuffle tree, so the sum order depends only on the run:
// two calls give bitwise-equal output, with no atomics. Sentinel slots (rank
// P: culled, overflow, padding) sort after every real rank and are never
// read.
//
// What bounds it: bytes. Each kept slot's 10 gradients are read once (40 B,
// gathered through perm, so each read touches its own 32 B sector), plus 4 B
// of perm per slot, 4 B of bounds and 64 B of output per rank.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NGRAD = 10;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS) reduce_sorted_kernel(
    const float* __restrict__ grads, int64_t max_pairs, const int32_t* __restrict__ perm,
    const int32_t* __restrict__ seg, int64_t n_ranks, float* __restrict__ out) {
  const int64_t r = (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= n_ranks) return;   // whole warps leave together
  const int lo = seg[r];
  const int hi = seg[r + 1];
  float acc[NGRAD];
#pragma unroll
  for (int q = 0; q < NGRAD; ++q) acc[q] = 0.0f;
  for (int k = lo + lane; k < hi; k += 32) {
    const int64_t j = perm[k];
#pragma unroll
    for (int q = 0; q < NGRAD; ++q) acc[q] = acc[q] + grads[q * max_pairs + j];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int q = 0; q < NGRAD; ++q) acc[q] = acc[q] + __shfl_down_sync(FULL, acc[q], off);
  }
  // lane 0 holds the sums; lanes 0-15 write the row's 16 columns
  float v = 0.0f;
#pragma unroll
  for (int q = 0; q < NGRAD; ++q) {
    const float s = __shfl_sync(FULL, acc[q], 0);
    if (lane == q) v = s;
  }
  if (lane < NFIELD) out[r * NFIELD + lane] = v;
}

}  // namespace

// grads [16, max_pairs] f32 (rows 0-9 read); perm [n] i32 slot indices in
// rank order; seg [n_ranks + 1] i32 run bounds into perm; out [n_ranks, 16]
// f32, every element written.
extern "C" int deblurgs_reduce_sorted(const void* grads, int64_t max_pairs, const void* perm,
                                      const void* seg, int64_t n_ranks, void* out,
                                      void* stream) {
  if (n_ranks <= 0) return 0;
  const int64_t blocks = (n_ranks * 32 + THREADS - 1) / THREADS;
  reduce_sorted_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grads), max_pairs, static_cast<const int32_t*>(perm),
      static_cast<const int32_t*>(seg), n_ranks, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
