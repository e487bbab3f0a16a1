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
// (pallas_blend.py:187-196). The function moves bytes and does no arithmetic: it is bound by
// the 64 B it writes a slot (plus 4 B of gauss_c and the [P, 16] table read
// once). Values are copied bit for bit, so the result equals
// ctable[gauss_c].T exactly.
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

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SPT = 4;   // consecutive slots a thread

template <bool VEC>
__global__ void __launch_bounds__(THREADS) broadcast_fields_kernel(
    const float4* __restrict__ ctable, const int32_t* __restrict__ gauss_c,
    float* __restrict__ out, int64_t n_rows, int64_t max_pairs) {
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
}

}  // namespace

extern "C" const char* deblurgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// ctable [n_rows, 16] f32 (16 B aligned), gauss_c [max_pairs] i32, out
// [16, max_pairs] f32 (16 B aligned), all contiguous on one device;
// launches on `stream`. gauss_c is read as 16 B vectors where it is 16 B
// aligned and max_pairs is a multiple of four.
extern "C" int deblurgs_broadcast_fields(const void* ctable, const void* gauss_c, void* out,
                                         int64_t n_rows, int64_t max_pairs, void* stream) {
  if ((reinterpret_cast<uintptr_t>(ctable) | reinterpret_cast<uintptr_t>(out)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (max_pairs <= 0) return 0;
  const int64_t threads = (max_pairs + SPT - 1) / SPT;
  const dim3 grid(static_cast<unsigned>((threads + THREADS - 1) / THREADS));
  const bool vec = max_pairs % SPT == 0 && reinterpret_cast<uintptr_t>(gauss_c) % 16 == 0;
  auto kernel = vec ? broadcast_fields_kernel<true> : broadcast_fields_kernel<false>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(ctable), static_cast<const int32_t*>(gauss_c),
      static_cast<float*>(out), n_rows, max_pairs);
  return static_cast<int>(cudaGetLastError());
}
