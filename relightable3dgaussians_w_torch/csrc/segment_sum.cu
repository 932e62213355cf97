// Segment sum of entry gradient rows into Gaussian rows: the transpose of the
// rasterizer's entry gather.
//
// Replaces the TPU kernel `_kernel` of the JAX package
// (relightable3dgaussians_w_tpu/ops/pallas/segment_sum.py), the VJP of
// `gather_rows_t`, and the reference's atomicAdd accumulation of the same
// gradients (backward.cu). Plain version: ops/segment_sum.py
// `segment_sum_rows_plain` (index_add_).
//
// What bounds it on an H100: bytes. Every entry row (F = 6 + C floats) is read
// once and every Gaussian row written once; there is one add per entry value.
// Design: the wrapper sorts the entry ids once (stable) and finds each
// Gaussian's range of sorted entries with a binary search. One warp per
// Gaussian then sums its entries' rows in ascending sorted order, lane f
// holding feature f, and writes the Gaussian's row once. No atomics: the order
// of every sum is fixed, so two runs give the same bits. A row is read through
// the sort permutation (a gather of F contiguous floats, coalesced across the
// lanes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps (Gaussians) per block

__global__ void __launch_bounds__(kWarps * 32) segment_sum_kernel(
    const float* __restrict__ rows, int F, const int64_t* __restrict__ perm,
    const int64_t* __restrict__ bounds, int64_t n_seg, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t seg = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (seg >= n_seg) return;
  const int64_t lo = bounds[seg];
  const int64_t hi = bounds[seg + 1];
  for (int f = lane; f < F; f += 32) {
    float acc = 0.f;
    for (int64_t e = lo; e < hi; ++e) acc += rows[perm[e] * F + f];
    out[seg * F + f] = acc;
  }
}

}  // namespace

extern "C" {

const char* r3dgw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// rows [*, F] f32; perm [D] i64 (sorted position -> row); bounds [n_seg + 1] i64
// (segment s owns sorted positions bounds[s] .. bounds[s + 1]; positions past
// bounds[n_seg] belong to no segment) -> out [n_seg, F].
// Returns cudaGetLastError().
int r3dgw_segment_sum(const void* rows, int F, const void* perm, const void* bounds,
                      int64_t n_seg, void* out, void* stream) {
  if (F < 1 || n_seg < 0) return (int)cudaErrorInvalidValue;
  if (n_seg == 0) return 0;
  const int64_t blocks = (n_seg + kWarps - 1) / kWarps;
  segment_sum_kernel<<<(unsigned)blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)rows, F, (const int64_t*)perm, (const int64_t*)bounds, n_seg,
      (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
