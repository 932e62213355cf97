// Segment sum of entry gradient rows into Gaussian rows: the transpose of the
// rasterizer's entry gather.
//
// Replaces the TPU kernel `_kernel` of the JAX package
// (relightable3dgaussians_w_tpu/ops/pallas/segment_sum.py), the VJP of
// `gather_rows_t`, and the reference's atomicAdd accumulation of the same
// gradients (backward.cu). Plain version: ops/segment_sum.py
// `segment_sum_rows_plain` (index_add_).
//
// The kernel sums a segment layout: segment s owns the positions
// bounds[s] .. bounds[s + 1], and position p holds row order[p]. It has two
// callers. The rasterizer's gather (ops/segment_sum.py `gather_rows`) passes
// the binning's own layout: Gaussian g's pre-sort entry slots are the run
// offsets[g] .. offsets[g] + counts[g] (clamped to the budget), and order is
// the sort's inverse permutation, the sorted position of each slot; so no
// sort and no search runs in the backward. The general entry
// (`segment_sum_rows(rows, ids, n)`) builds the same layout by sorting the ids.
// Within a Gaussian both layouts list its entries in ascending sorted position
// (its slots walk the tiles in ascending order and share one depth rank), so
// the two callers sum in the same order and give the same bits.
//
// What bounds it on an H100: bytes. Every real entry's row (F = 6 + C floats)
// and order index are read once and every Gaussian row is written once; there
// is one add per entry value. In the trainer's pool most Gaussian rows have
// no entry, and their zeros are most of the bytes.
// Design: a block owns 128 consecutive segments. If none of them has an entry
// (bounds equal at both ends), the block writes its 128 * F zeros as float4
// stores. Otherwise thread i of the block sums value i of the block's
// [128, F] output, (segment i / F, feature i % F): all 32 lanes are busy at
// any F, and the warp's stores cover 128 contiguous bytes. Each sum walks its
// entries in ascending position, 8 at a time: the 8 order indices are loaded
// together, then the 8 row values, while the next 8 order indices are
// already in flight, so a batch costs one memory latency, not two per entry.
// No atomics: every sum has a fixed order, so two runs give the same bits.
//
// permute_kernel builds the gather's side of that layout in the binning, in
// place of PyTorch's gather gid[perm] and a scatter of the inverse
// permutation over the whole budget: after the stable sort, the unused slots
// (key INT64_MAX, the last max_dup - total of them) keep their places, so
// only the real entries' positions are read and scattered; the rest are
// written as coalesced constants. Bounded by bytes: 12 per real entry
// (perm, gid) and 8 per budget slot (gauss_id, slot_pos).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSegs = 128;  // segments per block; a multiple of 4 (float4 zero stores)
constexpr int kBatch = 8;   // entries of one sum whose loads are in flight together

__global__ void __launch_bounds__(kThreads) segment_sum_kernel(
    const float* __restrict__ rows, int F, const int32_t* __restrict__ order,
    const int64_t* __restrict__ bounds, int64_t n_seg, float* __restrict__ out) {
  __shared__ int64_t lo[kSegs + 1];
  const int64_t s0 = (int64_t)blockIdx.x * kSegs;
  const int segs = (int)(n_seg - s0 < kSegs ? n_seg - s0 : kSegs);
  const int vals = segs * F;
  float* __restrict__ dst = out + s0 * F;
  if (bounds[s0] == bounds[s0 + segs]) {
    // No entry in the block: s0 * F floats is a multiple of 4, so dst is 16-byte
    // aligned when out is.
    const int v4 = vals >> 2;
    for (int i = threadIdx.x; i < v4; i += kThreads)
      reinterpret_cast<float4*>(dst)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = (v4 << 2) + threadIdx.x; i < vals; i += kThreads) dst[i] = 0.f;
    return;
  }
  for (int i = threadIdx.x; i <= segs; i += kThreads) lo[i] = bounds[s0 + i];
  __syncthreads();
  for (int i = threadIdx.x; i < vals; i += kThreads) {
    const int s = i / F;
    const int f = i - s * F;
    const int64_t end = lo[s + 1];
    int64_t e = lo[s];
    float acc = 0.f;
    int32_t idx[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) idx[j] = e + j < end ? __ldg(order + e + j) : 0;
    while (e < end) {
      float v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        v[j] = e + j < end ? __ldg(rows + (int64_t)idx[j] * F + f) : 0.f;
      const int64_t next = e + kBatch;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) idx[j] = next + j < end ? __ldg(order + next + j) : 0;
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (e + j < end) acc += v[j];
      e = next;
    }
    dst[i] = acc;
  }
}

// gauss_id[p] = gid[perm[p]] and slot_pos[perm[p]] = p for the n_sorted
// positions of a stable sort of the expansion's keys; positions past the
// real entries hold unused slots in slot order (perm[p] = p, gid 0).
__global__ void __launch_bounds__(kThreads) permute_kernel(
    const int64_t* __restrict__ perm, const int32_t* __restrict__ gid,
    const int64_t* __restrict__ num_entries, int64_t n_sorted, int32_t* __restrict__ gauss_id,
    int32_t* __restrict__ slot_pos) {
  const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (p >= n_sorted) return;
  const int64_t real = *num_entries < n_sorted ? *num_entries : n_sorted;
  if (p < real) {
    const int64_t s = __ldg(perm + p);
    gauss_id[p] = __ldg(gid + s);
    slot_pos[s] = (int32_t)p;
  } else {
    gauss_id[p] = 0;
    slot_pos[p] = (int32_t)p;
  }
}

}  // namespace

extern "C" {

const char* r3dgw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// rows [*, F] f32; order [*] i32 (position -> row); bounds [n_seg + 1] i64,
// non-decreasing (segment s owns positions bounds[s] .. bounds[s + 1]; other
// positions belong to no segment) -> out [n_seg, F], 16-byte aligned.
// Returns cudaGetLastError().
int r3dgw_segment_sum_ordered(const void* rows, int F, const void* order, const void* bounds,
                              int64_t n_seg, void* out, void* stream) {
  if (F < 1 || n_seg < 0 || ((uintptr_t)out & 15) != 0) return (int)cudaErrorInvalidValue;
  if (n_seg == 0) return 0;
  const int64_t blocks = (n_seg + kSegs - 1) / kSegs;
  segment_sum_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rows, F, (const int32_t*)order, (const int64_t*)bounds, n_seg,
      (float*)out);
  return (int)cudaGetLastError();
}

// perm [n] i64 (a stable sort's permutation of the expansion's keys), gid [n]
// i32 (the expansion's ids), num_entries [] i64 (entries before the budget
// clamp) -> gauss_id [n] i32, slot_pos [n] i32. Returns cudaGetLastError().
int r3dgw_permute_entries(const void* perm, const void* gid, const void* num_entries,
                          int64_t n, void* gauss_id, void* slot_pos, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  permute_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                   (cudaStream_t)stream>>>(
      (const int64_t*)perm, (const int32_t*)gid, (const int64_t*)num_entries, n,
      (int32_t*)gauss_id, (int32_t*)slot_pos);
  return (int)cudaGetLastError();
}

}  // extern "C"
