// Entry expansion: one sort key and one Gaussian id per (Gaussian, touched tile).
//
// Replaces the TPU kernel `_expand_kernel` of the JAX package
// (relightable3dgaussians_w_tpu/ops/pallas/expand.py), i.e. the reference's
// `duplicateWithKeys`, in both of its branches:
//   expand_kernel            the rect walk (intervals=False);
//   expand_intervals_kernel  the row-interval walk (intervals=True): the first
//                            8 tile rows of a Gaussian's rect emit w_j tiles
//                            from column rect_x0 + txl_rel_j, the rows below
//                            them the full rect width.
// Plain version: ops/binning.py `expand_entries_plain`, which both kernels
// equal bitwise.
//
// What bounds them on an H100: bytes. Per slot they write an 8-byte key and a
// 4-byte id; per Gaussian they read ~32 bytes (+32 bytes of packed interval
// rows); the integer work is a few adds per slot. The TPU kernel's monotone
// join over depth-ranked rows (a one-hot MXU matmul per 512 slots) exists
// because a TPU cannot scatter; here one thread per Gaussian writes its own
// contiguous run of slots at its offset, so there is no join at all and
// neighbouring threads write neighbouring runs. The walks are nested counters:
// no integer division (the packed row is split with a shift and a mask).
//
// The same launch also fills the slots past the real entries (key INT64_MAX,
// id 0), reading the total from the last offset on the device, so the wrapper
// allocates with torch.empty and nothing syncs with the host. Slots at or past
// max_dup are dropped (the caller reports the overflow).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowCap = 8;                             // preprocess.H_CAP
constexpr int64_t kKeyInvalid = 0x7FFFFFFFFFFFFFFFLL;  // INT64_MAX

// Slots past the last real entry: key INT64_MAX, id 0.
__device__ __forceinline__ void fill_unused(int64_t i, const int32_t* __restrict__ counts,
                                            const int64_t* __restrict__ offsets, int64_t n,
                                            int64_t max_dup, int64_t* __restrict__ keys,
                                            int32_t* __restrict__ gid) {
  if (i < max_dup) {
    const int64_t total = n > 0 ? offsets[n - 1] + counts[n - 1] : 0;
    if (i >= total) {
      keys[i] = kKeyInvalid;
      gid[i] = 0;
    }
  }
}

// Rows of full width `w` from tile row ry + q0 on, until `lim` slots are written.
__device__ __forceinline__ void walk_rect(int64_t q0, int64_t& s, int64_t lim, int64_t w,
                                          int64_t rx, int64_t ry, int64_t rk, int64_t grid_x,
                                          int64_t off, int32_t id, int64_t* __restrict__ keys,
                                          int32_t* __restrict__ gid) {
  for (int64_t q = q0; s < lim; ++q) {
    const int64_t row = (ry + q) * grid_x + rx;
    for (int64_t r = 0; r < w && s < lim; ++r, ++s) {
      keys[off + s] = ((row + r) << 32) | rk;
      gid[off + s] = id;
    }
  }
}

__global__ void __launch_bounds__(kThreads) expand_kernel(
    const int32_t* __restrict__ counts, const int64_t* __restrict__ offsets,
    const int32_t* __restrict__ rect_min, const int32_t* __restrict__ rect_w,
    const int64_t* __restrict__ rank, int64_t n, int64_t grid_x, int64_t max_dup,
    int64_t* __restrict__ keys, int32_t* __restrict__ gid) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) {
    const int64_t off = offsets[i];
    const int64_t room = max_dup - off;
    const int64_t lim = counts[i] < room ? (int64_t)counts[i] : room;
    if (lim > 0) {
      int64_t s = 0;
      walk_rect(0, s, lim, rect_w[i], rect_min[2 * i], rect_min[2 * i + 1], rank[i], grid_x,
                off, (int32_t)i, keys, gid);
    }
  }
  fill_unused(i, counts, offsets, n, max_dup, keys, gid);
}

// packed [kRowCap, n]: txl_rel + 128 * w_j of tile row j of Gaussian i (0 for an
// empty row); counts[i] = sum_j w_j + max(h - kRowCap, 0) * rect_w (0 if culled).
__global__ void __launch_bounds__(kThreads) expand_intervals_kernel(
    const int32_t* __restrict__ counts, const int64_t* __restrict__ offsets,
    const int32_t* __restrict__ rect_min, const int32_t* __restrict__ rect_w,
    const int64_t* __restrict__ rank, const int32_t* __restrict__ packed, int64_t n,
    int64_t grid_x, int64_t max_dup, int64_t* __restrict__ keys, int32_t* __restrict__ gid) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) {
    const int64_t off = offsets[i];
    const int64_t room = max_dup - off;
    const int64_t lim = counts[i] < room ? (int64_t)counts[i] : room;
    if (lim > 0) {
      const int64_t rx = rect_min[2 * i];
      const int64_t ry = rect_min[2 * i + 1];
      const int64_t rk = rank[i];
      int64_t s = 0;
      for (int j = 0; j < kRowCap && s < lim; ++j) {
        const int32_t p = packed[(int64_t)j * n + i];   // coalesced across threads
        const int64_t wj = p >> 7;
        const int64_t row = (ry + j) * grid_x + rx + (p & 127);
        for (int64_t r = 0; r < wj && s < lim; ++r, ++s) {
          keys[off + s] = ((row + r) << 32) | rk;
          gid[off + s] = (int32_t)i;
        }
      }
      walk_rect(kRowCap, s, lim, rect_w[i], rx, ry, rk, grid_x, off, (int32_t)i, keys, gid);
    }
  }
  fill_unused(i, counts, offsets, n, max_dup, keys, gid);
}

unsigned grid_for(int64_t n, int64_t max_dup) {
  const int64_t work = n > max_dup ? n : max_dup;
  return (unsigned)((work + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

const char* r3dgw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// counts [n] i32, offsets [n] i64, rect_min [n, 2] i32, rect_w [n] i32, rank [n] i64
// -> keys [max_dup] i64, gid [max_dup] i32. Returns cudaGetLastError().
int r3dgw_expand_entries(const void* counts, const void* offsets, const void* rect_min,
                         const void* rect_w, const void* rank, int64_t n, int64_t grid_x,
                         int64_t max_dup, void* keys, void* gid, void* stream) {
  const unsigned blocks = grid_for(n, max_dup);
  if (blocks > 0) {
    expand_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)counts, (const int64_t*)offsets, (const int32_t*)rect_min,
        (const int32_t*)rect_w, (const int64_t*)rank, n, grid_x, max_dup,
        (int64_t*)keys, (int32_t*)gid);
  }
  return (int)cudaGetLastError();
}

// As r3dgw_expand_entries, with packed [8, n] i32 per-row intervals.
int r3dgw_expand_entries_intervals(const void* counts, const void* offsets,
                                   const void* rect_min, const void* rect_w, const void* rank,
                                   const void* packed, int64_t n, int64_t grid_x,
                                   int64_t max_dup, void* keys, void* gid, void* stream) {
  const unsigned blocks = grid_for(n, max_dup);
  if (blocks > 0) {
    expand_intervals_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)counts, (const int64_t*)offsets, (const int32_t*)rect_min,
        (const int32_t*)rect_w, (const int64_t*)rank, (const int32_t*)packed, n, grid_x,
        max_dup, (int64_t*)keys, (int32_t*)gid);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
