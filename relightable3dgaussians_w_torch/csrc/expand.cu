// Entry expansion: one sort key and one Gaussian id per (Gaussian, touched tile).
//
// Replaces the TPU kernel `_expand_kernel` of the JAX package
// (relightable3dgaussians_w_tpu/ops/pallas/expand.py), i.e. the reference's
// `duplicateWithKeys`. Plain version: ops/binning.py `expand_entries_plain`,
// which this kernel equals bitwise.
//
// What bounds it on an H100: bytes. Per slot it writes an 8-byte key and a
// 4-byte id, and per Gaussian it reads ~28 bytes; the integer work is a few
// adds per slot. The TPU kernel's monotone join over depth-ranked rows (a
// one-hot MXU matmul per 512 slots) exists because a TPU cannot scatter; here
// one thread per Gaussian writes its own contiguous run of slots at its offset,
// so there is no join at all and neighbouring threads write neighbouring runs.
// The row-major rect walk is two nested counters, no integer division.
//
// The same launch also fills the slots past the real entries (key INT64_MAX,
// id 0), reading the total from the last offset on the device, so the wrapper
// allocates with torch.empty and nothing syncs with the host. Slots at or past
// max_dup are dropped (the caller reports the overflow).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kKeyInvalid = 0x7FFFFFFFFFFFFFFFLL;  // INT64_MAX

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
      const int64_t w = rect_w[i];
      const int64_t rx = rect_min[2 * i];
      const int64_t ry = rect_min[2 * i + 1];
      const int64_t rk = rank[i];
      int64_t s = 0;
      for (int64_t q = 0; s < lim; ++q) {
        const int64_t row = (ry + q) * grid_x + rx;
        for (int64_t r = 0; r < w && s < lim; ++r, ++s) {
          keys[off + s] = ((row + r) << 32) | rk;
          gid[off + s] = (int32_t)i;
        }
      }
    }
  }
  if (i < max_dup) {
    const int64_t total = n > 0 ? offsets[n - 1] + counts[n - 1] : 0;
    if (i >= total) {
      keys[i] = kKeyInvalid;
      gid[i] = 0;
    }
  }
}

}  // namespace

extern "C" {

const char* r3dgw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// counts [n] i32, offsets [n] i64, rect_min [n, 2] i32, rect_w [n] i32, rank [n] i64
// -> keys [max_dup] i64, gid [max_dup] i32. Returns cudaGetLastError().
int r3dgw_expand_entries(const void* counts, const void* offsets, const void* rect_min,
                         const void* rect_w, const void* rank, int64_t n, int64_t grid_x,
                         int64_t max_dup, void* keys, void* gid, void* stream) {
  const int64_t work = n > max_dup ? n : max_dup;
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 0) {
    expand_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)counts, (const int64_t*)offsets, (const int32_t*)rect_min,
        (const int32_t*)rect_w, (const int64_t*)rank, n, grid_x, max_dup,
        (int64_t*)keys, (int32_t*)gid);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
