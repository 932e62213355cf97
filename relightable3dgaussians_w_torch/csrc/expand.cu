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
// rows); the integer work is a few operations per slot. The TPU kernel's
// monotone join over depth-ranked rows (a one-hot MXU matmul per 512 slots)
// exists because a TPU cannot scatter; here no join is needed.
//
// expand_kernel is slot-parallel, a load-balancing search: Gaussians (keyed by
// their offset) and slots (keyed by their index) are merged, Gaussian g before
// slot s iff offsets[g] <= s, and each block takes 1024 consecutive items of
// that merge. A warp finds each end of the block's range with one 32-way
// search over offsets; the block stages the Gaussians of its range (plus the
// one whose run enters it) in shared memory, and thread t writes the slots
// t, t + 256, ... of the range: a warp's key stores cover 256 contiguous bytes
// and its id stores 128. A slot's Gaussian is a binary search of the staged
// offsets, its row and column in the rect one integer division. Every block
// does the same amount of work whatever the counts are (0 for a culled
// Gaussian, hundreds of tiles for a large rect).
// expand_intervals_kernel keeps one thread per Gaussian, which writes its own
// contiguous run of slots at its offset; its walks are nested counters (the
// packed row is split with a shift and a mask).
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

constexpr int kItems = 1024;  // merge items (Gaussians and slots) per block of expand_kernel

// The number of Gaussians among the first d items of the merge of n Gaussians
// and `slots` slots: the least g in [max(0, d - slots), min(d, n)] with
// offsets[g] + g >= d (offsets[g] + g rises strictly with g). All 32 lanes of
// the warp call it and get the answer: each round probes 32 points at once,
// so 10^6 Gaussians take 4 rounds of dependent loads.
__device__ __forceinline__ int64_t merge_split(const int64_t* __restrict__ offsets, int64_t n,
                                               int64_t slots, int64_t d) {
  const int lane = threadIdx.x & 31;
  int64_t lo = d - slots > 0 ? d - slots : 0;
  int64_t hi = d < n ? d : n;  // the answer lies in [lo, hi]; hi if no g in [lo, hi) holds
  while (hi - lo > 32) {
    const int64_t step = (hi - lo) / 32;
    const int64_t p = lo + (int64_t)(lane + 1) * step;  // in (lo, hi]
    const unsigned m = __ballot_sync(0xffffffffu, p >= hi || offsets[p] + p >= d);
    if (m == 0) {
      lo += 32 * step + 1;
    } else {
      const int f = __ffs(m) - 1;
      hi = lo + (int64_t)(f + 1) * step;
      if (f > 0) lo += (int64_t)f * step + 1;
    }
  }
  const int64_t p = lo + lane;
  const unsigned m = __ballot_sync(0xffffffffu, p < hi && offsets[p] + p >= d);
  return m ? lo + __ffs(m) - 1 : hi;
}

__global__ void __launch_bounds__(kThreads) expand_kernel(
    const int32_t* __restrict__ counts, const int64_t* __restrict__ offsets,
    const int32_t* __restrict__ rect_min, const int32_t* __restrict__ rect_w,
    const int64_t* __restrict__ rank, int64_t n, int64_t grid_x, int64_t max_dup,
    int64_t* __restrict__ keys, int32_t* __restrict__ gid) {
  __shared__ int64_t s_off[kItems + 1];
  __shared__ int64_t s_rank[kItems + 1];
  __shared__ int32_t s_x[kItems + 1], s_y[kItems + 1], s_w[kItems + 1];
  __shared__ int64_t s_split[2];
  const int64_t total = n > 0 ? offsets[n - 1] + counts[n - 1] : 0;
  const int64_t slots = total < max_dup ? total : max_dup;  // slots that get an entry
  const int64_t merged = n + slots;
  const int64_t d0 = (int64_t)blockIdx.x * kItems;
  const int64_t d1 = d0 + kItems < merged ? d0 + kItems : merged;
  if (d0 < merged) {
    const int warp = threadIdx.x >> 5;
    if (warp < 2) {
      const int64_t g = merge_split(offsets, n, slots, warp == 0 ? d0 : d1);
      if ((threadIdx.x & 31) == 0) s_split[warp] = g;
    }
    __syncthreads();
    const int64_t g0 = s_split[0], g1 = s_split[1];
    const int64_t sl0 = d0 - g0, sl1 = d1 - g1;  // the block's slots
    if (sl1 > sl0) {
      // Gaussian g0 - 1 precedes slot sl0, so its run may enter the block.
      const int64_t gs = g0 > 0 ? g0 - 1 : 0;
      const int m = (int)(g1 - gs);
      for (int k = threadIdx.x; k < m; k += kThreads) {
        const int64_t g = gs + k;
        s_off[k] = offsets[g];
        s_rank[k] = rank[g];
        s_x[k] = rect_min[2 * g];
        s_y[k] = rect_min[2 * g + 1];
        s_w[k] = rect_w[g];
      }
      __syncthreads();
      for (int64_t s = sl0 + threadIdx.x; s < sl1; s += kThreads) {
        int a = 0, b = m;  // the last staged k with s_off[k] <= s (s_off[0] <= sl0)
        while (b - a > 1) {
          const int mid = (a + b) >> 1;
          if (s_off[mid] <= s) a = mid; else b = mid;
        }
        const int j = (int)(s - s_off[a]);
        const int row = j / s_w[a];
        const int64_t tile = (int64_t)(s_y[a] + row) * grid_x + s_x[a] + (j - row * s_w[a]);
        keys[s] = (tile << 32) | s_rank[a];
        gid[s] = (int32_t)(gs + a);
      }
    }
  }
  // Items past the merge are the unused slots slots .. max_dup.
  const int64_t f0 = d0 > merged ? d0 : merged;
  const int64_t f1 = d0 + kItems < n + max_dup ? d0 + kItems : n + max_dup;
  for (int64_t i = f0 + threadIdx.x; i < f1; i += kThreads) {
    keys[i - n] = kKeyInvalid;
    gid[i - n] = 0;
  }
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
  const unsigned blocks = (unsigned)((n + max_dup + kItems - 1) / kItems);
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
