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
// 4-byte id; per Gaussian they read its 12-byte count and offset, and a
// Gaussian with entries ~20 bytes more (+ up to 32 bytes of packed interval
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
// expand_intervals_kernel carries that design over to the interval walk. Its
// merge is cut into tiles of 512 items, and each block walks up to 4
// consecutive tiles: one 32-way search finds the Gaussian of its first item,
// each later tile starts where the last one ended, and one more load tells
// whether the block's items are Gaussians only (a run of culled rows, most of
// a trainer's pool), which it then skips. A tile stages its Gaussians'
// offsets (32-bit, relative to its first slot) and counts, counts those
// before its last item with warp ballots, and reads rect, rank and the 8
// packed rows only for the Gaussians with entries (52 bytes a Gaussian, 27 KB
// a block). Its latency chains (loads, then barriers) bound it, so the kernel
// is held to 32 registers for 8 resident blocks an SM. A slot's row is the
// first interval row whose running sum of widths passes it (rows with w = 0
// are stepped over), or a full-width row below them by one division.
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

constexpr int kItems = 1024;  // merge items (Gaussians and slots) per block of expand_kernel

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

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

constexpr int kIvItems = 512;  // merge items per tile of expand_intervals_kernel
constexpr int kIvTilesPerBlock = 4;  // tiles a block walks (fewer when one wave holds them)
constexpr int kIvBlocksPerSM = 8;    // resident blocks: 32 registers a thread, 27 KB
constexpr int kIvStage = (kIvItems + 1 + kThreads - 1) / kThreads;  // staged Gaussians a thread
constexpr int kWarps = kThreads / 32;

// packed [kRowCap, n]: txl_rel + 128 * w_j of tile row j of Gaussian i (0 for an
// empty row); counts[i] = sum_j w_j + max(h - kRowCap, 0) * rect_w (0 if culled).
// Each block walks `tiles_per_block` consecutive tiles of kIvItems merge items;
// the first tile's Gaussian comes from one merge-path search, each later one
// starts where the previous tile ended.
__global__ void __launch_bounds__(kThreads, kIvBlocksPerSM) expand_intervals_kernel(
    const int32_t* __restrict__ counts, const int64_t* __restrict__ offsets,
    const int32_t* __restrict__ rect_min, const int32_t* __restrict__ rect_w,
    const int64_t* __restrict__ rank, const int32_t* __restrict__ packed, int64_t n,
    int64_t grid_x, int64_t max_dup, int64_t tiles_per_block, int64_t* __restrict__ keys,
    int32_t* __restrict__ gid) {
  // Offsets relative to the tile's first slot (within int32: a run is under
  // 2^31 slots), and ranks (under n < 2^31) as 32-bit words.
  __shared__ int32_t s_off[kIvItems + 1];
  __shared__ uint32_t s_rank[kIvItems + 1];
  __shared__ int32_t s_x[kIvItems + 1], s_y[kIvItems + 1], s_w[kIvItems + 1];
  __shared__ int32_t s_pk[kRowCap][kIvItems + 1];
  __shared__ int64_t s_g0;
  __shared__ int s_before[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t total = n > 0 ? offsets[n - 1] + counts[n - 1] : 0;
  const int64_t slots = total < max_dup ? total : max_dup;  // slots that get an entry
  const int64_t merged = n + slots;
  const int64_t items = n + max_dup;                       // merge items, then unused slots
  const int64_t d_begin = (int64_t)blockIdx.x * tiles_per_block * kIvItems;
  const int64_t d_end = min64(d_begin + tiles_per_block * kIvItems, items);
  if (d_begin >= d_end) return;
  // The Gaussians before the block's first item (one 32-way search), and
  // whether all of its merge items are Gaussians (a run of culled rows, most
  // of a trainer's pool): then it has no slot to write.
  int64_t g0 = n;  // Gaussians before the tile's first item
  bool only_g = true;
  if (d_begin < merged) {
    if (warp == 0) {
      const int64_t g = merge_split(offsets, n, slots, d_begin);
      if (lane == 0) s_g0 = g;
    }
    __syncthreads();
    g0 = s_g0;
    // They are iff the last of them, Gaussian g0 + (dm_end - d_begin) - 1,
    // precedes item dm_end.
    const int64_t dm_end = min64(d_end, merged);
    const int64_t last = g0 + (dm_end - d_begin) - 1;
    if (last < n) {
      const int64_t off = offsets[last];
      only_g = (off < slots ? off : slots) + last < dm_end;
    } else {
      only_g = false;
    }
  }
  for (int64_t d0 = d_begin; d0 < d_end; d0 += kIvItems) {
    const int64_t d1 = min64(d0 + kIvItems, d_end);
    const int64_t dm = min64(d1, merged);
    if (d0 < dm && !only_g) {
      // Stage g0 - 1 (its run may enter the tile) and the Gaussians that can
      // lie among the tile's items; g1, the first after them, is g0 plus the
      // count of those with min(offset, slots) + g < dm.
      const int64_t gs = g0 > 0 ? g0 - 1 : 0;
      const int64_t sl0 = d0 - g0;  // the tile's first slot
      const int m_hi = (int)(min64(g0 + (dm - d0), n) - gs);
      __syncthreads();  // the previous tile is done with shared memory
      int32_t cnt[kIvStage];
      int before = 0;
#pragma unroll
      for (int r = 0; r < kIvStage; ++r) {
        const int k = threadIdx.x + r * kThreads;
        cnt[r] = 0;
        bool pre = false;
        if (k < m_hi) {
          const int64_t g = gs + k;
          const int64_t off = offsets[g];
          cnt[r] = counts[g];
          s_off[k] = (int32_t)(off - sl0);
          pre = g >= g0 && (off < slots ? off : slots) + g < dm;
        }
        before += __popc(__ballot_sync(0xffffffffu, pre));
      }
      if (lane == 0) s_before[warp] = before;
      __syncthreads();
      before = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) before += s_before[w];
      const int64_t g1 = g0 + before;
      const int m = (int)(g1 - gs);
      // Only Gaussians with entries are read further: rect, rank, interval rows.
#pragma unroll
      for (int r = 0; r < kIvStage; ++r) {
        const int k = threadIdx.x + r * kThreads;
        if (k < m && cnt[r] > 0) {
          const int64_t g = gs + k;
          s_rank[k] = (uint32_t)rank[g];
          s_x[k] = rect_min[2 * g];
          s_y[k] = rect_min[2 * g + 1];
          s_w[k] = rect_w[g];
#pragma unroll
          for (int j = 0; j < kRowCap; ++j) s_pk[j][k] = packed[(int64_t)j * n + g];
        }
      }
      __syncthreads();
      const int nsl = (int)(dm - g1 - sl0);  // the tile's slots: sl0 .. sl0 + nsl
      for (int t = threadIdx.x; t < nsl; t += kThreads) {
        int a = 0, b = m;  // the last staged k with s_off[k] <= t (s_off[0] <= 0)
        while (b - a > 1) {
          const int mid = (a + b) >> 1;
          if (s_off[mid] <= t) a = mid; else b = mid;
        }
        // Slot j of the run: the interval row whose prefix holds it (rows with
        // w = 0 are stepped over), else a full-width row below them.
        const int j = t - s_off[a];
        int row, col;
        int base = 0, r = 0;
        int32_t p = 0;
        for (; r < kRowCap; ++r) {
          p = s_pk[r][a];
          if (j < base + (p >> 7)) break;
          base += p >> 7;
        }
        if (r < kRowCap) {
          row = r;
          col = (p & 127) + (j - base);
        } else {
          const int q = (j - base) / s_w[a];
          row = kRowCap + q;
          col = j - base - q * s_w[a];
        }
        const int64_t tile = (int64_t)(s_y[a] + row) * grid_x + s_x[a] + col;
        keys[sl0 + t] = (tile << 32) | s_rank[a];
        gid[sl0 + t] = (int32_t)(gs + a);
      }
      g0 = g1;
    } else if (d0 < dm) {
      g0 += dm - d0;  // the tile holds Gaussians only
    }
    // Items past the merge are the unused slots slots .. max_dup.
    for (int64_t i = (d0 > merged ? d0 : merged) + threadIdx.x; i < d1; i += kThreads) {
      keys[i - n] = kKeyInvalid;
      gid[i - n] = 0;
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
  const int64_t tiles = (n + max_dup + kIvItems - 1) / kIvItems;
  if (tiles > 0) {
    // One wave of blocks (resident blocks a card, kept per device), each over
    // an equal run of consecutive tiles.
    static int64_t waves[64];
    int dev = 0;
    cudaGetDevice(&dev);
    int64_t wave = dev < 64 ? waves[dev] : 0;
    if (wave == 0) {
      int sms = 0, per_sm = 0;
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, expand_intervals_kernel, kThreads,
                                                    0);
      wave = (int64_t)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
      if (dev < 64) waves[dev] = wave;
    }
    int64_t per_block = (tiles + wave - 1) / wave;
    if (per_block > kIvTilesPerBlock) per_block = kIvTilesPerBlock;
    const unsigned blocks = (unsigned)((tiles + per_block - 1) / per_block);
    expand_intervals_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)counts, (const int64_t*)offsets, (const int32_t*)rect_min,
        (const int32_t*)rect_w, (const int64_t*)rank, (const int32_t*)packed, n, grid_x,
        max_dup, per_block, (int64_t*)keys, (int32_t*)gid);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
