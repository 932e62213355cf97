// Row intervals: per Gaussian, the exact x-interval of its contributing ellipse
// in each of the first 8 tile rows of its rect, packed, and its entry count.
//
// Replaces no TPU kernel. The JAX package computes these with XLA ops
// (relightable3dgaussians_w_tpu/ops/preprocess.py `row_intervals`) that its jit
// fuses into the step's program; the port's eager version (ops/preprocess.py
// `row_intervals_plain`) is ~300 kernels, a prelude and ~35 per tile row. This
// kernel is the input half of the interval expansion (expand.cu
// `expand_intervals_kernel`, the TPU kernel's `intervals` branch): it computes
// the counts and the packed rows that the expansion walks.
//
// What bounds it on an H100: bytes. A row reads 44 bytes (mean2d, conic,
// opacity, rect min and max, tiles_touched) and writes 36 (its count and 8
// packed rows); its ~330 float operations a row are a fifth of that time at
// 67 TFLOP/s, but the IEEE divisions and square roots (19 and 18 a row) take
// several instructions each. So it is one pass, one thread per row: the
// prelude (rho^2, the conic's determinant, the ellipse's x and y extents)
// once, the 8 tile rows unrolled in registers, every load and the store of
// each packed row coalesced across the warp ([8, n] layout: row j of 32
// threads is 128 contiguous bytes). Rows with tiles_touched == 0 get their
// packed values too, as in the plain version, which computes every row.
//
// Bitwise equal to the plain version on the card. This source is compiled
// with --fmad=false (ops/cuda/build.py), so every product and sum is rounded
// on its own, in the plain version's op order ((det_c * dyp) * dyp among
// them); sqrtf, logf and the division are IEEE (no fast-math). torch.maximum,
// torch.minimum and torch.clamp_min return NaN for a NaN operand, which fmaxf
// does not: `tmax` / `tmin` keep torch's rule (the sign of a zero they return
// can differ from torch's, and no integer output depends on it: no result is
// divided by, and floor gives 0 for either zero). Scalars are rounded to
// float as PyTorch rounds a Python number against a float32 tensor: 1 /
// skip_alpha in double, then to float (the wrapper), and the clamp floors as
// double literals cast to float. Division by the tile size is a product with
// its reciprocal, as PyTorch's CUDA division by a scalar computes it (the
// tile is 16, a power of two, so the CPU's true division gives the same
// bits). The float32 -> int32 conversion is XLA's, saturating with NaN -> 0
// (the plain version's `_f32_to_i32`, in double there, one conversion
// instruction here); int32 sums wrap as torch's do. The packed rows are
// written as int32, the value of the plain version's float32 row converted
// back (`row_intervals_plain(...)[1].to(torch.int32)`).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowCap = 8;               // preprocess.H_CAP
constexpr float kMargin = 1.0f;          // preprocess.INTERVAL_MARGIN

// torch.maximum / torch.minimum / torch.clamp_min: NaN if either operand is
// NaN (one instruction, max.NaN; fmaxf would return the other operand).
__device__ __forceinline__ float tmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float tmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}
__device__ __forceinline__ int32_t clip_i(int32_t x, int32_t lo, int32_t hi) {
  return min(max(x, lo), hi);
}

// floor(x) converted as XLA converts float32 to int32 (preprocess._f32_to_i32):
// saturating, NaN -> 0. The conversion instruction with rounding down does
// all of it: cvt.rmi.s32.f32 clamps to the int32 range and maps NaN to 0.
__device__ __forceinline__ int32_t floor_to_i32(float x) { return __float2int_rd(x); }

__global__ void __launch_bounds__(kThreads) row_intervals_kernel(
    const float* __restrict__ mean2d, const float* __restrict__ conic,
    const float* __restrict__ opacity, const int32_t* __restrict__ rect_min,
    const int32_t* __restrict__ rect_max, const int32_t* __restrict__ tiles_touched,
    int64_t n, int tile, float inv_skip, int32_t* __restrict__ counts,
    int32_t* __restrict__ packed) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float mx = mean2d[2 * i], my = mean2d[2 * i + 1];
  const float a = conic[3 * i], b = conic[3 * i + 1], c = conic[3 * i + 2];
  const float op = opacity[i];
  const int32_t x0 = rect_min[2 * i], y0 = rect_min[2 * i + 1];
  const int32_t x1 = rect_max[2 * i], y1 = rect_max[2 * i + 1];
  const int32_t touched = tiles_touched[i];
  const int32_t h = wsub(y1, y0);
  const int32_t w_full = max(wsub(x1, x0), 0);

  const float tile_f = (float)tile, tile_m1 = (float)(tile - 1);
  const float inv_tile = 1.0f / tile_f;
  const float floor_op = (float)1e-12, floor_c = (float)1e-30;
  const float rho2 = tmax(2.0f * logf(inv_skip * tmax(op, floor_op)), 0.0f);
  const float det_c = tmax(a * c - b * b, floor_c);
  const float a_s = tmax(a, floor_c);
  const float dx_max = sqrtf(tmax(rho2 * c / det_c, 0.0f));
  const float dy_at_xmax = -(b / tmax(c, floor_c)) * dx_max;
  const float dy_max = sqrtf(tmax(rho2 * a / det_c, 0.0f));
  const float a_rho2 = a_s * rho2;
  const float nb = -b;

  int32_t count = 0;
#pragma unroll
  for (int j = 0; j < kRowCap; ++j) {
    const int32_t ty = wadd(y0, j);
    const bool live = j < h;
    const float dy0 = (float)ty * tile_f - my;
    const float dy1 = dy0 + tile_m1;
    const float lo = tmax(dy0, -dy_max);
    const float hi = tmin(dy1, dy_max);
    const bool nonempty = lo <= hi;
    // x+ is concave in dy: its band max at the clamped argmax; x- is convex.
    const float dyp = tmin(tmax(dy_at_xmax, lo), hi);
    const float sp = tmax(a_rho2 - det_c * dyp * dyp, 0.0f);
    const float x_hi = mx + (nb * dyp + sqrtf(sp)) / a_s + kMargin;
    const float dym = tmin(tmax(-dy_at_xmax, lo), hi);
    const float sm = tmax(a_rho2 - det_c * dym * dym, 0.0f);
    const float x_lo = mx + (nb * dym - sqrtf(sm)) / a_s - kMargin;
    const int32_t txl = max(floor_to_i32(x_lo * inv_tile), x0);
    const int32_t txh = min(wadd(floor_to_i32(x_hi * inv_tile), 1), x1);
    int32_t wj = clip_i(wsub(txh, txl), 0, w_full);
    wj = live && nonempty ? wj : 0;
    const int32_t txl_rel = clip_i(wsub(txl, x0), 0, 127);
    count = wadd(count, wj);
    const int32_t v = wj > 0 ? wadd(txl_rel, wmul(128, wj)) : 0;
    packed[(int64_t)j * n + i] = __float2int_rz(__int2float_rn(v));
  }
  count = wadd(count, wmul(max(wsub(h, kRowCap), 0), w_full));
  counts[i] = touched > 0 ? count : 0;
}

}  // namespace

extern "C" {

const char* r3dgw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// mean2d [n, 2] f32, conic [n, 3] f32, opacity [n] f32, rect_min / rect_max
// [n, 2] i32, tiles_touched [n] i32 -> counts [n] i32, packed [8, n] i32.
// inv_skip is 1 / skip_alpha rounded to float. Returns cudaGetLastError().
int r3dgw_row_intervals(const void* mean2d, const void* conic, const void* opacity,
                        const void* rect_min, const void* rect_max,
                        const void* tiles_touched, int64_t n, int tile, float inv_skip,
                        void* counts, void* packed, void* stream) {
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    row_intervals_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)mean2d, (const float*)conic, (const float*)opacity,
        (const int32_t*)rect_min, (const int32_t*)rect_max, (const int32_t*)tiles_touched, n,
        tile, inv_skip, (int32_t*)counts, (int32_t*)packed);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
