// Tile compositing forward: depth-ordered alpha blending of each 16x16 tile.
//
// Replaces the TPU kernel `_fwd_kernel` of the JAX package
// (relightable3dgaussians_w_tpu/ops/pallas/tile_composite.py), i.e. the
// reference's `renderCUDA` forward. Plain version: ops/composite.py
// `composite_forward`.
//
// What bounds it on an H100: the per-(pixel, entry) arithmetic, ~25 float32
// operations and one expf for every pair a pixel visits before it saturates;
// the bytes (each entry row read once per tile) are small beside that. Design:
// one block per tile and one thread per pixel (256), the reference's layout. The
// tile's sorted entry rows stream through shared memory in batches of 256: each
// thread loads one row and turns it into the 6 coefficients of the separable
// power quadratic plus opacity and colors, so the per-pair work is 5 multiplies,
// 4 adds, an exp and the blend. Each pixel runs the sequential front-to-back
// recurrence in registers and the block leaves once every pixel has terminated
// (__syncthreads_count). The TPU kernel's log-space triangular-matmul prefix and
// bf16 Dekker splits were MXU workarounds for that recurrence and are gone.
//
// Numerics: the power > 0 skip is a discontinuity of height ~opacity, so power
// is computed in the op order of ops/composite.py `entry_quad_coeffs` and
// `power_separable`, and this file is compiled with --fmad=false so no product
// is fused into an add. expf (not __expf), no fast math. The recurrence:
// include = T * (1 - alpha) >= 1e-4; w = alpha * T; T_final is the product of the
// included (1 - alpha); T_final * bg is added in the epilogue.
//
// Colors: C is a runtime argument (3 for serving, 13 or 21 in training); the
// accumulators are a register array of a compile-time capacity >= C.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // threads per block, entries per batch
constexpr int kCoef = 7;                // q0 qx qy qxx qyy qxy opacity
constexpr float kAlphaMin = (float)(1.0 / 255.0);
constexpr float kAlphaSat = 0.99f;
constexpr float kTEps = 1e-4f;

template <int MAXC>
__global__ void __launch_bounds__(kPixels) composite_fwd_kernel(
    const float* __restrict__ feat, int64_t n_rows, int C,
    const int64_t* __restrict__ tile_start, const int64_t* __restrict__ tile_end,
    const float* __restrict__ bg, int grid_x,
    float* __restrict__ out_rgb, float* __restrict__ out_tfin) {
  extern __shared__ float smem[];  // [kPixels][kCoef + C]
  const int F = 6 + C;
  const int S = kCoef + C;
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float tx0 = (float)((t % grid_x) * kTile);
  const float ty0 = (float)((t / grid_x) * kTile);
  const float px = (float)(p % kTile);
  const float py = (float)(p / kTile);
  const float px2 = px * px;
  const float py2 = py * py;
  const float pp = px * py;

  const int64_t start = tile_start[t];
  const int64_t end = tile_end[t] < n_rows ? tile_end[t] : n_rows;

  float acc[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) acc[c] = 0.f;
  float T = 1.f;
  bool done = false;

  for (int64_t b = start; b < end; b += kPixels) {
    if (__syncthreads_count(done) == kPixels) break;
    const int64_t e = b + p;
    if (e < end) {
      const float* row = feat + e * F;
      const float ca = row[2], cb = row[3], cc = row[4];
      const float mxl = row[0] - tx0;
      const float myl = row[1] - ty0;
      float* s = smem + p * S;
      // entry_quad_coeffs, same op order
      s[0] = -0.5f * (ca * (mxl * mxl) + cc * (myl * myl)) - cb * (mxl * myl);
      s[1] = ca * mxl + cb * myl;
      s[2] = cc * myl + cb * mxl;
      s[3] = -0.5f * ca;
      s[4] = -0.5f * cc;
      s[5] = -cb;
      s[6] = row[5];
      for (int c = 0; c < C; ++c) s[kCoef + c] = row[6 + c];
    }
    __syncthreads();
    const int nb = (end - b) < kPixels ? (int)(end - b) : kPixels;
    for (int j = 0; j < nb && !done; ++j) {
      const float* s = smem + j * S;
      // power_separable, same op order
      const float f = s[0] + s[1] * px + s[3] * px2;
      const float g = s[2] * py + s[4] * py2;
      const float power = (f + g) + s[5] * pp;
      if (power > 0.f) continue;
      const float alpha = fminf(kAlphaSat, s[6] * expf(power));
      if (alpha < kAlphaMin) continue;
      const float test_T = T * (1.f - alpha);
      if (test_T < kTEps) {
        done = true;
        continue;
      }
      const float w = alpha * T;
#pragma unroll
      for (int c = 0; c < MAXC; ++c)
        if (c < C) acc[c] += w * s[kCoef + c];
      T = test_T;
    }
  }

  const int64_t o = (int64_t)t * kPixels + p;
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
    if (c < C) out_rgb[o * C + c] = acc[c] + T * bg[c];
  out_tfin[o] = T;
}

template <int MAXC>
cudaError_t launch(const float* feat, int64_t n_rows, int C, const int64_t* ts,
                   const int64_t* te, const float* bg, int grid_x, int num_tiles,
                   float* out_rgb, float* out_tfin, cudaStream_t stream) {
  const size_t smem = (size_t)kPixels * (kCoef + C) * sizeof(float);
  composite_fwd_kernel<MAXC><<<num_tiles, kPixels, smem, stream>>>(
      feat, n_rows, C, ts, te, bg, grid_x, out_rgb, out_tfin);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* r3dgw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// feat [n_rows, 6 + C] f32, tile_start/tile_end [num_tiles] i64, bg [C] f32
// -> out_rgb [num_tiles, 256, C] f32, out_tfin [num_tiles, 256] f32.
// Returns cudaGetLastError() (cudaErrorInvalidValue for C outside 1..32).
int r3dgw_composite_forward(const void* feat, int64_t n_rows, int C, const void* tile_start,
                            const void* tile_end, const void* bg, int grid_x, int num_tiles,
                            void* out_rgb, void* out_tfin, void* stream) {
  auto f = (const float*)feat;
  auto ts = (const int64_t*)tile_start;
  auto te = (const int64_t*)tile_end;
  auto b = (const float*)bg;
  auto o = (float*)out_rgb;
  auto tf = (float*)out_tfin;
  auto s = (cudaStream_t)stream;
  if (C >= 1 && C <= 4) return (int)launch<4>(f, n_rows, C, ts, te, b, grid_x, num_tiles, o, tf, s);
  if (C >= 1 && C <= 16) return (int)launch<16>(f, n_rows, C, ts, te, b, grid_x, num_tiles, o, tf, s);
  if (C >= 1 && C <= 32) return (int)launch<32>(f, n_rows, C, ts, te, b, grid_x, num_tiles, o, tf, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
