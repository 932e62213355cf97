// Tile compositing, forward and backward: depth-ordered alpha blending of each
// 16x16 tile and its analytic gradient.
//
// The forward replaces the TPU kernel `_fwd_kernel` of the JAX package
// (relightable3dgaussians_w_tpu/ops/pallas/tile_composite.py), i.e. the
// reference's `renderCUDA` forward. Plain version: ops/composite.py
// `composite_forward`. The backward (second half of this file) replaces
// `_bwd_kernel` / `_bwd_one_tile` of the same file; plain version
// `composite_backward`.
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
// Colors: C is a runtime argument (3 for serving, 13 or 21 in training and
// evaluation, 51 in the evaluation's fused 17-angle relighting sweep, up to
// 64); the accumulators are a register array of a compile-time capacity >= C.
// Above 32 channels a batch's staged rows pass the 48 KB default of shared
// memory (256 x (7 + 51) x 4 = 59,392 bytes at C = 51), so the launch raises
// the kernel's dynamic shared-memory limit first.
//
// Kernel B' (`r3dgw_composite_forward_packed`) is the same kernel on packed
// serving rows: it replaces the `packed_rgb` branch of `_fwd_kernel`
// (`pack_rb` / `_unpack_rb_rows`, tile_composite.py:45-69). An entry row is 8
// floats: mean2d, conic, opacity, R and B quantized to 12 bits in one float
// (q_r * 4096 + q_b), exact G. The thread that stages a row unpacks it with
// the float ops of ops/composite.py `unpack_rb` (exact with FMA contraction
// off), so B' gives the image and T_final that B gives on the dequantized
// colors, bit for bit; the per-pair loop is B's. It is bound by operations
// as B is (the unpack is 5 float ops per staged row, beside ~25 per visited
// pair). Its row is 32 bytes instead of 36: the JAX package's reason for it,
// halving a 16-row padded gather on the TPU, does not carry over, because the
// port's entry rows carry no padding; it is the serving option kept as such.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // threads per block, entries per batch
constexpr int kCoef = 7;                // q0 qx qy qxx qyy qxy opacity
constexpr float kAlphaMin = (float)(1.0 / 255.0);
constexpr float kAlphaSat = 0.99f;
constexpr float kTEps = 1e-4f;
// 8 / 4095 rounded once from double to float (ops/composite.py PACK_STEP).
constexpr float kPackStep = (float)(8.0 / 4095.0);

template <int MAXC, bool PACKED>
__global__ void __launch_bounds__(kPixels) composite_fwd_kernel(
    const float* __restrict__ feat, int64_t n_rows, int C,
    const int64_t* __restrict__ tile_start, const int64_t* __restrict__ tile_end,
    const float* __restrict__ bg, int grid_x,
    float* __restrict__ out_rgb, float* __restrict__ out_tfin) {
  extern __shared__ float smem[];  // [kPixels][kCoef + C]
  const int F = PACKED ? 8 : 6 + C;
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
      if (PACKED) {
        // ops/composite.py unpack_rb, same ops
        const float rb = row[6];
        const float q_r = floorf(rb * (1.0f / 4096.0f));
        const float q_b = rb - q_r * 4096.0f;
        s[kCoef + 0] = q_r * kPackStep;
        s[kCoef + 1] = row[7];
        s[kCoef + 2] = q_b * kPackStep;
      } else {
        for (int c = 0; c < C; ++c) s[kCoef + c] = row[6 + c];
      }
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

template <int MAXC, bool PACKED = false>
cudaError_t launch(const float* feat, int64_t n_rows, int C, const int64_t* ts,
                   const int64_t* te, const float* bg, int grid_x, int num_tiles,
                   float* out_rgb, float* out_tfin, cudaStream_t stream) {
  const size_t smem = (size_t)kPixels * (kCoef + C) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(composite_fwd_kernel<MAXC, PACKED>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return err;
  }
  composite_fwd_kernel<MAXC, PACKED><<<num_tiles, kPixels, smem, stream>>>(
      feat, n_rows, C, ts, te, bg, grid_x, out_rgb, out_tfin);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ backward
//
// Per-entry gradients (mean2d x/y, conic a/b/c, opacity, C colors) from the
// pixel cotangents gbar [T, 256, C] and g_Tfinal. With S_g the suffix sum of
// w (c . gbar) over the entries after g and B = bg . gbar + g_Tfinal,
//   dL/dalpha_g = T_g (c_g . gbar) - (S_g + T_final * B) / (1 - alpha_g),
// and S_g = total - Q_g, where total = sum_g w_g (c_g . gbar) comes from the
// forward's output ((out - T_final * bg) . gbar, computed by the wrapper with
// T_final * B) and Q_g is the inclusive prefix, carried in a register. The
// saturation alpha = min(0.99, op * G) does not mask the gradient (reference
// semantics).
//
// What bounds it on an H100: the per-(pixel, entry) arithmetic, about 60
// float32 operations and one expf for every pair a pixel visits, and the
// reduction of each entry's 6 + C gradients over the tile's 256 pixels.
// Design: the forward's layout (one block per tile, one thread per pixel,
// entries staged in shared memory, here in batches of 32). Each thread replays
// the forward's own recurrence (same coefficients, same op order, expf, same
// alpha and termination tests, FMA contraction off for the whole file), so its
// include and skip decisions equal the forward's bit for bit. The TPU kernel's
// log-space prefix and Dekker splits were MXU workarounds and are gone. Each
// entry's 6 + C per-pixel terms are summed over the tile by a fixed-order
// reduction: a warp shuffle tree, one partial per warp in shared memory, then
// the 8 partials in warp order; a warp in which no pixel contributes writes
// zeros and skips the shuffles. No atomics, so two launches give the same
// bits. The block leaves once every pixel has terminated; the rows it never
// reaches are zero because the wrapper allocates d_feat with zeros.

constexpr int kBwdBatch = 32;            // entries per shared-memory batch
constexpr int kWarps = kPixels / 32;     // 8
constexpr int kBwdCoef = 12;             // q0 qx qy qxx qyy qxy op mx my ca cb cc

template <int MAXC>
__global__ void __launch_bounds__(kPixels) composite_bwd_kernel(
    const float* __restrict__ feat, int64_t n_rows, int C,
    const int64_t* __restrict__ tile_start, const int64_t* __restrict__ tile_end,
    const float* __restrict__ g_tiles, const float* __restrict__ total,
    const float* __restrict__ bterm, const float* __restrict__ tfin, int grid_x,
    float* __restrict__ d_feat) {
  extern __shared__ float smem[];
  const int F = 6 + C;
  const int S = kBwdCoef + C;
  float* coef = smem;                     // [kBwdBatch][S]
  float* part = smem + kBwdBatch * S;     // [kWarps][kBwdBatch][F]
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float tx0 = (float)((t % grid_x) * kTile);
  const float ty0 = (float)((t / grid_x) * kTile);
  const float px = (float)(p % kTile);
  const float py = (float)(p / kTile);
  const float px2 = px * px;
  const float py2 = py * py;
  const float pp = px * py;
  const float pxa = tx0 + px;  // absolute pixel coordinates (exact integers)
  const float pya = ty0 + py;

  const int64_t o = (int64_t)t * kPixels + p;
  float gb[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) gb[c] = c < C ? g_tiles[o * C + c] : 0.f;
  const float tot = total[o];
  const float TB = tfin[o] * bterm[o];

  const int64_t start = tile_start[t];
  const int64_t end = tile_end[t] < n_rows ? tile_end[t] : n_rows;

  float T = 1.f;
  float Q = 0.f;
  bool done = false;

  for (int64_t b = start; b < end; b += kBwdBatch) {
    if (__syncthreads_count(done) == kPixels) break;
    const int nb = (end - b) < kBwdBatch ? (int)(end - b) : kBwdBatch;
    if (p < nb) {
      const float* row = feat + (b + p) * F;
      const float ca = row[2], cb = row[3], cc = row[4];
      const float mxl = row[0] - tx0;
      const float myl = row[1] - ty0;
      float* s = coef + p * S;
      // entry_quad_coeffs, same op order as the forward
      s[0] = -0.5f * (ca * (mxl * mxl) + cc * (myl * myl)) - cb * (mxl * myl);
      s[1] = ca * mxl + cb * myl;
      s[2] = cc * myl + cb * mxl;
      s[3] = -0.5f * ca;
      s[4] = -0.5f * cc;
      s[5] = -cb;
      s[6] = row[5];
      s[7] = row[0];
      s[8] = row[1];
      s[9] = ca;
      s[10] = cb;
      s[11] = cc;
      for (int c = 0; c < C; ++c) s[kBwdCoef + c] = row[6 + c];
    }
    __syncthreads();
    for (int j = 0; j < nb; ++j) {
      const float* s = coef + j * S;
      float v[6 + MAXC];
#pragma unroll
      for (int k = 0; k < 6 + MAXC; ++k) v[k] = 0.f;
      bool contrib = false;
      if (!done) {
        // power_separable, same op order as the forward
        const float f = s[0] + s[1] * px + s[3] * px2;
        const float g = s[2] * py + s[4] * py2;
        const float power = (f + g) + s[5] * pp;
        if (!(power > 0.f)) {
          const float G = expf(power);
          const float alpha = fminf(kAlphaSat, s[6] * G);
          if (!(alpha < kAlphaMin)) {
            const float test_T = T * (1.f - alpha);
            if (test_T < kTEps) {
              done = true;
            } else {
              contrib = true;
              const float w = alpha * T;
              float cdotg = 0.f;
#pragma unroll
              for (int c = 0; c < MAXC; ++c)
                if (c < C) cdotg += s[kBwdCoef + c] * gb[c];
              Q += w * cdotg;
              const float d_alpha = T * cdotg - ((tot - Q) + TB) / (1.f - alpha);
              const float dG = s[6] * d_alpha;
              const float dx = s[7] - pxa;
              const float dy = s[8] - pya;
              const float gdx = G * dx;
              const float gdy = G * dy;
              v[0] = dG * (-(gdx * s[9] + gdy * s[10]));
              v[1] = dG * (-(gdy * s[11] + gdx * s[10]));
              v[2] = -0.5f * gdx * dx * dG;
              v[3] = -(gdx * dy) * dG;
              v[4] = -0.5f * gdy * dy * dG;
              v[5] = G * d_alpha;
#pragma unroll
              for (int c = 0; c < MAXC; ++c)
                if (c < C) v[6 + c] = w * gb[c];
              T = test_T;
            }
          }
        }
      }
      float* dst = part + (warp * kBwdBatch + j) * F;
      if (__any_sync(0xffffffffu, contrib)) {
#pragma unroll
        for (int k = 0; k < 6 + MAXC; ++k) {
          if (k < F) {
            float x = v[k];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
            if (lane == 0) dst[k] = x;
          }
        }
      } else if (lane == 0) {
        for (int k = 0; k < F; ++k) dst[k] = 0.f;
      }
    }
    __syncthreads();
    // Sum the warp partials in warp order; entry j's row is b + j.
    for (int i = p; i < nb * F; i += kPixels) {
      const int j = i / F;
      const int k = i - j * F;
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc += part[(w * kBwdBatch + j) * F + k];
      d_feat[b * F + i] = acc;
    }
  }
}

template <int MAXC>
cudaError_t launch_bwd(const float* feat, int64_t n_rows, int C, const int64_t* ts,
                       const int64_t* te, const float* g_tiles, const float* total,
                       const float* bterm, const float* tfin, int grid_x, int num_tiles,
                       float* d_feat, cudaStream_t stream) {
  const size_t smem = ((size_t)kBwdBatch * (kBwdCoef + C) +
                       (size_t)kWarps * kBwdBatch * (6 + C)) * sizeof(float);
  composite_bwd_kernel<MAXC><<<num_tiles, kPixels, smem, stream>>>(
      feat, n_rows, C, ts, te, g_tiles, total, bterm, tfin, grid_x, d_feat);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* r3dgw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// feat [n_rows, 6 + C] f32, tile_start/tile_end [num_tiles] i64, bg [C] f32
// -> out_rgb [num_tiles, 256, C] f32, out_tfin [num_tiles, 256] f32.
// Returns cudaGetLastError() (cudaErrorInvalidValue for C outside 1..64).
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
  if (C >= 1 && C <= 64) return (int)launch<64>(f, n_rows, C, ts, te, b, grid_x, num_tiles, o, tf, s);
  return (int)cudaErrorInvalidValue;
}

// Kernel B': packed rows feat [n_rows, 8] f32 (mean2d, conic, opacity, packed
// R|B, G), tile ranges as above, bg [3] f32 -> out_rgb [num_tiles, 256, 3] f32,
// out_tfin [num_tiles, 256] f32. Returns cudaGetLastError().
int r3dgw_composite_forward_packed(const void* feat, int64_t n_rows, const void* tile_start,
                                   const void* tile_end, const void* bg, int grid_x,
                                   int num_tiles, void* out_rgb, void* out_tfin, void* stream) {
  return (int)launch<4, true>((const float*)feat, n_rows, 3, (const int64_t*)tile_start,
                              (const int64_t*)tile_end, (const float*)bg, grid_x, num_tiles,
                              (float*)out_rgb, (float*)out_tfin, (cudaStream_t)stream);
}

// feat [n_rows, 6 + C] f32, tile ranges [num_tiles] i64, g_tiles [num_tiles, 256, C]
// f32, total / bterm / tfin [num_tiles, 256] f32 -> d_feat [n_rows, 6 + C] f32,
// which must hold zeros on entry (rows the kernel never reaches stay zero).
// Returns cudaGetLastError() (cudaErrorInvalidValue for C outside 1..32).
int r3dgw_composite_backward(const void* feat, int64_t n_rows, int C, const void* tile_start,
                             const void* tile_end, const void* g_tiles, const void* total,
                             const void* bterm, const void* tfin, int grid_x, int num_tiles,
                             void* d_feat, void* stream) {
  auto f = (const float*)feat;
  auto ts = (const int64_t*)tile_start;
  auto te = (const int64_t*)tile_end;
  auto g = (const float*)g_tiles;
  auto tot = (const float*)total;
  auto bt = (const float*)bterm;
  auto tf = (const float*)tfin;
  auto d = (float*)d_feat;
  auto s = (cudaStream_t)stream;
  if (C >= 1 && C <= 4)
    return (int)launch_bwd<4>(f, n_rows, C, ts, te, g, tot, bt, tf, grid_x, num_tiles, d, s);
  if (C >= 1 && C <= 16)
    return (int)launch_bwd<16>(f, n_rows, C, ts, te, g, tot, bt, tf, grid_x, num_tiles, d, s);
  if (C >= 1 && C <= 32)
    return (int)launch_bwd<32>(f, n_rows, C, ts, te, g, tot, bt, tf, grid_x, num_tiles, d, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
