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
// What bounds it on an H100: not the bytes (each entry row is read once per
// tile) nor the float32 operations that the bound counts, but the
// instructions a warp issues for each entry it visits: the rounded power
// chain, expf, the three tests and the blend, ~55 at C = 13. Reading each
// staged value with its own LDS would add 20 on the SM's shared-memory pipe
// (LDS, STS and SHFL share it, about one warp instruction per clock per SM).
// Every pixel of a warp reads the same staged entry, so each read is a
// broadcast. Design: one block per tile and one thread per pixel (256), the
// reference's layout. The tile's sorted entry rows stream through shared memory
// in batches of 256: one thread per row turns mean and conic into the 6
// coefficients of the separable power quadratic plus opacity, and all threads
// copy the colors. A staged row is padded to a multiple of 4 floats and read
// with float4 broadcasts: 5 LDS.128 per warp-entry at 13 channels instead of
// 20 scalar LDS. Each pixel runs the sequential
// front-to-back recurrence in registers and the block leaves once every pixel
// has terminated (__syncthreads_count). The TPU kernel's log-space
// triangular-matmul prefix and bf16 Dekker splits were MXU workarounds for that
// recurrence and are gone.
//
// Numerics: the power > 0 skip is a discontinuity of height ~opacity, so the
// predicate chain (entry_quad_coeffs, power_separable, alpha = min(0.99,
// op * expf(power)), T * (1 - alpha)) is written with __fmul_rn / __fadd_rn /
// __fsub_rn in the op order of ops/composite.py: no product is fused into an
// add there, and the include, skip and termination decisions equal the plain
// version's bit for bit. expf, not __expf. Everything past the predicates (the
// blend, the dot products, the gradient terms) may contract to FMA. The
// recurrence: include = T * (1 - alpha) >= 1e-4; w = alpha * T; T_final is the
// product of the included (1 - alpha); T_final * bg is added in the epilogue.
//
// Colors: the channel counts the paths use are template arguments (3 for
// serving, 13 in training, 21 in the render CLI, 51 in the evaluation's fused
// 17-angle relighting sweep), so the accumulators are exactly sized and no
// channel is predicated; any other count up to 64 runs a capacity instance of
// 4, 16, 32 or 64 channels with the count as a runtime argument. Above 48 KB
// of staged rows (256 x 60 x 4 = 61,440 bytes at C = 51) the launch raises the
// kernel's dynamic shared-memory limit first.
//
// Kernel B' (`r3dgw_composite_forward_packed`) is the same kernel on packed
// serving rows: it replaces the `packed_rgb` branch of `_fwd_kernel`
// (`pack_rb` / `_unpack_rb_rows`, tile_composite.py:45-69). An entry row is 8
// floats: mean2d, conic, opacity, R and B quantized to 12 bits in one float
// (q_r * 4096 + q_b), exact G. The thread that stages a row unpacks it with
// the float ops of ops/composite.py `unpack_rb`, each rounded on its own, so
// B' gives the image and T_final that B gives on the dequantized colors, bit
// for bit; the per-pair loop is B's (the same template at 3 channels). Its row
// is 32 bytes instead of 36: the JAX package's reason for it, halving a 16-row
// padded gather on the TPU, does not carry over, because the port's entry rows
// carry no padding; it is the serving option kept as such.

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
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// entry_quad_coeffs in its op order, every product and sum rounded on its own:
// s[0..5] = q0 qx qy qxx qyy qxy of one entry row relative to the tile origin.
__device__ __forceinline__ void quad_coeffs(const float* row, float tx0, float ty0, float* s) {
  const float ca = row[2], cb = row[3], cc = row[4];
  const float mxl = __fsub_rn(row[0], tx0);
  const float myl = __fsub_rn(row[1], ty0);
  const float quad = __fadd_rn(__fmul_rn(ca, __fmul_rn(mxl, mxl)), __fmul_rn(cc, __fmul_rn(myl, myl)));
  s[0] = __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(cb, __fmul_rn(mxl, myl)));
  s[1] = __fadd_rn(__fmul_rn(ca, mxl), __fmul_rn(cb, myl));
  s[2] = __fadd_rn(__fmul_rn(cc, myl), __fmul_rn(cb, mxl));
  s[3] = __fmul_rn(-0.5f, ca);
  s[4] = __fmul_rn(-0.5f, cc);
  s[5] = -cb;
}

// power_separable in its op order: q = (q0, qx, qy, qxx), then qyy and qxy.
__device__ __forceinline__ float power_at(float4 q, float qyy, float qxy, float px, float py,
                                          float px2, float py2, float pp) {
  const float f = __fadd_rn(__fadd_rn(q.x, __fmul_rn(q.y, px)), __fmul_rn(q.w, px2));
  const float g = __fadd_rn(__fmul_rn(q.z, py), __fmul_rn(qyy, py2));
  return __fadd_rn(__fadd_rn(f, g), __fmul_rn(qxy, pp));
}

// Copy the C colors of rows b .. b + nb into the staged rows at column `col`,
// all threads, neighbouring threads on neighbouring floats of a row.
__device__ __forceinline__ void stage_colors(const float* __restrict__ feat, int64_t b, int nb,
                                             int F, int C, float* smem, int stride, int col) {
  for (int i = threadIdx.x; i < nb * C; i += kPixels) {
    const int j = i / C;
    const int c = i - j * C;
    smem[j * stride + col + c] = feat[(b + j) * F + 6 + c];
  }
}

// MAXC: channels of the accumulators; EXACT: the channel count is MAXC (else
// the runtime c_arg <= MAXC); PACKED: kernel B' (8-float packed rows, C = 3).
template <int MAXC, bool EXACT, bool PACKED>
__global__ void __launch_bounds__(kPixels) composite_fwd_kernel(
    const float* __restrict__ feat, int64_t n_rows, int c_arg,
    const int64_t* __restrict__ tile_start, const int64_t* __restrict__ tile_end,
    const float* __restrict__ bg, int grid_x,
    float* __restrict__ out_rgb, float* __restrict__ out_tfin) {
  // Staged row: q0 qx qy qxx | qyy qxy op c0 | c1 c2 c3 c4 | ..., padded to SP.
  constexpr int SP = round4(kCoef + MAXC);
  extern __shared__ float4 smem4[];  // [kPixels][SP / 4]
  float* smem = reinterpret_cast<float*>(smem4);
  const int C = EXACT ? MAXC : c_arg;
  const int F = PACKED ? 8 : 6 + C;
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float tx0 = (float)((t % grid_x) * kTile);
  const float ty0 = (float)((t / grid_x) * kTile);
  const float px = (float)(p % kTile);
  const float py = (float)(p / kTile);
  const float px2 = px * px;  // exact small integers
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
    const int nb = (end - b) < kPixels ? (int)(end - b) : kPixels;
    if (p < nb) {
      const float* row = feat + (b + p) * F;
      float* s = smem + p * SP;
      quad_coeffs(row, tx0, ty0, s);
      s[6] = row[5];
      if (PACKED) {
        // ops/composite.py unpack_rb, same ops
        const float rb = row[6];
        const float q_r = floorf(__fmul_rn(rb, 1.0f / 4096.0f));
        const float q_b = __fsub_rn(rb, __fmul_rn(q_r, 4096.0f));
        s[kCoef + 0] = __fmul_rn(q_r, kPackStep);
        s[kCoef + 1] = row[7];
        s[kCoef + 2] = __fmul_rn(q_b, kPackStep);
      }
    }
    if (!PACKED) stage_colors(feat, b, nb, F, C, smem, SP, kCoef);
    __syncthreads();
    for (int j = 0; j < nb && !done; ++j) {
      const float4* r = smem4 + j * (SP / 4);
      const float4 q = r[0];
      const float4 h = r[1];  // qyy qxy op c0
      const float power = power_at(q, h.x, h.y, px, py, px2, py2, pp);
      if (power > 0.f) continue;
      const float alpha = fminf(kAlphaSat, __fmul_rn(h.z, expf(power)));
      if (alpha < kAlphaMin) continue;
      const float test_T = __fmul_rn(T, __fsub_rn(1.f, alpha));
      if (test_T < kTEps) {
        done = true;
        continue;
      }
      const float w = __fmul_rn(alpha, T);
      acc[0] = fmaf(w, h.w, acc[0]);
#pragma unroll
      for (int k = 0; k < (MAXC + 2) / 4; ++k) {  // colors 1 + 4k .. 4 + 4k
        if (EXACT || 1 + 4 * k < C) {
          const float4 v = r[2 + k];
          const float cv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int c = 1 + 4 * k + m;
            if (c < MAXC && (EXACT || c < C)) acc[c] = fmaf(w, cv[m], acc[c]);
          }
        }
      }
      T = test_T;
    }
  }

  const int64_t o = (int64_t)t * kPixels + p;
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
    if (EXACT || c < C) out_rgb[o * C + c] = __fadd_rn(acc[c], __fmul_rn(T, bg[c]));
  out_tfin[o] = T;
}

template <int MAXC, bool EXACT, bool PACKED = false>
cudaError_t launch(const float* feat, int64_t n_rows, int C, const int64_t* ts,
                   const int64_t* te, const float* bg, int grid_x, int num_tiles,
                   float* out_rgb, float* out_tfin, cudaStream_t stream) {
  const size_t smem = (size_t)kPixels * round4(kCoef + MAXC) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(composite_fwd_kernel<MAXC, EXACT, PACKED>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return err;
  }
  composite_fwd_kernel<MAXC, EXACT, PACKED><<<num_tiles, kPixels, smem, stream>>>(
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
// What bounds it on an H100: the instructions each warp issues per entry it
// visits, not the ~60 float32 operations per contributing (pixel, entry) pair
// that the bound counts. Each warp-entry with a contributing lane sums its
// F = 6 + C gradient values over the warp's 32 pixels; one 5-level shuffle
// tree per value would put 5F SHFL (95 at C = 13) on the shared-memory pipe
// (LDS, STS, SHFL: about one warp instruction per clock per SM), beside the
// reads of the staged row and F stores of the partial. Design: the forward's
// layout (one block per tile, one thread per pixel), entries staged in batches
// of 64, each row padded to a multiple of 4 floats (12 coefficients and C
// colors) and read with float4 broadcasts (7 LDS.128 at C = 13). Each thread
// replays the forward's own recurrence (the same rounded predicate chain,
// expf), so its include and skip decisions equal the forward's bit for bit.
// The replay has no branch: a lane that does not blend the entry (skipped,
// terminated or done) computes the same terms with w and dL/dalpha set to
// zero, which makes each of them exactly zero, so a divergent warp runs one
// path and clears nothing. The F values are summed over
// the warp by a reduce-scatter: at each of the five __shfl_xor_sync levels
// (offsets 16 .. 1) the lower half of the lanes keeps the lower half of the
// values and sends the upper half, and the upper lanes the opposite, so the
// set halves each level (19 -> 10 -> 5 -> 3 -> 2 -> 1: 21 SHFL at C = 13) and
// each lane ends with the warp sum of one value; one STS by all lanes writes
// the warp's partial row. A warp-entry no lane contributes to skips all of it
// and clears its bit in the warp's per-batch mask; the 8 warp partials of an
// entry are then summed in warp order, skipping the cleared ones, and a row no
// warp reached is not written. No atomics and a fixed order of summation, so
// two launches give the same bits. The block leaves once every pixel has
// terminated; the rows it never reaches are zero because the wrapper allocates
// d_feat with zeros. The TPU kernel's log-space prefix and Dekker splits were
// MXU workarounds and are gone.

constexpr int kBwdBatch = 64;            // entries per shared-memory batch (mask bits)
constexpr int kWarps = kPixels / 32;     // 8
constexpr int kBwdCoef = 12;             // q0 qx qy qxx | qyy qxy op mx | my ca cb cc

// One level of the warp reduce-scatter over N values (H = ceil(N / 2) kept):
// the lanes with `upper` set keep values H .. N - 1 (padded with a zero) and
// send 0 .. H - 1, the others the opposite; the partner's half is added.
template <int N, int H>
__device__ __forceinline__ void rs_level(float* v, bool upper, int offset) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float lo = v[i];
    const float hi = i + H < N ? v[i + H] : 0.f;
    const float keep = upper ? hi : lo;
    const float send = upper ? lo : hi;
    v[i] = keep + __shfl_xor_sync(kFull, send, offset);
  }
}

template <int N>
struct RS {
  static constexpr int H1 = (N + 1) / 2, H2 = (H1 + 1) / 2, H3 = (H2 + 1) / 2,
                       H4 = (H3 + 1) / 2, H5 = (H4 + 1) / 2;  // values a lane ends with

  // Sum v[0 .. N) over the warp; lane `lane` ends with the sums of values
  // slot .. slot + count - 1 in v[0 .. count) (see `slot`).
  static __device__ __forceinline__ void reduce(float* v, int lane) {
    rs_level<N, H1>(v, lane & 16, 16);
    rs_level<H1, H2>(v, lane & 8, 8);
    rs_level<H2, H3>(v, lane & 4, 4);
    rs_level<H3, H4>(v, lane & 2, 2);
    rs_level<H4, H5>(v, lane & 1, 1);
  }

  // The first value a lane ends with and how many of its H5 are real, for
  // `n` real values of the N (the rest are zero padding).
  static __device__ __forceinline__ void slot(int lane, int n, int& first, int& count) {
    const int h[5] = {H1, H2, H3, H4, H5};
    first = 0;
    count = n;
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      if (lane & (16 >> l)) {
        first += h[l];
        count -= h[l];
      } else {
        count = count < h[l] ? count : h[l];
      }
    }
    count = count > 0 ? count : 0;
  }
};

template <int MAXC, bool EXACT>
__global__ void __launch_bounds__(kPixels) composite_bwd_kernel(
    const float* __restrict__ feat, int64_t n_rows, int c_arg,
    const int64_t* __restrict__ tile_start, const int64_t* __restrict__ tile_end,
    const float* __restrict__ g_tiles, const float* __restrict__ total,
    const float* __restrict__ bterm, const float* __restrict__ tfin, int grid_x,
    float* __restrict__ d_feat) {
  constexpr int SP = kBwdCoef + round4(MAXC);
  constexpr int N = 6 + MAXC;  // gradient values per pixel, with capacity padding
  using Reduce = RS<N>;
  extern __shared__ float4 smem4[];
  const int C = EXACT ? MAXC : c_arg;
  const int F = 6 + C;
  float* coef = reinterpret_cast<float*>(smem4);   // [kBwdBatch][SP]
  float* part = coef + kBwdBatch * SP;              // [kWarps][kBwdBatch][F]
  unsigned long long* wmask =
      reinterpret_cast<unsigned long long*>(part + kWarps * kBwdBatch * F);  // [kWarps]
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
  int first, count;
  Reduce::slot(lane, F, first, count);

  const int64_t o = (int64_t)t * kPixels + p;
  float gb[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) gb[c] = (EXACT || c < C) ? g_tiles[o * C + c] : 0.f;
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
      float* s = coef + p * SP;
      quad_coeffs(row, tx0, ty0, s);
      s[6] = row[5];
      s[7] = row[0];
      s[8] = row[1];
      s[9] = row[2];
      s[10] = row[3];
      s[11] = row[4];
    }
    stage_colors(feat, b, nb, F, C, coef, SP, kBwdCoef);
    __syncthreads();
    unsigned long long mask = 0;
    for (int j = 0; j < nb; ++j) {
      if (__all_sync(kFull, done)) break;
      const float4* r = smem4 + j * (SP / 4);
      // The forward's replay, branch-free. G = expf(min(power, 0)) is the plain
      // version's own form and equals expf(power) wherever the pair is not
      // skipped, so every term below is finite on every lane.
      const float4 q = r[0];
      const float4 h = r[1];  // qyy qxy op mx
      const float power = power_at(q, h.x, h.y, px, py, px2, py2, pp);
      const float G = expf(fminf(power, 0.f));
      const float alpha = fminf(kAlphaSat, __fmul_rn(h.z, G));
      const float one_m = __fsub_rn(1.f, alpha);
      const float test_T = __fmul_rn(T, one_m);
      const bool hit = !done && !(power > 0.f) && !(alpha < kAlphaMin);
      const bool contrib = hit && !(test_T < kTEps);
      done = done || (hit && !contrib);
      if (__any_sync(kFull, contrib)) {  // warp-uniform
        // A lane that does not blend this entry gets w = dL/dalpha = 0, which
        // makes each of its gradient terms exactly zero: no branch, no clearing.
        const float4 m = r[2];  // my ca cb cc
        const float w = contrib ? __fmul_rn(alpha, T) : 0.f;
        float col[MAXC];
#pragma unroll
        for (int k = 0; k < round4(MAXC) / 4; ++k) {
          if (EXACT || 4 * k < C) {
            const float4 cv = r[3 + k];
            const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (4 * k + e < MAXC) col[4 * k + e] = c4[e];
          }
        }
        float cdotg = 0.f;
#pragma unroll
        for (int c = 0; c < MAXC; ++c)
          if (EXACT || c < C) cdotg = fmaf(col[c], gb[c], cdotg);
        Q = fmaf(w, cdotg, Q);
        const float d_alpha =
            contrib ? fmaf(T, cdotg, -__fdividef((tot - Q) + TB, one_m)) : 0.f;
        const float dG = h.z * d_alpha;
        const float dx = h.w - pxa;
        const float dy = m.x - pya;
        const float gdx = G * dx;
        const float gdy = G * dy;
        float v[N];
        v[0] = dG * (-(gdx * m.y + gdy * m.z));
        v[1] = dG * (-(gdy * m.w + gdx * m.z));
        v[2] = -0.5f * gdx * dx * dG;
        v[3] = -(gdx * dy) * dG;
        v[4] = -0.5f * gdy * dy * dG;
        v[5] = G * d_alpha;
#pragma unroll
        for (int c = 0; c < MAXC; ++c) v[6 + c] = w * gb[c];  // gb is 0 past C
        Reduce::reduce(v, lane);
        float* dst = part + (warp * kBwdBatch + j) * F + first;
#pragma unroll
        for (int i = 0; i < Reduce::H5; ++i)
          if (i < count) dst[i] = v[i];
        mask |= 1ull << j;
      }
      if (contrib) T = test_T;
    }
    if (lane == 0) wmask[warp] = mask;
    __syncthreads();
    // Sum the warp partials in warp order; entry j's row is b + j.
    unsigned long long wm[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) wm[w] = wmask[w];
    for (int i = p; i < nb * F; i += kPixels) {
      const int j = i / F;
      const int k = i - j * F;
      float acc = 0.f;
      bool any = false;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if ((wm[w] >> j) & 1ull) {
          acc += part[(w * kBwdBatch + j) * F + k];
          any = true;
        }
      }
      if (any) d_feat[b * F + i] = acc;
    }
  }
}

template <int MAXC, bool EXACT>
cudaError_t launch_bwd(const float* feat, int64_t n_rows, int C, const int64_t* ts,
                       const int64_t* te, const float* g_tiles, const float* total,
                       const float* bterm, const float* tfin, int grid_x, int num_tiles,
                       float* d_feat, cudaStream_t stream) {
  const size_t smem = ((size_t)kBwdBatch * (kBwdCoef + round4(MAXC)) +
                       (size_t)kWarps * kBwdBatch * (6 + C)) * sizeof(float) +
                      kWarps * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(composite_bwd_kernel<MAXC, EXACT>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return err;
  }
  composite_bwd_kernel<MAXC, EXACT><<<num_tiles, kPixels, smem, stream>>>(
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
  switch (C) {
    case 3: return (int)launch<3, true>(f, n_rows, C, ts, te, b, grid_x, num_tiles, o, tf, s);
    case 13: return (int)launch<13, true>(f, n_rows, C, ts, te, b, grid_x, num_tiles, o, tf, s);
    case 21: return (int)launch<21, true>(f, n_rows, C, ts, te, b, grid_x, num_tiles, o, tf, s);
    case 51: return (int)launch<51, true>(f, n_rows, C, ts, te, b, grid_x, num_tiles, o, tf, s);
  }
  if (C >= 1 && C <= 4) return (int)launch<4, false>(f, n_rows, C, ts, te, b, grid_x, num_tiles, o, tf, s);
  if (C >= 1 && C <= 16) return (int)launch<16, false>(f, n_rows, C, ts, te, b, grid_x, num_tiles, o, tf, s);
  if (C >= 1 && C <= 32) return (int)launch<32, false>(f, n_rows, C, ts, te, b, grid_x, num_tiles, o, tf, s);
  if (C >= 1 && C <= 64) return (int)launch<64, false>(f, n_rows, C, ts, te, b, grid_x, num_tiles, o, tf, s);
  return (int)cudaErrorInvalidValue;
}

// Kernel B': packed rows feat [n_rows, 8] f32 (mean2d, conic, opacity, packed
// R|B, G), tile ranges as above, bg [3] f32 -> out_rgb [num_tiles, 256, 3] f32,
// out_tfin [num_tiles, 256] f32. Returns cudaGetLastError().
int r3dgw_composite_forward_packed(const void* feat, int64_t n_rows, const void* tile_start,
                                   const void* tile_end, const void* bg, int grid_x,
                                   int num_tiles, void* out_rgb, void* out_tfin, void* stream) {
  return (int)launch<3, true, true>((const float*)feat, n_rows, 3, (const int64_t*)tile_start,
                                    (const int64_t*)tile_end, (const float*)bg, grid_x,
                                    num_tiles, (float*)out_rgb, (float*)out_tfin,
                                    (cudaStream_t)stream);
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
  switch (C) {
    case 3: return (int)launch_bwd<3, true>(f, n_rows, C, ts, te, g, tot, bt, tf, grid_x, num_tiles, d, s);
    case 13: return (int)launch_bwd<13, true>(f, n_rows, C, ts, te, g, tot, bt, tf, grid_x, num_tiles, d, s);
    case 21: return (int)launch_bwd<21, true>(f, n_rows, C, ts, te, g, tot, bt, tf, grid_x, num_tiles, d, s);
  }
  if (C >= 1 && C <= 4)
    return (int)launch_bwd<4, false>(f, n_rows, C, ts, te, g, tot, bt, tf, grid_x, num_tiles, d, s);
  if (C >= 1 && C <= 16)
    return (int)launch_bwd<16, false>(f, n_rows, C, ts, te, g, tot, bt, tf, grid_x, num_tiles, d, s);
  if (C >= 1 && C <= 32)
    return (int)launch_bwd<32, false>(f, n_rows, C, ts, te, g, tot, bt, tf, grid_x, num_tiles, d, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
