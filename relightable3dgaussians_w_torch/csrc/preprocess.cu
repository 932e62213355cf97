// Preprocess: per Gaussian, the projection of its center, its world and
// screen (EWA) covariance, the conic, the screen radius and the tile rect,
// opacity-tightened where the caller passes opacities (forward, kernel R);
// and the gradients of the positions, scales and rotations, or of a
// precomputed covariance, from those of the centers, conics, depths and world
// covariances (backward, kernel R').
//
// Replaces no TPU kernel: the JAX package leaves `ops/preprocess.py`
// `preprocess` to XLA, which fuses it. On the card the same chain in eager
// PyTorch (ops/preprocess.py `preprocess_plain`, utils/graphics.py
// `covariance_3d`) is ~360 launches over every row, most of them float ops on
// a strided column of an [N, 3], [N, 4] or [N, 6] tensor, and autograd walks
// ~300 nodes back, each column's select a zeros tensor, a strided copy and an
// add. Plain versions: `preprocess_plain` (the unchanged chain) and
// `preprocess_backward_plain` (the same derivation as the backward kernel,
// step for step).
//
// Bitwise equal to the plain chain on the card, every output: each integer
// output feeds the binning or the entry budget, and each float one the
// compositor's predicates. This source is compiled with --fmad=false
// (ops/cuda/build.py), so every product and sum rounds on its own, in the
// plain chain's op order (a 3-term projection summed left to right, then the
// translation). Division, sqrtf, logf, floorf and ceilf are IEEE (no
// fast-math). `1 / x` is a reciprocal, as torch's `Tensor.__rtruediv__`
// computes it (`x.reciprocal() * 1`, the product exact), and a division by
// the tile size a product with its reciprocal, as torch's CUDA division by a
// Python number computes it. torch.maximum, torch.minimum and torch.clamp_min
// return NaN for a NaN operand, which fmaxf does not: `tmax` / `tmin` keep
// torch's rule, and `clampf` torch.clamp's (a NaN passes, and converts to 0).
// Python numbers are rounded to float32 as torch rounds them against a
// float32 tensor (the double literal cast: (float)0.2, not 0.2f, which can
// differ by double rounding); the camera's scalars are computed per block
// from its tensors as the plain chain computes them (focal = width * (1 /
// (2 tan)), lim = 1.3 tan). A float32 -> int32 conversion truncates,
// saturates and maps NaN to 0, as torch's `.to(torch.int32)` on the card.
//
// The backward recomputes the forward from the inputs (nothing else is
// saved). Sub-gradients as torch's autograd takes them: maximum and minimum
// split the gradient in half at a tie, the unselected branch of a where gets
// none, the reciprocal of the homogeneous w and of the determinant pass none
// where the where drops them. The opacity gets no gradient: the rect chain is
// derivative-dead. One thread a row, no sums across rows, no atomics: two
// runs give the same bits. A row whose cotangents are all 0 has all-0
// gradients (the backward is linear in them, and each factor is finite for a
// finite row): it writes zeros, and a tile of such rows (a pool's rows past
// the live ones, rows with no entries) reads none of its inputs.
//
// What bounds it on an H100: bytes. The forward reads 40 bytes a row (45
// with opacities and `active`; 36 and 41 with a precomputed covariance) and
// writes 72 (48 with a precomputed covariance, which it does not write back)
// against ~150 float operations; the backward reads the rows' 40 bytes and
// 20-48 of cotangents and writes 40 against ~350. Design: one thread a row,
// 128 rows a block; every input and output tile of a block that is more
// than one value wide moves through shared memory as one contiguous,
// coalesced run (a thread's own row loads would stride), each thread issuing
// all its loads of a tile before it stores any; the camera sits in shared
// memory. The backward reads its
// cotangents in place with the row strides the caller's tensors have (the
// gather's transpose gives them as column slices of one [N, F] tensor), so
// no copy precedes it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;       // rows a block (one a thread)
// The plain chain's Python numbers, rounded as torch rounds them.
constexpr float kNear = (float)0.2;       // t2 > 0.2: in front of the camera
constexpr float kWEps = (float)1e-7;      // 1 / (p_w + 1e-7)
constexpr float kLowPass = (float)0.3;    // the screen covariance's +0.3
constexpr float kLim = (float)1.3;        // the frustum limit 1.3 tan(fov / 2)
constexpr float kDiscFloor = (float)0.1;  // the eigenvalue discriminant's floor
constexpr float kOpFloor = (float)1e-12;  // the opacity's floor in the tightening
constexpr float kSlack = (float)1.0001;   // the tightened half-extent's slack

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
// torch.clamp(x, lo, hi) with Python bounds: NaN passes.
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
// float32 -> int32 as torch converts on the card (cvt.rzi: truncating,
// saturating, NaN -> 0).
__device__ __forceinline__ int32_t to_i32(float x) { return __float2int_rz(x); }

// Rows row0 .. row0 + rows of a [n, W] tensor, as one contiguous run split
// over the block's threads: fetch issues every load of the thread before any
// value is used, so a tile waits for one memory latency, not one a value;
// put stores them.
template <int W, typename T>
struct Run {
  T v[W];
  __device__ __forceinline__ void fetch(const T* __restrict__ src, int64_t row0, int rows) {
    const T* s = src + row0 * W;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int j = threadIdx.x + k * kThreads;
      if (j < rows * W) v[k] = s[j];
    }
  }
  __device__ __forceinline__ void put(T* dst, int rows) const {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int j = threadIdx.x + k * kThreads;
      if (j < rows * W) dst[j] = v[k];
    }
  }
};

template <int W, typename T>
__device__ __forceinline__ void tile_out(T* __restrict__ dst, const T* src, int64_t row0,
                                         int rows) {
  T* d = dst + row0 * W;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int j = threadIdx.x + k * kThreads;
    if (j < rows * W) d[j] = src[j];
  }
}

// The camera: the view matrix's rows 0-2, the projection's rows 0, 1 and 3,
// and the scalars the plain chain derives from the fields of view.
struct Camera {
  float v[12], p[12];
  float fx, fy, limx, limy, w, h;
};

__device__ __forceinline__ void load_camera(Camera& c, const float* viewmat,
                                            const float* projmat, const float* tanx,
                                            const float* tany, int width, int height) {
  const int t = threadIdx.x;
  if (t < 12) c.v[t] = viewmat[t];
  else if (t < 20) c.p[t - 12] = projmat[t - 12];
  else if (t < 24) c.p[t - 12] = projmat[t - 8];
  else if (t == 24) {
    const float tx = *tanx;
    c.fx = (1.0f / (2.0f * tx)) * (float)width;
    c.limx = kLim * tx;
    c.w = (float)width;
  } else if (t == 25) {
    const float ty = *tany;
    c.fy = (1.0f / (2.0f * ty)) * (float)height;
    c.limy = kLim * ty;
    c.h = (float)height;
  }
}

// Row i of M @ [p, 1], summed left to right (preprocess._affine_row).
__device__ __forceinline__ float affine(const float* m, const float* p) {
  return p[0] * m[0] + p[1] * m[1] + p[2] * m[2] + m[3];
}

// The rotation matrix of a (w, x, y, z) quaternion as it is, unnormalized
// (utils/graphics.py `_rotmat_entries`), row-major.
__device__ __forceinline__ void rotation(const float* q, float* R) {
  const float r = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = 1.f - 2.f * (y * y + z * z);
  R[1] = 2.f * (x * y - r * z);
  R[2] = 2.f * (x * z + r * y);
  R[3] = 2.f * (x * y + r * z);
  R[4] = 1.f - 2.f * (x * x + z * z);
  R[5] = 2.f * (y * z - r * x);
  R[6] = 2.f * (x * z - r * y);
  R[7] = 2.f * (y * z + r * x);
  R[8] = 1.f - 2.f * (x * x + y * y);
}

// The world covariance R diag(s^2) R^T, (xx, xy, xz, yy, yz, zz), s the
// scales times the modifier (utils/graphics.py `covariance_3d`).
__device__ __forceinline__ void covariance(const float* R, const float* s2, float* c) {
  c[0] = R[0] * R[0] * s2[0] + R[1] * R[1] * s2[1] + R[2] * R[2] * s2[2];
  c[1] = R[0] * R[3] * s2[0] + R[1] * R[4] * s2[1] + R[2] * R[5] * s2[2];
  c[2] = R[0] * R[6] * s2[0] + R[1] * R[7] * s2[1] + R[2] * R[8] * s2[2];
  c[3] = R[3] * R[3] * s2[0] + R[4] * R[4] * s2[1] + R[5] * R[5] * s2[2];
  c[4] = R[3] * R[6] * s2[0] + R[4] * R[7] * s2[1] + R[5] * R[8] * s2[2];
  c[5] = R[6] * R[6] * s2[0] + R[7] * R[7] * s2[1] + R[8] * R[8] * s2[2];
}

// The EWA projection of a row (preprocess.compute_cov2d) and its conic, with
// every intermediate the backward needs.
struct Proj {
  float t[3], tz, txtz, tytz, mx_x, mx_y, clx, cly, tx, ty;
  float j00, j02, j11, j12, m0[3], m1[3], vx[3], vy[3];
  float cxx, cxy, cyy, det, di;
  bool det_ok;
};

__device__ __forceinline__ void project(const Camera& c, const float* p, const float* cov,
                                        Proj& o) {
  o.t[0] = affine(c.v, p);
  o.t[1] = affine(c.v + 4, p);
  o.t[2] = affine(c.v + 8, p);
  o.tz = o.t[2] > kNear ? o.t[2] : 1.0f;
  o.txtz = o.t[0] / o.tz;
  o.tytz = o.t[1] / o.tz;
  o.mx_x = tmax(o.txtz, -c.limx);
  o.clx = tmin(o.mx_x, c.limx);
  o.tx = o.clx * o.tz;
  o.mx_y = tmax(o.tytz, -c.limy);
  o.cly = tmin(o.mx_y, c.limy);
  o.ty = o.cly * o.tz;
  const float tz2 = o.tz * o.tz;
  o.j00 = c.fx / o.tz;
  o.j02 = -(c.fx * o.tx) / tz2;
  o.j11 = c.fy / o.tz;
  o.j12 = -(c.fy * o.ty) / tz2;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o.m0[k] = o.j00 * c.v[k] + o.j02 * c.v[8 + k];
    o.m1[k] = o.j11 * c.v[4 + k] + o.j12 * c.v[8 + k];
  }
  const float a = cov[0], b = cov[1], cc = cov[2], d = cov[3], e = cov[4], f = cov[5];
  o.vx[0] = a * o.m0[0] + b * o.m0[1] + cc * o.m0[2];
  o.vx[1] = b * o.m0[0] + d * o.m0[1] + e * o.m0[2];
  o.vx[2] = cc * o.m0[0] + e * o.m0[1] + f * o.m0[2];
  o.vy[0] = a * o.m1[0] + b * o.m1[1] + cc * o.m1[2];
  o.vy[1] = b * o.m1[0] + d * o.m1[1] + e * o.m1[2];
  o.vy[2] = cc * o.m1[0] + e * o.m1[1] + f * o.m1[2];
  o.cxx = o.m0[0] * o.vx[0] + o.m0[1] * o.vx[1] + o.m0[2] * o.vx[2] + kLowPass;
  o.cxy = o.m1[0] * o.vx[0] + o.m1[1] * o.vx[1] + o.m1[2] * o.vx[2];
  o.cyy = o.m1[0] * o.vy[0] + o.m1[1] * o.vy[1] + o.m1[2] * o.vy[2] + kLowPass;
  o.det = o.cxx * o.cyy - o.cxy * o.cxy;
  o.det_ok = o.det != 0.0f;
  o.di = 1.0f / (o.det_ok ? o.det : 1.0f);
}

struct Grid {
  int tile, gx, gy;
  float inv_tile;
};

// clamp(floor(x / tile), 0, hi) as int32 (preprocess._tile_floor).
__device__ __forceinline__ int32_t tile_floor(float x, const Grid& g, int hi) {
  return to_i32(clampf(floorf(x * g.inv_tile), 0.f, (float)hi));
}

template <bool PRECOMP>
__global__ void __launch_bounds__(kThreads) preprocess_forward_kernel(
    const float* __restrict__ means, const float* __restrict__ scales,
    const float* __restrict__ quats, const float* __restrict__ cov_in,
    const float* __restrict__ opac, const uint8_t* __restrict__ active,
    const float* __restrict__ viewmat, const float* __restrict__ projmat,
    const float* __restrict__ tanx, const float* __restrict__ tany, int64_t n, int width,
    int height, Grid g, float mod, float inv_skip, float skip, float* __restrict__ mean2d,
    float* __restrict__ conic, float* __restrict__ depth, float* __restrict__ cov_out,
    int32_t* __restrict__ radius, int32_t* __restrict__ touched,
    int32_t* __restrict__ rect_min, int32_t* __restrict__ rect_max) {
  __shared__ Camera cam;
  __shared__ float s_p[kThreads * 3], s_c[kThreads * 7];   // scales + quats, or cov
  __shared__ float o_m[kThreads * 2], o_c[kThreads * 3], o_cov[kThreads * 6];
  __shared__ int32_t o_lo[kThreads * 2], o_hi[kThreads * 2];
  const int64_t row0 = (int64_t)blockIdx.x * kThreads;
  const int rows = n - row0 < kThreads ? (int)(n - row0) : kThreads;
  const int i = threadIdx.x;
  const int64_t row = row0 + i;
  load_camera(cam, viewmat, projmat, tanx, tany, width, height);
  {
    Run<3, float> a;
    a.fetch(means, row0, rows);
    if constexpr (PRECOMP) {
      Run<6, float> c;
      c.fetch(cov_in, row0, rows);
      a.put(s_p, rows);
      c.put(s_c, rows);
    } else {
      Run<3, float> s;
      Run<4, float> q;
      s.fetch(scales, row0, rows);
      q.fetch(quats, row0, rows);
      a.put(s_p, rows);
      s.put(s_c, rows);
      q.put(s_c + kThreads * 3, rows);
    }
  }
  float op = 0.f;
  bool act = true;
  if (i < rows) {
    if (opac != nullptr) op = opac[row];
    if (active != nullptr) act = active[row] != 0;
  }
  __syncthreads();
  if (i < rows) {
    const float* p = s_p + i * 3;
    float cov[6];
    if constexpr (PRECOMP) {
#pragma unroll
      for (int k = 0; k < 6; ++k) cov[k] = s_c[i * 6 + k];
    } else {
      float R[9], s2[3];
      rotation(s_c + kThreads * 3 + i * 4, R);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float s = mod * s_c[i * 3 + k];
        s2[k] = s * s;
      }
      covariance(R, s2, cov);
#pragma unroll
      for (int k = 0; k < 6; ++k) o_cov[i * 6 + k] = cov[k];
    }
    // The center: NDC through 1 / (w + 1e-7) where in front, then pixels.
    const float ph_x = affine(cam.p, p), ph_y = affine(cam.p + 4, p);
    const float pw = affine(cam.p + 8, p);
    Proj o;
    project(cam, p, cov, o);
    const bool in_front = o.t[2] > kNear;
    const float inv_w = in_front ? 1.0f / (pw + kWEps) : 0.0f;
    const float mx = ((ph_x * inv_w + 1.0f) * cam.w - 1.0f) * 0.5f;
    const float my = ((ph_y * inv_w + 1.0f) * cam.h - 1.0f) * 0.5f;
    o_m[i * 2] = mx;
    o_m[i * 2 + 1] = my;
    o_c[i * 3] = o.cyy * o.di;
    o_c[i * 3 + 1] = -o.cxy * o.di;
    o_c[i * 3 + 2] = o.cxx * o.di;
    depth[row] = o.t[2];

    // The radius and the reference rect (preprocess._rects).
    const float mid = 0.5f * (o.cxx + o.cyy);
    const float disc = sqrtf(tmax(mid * mid - o.det, kDiscFloor));
    const float lambda1 = mid + disc;
    const float radius_f = ceilf(3.0f * sqrtf(tmax(tmax(lambda1, mid - disc), 0.0f)));
    int32_t x0 = tile_floor(mx - radius_f, g, g.gx);
    int32_t y0 = tile_floor(my - radius_f, g, g.gy);
    int32_t x1 = tile_floor(mx + radius_f + (float)g.tile - 1.0f, g, g.gx);
    int32_t y1 = tile_floor(my + radius_f + (float)g.tile - 1.0f, g, g.gy);
    const int32_t area = (x1 - x0) * (y1 - y0);
    const bool alive = in_front && o.det_ok && area > 0 && act;
    radius[row] = alive ? to_i32(radius_f) : 0;
    int32_t count;
    if (opac != nullptr) {
      // The exact opacity-aware tightening, intersected with the reference rect.
      const float tau = sqrtf(tmax(2.0f * logf(inv_skip * tmax(op, kOpFloor)), 0.0f));
      const float bx = tau * sqrtf(tmax(o.cxx, 0.0f)) * kSlack + 0.5f;
      const float by = tau * sqrtf(tmax(o.cyy, 0.0f)) * kSlack + 0.5f;
      const int32_t tx0 = tile_floor(mx - bx, g, g.gx);
      const int32_t ty0 = tile_floor(my - by, g, g.gy);
      const int32_t tx1 = to_i32(clampf(floorf((mx + bx) * g.inv_tile) + 1.0f, 0.f,
                                        (float)g.gx));
      const int32_t ty1 = to_i32(clampf(floorf((my + by) * g.inv_tile) + 1.0f, 0.f,
                                        (float)g.gy));
      x0 = max(x0, tx0);
      y0 = max(y0, ty0);
      x1 = min(x1, tx1);
      y1 = min(y1, ty1);
      const int32_t area_t = max(x1 - x0, 0) * max(y1 - y0, 0);
      count = alive && op >= skip ? area_t : 0;
      x0 = min(x0, x1);
      y0 = min(y0, y1);
    } else {
      count = alive ? area : 0;
    }
    touched[row] = count;
    o_lo[i * 2] = x0;
    o_lo[i * 2 + 1] = y0;
    o_hi[i * 2] = x1;
    o_hi[i * 2 + 1] = y1;
  }
  __syncthreads();
  tile_out<2>(mean2d, o_m, row0, rows);
  tile_out<3>(conic, o_c, row0, rows);
  if constexpr (!PRECOMP) tile_out<6>(cov_out, o_cov, row0, rows);
  tile_out<2>(rect_min, o_lo, row0, rows);
  tile_out<2>(rect_max, o_hi, row0, rows);
}

// d maximum(a, b) / d a and d minimum(a, b) / d a as torch's autograd takes
// them: half at a tie.
__device__ __forceinline__ float dmax(float a, float b) {
  return a > b ? 1.0f : a == b ? 0.5f : 0.0f;
}
__device__ __forceinline__ float dmin(float a, float b) {
  return a < b ? 1.0f : a == b ? 0.5f : 0.0f;
}

// The cotangents of a row: its center, conic, depth and world covariance.
struct Cot {
  float m[2], c[3], d, s[6];
};

template <bool PRECOMP>
__global__ void __launch_bounds__(kThreads) preprocess_backward_kernel(
    const float* __restrict__ means, const float* __restrict__ scales,
    const float* __restrict__ quats, const float* __restrict__ cov_in,
    const float* __restrict__ viewmat, const float* __restrict__ projmat,
    const float* __restrict__ tanx, const float* __restrict__ tany, int64_t n, int width,
    int height, float mod, const float* __restrict__ g_mean2d, int64_t stride_m,
    const float* __restrict__ g_conic, int64_t stride_c, const float* __restrict__ g_depth,
    const float* __restrict__ g_cov, float* __restrict__ d_means,
    float* __restrict__ d_scales, float* __restrict__ d_quats, float* __restrict__ d_cov) {
  __shared__ Camera cam;
  __shared__ float s_p[kThreads * 3], s_c[kThreads * 7];
  // d means; d scales [kThreads, 3] then d quats [kThreads, 4], or d cov [kThreads, 6]
  __shared__ float o_p[kThreads * 3], o_s[kThreads * 7];
  const int64_t row0 = (int64_t)blockIdx.x * kThreads;
  const int rows = n - row0 < kThreads ? (int)(n - row0) : kThreads;
  const int i = threadIdx.x;
  const int64_t row = row0 + i;
  load_camera(cam, viewmat, projmat, tanx, tany, width, height);
  Cot gt = {};
  bool live = false;
  if (i < rows) {
    gt.m[0] = g_mean2d[row * stride_m];
    gt.m[1] = g_mean2d[row * stride_m + 1];
#pragma unroll
    for (int k = 0; k < 3; ++k) gt.c[k] = g_conic[row * stride_c + k];
    if (g_depth != nullptr) gt.d = g_depth[row];
    if (g_cov != nullptr) {
#pragma unroll
      for (int k = 0; k < 6; ++k) gt.s[k] = g_cov[row * 6 + k];
    }
    live = (gt.m[0] != 0.f) | (gt.m[1] != 0.f) | (gt.c[0] != 0.f) | (gt.c[1] != 0.f) |
           (gt.c[2] != 0.f) | (gt.d != 0.f);
#pragma unroll
    for (int k = 0; k < 6; ++k) live |= gt.s[k] != 0.f;
  }
  if (__syncthreads_or(live)) {
    Run<3, float> a;
    a.fetch(means, row0, rows);
    if constexpr (PRECOMP) {
      Run<6, float> c;
      c.fetch(cov_in, row0, rows);
      a.put(s_p, rows);
      c.put(s_c, rows);
    } else {
      Run<3, float> s;
      Run<4, float> q;
      s.fetch(scales, row0, rows);
      q.fetch(quats, row0, rows);
      a.put(s_p, rows);
      s.put(s_c, rows);
      q.put(s_c + kThreads * 3, rows);
    }
    __syncthreads();
  }
  if (i < rows && !live) {
#pragma unroll
    for (int k = 0; k < 3; ++k) o_p[i * 3 + k] = 0.f;
    if constexpr (PRECOMP) {
#pragma unroll
      for (int k = 0; k < 6; ++k) o_s[i * 6 + k] = 0.f;
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) o_s[i * 3 + k] = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) o_s[kThreads * 3 + i * 4 + k] = 0.f;
    }
  } else if (i < rows) {
    const float* p = s_p + i * 3;
    float cov[6], R[9], s[3], s2[3];
    const float* q = s_c + kThreads * 3 + i * 4;
    if constexpr (PRECOMP) {
#pragma unroll
      for (int k = 0; k < 6; ++k) cov[k] = s_c[i * 6 + k];
    } else {
      rotation(q, R);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s[k] = mod * s_c[i * 3 + k];
        s2[k] = s[k] * s[k];
      }
      covariance(R, s2, cov);
    }
    Proj o;
    project(cam, p, cov, o);
    const float* V = cam.v;
    const float* P = cam.p;

    // The center: mean2d = ((u + 1) W - 1) / 2, u = ph * inv_w.
    const bool in_front = o.t[2] > kNear;
    const float ph_x = affine(P, p), ph_y = affine(P + 4, p), pw = affine(P + 8, p);
    const float inv_w = in_front ? 1.0f / (pw + kWEps) : 0.0f;
    const float gu = gt.m[0] * 0.5f * cam.w, gv = gt.m[1] * 0.5f * cam.h;
    const float g_phx = gu * inv_w, g_phy = gv * inv_w;
    const float g_invw = gu * ph_x + gv * ph_y;
    const float g_pw = in_front ? -g_invw * inv_w * inv_w : 0.0f;

    // The conic (cyy, -cxy, cxx) / det, det = cxx cyy - cxy^2.
    float g_cxx = gt.c[2] * o.di, g_cxy = -gt.c[1] * o.di, g_cyy = gt.c[0] * o.di;
    const float g_di = gt.c[0] * o.cyy - gt.c[1] * o.cxy + gt.c[2] * o.cxx;
    const float g_det = o.det_ok ? -g_di * o.di * o.di : 0.0f;
    g_cxx = g_cxx + g_det * o.cyy;
    g_cyy = g_cyy + g_det * o.cxx;
    g_cxy = g_cxy - 2.0f * o.cxy * g_det;

    // The screen covariance: cxx = m0' S m0, cxy = m1' S m0, cyy = m1' S m1.
    // gS[(j, k)] sums the full matrix's (j, k) and (k, j) entries.
    const float* m0 = o.m0;
    const float* m1 = o.m1;
    float gS[6];
    const int J[6] = {0, 0, 0, 1, 1, 2}, K[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
    for (int u = 0; u < 6; ++u) {
      const int j = J[u], k = K[u];
      if (j == k) {
        gS[u] = g_cxx * m0[j] * m0[j] + g_cxy * m1[j] * m0[j] + g_cyy * m1[j] * m1[j];
      } else {
        gS[u] = 2.0f * g_cxx * m0[j] * m0[k] + g_cxy * (m1[j] * m0[k] + m1[k] * m0[j]) +
                2.0f * g_cyy * m1[j] * m1[k];
      }
      gS[u] = gS[u] + gt.s[u];
    }
    float g_m0[3], g_m1[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g_m0[k] = 2.0f * g_cxx * o.vx[k] + g_cxy * o.vy[k];
      g_m1[k] = g_cxy * o.vx[k] + 2.0f * g_cyy * o.vy[k];
    }

    // J: m0 = j00 W0 + j02 W2, m1 = j11 W1 + j12 W2.
    float g_j00 = 0.f, g_j02 = 0.f, g_j11 = 0.f, g_j12 = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g_j00 = g_j00 + g_m0[k] * V[k];
      g_j02 = g_j02 + g_m0[k] * V[8 + k];
      g_j11 = g_j11 + g_m1[k] * V[4 + k];
      g_j12 = g_j12 + g_m1[k] * V[8 + k];
    }
    // j00 = fx / tz, j02 = -fx tx / tz^2, j11 = fy / tz, j12 = -fy ty / tz^2.
    const float tz2 = o.tz * o.tz;
    float g_tz = -(g_j00 * o.j00 + g_j11 * o.j11 + 2.0f * (g_j02 * o.j02 + g_j12 * o.j12)) /
                 o.tz;
    const float g_tx = -(g_j02 * cam.fx) / tz2;
    const float g_ty = -(g_j12 * cam.fy) / tz2;
    // tx = min(max(t0 / tz, -limx), limx) tz.
    g_tz = g_tz + g_tx * o.clx + g_ty * o.cly;
    const float g_txtz = g_tx * o.tz * dmin(o.mx_x, cam.limx) * dmax(o.txtz, -cam.limx);
    const float g_tytz = g_ty * o.tz * dmin(o.mx_y, cam.limy) * dmax(o.tytz, -cam.limy);
    g_tz = g_tz - (g_txtz * o.txtz + g_tytz * o.tytz) / o.tz;
    const float g_t0 = g_txtz / o.tz, g_t1 = g_tytz / o.tz;
    const float g_t2 = (in_front ? g_tz : 0.0f) + gt.d;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o_p[i * 3 + k] = g_t0 * V[k] + g_t1 * V[4 + k] + g_t2 * V[8 + k] + g_phx * P[k] +
                       g_phy * P[4 + k] + g_pw * P[8 + k];
    }

    if constexpr (PRECOMP) {
#pragma unroll
      for (int u = 0; u < 6; ++u) o_s[i * 6 + u] = gS[u];
    } else {
      // S = R diag(s^2) R', s = mod * scale.
      const float gxx = gS[0], gxy = gS[1], gxz = gS[2], gyy = gS[3], gyz = gS[4], gzz = gS[5];
      float gR[9];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float r0 = R[k], r1 = R[3 + k], r2 = R[6 + k];
        const float g_s2 = gxx * r0 * r0 + gxy * r0 * r1 + gxz * r0 * r2 + gyy * r1 * r1 +
                           gyz * r1 * r2 + gzz * r2 * r2;
        o_s[i * 3 + k] = g_s2 * 2.0f * s[k] * mod;
        gR[k] = s2[k] * (2.0f * gxx * r0 + gxy * r1 + gxz * r2);
        gR[3 + k] = s2[k] * (gxy * r0 + 2.0f * gyy * r1 + gyz * r2);
        gR[6 + k] = s2[k] * (gxz * r0 + gyz * r1 + 2.0f * gzz * r2);
      }
      // The rotation's entries in the quaternion (w, x, y, z).
      const float w = q[0], x = q[1], y = q[2], z = q[3];
      float* gq = o_s + kThreads * 3 + i * 4;
      gq[0] = 2.0f * (-z * gR[1] + y * gR[2] + z * gR[3] - x * gR[5] - y * gR[6] + x * gR[7]);
      gq[1] = 2.0f * (y * gR[1] + z * gR[2] + y * gR[3] - 2.0f * x * gR[4] - w * gR[5] +
                      z * gR[6] + w * gR[7] - 2.0f * x * gR[8]);
      gq[2] = 2.0f * (-2.0f * y * gR[0] + x * gR[1] + w * gR[2] + x * gR[3] + z * gR[5] -
                      w * gR[6] + z * gR[7] - 2.0f * y * gR[8]);
      gq[3] = 2.0f * (-2.0f * z * gR[0] - w * gR[1] + x * gR[2] + w * gR[3] -
                      2.0f * z * gR[4] + y * gR[5] + x * gR[6] + y * gR[7]);
    }
  }
  __syncthreads();
  tile_out<3>(d_means, o_p, row0, rows);
  if constexpr (PRECOMP) {
    tile_out<6>(d_cov, o_s, row0, rows);
  } else {
    tile_out<3>(d_scales, o_s, row0, rows);
    tile_out<4>(d_quats, o_s + kThreads * 3, row0, rows);
  }
}

}  // namespace
extern "C" {

const char* r3dgw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// in: means3d [n, 3], scales [n, 3], quats [n, 4] (null with a precomputed
// covariance), cov3d_precomp [n, 6] or null, opacities [n] or null, active
// [n] bool or null, viewmat [4, 4], projmat [4, 4], tan_fovx [], tan_fovy []
// (float32, contiguous, on the card). out: mean2d [n, 2], conic [n, 3], depth
// [n], cov3d [n, 6] (not written with a precomputed covariance), radius [n],
// tiles_touched [n], rect_min [n, 2], rect_max [n, 2] (int32). scale_modifier,
// 1 / skip_alpha and skip_alpha are rounded to float as torch rounds them.
// Returns cudaGetLastError().
int r3dgw_preprocess_forward(const void* const* in, int64_t n, int width, int height, int tile,
                             float scale_modifier, float inv_skip, float skip,
                             void* const* out, void* stream) {
  if (n < 0 || tile <= 0 || width <= 0 || height <= 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Grid g{tile, (width + tile - 1) / tile, (height + tile - 1) / tile, 1.0f / (float)tile};
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const bool precomp = in[3] != nullptr;
  auto f = precomp ? preprocess_forward_kernel<true> : preprocess_forward_kernel<false>;
  f<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)in[0], (const float*)in[1], (const float*)in[2], (const float*)in[3],
      (const float*)in[4], (const uint8_t*)in[5], (const float*)in[6], (const float*)in[7],
      (const float*)in[8], (const float*)in[9], n, width, height, g, scale_modifier, inv_skip,
      skip, (float*)out[0], (float*)out[1], (float*)out[2], (float*)out[3], (int32_t*)out[4],
      (int32_t*)out[5], (int32_t*)out[6], (int32_t*)out[7]);
  return (int)cudaGetLastError();
}

// in: as the forward's (opacities and active unread). Cotangents: g_mean2d
// [n, 2] and g_conic [n, 3] with row strides stride_m and stride_c (in
// floats; the last stride 1), g_depth [n] or null, g_cov3d [n, 6] or null.
// grads: d_means3d [n, 3], then d_scales [n, 3] and d_quats [n, 4], or
// d_cov3d_precomp [n, 6] with a precomputed covariance (the others null).
int r3dgw_preprocess_backward(const void* const* in, int64_t n, int width, int height,
                              float scale_modifier, const void* g_mean2d, int64_t stride_m,
                              const void* g_conic, int64_t stride_c, const void* g_depth,
                              const void* g_cov, void* const* grads, void* stream) {
  if (n < 0 || width <= 0 || height <= 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const bool precomp = in[3] != nullptr;
  auto f = precomp ? preprocess_backward_kernel<true> : preprocess_backward_kernel<false>;
  f<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)in[0], (const float*)in[1], (const float*)in[2], (const float*)in[3],
      (const float*)in[6], (const float*)in[7], (const float*)in[8], (const float*)in[9], n,
      width, height, scale_modifier, (const float*)g_mean2d, stride_m, (const float*)g_conic,
      stride_c, (const float*)g_depth, (const float*)g_cov, (float*)grads[0], (float*)grads[1],
      (float*)grads[2], (float*)grads[3]);
  return (int)cudaGetLastError();
}

}  // extern "C"
