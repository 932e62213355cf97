// Per-Gaussian shading: the feature channels of every pool row (forward) and
// their gradient (backward), in one pass over the rows each.
//
// Replaces no TPU kernel: the JAX package leaves `renderer.compute_colors` to
// XLA, which fuses it. On the card the same chain in eager PyTorch is ~150
// launches over every row (the SH basis `torch.stack`, the Cook-Torrance ops,
// the channels' `torch.cat`), and autograd walks as many nodes back. Plain
// versions: ops/shading.py `shade_rows_plain` (the unchanged chain of
// renderer.compute_colors, models/light.py `shade`, utils/sh.py and
// ops/texture.py `bilinear_sample_packed`) and `shade_rows_backward_plain`
// (the same derivation as shade_backward_kernel, line for line).
//
// Per row, in float32: the sigmoids of albedo, roughness and metalness; the
// normal (the quaternion normalized twice, as get_rotation and quat_to_rotmat
// do, the rotation column of the smallest scale, first minimum wins, flipped
// toward the viewer); the degree-2 irradiance (floor 1e-4); wo, the
// reflection vector and n.v (floor 1e-4); the FG LUT's clamped bilinear
// sample (texel centres, left/top border fraction zeroed); the SH basis of
// the envlight degree times the Gauss-Weierstrass band factor, contracted
// with the envlight as a plain float32 sum (no TF32 can reach it); F0, the
// split-sum reflectivity, the three gamma corrections. Sky rows take the sky
// SH colour (+0.5, clamped at 0), or white under fix_sky. A row computes only
// the branch it takes: torch.where over both gives the same values, and zero
// gradient to the branch it drops.
//
// Layouts (renderer.py's docstring): 3 (rgb), 13 (+ diffuse, specular, depth,
// normal * 0.5 + 0.5) or 21 (+ sky colour, roughness, metalness, albedo). The
// depth channel is the view depth where the caller passes the view matrix's
// third row, else 0. Normals [n, 3] are written only where asked for.
//
// The backward recomputes the forward from the inputs (nothing else is
// saved) and writes the gradients of xyz, rotation, albedo, roughness and
// metalness per row; scaling has none (the smallest-axis choice is a
// comparison). Sub-gradients as torch's: clamp and clamp_min pass the gradient
// at equality, floor passes none, the unselected branch of a where gets none.
// The envlight's and the sky SH's gradients are sums over all rows: each
// thread keeps its rows' sums in its column of shared memory, each block
// reduces them in a fixed order (warp shuffles, then the warps in turn) into
// one partial row, and reduce_partials_kernel sums the partial rows in a
// fixed order. No atomics: two runs give the same bits.
//
// What bounds it on an H100: bytes in the forward (~61 read and 12-84
// written a row against ~400 float operations), and in the backward too
// (~161 bytes a row at 13 channels against ~1,200 operations) were its
// registers not the limit. Design: one thread a row, 128 rows a block;
// every input and output tile of the block moves through shared memory as
// contiguous, coalesced runs (a row is 3-21 floats, so a thread's own row
// loads would stride), each thread issuing all its loads of a tile before
// it stores any (one memory latency a tile, not one a value); the envlight,
// the sky SH and the camera sit in shared memory; the LUT (2 MB) stays in L2
// and a row reads its quad with two float4 loads. The SH degrees are
// template parameters and the basis is walked term by term (`sh_terms`), so
// no array of it is held. The backward's row holds ~270 values: its
// envlight and sky sums live in shared memory rather than registers, which
// buys 3 blocks an SM at 168 registers (some spill); it is a grid of at most
// kBwdBlocks blocks that each walk tiles, so the partial rows stay few, and
// rows with all-zero cotangents (most of a training pool's) skip the work.
// Built without --use_fast_math: expf, powf, sqrtf and division are IEEE.
// The chain into the normal's flip test (dir_pp_n, both normalizations of the
// quaternion, the rotation column, the dot product) and the view depth round
// each product and sum as the plain version's separate ops do on the card
// (__fmul_rn / __fadd_rn, rsqrtf as torch.rsqrt): the flip is a sign test.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;    // rows a block (one a thread)
constexpr int kBwdBlocks = 4096; // at most this many blocks (partial rows) in the backward
constexpr int kBwdBlocksPerSm = 3; // the backward's occupancy target (registers <= 168)
constexpr int kLut = 256;        // the FG LUT is [kLut, kLut, 8]: 4 texels x (F, G)
constexpr float kEps = 1e-20f;   // safe_normalize's floor of |x|^2
constexpr float kFloor = 1e-4f;  // irradiance, specular irradiance and n.v floors
// torch raises a float32 tensor to the double 1 / 2.2 as the float nearest it
// (0.45454547), not 1 / 2.2f (0.45454544); the gradient's exponent likewise.
constexpr float kInvGamma = (float)(1.0 / 2.2);
constexpr float kInvGammaM1 = (float)(1.0 / 2.2 - 1.0);

// utils/sh.py's constants, as float32 (SH_Cl_k is its Cl[k]).
constexpr float SH_C0 = 0.28209479177387814f;
constexpr float SH_C1 = 0.4886025119029199f;
constexpr float SH_C2_0 = 1.0925484305920792f;
constexpr float SH_C2_1 = -1.0925484305920792f;
constexpr float SH_C2_2 = 0.31539156525252005f;
constexpr float SH_C2_3 = -1.0925484305920792f;
constexpr float SH_C2_4 = 0.5462742152960396f;
constexpr float SH_C3_0 = -0.5900435899266435f;
constexpr float SH_C3_1 = 2.890611442640554f;
constexpr float SH_C3_2 = -0.4570457994644658f;
constexpr float SH_C3_3 = 0.3731763325901154f;
constexpr float SH_C3_4 = -0.4570457994644658f;
constexpr float SH_C3_5 = 1.445305721320277f;
constexpr float SH_C3_6 = -0.5900435899266435f;
constexpr float SH_C4_0 = 2.5033429417967046f;
constexpr float SH_C4_1 = -1.7701307697799304f;
constexpr float SH_C4_2 = 0.9461746957575601f;
constexpr float SH_C4_3 = -0.6690465435572892f;
constexpr float SH_C4_4 = 0.10578554691520431f;
constexpr float SH_C4_5 = -0.6690465435572892f;
constexpr float SH_C4_6 = 0.47308734787878004f;
constexpr float SH_C4_7 = -1.7701307697799304f;
constexpr float SH_C4_8 = 0.6258357354491761f;
constexpr float SH_C5_0 = -0.6563820568401703f;
constexpr float SH_C5_1 = 8.302649259524165f;
constexpr float SH_C5_2 = -0.48923829943525043f;
constexpr float SH_C5_3 = 4.793536784973324f;
constexpr float SH_C5_4 = -0.452946651195697f;
constexpr float SH_C5_5 = 0.1169503224534236f;
constexpr float SH_C5_6 = -0.452946651195697f;
constexpr float SH_C5_7 = 2.3967683924866f;
constexpr float SH_C5_8 = -0.48923829943525043f;
constexpr float SH_C5_9 = 2.075662314881041f;
constexpr float SH_C5_10 = -0.6563820568401701f;

// models/light.py's Ramamoorthi-Hanrahan constants (2 * C computed in double,
// as Python does, then rounded).
constexpr float IR_C1 = 0.429043f, IR_2C1 = (float)(2 * 0.429043);
constexpr float IR_2C2 = (float)(2 * 0.511664);
constexpr float IR_C3 = 0.743125f, IR_C4 = 0.886227f, IR_C5 = 0.247708f;

template <int DEG>
struct Sh {
  static constexpr int K = (DEG + 1) * (DEG + 1);
};

// The band l of SH coefficient k.
__host__ __device__ constexpr int band(int k) {
  return k < 1 ? 0 : k < 4 ? 1 : k < 9 ? 2 : k < 16 ? 3 : k < 25 ? 4 : 5;
}

// One thread's column of a [P, kThreads] shared-memory table: its running
// sums, apart from every other thread's and free of bank conflicts.
struct Column {
  float* p;
  __device__ __forceinline__ float& operator[](int j) const { return p[j * kThreads]; }
};

// Each term of the real SH basis of degree DEG at (x, y, z) (utils/sh.py
// `sh_basis`, term by term) with its partial derivatives (ops/shading.py
// `sh_basis_vjp`): f.template term<k>(Y_k, dY_k/dx, dY_k/dy, dY_k/dz), k in
// order. Once inlined, a caller that reads no derivative computes none, and
// no array of the basis is held: each term is used as it is made.
template <int DEG, typename F>
__device__ __forceinline__ void sh_terms(float x, float y, float z, F& f) {
  f.template term<0>(SH_C0, 0.f, 0.f, 0.f);
  if constexpr (DEG > 0) {
    f.template term<1>(-SH_C1 * y, 0.f, -SH_C1, 0.f);
    f.template term<2>(SH_C1 * z, 0.f, 0.f, SH_C1);
    f.template term<3>(-SH_C1 * x, -SH_C1, 0.f, 0.f);
  }
  if constexpr (DEG > 1) {
    const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, yz = y * z, xz = x * z;
    f.template term<4>(SH_C2_0 * xy, SH_C2_0 * y, SH_C2_0 * x, 0.f);
    f.template term<5>(SH_C2_1 * yz, 0.f, SH_C2_1 * z, SH_C2_1 * y);
    f.template term<6>(SH_C2_2 * (2.f * zz - xx - yy), SH_C2_2 * -2 * x, SH_C2_2 * -2 * y,
                       SH_C2_2 * 4 * z);
    f.template term<7>(SH_C2_3 * xz, SH_C2_3 * z, 0.f, SH_C2_3 * x);
    f.template term<8>(SH_C2_4 * (xx - yy), SH_C2_4 * 2 * x, SH_C2_4 * -2 * y, 0.f);
    if constexpr (DEG > 2) {
      f.template term<9>(SH_C3_0 * y * (3 * xx - yy), SH_C3_0 * 6 * xy, SH_C3_0 * (3 * xx - 3 * yy),
                         0.f);
      f.template term<10>(SH_C3_1 * xy * z, SH_C3_1 * yz, SH_C3_1 * xz, SH_C3_1 * xy);
      f.template term<11>(SH_C3_2 * y * (4 * zz - xx - yy), SH_C3_2 * -2 * xy,
                          SH_C3_2 * (4 * zz - xx - 3 * yy), SH_C3_2 * 8 * yz);
      f.template term<12>(SH_C3_3 * z * (2 * zz - 3 * xx - 3 * yy), SH_C3_3 * -6 * xz,
                          SH_C3_3 * -6 * yz, SH_C3_3 * (6 * zz - 3 * xx - 3 * yy));
      f.template term<13>(SH_C3_4 * x * (4 * zz - xx - yy), SH_C3_4 * (4 * zz - 3 * xx - yy),
                          SH_C3_4 * -2 * xy, SH_C3_4 * 8 * xz);
      f.template term<14>(SH_C3_5 * z * (xx - yy), SH_C3_5 * 2 * xz, SH_C3_5 * -2 * yz,
                          SH_C3_5 * (xx - yy));
      f.template term<15>(SH_C3_6 * x * (xx - 3 * yy), SH_C3_6 * (3 * xx - 3 * yy),
                          SH_C3_6 * -6 * xy, 0.f);
    }
    if constexpr (DEG > 3) {
      f.template term<16>(SH_C4_0 * xy * (xx - yy), SH_C4_0 * y * (3 * xx - yy),
                          SH_C4_0 * x * (xx - 3 * yy), 0.f);
      f.template term<17>(SH_C4_1 * yz * (3 * xx - yy), SH_C4_1 * 6 * xy * z,
                          SH_C4_1 * z * (3 * xx - 3 * yy), SH_C4_1 * y * (3 * xx - yy));
      f.template term<18>(SH_C4_2 * xy * (7 * zz - 1), SH_C4_2 * y * (7 * zz - 1),
                          SH_C4_2 * x * (7 * zz - 1), SH_C4_2 * 14 * xy * z);
      f.template term<19>(SH_C4_3 * yz * (7 * zz - 3), 0.f, SH_C4_3 * z * (7 * zz - 3),
                          SH_C4_3 * y * (21 * zz - 3));
      f.template term<20>(SH_C4_4 * (zz * (35 * zz - 30) + 3), 0.f, 0.f,
                          SH_C4_4 * z * (140 * zz - 60));
      f.template term<21>(SH_C4_5 * xz * (7 * zz - 3), SH_C4_5 * z * (7 * zz - 3), 0.f,
                          SH_C4_5 * x * (21 * zz - 3));
      f.template term<22>(SH_C4_6 * (xx - yy) * (7 * zz - 1), SH_C4_6 * 2 * x * (7 * zz - 1),
                          SH_C4_6 * -2 * y * (7 * zz - 1), SH_C4_6 * 14 * z * (xx - yy));
      f.template term<23>(SH_C4_7 * xz * (xx - 3 * yy), SH_C4_7 * z * (3 * xx - 3 * yy),
                          SH_C4_7 * -6 * xy * z, SH_C4_7 * x * (xx - 3 * yy));
      f.template term<24>(SH_C4_8 * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
                          SH_C4_8 * 4 * x * (xx - 3 * yy), SH_C4_8 * 4 * y * (yy - 3 * xx), 0.f);
    }
    if constexpr (DEG > 4) {
      f.template term<25>(SH_C5_0 * y * (5 * xx * xx - 10 * yy * xx + yy * yy),
                          SH_C5_0 * 20 * xy * (xx - yy),
                          SH_C5_0 * (5 * xx * xx - 30 * xx * yy + 5 * yy * yy), 0.f);
      f.template term<26>(SH_C5_1 * xy * z * (xx - yy), SH_C5_1 * yz * (3 * xx - yy),
                          SH_C5_1 * xz * (xx - 3 * yy), SH_C5_1 * xy * (xx - yy));
      f.template term<27>(SH_C5_2 * y * (9 * zz - 1) * (3 * xx - yy),
                          SH_C5_2 * 6 * xy * (9 * zz - 1),
                          SH_C5_2 * (9 * zz - 1) * (3 * xx - 3 * yy),
                          SH_C5_2 * 18 * yz * (3 * xx - yy));
      f.template term<28>(SH_C5_3 * xy * z * (3 * zz - 1), SH_C5_3 * yz * (3 * zz - 1),
                          SH_C5_3 * xz * (3 * zz - 1), SH_C5_3 * xy * (9 * zz - 1));
      f.template term<29>(SH_C5_4 * y * (zz * (-14 + 21 * zz) + 1), 0.f,
                          SH_C5_4 * (zz * (-14 + 21 * zz) + 1), SH_C5_4 * yz * (84 * zz - 28));
      f.template term<30>(SH_C5_5 * z * (zz * (63 * zz - 70) + 15), 0.f, 0.f,
                          SH_C5_5 * (zz * (315 * zz - 210) + 15));
      f.template term<31>(SH_C5_6 * x * (zz * (21 * zz - 14) + 1),
                          SH_C5_6 * (zz * (21 * zz - 14) + 1), 0.f,
                          SH_C5_6 * xz * (84 * zz - 28));
      f.template term<32>(SH_C5_7 * z * (xx - yy) * (-1 + 3 * zz),
                          SH_C5_7 * 2 * xz * (3 * zz - 1), SH_C5_7 * -2 * yz * (3 * zz - 1),
                          SH_C5_7 * (xx - yy) * (9 * zz - 1));
      f.template term<33>(SH_C5_8 * x * (xx - 3 * yy) * (-1 + 9 * zz),
                          SH_C5_8 * (9 * zz - 1) * (3 * xx - 3 * yy),
                          SH_C5_8 * (9 * zz - 1) * -6 * xy, SH_C5_8 * 18 * xz * (xx - 3 * yy));
      f.template term<34>(SH_C5_9 * z * (xx * (xx - 6 * yy) + yy * yy),
                          SH_C5_9 * 4 * xz * (xx - 3 * yy), SH_C5_9 * 4 * yz * (yy - 3 * xx),
                          SH_C5_9 * (xx * (xx - 6 * yy) + yy * yy));
      f.template term<35>(SH_C5_10 * x * (xx * (xx - 10 * yy) + 5 * yy * yy),
                          SH_C5_10 * (5 * xx * xx - 30 * xx * yy + 5 * yy * yy),
                          SH_C5_10 * 20 * xy * (yy - xx), 0.f);
    }
  }
}

// sum_k Y_k w_k c[k] for three channels of a row-major [K, 3] table c, w_k
// the Gauss-Weierstrass factor gk of k's band (BANDS) or 1.
template <bool BANDS>
struct Contract {
  const float* c;
  const float* gk;
  float out[3];
  template <int K>
  __device__ __forceinline__ void term(float Y, float, float, float) {
    const float w = BANDS ? Y * gk[band(K)] : Y;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) out[ch] += w * c[K * 3 + ch];
  }
};

// The gradient of Contract's sums from their cotangents g[3]: the table's
// (into the thread's row sums acc [K * 3]), the direction's (dir[3]) and, with
// BANDS, the roughness's through the band factors exp(-l(l+1) * 0.3 * kr).
template <bool BANDS>
struct ContractGrad {
  const float* c;
  const float* gk;
  const float* g;
  Column acc;
  float dir[3];
  float dkr;
  template <int K>
  __device__ __forceinline__ void term(float Y, float dx, float dy, float dz) {
    constexpr int l = band(K);
    const float w = BANDS ? gk[l] : 1.f;
    const float kk = Y * w;
    float gkk = 0.f;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      acc[K * 3 + ch] += kk * g[ch];
      gkk += g[ch] * c[K * 3 + ch];
    }
    const float gY = gkk * w;
    dir[0] += gY * dx;
    dir[1] += gY * dy;
    dir[2] += gY * dz;
    if (BANDS) dkr += gkk * Y * w * (-(float)(l * (l + 1)) * 0.3f);
  }
};

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// utils/sh.py `gamma_correction` and its derivative (clamp passes at equality).
__device__ __forceinline__ float gamma_fwd(float x) {
  return powf(fminf(fmaxf(x, 0.f), 1.f) + 1e-4f, kInvGamma);
}
__device__ __forceinline__ float gamma_grad(float x) {
  if (!(x >= 0.f && x <= 1.f)) return 0.f;
  return kInvGamma * powf(x + 1e-4f, kInvGammaM1);
}

// sum(a * b) over 3, each product and sum rounded on its own, in order.
__device__ __forceinline__ float dot3_rn(const float* a, const float* b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a[0], b[0]), __fmul_rn(a[1], b[1])), __fmul_rn(a[2], b[2]));
}

__device__ __forceinline__ float sum4_sq_rn(const float* a) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a[0], a[0]), __fmul_rn(a[1], a[1])),
                             __fmul_rn(a[2], a[2])),
                   __fmul_rn(a[3], a[3]));
}

// 2 * (a * b + c * d)
__device__ __forceinline__ float rn2sum(float a, float b, float c, float d) {
  return __fmul_rn(2.f, __fadd_rn(__fmul_rn(a, b), __fmul_rn(c, d)));
}
// 2 * (a * b - c * d)
__device__ __forceinline__ float rn2dif(float a, float b, float c, float d) {
  return __fmul_rn(2.f, __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d)));
}
// 1 - 2 * (a * a + b * b)
__device__ __forceinline__ float rn1m2(float a, float b) {
  return __fsub_rn(1.f, __fmul_rn(2.f, __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b))));
}
// Column `ax` of the rotation matrix of the unit quaternion q = (r, x, y, z)
// (utils/graphics.py `_rotmat_entries`), each product and sum rounded as the
// plain version's separate ops round it: the flip's sign test reads it.
__device__ __forceinline__ void rot_column(const float* q, int ax, float* col) {
  const float r = q[0], x = q[1], y = q[2], z = q[3];
  if (ax == 0) {
    col[0] = rn1m2(y, z); col[1] = rn2sum(x, y, r, z); col[2] = rn2dif(x, z, r, y);
  } else if (ax == 1) {
    col[0] = rn2dif(x, y, r, z); col[1] = rn1m2(x, z); col[2] = rn2sum(y, z, r, x);
  } else {
    col[0] = rn2sum(x, z, r, y); col[1] = rn2dif(y, z, r, x); col[2] = rn1m2(x, y);
  }
}

// g_q = (d col / d q)^T g_col for rot_column.
__device__ __forceinline__ void rot_column_vjp(const float* q, int ax, const float* g, float* gq) {
  const float r = q[0], x = q[1], y = q[2], z = q[3];
  const float a = g[0], b = g[1], c = g[2];
  if (ax == 0) {
    gq[0] = 2 * (z * b - y * c);
    gq[1] = 2 * (y * b + z * c);
    gq[2] = -4 * y * a + 2 * (x * b - r * c);
    gq[3] = -4 * z * a + 2 * (r * b + x * c);
  } else if (ax == 1) {
    gq[0] = 2 * (x * c - z * a);
    gq[1] = 2 * (y * a + r * c) - 4 * x * b;
    gq[2] = 2 * (x * a + z * c);
    gq[3] = 2 * (y * c - r * a) - 4 * z * b;
  } else {
    gq[0] = 2 * (y * a - x * b);
    gq[1] = 2 * (z * a - r * b) - 4 * x * c;
    gq[2] = 2 * (r * a + z * b) - 4 * y * c;
    gq[3] = 2 * (x * a + y * b);
  }
}

// The block's copy of the per-call constants.
template <int KE, int KS>
struct Consts {
  float base[KE * 3];
  float sky[KS * 3];
  float cam[3];
  float vrow[4];
};

template <int KE, int KS>
__device__ __forceinline__ void load_consts(Consts<KE, KS>& s, const float* base,
                                            const float* sky, const float* cam,
                                            const float* vrow) {
  for (int i = threadIdx.x; i < KE * 3; i += blockDim.x) s.base[i] = base[i];
  for (int i = threadIdx.x; i < KS * 3; i += blockDim.x) s.sky[i] = sky[i];
  if (threadIdx.x < 3) s.cam[threadIdx.x] = cam[threadIdx.x];
  if (threadIdx.x < 4) s.vrow[threadIdx.x] = vrow != nullptr ? vrow[threadIdx.x] : 0.f;
}

// Rows row0 .. row0 + rows of a [n, W] tensor, as one contiguous run split
// over the block's threads (at most MAXW values a thread, W <= MAXW): fetch
// issues every load of the thread before any value is used, so a tile waits
// for one memory latency, not one a value; put stores them.
template <int MAXW, typename T>
struct Run {
  T v[MAXW];
  __device__ __forceinline__ void fetch(const T* __restrict__ src, int64_t row0, int rows, int W) {
    const T* s = src + row0 * W;
#pragma unroll
    for (int k = 0; k < MAXW; ++k) {
      const int j = threadIdx.x + k * kThreads;
      if (k < W && j < rows * W) v[k] = s[j];
    }
  }
  __device__ __forceinline__ void put(T* dst, int rows, int W) const {
#pragma unroll
    for (int k = 0; k < MAXW; ++k) {
      const int j = threadIdx.x + k * kThreads;
      if (k < W && j < rows * W) dst[j] = v[k];
    }
  }
};

// Shared-memory tile in (all loads in flight together) and out.
template <int MAXW, typename T>
__device__ __forceinline__ void tile_in(T* dst, const T* __restrict__ src, int64_t row0, int rows,
                                        int W = MAXW) {
  Run<MAXW, T> r;
  r.fetch(src, row0, rows, W);
  r.put(dst, rows, W);
}
template <int MAXW>
__device__ __forceinline__ void tile_out(float* __restrict__ dst, const float* src, int64_t row0,
                                         int rows, int W = MAXW) {
  float* d = dst + row0 * W;
#pragma unroll
  for (int k = 0; k < MAXW; ++k) {
    const int j = threadIdx.x + k * kThreads;
    if (k < W && j < rows * W) d[j] = src[j];
  }
}

// The staged inputs of a block's rows.
struct InTile {
  float xyz[kThreads * 3];
  float rot[kThreads * 4];
  float scl[kThreads * 3];
  float alb[kThreads * 3];
  float rough[kThreads];
  float metal[kThreads];
  uint8_t sky[kThreads];
};

__device__ __forceinline__ void load_tile(InTile& t, const float* xyz, const float* rot,
                                          const float* scl, const float* alb, const float* rough,
                                          const float* metal, const uint8_t* sky, int64_t row0,
                                          int rows) {
  Run<3, float> a, c, e;
  Run<4, float> b;
  Run<1, float> f, g;
  Run<1, uint8_t> h;
  a.fetch(xyz, row0, rows, 3);
  b.fetch(rot, row0, rows, 4);
  c.fetch(scl, row0, rows, 3);
  e.fetch(alb, row0, rows, 3);
  f.fetch(rough, row0, rows, 1);
  g.fetch(metal, row0, rows, 1);
  h.fetch(sky, row0, rows, 1);
  a.put(t.xyz, rows, 3);
  b.put(t.rot, rows, 4);
  c.put(t.scl, rows, 3);
  e.put(t.alb, rows, 3);
  f.put(t.rough, rows, 1);
  g.put(t.metal, rows, 1);
  h.put(t.sky, rows, 1);
}

// Everything of a row up to the branch: the forward's first half, which the
// backward recomputes.
struct Geometry {
  float alb[3], kr, km;
  float dn[3];                   // dir_pp_n
  int ax;
  float flip;                    // +1 or -1
  float n[3];
  bool sky;
};

// dir_pp = xyz - campos, its clamped |.|^2 and root, dir_pp_n: light.py's
// x / sqrt(max(|x|^2, eps)).
struct Dir {
  float d[3], sd, dden, dn[3];
};

template <int KE, int KS>
__device__ __forceinline__ void direction(const InTile& t, int i, const Consts<KE, KS>& s,
                                          Dir& r) {
#pragma unroll
  for (int c = 0; c < 3; ++c) r.d[c] = __fsub_rn(t.xyz[i * 3 + c], s.cam[c]);
  r.sd = dot3_rn(r.d, r.d);
  r.dden = sqrtf(fmaxf(r.sd, kEps));
#pragma unroll
  for (int c = 0; c < 3; ++c) r.dn[c] = __fdiv_rn(r.d[c], r.dden);
}

// get_rotation, then quat_to_rotmat's own normalization: q * rsqrt(max(|q|^2,
// eps)) twice, rounded as the plain version's ops on the card (torch.rsqrt is
// rsqrtf). The backward makes it again at its end rather than hold it.
struct Quat {
  float q[4], sq1, rs1, q1[4], sq2, rs2, qn[4];
};

__device__ __forceinline__ void quaternion(const InTile& t, int i, Quat& r) {
#pragma unroll
  for (int c = 0; c < 4; ++c) r.q[c] = t.rot[i * 4 + c];
  r.sq1 = sum4_sq_rn(r.q);
  r.rs1 = rsqrtf(fmaxf(r.sq1, kEps));
#pragma unroll
  for (int c = 0; c < 4; ++c) r.q1[c] = __fmul_rn(r.q[c], r.rs1);
  r.sq2 = sum4_sq_rn(r.q1);
  r.rs2 = rsqrtf(fmaxf(r.sq2, kEps));
#pragma unroll
  for (int c = 0; c < 4; ++c) r.qn[c] = __fmul_rn(r.q1[c], r.rs2);
}

template <int KE, int KS>
__device__ __forceinline__ void geometry(const InTile& t, int i, const Consts<KE, KS>& s,
                                         Geometry& g) {
#pragma unroll
  for (int c = 0; c < 3; ++c) g.alb[c] = sigmoid(t.alb[i * 3 + c]);
  g.kr = sigmoid(t.rough[i]);
  g.km = sigmoid(t.metal[i]);
  g.sky = t.sky[i] != 0;
  Dir r;
  direction(t, i, s, r);
#pragma unroll
  for (int c = 0; c < 3; ++c) g.dn[c] = r.dn[c];
  Quat q;
  quaternion(t, i, q);
  // get_minimum_axis on exp(scaling): the first minimum wins
  const float e0 = expf(t.scl[i * 3]), e1 = expf(t.scl[i * 3 + 1]), e2 = expf(t.scl[i * 3 + 2]);
  const bool first01 = e0 <= e1;
  g.ax = (first01 ? e0 : e1) <= e2 ? (first01 ? 0 : 1) : 2;
  float n0[3];
  rot_column(q.qn, g.ax, n0);
  // flip_align_view: keep n where n . (-dir) >= 0
  const float mdn[3] = {-g.dn[0], -g.dn[1], -g.dn[2]};
  g.flip = dot3_rn(n0, mdn) >= 0.f ? 1.f : -1.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) g.n[c] = g.flip * n0[c];
}

// models/light.py `diffuse_irradiance` for channel c (base row-major [K, 3]).
__device__ __forceinline__ float irradiance(const float* b, int c, const float* n) {
  const float x = n[0], y = n[1], z = n[2];
  return IR_C1 * b[8 * 3 + c] * (x * x - y * y) + IR_C3 * b[6 * 3 + c] * (z * z) +
         IR_C4 * b[0 * 3 + c] - IR_C5 * b[6 * 3 + c] + IR_2C1 * b[4 * 3 + c] * x * y +
         IR_2C1 * b[7 * 3 + c] * x * z + IR_2C1 * b[5 * 3 + c] * y * z +
         IR_2C2 * b[3 * 3 + c] * x + IR_2C2 * b[1 * 3 + c] * y + IR_2C2 * b[2 * 3 + c] * z;
}

// The specular half of a shaded row.
template <int ED>
struct Specular {
  float wo[3], dv, r[3], sr, rden, refl[3], ndotv;
  float u0, v0, fu, fv;
  float tex[8];       // t00 (F, G), t01, t10, t11
  float fg0, fg1;
  float gk[ED + 1];   // the Gauss-Weierstrass factor of each band
  float K3[3];        // the contraction before its floor
};

template <int ED, int KE, int KS>
__device__ __forceinline__ void specular(const Geometry& g, const Consts<KE, KS>& s,
                                         const float* __restrict__ lut, Specular<ED>& p) {
#pragma unroll
  for (int c = 0; c < 3; ++c) p.wo[c] = -g.dn[c];   // safe_normalize(campos - xyz), exactly
  p.dv = p.wo[0] * g.n[0] + p.wo[1] * g.n[1] + p.wo[2] * g.n[2];
#pragma unroll
  for (int c = 0; c < 3; ++c) p.r[c] = 2 * p.dv * g.n[c] - p.wo[c];
  p.sr = p.r[0] * p.r[0] + p.r[1] * p.r[1] + p.r[2] * p.r[2];
  p.rden = sqrtf(fmaxf(p.sr, kEps));
#pragma unroll
  for (int c = 0; c < 3; ++c) p.refl[c] = p.r[c] / p.rden;
  p.ndotv = fmaxf(p.dv, kFloor);
  // ops/texture.py `bilinear_sample_packed` at (n.v, roughness)
  const float u = p.ndotv * kLut - 0.5f, v = g.kr * kLut - 0.5f;
  p.u0 = floorf(u);
  p.v0 = floorf(v);
  p.fu = p.u0 < 0.f ? 0.f : u - p.u0;
  p.fv = p.v0 < 0.f ? 0.f : v - p.v0;
  const int ui = min(max((int)p.u0, 0), kLut - 1), vi = min(max((int)p.v0, 0), kLut - 1);
  const float4* q = reinterpret_cast<const float4*>(lut + ((int64_t)vi * kLut + ui) * 8);
  const float4 a = __ldg(q), b = __ldg(q + 1);
  p.tex[0] = a.x; p.tex[1] = a.y; p.tex[2] = a.z; p.tex[3] = a.w;
  p.tex[4] = b.x; p.tex[5] = b.y; p.tex[6] = b.z; p.tex[7] = b.w;
  const float wu = 1 - p.fu, wv = 1 - p.fv;
  p.fg0 = p.tex[0] * wu * wv + p.tex[2] * p.fu * wv + p.tex[4] * wu * p.fv + p.tex[6] * p.fu * p.fv;
  p.fg1 = p.tex[1] * wu * wv + p.tex[3] * p.fu * wv + p.tex[5] * wu * p.fv + p.tex[7] * p.fu * p.fv;
  // The basis times the Gauss-Weierstrass factor exp(-l(l+1) * 0.3 * kr), contracted.
  const float kr3 = 0.3f * g.kr;
#pragma unroll
  for (int l = 0; l <= ED; ++l) p.gk[l] = expf(-(float)(l * (l + 1)) * kr3);
  Contract<true> k{s.base, p.gk, {0.f, 0.f, 0.f}};
  sh_terms<ED>(p.refl[0], p.refl[1], p.refl[2], k);
#pragma unroll
  for (int c = 0; c < 3; ++c) p.K3[c] = k.out[c];
}

// utils/sh.py `eval_sh` of the sky SH (row-major [K, 3]) along dir, + 0.5.
template <int SD, int KE, int KS>
__device__ __forceinline__ void sky_sh(const Geometry& g, const Consts<KE, KS>& s, float* E) {
  Contract<false> k{s.sky, nullptr, {0.f, 0.f, 0.f}};
  sh_terms<SD>(g.dn[0], g.dn[1], g.dn[2], k);
#pragma unroll
  for (int c = 0; c < 3; ++c) E[c] = k.out[c] + 0.5f;
}

template <int ED, int SD>
__global__ void __launch_bounds__(kThreads) shade_forward_kernel(
    const float* __restrict__ xyz, const float* __restrict__ rot, const float* __restrict__ scl,
    const float* __restrict__ alb, const float* __restrict__ rough,
    const float* __restrict__ metal, const uint8_t* __restrict__ is_sky,
    const float* __restrict__ base, const float* __restrict__ sky, const float* __restrict__ cam,
    const float* __restrict__ vrow, const float* __restrict__ lut, int64_t n, int C,
    int specular_on, int fix_sky, float* __restrict__ out, float* __restrict__ normals) {
  constexpr int KE = Sh<ED>::K, KS = Sh<SD>::K;
  __shared__ Consts<KE, KS> s;
  __shared__ InTile t;
  __shared__ float o[kThreads * 21];
  __shared__ float on[kThreads * 3];
  const int64_t row0 = (int64_t)blockIdx.x * kThreads;
  const int rows = n - row0 < kThreads ? (int)(n - row0) : kThreads;
  load_consts(s, base, sky, cam, vrow);
  load_tile(t, xyz, rot, scl, alb, rough, metal, is_sky, row0, rows);
  __syncthreads();
  const int i = threadIdx.x;
  if (i < rows) {
    Geometry g;
    geometry(t, i, s, g);
    float rgb[3], dif[3] = {0.f, 0.f, 0.f}, spc[3] = {0.f, 0.f, 0.f};
    if (g.sky) {
      if (fix_sky) {
        rgb[0] = rgb[1] = rgb[2] = 1.f;
      } else {
        float E[3];
        sky_sh<SD>(g, s, E);
#pragma unroll
        for (int c = 0; c < 3; ++c) rgb[c] = fmaxf(E[c], 0.f);
      }
    } else {
      float D[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) D[c] = g.alb[c] * fmaxf(irradiance(s.base, c, g.n), kFloor);
      if (specular_on) {
        Specular<ED> p;
        specular<ED>(g, s, lut, p);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float F0 = (1.f - g.km) * 0.04f + g.alb[c] * g.km;
          const float S = fmaxf(p.K3[c], kFloor) * (F0 * p.fg0 + p.fg1);
          rgb[c] = gamma_fwd((1 - g.km) * D[c] + S);
          dif[c] = gamma_fwd(D[c]);
          spc[c] = gamma_fwd(S);
        }
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) rgb[c] = dif[c] = gamma_fwd(D[c]);
      }
    }
    float* r = o + i * C;
#pragma unroll
    for (int c = 0; c < 3; ++c) r[c] = rgb[c];
    if (C > 3) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        r[3 + c] = dif[c];
        r[6 + c] = spc[c];
        r[10 + c] = 0.5f * g.n[c] + 0.5f;
      }
      const float* p = t.xyz + i * 3;
      r[9] = vrow == nullptr ? 0.f
                             : __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(p[0], s.vrow[0]),
                                                             __fmul_rn(p[1], s.vrow[1])),
                                                   __fmul_rn(p[2], s.vrow[2])),
                                         s.vrow[3]);
    }
    if (C > 13) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        r[13 + c] = g.sky ? rgb[c] : 0.f;
        r[18 + c] = g.sky ? 1.f : g.alb[c];
      }
      r[16] = g.sky ? 0.f : g.kr;
      r[17] = g.sky ? 0.f : g.km;
    }
    if (normals != nullptr) {
#pragma unroll
      for (int c = 0; c < 3; ++c) on[i * 3 + c] = g.n[c];
    }
  }
  __syncthreads();
  tile_out<21>(out, o, row0, rows, C);
  if (normals != nullptr) tile_out<3>(normals, on, row0, rows);
}

// The per-row gradient outputs of a tile.
struct GradTile {
  float xyz[kThreads * 3];
  float rot[kThreads * 4];
  float alb[kThreads * 3];
  float rough[kThreads];
  float metal[kThreads];
};

template <int ED, int SD>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSm) shade_backward_kernel(
    const float* __restrict__ xyz, const float* __restrict__ rot, const float* __restrict__ scl,
    const float* __restrict__ alb, const float* __restrict__ rough,
    const float* __restrict__ metal, const uint8_t* __restrict__ is_sky,
    const float* __restrict__ base, const float* __restrict__ sky, const float* __restrict__ cam,
    const float* __restrict__ vrow, const float* __restrict__ lut, int64_t n, int C,
    int specular_on, int fix_sky, const float* __restrict__ g_out,
    const float* __restrict__ g_normals, float* __restrict__ d_xyz, float* __restrict__ d_rot,
    float* __restrict__ d_alb, float* __restrict__ d_rough, float* __restrict__ d_metal,
    float* __restrict__ partial) {
  constexpr int KE = Sh<ED>::K, KS = Sh<SD>::K, P = (KE + KS) * 3;
  constexpr int kWarps = kThreads / 32;
  __shared__ Consts<KE, KS> s;
  __shared__ InTile t;
  __shared__ float go[kThreads * 21];
  __shared__ float gn_in[kThreads * 3];
  __shared__ GradTile d;
  __shared__ float red[kWarps][P];
  // This thread's rows' sums of the envlight's gradient ([KE, 3]) and the sky
  // SH's ([KS, 3]): a column of the dynamic [P, kThreads] table (registers
  // would hold them at the cost of a block's occupancy).
  extern __shared__ float sums[];
  const Column acc_e{sums + threadIdx.x}, acc_s{sums + KE * 3 * kThreads + threadIdx.x};
  for (int j = 0; j < P; ++j) sums[j * kThreads + threadIdx.x] = 0.f;
  load_consts(s, base, sky, cam, vrow);
  const int64_t tiles = (n + kThreads - 1) / kThreads;
  const bool debug = C > 13;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t row0 = tile * kThreads;
    const int rows = n - row0 < kThreads ? (int)(n - row0) : kThreads;
    tile_in<21>(go, g_out, row0, rows, C);
    if (g_normals != nullptr) tile_in<3>(gn_in, g_normals, row0, rows);
    __syncthreads();
    // A row whose cotangents are all 0 has all-0 gradients (the backward is
    // linear in them, and every factor is finite): it skips the work, and a
    // tile of such rows (a pool's rows past the live ones, rows outside the
    // view) reads none of its inputs.
    const int i = threadIdx.x;
    bool live = false;
    if (i < rows) {
      for (int c = 0; c < C; ++c) live |= go[i * C + c] != 0.f;
      if (g_normals != nullptr) live |= (gn_in[i * 3] != 0.f) | (gn_in[i * 3 + 1] != 0.f) |
                                        (gn_in[i * 3 + 2] != 0.f);
    }
    if (__syncthreads_or(live)) {
      load_tile(t, xyz, rot, scl, alb, rough, metal, is_sky, row0, rows);
      __syncthreads();
    }
    if (i < rows && !live) {
#pragma unroll
      for (int c = 0; c < 3; ++c) d.xyz[i * 3 + c] = d.alb[i * 3 + c] = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) d.rot[i * 4 + c] = 0.f;
      d.rough[i] = d.metal[i] = 0.f;
    }
    if (live) {
      Geometry g;
      geometry(t, i, s, g);
      const float* gr = go + i * C;
      float gn[3] = {0.f, 0.f, 0.f};     // d loss / d normal (after the flip)
      float gdn[3] = {0.f, 0.f, 0.f};    // d loss / d dir_pp_n
      float ga[3] = {0.f, 0.f, 0.f}, gkr = 0.f, gkm = 0.f;
      if (C > 3) {
#pragma unroll
        for (int c = 0; c < 3; ++c) gn[c] = 0.5f * gr[10 + c];
      }
      if (g_normals != nullptr) {
#pragma unroll
        for (int c = 0; c < 3; ++c) gn[c] += gn_in[i * 3 + c];
      }
      if (g.sky) {
        if (!fix_sky) {
          float E[3], gE[3];
          sky_sh<SD>(g, s, E);
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float gs = debug ? gr[c] + gr[13 + c] : gr[c];
            gE[c] = E[c] >= 0.f ? gs : 0.f;
          }
          ContractGrad<false> k{s.sky, nullptr, gE, acc_s, {0.f, 0.f, 0.f}, 0.f};
          sh_terms<SD>(g.dn[0], g.dn[1], g.dn[2], k);
#pragma unroll
          for (int c = 0; c < 3; ++c) gdn[c] += k.dir[c];
        }
      } else {
        if (debug) {
          gkr += gr[16];
          gkm += gr[17];
#pragma unroll
          for (int c = 0; c < 3; ++c) ga[c] += gr[18 + c];
        }
        float I[3], D[3], gD[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          I[c] = irradiance(s.base, c, g.n);
          D[c] = g.alb[c] * fmaxf(I[c], kFloor);
        }
        if (specular_on) {
          Specular<ED> p;
          specular<ED>(g, s, lut, p);
          float gK[3], gfg0 = 0.f, gfg1 = 0.f;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float F0 = (1.f - g.km) * 0.04f + g.alb[c] * g.km;
            const float rf = F0 * p.fg0 + p.fg1;
            const float si = fmaxf(p.K3[c], kFloor);
            const float S = si * rf;
            const float H = (1 - g.km) * D[c] + S;
            const float gH = gr[c] * gamma_grad(H);
            const float gS = (C > 3 ? gr[6 + c] * gamma_grad(S) : 0.f) + gH;
            gD[c] = (C > 3 ? gr[3 + c] * gamma_grad(D[c]) : 0.f) + gH * (1 - g.km);
            gkm += -gH * D[c];
            const float grf = gS * si;
            const float gF0 = grf * p.fg0;
            gfg0 += grf * F0;
            gfg1 += grf;
            gkm += gF0 * (g.alb[c] - 0.04f);
            ga[c] += gF0 * g.km;
            gK[c] = p.K3[c] >= kFloor ? gS * rf : 0.f;
          }
          // The contraction and the band factor.
          ContractGrad<true> k{s.base, p.gk, gK, acc_e, {0.f, 0.f, 0.f}, 0.f};
          sh_terms<ED>(p.refl[0], p.refl[1], p.refl[2], k);
          gkr += k.dkr;
          const float* grefl = k.dir;
          // refl = r / sqrt(max(|r|^2, eps))
          const float gdotr = grefl[0] * p.r[0] + grefl[1] * p.r[1] + grefl[2] * p.r[2];
          const float mr = p.sr >= kEps ? gdotr / (p.rden * p.rden * p.rden) : 0.f;
          float gr3[3];
#pragma unroll
          for (int c = 0; c < 3; ++c) gr3[c] = grefl[c] / p.rden - p.r[c] * mr;
          // r = 2 (wo . n) n - wo
          float gdv = 2 * (gr3[0] * g.n[0] + gr3[1] * g.n[1] + gr3[2] * g.n[2]);
          float gwo[3];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            gn[c] += 2 * p.dv * gr3[c];
            gwo[c] = -gr3[c];
          }
          // The LUT's fractions carry the gradient of n.v and of the roughness.
          const float wu = 1 - p.fu, wv = 1 - p.fv;
          const float gfu = gfg0 * ((p.tex[2] - p.tex[0]) * wv + (p.tex[6] - p.tex[4]) * p.fv) +
                            gfg1 * ((p.tex[3] - p.tex[1]) * wv + (p.tex[7] - p.tex[5]) * p.fv);
          const float gfv = gfg0 * ((p.tex[4] - p.tex[0]) * wu + (p.tex[6] - p.tex[2]) * p.fu) +
                            gfg1 * ((p.tex[5] - p.tex[1]) * wu + (p.tex[7] - p.tex[3]) * p.fu);
          const float gndotv = p.u0 >= 0.f ? gfu * kLut : 0.f;
          gkr += p.v0 >= 0.f ? gfv * kLut : 0.f;
          gdv += p.dv >= kFloor ? gndotv : 0.f;
          // dv = wo . n
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            gwo[c] += gdv * g.n[c];
            gn[c] += gdv * p.wo[c];
            gdn[c] -= gwo[c];
          }
        } else {
#pragma unroll
          for (int c = 0; c < 3; ++c)
            gD[c] = (C > 3 ? gr[c] + gr[3 + c] : gr[c]) * gamma_grad(D[c]);
        }
        // D = albedo * max(I, 1e-4), I the degree-2 irradiance.
        const float x = g.n[0], y = g.n[1], z = g.n[2];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          ga[c] += gD[c] * fmaxf(I[c], kFloor);
          const float gI = I[c] >= kFloor ? gD[c] * g.alb[c] : 0.f;
          const float* b = s.base;
          gn[0] += gI * (IR_2C1 * b[24 + c] * x + IR_2C1 * b[12 + c] * y +
                         IR_2C1 * b[21 + c] * z + IR_2C2 * b[9 + c]);
          gn[1] += gI * (-IR_2C1 * b[24 + c] * y + IR_2C1 * b[12 + c] * x +
                         IR_2C1 * b[15 + c] * z + IR_2C2 * b[3 + c]);
          gn[2] += gI * (2 * IR_C3 * b[18 + c] * z + IR_2C1 * b[21 + c] * x +
                         IR_2C1 * b[15 + c] * y + IR_2C2 * b[6 + c]);
          acc_e[0 + c] += gI * IR_C4;
          acc_e[3 + c] += gI * IR_2C2 * y;
          acc_e[6 + c] += gI * IR_2C2 * z;
          acc_e[9 + c] += gI * IR_2C2 * x;
          acc_e[12 + c] += gI * IR_2C1 * x * y;
          acc_e[15 + c] += gI * IR_2C1 * y * z;
          acc_e[18 + c] += gI * (IR_C3 * (z * z) - IR_C5);
          acc_e[21 + c] += gI * IR_2C1 * x * z;
          acc_e[24 + c] += gI * IR_C1 * (x * x - y * y);
        }
      }
      // The sigmoids (torch: grad * (1 - y) * y).
#pragma unroll
      for (int c = 0; c < 3; ++c) d.alb[i * 3 + c] = ga[c] * (1 - g.alb[c]) * g.alb[c];
      d.rough[i] = gkr * (1 - g.kr) * g.kr;
      d.metal[i] = gkm * (1 - g.km) * g.km;
      // The normal: the flip, the rotation column, both normalizations.
      float gn0[3], gq[4], gq1[4], gq0[4];
#pragma unroll
      for (int c = 0; c < 3; ++c) gn0[c] = g.flip * gn[c];
      Quat q;
      quaternion(t, i, q);
      rot_column_vjp(q.qn, g.ax, gn0, gq);
      {
        const float m = (q.sq2 >= kEps ? 1.f : 0.f) *
                        (gq[0] * q.q1[0] + gq[1] * q.q1[1] + gq[2] * q.q1[2] + gq[3] * q.q1[3]) *
                        (q.rs2 * q.rs2 * q.rs2);
#pragma unroll
        for (int c = 0; c < 4; ++c) gq1[c] = gq[c] * q.rs2 - q.q1[c] * m;
      }
      {
        const float m = (q.sq1 >= kEps ? 1.f : 0.f) *
                        (gq1[0] * q.q[0] + gq1[1] * q.q[1] + gq1[2] * q.q[2] + gq1[3] * q.q[3]) *
                        (q.rs1 * q.rs1 * q.rs1);
#pragma unroll
        for (int c = 0; c < 4; ++c) gq0[c] = gq1[c] * q.rs1 - q.q[c] * m;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) d.rot[i * 4 + c] = gq0[c];
      // dir_pp_n = d / sqrt(max(|d|^2, eps)), d = xyz - campos; and the depth channel.
      Dir r;
      direction(t, i, s, r);
      const float gdotd = gdn[0] * r.d[0] + gdn[1] * r.d[1] + gdn[2] * r.d[2];
      const float m = r.sd >= kEps ? gdotd / (r.dden * r.dden * r.dden) : 0.f;
      const float gdepth = (C > 3 && vrow != nullptr) ? gr[9] : 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        d.xyz[i * 3 + c] = gdn[c] / r.dden - r.d[c] * m + gdepth * s.vrow[c];
    }
    __syncthreads();
    tile_out<3>(d_xyz, d.xyz, row0, rows);
    tile_out<4>(d_rot, d.rot, row0, rows);
    tile_out<3>(d_alb, d.alb, row0, rows);
    tile_out<1>(d_rough, d.rough, row0, rows);
    tile_out<1>(d_metal, d.metal, row0, rows);
    __syncthreads();
  }
  // The block's sums, in a fixed order: a shuffle tree within each warp, then
  // the warps in turn.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    float v = sums[j * kThreads + threadIdx.x];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp][j] = v;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < P; j += kThreads) {
    float v = red[0][j];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += red[w][j];
    partial[(int64_t)blockIdx.x * P + j] = v;
  }
}

// out[j] = sum over b of partial[b, j], in a fixed order: block j, thread t
// sums b = t, t + 256, ..., then a shared-memory tree. out is the envlight's
// gradient [KE * 3] followed by the sky SH's [KS * 3].
__global__ void __launch_bounds__(256) reduce_partials_kernel(const float* __restrict__ partial,
                                                              int blocks, int P,
                                                              float* __restrict__ d_base,
                                                              int pe, float* __restrict__ d_sky) {
  __shared__ float sm[256];
  const int j = blockIdx.x;
  float v = 0.f;
  for (int b = threadIdx.x; b < blocks; b += 256) v += partial[(int64_t)b * P + j];
  sm[threadIdx.x] = v;
  __syncthreads();
  for (int w = 128; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w) sm[threadIdx.x] += sm[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    if (j < pe) d_base[j] = sm[0];
    else d_sky[j - pe] = sm[0];
  }
}

template <int ED, int SD>
cudaError_t launch_forward(const void* const* in, int64_t n, int C, int specular_on, int fix_sky,
                           void* out, void* normals, cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  shade_forward_kernel<ED, SD><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const float*)in[0], (const float*)in[1], (const float*)in[2], (const float*)in[3],
      (const float*)in[4], (const float*)in[5], (const uint8_t*)in[6], (const float*)in[7],
      (const float*)in[8], (const float*)in[9], (const float*)in[10], (const float*)in[11], n, C,
      specular_on, fix_sky, (float*)out, (float*)normals);
  return cudaGetLastError();
}

template <int ED, int SD>
cudaError_t launch_backward(const void* const* in, int64_t n, int C, int specular_on, int fix_sky,
                            const void* g_out, const void* g_normals, void* const* grads,
                            void* partial, int blocks, cudaStream_t stream) {
  constexpr int KE = Sh<ED>::K, KS = Sh<SD>::K, P = (KE + KS) * 3;
  constexpr int smem = P * kThreads * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(shade_backward_kernel<ED, SD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  shade_backward_kernel<ED, SD><<<blocks, kThreads, smem, stream>>>(
      (const float*)in[0], (const float*)in[1], (const float*)in[2], (const float*)in[3],
      (const float*)in[4], (const float*)in[5], (const uint8_t*)in[6], (const float*)in[7],
      (const float*)in[8], (const float*)in[9], (const float*)in[10], (const float*)in[11], n, C,
      specular_on, fix_sky, (const float*)g_out, (const float*)g_normals, (float*)grads[0],
      (float*)grads[1], (float*)grads[2], (float*)grads[3], (float*)grads[4], (float*)partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials_kernel<<<P, 256, 0, stream>>>((const float*)partial, blocks, P,
                                                (float*)grads[5], KE * 3, (float*)grads[6]);
  return cudaGetLastError();
}

using ForwardFn = cudaError_t (*)(const void* const*, int64_t, int, int, int, void*, void*,
                                  cudaStream_t);
using BackwardFn = cudaError_t (*)(const void* const*, int64_t, int, int, int, const void*,
                                   const void*, void* const*, void*, int, cudaStream_t);

// Every degree pair the port's configuration can name: the envlight 2..5 (the
// irradiance reads coefficients 0..8), the sky 0..5.
#define R3DGW_SKY_ROW(ED, T)                                                                  \
  {T<ED, 0>, T<ED, 1>, T<ED, 2>, T<ED, 3>, T<ED, 4>, T<ED, 5>}
constexpr int kMinEnv = 2, kMaxEnv = 5, kMaxSky = 5;
const ForwardFn kForward[4][6] = {
    R3DGW_SKY_ROW(2, launch_forward), R3DGW_SKY_ROW(3, launch_forward),
    R3DGW_SKY_ROW(4, launch_forward), R3DGW_SKY_ROW(5, launch_forward)};
const BackwardFn kBackward[4][6] = {
    R3DGW_SKY_ROW(2, launch_backward), R3DGW_SKY_ROW(3, launch_backward),
    R3DGW_SKY_ROW(4, launch_backward), R3DGW_SKY_ROW(5, launch_backward)};
#undef R3DGW_SKY_ROW

bool bad_args(int env_deg, int sky_deg, int C, int64_t n, const void* const* in) {
  if (env_deg < kMinEnv || env_deg > kMaxEnv || sky_deg < 0 || sky_deg > kMaxSky) return true;
  if (!(C == 3 || C == 13 || C == 21) || n < 0) return true;
  return ((uintptr_t)in[11] & 15) != 0;   // the LUT's float4 loads
}

}  // namespace

extern "C" {

const char* r3dgw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The backward's number of partial rows for n rows.
int r3dgw_shade_backward_blocks(int64_t n) {
  const int64_t tiles = (n + kThreads - 1) / kThreads;
  return (int)(tiles < kBwdBlocks ? (tiles > 0 ? tiles : 1) : kBwdBlocks);
}

// in: xyz [n, 3], rotation [n, 4], scaling [n, 3], albedo [n, 3], roughness
// [n], metalness [n] (raw leaves, float32), is_sky [n] (bool), envlight
// [(env_deg+1)^2, 3], sky SH [(sky_deg+1)^2, 3], campos [3], the view
// matrix's third row [4] or null, the quad-packed FG LUT [256, 256, 8].
// out [n, C]; normals [n, 3] or null. Returns cudaGetLastError().
int r3dgw_shade_forward(const void* const* in, int64_t n, int env_deg, int sky_deg, int C,
                        int specular_on, int fix_sky, void* out, void* normals, void* stream) {
  if (bad_args(env_deg, sky_deg, C, n, in)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  return (int)kForward[env_deg - kMinEnv][sky_deg](in, n, C, specular_on, fix_sky, out, normals,
                                                   (cudaStream_t)stream);
}

// in: as the forward's; g_out [n, C], g_normals [n, 3] or null. grads: d_xyz
// [n, 3], d_rotation [n, 4], d_albedo [n, 3], d_roughness [n], d_metalness
// [n], d_envlight [(env_deg+1)^2, 3], d_sky [(sky_deg+1)^2, 3]; partial
// [r3dgw_shade_backward_blocks(n), ((env_deg+1)^2 + (sky_deg+1)^2) * 3].
int r3dgw_shade_backward(const void* const* in, int64_t n, int env_deg, int sky_deg, int C,
                         int specular_on, int fix_sky, const void* g_out, const void* g_normals,
                         void* const* grads, void* partial, void* stream) {
  if (bad_args(env_deg, sky_deg, C, n, in)) return (int)cudaErrorInvalidValue;
  return (int)kBackward[env_deg - kMinEnv][sky_deg](in, n, C, specular_on, fix_sky, g_out,
                                                    g_normals, grads, partial,
                                                    r3dgw_shade_backward_blocks(n),
                                                    (cudaStream_t)stream);
}

}  // extern "C"
