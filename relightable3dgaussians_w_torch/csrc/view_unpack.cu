// View unpack (kernel V): one training photo's padded float32 canvas, built
// from the photo's 8-bit bytes as the view store (data/view_store.py) holds
// them on the card.
//
// Replaces no TPU kernel. The JAX package pads every training photo to the
// largest (H, W) once, on the host, and keeps the float32 canvases on the
// device (trainer.py `pad_cameras`): 20 bytes a canvas pixel. The port keeps
// each photo once at its own size, in at most 5 bytes a pixel, and rebuilds
// the step's canvas with this kernel: the image over 255, the sky mask and the
// occluder mask over 255 inside the photo; the image and the sky mask 0
// outside it, and the occluder mask 0 there too, so padding drops out of
// every masked loss. A camera with no sky or occluder mask reads 1 inside the
// photo. A Blender frame with alpha (4 channels) is composited over its
// background, as the reader does.
//
// Bitwise equal to the readers' numpy arithmetic: the division by 255 is the
// IEEE float32 division (__fdiv_rn, once a byte value, into a table in shared
// memory), and the composite r * a + bg * (1 - a) rounds each product, sum
// and difference on its own (__fmul_rn / __fadd_rn / __fsub_rn: no
// contraction into an FMA).
//
// What bounds it on an H100: bytes. A canvas pixel is written as 20 bytes (3
// image floats and 2 masks) and a photo pixel read as 5 (or 4 for an RGBA
// frame with no masks). One block a canvas row and part (image, sky, occluder:
// grid (1, H, 3)), 4 consecutive floats a thread, stored as one float4 where
// the row is 16-byte aligned (W a multiple of 4); the reads of a warp are
// consecutive bytes of the photo's row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;

template <int C>
__global__ void view_unpack_kernel(const uint8_t* __restrict__ rgb,
                                   const uint8_t* __restrict__ sky,
                                   const uint8_t* __restrict__ occ, int h, int w, float bg,
                                   int W, float* __restrict__ image,
                                   float* __restrict__ sky_out, float* __restrict__ occ_out) {
  __shared__ float unit[256];
  unit[threadIdx.x] = __fdiv_rn((float)threadIdx.x, 255.0f);
  __syncthreads();

  const int y = blockIdx.y;
  const int part = blockIdx.z;              // 0 image, 1 sky mask, 2 occluder mask
  const int n = part == 0 ? 3 * W : W;      // floats in this canvas row
  float* out = part == 0 ? image + (int64_t)y * 3 * W
             : (part == 1 ? sky_out : occ_out) + (int64_t)y * W;
  const uint8_t* mask = part == 1 ? sky : occ;
  const bool inside_row = y < h;
  const bool vec = (W & 3) == 0;
  for (int e0 = threadIdx.x * kPerThread; e0 < n; e0 += kThreads * kPerThread) {
    float v[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int e = e0 + k;
      const int x = part == 0 ? e / 3 : e;
      float r = 0.0f;
      if (inside_row && x < w && e < n) {
        const int64_t q = (int64_t)y * w + x;
        if (part == 0) {
          r = unit[rgb[q * C + (e - 3 * x)]];
          if (C == 4) {
            const float a = unit[rgb[q * C + 3]];
            r = __fadd_rn(__fmul_rn(r, a), __fmul_rn(bg, __fsub_rn(1.0f, a)));
          }
        } else {
          r = mask != nullptr ? unit[mask[q]] : 1.0f;
        }
      }
      v[k] = r;
    }
    if (vec && e0 + kPerThread <= n) {
      *reinterpret_cast<float4*>(out + e0) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k)
        if (e0 + k < n) out[e0 + k] = v[k];
    }
  }
}

}  // namespace

extern "C" {

const char* r3dgw_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// rgb [h, w, channels] u8 (channels 3, or 4: composited over bg), sky / occ
// [h, w] u8 or null (the mask reads 1 inside the photo) -> image [H, W, 3],
// sky_out [H, W], occ_out [H, W] f32, every float-aligned output contiguous.
// Returns cudaGetLastError().
int r3dgw_view_unpack(const void* rgb, const void* sky, const void* occ, int h, int w,
                      int channels, float bg, int H, int W, void* image, void* sky_out,
                      void* occ_out, void* stream) {
  if (H > 0 && W > 0) {
    const dim3 grid(1, (unsigned)H, 3);
    auto* kernel = channels == 4 ? view_unpack_kernel<4> : view_unpack_kernel<3>;
    kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)rgb, (const uint8_t*)sky, (const uint8_t*)occ, h, w, bg, W,
        (float*)image, (float*)sky_out, (float*)occ_out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
