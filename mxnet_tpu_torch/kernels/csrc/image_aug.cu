// image_aug: the augment stages of a batch of decoded images, on the card,
// in one launch.
//
// It replaces no TPU kernel.  The reference decodes and augments on the
// host, in C++ threads (native/src/image_loader.cc:405-460, copied into
// mxnet_tpu_torch/native_src/): resize the short side (ResizeBilinear,
// :214-246), resize up when the image is smaller than the crop
// (:418-425), crop (random or centre), mirror, normalise and lay out as
// NCHW or NHWC f32.  On the card those stages, done per image in torch
// ops, are several launches an image (a host-held chain of about a
// thousand launches for a 128-image batch); this kernel does the batch
// in one launch, with the native code's arithmetic bit for bit (the DCT
// scaling is the decode's, done by jpeg_color before this kernel runs):
//   * ResizeBilinear: f32 source coordinate (x + 0.5) * s - 0.5, floor,
//     edge clamp, rounding to uint8 by + 0.5 and truncation; the
//     resize-up of the second stage reads the first stage's uint8
//     pixels, as the native code does;
//   * (pix * scale - mean) * inv_std with inv_std = 1 / std.
// Every float operation is an explicit _rn intrinsic, so nvcc's FMA
// contraction cannot change a bit against the host's IEEE order.
//
// One thread computes one output pixel (all channels).  Bound: bytes
// (the pixels the crop windows read, the f32 batch written once); the
// design recomputes the stages' coordinates per pixel and reads the few
// source pixels each needs straight from device memory, which is enough
// for a first kernel that is right.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// per-image table row (int64): the decoded image's offset in the batch
// buffer, its height and width, the size after the short-side resize and
// after the resize-up, the crop origin and the mirror flag
enum {
  T_OFF, T_H, T_W, T_RH, T_RW, T_UH, T_UW, T_Y0, T_X0, T_MIRROR, T_FIELDS
};

struct Img {
  const uint8_t* src;
  int h, w, rh, rw, uh, uw;
};

// stage 0: the decoded image
__device__ __forceinline__ int stage0(const Img& m, int y, int x, int c) {
  return m.src[((size_t)y * m.w + x) * 3 + c];
}

// the native ResizeBilinear's taps of output coordinate o for a source
// of n over an output of on: (i0, i1, weight of i1)
__device__ __forceinline__ void taps(int o, int n, int on, int* i0,
                                     int* i1, float* wt) {
  const float s = __fdiv_rn((float)n, (float)on);
  float f = __fsub_rn(__fmul_rn(__fadd_rn((float)o, 0.5f), s), 0.5f);
  int a = (int)floorf(f);
  *wt = __fsub_rn(f, (float)a);
  *i1 = min(a + 1, n - 1);
  *i0 = max(a, 0);
}

__device__ __forceinline__ int blend(float p00, float p01, float p10,
                                     float p11, float wx, float wy) {
  float top = __fadd_rn(__fmul_rn(p00, __fsub_rn(1.f, wx)), __fmul_rn(p01, wx));
  float bot = __fadd_rn(__fmul_rn(p10, __fsub_rn(1.f, wx)), __fmul_rn(p11, wx));
  float v = __fadd_rn(__fadd_rn(__fmul_rn(top, __fsub_rn(1.f, wy)),
                                __fmul_rn(bot, wy)), 0.5f);
  v = fminf(255.f, fmaxf(0.f, v));
  return (int)(uint8_t)v;
}

// stage 1: the short-side resize of stage 0 (to rh x rw)
__device__ __forceinline__ int stage1(const Img& m, int y, int x, int c) {
  if (m.rh == m.h && m.rw == m.w) return stage0(m, y, x, c);
  int y0, y1, x0, x1;
  float wy, wx;
  taps(y, m.h, m.rh, &y0, &y1, &wy);
  taps(x, m.w, m.rw, &x0, &x1, &wx);
  return blend((float)stage0(m, y0, x0, c), (float)stage0(m, y0, x1, c),
               (float)stage0(m, y1, x0, c), (float)stage0(m, y1, x1, c),
               wx, wy);
}

// stage 2: the resize-up of stage 1 (to uh x uw) when it is smaller than
// the crop
__device__ __forceinline__ int stage2(const Img& m, int y, int x, int c) {
  if (m.uh == m.rh && m.uw == m.rw) return stage1(m, y, x, c);
  int y0, y1, x0, x1;
  float wy, wx;
  taps(y, m.rh, m.uh, &y0, &y1, &wy);
  taps(x, m.rw, m.uw, &x0, &x1, &wx);
  return blend((float)stage1(m, y0, x0, c), (float)stage1(m, y0, x1, c),
               (float)stage1(m, y1, x0, c), (float)stage1(m, y1, x1, c),
               wx, wy);
}

__global__ void image_aug_kernel(const uint8_t* __restrict__ buf,
                                 const int64_t* __restrict__ table, int B,
                                 int H, int W, int C, float scale,
                                 float m0, float m1, float m2, float i0,
                                 float i1, float i2, int nhwc,
                                 float* __restrict__ out) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t hw = (int64_t)H * W;
  if (p >= (int64_t)B * hw) return;
  const int b = (int)(p / hw);
  const int y = (int)((p % hw) / W), x = (int)(p % W);
  const int64_t* t = table + (int64_t)b * T_FIELDS;
  Img m;
  m.src = buf + t[T_OFF];
  m.h = (int)t[T_H]; m.w = (int)t[T_W];
  m.rh = (int)t[T_RH]; m.rw = (int)t[T_RW];
  m.uh = (int)t[T_UH]; m.uw = (int)t[T_UW];
  const int sy = (int)t[T_Y0] + y;
  const int sx = (int)t[T_X0] + (t[T_MIRROR] ? W - 1 - x : x);
  const float mean[3] = {m0, m1, m2}, inv_std[3] = {i0, i1, i2};
  for (int c = 0; c < C; ++c) {
    float v = __fmul_rn(__fsub_rn(__fmul_rn((float)stage2(m, sy, sx, c), scale),
                                  mean[c]), inv_std[c]);
    int64_t di = nhwc ? (((int64_t)b * H + y) * W + x) * C + c
                      : ((int64_t)b * C + c) * hw + (int64_t)y * W + x;
    out[di] = v;
  }
}

}  // namespace

extern "C" int mxt_image_aug(const void* buf, const void* table, int B,
                             int H, int W, int C, float scale, const float* mean,
                             const float* inv_std, int nhwc, void* out,
                             void* stream) {
  if (B == 0) return 0;
  const int threads = 256;
  const int64_t n = (int64_t)B * H * W;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  image_aug_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)buf, (const int64_t*)table, B, H, W, C, scale,
      mean[0], mean[1], mean[2], inv_std[0], inv_std[1], inv_std[2], nhwc,
      (float*)out);
  return (int)cudaGetLastError();
}
