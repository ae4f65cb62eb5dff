// jpeg_color: libjpeg's chroma upsampling and YCbCr -> RGB conversion of
// a batch of JPEGs that nvJPEG decoded to planes, in one launch.
//
// It replaces no TPU kernel.  The reference decodes with libjpeg (through
// OpenCV or its native loader), whose defaults are "fancy" upsampling
// (jdsample.c: h2v1_fancy_upsample, h2v2_fancy_upsample, a triangle
// filter, 3/4 of the nearer chroma sample and 1/4 of the farther one)
// and its fixed-point colour tables (jdcolor.c: ycc_rgb_convert, 16
// fraction bits, rounded).  nvJPEG's own RGB output replicates chroma and
// converts in its own arithmetic: against libjpeg's pixels it is 3-4
// levels off on average for 4:2:0 images, up to 40 at colour edges.  So
// the card route asks nvJPEG for the planes its IDCT produced (Y, Cb, Cr
// at their own sizes) and this kernel finishes the decode as libjpeg
// does; only the IDCT's rounding is left between the two.
//
// With a factor d > 1 (DCT scaling: libjpeg's 1/d-scale decode, which
// ImageRecordIter asks for on its random-crop path) the kernel writes the
// image at libjpeg's scaled size, ceil(h / d) x ceil(w / d).  libjpeg runs
// a reduced IDCT per component so that each lands at the output size with
// no upsampling (jdmaster.c: 4:2:0 chroma at d = 2 keeps its 8 x 8 IDCT);
// nvJPEG has no scaled IDCT, so each plane is box-averaged to that size
// instead (Y by d; chroma by d over its full-resolution axes and by d / 2
// over its halved ones: a mean rounded half up) and then converted.  This
// kernel is the only place the card route scales: every image of a batch
// passes through it.
//
// Each image's row of the table: the offsets of its Y, Cb and Cr planes
// in the scratch buffer, its height and width, the chroma planes' height
// and width, its layout (0 grey, 1 4:4:4, 2 4:2:2, 3 4:2:0, 4 RGB: a
// layout nvJPEG decodes only to interleaved RGB, at the Y offset, which
// the kernel copies or box-averages), the offset of its interleaved RGB
// output and its scale factor d (1, 2, 4 or 8).  One thread computes one
// output pixel; blockIdx.y is the image (max_pixels: the largest output).
// Bound: bytes (the planes read once, the RGB written once).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { C_Y, C_CB, C_CR, C_H, C_W, C_CH, C_CW, C_KIND, C_OUT, C_DENOM,
       C_FIELDS };
enum { K_GREY = 0, K_444 = 1, K_422 = 2, K_420 = 3, K_RGB = 4 };

__device__ __forceinline__ int at(const uint8_t* p, int w, int r, int c) {
  return p[(size_t)r * w + c];
}

// h2v1_fancy_upsample: output column x of chroma row r
__device__ __forceinline__ int up_h2v1(const uint8_t* p, int cw, int r,
                                       int x) {
  const int i = x >> 1, v = at(p, cw, r, i) * 3;
  if (cw == 1) return at(p, cw, r, 0);
  if ((x & 1) == 0)
    return i == 0 ? at(p, cw, r, 0) : (v + at(p, cw, r, i - 1) + 1) >> 2;
  return i == cw - 1 ? at(p, cw, r, i) : (v + at(p, cw, r, i + 1) + 2) >> 2;
}

// h2v2_fancy_upsample: output pixel (y, x) from the chroma plane (ch, cw)
__device__ __forceinline__ int up_h2v2(const uint8_t* p, int ch, int cw,
                                       int y, int x) {
  const int r = y >> 1;
  const int nb = (y & 1) ? min(r + 1, ch - 1) : max(r - 1, 0);
  const int i = x >> 1;
  const int cur = at(p, cw, r, i) * 3 + at(p, cw, nb, i);
  if ((x & 1) == 0) {
    if (i == 0) return (cur * 4 + 8) >> 4;
    const int last = at(p, cw, r, i - 1) * 3 + at(p, cw, nb, i - 1);
    return (cur * 3 + last + 8) >> 4;
  }
  if (i == cw - 1) return (cur * 4 + 7) >> 4;
  const int next = at(p, cw, r, i + 1) * 3 + at(p, cw, nb, i + 1);
  return (cur * 3 + next + 7) >> 4;
}

// the mean of the fy x fx block (r, c) of an (h, w) plane of STEP bytes
// a pixel, clipped at its edges, rounded half up
template <int STEP>
__device__ __forceinline__ int box(const uint8_t* p, int h, int w, int fy,
                                   int fx, int r, int c) {
  const int r1 = min(r * fy + fy, h), c1 = min(c * fx + fx, w);
  int sum = 0;
  for (int y = r * fy; y < r1; ++y)
    for (int x = c * fx; x < c1; ++x) sum += p[((size_t)y * w + x) * STEP];
  const int n = (r1 - r * fy) * (c1 - c * fx);
  return (sum + n / 2) / n;
}

__device__ __forceinline__ uint8_t clamp8(int v) {
  return (uint8_t)min(255, max(0, v));
}

__global__ void jpeg_color_kernel(const uint8_t* __restrict__ planes,
                                  const int64_t* __restrict__ table,
                                  uint8_t* __restrict__ out) {
  const int64_t* t = table + (int64_t)blockIdx.y * C_FIELDS;
  const int h = (int)t[C_H], w = (int)t[C_W], d = (int)t[C_DENOM];
  const int oh = (h + d - 1) / d, ow = (w + d - 1) / d;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (int64_t)oh * ow) return;
  const int y = (int)(p / ow), x = (int)(p % ow);
  const uint8_t* yp = planes + t[C_Y];
  uint8_t* o = out + t[C_OUT] + p * 3;
  const int kind = (int)t[C_KIND];
  if (kind == K_RGB) {
    for (int k = 0; k < 3; ++k)
      o[k] = (uint8_t)(d == 1 ? yp[p * 3 + k]
                              : box<3>(yp + k, h, w, d, d, y, x));
    return;
  }
  const int Y = d == 1 ? yp[p] : box<1>(yp, h, w, d, d, y, x);
  if (kind == K_GREY) {
    o[0] = o[1] = o[2] = (uint8_t)Y;
    return;
  }
  const int ch = (int)t[C_CH], cw = (int)t[C_CW];
  const uint8_t* cbp = planes + t[C_CB];
  const uint8_t* crp = planes + t[C_CR];
  int cb, cr;
  if (d > 1) {
    const int fy = kind == K_420 ? d / 2 : d;
    const int fx = kind == K_444 ? d : d / 2;
    cb = fy * fx == 1 ? at(cbp, cw, y, x) : box<1>(cbp, ch, cw, fy, fx, y, x);
    cr = fy * fx == 1 ? at(crp, cw, y, x) : box<1>(crp, ch, cw, fy, fx, y, x);
  } else if (kind == K_444) {
    cb = at(cbp, cw, y, x);
    cr = at(crp, cw, y, x);
  } else if (kind == K_422) {
    cb = up_h2v1(cbp, cw, y, x);
    cr = up_h2v1(crp, cw, y, x);
  } else {
    cb = up_h2v2(cbp, ch, cw, y, x);
    cr = up_h2v2(crp, ch, cw, y, x);
  }
  // jdcolor.c build_ycc_rgb_table: FIX(1.40200) = 91881, FIX(1.77200) =
  // 116130, FIX(0.71414) = 46802, FIX(0.34414) = 22554, ONE_HALF = 32768
  cb -= 128;
  cr -= 128;
  o[0] = clamp8(Y + ((91881 * cr + 32768) >> 16));
  o[1] = clamp8(Y + ((-22554 * cb + 32768 - 46802 * cr) >> 16));
  o[2] = clamp8(Y + ((116130 * cb + 32768) >> 16));
}

}  // namespace

extern "C" int mxt_jpeg_color(const void* planes, const void* table, int n,
                              int max_pixels, void* out, void* stream) {
  if (n == 0 || max_pixels == 0) return 0;
  const int threads = 256;
  dim3 grid((max_pixels + threads - 1) / threads, n);
  jpeg_color_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)planes, (const int64_t*)table, (uint8_t*)out);
  return (int)cudaGetLastError();
}
