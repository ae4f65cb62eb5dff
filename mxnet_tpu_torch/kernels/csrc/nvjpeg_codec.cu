// A small C interface over nvJPEG: batched JPEG decode straight into card
// memory, as planes (Y, Cb, Cr at their own sizes, which the jpeg_color
// kernel upsamples and converts as libjpeg does) or as interleaved RGB,
// and a private encoder for making seeded test records on the card's
// machine.
//
// No kernel of this repository is here: decoding is left to the CUDA
// toolkit's codec library, as the reference leaves it to libjpeg or
// OpenCV (mxnet_tpu/image/image.py:32-48, native/src/image_loader.cc:
// 50-90).  The H100 has hardware JPEG decoders; where the machine exposes
// them the codec decodes there (NVJPEG_BACKEND_HARDWARE, batched) every
// image that backend takes and the rest (progressive, some greyscale or
// odd layouts) one by one with the default backend.  Where it does not,
// a batch goes to one batched call of the GPU hybrid backend (Huffman
// decoding on the card); a batch that call refuses is an error, not a
// quiet move of the work to the host's Huffman decoder.  The codec state
// (handles, batched-decode state, parsed streams, their pinned buffers)
// lives in one Codec and is reused across batches; the batched state is
// initialised again only when the batch size changes.  Every call
// enqueues on the caller's stream.
#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <vector>

namespace {

struct Codec {
  int device = 0;
  nvjpegHandle_t gpu = nullptr;        // default backend: single decodes
  nvjpegJpegState_t gpu_state = nullptr;
  nvjpegHandle_t bat = nullptr;        // the batched decodes' handle
  nvjpegJpegState_t bat_state = nullptr;
  int bat_backend = 2;                 // nvjpegBackend_t of bat
  nvjpegJpegStream_t parsed = nullptr;
  int bat_batch = -1;                  // batch size bat_state holds
  int bat_fmt = -1;                    // and its output format
  nvjpegEncoderState_t enc_state = nullptr;
  nvjpegEncoderParams_t enc_params = nullptr;
};

}  // namespace

#define NVJ(call)                                   \
  do {                                              \
    nvjpegStatus_t s_ = (call);                     \
    if (s_ != NVJPEG_STATUS_SUCCESS) return 1000 + (int)s_; \
  } while (0)

extern "C" {

// The batched decodes take the hardware backend where creating it
// succeeds, else the GPU hybrid one.  *backend_out: the backend taken
// (nvjpegBackend_t: 2 GPU hybrid, 3 hardware); *hw_status: what creating
// the hardware backend returned (nvjpegStatus_t).
int mxt_nvjpeg_create(int device, void** out, int* backend_out,
                      int* hw_status) {
  cudaError_t ce = cudaSetDevice(device);
  if (ce != cudaSuccess) return (int)ce;
  Codec* c = new Codec();
  c->device = device;
  nvjpegStatus_t s = nvjpegCreateEx(NVJPEG_BACKEND_DEFAULT, nullptr, nullptr,
                                    0, &c->gpu);
  if (s != NVJPEG_STATUS_SUCCESS) { delete c; return 1000 + (int)s; }
  NVJ(nvjpegJpegStateCreate(c->gpu, &c->gpu_state));
  s = nvjpegCreateEx(NVJPEG_BACKEND_HARDWARE, nullptr, nullptr, 0, &c->bat);
  *hw_status = (int)s;
  if (s == NVJPEG_STATUS_SUCCESS) {
    c->bat_backend = 3;
  } else {
    c->bat = nullptr;
    NVJ(nvjpegCreateEx(NVJPEG_BACKEND_GPU_HYBRID, nullptr, nullptr, 0,
                       &c->bat));
  }
  NVJ(nvjpegJpegStateCreate(c->bat, &c->bat_state));
  NVJ(nvjpegJpegStreamCreate(c->bat, &c->parsed));
  *backend_out = c->bat_backend;
  *out = c;
  return 0;
}

void mxt_nvjpeg_destroy(void* h) {
  Codec* c = static_cast<Codec*>(h);
  if (!c) return;
  if (c->enc_params) nvjpegEncoderParamsDestroy(c->enc_params);
  if (c->enc_state) nvjpegEncoderStateDestroy(c->enc_state);
  if (c->parsed) nvjpegJpegStreamDestroy(c->parsed);
  if (c->bat_state) nvjpegJpegStateDestroy(c->bat_state);
  if (c->bat) nvjpegDestroy(c->bat);
  if (c->gpu_state) nvjpegJpegStateDestroy(c->gpu_state);
  if (c->gpu) nvjpegDestroy(c->gpu);
  delete c;
}

// the image's components, chroma subsampling (nvjpegChromaSubsampling_t)
// and each component's height and width (heights[0], widths[0]: the
// image's), from its header
int mxt_nvjpeg_info(void* h, const unsigned char* data, size_t len,
                    int* comps, int* subsampling, int* heights,
                    int* widths) {
  Codec* c = static_cast<Codec*>(h);
  nvjpegChromaSubsampling_t ss;
  NVJ(nvjpegGetImageInfo(c->gpu, data, len, comps, &ss, widths, heights));
  *subsampling = (int)ss;
  return 0;
}

// Decode n JPEGs in output format fmt (nvjpegOutputFormat_t:
// NVJPEG_OUTPUT_RGBI interleaved, NVJPEG_OUTPUT_YUV planar) into device
// memory: image i's channel k at outs[3 * i + k] with pitch
// pitches[3 * i + k].  With the hardware backend, each image it takes
// goes into one batched call and the rest are decoded alone; with the
// GPU hybrid backend every image goes into one batched call, and a batch
// it refuses returns its status; allow_batched 0 decodes every image
// alone.  batched[i] is set to 1 for each image a batched call decoded,
// else 0.
int mxt_nvjpeg_decode(void* h, int n, const unsigned char* const* data,
                      const size_t* lens, int fmt,
                      unsigned char* const* outs, const int* pitches,
                      int allow_batched, void* stream, int* batched) {
  Codec* c = static_cast<Codec*>(h);
  cudaStream_t st = (cudaStream_t)stream;
  const nvjpegOutputFormat_t of = (nvjpegOutputFormat_t)fmt;
  std::vector<const unsigned char*> b_data;
  std::vector<size_t> b_lens;
  std::vector<nvjpegImage_t> b_out, all(n);
  for (int i = 0; i < n; ++i) {
    all[i] = nvjpegImage_t();
    for (int k = 0; k < 3; ++k) {
      all[i].channel[k] = outs[3 * i + k];
      all[i].pitch[k] = (size_t)pitches[3 * i + k];
    }
    int take = allow_batched;
    if (take && c->bat_backend == 3) {
      int unsupported = 1;
      NVJ(nvjpegJpegStreamParse(c->bat, data[i], lens[i], 0, 0, c->parsed));
      NVJ(nvjpegDecodeBatchedSupported(c->bat, c->parsed, &unsupported));
      take = unsupported == 0;
    }
    batched[i] = take;
    if (take) {
      b_data.push_back(data[i]);
      b_lens.push_back(lens[i]);
      b_out.push_back(all[i]);
    }
  }
  if (!b_data.empty()) {
    int m = (int)b_data.size();
    nvjpegStatus_t s = NVJPEG_STATUS_SUCCESS;
    if (m != c->bat_batch || fmt != c->bat_fmt) {
      s = nvjpegDecodeBatchedInitialize(c->bat, c->bat_state, m, 1, of);
      c->bat_batch = s == NVJPEG_STATUS_SUCCESS ? m : -1;
      c->bat_fmt = fmt;
    }
    if (s == NVJPEG_STATUS_SUCCESS)
      s = nvjpegDecodeBatched(c->bat, c->bat_state, b_data.data(),
                              b_lens.data(), b_out.data(), st);
    if (s != NVJPEG_STATUS_SUCCESS) return 1000 + (int)s;
  }
  for (int i = 0; i < n; ++i)
    if (!batched[i])
      NVJ(nvjpegDecode(c->gpu, c->gpu_state, data[i], lens[i], of, &all[i],
                       st));
  return (int)cudaGetLastError();
}

// Encode one interleaved RGB image (device, pitch 3 * width) as a
// baseline JPEG at `quality` with 4:2:0 chroma (subsampling 420) or 4:4:4
// (444).  With out == NULL or cap too small, *len gets the size needed
// and the call returns -1 (encode again with a buffer that large).
int mxt_nvjpeg_encode(void* h, const unsigned char* rgb, int height,
                      int width, int quality, int subsampling, void* stream,
                      unsigned char* out, size_t cap, size_t* len) {
  Codec* c = static_cast<Codec*>(h);
  cudaStream_t st = (cudaStream_t)stream;
  if (!c->enc_state) {
    NVJ(nvjpegEncoderStateCreate(c->gpu, &c->enc_state, st));
    NVJ(nvjpegEncoderParamsCreate(c->gpu, &c->enc_params, st));
  }
  NVJ(nvjpegEncoderParamsSetQuality(c->enc_params, quality, st));
  NVJ(nvjpegEncoderParamsSetSamplingFactors(
      c->enc_params, subsampling == 444 ? NVJPEG_CSS_444 : NVJPEG_CSS_420, st));
  NVJ(nvjpegEncoderParamsSetOptimizedHuffman(c->enc_params, 0, st));
  nvjpegImage_t img = {};
  img.channel[0] = const_cast<unsigned char*>(rgb);
  img.pitch[0] = (size_t)width * 3;
  NVJ(nvjpegEncodeImage(c->gpu, c->enc_state, c->enc_params, &img,
                        NVJPEG_INPUT_RGBI, width, height, st));
  size_t need = 0;
  NVJ(nvjpegEncodeRetrieveBitstream(c->gpu, c->enc_state, nullptr, &need, st));
  *len = need;
  if (out == nullptr || cap < need) return -1;
  cudaError_t ce = cudaStreamSynchronize(st);
  if (ce != cudaSuccess) return (int)ce;
  NVJ(nvjpegEncodeRetrieveBitstream(c->gpu, c->enc_state, out, len, st));
  ce = cudaStreamSynchronize(st);
  return (int)ce;
}

}  // extern "C"
