// Threaded RecordIO image pipeline — the native data loader.
//
// The port's copy of mxnet_tpu's native/src/image_loader.h (upstream:
// src/io/iter_image_recordio_2.cc, iter_prefetcher.h,
// iter_batchloader.h, image_aug_default.cc): shard the .rec
// (part_index/num_parts) → decode threads (RecordIO parse → libjpeg or
// libpng decode → resize, crop, mirror, normalise) → batch pack → a ring
// of prefetched float32 NCHW/NHWC batch buffers on the host.  This is the
// host route of ImageRecordIter; the card route decodes with nvJPEG and
// augments in kernels/csrc/image_aug.cu with the same arithmetic.
#ifndef MXNET_TPU_IMAGE_LOADER_H_
#define MXNET_TPU_IMAGE_LOADER_H_

#include <atomic>
#include <condition_variable>
#include <cstring>
#include <memory>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include "recordio.h"

namespace mxnet_tpu {

struct ImageRecParams {
  int batch_size = 32;
  int height = 224, width = 224, channels = 3;
  int num_threads = 4;
  int shuffle = 0;
  uint64_t seed = 0;
  int part_index = 0, num_parts = 1;
  int rand_crop = 0, rand_mirror = 0;
  int resize_short = 0;     // 0 = no resize; else resize short side to this
  int label_width = 1;
  float mean[3] = {0.f, 0.f, 0.f};
  float std[3] = {1.f, 1.f, 1.f};
  float scale = 1.0f;       // applied before mean/std
  int layout_nhwc = 0;      // 0 = NCHW (reference default), 1 = NHWC
  int round_batch = 1;      // pad last batch by wrapping (reference semantics)
  // DCT-domain downscale on the train-crop path:
  // when rand_crop is set and the source short side is >= 2x the
  // resize/crop target, decode JPEGs at 1/2 (1/4, 1/8) scale inside
  // libjpeg — the IDCT runs on fewer coefficients and every later
  // stage touches 4x fewer pixels.  Never engages when it would drop
  // below the target (the guard keeps crops valid); eval paths
  // (center crop) are untouched.  Reference: the OpenCV augmenter got
  // this via cv::IMREAD_REDUCED_*.
  int dct_scale = 1;        // 1 = allow (train path only), 0 = always full
};

// Decoded image scratch (HWC uint8).
struct DecodedImage {
  std::vector<uint8_t> pixels;
  int h = 0, w = 0, c = 0;
};

// min_short > 0 allows DCT-domain scaling: the largest 1/2^k (k<=3)
// scale keeping min(h, w) >= min_short is applied inside libjpeg.
bool DecodeJPEG(const uint8_t* data, size_t size, DecodedImage* out,
                int min_short = 0);
bool DecodePNG(const uint8_t* data, size_t size, DecodedImage* out);

// Cumulative decode counters: every successful
// JPEG/PNG decode — imdecode, the threaded loader's workers, profile
// passes excluded — bumps these relaxed atomics; dct_scaled counts
// decodes where the DCT-domain downscale actually engaged.  Read via
// MXImageDecodeProfileStats, reset via MXImageDecodeProfileReset so
// the Prometheus surface can export per-interval pipeline rates.
struct DecodeStats {
  std::atomic<uint64_t> jpeg{0};
  std::atomic<uint64_t> png{0};
  std::atomic<uint64_t> dct_scaled{0};
  std::atomic<uint64_t> errors{0};
};
DecodeStats& GetDecodeStats();
void ResetDecodeStats();
void ResizeBilinear(const DecodedImage& src, int out_h, int out_w,
                    DecodedImage* dst);

// Per-stage JPEG decode timing: mean ms over
// `reps` for (0) entropy/huffman decode only (jpeg_read_coefficients),
// (1) + IDCT/upsampling (full decompress to YCbCr, no colorspace
// conversion), (2) the full RGB path, (3) the RGB path with the
// min_short-guarded DCT-domain scale.  IDCT cost ~= [1]-[0],
// colorspace cost ~= [2]-[1].
bool ProfileJPEGStages(const uint8_t* data, size_t size, int reps,
                       int min_short, double out_ms[4]);

class ImageRecordLoader {
 public:
  ImageRecordLoader(const std::string& rec_path, const std::string& idx_path,
                    const ImageRecParams& p);
  ~ImageRecordLoader();

  // Returns actual batch size (== batch_size), with *pad = number of wrapped
  // padding samples in the final batch; returns 0 at epoch end.  The
  // returned pointers stay valid until the next call to Next()/Reset().
  int Next(const float** data, const float** label, int* pad);
  void Reset();

  int64_t num_samples() const { return static_cast<int64_t>(my_keys_.size()); }

 private:
  struct BatchBuf {
    std::vector<float> data, label;
    std::atomic<int> remaining{0};
    int pad = 0;
    bool ready = false;
  };

  void WorkerLoop(int tid);
  void WorkerBody(int tid);
  void StartEpoch();
  void StopWorkers();

  ImageRecParams p_;
  std::string rec_path_;
  std::vector<std::pair<int64_t, uint64_t>> my_keys_;  // this part's (key, offset)
  std::vector<uint32_t> order_;                        // epoch sample order
  size_t num_batches_ = 0;

  static const int kDepth = 4;  // prefetch ring depth
  std::vector<std::unique_ptr<BatchBuf>> ring_;
  std::atomic<size_t> cursor_{0};      // next global sample slot to claim
  size_t consumed_ = 0;                // batches handed to the consumer
  size_t released_ = 0;                // batches whose ring slot was recycled
  bool leased_ = false;                // consumer currently holds a buffer
  std::mutex mu_;
  std::condition_variable cv_ready_, cv_space_;
  std::atomic<bool> stop_{false};
  std::string error_;
  bool has_error_ = false;
  std::vector<std::thread> workers_;
  std::mt19937_64 rng_;
  uint64_t epoch_ = 0;
  bool epoch_running_ = false;
};

}  // namespace mxnet_tpu

#endif  // MXNET_TPU_IMAGE_LOADER_H_
