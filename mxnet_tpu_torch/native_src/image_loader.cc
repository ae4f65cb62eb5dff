// See image_loader.h for design notes.
#include "image_loader.h"

#include <jpeglib.h>
#include <png.h>
#include <setjmp.h>

#include <algorithm>
#include <chrono>
#include <cmath>
#include <stdexcept>

namespace mxnet_tpu {

DecodeStats& GetDecodeStats() {
  static DecodeStats stats;
  return stats;
}

void ResetDecodeStats() {
  DecodeStats& s = GetDecodeStats();
  s.jpeg.store(0, std::memory_order_relaxed);
  s.png.store(0, std::memory_order_relaxed);
  s.dct_scaled.store(0, std::memory_order_relaxed);
  s.errors.store(0, std::memory_order_relaxed);
}

// ---------------------------------------------------------------- JPEG ----
namespace {
struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void JpegErrorExit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Largest 1/2^k (k <= 3) DCT-domain scale keeping min(h, w) >=
// min_short; 1 means full decode.
int PickScaleDenom(int h, int w, int min_short) {
  if (min_short <= 0) return 1;
  int short_side = std::min(h, w);
  int denom = 1;
  while (denom < 8 && short_side / (denom * 2) >= min_short) denom *= 2;
  return denom;
}
}  // namespace

bool DecodeJPEG(const uint8_t* data, size_t size, DecodedImage* out,
                int min_short) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = JpegErrorExit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), size);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  int denom = PickScaleDenom(cinfo.image_height, cinfo.image_width,
                             min_short);
  if (denom > 1) {
    // DCT-domain downscale: the IDCT itself emits the reduced-size
    // image (libjpeg scaled idct), so huffman is the only stage still
    // paying for the full resolution
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }
  jpeg_start_decompress(&cinfo);
  out->h = cinfo.output_height;
  out->w = cinfo.output_width;
  out->c = 3;
  out->pixels.resize(static_cast<size_t>(out->h) * out->w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->pixels.data() +
                   static_cast<size_t>(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  DecodeStats& stats = GetDecodeStats();
  stats.jpeg.fetch_add(1, std::memory_order_relaxed);
  if (denom > 1) stats.dct_scaled.fetch_add(1, std::memory_order_relaxed);
  return true;
}

// ------------------------------------------------------- stage profile ----
namespace {
// One bounded decode pass.  mode 0: entropy (huffman) decode only via
// jpeg_read_coefficients; 1: full decompress to YCbCr (huffman + IDCT
// + upsampling, no colorspace conversion); 2: full RGB; 3: RGB with
// the min_short-guarded DCT-domain scale.
bool ProfilePass(const uint8_t* data, size_t size, int mode,
                 int min_short, std::vector<uint8_t>* scratch) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = JpegErrorExit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), size);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  if (mode == 0) {
    if (!jpeg_read_coefficients(&cinfo)) {
      jpeg_destroy_decompress(&cinfo);
      return false;
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return true;
  }
  cinfo.out_color_space = mode == 1 ? JCS_YCbCr : JCS_RGB;
  if (mode == 3) {
    int denom = PickScaleDenom(cinfo.image_height, cinfo.image_width,
                               min_short);
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }
  jpeg_start_decompress(&cinfo);
  size_t stride =
      static_cast<size_t>(cinfo.output_width) * cinfo.output_components;
  if (scratch->size() < stride) scratch->resize(stride);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = scratch->data();
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}
}  // namespace

bool ProfileJPEGStages(const uint8_t* data, size_t size, int reps,
                       int min_short, double out_ms[4]) {
  if (reps < 1) reps = 1;
  std::vector<uint8_t> scratch;
  for (int mode = 0; mode < 4; ++mode) {
    if (!ProfilePass(data, size, mode, min_short, &scratch))
      return false;                      // warmup + validity check
    auto t0 = std::chrono::steady_clock::now();
    for (int r = 0; r < reps; ++r)
      if (!ProfilePass(data, size, mode, min_short, &scratch))
        return false;
    out_ms[mode] = std::chrono::duration<double, std::milli>(
                       std::chrono::steady_clock::now() - t0)
                       .count() /
                   reps;
  }
  return true;
}

// ----------------------------------------------------------------- PNG ----
namespace {
struct PngReadState {
  const uint8_t* data;
  size_t size, pos;
};

void PngReadFn(png_structp png, png_bytep out, png_size_t n) {
  PngReadState* s = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->pos + n > s->size) png_error(png, "png: out of data");
  memcpy(out, s->data + s->pos, n);
  s->pos += n;
}
}  // namespace

bool DecodePNG(const uint8_t* data, size_t size, DecodedImage* out) {
  if (size < 8 || png_sig_cmp(data, 0, 8)) return false;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) { png_destroy_read_struct(&png, nullptr, nullptr); return false; }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  PngReadState state{data, size, 0};
  png_set_read_fn(png, &state, PngReadFn);
  png_read_info(png, info);
  png_set_expand(png);
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  out->h = png_get_image_height(png, info);
  out->w = png_get_image_width(png, info);
  out->c = 3;
  out->pixels.resize(static_cast<size_t>(out->h) * out->w * 3);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y)
    rows[y] = out->pixels.data() + static_cast<size_t>(y) * out->w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  GetDecodeStats().png.fetch_add(1, std::memory_order_relaxed);
  return true;
}

// -------------------------------------------------------------- resize ----
void ResizeBilinear(const DecodedImage& src, int out_h, int out_w,
                    DecodedImage* dst) {
  dst->h = out_h;
  dst->w = out_w;
  dst->c = src.c;
  dst->pixels.resize(static_cast<size_t>(out_h) * out_w * src.c);
  const float sy = static_cast<float>(src.h) / out_h;
  const float sx = static_cast<float>(src.w) / out_w;
  for (int y = 0; y < out_h; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float wy = fy - y0;
    int y1 = std::min(y0 + 1, src.h - 1);
    y0 = std::max(y0, 0);
    const uint8_t* row0 = src.pixels.data() + static_cast<size_t>(y0) * src.w * src.c;
    const uint8_t* row1 = src.pixels.data() + static_cast<size_t>(y1) * src.w * src.c;
    uint8_t* orow = dst->pixels.data() + static_cast<size_t>(y) * out_w * src.c;
    for (int x = 0; x < out_w; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(std::floor(fx));
      float wx = fx - x0;
      int x1 = std::min(x0 + 1, src.w - 1);
      x0 = std::max(x0, 0);
      for (int ch = 0; ch < src.c; ++ch) {
        float top = row0[x0 * src.c + ch] * (1 - wx) + row0[x1 * src.c + ch] * wx;
        float bot = row1[x0 * src.c + ch] * (1 - wx) + row1[x1 * src.c + ch] * wx;
        orow[x * src.c + ch] =
            static_cast<uint8_t>(std::min(255.f, std::max(0.f, top * (1 - wy) + bot * wy + 0.5f)));
      }
    }
  }
}

// -------------------------------------------------------------- loader ----
ImageRecordLoader::ImageRecordLoader(const std::string& rec_path,
                                     const std::string& idx_path,
                                     const ImageRecParams& p)
    : p_(p), rec_path_(rec_path), rng_(p.seed) {
  std::vector<std::pair<int64_t, uint64_t>> all;
  LoadIndex(idx_path, &all);
  if (all.empty()) throw std::runtime_error("empty index " + idx_path);
  // InputSplit semantics: contiguous shard of the key list for this part.
  size_t n = all.size();
  size_t begin = n * p.part_index / p.num_parts;
  size_t end = n * (p.part_index + 1) / p.num_parts;
  my_keys_.assign(all.begin() + begin, all.begin() + end);
  order_.resize(my_keys_.size());
  for (size_t i = 0; i < order_.size(); ++i) order_[i] = static_cast<uint32_t>(i);

  size_t batch_elems = static_cast<size_t>(p_.batch_size) * p_.channels *
                       p_.height * p_.width;
  for (int i = 0; i < kDepth; ++i) {
    ring_.emplace_back(new BatchBuf());
    ring_.back()->data.resize(batch_elems);
    ring_.back()->label.resize(static_cast<size_t>(p_.batch_size) * p_.label_width);
  }
  StartEpoch();
}

ImageRecordLoader::~ImageRecordLoader() { StopWorkers(); }

void ImageRecordLoader::StartEpoch() {
  StopWorkers();
  if (p_.shuffle) std::shuffle(order_.begin(), order_.end(), rng_);
  num_batches_ = p_.round_batch
                     ? (order_.size() + p_.batch_size - 1) / p_.batch_size
                     : order_.size() / p_.batch_size;
  if (num_batches_ == 0 && !order_.empty()) num_batches_ = 1;
  cursor_.store(0);
  {
    // Workers are joined at this point, but resetting the shared state
    // under mu_ keeps the discipline uniform (and the release pairs
    // with the new workers' first acquire).
    std::lock_guard<std::mutex> lk(mu_);
    consumed_ = 0;
    released_ = 0;
    leased_ = false;
    has_error_ = false;
    error_.clear();
    stop_.store(false);
    for (auto& b : ring_) {
      b->remaining.store(0);
      b->ready = false;
      b->pad = 0;
    }
    // Pre-mark per-batch remaining counters lazily: a batch buffer is
    // claimed when the first worker touches it; remaining counts down
    // from batch_size.
    for (size_t b = 0;
         b < std::min(static_cast<size_t>(kDepth), num_batches_); ++b)
      ring_[b % kDepth]->remaining.store(p_.batch_size);
  }
  epoch_running_ = true;
  int nthreads = std::max(1, p_.num_threads);
  for (int t = 0; t < nthreads; ++t)
    workers_.emplace_back(&ImageRecordLoader::WorkerLoop, this, t);
}

void ImageRecordLoader::StopWorkers() {
  {
    // Predicate store under the cv mutex: a worker between predicate
    // check and block holds mu_, and a store+notify in that window is
    // a lost wakeup (same class as the Engine::~Engine fix).
    std::lock_guard<std::mutex> lk(mu_);
    stop_.store(true);
  }
  cv_space_.notify_all();
  cv_ready_.notify_all();
  for (auto& w : workers_) w.join();
  workers_.clear();
  epoch_running_ = false;
}

void ImageRecordLoader::WorkerLoop(int tid) {
  try {
    WorkerBody(tid);
  } catch (const std::exception& e) {
    std::lock_guard<std::mutex> lk(mu_);
    if (!has_error_) {
      has_error_ = true;
      error_ = e.what();
    }
    stop_.store(true);
    cv_ready_.notify_all();
    cv_space_.notify_all();
  }
}

void ImageRecordLoader::WorkerBody(int tid) {
  RecordIOReader reader(rec_path_);
  std::string rec;
  DecodedImage img, resized, *cur;
  std::mt19937_64 rng(p_.seed * 2654435761u + tid * 40503u + epoch_);
  // DCT-domain downscale target (train-crop path only): never drop
  // the decoded short side below what resize/crop needs
  int dct_min_short = 0;
  if (p_.dct_scale && p_.rand_crop)
    dct_min_short = p_.resize_short > 0
                        ? p_.resize_short
                        : std::max(p_.height, p_.width);
  const size_t total = num_batches_ * p_.batch_size;
  const size_t hw = static_cast<size_t>(p_.height) * p_.width;

  while (!stop_.load()) {
    size_t slot = cursor_.fetch_add(1);
    if (slot >= total) break;
    size_t batch_id = slot / p_.batch_size;
    int pos = static_cast<int>(slot % p_.batch_size);
    BatchBuf* buf = ring_[batch_id % kDepth].get();

    // wait until this ring slot has been recycled up to batch_id
    {
      std::unique_lock<std::mutex> lk(mu_);
      cv_space_.wait(lk, [&] {
        return stop_.load() || batch_id < released_ + kDepth;
      });
      if (stop_.load()) break;
    }

    size_t oidx = slot;
    bool is_pad = oidx >= order_.size();
    if (is_pad) oidx %= order_.size();  // wrap (round_batch padding)
    const auto& kv = my_keys_[order_[oidx]];
    reader.Seek(kv.second);
    if (!reader.ReadRecord(&rec))
      throw std::runtime_error("record read failed");

    // IRHeader: [flag u32][label f32][id u64][id2 u64] (+flag floats if >0)
    if (rec.size() < 24) throw std::runtime_error("record too small");
    uint32_t flag;
    float single_label;
    memcpy(&flag, rec.data(), 4);
    memcpy(&single_label, rec.data() + 4, 4);
    size_t img_off = 24;
    float* lbl = buf->label.data() + static_cast<size_t>(pos) * p_.label_width;
    if (flag > 0) {
      size_t nl = std::min<size_t>(flag, p_.label_width);
      memcpy(lbl, rec.data() + 24, nl * 4);
      for (size_t i = nl; i < static_cast<size_t>(p_.label_width); ++i) lbl[i] = 0.f;
      img_off += static_cast<size_t>(flag) * 4;
    } else {
      lbl[0] = single_label;
      for (int i = 1; i < p_.label_width; ++i) lbl[i] = 0.f;
    }

    const uint8_t* jpg = reinterpret_cast<const uint8_t*>(rec.data()) + img_off;
    size_t jpg_len = rec.size() - img_off;
    if (!DecodeJPEG(jpg, jpg_len, &img, dct_min_short) &&
        !DecodePNG(jpg, jpg_len, &img)) {
      GetDecodeStats().errors.fetch_add(1, std::memory_order_relaxed);
      throw std::runtime_error("image decode failed (not JPEG/PNG?)");
    }

    cur = &img;
    if (p_.resize_short > 0) {
      int sh = img.h, sw = img.w;
      int oh, ow;
      if (sh < sw) { oh = p_.resize_short; ow = sw * p_.resize_short / sh; }
      else { ow = p_.resize_short; oh = sh * p_.resize_short / sw; }
      if (oh != sh || ow != sw) {
        ResizeBilinear(img, oh, ow, &resized);
        cur = &resized;
      }
    }
    // crop to HxW (random or center); if smaller, resize up first
    if (cur->h < p_.height || cur->w < p_.width) {
      DecodedImage tmp;
      ResizeBilinear(*cur, std::max(cur->h, p_.height),
                     std::max(cur->w, p_.width), &tmp);
      if (cur == &img) { resized = std::move(tmp); cur = &resized; }
      else { *cur = std::move(tmp); }
    }
    int y0, x0;
    if (p_.rand_crop) {
      y0 = cur->h > p_.height ? static_cast<int>(rng() % (cur->h - p_.height + 1)) : 0;
      x0 = cur->w > p_.width ? static_cast<int>(rng() % (cur->w - p_.width + 1)) : 0;
    } else {
      y0 = (cur->h - p_.height) / 2;
      x0 = (cur->w - p_.width) / 2;
    }
    bool mirror = p_.rand_mirror && (rng() & 1);

    // normalize + layout into the batch buffer
    float* dst = buf->data.data();
    const float inv_std[3] = {1.f / p_.std[0], 1.f / p_.std[1], 1.f / p_.std[2]};
    for (int y = 0; y < p_.height; ++y) {
      const uint8_t* srow = cur->pixels.data() +
          (static_cast<size_t>(y0 + y) * cur->w + x0) * cur->c;
      for (int x = 0; x < p_.width; ++x) {
        int sx = mirror ? (p_.width - 1 - x) : x;
        for (int ch = 0; ch < p_.channels; ++ch) {
          float v = (srow[sx * cur->c + ch] * p_.scale - p_.mean[ch]) * inv_std[ch];
          size_t di;
          if (p_.layout_nhwc)
            di = ((static_cast<size_t>(pos) * p_.height + y) * p_.width + x) *
                     p_.channels + ch;
          else
            di = ((static_cast<size_t>(pos) * p_.channels + ch) * hw) +
                 static_cast<size_t>(y) * p_.width + x;
          dst[di] = v;
        }
      }
    }
    if (is_pad) {
      std::lock_guard<std::mutex> lk(mu_);
      buf->pad += 1;
    }

    if (buf->remaining.fetch_sub(1) == 1) {
      std::lock_guard<std::mutex> lk(mu_);
      buf->ready = true;
      cv_ready_.notify_all();
    }
  }
}

int ImageRecordLoader::Next(const float** data, const float** label, int* pad) {
  // Release the buffer leased by the previous call: its ring slot becomes
  // writable for batch released_ + kDepth.  Doing this at the START of the
  // following call keeps the handed-out pointers valid in between.
  {
    std::lock_guard<std::mutex> lk(mu_);
    if (leased_) {
      BatchBuf* old = ring_[released_ % kDepth].get();
      old->ready = false;
      old->pad = 0;
      old->remaining.store(p_.batch_size);
      released_ += 1;
      leased_ = false;
      cv_space_.notify_all();
    }
  }
  if (consumed_ >= num_batches_) return 0;
  BatchBuf* buf = ring_[consumed_ % kDepth].get();
  {
    std::unique_lock<std::mutex> lk(mu_);
    cv_ready_.wait(lk, [&] { return buf->ready || stop_.load(); });
    if (has_error_) throw std::runtime_error("ImageRecordLoader: " + error_);
  }
  *data = buf->data.data();
  *label = buf->label.data();
  // mxlint: allow(guarded-field) -- read after ready was observed true
  // under mu_: the workers' pad writes happen-before the ready store,
  // and nothing writes this buffer again until it is released below
  *pad = buf->pad;
  {
    std::lock_guard<std::mutex> lk(mu_);
    consumed_ += 1;
    leased_ = true;
  }
  return p_.batch_size;
}

void ImageRecordLoader::Reset() {
  epoch_ += 1;
  StartEpoch();
}

}  // namespace mxnet_tpu
