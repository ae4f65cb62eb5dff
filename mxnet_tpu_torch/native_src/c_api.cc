// C ABI implementation — exception→error translation at the boundary.
// Reference: src/c_api/c_api.cc (MXAPIErrorMessage / MXGetLastError TLS
// pattern).
#include "c_api.h"

#include <cstring>
#include <memory>
#include <string>

#include "engine.h"
#include "image_loader.h"
#include "recordio.h"
#include "storage.h"

namespace {

thread_local std::string g_last_error;

int HandleError(const std::exception& e) {
  g_last_error = e.what();
  return -1;
}

#define API_BEGIN() try {
#define API_END()                 \
  }                               \
  catch (const std::exception& e) { return HandleError(e); } \
  return 0;

struct ReaderState {
  mxnet_tpu::RecordIOReader reader;
  std::string buf;
  explicit ReaderState(const std::string& p) : reader(p) {}
};

std::unique_ptr<mxnet_tpu::Engine> g_engine;
std::mutex g_engine_mu;

mxnet_tpu::Engine* GetEngine() {
  std::lock_guard<std::mutex> lk(g_engine_mu);
  if (!g_engine) {
    const char* env = getenv("MXNET_ENGINE_TYPE");
    bool naive = env && std::string(env) == "NaiveEngine";
    g_engine.reset(new mxnet_tpu::Engine(0, naive));
  }
  return g_engine.get();
}

}  // namespace

extern "C" {

const char* MXGetLastError(void) { return g_last_error.c_str(); }

/* ----- RecordIO ---------------------------------------------------------- */

int MXRecordIOReaderCreate(const char* path, RecordIOReaderHandle* out) {
  API_BEGIN();
  *out = new ReaderState(path);
  API_END();
}

int MXRecordIOReaderFree(RecordIOReaderHandle h) {
  delete static_cast<ReaderState*>(h);
  return 0;
}

int MXRecordIOReaderReadRecord(RecordIOReaderHandle h, const char** out,
                               size_t* size) {
  API_BEGIN();
  auto* s = static_cast<ReaderState*>(h);
  if (s->reader.ReadRecord(&s->buf)) {
    *out = s->buf.data();
    *size = s->buf.size();
  } else {
    *out = nullptr;
    *size = 0;
  }
  API_END();
}

int MXRecordIOReaderSeek(RecordIOReaderHandle h, uint64_t offset) {
  API_BEGIN();
  static_cast<ReaderState*>(h)->reader.Seek(offset);
  API_END();
}

int MXRecordIOReaderTell(RecordIOReaderHandle h, uint64_t* out) {
  API_BEGIN();
  *out = static_cast<ReaderState*>(h)->reader.Tell();
  API_END();
}

int MXRecordIOWriterCreate(const char* path, RecordIOWriterHandle* out) {
  API_BEGIN();
  *out = new mxnet_tpu::RecordIOWriter(path);
  API_END();
}

int MXRecordIOWriterFree(RecordIOWriterHandle h) {
  delete static_cast<mxnet_tpu::RecordIOWriter*>(h);
  return 0;
}

int MXRecordIOWriterWriteRecord(RecordIOWriterHandle h, const char* buf,
                                size_t size) {
  API_BEGIN();
  static_cast<mxnet_tpu::RecordIOWriter*>(h)->WriteRecord(buf, size);
  API_END();
}

int MXRecordIOWriterTell(RecordIOWriterHandle h, uint64_t* out) {
  API_BEGIN();
  *out = static_cast<mxnet_tpu::RecordIOWriter*>(h)->Tell();
  API_END();
}

/* ----- image pipeline ---------------------------------------------------- */

int MXImageRecordLoaderCreateEx(
    const char* rec_path, const char* idx_path, int batch_size, int height,
    int width, int channels, int num_threads, int shuffle, uint64_t seed,
    int part_index, int num_parts, int rand_crop, int rand_mirror,
    int resize_short, int label_width, const float* mean, const float* std_,
    float scale, int layout_nhwc, int round_batch, int dct_scale,
    ImageLoaderHandle* out) {
  API_BEGIN();
  mxnet_tpu::ImageRecParams p;
  p.batch_size = batch_size;
  p.height = height;
  p.width = width;
  p.channels = channels;
  p.num_threads = num_threads;
  p.shuffle = shuffle;
  p.seed = seed;
  p.part_index = part_index;
  p.num_parts = num_parts;
  p.rand_crop = rand_crop;
  p.rand_mirror = rand_mirror;
  p.resize_short = resize_short;
  p.label_width = label_width;
  for (int i = 0; i < 3; ++i) {
    p.mean[i] = mean ? mean[i] : 0.f;
    p.std[i] = std_ ? std_[i] : 1.f;
  }
  p.scale = scale;
  p.layout_nhwc = layout_nhwc;
  p.round_batch = round_batch;
  p.dct_scale = dct_scale;
  *out = new mxnet_tpu::ImageRecordLoader(rec_path, idx_path, p);
  API_END();
}

int MXImageRecordLoaderCreate(
    const char* rec_path, const char* idx_path, int batch_size, int height,
    int width, int channels, int num_threads, int shuffle, uint64_t seed,
    int part_index, int num_parts, int rand_crop, int rand_mirror,
    int resize_short, int label_width, const float* mean, const float* std_,
    float scale, int layout_nhwc, int round_batch, ImageLoaderHandle* out) {
  return MXImageRecordLoaderCreateEx(
      rec_path, idx_path, batch_size, height, width, channels, num_threads,
      shuffle, seed, part_index, num_parts, rand_crop, rand_mirror,
      resize_short, label_width, mean, std_, scale, layout_nhwc, round_batch,
      /*dct_scale=*/1, out);
}

int MXImageRecordLoaderNext(ImageLoaderHandle h, const float** data,
                            const float** label, int* pad, int* out_bs) {
  API_BEGIN();
  *out_bs = static_cast<mxnet_tpu::ImageRecordLoader*>(h)->Next(data, label,
                                                                pad);
  API_END();
}

int MXImageRecordLoaderReset(ImageLoaderHandle h) {
  API_BEGIN();
  static_cast<mxnet_tpu::ImageRecordLoader*>(h)->Reset();
  API_END();
}

int MXImageRecordLoaderNumSamples(ImageLoaderHandle h, int64_t* out) {
  API_BEGIN();
  *out = static_cast<mxnet_tpu::ImageRecordLoader*>(h)->num_samples();
  API_END();
}

int MXImageRecordLoaderFree(ImageLoaderHandle h) {
  delete static_cast<mxnet_tpu::ImageRecordLoader*>(h);
  return 0;
}

int MXImageDecode(const uint8_t* data, size_t size, int* h, int* w, int* c,
                  uint8_t* out_buf, size_t out_buf_size) {
  API_BEGIN();
  mxnet_tpu::DecodedImage img;
  if (!mxnet_tpu::DecodeJPEG(data, size, &img) &&
      !mxnet_tpu::DecodePNG(data, size, &img)) {
    mxnet_tpu::GetDecodeStats().errors.fetch_add(1,
                                                 std::memory_order_relaxed);
    throw std::runtime_error("MXImageDecode: unsupported image format");
  }
  *h = img.h;
  *w = img.w;
  *c = img.c;
  if (out_buf) {
    if (out_buf_size < img.pixels.size())
      throw std::runtime_error("MXImageDecode: buffer too small");
    memcpy(out_buf, img.pixels.data(), img.pixels.size());
  }
  API_END();
}

int MXImageDecodeAlloc(const uint8_t* data, size_t size, int* h, int* w,
                       int* c, uint8_t** out_buf) {
  API_BEGIN();
  mxnet_tpu::DecodedImage img;
  if (!mxnet_tpu::DecodeJPEG(data, size, &img) &&
      !mxnet_tpu::DecodePNG(data, size, &img)) {
    mxnet_tpu::GetDecodeStats().errors.fetch_add(1,
                                                 std::memory_order_relaxed);
    throw std::runtime_error("MXImageDecodeAlloc: unsupported image format");
  }
  *h = img.h;
  *w = img.w;
  *c = img.c;
  *out_buf = static_cast<uint8_t*>(malloc(img.pixels.size()));
  if (!*out_buf) throw std::runtime_error("MXImageDecodeAlloc: oom");
  memcpy(*out_buf, img.pixels.data(), img.pixels.size());
  API_END();
}

int MXBufferFree(void* p) {
  free(p);
  return 0;
}

int MXImageDecodeProfile(const uint8_t* data, size_t size, int reps,
                         int min_short, double* out_ms) {
  API_BEGIN();
  if (!mxnet_tpu::ProfileJPEGStages(data, size, reps, min_short, out_ms))
    throw std::runtime_error("MXImageDecodeProfile: not a decodable JPEG");
  API_END();
}

int MXImageDecodeProfileStats(uint64_t* jpeg, uint64_t* png,
                              uint64_t* dct_scaled, uint64_t* errors) {
  API_BEGIN();
  mxnet_tpu::DecodeStats& s = mxnet_tpu::GetDecodeStats();
  *jpeg = s.jpeg.load(std::memory_order_relaxed);
  *png = s.png.load(std::memory_order_relaxed);
  *dct_scaled = s.dct_scaled.load(std::memory_order_relaxed);
  *errors = s.errors.load(std::memory_order_relaxed);
  API_END();
}

int MXImageDecodeProfileReset(void) {
  API_BEGIN();
  mxnet_tpu::ResetDecodeStats();
  API_END();
}

/* ----- engine ------------------------------------------------------------ */

int MXEngineInit(int engine_type, int num_workers) {
  API_BEGIN();
  std::lock_guard<std::mutex> lk(g_engine_mu);
  g_engine.reset(new mxnet_tpu::Engine(num_workers, engine_type == 1));
  API_END();
}

int MXEngineNewVar(EngineVarHandle* out) {
  API_BEGIN();
  *out = GetEngine()->NewVar();
  API_END();
}

int MXEngineDeleteVar(EngineVarHandle var) {
  API_BEGIN();
  GetEngine()->DeleteVar(static_cast<mxnet_tpu::EngineVar*>(var));
  API_END();
}

int MXEnginePushAsync(MXEngineFn fn, void* param, MXEngineDeleter deleter,
                      EngineVarHandle* const_vars, int num_const,
                      EngineVarHandle* mutate_vars, int num_mutate,
                      int priority, const char* name) {
  API_BEGIN();
  std::vector<mxnet_tpu::EngineVar*> cv(num_const), mv(num_mutate);
  for (int i = 0; i < num_const; ++i)
    cv[i] = static_cast<mxnet_tpu::EngineVar*>(const_vars[i]);
  for (int i = 0; i < num_mutate; ++i)
    mv[i] = static_cast<mxnet_tpu::EngineVar*>(mutate_vars[i]);
  GetEngine()->PushAsync(
      [fn, param, deleter](std::string* err) -> int {
        char buf[512];
        buf[0] = '\0';
        int rc = fn(param, buf, sizeof(buf));
        if (rc != 0) *err = buf[0] ? buf : "engine op failed";
        if (deleter) deleter(param);
        return rc;
      },
      std::move(cv), std::move(mv), priority, name ? name : "");
  API_END();
}

int MXEngineWaitForVar(EngineVarHandle var) {
  API_BEGIN();
  std::string err =
      GetEngine()->WaitForVar(static_cast<mxnet_tpu::EngineVar*>(var));
  if (!err.empty()) throw std::runtime_error(err);
  API_END();
}

int MXEngineWaitForAll(void) {
  API_BEGIN();
  std::string err = GetEngine()->WaitForAll();
  if (!err.empty()) throw std::runtime_error(err);
  API_END();
}

int MXEngineVarVersion(EngineVarHandle var, uint64_t* out) {
  API_BEGIN();
  auto* v = static_cast<mxnet_tpu::EngineVar*>(var);
  std::lock_guard<std::mutex> lk(v->mu);
  *out = v->version;
  API_END();
}

int MXEngineStats(uint64_t* ops_dispatched, uint64_t* ops_executed,
                  uint64_t* worker_wakeups, uint64_t* queue_depth,
                  uint64_t* outstanding, uint64_t* workers) {
  API_BEGIN();
  mxnet_tpu::Engine::Stats s = GetEngine()->GetStats();
  *ops_dispatched = s.ops_dispatched;
  *ops_executed = s.ops_executed;
  *worker_wakeups = s.worker_wakeups;
  *queue_depth = s.queue_depth;
  *outstanding = s.outstanding;
  *workers = s.workers;
  API_END();
}

/* ----- storage ----------------------------------------------------------- */

int MXStorageAlloc(size_t size, void** out) {
  API_BEGIN();
  *out = mxnet_tpu::PooledStorage::Get()->Alloc(size);
  API_END();
}

int MXStorageFree(void* ptr) {
  API_BEGIN();
  mxnet_tpu::PooledStorage::Get()->Free(ptr);
  API_END();
}

int MXStorageReleaseAll(void) {
  API_BEGIN();
  mxnet_tpu::PooledStorage::Get()->ReleaseAll();
  API_END();
}

int MXStorageStats(uint64_t* allocated, uint64_t* pooled,
                   uint64_t* num_allocs) {
  API_BEGIN();
  mxnet_tpu::PooledStorage::Get()->Stats(allocated, pooled, num_allocs);
  API_END();
}

/* ----- shm --------------------------------------------------------------- */

int MXShmCreate(const char* name, size_t size, ShmHandle* out) {
  API_BEGIN();
  *out = new mxnet_tpu::ShmSegment(name, size, /*create=*/true);
  API_END();
}

int MXShmAttach(const char* name, ShmHandle* out) {
  API_BEGIN();
  *out = new mxnet_tpu::ShmSegment(name, 0, /*create=*/false);
  API_END();
}

int MXShmData(ShmHandle h, void** out, size_t* size) {
  API_BEGIN();
  auto* s = static_cast<mxnet_tpu::ShmSegment*>(h);
  *out = s->data();
  *size = s->size();
  API_END();
}

int MXShmUnlink(ShmHandle h) {
  API_BEGIN();
  static_cast<mxnet_tpu::ShmSegment*>(h)->Unlink();
  API_END();
}

int MXShmFree(ShmHandle h) {
  delete static_cast<mxnet_tpu::ShmSegment*>(h);
  return 0;
}

/* ----- libinfo ----------------------------------------------------------- */

const char* MXLibInfoFeatures(void) {
  return "RECORDIO,IMAGE_JPEG,IMAGE_PNG,IMAGE_LOADER,ENGINE,NAIVE_ENGINE,"
         "SHM,STORAGE_POOL,ENGINE_STATS,DECODE_STATS";
}

}  /* extern "C" */
