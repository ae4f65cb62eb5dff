/* Flat C ABI of the port's native runtime (a copy of mxnet_tpu's
 * native/include/mxnet_tpu/c_api.h).
 *
 * Upstream: include/mxnet/c_api.h — flat extern "C" entry points with
 * exception→error-code translation and MXGetLastError.  Same conventions
 * here: every function returns 0 on success and -1 on failure with the
 * message retrievable via MXGetLastError() (thread local).  Handles are
 * opaque pointers.
 *
 * Scope: the host runtime — RecordIO, the threaded image pipeline, the
 * dependency engine, pooled host storage and shm segments.  Tensor math
 * is torch's; it does not cross this ABI.
 */
#ifndef MXNET_TPU_C_API_H_
#define MXNET_TPU_C_API_H_

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef void* RecordIOReaderHandle;
typedef void* RecordIOWriterHandle;
typedef void* ImageLoaderHandle;
typedef void* EngineVarHandle;
typedef void* ShmHandle;

/* ----- error handling ---------------------------------------------------- */
const char* MXGetLastError(void);

/* ----- RecordIO ---------------------------------------------------------- */
int MXRecordIOReaderCreate(const char* path, RecordIOReaderHandle* out);
int MXRecordIOReaderFree(RecordIOReaderHandle h);
/* *out points into an internal buffer valid until the next read; *size==0
 * and *out==NULL at EOF. */
int MXRecordIOReaderReadRecord(RecordIOReaderHandle h, const char** out,
                               size_t* size);
int MXRecordIOReaderSeek(RecordIOReaderHandle h, uint64_t offset);
int MXRecordIOReaderTell(RecordIOReaderHandle h, uint64_t* out);
int MXRecordIOWriterCreate(const char* path, RecordIOWriterHandle* out);
int MXRecordIOWriterFree(RecordIOWriterHandle h);
int MXRecordIOWriterWriteRecord(RecordIOWriterHandle h, const char* buf,
                                size_t size);
int MXRecordIOWriterTell(RecordIOWriterHandle h, uint64_t* out);

/* ----- threaded image pipeline ------------------------------------------ */
/* mean/std are 3-element arrays. layout_nhwc: 1 = NHWC,
 * 0 = NCHW (reference default). */
int MXImageRecordLoaderCreate(
    const char* rec_path, const char* idx_path, int batch_size, int height,
    int width, int channels, int num_threads, int shuffle, uint64_t seed,
    int part_index, int num_parts, int rand_crop, int rand_mirror,
    int resize_short, int label_width, const float* mean, const float* std_,
    float scale, int layout_nhwc, int round_batch, ImageLoaderHandle* out);
/* As above plus dct_scale: 1 allows DCT-domain 1/2^k downscale decode on
 * the rand_crop (train) path when the source short side stays >= the
 * resize/crop target; 0 always decodes at full scale. */
int MXImageRecordLoaderCreateEx(
    const char* rec_path, const char* idx_path, int batch_size, int height,
    int width, int channels, int num_threads, int shuffle, uint64_t seed,
    int part_index, int num_parts, int rand_crop, int rand_mirror,
    int resize_short, int label_width, const float* mean, const float* std_,
    float scale, int layout_nhwc, int round_batch, int dct_scale,
    ImageLoaderHandle* out);
/* Fills pointers to the loader-owned batch (valid until next call); returns
 * batch_size via *out_bs, 0 at epoch end; *pad = wrapped padding samples. */
int MXImageRecordLoaderNext(ImageLoaderHandle h, const float** data,
                            const float** label, int* pad, int* out_bs);
int MXImageRecordLoaderReset(ImageLoaderHandle h);
int MXImageRecordLoaderNumSamples(ImageLoaderHandle h, int64_t* out);
int MXImageRecordLoaderFree(ImageLoaderHandle h);

/* ----- standalone image decode (imdecode parity) ------------------------ */
/* Decodes JPEG/PNG into caller-provided or loader-allocated HWC uint8
 * buffer.  Two-phase: query dims with out_buf=NULL, then decode. */
int MXImageDecode(const uint8_t* data, size_t size, int* h, int* w, int* c,
                  uint8_t* out_buf, size_t out_buf_size);
/* Single-pass variant: decodes once into a malloc'd buffer the caller
 * releases with MXBufferFree. */
int MXImageDecodeAlloc(const uint8_t* data, size_t size, int* h, int* w,
                       int* c, uint8_t** out_buf);
int MXBufferFree(void* p);
/* Per-stage JPEG decode timing (mean ms over reps) into out_ms[4]:
 * [0] entropy/huffman only, [1] +IDCT (YCbCr, no colorspace conversion),
 * [2] full RGB, [3] RGB with the min_short-guarded DCT-domain scale. */
int MXImageDecodeProfile(const uint8_t* data, size_t size, int reps,
                         int min_short, double* out_ms);
/* Cumulative decode counters across imdecode + the threaded loader
 * (profile passes excluded): successful JPEG/PNG decodes, decodes where
 * the DCT-domain downscale engaged, and decode failures.  Resettable so
 * the Prometheus exporter can publish per-interval pipeline rates. */
int MXImageDecodeProfileStats(uint64_t* jpeg, uint64_t* png,
                              uint64_t* dct_scaled, uint64_t* errors);
int MXImageDecodeProfileReset(void);

/* ----- dependency engine ------------------------------------------------- */
/* fn returns 0 on success; on failure it may write a NUL-terminated message
 * into err_buf (err_len bytes).  deleter (may be NULL) is called with param
 * after the op completes. */
typedef int (*MXEngineFn)(void* param, char* err_buf, int err_len);
typedef void (*MXEngineDeleter)(void* param);

/* engine_type: 0 = threaded (default), 1 = naive (synchronous).
 * Re-creating with a different type resets the process engine. */
int MXEngineInit(int engine_type, int num_workers);
int MXEngineNewVar(EngineVarHandle* out);
int MXEngineDeleteVar(EngineVarHandle var);
int MXEnginePushAsync(MXEngineFn fn, void* param, MXEngineDeleter deleter,
                      EngineVarHandle* const_vars, int num_const,
                      EngineVarHandle* mutate_vars, int num_mutate,
                      int priority, const char* name);
/* Blocks; returns -1 with the var's deferred exception if one is stored. */
int MXEngineWaitForVar(EngineVarHandle var);
int MXEngineWaitForAll(void);
int MXEngineVarVersion(EngineVarHandle var, uint64_t* out);
/* Engine telemetry (always-on relaxed atomics): ops pushed / executed,
 * worker cv wakeups that found work, instantaneous ready-queue depth,
 * in-flight op count, and worker-thread count (0 under NaiveEngine).
 * Feeds the obs layer's Prometheus exposition. */
int MXEngineStats(uint64_t* ops_dispatched, uint64_t* ops_executed,
                  uint64_t* worker_wakeups, uint64_t* queue_depth,
                  uint64_t* outstanding, uint64_t* workers);

/* ----- pooled host storage ---------------------------------------------- */
int MXStorageAlloc(size_t size, void** out);
int MXStorageFree(void* ptr);
int MXStorageReleaseAll(void);
int MXStorageStats(uint64_t* allocated, uint64_t* pooled,
                   uint64_t* num_allocs);

/* ----- shm segments (DataLoader IPC) ------------------------------------ */
int MXShmCreate(const char* name, size_t size, ShmHandle* out);
int MXShmAttach(const char* name, ShmHandle* out);
int MXShmData(ShmHandle h, void** out, size_t* size);
int MXShmUnlink(ShmHandle h);
int MXShmFree(ShmHandle h);

/* ----- runtime feature flags (libinfo parity) --------------------------- */
/* Returns a static comma-separated feature list, e.g.
 * "RECORDIO,IMAGE_JPEG,IMAGE_PNG,ENGINE,SHM,STORAGE_POOL". */
const char* MXLibInfoFeatures(void);

#ifdef __cplusplus
}
#endif

#endif /* MXNET_TPU_C_API_H_ */
