// Grouped SGD update for Hopper (sm_90a), plain C interface: one launch
// updates a whole group of f32 tensors, each with its own lr and wd.
//
// Replaces the TPU kernels of mxnet_tpu/kernels/fused_optimizer.py
// fused_multi_sgd (:99): _sgd_kernel (:76, pl.pallas_call at :134) and
// _sgd_mom_kernel (:86, pl.pallas_call at :144).  Per element, in the
// reference expression's order (the MXNet convention: the momentum
// buffer holds the lr-scaled step):
//
//   g  = clip(grad * rescale) + wd * w       (clip < 0: no clip)
//   m' = mu * m - lr * g;  w' = w + m'       (with momentum)
//   w' = w - lr * g                          (without)
//
// Every product, sum and difference is written with __fmul_rn /
// __fadd_rn / __fsub_rn, so nvcc cannot contract a*b - c*d into an FMA:
// each operation rounds once, as PyTorch's eager per-tensor ops do, and
// the kernel agrees bit for bit with the port's per-tensor sgd_update /
// sgd_mom_update in f32.  The one difference: the kernel always adds
// wd * w, where the per-tensor op skips it at wd == 0; that changes at
// most the sign of a zero.
//
// What bounds it on an H100: bytes.  It reads w, g (and m) and writes w'
// (and m'): 20 bytes an element with momentum, 12 without, and one
// operation per few bytes.  ResNet-50 v1's 25.6 M trainable f32 values
// move 511 MB with momentum: 0.153 ms at 3.35 TB/s.
//
// Design (simple and correct first):
//   * the TPU kernel concatenates the group into one padded 1-D buffer
//     and splits it again afterwards: two extra passes over the
//     parameters.  Here the wrapper passes a device table of one Entry
//     per tensor (its pointers, size, lr, wd and first chunk), copied to
//     the card once per call, and the kernel reads and writes every
//     tensor where it lies;
//   * the group is cut into chunks of CHUNK elements, each chunk within
//     one tensor; block b finds its tensor by a binary search over the
//     tensors' first chunks and walks its chunk, float4 at a time where
//     the tensor's pointers are 16-byte aligned (the tail element by
//     element);
//   * w' goes to a separate output tensor and m' back into m in place.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = THREADS * 4 * 4;  // elements a block walks

// One tensor of the group, as the wrapper packs it (64 bytes).
struct Entry {
  const float* w;
  const float* g;
  float* m;  // nullptr without momentum
  float* out;
  long long n;       // elements
  long long chunk0;  // index of its first chunk in the grid
  float lr, wd;
  int vec;  // 1: every pointer 16-byte aligned
  int pad;
};
static_assert(sizeof(Entry) == 64, "Entry must match the wrapper's layout");

struct Hyper {
  float rescale, clip, mu;
};

template <bool MOM>
__device__ __forceinline__ float update(float w, float g, float* m, float lr,
                                        float wd, const Hyper& h) {
  g = __fmul_rn(g, h.rescale);
  if (h.clip >= 0.f) g = g < -h.clip ? -h.clip : (g > h.clip ? h.clip : g);
  g = __fadd_rn(g, __fmul_rn(wd, w));
  if (MOM) {
    *m = __fsub_rn(__fmul_rn(h.mu, *m), __fmul_rn(lr, g));
    return __fadd_rn(w, *m);
  }
  return __fsub_rn(w, __fmul_rn(lr, g));
}

template <bool MOM>
__global__ void __launch_bounds__(THREADS)
fused_sgd_kernel(const Entry* __restrict__ tab, int ntensors, Hyper h) {
  const long long chunk = blockIdx.x;
  int lo = 0, hi = ntensors - 1;  // the last tensor whose chunk0 <= chunk
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab[mid].chunk0 <= chunk) lo = mid;
    else hi = mid - 1;
  }
  const Entry e = tab[lo];
  const long long start = (chunk - e.chunk0) * CHUNK;
  const long long end = start + CHUNK < e.n ? start + CHUNK : e.n;
  long long i = start;
  if (e.vec) {
    const long long end4 = start + ((end - start) & ~3LL);
    for (long long j = start + 4 * threadIdx.x; j < end4; j += 4 * THREADS) {
      const float4 w = *reinterpret_cast<const float4*>(e.w + j);
      const float4 g = *reinterpret_cast<const float4*>(e.g + j);
      float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
      if (MOM) m = *reinterpret_cast<const float4*>(e.m + j);
      float4 o;
      o.x = update<MOM>(w.x, g.x, &m.x, e.lr, e.wd, h);
      o.y = update<MOM>(w.y, g.y, &m.y, e.lr, e.wd, h);
      o.z = update<MOM>(w.z, g.z, &m.z, e.lr, e.wd, h);
      o.w = update<MOM>(w.w, g.w, &m.w, e.lr, e.wd, h);
      *reinterpret_cast<float4*>(e.out + j) = o;
      if (MOM) *reinterpret_cast<float4*>(e.m + j) = m;
    }
    i = end4;
  }
  for (long long j = i + threadIdx.x; j < end; j += THREADS) {
    float m = MOM ? e.m[j] : 0.f;
    e.out[j] = update<MOM>(e.w[j], e.g[j], &m, e.lr, e.wd, h);
    if (MOM) e.m[j] = m;
  }
}

}  // namespace

// The number of elements one block walks; the wrapper cuts the group
// into chunks of this size.
extern "C" int mxt_fused_sgd_chunk() { return CHUNK; }

// table: ntensors Entry records in device memory, chunk0 ascending and
// every tensor non-empty; nchunks: the total of their chunks.  momentum
// != 0 updates m in place (every Entry's m set); clip < 0 means no clip.
// Returns cudaGetLastError() after the launch.
extern "C" int mxt_fused_sgd(const void* table, int ntensors, long long nchunks,
                             int momentum, float rescale, float clip, float mu,
                             void* stream) {
  if (ntensors == 0 || nchunks == 0) return 0;
  if (nchunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Hyper h{rescale, clip, mu};
  const Entry* tab = (const Entry*)table;
  if (momentum)
    fused_sgd_kernel<true><<<(unsigned)nchunks, THREADS, 0, st>>>(tab, ntensors, h);
  else
    fused_sgd_kernel<false><<<(unsigned)nchunks, THREADS, 0, st>>>(tab, ntensors, h);
  return (int)cudaGetLastError();
}
