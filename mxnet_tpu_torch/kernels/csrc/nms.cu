// Greedy non-maximum suppression for Hopper (sm_90a), plain C interface:
// the keep mask of score-sorted boxes, one image per row of a batch.
//
// Replaces no TPU kernel.  The reference leaves NMS to XLA:
// mxnet_tpu/ops/vision.py _nms_keep (:108) builds the N x N IoU matrix
// and runs a lax.scan of N steps over its rows.  Ported as torch ops that
// is a Python loop of N steps with several launches each (about 35k
// launches a decode at SSD300's 8732 anchors) over a matrix of 305 MB an
// image.  This kernel computes the same keep mask in two launches:
//
//   keep[i] = valid[i] && !(exists j < i: keep[j] && iou(j, i) > thresh
//                                        && (force || id[j] == id[i]))
//
// nms_mask: block (cb, rb, b) of 64 threads; thread t owns row
//   j = rb * 64 + t and writes word cb of its row: bit k set when box
//   i = cb * 64 + k comes after j (i > j) and j would suppress it.  Only
//   the words cb >= rb are written, the only ones the sweep reads; rows of
//   invalid boxes are skipped (an invalid box is never kept).
// nms_sweep: one warp per image walks the rows in score order.  The
//   words of boxes removed so far sit in shared memory; a row that is
//   valid and not removed is kept, and its mask row is ORed in, one word
//   per lane.  32 rows' valid flags come in one load and one ballot.
//
// The IoU is the reference's _pairwise_iou(lhs=j, rhs=i) in the same
// order, every operation written with __fadd_rn / __fsub_rn / __fmul_rn /
// __fdiv_rn so that nvcc contracts nothing into an FMA: each rounds once,
// as PyTorch's eager ops on the CPU do, and no box crosses the threshold
// because of a fused multiply-add.  IoU is symmetric in (j, i) bit for bit
// (max, min and the two areas' sum commute).
//
// What bounds it on an H100: the sweep's serial walk.  The bytes the
// function must move are its inputs and the keep mask (22 bytes a box);
// the mask matrix (N * ceil(N / 64) * 8 bytes an image) is scratch.  A
// kept row costs one latency of its mask row's load; a removed or
// invalid row a shared-memory read.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 64;

__device__ __forceinline__ float area(float x0, float y0, float x1, float y1) {
  return __fmul_rn(fmaxf(__fsub_rn(x1, x0), 0.f), fmaxf(__fsub_rn(y1, y0), 0.f));
}

// iou(l, r) > thresh, the reference's arithmetic
__device__ __forceinline__ bool over(const float4& l, float al, const float4& r,
                                     float ar, float thresh) {
  float w = fmaxf(__fsub_rn(fminf(l.z, r.z), fmaxf(l.x, r.x)), 0.f);
  float h = fmaxf(__fsub_rn(fminf(l.w, r.w), fmaxf(l.y, r.y)), 0.f);
  float inter = __fmul_rn(w, h);
  float uni = __fsub_rn(__fadd_rn(al, ar), inter);
  float iou = uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
  return iou > thresh;
}

__global__ void __launch_bounds__(BLOCK)
    nms_mask(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
             const float* __restrict__ ids, int n, int words, float thresh,
             unsigned long long* __restrict__ mask) {
  const int cb = blockIdx.x, rb = blockIdx.y, b = blockIdx.z;
  if (cb < rb) return;
  __shared__ float4 col[BLOCK];
  __shared__ float col_area[BLOCK];
  __shared__ float col_id[BLOCK];
  const float4* img = boxes + (size_t)b * n;
  const int t = threadIdx.x;
  const int ci = cb * BLOCK + t;
  if (ci < n) {
    float4 c = img[ci];
    col[t] = c;
    col_area[t] = area(c.x, c.y, c.z, c.w);
    col_id[t] = ids ? ids[(size_t)b * n + ci] : 0.f;
  }
  __syncthreads();
  const int j = rb * BLOCK + t;
  if (j >= n || !valid[(size_t)b * n + j]) return;
  const float4 r = img[j];
  const float ar = area(r.x, r.y, r.z, r.w);
  const float id = ids ? ids[(size_t)b * n + j] : 0.f;
  const int lo = cb == rb ? t + 1 : 0;
  const int hi = min(BLOCK, n - cb * BLOCK);
  unsigned long long bits = 0;
  for (int k = lo; k < hi; ++k) {
    if ((!ids || col_id[k] == id) && over(r, ar, col[k], col_area[k], thresh))
      bits |= 1ull << k;
  }
  mask[((size_t)b * n + j) * words + cb] = bits;
}

__global__ void __launch_bounds__(32)
    nms_sweep(const uint8_t* __restrict__ valid,
              const unsigned long long* __restrict__ mask, int n, int words,
              uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];
  const int b = blockIdx.x, lane = threadIdx.x;
  const uint8_t* v = valid + (size_t)b * n;
  const unsigned long long* m = mask + (size_t)b * n * words;
  uint8_t* out = keep + (size_t)b * n;
  for (int w = lane; w < words; w += 32) removed[w] = 0;
  __syncwarp();
  for (int base = 0; base < n; base += 32) {
    const int i0 = base + lane;
    const unsigned live = __ballot_sync(0xffffffffu, i0 < n && v[i0]);
    unsigned kept = 0;
    for (unsigned rest = live; rest; rest &= rest - 1) {
      const int k = __ffs(rest) - 1;
      const int i = base + k;
      if (removed[i >> 6] >> (i & 63) & 1ull) continue;
      kept |= 1u << k;
      const unsigned long long* row = m + (size_t)i * words;
      for (int w = (i >> 6) + lane; w < words; w += 32) removed[w] |= row[w];
      __syncwarp();
    }
    if (i0 < n) out[i0] = kept >> lane & 1u;
  }
}

}  // namespace

extern "C" {

// boxes (B, n, 4) f32 corner boxes, sorted by score within each image;
// valid (B, n) bytes; ids (B, n) f32 class ids or null (suppress across
// classes); mask scratch (B, n, words) with words = ceil(n / 64); keep
// (B, n) bytes.  16-byte aligned boxes.  Returns cudaGetLastError().
int mxt_nms_keep(const void* boxes, const void* valid, const void* ids, int B,
                 int n, float thresh, void* mask, void* keep, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int words = (n + 63) / 64;
  dim3 grid(words, words, B);
  nms_mask<<<grid, BLOCK, 0, s>>>((const float4*)boxes, (const uint8_t*)valid,
                                  (const float*)ids, n, words, thresh,
                                  (unsigned long long*)mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)words * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_sweep,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_sweep<<<B, 32, smem, s>>>((const uint8_t*)valid,
                                (const unsigned long long*)mask, n, words,
                                (uint8_t*)keep);
  return (int)cudaGetLastError();
}

}  // extern "C"
