// Paged single-token attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel mxnet_tpu/kernels/paged_attention.py
// (pl.pallas_call in _build at :209, body _kernel at :82, entry
// paged_attention at :221): each row t attends with its query
// q[t, h, :] to the positions 0..pos[t] of its sequence, whose k|v live
// in pages of the pool named by the row's block table.  Online softmax
// over pages; pages past pos are skipped and the last page is masked by
// k_pos <= pos with -1e30 exactly like the Pallas body (:132).  For an
// int8 pool the k scale (plane 0) multiplies the scores and the v scale
// (plane 1) multiplies p after the denominator update, as at :129/:142.
//
// What bounds it on an H100: a decode step reads every live position's
// k|v once and does 4*dh FLOPs per (row, head, position) against
// 2*2*dh bytes (bf16) — about one FLOP per byte — so it is bound by
// bytes: sum over rows of the pages it walks * ps*H*2*dh*elem, over
// 3.35 TB/s.
//
// Design (simple and correct first): one block per (row, head); the
// block reads its page ids from bt and its pos itself (no scalar
// prefetch).  Each visited page's (ps, 2*dh) slice for the head is
// staged through shared memory as f32 with contiguous per-token runs
// (coalesced), scores are warp-reduced dot products, and every thread
// owns one output dim and its f32 accumulator.  p is rounded to the
// compute dtype before the PV product (the Pallas ``p.astype(cdt)``).
// Dead engine rows point at an all-zero block-table row (scratch page
// 0) with pos 0 and read one finite scratch slot.  The wrapper checks
// every shape and dtype; the caller guarantees page ids < num_pages.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename TQ, typename TKV, bool INT8>
__global__ void paged_attention_kernel(const TQ* __restrict__ q,
                                       const TKV* __restrict__ pool,
                                       const float* __restrict__ scales,
                                       const int* __restrict__ bt,
                                       const int* __restrict__ pos,
                                       float* __restrict__ out, int H, int dh,
                                       int ps, int PP, float sqrt_dh) {
  extern __shared__ float smem[];
  const int two_dh = 2 * dh;
  float* qs = smem;                 // (dh)
  float* kvs = qs + dh;             // (ps, 2*dh)
  float* sc = kvs + ps * two_dh;    // (ps) scores
  float* ksc = sc + ps;             // (ps) k scales
  float* vsc = ksc + ps;            // (ps) v scales

  const int t = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int p = pos[t];
  // positions past the view (PP pages) do not exist in the reference
  const int last = min(p / ps, PP - 1);
  const size_t tok_stride = (size_t)H * two_dh;

  if (tid < dh) qs[tid] = to_f(q[((size_t)t * H + h) * dh + tid]);
  float m = -INFINITY, l = 0.f, acc = 0.f;

  for (int j = 0; j <= last; ++j) {
    const int page = bt[(size_t)t * PP + j];
    __syncthreads();  // the previous page is consumed (and qs is loaded)
    const TKV* src = pool + (size_t)page * ps * tok_stride + (size_t)h * two_dh;
    for (int idx = tid; idx < ps * two_dh; idx += nt) {
      const int i = idx / two_dh, e = idx - i * two_dh;
      kvs[idx] = to_f(src[(size_t)i * tok_stride + e]);
    }
    if (INT8) {
      for (int i = tid; i < ps; i += nt) {
        ksc[i] = scales[(((size_t)page * 2 + 0) * ps + i) * H + h];
        vsc[i] = scales[(((size_t)page * 2 + 1) * ps + i) * H + h];
      }
    }
    __syncthreads();
    for (int i = warp; i < ps; i += nwarps) {
      float part = 0.f;
      for (int d = lane; d < dh; d += 32) part += qs[d] * kvs[i * two_dh + d];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) {
        float s = part;
        if (INT8) s *= ksc[i];
        s = s / sqrt_dh;
        sc[i] = (j * ps + i <= p) ? s : -1e30f;
      }
    }
    __syncthreads();
    float mt = -INFINITY;
    for (int i = 0; i < ps; ++i) mt = fmaxf(mt, sc[i]);
    const float mn = fmaxf(m, mt);
    const float alpha = expf(m - mn);
    float psum = 0.f, pv = 0.f;
    for (int i = 0; i < ps; ++i) {
      const float e = expf(sc[i] - mn);
      psum += e;
      float w = INT8 ? e * vsc[i] : e;   // v scale after the denominator
      w = round_to<TQ>(w);                // p.astype(cdt) before the V dot
      if (tid < dh) pv += w * kvs[i * two_dh + dh + tid];
    }
    l = l * alpha + psum;
    acc = acc * alpha + pv;
    m = mn;
  }
  if (tid < dh) out[((size_t)t * H + h) * dh + tid] = acc / l;
}

template <typename TQ, typename TKV, bool INT8>
int launch(const void* q, const void* pool, const void* scales, const void* bt,
           const void* pos, void* out, int T, int H, int dh, int ps, int PP,
           float sqrt_dh, cudaStream_t st) {
  const int nt = ((dh + 31) / 32) * 32;
  const size_t smem = (size_t)(dh + ps * 2 * dh + 3 * ps) * sizeof(float);
  auto kern = paged_attention_kernel<TQ, TKV, INT8>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(T, H), nt, smem, st>>>((const TQ*)q, (const TKV*)pool,
                                      (const float*)scales, (const int*)bt,
                                      (const int*)pos, (float*)out, H, dh, ps, PP,
                                      sqrt_dh);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (T, H, dh) f32 (bf16 == 0) or bf16 (bf16 == 1); pool: (NP, ps, H,
// 2*dh) in q's dtype, or int8 (kv_int8 == 1) with scales (NP, 2, ps, H)
// f32; bt: (T, PP) int32; pos: (T,) int32; out: (T, H, dh) f32.  All
// contiguous.  dh <= 256.  Returns cudaGetLastError() after the launch.
extern "C" int mxt_paged_attention(const void* q, const void* pool,
                                   const void* scales, const void* bt,
                                   const void* pos, void* out, int T, int H,
                                   int dh, int ps, int PP, int bf16, int kv_int8,
                                   float sqrt_dh, void* stream) {
  if (T * H == 0) return 0;
  if (dh < 1 || dh > 256 || ps < 1 || PP < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16 && kv_int8)
    return launch<__nv_bfloat16, int8_t, true>(q, pool, scales, bt, pos, out, T, H,
                                               dh, ps, PP, sqrt_dh, st);
  if (bf16)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(q, pool, scales, bt, pos, out,
                                                       T, H, dh, ps, PP, sqrt_dh, st);
  if (kv_int8)
    return launch<float, int8_t, true>(q, pool, scales, bt, pos, out, T, H, dh, ps,
                                       PP, sqrt_dh, st);
  return launch<float, float, false>(q, pool, scales, bt, pos, out, T, H, dh, ps, PP,
                                     sqrt_dh, st);
}
