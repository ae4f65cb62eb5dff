// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel mxnet_tpu/kernels/flash_attention.py
// _flash_fwd_tpu (pl.pallas_call at :169, body _kernel at :85): attention
// over (B, T, H, dh) with an online softmax over key tiles, the (B, T)
// key-padding mask, the causal bound that stops at the diagonal tile,
// the positional-hash attention dropout (:117-123), and the per-row
// logsumexp (B, H, T) f32 that the backward kernels (flash_bwd.cu) read.
//
// What bounds it on an H100: at the serving path's shapes (B=4, H=12,
// dh=64, T <= 512, bf16) it is bound by bytes: q, k, v and o are
// 4*B*T*H*dh*2 bytes (12.6 MB at T=512, 3.8 us at 3.35 TB/s) against
// 4*B*H*dh*T(T+1)/2 causal FLOPs (1.6 GFLOP, 1.7 us at 989 TFLOP/s of
// bf16 tensor-core work).  Past T ~ 1.2k the operations bound instead;
// in f32 (67 TFLOP/s outside the tensor cores) already past T ~ 100.
//
// Design (simple and correct first; wgmma/TMA come in a later PR):
//   * one block of 128 threads per (b*h, BQ-row q tile); TPR threads
//     share a query row, each holding dh/TPR of its q and of its f32
//     accumulator in registers, so a score is a TPR-lane shuffle reduce
//     (BQ = 32, TPR = 4 at dh 64 and 128; BQ = 16, TPR = 8 at dh 256,
//     flash_common.cuh);
//   * each BK-key tile of K and V is staged in shared memory as f32
//     (bf16 -> f32 is exact), read by all 32 rows of the block: the
//     q tile is loaded once and every K/V element is read from device
//     memory T/BQ times per head instead of T times;
//   * online softmax in f32 registers, one rescale per tile.  The
//     denominator takes the undropped p; with dropout the kept p is
//     scaled by 1/(1-rate) and the dropped p is 0 before the PV
//     product, and p is rounded to the input dtype exactly where the
//     Pallas kernel casts ``p.astype(v.dtype)``.  lse stays the
//     undropped logsumexp, as in the reference;
//   * masked keys score -1e30 like the TPU kernel, keys past T (the
//     tail tile — any T works, there is no T % 128 guard) score -inf
//     so they contribute nothing even to an all-masked row.
// It runs on the CUDA cores in f32 FMA, far below the tensor-core
// bound; PERF.md records its time beside the bound.
#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace mxt_flash;

template <typename T, int DH, bool CAUSAL>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int8_t* __restrict__ mask,
                 T* __restrict__ o, float* __restrict__ lse, int seq,
                 int heads, float sm_scale, Dropout drop) {
  constexpr int TPR = Tile<DH>::TPR, BQ = Tile<DH>::BQ, BK = Tile<DH>::BK;
  constexpr int DPT = DH / TPR;  // dims per thread
  __shared__ float ks[BK][DH];
  __shared__ float vs[BK][DH];
  __shared__ int8_t ms[BK];

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int row = tid / TPR, sub = tid % TPR;
  const int qpos = q0 + row;
  const bool qvalid = qpos < seq;
  const size_t rs = (size_t)heads * DH;  // token stride of (B, T, H, dh)
  const size_t base = (size_t)b * seq * rs + (size_t)h * DH;
  const uint32_t seed = drop.on ? (uint32_t)drop.seed[0] : 0u;

  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = qvalid ? to_f(q[base + (size_t)qpos * rs + sub + TPR * i]) : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  int nk = (seq + BK - 1) / BK;
  if (CAUSAL) {
    // tiles wholly above the diagonal contribute nothing
    const int q_end = min(q0 + BQ, seq);
    nk = min(nk, (q_end + BK - 1) / BK);
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < BK * DH; idx += NT) {
      const int j = idx / DH, d = idx % DH;
      const int kp = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kp < seq) {
        kv = to_f(k[base + (size_t)kp * rs + d]);
        vv = to_f(v[base + (size_t)kp * rs + d]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    if (tid < BK) ms[tid] = (k0 + tid < seq) ? mask[(size_t)b * seq + k0 + tid] : 0;
    __syncthreads();

    float s[BK];
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) part += qr[i] * ks[j][sub + TPR * i];
      part = row_sum<TPR>(part);
      const int kp = k0 + j;
      const bool valid = ms[j] != 0 && (!CAUSAL || kp <= qpos);
      const float sj = kp >= seq ? -INFINITY : (valid ? part * sm_scale : -1e30f);
      s[j] = sj;
      mt = fmaxf(mt, sj);
    }
    const float mn = fmaxf(m, mt);
    const float alpha = expf(m - mn);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float p = expf(s[j] - mn);
      psum += p;                      // the denominator takes p undropped
      if (drop.on)
        p = dropout_keep(bh, qpos, k0 + j, seed, drop.thr) ? p * drop.inv : 0.f;
      s[j] = round_to<T>(p);          // p.astype(v.dtype) before PV
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      float pv = 0.f;
#pragma unroll
      for (int j = 0; j < BK; ++j) pv += s[j] * vs[j][sub + TPR * i];
      acc[i] = acc[i] * alpha + pv;
    }
    m = mn;
  }

  if (qvalid) {
    const float lc = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      o[base + (size_t)qpos * rs + sub + TPR * i] = from_f<T>(acc[i] / lc);
    if (sub == 0) lse[(size_t)bh * seq + qpos] = m + logf(lc);
  }
}

template <typename T, int DH>
void launch(const void* q, const void* k, const void* v, const void* mask, void* o,
            void* lse, int B, int seq, int H, int causal, float sm_scale,
            Dropout drop, cudaStream_t st) {
  dim3 grid((seq + Tile<DH>::BQ - 1) / Tile<DH>::BQ, B * H);
  if (causal)
    flash_fwd_kernel<T, DH, true><<<grid, NT, 0, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const int8_t*)mask, (T*)o,
        (float*)lse, seq, H, sm_scale, drop);
  else
    flash_fwd_kernel<T, DH, false><<<grid, NT, 0, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const int8_t*)mask, (T*)o,
        (float*)lse, seq, H, sm_scale, drop);
}

}  // namespace

// q, k, v, o: (B, T, H, dh) contiguous, f32 (bf16 == 0) or bf16
// (bf16 == 1); mask: (B, T) int8, nonzero = key kept; lse: (B, H, T) f32.
// dropout != 0 applies the positional-hash dropout with the int32 seed
// read from device memory at ``seed``, keep threshold ``thr`` and scale
// ``inv``.  dh must be 64, 128 or 256.  Returns cudaGetLastError() after the
// launch (an unsupported dh returns cudaErrorInvalidValue).
extern "C" int mxt_flash_fwd(const void* q, const void* k, const void* v,
                             const void* mask, void* o, void* lse, int B, int seq,
                             int H, int dh, int causal, int bf16, float sm_scale,
                             const void* seed, int dropout, unsigned int thr,
                             float inv, void* stream) {
  if (B * seq * H == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const Dropout drop{(const int*)seed, thr, inv, dropout};
  if (dh == 64 && bf16)
    launch<__nv_bfloat16, 64>(q, k, v, mask, o, lse, B, seq, H, causal, sm_scale, drop, st);
  else if (dh == 64)
    launch<float, 64>(q, k, v, mask, o, lse, B, seq, H, causal, sm_scale, drop, st);
  else if (dh == 128 && bf16)
    launch<__nv_bfloat16, 128>(q, k, v, mask, o, lse, B, seq, H, causal, sm_scale, drop, st);
  else if (dh == 128)
    launch<float, 128>(q, k, v, mask, o, lse, B, seq, H, causal, sm_scale, drop, st);
  else if (dh == 256 && bf16)
    launch<__nv_bfloat16, 256>(q, k, v, mask, o, lse, B, seq, H, causal, sm_scale, drop, st);
  else if (dh == 256)
    launch<float, 256>(q, k, v, mask, o, lse, B, seq, H, causal, sm_scale, drop, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
