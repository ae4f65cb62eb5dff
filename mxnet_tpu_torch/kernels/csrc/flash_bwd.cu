// Flash-attention backward for Hopper (sm_90a), plain C interface: two
// kernels, dQ and dK/dV, after the FlashAttention-2 recipe.
//
// Replaces the TPU kernels of mxnet_tpu/kernels/flash_attention.py
// _flash_bwd_tpu: the dQ pl.pallas_call at :333 (body _bwd_dq_kernel
// :192) and the dK/dV pl.pallas_call at :354 (body _bwd_dkv_kernel
// :244).  Both recompute P = exp(s * scale - lse) from the forward's
// logsumexp instead of storing it, regenerate the forward's dropout keep
// bit from positions (flash_common.cuh), and read delta = rowsum(dO * O)
// (B, H, T) f32, which the wrapper reduces outside the kernels as the
// reference does in jnp (:330).
//
//   dP = dO V^T;  with dropout dP = keep * dP / (1 - rate)
//   dS = P * (dP - delta) * scale
//   dQ = dS K                    (dS rounded to K's dtype, as .astype)
//   dV = P~^T dO, P~ = keep * P / (1 - rate)   (P~ rounded to dO's dtype)
//   dK = dS^T Q                  (dS rounded to Q's dtype)
//
// What bounds them on an H100: at BERT-base's shapes (B=16, H=12, T=512,
// dh=64, bf16) dQ moves 5*B*T*H*dh*2 bytes (63 MB, 19 us at 3.35 TB/s)
// and needs 6*T^2*dh FLOPs per (b, h) (19.3 GFLOP, 20 us at 989 TFLOP/s
// of bf16 tensor-core work); dK/dV moves 6*B*T*H*dh*2 bytes (75 MB, 23
// us) and needs 8*T^2*dh per (b, h) (25.8 GFLOP, 26 us).  So both sit on
// the ridge, and a padding mask or the causal bound moves them to the
// bytes side.  These first versions run f32 FMA on the CUDA cores (67
// TFLOP/s peak), so they are bound by operations far above either line;
// wgmma and TMA are later work.  PERF.md records their times.
//
// Design (simple and correct first, the pattern of flash_fwd.cu):
//   * dQ: one block of 128 threads per (b*h, BQ-row q tile), TPR threads
//     per query row holding dh/TPR of q, dO and the f32 dQ accumulator;
//     BK-key tiles of K and V staged in shared memory as f32.  The loop
//     over key tiles stops at the diagonal tile when causal.
//   * dK/dV: one block per (b*h, BK-key tile), TPR threads per key row
//     holding dh/TPR of k, v and the two f32 accumulators; BQ-row tiles
//     of Q and dO (with their lse and delta) staged in shared memory.
//     The loop over query tiles starts at the diagonal tile when causal.
//     (BQ = BK = 32, TPR = 4 at dh 64 and 128; 16 and 8 at dh 256, so
//     the staged tiles stay within 48 KB: flash_common.cuh.)
//   * each score and each dP is a TPR-lane shuffle reduce; every pair is
//     visited once per kernel, no atomics, so results are deterministic.
//   * masked keys, keys and queries past T, and pairs above the diagonal
//     get P = 0 (the reference's jnp.where(valid, exp(...), 0)).
#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace mxt_flash;

template <typename T, int DH, bool CAUSAL>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int8_t* __restrict__ mask, T* __restrict__ dq, int seq,
                    int heads, float sm_scale, Dropout drop) {
  constexpr int TPR = Tile<DH>::TPR, BQ = Tile<DH>::BQ, BK = Tile<DH>::BK;
  constexpr int DPT = DH / TPR;
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
  const size_t rs = (size_t)heads * DH;
  const size_t base = (size_t)b * seq * rs + (size_t)h * DH;
  const uint32_t seed = drop.on ? (uint32_t)drop.seed[0] : 0u;

  float qr[DPT], dor[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const size_t at = base + (size_t)qpos * rs + sub + TPR * i;
    qr[i] = qvalid ? to_f(q[at]) : 0.f;
    dor[i] = qvalid ? to_f(dout[at]) : 0.f;
    acc[i] = 0.f;
  }
  const float lse_r = qvalid ? lse[(size_t)bh * seq + qpos] : 0.f;
  const float delta_r = qvalid ? delta[(size_t)bh * seq + qpos] : 0.f;

  int nk = (seq + BK - 1) / BK;
  if (CAUSAL) nk = min(nk, (min(q0 + BQ, seq) + BK - 1) / BK);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
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

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float sp = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        sp += qr[i] * ks[j][sub + TPR * i];
        dp += dor[i] * vs[j][sub + TPR * i];
      }
      sp = row_sum<TPR>(sp);
      dp = row_sum<TPR>(dp);
      const int kp = k0 + j;
      const bool valid = qvalid && ms[j] != 0 && (!CAUSAL || kp <= qpos);
      const float p = valid ? expf(sp * sm_scale - lse_r) : 0.f;
      if (drop.on)
        dp = dropout_keep(bh, qpos, kp, seed, drop.thr) ? dp * drop.inv : 0.f;
      const float ds = round_to<T>(p * (dp - delta_r) * sm_scale);
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] += ds * ks[j][sub + TPR * i];
    }
  }
  if (qvalid) {
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      dq[base + (size_t)qpos * rs + sub + TPR * i] = from_f<T>(acc[i]);
  }
}

template <typename T, int DH, bool CAUSAL>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int8_t* __restrict__ mask, T* __restrict__ dk,
                     T* __restrict__ dv, int seq, int heads, float sm_scale,
                     Dropout drop) {
  constexpr int TPR = Tile<DH>::TPR, BQ = Tile<DH>::BQ, BK = Tile<DH>::BK;
  constexpr int DPT = DH / TPR;
  __shared__ float qs[BQ][DH];
  __shared__ float dos[BQ][DH];
  __shared__ float ls[BQ];
  __shared__ float dl[BQ];

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int row = tid / TPR, sub = tid % TPR;
  const int kpos = k0 + row;
  const bool kvalid = kpos < seq;
  const size_t rs = (size_t)heads * DH;
  const size_t base = (size_t)b * seq * rs + (size_t)h * DH;
  const uint32_t seed = drop.on ? (uint32_t)drop.seed[0] : 0u;
  // a masked key gets no gradient from any query
  const bool kon = kvalid && mask[(size_t)b * seq + kpos] != 0;

  float kr[DPT], vr[DPT], dka[DPT], dva[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const size_t at = base + (size_t)kpos * rs + sub + TPR * i;
    kr[i] = kvalid ? to_f(k[at]) : 0.f;
    vr[i] = kvalid ? to_f(v[at]) : 0.f;
    dka[i] = 0.f;
    dva[i] = 0.f;
  }

  const int nq = (seq + BQ - 1) / BQ;
  const int j0 = CAUSAL ? k0 / BQ : 0;  // q tiles above the diagonal see none of these keys
  for (int qt = j0; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    for (int idx = tid; idx < BQ * DH; idx += NT) {
      const int i = idx / DH, d = idx % DH;
      const int qp = q0 + i;
      float qv = 0.f, dv_ = 0.f;
      if (qp < seq) {
        qv = to_f(q[base + (size_t)qp * rs + d]);
        dv_ = to_f(dout[base + (size_t)qp * rs + d]);
      }
      qs[i][d] = qv;
      dos[i][d] = dv_;
    }
    if (tid < BQ) {
      const int qp = q0 + tid;
      ls[tid] = qp < seq ? lse[(size_t)bh * seq + qp] : 0.f;
      dl[tid] = qp < seq ? delta[(size_t)bh * seq + qp] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int i = 0; i < BQ; ++i) {
      float sp = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DPT; ++d) {
        sp += qs[i][sub + TPR * d] * kr[d];
        dp += dos[i][sub + TPR * d] * vr[d];
      }
      sp = row_sum<TPR>(sp);
      dp = row_sum<TPR>(dp);
      const int qp = q0 + i;
      const bool valid = kon && qp < seq && (!CAUSAL || kpos <= qp);
      const float p = valid ? expf(sp * sm_scale - ls[i]) : 0.f;
      float pd = p;
      if (drop.on) {
        const bool keep = dropout_keep(bh, qp, kpos, seed, drop.thr);
        pd = keep ? p * drop.inv : 0.f;
        dp = keep ? dp * drop.inv : 0.f;
      }
      const float pr = round_to<T>(pd);
      const float ds = round_to<T>(p * (dp - dl[i]) * sm_scale);
#pragma unroll
      for (int d = 0; d < DPT; ++d) {
        dva[d] += pr * dos[i][sub + TPR * d];
        dka[d] += ds * qs[i][sub + TPR * d];
      }
    }
  }
  if (kvalid) {
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const size_t at = base + (size_t)kpos * rs + sub + TPR * i;
      dk[at] = from_f<T>(dka[i]);
      dv[at] = from_f<T>(dva[i]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *mask;
  int B, seq, H, causal;
  float sm_scale;
  Dropout drop;
};

template <typename T, int DH>
void launch_dq(const Args& a, void* dq, cudaStream_t st) {
  dim3 grid((a.seq + Tile<DH>::BQ - 1) / Tile<DH>::BQ, a.B * a.H);
#define MXT_DQ(C)                                                              \
  flash_bwd_dq_kernel<T, DH, C><<<grid, NT, 0, st>>>(                          \
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,           \
      (const float*)a.lse, (const float*)a.delta, (const int8_t*)a.mask,       \
      (T*)dq, a.seq, a.H, a.sm_scale, a.drop)
  if (a.causal) MXT_DQ(true); else MXT_DQ(false);
#undef MXT_DQ
}

template <typename T, int DH>
void launch_dkv(const Args& a, void* dk, void* dv, cudaStream_t st) {
  dim3 grid((a.seq + Tile<DH>::BK - 1) / Tile<DH>::BK, a.B * a.H);
#define MXT_DKV(C)                                                             \
  flash_bwd_dkv_kernel<T, DH, C><<<grid, NT, 0, st>>>(                         \
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,           \
      (const float*)a.lse, (const float*)a.delta, (const int8_t*)a.mask,       \
      (T*)dk, (T*)dv, a.seq, a.H, a.sm_scale, a.drop)
  if (a.causal) MXT_DKV(true); else MXT_DKV(false);
#undef MXT_DKV
}

}  // namespace

// Common arguments of both entries: q, k, v, dout: (B, T, H, dh)
// contiguous, f32 (bf16 == 0) or bf16 (bf16 == 1); lse, delta: (B, H, T)
// f32; mask: (B, T) int8, nonzero = key kept; dropout != 0 regenerates
// the forward's keep mask from the int32 seed at ``seed`` (device
// memory), threshold ``thr``, scale ``inv``.  dh must be 64, 128 or 256.
// Each returns cudaGetLastError() after its launch (an unsupported dh
// returns cudaErrorInvalidValue).

// dq: (B, T, H, dh), q's dtype.
extern "C" int mxt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                const void* mask, void* dq, int B, int seq, int H,
                                int dh, int causal, int bf16, float sm_scale,
                                const void* seed, int dropout, unsigned int thr,
                                float inv, void* stream) {
  if (B * seq * H == 0) return 0;
  const Args a{q, k, v, dout, lse, delta, mask, B, seq, H, causal, sm_scale,
               Dropout{(const int*)seed, thr, inv, dropout}};
  cudaStream_t st = (cudaStream_t)stream;
  if (dh == 64 && bf16) launch_dq<__nv_bfloat16, 64>(a, dq, st);
  else if (dh == 64) launch_dq<float, 64>(a, dq, st);
  else if (dh == 128 && bf16) launch_dq<__nv_bfloat16, 128>(a, dq, st);
  else if (dh == 128) launch_dq<float, 128>(a, dq, st);
  else if (dh == 256 && bf16) launch_dq<__nv_bfloat16, 256>(a, dq, st);
  else if (dh == 256) launch_dq<float, 256>(a, dq, st);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dk, dv: (B, T, H, dh), k's and v's dtype.
extern "C" int mxt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 const void* mask, void* dk, void* dv, int B, int seq,
                                 int H, int dh, int causal, int bf16, float sm_scale,
                                 const void* seed, int dropout, unsigned int thr,
                                 float inv, void* stream) {
  if (B * seq * H == 0) return 0;
  const Args a{q, k, v, dout, lse, delta, mask, B, seq, H, causal, sm_scale,
               Dropout{(const int*)seed, thr, inv, dropout}};
  cudaStream_t st = (cudaStream_t)stream;
  if (dh == 64 && bf16) launch_dkv<__nv_bfloat16, 64>(a, dk, dv, st);
  else if (dh == 64) launch_dkv<float, 64>(a, dk, dv, st);
  else if (dh == 128 && bf16) launch_dkv<__nv_bfloat16, 128>(a, dk, dv, st);
  else if (dh == 128) launch_dkv<float, 128>(a, dk, dv, st);
  else if (dh == 256 && bf16) launch_dkv<__nv_bfloat16, 256>(a, dk, dv, st);
  else if (dh == 256) launch_dkv<float, 256>(a, dk, dv, st);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
