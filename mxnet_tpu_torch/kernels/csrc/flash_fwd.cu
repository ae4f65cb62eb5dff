// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel mxnet_tpu/kernels/flash_attention.py
// _flash_fwd_tpu (pl.pallas_call at :169, body _kernel at :85): attention
// over (B, T, H, dh) with an online softmax over key tiles, the (B, T)
// key-padding mask, the causal bound that stops at the diagonal tile,
// the positional-hash attention dropout (:117-123), and the per-row
// logsumexp (B, H, T) f32 that the backward kernels (flash_bwd.cu) read.
//
// Two kernels behind one entry, chosen by dtype:
//
// bf16: FlashAttention-2 on the tensor cores (mma.sync m16n8k16, f32
// accumulators; the helpers are flash_mma.cuh).
//   * one block of 4 warps per (b*h, 64-query tile), 16 query rows a
//     warp; keys in tiles of BK = 64 (32 at dh 256), held in shared
//     memory as bf16 in rows padded for conflict-free ldmatrix;
//   * a two-stage cp.async ring: the next K/V tile (and its mask bytes)
//     is in flight while this one computes; the ragged tail tile reads
//     zeros (cp.async src-size 0), so any T works, T = 1 included;
//   * S = Q K^T into f32 fragments; the online softmax runs on the
//     fragments, the row max and sum over the 4 lanes of a quad, in the
//     base-2 domain (scores times scale*log2(e), exp2); the row sum
//     stays a per-lane partial until the end;
//   * the reference's order per element: p = exp(s - m_new) in f32, the
//     denominator takes the undropped p, the keep bit is
//     dropout_keep(bh, q_pos, k_pos) of the element's absolute
//     positions, then x 1/(1-rate), and p is rounded to bf16 only as the
//     A operand of P V (the reference's p.astype(v.dtype)), repacked in
//     registers from the accumulator layout; V is the B operand through
//     ldmatrix.trans;
//   * Q stays in registers as A fragments at dh 64 and 128; at dh 256
//     the 16 x 256 f32 O accumulator takes 128 registers a thread, so Q
//     is re-read from shared memory (ldmatrix) for each key tile;
//   * masked keys score -1e30 (in natural-log units, as the TPU kernel),
//     keys past T score -inf; lse stays the undropped logsumexp.
// What bounds it: at BERT-base's case (B=16, T=512, H=12, dh=64, a
// padding mask, dropout 0.1) the least time is 13.5 us (q, k, v, o and
// the kept keys' bytes at 3.35 TB/s; the 9.9 GFLOP of kept pairs take
// 10 us at 989 TFLOP/s).  The kernel takes several times that: at dh 64
// a score costs one 64-deep product on the tensor cores but a dozen
// scalar instructions (mask select, scale, max, exp2, sum, the bf16
// pack) and, with dropout, the 12-operation hash, which is about a
// quarter of its time there (PERF.md §6).  That share points at the
// issue rate of the per-element work, not the mma rate or the bytes, as
// what sets its pace (no finer counter is readable on the card).
//
// f32: the CUDA-core kernel (flash_fwd_f32): TPR threads share a query
// row, each holding dh/TPR of its q and accumulator; K/V tiles staged in
// shared memory as f32; a score is a TPR-lane shuffle reduce
// (flash_common.cuh).  The tensor cores take f32 only as TF32 (a 10-bit
// mantissa), which would not hold the f32 kernel to 1e-5 of its plain
// version.
#include <math.h>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace mxt_flash;
using namespace mxt_mma;
using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ------------------------------------------------------------- f32 kernel --
template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(NT)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int8_t* __restrict__ mask,
              float* __restrict__ o, float* __restrict__ lse, int seq, int heads,
              float sm_scale, Dropout drop) {
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
    qr[i] = qvalid ? q[base + (size_t)qpos * rs + sub + TPR * i] : 0.f;
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
        kv = k[base + (size_t)kp * rs + d];
        vv = v[base + (size_t)kp * rs + d];
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
      s[j] = p;
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
    for (int i = 0; i < DPT; ++i) o[base + (size_t)qpos * rs + sub + TPR * i] = acc[i] / lc;
    if (sub == 0) lse[(size_t)bh * seq + qpos] = m + logf(lc);
  }
}

// ----------------------------------------------------- bf16 tensor cores --
template <int DH> struct FwdTc {
  static constexpr int NW = 4;                    // warps, 16 query rows each
  static constexpr int BQ = 16 * NW;              // query rows per block
  static constexpr int BK = DH <= 128 ? 64 : 32;  // keys per tile
  static constexpr int LD = DH + 8;               // padded smem row, bf16
  static constexpr bool QREG = DH <= 128;         // Q fragments in registers
  static constexpr size_t SMEM =                  // Q, K x2, V x2, mask x2
      (size_t)(BQ + 4 * BK) * LD * sizeof(bf16) + 2 * BK;
};

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(128)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const int8_t* __restrict__ mask,
             bf16* __restrict__ o, float* __restrict__ lse, int seq, int heads,
             float sm_scale, Dropout drop) {
  using G = FwdTc<DH>;
  constexpr int BQ = G::BQ, BK = G::BK, LD = G::LD, NTH = 32 * G::NW;
  constexpr int KS = DH / 16;  // k-steps of S = Q K^T over dh
  constexpr int NS = BK / 8;   // 8-key column tiles of S
  constexpr int NO = DH / 8;   // 8-wide column tiles of O
  // scores in base-2 units; a masked key is -1e30 in natural-log units
  const float MASKED = -1e30f * LOG2E;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);       // [BQ][LD]
  bf16* ks = qs + BQ * LD;                        // [2][BK][LD]
  bf16* vs = ks + 2 * BK * LD;                    // [2][BK][LD]
  int8_t* ms = reinterpret_cast<int8_t*>(vs + 2 * BK * LD);  // [2][BK]

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t rs = (size_t)heads * DH;  // token stride of (B, T, H, dh)
  const size_t base = (size_t)b * seq * rs + (size_t)h * DH;
  const int8_t* mrow = mask + (size_t)b * seq;
  const uint32_t seed = drop.on ? (uint32_t)drop.seed[0] : 0u;
  const float scale2 = sm_scale * LOG2E;
  const int qr[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  int nk = (seq + BK - 1) / BK;
  if (CAUSAL) nk = min(nk, (min(q0 + BQ, seq) + BK - 1) / BK);

  // stage 0: the Q tile and the first K/V tile, one cp.async group
  load_rows<BQ, DH, NTH>(qs, q + base, q0, seq, rs);
  load_rows<BK, DH, NTH>(ks, k + base, 0, seq, rs);
  load_rows<BK, DH, NTH>(vs, v + base, 0, seq, rs);
  cp_async_commit();
  if (tid < BK) ms[tid] = tid < seq ? mrow[tid] : 0;

  float oacc[NO][4];
#pragma unroll
  for (int d = 0; d < NO; ++d) oacc[d][0] = oacc[d][1] = oacc[d][2] = oacc[d][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  uint32_t qf[G::QREG ? KS : 1][4];

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1, k0 = kt * BK;
    int8_t m_next = 0;
    if (kt + 1 < nk) {  // the next tile into the other stage
      const int k1 = k0 + BK;
      load_rows<BK, DH, NTH>(ks + (st ^ 1) * BK * LD, k + base, k1, seq, rs);
      load_rows<BK, DH, NTH>(vs + (st ^ 1) * BK * LD, v + base, k1, seq, rs);
      cp_async_commit();
      if (tid < BK && k1 + tid < seq) m_next = mrow[k1 + tid];
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and, on the first, Q) has landed
    const bf16* kst = ks + st * BK * LD;
    const bf16* vst = vs + st * BK * LD;
    const int8_t* mst = ms + st * BK;

    if constexpr (G::QREG) {
      if (kt == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) ldsm_x4(qf[kk], a_addr<LD>(qs, warp * 16, kk * 16, lane));
      }
    }

    // S = Q K^T, 16 rows x BK keys a warp
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      if constexpr (G::QREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
      } else {
        ldsm_x4(a, a_addr<LD>(qs, warp * 16, kk * 16, lane));
      }
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        uint32_t bk[4];
        ldsm_x4(bk, b_addr<LD>(kst, j * 16, kk * 16, lane));
        mma(s[2 * j], a, bk[0], bk[1]);
        mma(s[2 * j + 1], a, bk[2], bk[3]);
      }
    }

    // scale, mask, row max over the quad
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1), kp = k0 + col;
        const bool valid = mst[col] != 0 && (!CAUSAL || kp <= qr[e >> 1]);
        const float x = kp >= seq ? -INFINITY : (valid ? s[j][e] * scale2 : MASKED);
        s[j][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(m_r[i], quad_max(mt[i]));
      alpha[i] = exp2f(m_r[i] - mn);  // 0 on the first tile (m = -inf)
      m_r[i] = mn;
    }

    // p = exp(s - m_new); the denominator takes it undropped; then the
    // keep bit and 1/(1-rate); bf16 only as the A operand of P V
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[j][e] - m_r[e >> 1]);
        psum[e >> 1] += p;
        if (drop.on)
          p = dropout_keep(bh, qr[e >> 1], k0 + j * 8 + 2 * t + (e & 1), seed, drop.thr)
                  ? p * drop.inv
                  : 0.f;
        s[j][e] = p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * alpha[i] + psum[i];
#pragma unroll
    for (int d = 0; d < NO; ++d) {
      oacc[d][0] *= alpha[0];
      oacc[d][1] *= alpha[0];
      oacc[d][2] *= alpha[1];
      oacc[d][3] *= alpha[1];
    }

    // O += P~ V
#pragma unroll
    for (int jj = 0; jj < BK / 16; ++jj) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * jj], s[2 * jj + 1]);
#pragma unroll
      for (int d2 = 0; d2 < DH / 16; ++d2) {
        uint32_t bv[4];
        ldsm_x4_t(bv, bt_addr<LD>(vst, jj * 16, d2 * 16, lane));
        mma(oacc[2 * d2], pa, bv[0], bv[1]);
        mma(oacc[2 * d2 + 1], pa, bv[2], bv[3]);
      }
    }

    __syncthreads();  // every warp is done with this stage
    if (tid < BK) ms[(st ^ 1) * BK + tid] = m_next;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lc = fmaxf(quad_sum(l_r[i]), 1e-30f);
    const int qp = qr[i];
    if (qp >= seq) continue;
    const float inv = 1.f / lc;
    bf16* orow = o + base + (size_t)qp * rs;
#pragma unroll
    for (int d = 0; d < NO; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + d * 8 + 2 * t) =
          __floats2bfloat162_rn(oacc[d][2 * i] * inv, oacc[d][2 * i + 1] * inv);
    if (t == 0) lse[(size_t)bh * seq + qp] = m_r[i] * LN2 + logf(lc);
  }
}

// ---------------------------------------------------------------- launch --
struct Args {
  const void *q, *k, *v, *mask;
  void *o, *lse;
  int B, seq, H;
  float sm_scale;
  Dropout drop;
};

template <int DH, bool CAUSAL>
void launch_f32(const Args& a, cudaStream_t st) {
  dim3 grid((a.seq + Tile<DH>::BQ - 1) / Tile<DH>::BQ, a.B * a.H);
  flash_fwd_f32<DH, CAUSAL><<<grid, NT, 0, st>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, (const int8_t*)a.mask,
      (float*)a.o, (float*)a.lse, a.seq, a.H, a.sm_scale, a.drop);
}

template <int DH, bool CAUSAL>
void launch_tc(const Args& a, cudaStream_t st) {
  using G = FwdTc<DH>;
  allow_smem<flash_fwd_tc<DH, CAUSAL>>((int)G::SMEM);
  dim3 grid((a.seq + G::BQ - 1) / G::BQ, a.B * a.H);
  flash_fwd_tc<DH, CAUSAL><<<grid, 32 * G::NW, G::SMEM, st>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (const int8_t*)a.mask,
      (bf16*)a.o, (float*)a.lse, a.seq, a.H, a.sm_scale, a.drop);
}

template <int DH>
void launch(const Args& a, int causal, int bf16_, cudaStream_t st) {
  if (bf16_) {
    if (causal) launch_tc<DH, true>(a, st); else launch_tc<DH, false>(a, st);
  } else {
    if (causal) launch_f32<DH, true>(a, st); else launch_f32<DH, false>(a, st);
  }
}

}  // namespace

// q, k, v, o: (B, T, H, dh) contiguous, f32 (bf16 == 0) or bf16
// (bf16 == 1, 16-byte aligned); mask: (B, T) int8, nonzero = key kept;
// lse: (B, H, T) f32.  dropout != 0 applies the positional-hash dropout
// with the int32 seed read from device memory at ``seed``, keep threshold
// ``thr`` and scale ``inv``.  dh must be 64, 128 or 256.  Returns
// cudaGetLastError() after the launch (an unsupported dh returns
// cudaErrorInvalidValue).
extern "C" int mxt_flash_fwd(const void* q, const void* k, const void* v,
                             const void* mask, void* o, void* lse, int B, int seq,
                             int H, int dh, int causal, int bf16, float sm_scale,
                             const void* seed, int dropout, unsigned int thr,
                             float inv, void* stream) {
  if (B * seq * H == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const Args a{q, k, v, mask, o, lse, B, seq, H, sm_scale,
               Dropout{(const int*)seed, thr, inv, dropout}};
  if (dh == 64) launch<64>(a, causal, bf16, st);
  else if (dh == 128) launch<128>(a, causal, bf16, st);
  else if (dh == 256) launch<256>(a, causal, bf16, st);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
