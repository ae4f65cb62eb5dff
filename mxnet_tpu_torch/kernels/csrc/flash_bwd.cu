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
// bytes side.  PERF.md records their times beside those bounds.  The
// tensor-core dK/dV keeps four f32 accumulator tiles live (S, dP, dK,
// dV: 238-246 registers a thread at every dh), so an SM holds two of its
// 4-warp blocks at dh 64: few warps to hide each tile's loads and the
// per-element work (exp2, the hash, two bf16 packs).  It runs several
// times its bound; no finer counter is readable on the card.
//
// In bf16 both run on the tensor cores (mma.sync m16n8k16 with f32
// accumulators, helpers in flash_mma.cuh), without atomics, so every
// (query, key) pair is visited once per output tile and results are
// deterministic (remat on and off agree bit for bit).
//
// dK/dV (flash_bwd_dkv_tc), FA2's key-major loop:
//   * one block per (b*h, 64-key tile): 4 warps of 16 keys; at dh 256, 8
//     warps, two per 16 keys, each owning half of dK's and dV's columns
//     (the 64 x 256 f32 accumulators would be 256 registers a thread on
//     4 warps); both warps of a pair compute the same S and dP;
//   * K and V of the tile sit in shared memory for the whole walk; the
//     block walks the query tiles (BQ = 64 at dh 64, 32 above, for the
//     registers), from the diagonal tile when causal, through a two-stage
//     cp.async ring of Q, dO, lse and delta, zero-filled past T;
//   * S^T = K Q^T and dP^T = V dO^T come out with keys as rows, so P^T,
//     P~^T and dS^T are built in the accumulator layout, rounded to bf16
//     and repacked in registers as the A operands of dV += P~^T dO and
//     dK += dS^T Q (dO and Q as B operands through ldmatrix.trans);
//   * rows are keys here, but the hash is still called as (bh, q_pos,
//     k_pos).
// dQ (flash_bwd_dq_tc), the same loop turned query-major:
//   * one block per (b*h, 64-query tile): 4 warps of 16 queries; at dh
//     256, 8 warps, two per 16 queries, each owning half of dQ's columns
//     (a 16 x 256 f32 accumulator would be 128 registers a thread); both
//     warps of a pair compute the same S and dP;
//   * Q and dO of the tile are loaded once into shared memory and, at dh
//     64 and 128, held in registers as A fragments; at dh 256 they are
//     re-read from shared memory (ldmatrix) for each key tile; lse (in
//     base 2) and delta of the thread's two rows sit in registers;
//   * K, V and the mask bytes of each key tile (BK = 64 at dh 64, 32
//     above, for the registers) come through a two-stage cp.async ring,
//     zero-filled past T; when causal the walk stops at the diagonal
//     tile, nk = ceil(min(q0 + 64, T) / BK), the reference's nk_eff;
//   * S = Q K^T and dP = dO V^T have K and V as B operands; dS is built
//     in the accumulator layout (P through a select, so a masked key or
//     a zero-filled key past T gives P = 0, never exp(-inf) * 0), rounded
//     to bf16 and repacked in registers as the A operand of dQ += dS K,
//     with K as the B operand through ldmatrix.trans;
//   * rows are queries, so the hash is called as (bh, q_pos, k_pos) in
//     its natural orientation.
// The f32 kernels (dQ and dK/dV) stay on the CUDA cores, which the
// tensor cores would hold to TF32: TPR threads per query (key) row, each
// holding dh/TPR of its row and of the f32 accumulators; tiles staged in
// shared memory as f32; each score and each dP a TPR-lane shuffle reduce
// (BQ = BK = 32, TPR = 4 at dh 64 and 128; 16 and 8 at dh 256:
// flash_common.cuh).  Masked keys, keys and queries past T, and pairs
// above the diagonal get P = 0 (the reference's jnp.where(valid,
// exp(...), 0)).
#include <math.h>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace mxt_flash;
using namespace mxt_mma;
using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int8_t* __restrict__ mask, float* __restrict__ dq, int seq,
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
    qr[i] = qvalid ? q[at] : 0.f;
    dor[i] = qvalid ? dout[at] : 0.f;
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
        kv = k[base + (size_t)kp * rs + d];
        vv = v[base + (size_t)kp * rs + d];
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
      const float ds = p * (dp - delta_r) * sm_scale;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] += ds * ks[j][sub + TPR * i];
    }
  }
  if (qvalid) {
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      dq[base + (size_t)qpos * rs + sub + TPR * i] = acc[i];
  }
}

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  const int8_t* __restrict__ mask, float* __restrict__ dk,
                  float* __restrict__ dv, int seq, int heads, float sm_scale,
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
    kr[i] = kvalid ? k[at] : 0.f;
    vr[i] = kvalid ? v[at] : 0.f;
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
        qv = q[base + (size_t)qp * rs + d];
        dv_ = dout[base + (size_t)qp * rs + d];
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
      const float ds = p * (dp - dl[i]) * sm_scale;
#pragma unroll
      for (int d = 0; d < DPT; ++d) {
        dva[d] += pd * dos[i][sub + TPR * d];
        dka[d] += ds * qs[i][sub + TPR * d];
      }
    }
  }
  if (kvalid) {
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const size_t at = base + (size_t)kpos * rs + sub + TPR * i;
      dk[at] = dka[i];
      dv[at] = dva[i];
    }
  }
}

// ----------------------------------------------------- bf16 tensor cores --
template <int DH> struct DkvTc {
  static constexpr int WN = DH <= 128 ? 1 : 2;  // warps sharing 16 keys
  static constexpr int NW = 4 * WN;             // warps per block
  static constexpr int BK = 64;                 // keys per block
  static constexpr int BQ = DH <= 64 ? 64 : 32; // queries per tile
  static constexpr int LD = DH + 8;             // padded smem row, bf16
  static constexpr int DW = DH / WN;            // dK/dV columns per warp
  static constexpr size_t SMEM =                // K, V, Q x2, dO x2; lse, delta x2
      (size_t)(2 * BK + 4 * BQ) * LD * sizeof(bf16) + 4 * BQ * sizeof(float);
};

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(32 * DkvTc<DH>::NW)
flash_bwd_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int8_t* __restrict__ mask, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int seq, int heads, float sm_scale,
                 Dropout drop) {
  using G = DkvTc<DH>;
  constexpr int BQ = G::BQ, BK = G::BK, LD = G::LD, DW = G::DW, NTH = 32 * G::NW;
  constexpr int KS = DH / 16;  // k-steps of S^T and dP^T over dh
  constexpr int NS = BQ / 8;   // 8-query column tiles of S^T
  constexpr int NO = DW / 8;   // 8-wide column tiles of this warp's dK, dV

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);   // [BK][LD]
  bf16* vs = ks + BK * LD;                    // [BK][LD]
  bf16* qs = vs + BK * LD;                    // [2][BQ][LD]
  bf16* dos = qs + 2 * BQ * LD;               // [2][BQ][LD]
  float* ls = reinterpret_cast<float*>(dos + 2 * BQ * LD);  // [2][BQ]
  float* dls = ls + 2 * BQ;                   // [2][BQ]

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw = warp & 3, wn = warp >> 2;    // 16-key group, column half
  const size_t rs = (size_t)heads * DH;
  const size_t base = (size_t)b * seq * rs + (size_t)h * DH;
  const uint32_t seed = drop.on ? (uint32_t)drop.seed[0] : 0u;
  const float scale2 = sm_scale * LOG2E;
  const int kr[2] = {k0 + kw * 16 + g, k0 + kw * 16 + g + 8};
  // a masked key gets no gradient from any query
  bool kon[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) kon[i] = kr[i] < seq && mask[(size_t)b * seq + kr[i]] != 0;

  const int nq = (seq + BQ - 1) / BQ;
  const int j0 = CAUSAL ? k0 / BQ : 0;  // q tiles above the diagonal see none of these keys
  // Q, dO, lse and delta of query tile qt into stage stg
  auto load_q = [&](int qt, int stg) {
    const int q0 = qt * BQ;
    load_rows<BQ, DH, NTH>(qs + stg * BQ * LD, q + base, q0, seq, rs);
    load_rows<BQ, DH, NTH>(dos + stg * BQ * LD, dout + base, q0, seq, rs);
    if (tid < 2 * BQ) {
      const int i = tid % BQ;
      const bool ok = q0 + i < seq;
      const float* src = (tid < BQ ? lse : delta) + (size_t)bh * seq + (ok ? q0 + i : 0);
      cp_async4((tid < BQ ? ls : dls) + stg * BQ + i, src, ok);
    }
  };
  load_rows<BK, DH, NTH>(ks, k + base, k0, seq, rs);
  load_rows<BK, DH, NTH>(vs, v + base, k0, seq, rs);
  load_q(j0, 0);
  cp_async_commit();

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int d = 0; d < NO; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;

  for (int qt = j0; qt < nq; ++qt) {
    const int st = (qt - j0) & 1, q0 = qt * BQ;
    if (qt + 1 < nq) {  // the next query tile into the other stage
      load_q(qt + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and, on the first, K and V) has landed
    const bf16* qst = qs + st * BQ * LD;
    const bf16* dost = dos + st * BQ * LD;
    const float* lst = ls + st * BQ;
    const float* dlst = dls + st * BQ;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ queries a warp
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ak[4], av[4];
      ldsm_x4(ak, a_addr<LD>(ks, kw * 16, kk * 16, lane));
      ldsm_x4(av, a_addr<LD>(vs, kw * 16, kk * 16, lane));
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, b_addr<LD>(qst, j * 16, kk * 16, lane));
        ldsm_x4(bo, b_addr<LD>(dost, j * 16, kk * 16, lane));
        mma(s[2 * j], ak, bq[0], bq[1]);
        mma(s[2 * j + 1], ak, bq[2], bq[3]);
        mma(dp[2 * j], av, bo[0], bo[1]);
        mma(dp[2 * j + 1], av, bo[2], bo[3]);
      }
    }

    // P^T = exp(S^T * scale - lse) where valid; P~^T and dS^T in place
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1), qp = q0 + col, kp = kr[e >> 1];
        const bool valid = kon[e >> 1] && qp < seq && (!CAUSAL || kp <= qp);
        const float p = valid ? exp2f(s[j][e] * scale2 - lst[col] * LOG2E) : 0.f;
        float pd = p, dpv = dp[j][e];
        if (drop.on) {
          const bool keep = dropout_keep(bh, qp, kp, seed, drop.thr);
          pd = keep ? p * drop.inv : 0.f;
          dpv = keep ? dpv * drop.inv : 0.f;
        }
        s[j][e] = pd;
        dp[j][e] = p * (dpv - dlst[col]) * sm_scale;
      }
    }

    // dV += P~^T dO and dK += dS^T Q over this warp's columns
#pragma unroll
    for (int jj = 0; jj < BQ / 16; ++jj) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, s[2 * jj], s[2 * jj + 1]);
      acc_to_a(da, dp[2 * jj], dp[2 * jj + 1]);
#pragma unroll
      for (int d2 = 0; d2 < DW / 16; ++d2) {
        const int n0 = wn * DW + d2 * 16;
        uint32_t bo[4], bq[4];
        ldsm_x4_t(bo, bt_addr<LD>(dost, jj * 16, n0, lane));
        ldsm_x4_t(bq, bt_addr<LD>(qst, jj * 16, n0, lane));
        mma(dva[2 * d2], pa, bo[0], bo[1]);
        mma(dva[2 * d2 + 1], pa, bo[2], bo[3]);
        mma(dka[2 * d2], da, bq[0], bq[1]);
        mma(dka[2 * d2 + 1], da, bq[2], bq[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kr[i] >= seq) continue;
    const size_t at = base + (size_t)kr[i] * rs + wn * DW + 2 * t;
#pragma unroll
    for (int d = 0; d < NO; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + d * 8) =
          __floats2bfloat162_rn(dka[d][2 * i], dka[d][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + d * 8) =
          __floats2bfloat162_rn(dva[d][2 * i], dva[d][2 * i + 1]);
    }
  }
}

// dQ in bf16 on the tensor cores (notes at the top of the file).
template <int DH> struct DqTc {
  static constexpr int WN = DH <= 128 ? 1 : 2;   // warps sharing 16 queries
  static constexpr int NW = 4 * WN;              // warps per block
  static constexpr int BQ = 64;                  // queries per block
  static constexpr int BK = DH <= 64 ? 64 : 32;  // keys per tile
  static constexpr int LD = DH + 8;              // padded smem row, bf16
  static constexpr int DW = DH / WN;             // dQ columns per warp
  static constexpr bool QREG = DH <= 128;        // Q, dO fragments in registers
  static constexpr size_t SMEM =                 // Q, dO; K x2, V x2; mask x2
      (size_t)(2 * BQ + 4 * BK) * LD * sizeof(bf16) + 2 * BK;
};

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(32 * DqTc<DH>::NW)
flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int8_t* __restrict__ mask, bf16* __restrict__ dq, int seq,
                int heads, float sm_scale, Dropout drop) {
  using G = DqTc<DH>;
  constexpr int BQ = G::BQ, BK = G::BK, LD = G::LD, DW = G::DW, NTH = 32 * G::NW;
  constexpr int KS = DH / 16;  // k-steps of S and dP over dh
  constexpr int NS = BK / 8;   // 8-key column tiles of S and dP
  constexpr int NO = DW / 8;   // 8-wide column tiles of this warp's dQ

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);   // [BQ][LD]
  bf16* dos = qs + BQ * LD;                   // [BQ][LD]
  bf16* ks = dos + BQ * LD;                   // [2][BK][LD]
  bf16* vs = ks + 2 * BK * LD;                // [2][BK][LD]
  int8_t* ms = reinterpret_cast<int8_t*>(vs + 2 * BK * LD);  // [2][BK]

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qw = warp & 3, wn = warp >> 2;    // 16-query group, column half
  const size_t rs = (size_t)heads * DH;
  const size_t base = (size_t)b * seq * rs + (size_t)h * DH;
  const int8_t* mrow = mask + (size_t)b * seq;
  const uint32_t seed = drop.on ? (uint32_t)drop.seed[0] : 0u;
  const float scale2 = sm_scale * LOG2E;
  const int qr[2] = {q0 + qw * 16 + g, q0 + qw * 16 + g + 8};
  float lse2[2], dl[2];  // lse in base 2, delta; 0 for rows past T (not written)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = qr[i] < seq;
    lse2[i] = ok ? lse[(size_t)bh * seq + qr[i]] * LOG2E : 0.f;
    dl[i] = ok ? delta[(size_t)bh * seq + qr[i]] : 0.f;
  }

  int nk = (seq + BK - 1) / BK;
  if (CAUSAL) nk = min(nk, (min(q0 + BQ, seq) + BK - 1) / BK);

  // stage 0: the Q and dO tiles and the first K/V tile, one cp.async group
  load_rows<BQ, DH, NTH>(qs, q + base, q0, seq, rs);
  load_rows<BQ, DH, NTH>(dos, dout + base, q0, seq, rs);
  load_rows<BK, DH, NTH>(ks, k + base, 0, seq, rs);
  load_rows<BK, DH, NTH>(vs, v + base, 0, seq, rs);
  cp_async_commit();
  if (tid < BK) ms[tid] = tid < seq ? mrow[tid] : 0;

  float dqa[NO][4];
#pragma unroll
  for (int d = 0; d < NO; ++d) dqa[d][0] = dqa[d][1] = dqa[d][2] = dqa[d][3] = 0.f;
  uint32_t qf[G::QREG ? KS : 1][4], of[G::QREG ? KS : 1][4];

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1, k0 = kt * BK;
    int8_t m_next = 0;
    if (kt + 1 < nk) {  // the next key tile into the other stage
      const int k1 = k0 + BK;
      load_rows<BK, DH, NTH>(ks + (st ^ 1) * BK * LD, k + base, k1, seq, rs);
      load_rows<BK, DH, NTH>(vs + (st ^ 1) * BK * LD, v + base, k1, seq, rs);
      cp_async_commit();
      if (tid < BK && k1 + tid < seq) m_next = mrow[k1 + tid];
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and, on the first, Q and dO) has landed
    const bf16* kst = ks + st * BK * LD;
    const bf16* vst = vs + st * BK * LD;
    const int8_t* mst = ms + st * BK;

    if constexpr (G::QREG) {
      if (kt == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          ldsm_x4(qf[kk], a_addr<LD>(qs, qw * 16, kk * 16, lane));
          ldsm_x4(of[kk], a_addr<LD>(dos, qw * 16, kk * 16, lane));
        }
      }
    }

    // S = Q K^T and dP = dO V^T: 16 queries x BK keys a warp
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t aq[4], ao[4];
      if constexpr (G::QREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          aq[i] = qf[kk][i];
          ao[i] = of[kk][i];
        }
      } else {
        ldsm_x4(aq, a_addr<LD>(qs, qw * 16, kk * 16, lane));
        ldsm_x4(ao, a_addr<LD>(dos, qw * 16, kk * 16, lane));
      }
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, b_addr<LD>(kst, j * 16, kk * 16, lane));
        ldsm_x4(bv, b_addr<LD>(vst, j * 16, kk * 16, lane));
        mma(s[2 * j], aq, bk[0], bk[1]);
        mma(s[2 * j + 1], aq, bk[2], bk[3]);
        mma(dp[2 * j], ao, bv[0], bv[1]);
        mma(dp[2 * j + 1], ao, bv[2], bv[3]);
      }
    }

    // dS = P * (dP~ - delta) * scale in place of S; P = exp(s*scale - lse)
    // where the key is kept (mask byte, 0 past T) and at or below the
    // diagonal, else 0 by the select
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1), kp = k0 + col, r = e >> 1;
        const bool valid = mst[col] != 0 && (!CAUSAL || kp <= qr[r]);
        const float p = valid ? exp2f(s[j][e] * scale2 - lse2[r]) : 0.f;
        float dpv = dp[j][e];
        if (drop.on)
          dpv = dropout_keep(bh, qr[r], kp, seed, drop.thr) ? dpv * drop.inv : 0.f;
        s[j][e] = p * (dpv - dl[r]) * sm_scale;
      }
    }

    // dQ += dS K over this warp's columns (dS rounded to bf16)
#pragma unroll
    for (int jj = 0; jj < BK / 16; ++jj) {
      uint32_t da[4];
      acc_to_a(da, s[2 * jj], s[2 * jj + 1]);
#pragma unroll
      for (int d2 = 0; d2 < DW / 16; ++d2) {
        uint32_t bk[4];
        ldsm_x4_t(bk, bt_addr<LD>(kst, jj * 16, wn * DW + d2 * 16, lane));
        mma(dqa[2 * d2], da, bk[0], bk[1]);
        mma(dqa[2 * d2 + 1], da, bk[2], bk[3]);
      }
    }

    __syncthreads();  // every warp is done with this stage
    if (tid < BK) ms[(st ^ 1) * BK + tid] = m_next;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qr[i] >= seq) continue;
    bf16* row = dq + base + (size_t)qr[i] * rs + wn * DW + 2 * t;
#pragma unroll
    for (int d = 0; d < NO; ++d)
      *reinterpret_cast<__nv_bfloat162*>(row + d * 8) =
          __floats2bfloat162_rn(dqa[d][2 * i], dqa[d][2 * i + 1]);
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *mask;
  int B, seq, H, causal;
  float sm_scale;
  Dropout drop;
};

template <int DH>
void launch_dq(const Args& a, int bf16_, void* dq, cudaStream_t st) {
  if (!bf16_) {
    dim3 grid((a.seq + Tile<DH>::BQ - 1) / Tile<DH>::BQ, a.B * a.H);
#define MXT_DQ(C)                                                              \
  flash_bwd_dq_f32<DH, C><<<grid, NT, 0, st>>>(                                \
      (const float*)a.q, (const float*)a.k, (const float*)a.v,                 \
      (const float*)a.dout, (const float*)a.lse, (const float*)a.delta,        \
      (const int8_t*)a.mask, (float*)dq, a.seq, a.H, a.sm_scale, a.drop)
    if (a.causal) MXT_DQ(true); else MXT_DQ(false);
#undef MXT_DQ
    return;
  }
  using G = DqTc<DH>;
  dim3 grid((a.seq + G::BQ - 1) / G::BQ, a.B * a.H);
#define MXT_DQ(C)                                                              \
  do {                                                                         \
    allow_smem<flash_bwd_dq_tc<DH, C>>((int)G::SMEM);                          \
    flash_bwd_dq_tc<DH, C><<<grid, 32 * G::NW, G::SMEM, st>>>(                 \
        (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,                  \
        (const bf16*)a.dout, (const float*)a.lse, (const float*)a.delta,       \
        (const int8_t*)a.mask, (bf16*)dq, a.seq, a.H, a.sm_scale, a.drop);     \
  } while (0)
  if (a.causal) MXT_DQ(true); else MXT_DQ(false);
#undef MXT_DQ
}

template <int DH>
void launch_dkv(const Args& a, int bf16_, void* dk, void* dv, cudaStream_t st) {
  if (!bf16_) {
    dim3 grid((a.seq + Tile<DH>::BK - 1) / Tile<DH>::BK, a.B * a.H);
#define MXT_DKV(C)                                                             \
  flash_bwd_dkv_f32<DH, C><<<grid, NT, 0, st>>>(                               \
      (const float*)a.q, (const float*)a.k, (const float*)a.v,                 \
      (const float*)a.dout, (const float*)a.lse, (const float*)a.delta,        \
      (const int8_t*)a.mask, (float*)dk, (float*)dv, a.seq, a.H, a.sm_scale,   \
      a.drop)
    if (a.causal) MXT_DKV(true); else MXT_DKV(false);
#undef MXT_DKV
    return;
  }
  using G = DkvTc<DH>;
  dim3 grid((a.seq + G::BK - 1) / G::BK, a.B * a.H);
#define MXT_DKV(C)                                                             \
  do {                                                                         \
    allow_smem<flash_bwd_dkv_tc<DH, C>>((int)G::SMEM);                         \
    flash_bwd_dkv_tc<DH, C><<<grid, 32 * G::NW, G::SMEM, st>>>(                \
        (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,                  \
        (const bf16*)a.dout, (const float*)a.lse, (const float*)a.delta,       \
        (const int8_t*)a.mask, (bf16*)dk, (bf16*)dv, a.seq, a.H, a.sm_scale,   \
        a.drop);                                                               \
  } while (0)
  if (a.causal) MXT_DKV(true); else MXT_DKV(false);
#undef MXT_DKV
}

}  // namespace

// Common arguments of both entries: q, k, v, dout: (B, T, H, dh)
// contiguous, f32 (bf16 == 0) or bf16 (bf16 == 1, 16-byte aligned);
// lse, delta: (B, H, T) f32; mask: (B, T) int8, nonzero = key kept;
// dropout != 0 regenerates the forward's keep mask from the int32 seed
// at ``seed`` (device memory), threshold ``thr``, scale ``inv``.  dh
// must be 64, 128 or 256.
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
  if (dh == 64) launch_dq<64>(a, bf16, dq, st);
  else if (dh == 128) launch_dq<128>(a, bf16, dq, st);
  else if (dh == 256) launch_dq<256>(a, bf16, dq, st);
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
  if (dh == 64) launch_dkv<64>(a, bf16, dk, dv, st);
  else if (dh == 128) launch_dkv<128>(a, bf16, dk, dv, st);
  else if (dh == 256) launch_dkv<256>(a, bf16, dk, dv, st);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
