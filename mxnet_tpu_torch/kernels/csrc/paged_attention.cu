// Paged single-token attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel mxnet_tpu/kernels/paged_attention.py
// (pl.pallas_call in _build at :209, body _kernel at :82, entry
// paged_attention at :221): each row t attends with its query
// q[t, h, :] to the positions 0..pos[t] of its sequence, whose k|v live
// in pages of the pool named by the row's block table.  Pages past
// min(pos/ps, PP-1) are never read, and positions above pos in the last
// page score -1e30 exactly like the Pallas body (:132).  For an int8
// pool the k scale (plane 0) multiplies the scores before the division
// by sqrt(dh), and the v scale (plane 1) multiplies p after the
// denominator takes it, as at :129/:142; p is rounded to the compute
// dtype before the PV product (the Pallas ``p.astype(cdt)``).
//
// What bounds it on an H100: a decode step reads every live position's
// k|v once and does 4*dh FLOPs per (row, head, position) against
// 2*2*dh bytes (bf16), about one FLOP per byte, so bytes bound it: the
// distinct pages the rows walk, ps*H*2*dh*elem each, over 3.35 TB/s
// (about 1 us at the engine's shapes).  At those shapes the call is a
// few microseconds of launch and latency, so the design spreads the
// walk over many blocks and keeps each block's dependent steps short.
//
// Design: flash decoding, two kernels a call.
//   * paged_split, grid (T, H, NS): split s of row t, head h walks the
//     pages [s*pps, min((s+1)*pps, last+1)) of the row's block table,
//     pps pages a split (the wrapper takes pps*ps near 64 positions) and
//     NS = ceil(PP / pps) from the table's shape, never from pos, so the
//     host reads no device data.  A split whose first page lies past the
//     row's last page writes nothing and exits.  Inside a split, L lanes
//     share a position (L a power of two up to 32) and each loads 16-byte
//     pieces of its k row (8 bf16, 16 int8 or 4 f32 values), so each
//     score is one dot product reduced over L lanes and computed once;
//     the split's max is a block reduce, each exp is taken once (one
//     thread a position), and the weight p (v-scaled for int8) is
//     rounded to the compute dtype in shared memory; PV accumulates in
//     f32 with each thread owning one 16-byte piece of output dims over
//     a fixed subset of positions, the subsets summed in a fixed order.
//     The split writes its (m, l, acc[dh]) in f32 to the workspace.
//   * paged_combine, one warp per (t, h): derives the live splits from
//     pos on the device and reads only those partials (so -inf - -inf
//     never arises), rescales each by exp(m_s - M) in split order
//     0..n-1, and writes acc / l in f32.  The fixed orders keep the
//     result bit-identical from call to call.
// 16-byte loads need the pool 16-byte aligned and dh*elem a multiple of
// 16 (so the v half of a row is aligned too); otherwise the same kernel
// runs its scalar load loop (template argument VEC = false, one value a
// piece), chosen by the wrapper, with the same arithmetic.  Dead engine
// rows point at an all-zero block-table row (scratch page 0) with pos 0
// and read one finite scratch slot.  The wrapper checks every shape and
// dtype and allocates the workspace; the caller guarantees page ids <
// num_pages.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads of a split block
constexpr int NWS = NT / 32;
constexpr int CW = 4;    // (t, h) rows per combine block, a warp each

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

// One piece of a k or v row: W values from p as f32, one 16-byte load
// (VEC) or one scalar load (W = 1).
template <typename T, bool VEC> struct Piece {
  static constexpr int W = 1;
  static __device__ __forceinline__ void load(const T* p, float (&x)[W]) { x[0] = to_f(p[0]); }
};
template <> struct Piece<float, true> {
  static constexpr int W = 4;
  static __device__ __forceinline__ void load(const float* p, float (&x)[W]) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    x[0] = u.x;
    x[1] = u.y;
    x[2] = u.z;
    x[3] = u.w;
  }
};
template <> struct Piece<__nv_bfloat16, true> {
  static constexpr int W = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&x)[W]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(b[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};
template <> struct Piece<int8_t, true> {
  static constexpr int W = 16;
  static __device__ __forceinline__ void load(const int8_t* p, float (&x)[W]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = (float)c[i];
  }
};

// Shared memory of a split block, in 4-byte words: q, the scores (then
// the weights), the v scales, the warp reduce slots, the PV partials of
// the G position groups, the page ids.
__host__ __device__ inline int split_groups(int dh, int w) {
  const int nc = dh / w;
  return nc >= NT ? 1 : NT / nc;
}
__host__ __device__ inline int split_smem_words(int dh, int ps, int pps, int w) {
  return dh + 2 * pps * ps + 2 * NWS + split_groups(dh, w) * dh + pps;
}

template <typename TQ, typename TKV, bool INT8, bool VEC>
__global__ void __launch_bounds__(NT)
paged_split(const TQ* __restrict__ q, const TKV* __restrict__ pool,
            const float* __restrict__ scales, const int* __restrict__ bt,
            const int* __restrict__ pos, float* __restrict__ part, int H, int dh,
            int ps, int PP, int pps, float sqrt_dh) {
  using P = Piece<TKV, VEC>;
  constexpr int W = P::W;
  extern __shared__ float smem[];
  const int t = blockIdx.x, h = blockIdx.y, sp = blockIdx.z, NS = gridDim.z;
  const int p = pos[t];
  // positions past the view (PP pages) do not exist in the reference
  const int last = min(p / ps, PP - 1);
  const int j0 = sp * pps;
  if (j0 > last) return;  // a dead split: the combine never reads it
  const int n = min(pps, last + 1 - j0) * ps;  // positions of this split
  const int nmax = pps * ps;
  const int nc = dh / W;                       // pieces of a k or v row
  const int G = split_groups(dh, W);
  float* qs = smem;              // [dh]
  float* sc = qs + dh;           // [nmax] scores, then rounded weights
  float* vsc = sc + nmax;        // [nmax] v scales (int8)
  float* red = vsc + nmax;       // [2][NWS] max, sum
  float* acc = red + 2 * NWS;    // [G][dh] PV partials
  int* pg = reinterpret_cast<int*>(acc + G * dh);  // [pps] page ids
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t tok = (size_t)H * 2 * dh;       // pool stride of a slot
  const size_t head = (size_t)h * 2 * dh;

  for (int d = tid; d < dh; d += NT) qs[d] = to_f(q[((size_t)t * H + h) * dh + d]);
  for (int j = tid; j < n / ps; j += NT) pg[j] = bt[(size_t)t * PP + j0 + j];
  if (INT8) {
    for (int i = tid; i < n; i += NT) {
      const int page = bt[(size_t)t * PP + j0 + i / ps];
      vsc[i] = scales[(((size_t)page * 2 + 1) * ps + i % ps) * H + h];
    }
  }
  __syncthreads();

  // scores: L lanes a position, each position's dot product once
  int L = 1;
  while (L < nc && L < 32) L <<= 1;
  const int sub = tid & (L - 1);
  for (int i0 = 0; i0 < n; i0 += NT / L) {  // the same trip count in every lane
    const int i = i0 + tid / L;
    const bool ok = i < n;
    const int page = ok ? pg[i / ps] : 0, slot = i % ps;
    const TKV* kr = pool + ((size_t)page * ps + slot) * tok + head;
    float part_s = 0.f;
    if (ok) {
      for (int c = sub; c < nc; c += L) {
        float x[W];
        P::load(kr + c * W, x);
#pragma unroll
        for (int w = 0; w < W; ++w) part_s += qs[c * W + w] * x[w];
      }
    }
    for (int o = L >> 1; o > 0; o >>= 1) part_s += __shfl_xor_sync(0xffffffffu, part_s, o);
    if (ok && sub == 0) {
      float s = part_s;
      if (INT8) s *= scales[(((size_t)page * 2 + 0) * ps + slot) * H + h];
      s = s / sqrt_dh;
      sc[i] = (j0 * ps + i <= p) ? s : -1e30f;
    }
  }
  __syncthreads();

  // the split's max, then each exp once; l takes p unscaled
  float m = -INFINITY;
  for (int i = tid; i < n; i += NT) m = fmaxf(m, sc[i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < NWS; ++w) m = fmaxf(m, red[w]);
  float l = 0.f;
  for (int i = tid; i < n; i += NT) {
    const float e = expf(sc[i] - m);
    l += e;
    sc[i] = round_to<TQ>(INT8 ? e * vsc[i] : e);  // p.astype(cdt) before the V dot
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  if (lane == 0) red[NWS + warp] = l;
  __syncthreads();

  // PV: piece c of the output over positions grp, grp + G, ...
  for (int u = tid; u < G * nc; u += NT) {
    const int c = u % nc, grp = u / nc;
    float a[W];
#pragma unroll
    for (int w = 0; w < W; ++w) a[w] = 0.f;
    for (int i = grp; i < n; i += G) {
      const float wt = sc[i];
      const TKV* vr = pool + ((size_t)pg[i / ps] * ps + i % ps) * tok + head + dh;
      float x[W];
      P::load(vr + c * W, x);
#pragma unroll
      for (int w = 0; w < W; ++w) a[w] += wt * x[w];
    }
#pragma unroll
    for (int w = 0; w < W; ++w) acc[grp * dh + c * W + w] = a[w];
  }
  __syncthreads();

  float* out = part + (((size_t)t * H + h) * NS + sp) * (dh + 2);
  if (tid == 0) {
    float lt = red[NWS];
#pragma unroll
    for (int w = 1; w < NWS; ++w) lt += red[NWS + w];
    out[0] = m;
    out[1] = lt;
  }
  for (int d = tid; d < dh; d += NT) {
    float a = acc[d];
    for (int grp = 1; grp < G; ++grp) a += acc[grp * dh + d];
    out[2 + d] = a;
  }
}

__global__ void __launch_bounds__(32 * CW)
paged_combine(const float* __restrict__ part, const int* __restrict__ pos,
              float* __restrict__ out, int T, int H, int dh, int ps, int PP, int pps,
              int NS) {
  const int row = blockIdx.x * CW + (threadIdx.x >> 5);  // t * H + h
  const int lane = threadIdx.x & 31;
  if (row >= T * H) return;
  const int last = min(pos[row / H] / ps, PP - 1);
  const int live = last / pps + 1;  // splits whose first page is <= last
  const size_t stride = (size_t)dh + 2;
  const float* pr = part + (size_t)row * NS * stride;
  float M = -INFINITY;
  for (int s = 0; s < live; ++s) M = fmaxf(M, pr[s * stride]);
  float l = 0.f;
  for (int s = 0; s < live; ++s) l += pr[s * stride + 1] * expf(pr[s * stride] - M);
  for (int d = lane; d < dh; d += 32) {
    float a = 0.f;
    for (int s = 0; s < live; ++s) a += pr[s * stride + 2 + d] * expf(pr[s * stride] - M);
    out[(size_t)row * dh + d] = a / l;
  }
}

template <typename TQ, typename TKV, bool INT8, bool VEC>
int launch(const void* q, const void* pool, const void* scales, const void* bt,
           const void* pos, void* part, void* out, int T, int H, int dh, int ps,
           int PP, int pps, float sqrt_dh, cudaStream_t st) {
  const int NS = (PP + pps - 1) / pps;
  const size_t smem =
      (size_t)split_smem_words(dh, ps, pps, Piece<TKV, VEC>::W) * sizeof(float);
  auto kern = paged_split<TQ, TKV, INT8, VEC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(T, H, NS), NT, smem, st>>>((const TQ*)q, (const TKV*)pool,
                                         (const float*)scales, (const int*)bt,
                                         (const int*)pos, (float*)part, H, dh, ps, PP,
                                         pps, sqrt_dh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paged_combine<<<(T * H + CW - 1) / CW, 32 * CW, 0, st>>>(
      (const float*)part, (const int*)pos, (float*)out, T, H, dh, ps, PP, pps, NS);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV, bool INT8>
int launch_vec(int vec, const void* q, const void* pool, const void* scales,
               const void* bt, const void* pos, void* part, void* out, int T, int H,
               int dh, int ps, int PP, int pps, float sqrt_dh, cudaStream_t st) {
  if (!vec)
    return launch<TQ, TKV, INT8, false>(q, pool, scales, bt, pos, part, out, T, H, dh,
                                        ps, PP, pps, sqrt_dh, st);
  if ((uintptr_t)pool % 16 != 0 || (dh * sizeof(TKV)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return launch<TQ, TKV, INT8, true>(q, pool, scales, bt, pos, part, out, T, H, dh, ps,
                                     PP, pps, sqrt_dh, st);
}

}  // namespace

// q: (T, H, dh) f32 (bf16 == 0) or bf16 (bf16 == 1); pool: (NP, ps, H,
// 2*dh) in q's dtype, or int8 (kv_int8 == 1) with scales (NP, 2, ps, H)
// f32; bt: (T, PP) int32; pos: (T,) int32; part: the f32 workspace,
// (T, H, ceil(PP / pps), dh + 2); out: (T, H, dh) f32.  All contiguous.
// dh <= 256; pps >= 1 pages a split; vec != 0 takes 16-byte loads (the
// pool 16-byte aligned and dh * elem a multiple of 16, else an error).
// Launches the split and the combine kernel and returns
// cudaGetLastError() after them.
extern "C" int mxt_paged_attention(const void* q, const void* pool,
                                   const void* scales, const void* bt,
                                   const void* pos, void* part, void* out, int T,
                                   int H, int dh, int ps, int PP, int pps, int bf16,
                                   int kv_int8, int vec, float sqrt_dh,
                                   void* stream) {
  if (T * H == 0) return 0;
  if (dh < 1 || dh > 256 || ps < 1 || PP < 1 || pps < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16 && kv_int8)
    return launch_vec<__nv_bfloat16, int8_t, true>(vec, q, pool, scales, bt, pos, part,
                                                   out, T, H, dh, ps, PP, pps, sqrt_dh,
                                                   st);
  if (bf16)
    return launch_vec<__nv_bfloat16, __nv_bfloat16, false>(
        vec, q, pool, scales, bt, pos, part, out, T, H, dh, ps, PP, pps, sqrt_dh, st);
  if (kv_int8)
    return launch_vec<float, int8_t, true>(vec, q, pool, scales, bt, pos, part, out, T,
                                           H, dh, ps, PP, pps, sqrt_dh, st);
  return launch_vec<float, float, false>(vec, q, pool, scales, bt, pos, part, out, T, H,
                                         dh, ps, PP, pps, sqrt_dh, st);
}
