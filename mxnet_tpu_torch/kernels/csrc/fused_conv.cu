// Implicit-GEMM 3x3 convolution for Hopper (sm_90a), stride 1, SAME
// padding, NHWC input and HWIO weights, with the optional BN-apply + ReLU
// prologue on the input read and the optional per-output-channel sum and
// sum of squares of the f32 accumulator.  Plain C interface.
//
// Replaces the TPU kernel of mxnet_tpu/kernels/fused_conv.py
// conv3x3_fused (:107; body _kernel :36, pl.pallas_call at :143).  Its
// semantics, read from the Pallas body and kept exactly:
//   * with scale/shift: v = x*scale + shift in f32, then max(v, 0) with
//     relu; relu alone also applies max(x, 0) (:46);
//   * the 1-pixel SAME halo is zero AFTER the prologue (:57-65): the
//     window is loaded with the prologue applied and the halo zeroed;
//   * the normalised input is rounded back to x's dtype before the
//     products (:66); products and sums are f32 (:77-79);
//   * y is the f32 accumulator cast to the output dtype (:82), and the
//     stats are sums over B, H and W of that accumulator before the cast
//     (:90-91).
// The prologue's x*scale + shift is written with __fmul_rn/__fadd_rn, so
// nvcc cannot contract it into an FMA: it rounds twice, as the plain
// version's eager ops do, and the rounded input agrees bit for bit.
//
// What bounds it on an H100: a ResNet-50 3x3 conv at batch 128 is
// 2*B*H*W*C*K*9 = 29.6 GFLOP, 0.030 ms at 989 TFLOP/s on the tensor
// cores, against 18-103 MB of x, w and y (0.005-0.031 ms at 3.35 TB/s):
// at 56x56x64 bytes and operations are level, at 28x28x128, 14x14x256
// and 7x7x512 operations bound it.  So bf16 inputs go to the tensor
// cores (conv3x3_tc): the inputs are bf16 and the products of bf16
// values are exact in f32, which is mma.sync m16n8k16 bf16 -> f32.
//
// conv3x3_tc, bf16 x and w, y bf16 or f32, an implicit GEMM with M = the
// B*H*W output pixels, N = the K output channels and the reduction over
// 9 taps x C input channels:
//   * a block computes BM consecutive pixels of the flattened B*H*W (a
//     tile may cross rows and images, so the 7x7 and 14x14 images leave
//     no mma rows idle) by BN channels: (BM, BN) = (256, 64) when K <= 64,
//     else (128, 128); 4 warps, each 64 pixels x 64 channels of f32
//     accumulators, so a k-step of 32 mma reads 4 A and 4 B fragments
//     (ldmatrix.x4) from shared memory;
//   * the window: per chunk of CC = 32 input channels, the block stages
//     in shared memory, as bf16 with rows padded by 8 (80 bytes, so the
//     eight rows of an ldmatrix phase hit distinct banks), the flattened
//     pixels each tap can reach: q = p0 - 1 + (dy-1)*W + j for the row
//     offsets dy = 0, 1, 2 and j in [0, BM + 2).  When W < BM + 2 the
//     three segments overlap into one run of BM + 2W + 2 pixels,
//     otherwise they are three runs of BM + 2; window row s holds
//     segment dy = min(s / SS, 2), SS = min(W, BM + 2), in both cases,
//     and pixel i of the tile finds tap (dy, dx) at row dy*SS + i + dx.
//     The window loads by cp.async in 16-byte pieces of 8 channels,
//     zero past B*H*W and past C, two slabs ahead of its first tap; with
//     a prologue, one pass over the landed window in shared memory maps
//     each piece in f32 and rounds it back to bf16 before the chunk's
//     first tap, so no thread waits on a global load for it;
//   * the halo: a tap whose source row or column lies outside the
//     pixel's own image reads an all-zero window row instead (one per
//     window buffer), so the halo is zero after the prologue and a tile
//     that crosses images never reads a neighbouring image;
//   * the im2col gather is free: ldmatrix takes one row address per
//     lane, and each lane points at its own pixel's shifted row; the
//     window stays resident over all 9 taps;
//   * the weights: w is HWIO with K contiguous; one slab of a chunk's
//     tap row (3 taps x CC x BN values) at a time streams through two
//     cp.async stages, the next slab loading while the block runs 3 taps
//     x 2 k-steps on this one (one barrier per 192 mma a warp), and is
//     read as B fragments with ldmatrix.trans; the next chunk's window
//     loads one slab ahead into the second window buffer;
//   * lanes of pixels past B*H*W compute the last pixel again (their
//     rows of y are not written and the stats skip them);
//   * rows that cannot take 16-byte loads (C or K not a multiple of 8,
//     or x or w not 16-byte aligned) run the same kernel with a scalar
//     load loop (template argument VEC = false).
// The f32 instance (x and w f32) stays on the CUDA cores in
// conv3x3_kernel: TF32 would round its inputs to 10 bits, where the
// reference's f32 products do not.  One block per (image, tile of TM
// pixels of that image, TN channels), 4 pixels x 4 channels a thread
// over an f32 window of CC channels in shared memory.
//
// Stats, both kernels: the TPU carries them through its sequential grid
// in VMEM scratch.  Blocks run in no order here, so each block writes
// its per-channel partial sums over its valid pixels, reduced in a fixed
// order, to a (2, rows, K) f32 scratch (rows: mxt_conv3x3_partials), and
// a second launch (reduce_stats_kernel) sums the rows in a fixed order:
// no float atomics, so two calls give bit-identical stats.  In
// conv3x3_tc a thread sums its 8 rows of a column, the 8 lanes of a
// column add by __shfl_xor over 4, 8 and 16, and the pixel warps in
// order through shared memory.
#include "flash_mma.cuh"

namespace {

constexpr int TM = 64;       // output pixels a block computes
constexpr int TN = 64;       // output channels a block computes
constexpr int CC = 16;       // input channels staged per chunk
constexpr int CP = CC + 1;   // padded pixel stride of the window (no bank conflicts)
constexpr int THREADS = 256; // 16 pixel groups x 16 channel groups
constexpr int SMEM_LIMIT = 232448;

struct Args {
  const void* x;
  const void* w;
  const float* scale;
  const float* shift;
  void* y;
  float* part;  // (2, blocks, K): partial sums, then partial sums of squares
  int B, H, W, C, K;
  int tiles;    // pixel tiles per image
  int wrows;    // the most window rows any tile needs
  int prologue, relu, stats;
};

__device__ __forceinline__ float load(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16(v);
}

// Floats of the window region, rounded up so the weights after it are
// 16-byte aligned.
__host__ __device__ inline int window_floats(int wrows, int W) {
  return (wrows * (W + 2) * CP + 3) & ~3;
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(THREADS) conv3x3_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const TI* __restrict__ x = static_cast<const TI*>(a.x);
  const TI* __restrict__ w = static_cast<const TI*>(a.w);
  TO* __restrict__ y = static_cast<TO*>(a.y);

  const int tile = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * TN;
  const int W = a.W, W2 = a.W + 2, HW = a.H * a.W;
  const int p0 = tile * TM;
  const int plast = min(p0 + TM, HW) - 1;
  const int hr0 = p0 / W;                      // first output row of the tile
  const int nrows = plast / W - hr0 + 3;       // window rows, halo included
  float* xs = smem;                            // [nrows][W2][CP]
  float* ws = smem + window_floats(a.wrows, W);  // [9][CC][TN]

  const int tid = threadIdx.x, ti = tid & 15, tj = tid >> 4;
  int base[4];
  bool valid[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int p = p0 + ti + 16 * m;
    valid[m] = p < HW;
    const int q = valid[m] ? p : plast;
    base[m] = ((q / W - hr0) * W2 + q % W) * CP;
  }
  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;

  const long long xb = (long long)b * HW * a.C;
  for (int c0 = 0; c0 < a.C; c0 += CC) {
    const int nwin = nrows * W2 * CC;
    for (int e = tid; e < nwin; e += THREADS) {
      const int c = e % CC, rc = e / CC;
      const int col = rc % W2, r = rc / W2;
      const int h = hr0 - 1 + r, wc = col - 1, ch = c0 + c;
      float v = 0.f;
      if (h >= 0 && h < a.H && wc >= 0 && wc < W && ch < a.C) {
        v = load(x, xb + ((long long)h * W + wc) * a.C + ch);
        if (a.prologue) v = __fadd_rn(__fmul_rn(v, a.scale[ch]), a.shift[ch]);
        if (a.relu) v = v < 0.f ? 0.f : v;
        v = round_to(v, TI());
      }
      xs[(r * W2 + col) * CP + c] = v;
    }
    for (int e = tid; e < 9 * CC * TN; e += THREADS) {
      const int n = e % TN, c = (e / TN) % CC, tap = e / (TN * CC);
      const int ch = c0 + c, k = k0 + n;
      ws[e] = (ch < a.C && k < a.K)
                  ? load(w, ((long long)tap * a.C + ch) * a.K + k) : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = ((tap / 3) * W2 + tap % 3) * CP;
      const float* wt = ws + tap * CC * TN + tj * 4;
#pragma unroll
      for (int c = 0; c < CC; ++c) {
        const float4 bv = *reinterpret_cast<const float4*>(wt + c * TN);
        float av[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) av[m] = xs[base[m] + toff + c];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          acc[m][0] = fmaf(av[m], bv.x, acc[m][0]);
          acc[m][1] = fmaf(av[m], bv.y, acc[m][1]);
          acc[m][2] = fmaf(av[m], bv.z, acc[m][2]);
          acc[m][3] = fmaf(av[m], bv.w, acc[m][3]);
        }
      }
    }
    __syncthreads();
  }

  const long long yb = (long long)b * HW * a.K;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    if (!valid[m]) continue;
    const long long o = yb + (long long)(p0 + ti + 16 * m) * a.K;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int k = k0 + tj * 4 + n;
      if (k < a.K) store(y, o + k, acc[m][n]);
    }
  }
  if (!a.stats) return;
  // partial stats of this block: each thread over its valid pixels, then
  // the 16 pixel groups in order (the loop above ended with a barrier, so
  // the window's shared memory is free)
  float* rs = smem;             // [16][TN]
  float* rq = smem + 16 * TN;   // [16][TN]
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (valid[m]) {
        s += acc[m][n];
        q += acc[m][n] * acc[m][n];
      }
    rs[ti * TN + tj * 4 + n] = s;
    rq[ti * TN + tj * 4 + n] = q;
  }
  __syncthreads();
  if (tid < TN && k0 + tid < a.K) {
    float s = 0.f, q = 0.f;
    for (int i = 0; i < 16; ++i) {
      s += rs[i * TN + tid];
      q += rq[i * TN + tid];
    }
    const long long blocks = (long long)a.B * a.tiles;
    const long long blk = (long long)b * a.tiles + tile;
    a.part[blk * a.K + k0 + tid] = s;
    a.part[(blocks + blk) * a.K + k0 + tid] = q;
  }
}

// ---- conv3x3_tc: the bf16 instance on the tensor cores ------------------

namespace tc {

constexpr int CC = 32;           // input channels a window chunk holds
constexpr int LDW = CC + 8;      // window row stride, bf16 (80 bytes)
constexpr int NT = 128;          // 4 warps, each 64 pixels x 64 channels
constexpr int MI = 4;            // 16-pixel mma tiles of a warp
constexpr int NJ = 4;            // 16-channel ldmatrix.trans loads of B a k-step
constexpr int STAGES = 2;        // weight slabs: the one in use and the next

// Block tiles: (BM pixels, BN channels) = (256, 64) when K <= 64, else
// (128, 128); 4 warps either way.
template <int BM>
__host__ __device__ inline int seg_stride(int W) { return W < BM + 2 ? W : BM + 2; }
template <int BM>
__host__ __device__ inline int window_rows(int W) { return 2 * seg_stride<BM>(W) + BM + 2; }

// Dynamic shared memory: two windows, each with its zero row, and the
// weight ring.
template <int BM, int BN>
__host__ __device__ inline int smem_bytes(int W) {
  return (2 * (window_rows<BM>(W) + 1) * LDW + STAGES * 3 * CC * (BN + 8)) *
         (int)sizeof(__nv_bfloat16);
}

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;
  const float* scale;
  const float* shift;
  void* y;
  float* part;     // (2, tiles, K)
  long long P;     // B*H*W output pixels
  int H, W, C, K;
  int tiles;       // ceil(P / BM): the grid's x and the partial rows
  int prologue, relu, stats;
};

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16(a);
}
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }

// The prologue on value v of a channel with (sc, sh), before its
// rounding to bf16.
__device__ __forceinline__ float prologue(const Args& a, float v, float sc, float sh) {
  if (a.prologue) v = __fadd_rn(__fmul_rn(v, sc), sh);
  if (a.relu) v = v < 0.f ? 0.f : v;
  return v;
}

// Flattened pixel of window row s (may lie outside [0, P)).
__device__ __forceinline__ long long window_pixel(long long p0, int s, int SS, int W) {
  const int dy = s >= 2 * SS ? 2 : s >= SS ? 1 : 0;  // min(s / SS, 2)
  return p0 - 1 + (long long)(dy - 1) * W + (s - dy * SS);
}

// Window of channels [c0, c0 + CC) into dst[rows][LDW], rows outside
// [0, P) and channels past C zero.  With VEC by cp.async, as x holds it
// (waited for with the weight slab committed after it; prologue_window
// applies the prologue once it has landed); otherwise by scalar loads,
// the prologue applied, seen by the block after its next barrier.
template <bool VEC>
__device__ __forceinline__ void stage_window(const Args& a, __nv_bfloat16* dst,
                                             long long p0, int c0, int SS, int NS) {
  const int tid = threadIdx.x;
  if (VEC) {
    // a thread's pieces all hold channels c0 + (tid & 3) * 8 .. + 7
    const int c = c0 + (tid & 3) * 8;
    for (int e = tid; e < NS * (CC / 8); e += NT) {
      const long long q = window_pixel(p0, e >> 2, SS, a.W);
      const bool ok = q >= 0 && q < a.P && c < a.C;
      mxt_mma::cp_async16(dst + (e >> 2) * LDW + (e & 3) * 8,
                          ok ? a.x + q * a.C + c : a.x, ok);
    }
  } else {
    for (int e = tid; e < NS * CC; e += NT) {
      const int s = e / CC, c = c0 + e % CC;
      const long long q = window_pixel(p0, s, SS, a.W);
      __nv_bfloat16 v = __float2bfloat16(0.f);
      if (q >= 0 && q < a.P && c < a.C) {
        v = a.x[q * a.C + c];
        if (a.prologue || a.relu)
          v = __float2bfloat16(prologue(a, __bfloat162float(v),
                                        a.prologue ? __ldg(a.scale + c) : 1.f,
                                        a.prologue ? __ldg(a.shift + c) : 0.f));
      }
      dst[s * LDW + e % CC] = v;
    }
  }
}

// The prologue on a window loaded by cp.async, in place: each 16-byte
// piece (8 channels of a row) read from shared memory, mapped in f32,
// rounded back to bf16 and stored; rows outside [0, P) and channels past
// C stay zero, so the halo (the zero row) is zero after the prologue.
__device__ __forceinline__ void prologue_window(const Args& a, __nv_bfloat16* win,
                                                long long p0, int c0, int SS, int NS) {
  const int tid = threadIdx.x, c = c0 + (tid & 3) * 8;
  if (c >= a.C) return;
  float sc[8], sh[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    sc[i] = a.prologue ? __ldg(a.scale + c + i) : 1.f;
    sh[i] = a.prologue ? __ldg(a.shift + c + i) : 0.f;
  }
  for (int e = tid; e < NS * (CC / 8); e += NT) {
    const long long q = window_pixel(p0, e >> 2, SS, a.W);
    if (q < 0 || q >= a.P) continue;
    uint4* piece = reinterpret_cast<uint4*>(win + (e >> 2) * LDW + (e & 3) * 8);
    const uint4 v = *piece;
    uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      u[i] = mxt_mma::pack_bf16(
          prologue(a, __uint_as_float(u[i] << 16), sc[2 * i], sh[2 * i]),
          prologue(a, __uint_as_float(u[i] & 0xffff0000u), sc[2 * i + 1], sh[2 * i + 1]));
    *piece = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

// Weight slab `it` (chunk it / 3, tap row dy = it % 3): for the taps
// (dy, 0..2), rows of input channels [c0, c0 + CC) and columns of output
// channels [k0, k0 + BN), into dst[3][CC][BN + 8], zero past C and K.
template <int BN, bool VEC>
__device__ __forceinline__ void stage_weights(const Args& a, __nv_bfloat16* dst, int it,
                                              int k0) {
  constexpr int LDB = BN + 8;
  const int chunk = it / 3, dy = it - chunk * 3, c0 = chunk * CC;
  const __nv_bfloat16* src = a.w + (long long)dy * 3 * a.C * a.K;
  if (VEC) {
    constexpr int PER = BN / 8;
#pragma unroll
    for (int e = threadIdx.x; e < 3 * CC * PER; e += NT) {
      const int r = e / PER, n = (e % PER) * 8, dx = r / CC, c = c0 + r % CC, k = k0 + n;
      const bool ok = c < a.C && k < a.K;
      mxt_mma::cp_async16(dst + r * LDB + n,
                          ok ? src + ((long long)dx * a.C + c) * a.K + k : a.w, ok);
    }
  } else {
    for (int e = threadIdx.x; e < 3 * CC * BN; e += NT) {
      const int r = e / BN, n = e % BN, dx = r / CC, c = c0 + r % CC, k = k0 + n;
      dst[r * LDB + n] = (c < a.C && k < a.K) ? src[((long long)dx * a.C + c) * a.K + k]
                                              : __float2bfloat16(0.f);
    }
  }
}

template <typename TO, int BM, int BN, bool VEC>
__global__ void __launch_bounds__(NT, 2) conv3x3_tc(Args a) {
  constexpr int LDB = BN + 8;
  constexpr int WMS = BM / 64;  // warps along the pixels (BN / 64 along channels)
  static_assert(WMS * (BN / 64) * 32 == NT, "4 warps of 64 x 64");
  extern __shared__ uint4 smem_tc[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  const int W = a.W, SS = seg_stride<BM>(W), NS = window_rows<BM>(W);
  __nv_bfloat16* win0 = smem;
  __nv_bfloat16* ring = smem + 2 * (NS + 1) * LDW;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WMS, wn = warp / WMS;
  const long long p0 = (long long)blockIdx.x * BM;
  const int k0 = blockIdx.y * BN;

  // the zero row after each window
  if (tid < 2 * (LDW / 8)) {
    const int b = tid / (LDW / 8), piece = tid % (LDW / 8);
    *reinterpret_cast<uint4*>(win0 + b * (NS + 1) * LDW + NS * LDW + piece * 8) =
        make_uint4(0, 0, 0, 0);
  }
  // this lane's A rows (pixel lane & 15 of its warp's 16-pixel tiles):
  // the tile-local index and the taps that stay in its image
  int arow[MI], amask[MI];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    long long p = p0 + wm * 64 + mi * 16 + (lane & 15);
    if (p >= a.P) p = a.P - 1;
    const int h = (int)((p / W) % a.H), wc = (int)(p % W);
    int mask = 0;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int hh = h + t / 3 - 1, ww = wc + t % 3 - 1;
      if (hh >= 0 && hh < a.H && ww >= 0 && ww < W) mask |= 1 << t;
    }
    arow[mi] = (int)(p - p0);
    amask[mi] = mask;
  }

  float acc[MI][2 * NJ][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < 2 * NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;

  constexpr int SLAB = 3 * CC * LDB;   // bf16 of one ring stage
  const int nit = (a.C + CC - 1) / CC * 3;
  stage_window<VEC>(a, win0, p0, 0, SS, NS);
  stage_weights<BN, VEC>(a, ring, 0, k0);
  mxt_mma::cp_async_commit();

#pragma unroll 1
  for (int it = 0; it < nit; ++it) {
    mxt_mma::cp_async_wait<0>();  // slab it (and its chunk's window) landed
    __syncthreads();              // ... for every thread; slab it - 1 is free
    const int nxt = it + 1;
    if (nxt < nit) {
      stage_weights<BN, VEC>(a, ring + (nxt & 1) * SLAB, nxt, k0);
      if (nxt % 3 == 0)
        stage_window<VEC>(a, win0 + ((nxt / 3) & 1) * (NS + 1) * LDW, p0, nxt / 3 * CC,
                          SS, NS);
    }
    mxt_mma::cp_async_commit();

    const int chunk = it / 3, dy = it - chunk * 3;
    if (VEC && dy == 0 && (a.prologue || a.relu)) {
      prologue_window(a, win0 + (chunk & 1) * (NS + 1) * LDW, p0, chunk * CC, SS, NS);
      __syncthreads();
    }
    const __nv_bfloat16* wb = win0 + (chunk & 1) * (NS + 1) * LDW + (lane >> 4) * 8;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int tap = dy * 3 + dx;
      const __nv_bfloat16* rb = ring + (it & 1) * SLAB + dx * CC * LDB;
      int arows[MI];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        arows[mi] = (amask[mi] >> tap) & 1 ? dy * SS + arow[mi] + dx : NS;
#pragma unroll
      for (int ks = 0; ks < CC / 16; ++ks) {
        uint32_t af[MI][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          mxt_mma::ldsm_x4(af[mi], wb + arows[mi] * LDW + ks * 16);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          uint32_t bf[4];
          mxt_mma::ldsm_x4_t(bf, mxt_mma::bt_addr<LDB>(rb, ks * 16, wn * 64 + j * 16, lane));
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            mxt_mma::mma(acc[mi][2 * j], af[mi], bf[0], bf[1]);
            mxt_mma::mma(acc[mi][2 * j + 1], af[mi], bf[2], bf[3]);
          }
        }
      }
    }
  }
  mxt_mma::cp_async_wait<0>();

  // y: accumulator rows g and g + 8 of each 16-pixel tile, columns 2t, 2t + 1
  TO* __restrict__ y = static_cast<TO*>(a.y);
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = (a.K & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const long long p = p0 + wm * 64 + mi * 16 + g + hf * 8;
      if (p >= a.P) continue;
#pragma unroll
      for (int j = 0; j < 2 * NJ; ++j) {
        const int k = k0 + wn * 64 + j * 8 + 2 * t;
        TO* o = y + p * a.K + k;
        const float v0 = acc[mi][j][2 * hf], v1 = acc[mi][j][2 * hf + 1];
        if (pairs && k + 1 < a.K) {
          store2(o, v0, v1);
        } else {
          if (k < a.K) store1(o, v0);
          if (k + 1 < a.K) store1(o + 1, v1);
        }
      }
    }
  if (!a.stats) return;

  // partial stats of this block: each thread over its valid rows (tile mi
  // row g, then g + 8, for mi = 0..3), the 8 lanes g of a column by
  // __shfl_xor 4, 8, 16, then the pixel warps in order
  __syncthreads();                       // every warp is done with the window
  float* red = reinterpret_cast<float*>(smem);   // [2][WMS][BN]
#pragma unroll
  for (int j = 0; j < 2 * NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          if (p0 + wm * 64 + mi * 16 + g + hf * 8 < a.P) {
            const float v = acc[mi][j][2 * hf + e];
            s += v;
            q += v * v;
          }
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, m);
        q += __shfl_xor_sync(0xffffffffu, q, m);
      }
      if (g == 0) {
        const int col = wn * 64 + j * 8 + 2 * t + e;
        red[wm * BN + col] = s;
        red[(WMS + wm) * BN + col] = q;
      }
    }
  __syncthreads();
  if (tid < BN && k0 + tid < a.K) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int r = 0; r < WMS; ++r) {
      s += red[r * BN + tid];
      q += red[(WMS + r) * BN + tid];
    }
    a.part[(long long)blockIdx.x * a.K + k0 + tid] = s;
    a.part[((long long)a.tiles + blockIdx.x) * a.K + k0 + tid] = q;
  }
}

// Pixels one block (and one partial row of the stats) covers.
inline int block_pixels(int K) { return K <= 64 ? 256 : 128; }

template <typename TO, int BM, int BN, bool VEC>
int launch(const Args& a, cudaStream_t st) {
  // the attribute is set once, for the widest window any W needs
  mxt_mma::allow_smem<conv3x3_tc<TO, BM, BN, VEC>>(smem_bytes<BM, BN>(BM + 2));
  const dim3 grid(a.tiles, (a.K + BN - 1) / BN);
  conv3x3_tc<TO, BM, BN, VEC><<<grid, NT, smem_bytes<BM, BN>(a.W), st>>>(a);
  return (int)cudaGetLastError();
}

template <typename TO>
int launch_tile(const Args& a, bool vec, cudaStream_t st) {
  if (block_pixels(a.K) == 256)
    return vec ? launch<TO, 256, 64, true>(a, st) : launch<TO, 256, 64, false>(a, st);
  return vec ? launch<TO, 128, 128, true>(a, st) : launch<TO, 128, 128, false>(a, st);
}

}  // namespace tc

// sums[0][k], sums[1][k]: the partial rows of channel k summed in a
// fixed order: thread row r of 32 takes rows r, r+32, ... in order (its
// loads unrolled ahead of the additions), then one thread adds the 32 in
// order.  A term passes through at most ceil(rows/32) + 32 additions
// here, the part of the depth chip_smoke.py's stats limit counts after
// the blocks.
__global__ void __launch_bounds__(1024)
reduce_stats_kernel(const float* __restrict__ part, long long rows, int K,
                    float* __restrict__ sums) {
  __shared__ float red[2][32][33];
  const int k = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f, q = 0.f;
  if (k < K) {
#pragma unroll 4
    for (long long r = threadIdx.y; r < rows; r += 32) {
      s += part[r * K + k];
      q += part[(rows + r) * K + k];
    }
  }
  red[0][threadIdx.y][threadIdx.x] = s;
  red[1][threadIdx.y][threadIdx.x] = q;
  __syncthreads();
  if (threadIdx.y == 0 && k < K) {
    s = 0.f;
    q = 0.f;
    for (int r = 0; r < 32; ++r) {
      s += red[0][r][threadIdx.x];
      q += red[1][r][threadIdx.x];
    }
    sums[k] = s;
    sums[K + k] = q;
  }
}

int window_rows(int H, int W) {
  const int span = (TM - 1) / W + 2;  // output rows a tile can touch
  return (span < H ? span : H) + 2;
}

template <typename TO>
int launch_f32(const Args& a, int smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv3x3_kernel<float, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(a.tiles, a.B, (a.K + TN - 1) / TN);
  conv3x3_kernel<float, TO><<<grid, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Output pixels one block's stats partial row covers, for K output
// channels: 256 (K <= 64) or 128 consecutive pixels of the flattened
// B*H*W for bf16 x (conv3x3_tc), TM pixels of one image for f32 x
// (conv3x3_kernel).
extern "C" int mxt_conv3x3_tile(int K, int in_bf16) {
  return in_bf16 ? tc::block_pixels(K) : TM;
}

// Rows of the (2, rows, K) stats scratch for x (B, H, W, C): one per
// block along the pixels.
extern "C" long long mxt_conv3x3_partials(int B, int H, int W, int K, int in_bf16) {
  if (in_bf16) {
    const int bm = tc::block_pixels(K);
    return ((long long)B * H * W + bm - 1) / bm;
  }
  return (long long)B * ((H * W + TM - 1) / TM);
}

// x (B,H,W,C) and w (3,3,C,K), both f32 (in_bf16 = 0) or both bf16;
// y (B,H,W,K) f32 or bf16 (out_bf16); scale/shift (C,) f32 when prologue;
// with stats, part is a (2, mxt_conv3x3_partials(...), K) f32 scratch and
// sums (2, K) f32 receives the channel sums and sums of squares.  All
// contiguous.  bf16 x runs conv3x3_tc at any W (16-byte loads where C
// and K are multiples of 8 and x and w 16-byte aligned, else its scalar
// loop); f32 x runs conv3x3_kernel, which returns cudaErrorInvalidValue
// when the window of width W needs more shared memory than the card
// offers (SMEM_LIMIT: W above 717).  Returns cudaGetLastError() after the
// launches.
extern "C" int mxt_conv3x3(const void* x, const void* w, const float* scale,
                           const float* shift, void* y, float* part, float* sums,
                           int B, int H, int W, int C, int K, int in_bf16,
                           int out_bf16, int prologue, int relu, int stats,
                           void* stream) {
  if (B == 0 || H == 0 || W == 0 || K == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const long long rows = mxt_conv3x3_partials(B, H, W, K, in_bf16);
  int err;
  if (in_bf16) {
    const tc::Args a{static_cast<const __nv_bfloat16*>(x),
                     static_cast<const __nv_bfloat16*>(w),
                     scale, shift, y, part, (long long)B * H * W, H, W, C, K,
                     (int)rows, prologue, relu, stats};
    const bool vec = C % 8 == 0 && K % 8 == 0 && (uintptr_t)x % 16 == 0 &&
                     (uintptr_t)w % 16 == 0;
    err = out_bf16 ? tc::launch_tile<__nv_bfloat16>(a, vec, st)
                   : tc::launch_tile<float>(a, vec, st);
  } else {
    const int smem =
        (window_floats(window_rows(H, W), W) + 9 * CC * TN) * (int)sizeof(float);
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    Args a{x, w, scale, shift, y, part, B, H, W, C, K,
           (H * W + TM - 1) / TM, window_rows(H, W), prologue, relu, stats};
    err = out_bf16 ? launch_f32<__nv_bfloat16>(a, smem, st)
                   : launch_f32<float>(a, smem, st);
  }
  if (err != 0 || !stats) return err;
  reduce_stats_kernel<<<(K + 31) / 32, dim3(32, 32), 0, st>>>(part, rows, K, sums);
  return (int)cudaGetLastError();
}
