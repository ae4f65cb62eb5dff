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
// What bounds it on an H100: operations.  A ResNet-50 3x3 conv at batch
// 128 is 2*B*H*W*C*K*9 = 29.6 GFLOP, 0.030 ms at 989 TFLOP/s on the
// tensor cores, against 18-103 MB of x, w and y (0.005-0.031 ms at
// 3.35 TB/s).
//
// Design (simple and correct first; wgmma, TMA and pipelining later):
//   * one block per (image b, tile of TM consecutive output pixels of
//     that image, tile of TN output channels); 256 threads, each holding
//     a 4-pixel x 4-channel f32 accumulator on the CUDA cores;
//   * over chunks of CC input channels, the block stages the input
//     window (the tile's rows plus one halo row above and below, W+2
//     columns) in shared memory as f32, prologue applied, rounded to x's
//     dtype and halo zeroed as it is loaded, and the 9 x CC x TN weight
//     chunk beside it; then every thread walks the 9 taps x CC channels;
//   * the TPU carries the stats through its sequential grid in VMEM
//     scratch.  Blocks run in no order here, so each block writes its
//     per-channel partial sums (fixed-order reduction over its threads)
//     to a (blocks, K) f32 scratch, and a second launch reduces it in a
//     fixed order: no float atomics, so two calls give bit-identical
//     stats;
//   * shared memory is dynamic (56.6 KB at W = 56, above the 48 KB
//     static limit), with cudaFuncSetAttribute where it needs more.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}
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

// sums[0][k], sums[1][k]: the partials of every block for channel k, in a
// fixed order (thread row r takes blocks r, r+8, ...; then rows 0..7).
// A term passes through at most 4 + 16 + ceil(blocks/8) + 8 additions,
// the depth chip_smoke.py's stats limit counts.
__global__ void __launch_bounds__(256)
reduce_stats_kernel(const float* __restrict__ part, long long blocks, int K,
                    float* __restrict__ sums) {
  __shared__ float red[2][8][32];
  const int k = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f, q = 0.f;
  if (k < K)
    for (long long r = threadIdx.y; r < blocks; r += 8) {
      s += part[r * K + k];
      q += part[(blocks + r) * K + k];
    }
  red[0][threadIdx.y][threadIdx.x] = s;
  red[1][threadIdx.y][threadIdx.x] = q;
  __syncthreads();
  if (threadIdx.y == 0 && k < K) {
    s = 0.f;
    q = 0.f;
    for (int r = 0; r < 8; ++r) {
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

template <typename TI, typename TO>
int launch(const Args& a, int smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv3x3_kernel<TI, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(a.tiles, a.B, (a.K + TN - 1) / TN);
  conv3x3_kernel<TI, TO><<<grid, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Output pixels one block computes: the wrapper allocates the stats
// scratch for B * ceil(H*W / this) blocks.
extern "C" int mxt_conv3x3_tile() { return TM; }

// x (B,H,W,C) and w (3,3,C,K), both f32 (in_bf16 = 0) or both bf16;
// y (B,H,W,K) f32 or bf16 (out_bf16); scale/shift (C,) f32 when prologue;
// with stats, part is a (2, B*tiles, K) f32 scratch and sums (2, K) f32
// receives the channel sums and sums of squares.  All contiguous.
// Returns cudaErrorInvalidValue when the window of width W needs more
// shared memory than the card offers (SMEM_LIMIT: W above 717), else
// cudaGetLastError() after the launches.
extern "C" int mxt_conv3x3(const void* x, const void* w, const float* scale,
                           const float* shift, void* y, float* part, float* sums,
                           int B, int H, int W, int C, int K, int in_bf16,
                           int out_bf16, int prologue, int relu, int stats,
                           void* stream) {
  if (B == 0 || H == 0 || W == 0 || K == 0) return 0;
  const int smem =
      (window_floats(window_rows(H, W), W) + 9 * CC * TN) * (int)sizeof(float);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Args a{x, w, scale, shift, y, part, B, H, W, C, K,
         (H * W + TM - 1) / TM, window_rows(H, W), prologue, relu, stats};
  int err;
  if (in_bf16)
    err = out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(a, smem, st)
                   : launch<__nv_bfloat16, float>(a, smem, st);
  else
    err = out_bf16 ? launch<float, __nv_bfloat16>(a, smem, st)
                   : launch<float, float>(a, smem, st);
  if (err != 0 || !stats) return err;
  const long long blocks = (long long)B * a.tiles;
  reduce_stats_kernel<<<(K + 31) / 32, dim3(32, 8), 0, st>>>(part, blocks, K, sums);
  return (int)cudaGetLastError();
}
