// Shared by flash_fwd.cu and flash_bwd.cu: the positional-hash dropout
// and, for the CUDA-core kernels (the forward, dQ and dK/dV in f32), the
// tile geometry.  The bf16 kernels run on the tensor cores with their
// own tiles (flash_mma.cuh and the kernels' notes).
//
// The tile geometry depends on the head dim.  Every block has NT = 128
// threads; TPR of them share a query (or key) row, each holding DH/TPR
// of its values in registers, and tiles of BK keys (BQ queries) are
// staged in shared memory as f32.  dh 64 and 128 use 32-row tiles with
// 4 threads a row.  At dh 256 that geometry needs 64 KB of static
// shared memory for the two staged tiles (the limit is 48 KB) and 64
// floats a thread for each register array, so dh 256 uses 16-row tiles
// with 8 threads a row: 32 KB of tiles and 32 floats a thread, the same
// register arrays as dh 128.
//
// The hash is mxnet_tpu/kernels/flash_attention.py _dropout_keep (:47)
// in native uint32 arithmetic: a murmur-style mix of (b*H + h, absolute
// query position, absolute key position, seed).  The forward and both
// backward kernels regenerate the same keep bit for a (q, k) pair from
// positions alone, so no mask is stored and the three agree bit for bit
// with the reference and with the plain torch version.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mxt_flash {

constexpr int NT = 128;       // threads per block

template <int DH> struct Tile {
  static constexpr int TPR = DH <= 128 ? 4 : 8;  // threads per row
  static constexpr int BQ = NT / TPR;            // query rows per tile
  static constexpr int BK = BQ;                  // keys per tile
  static_assert(DH % TPR == 0, "head dim must split over the row's threads");
};

// The sum of a value over the TPR neighbouring lanes of one row.
template <int TPR> __device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// True when the pair (q_pos, k_pos) of head row bh is kept; thr is
// min(int(rate * 2^32), 2^32 - 1), computed by the wrapper as the
// reference computes it.
__device__ __forceinline__ bool dropout_keep(uint32_t bh, uint32_t q_pos,
                                             uint32_t k_pos, uint32_t seed,
                                             uint32_t thr) {
  uint32_t x = (q_pos * 2654435761u) ^ (k_pos * 97780813u) ^
               (bh * 2246822519u) ^ seed;
  x = (x ^ (x >> 16)) * 2246822519u;
  x = (x ^ (x >> 13)) * 3266489917u;
  x = x ^ (x >> 16);
  return x >= thr;
}

// Dropout parameters as the wrapper passes them: on == 0 means no
// dropout (seed is then not read); inv is float32(1 / (1 - rate)).
struct Dropout {
  const int* seed;
  uint32_t thr;
  float inv;
  int on;
};

}  // namespace mxt_flash
