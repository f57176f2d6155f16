// Building blocks of the flash-attention kernels above head dim 256
// (flash_attention_fwd_wide.cu, flash_attention_bwd_wide.cu): a block holds
// G groups of warps over the same rows, each group owning a slice of the
// head dim, streaming its own tiles through a ring in shared memory and
// syncing on a named barrier of its own threads; the warps of a 16-row
// strip swap their partial products behind a named barrier of theirs.

#pragma once

#include <cuda_bf16.h>
#include <stddef.h>

#include "flash_attention_common.cuh"
#include "flash_attention_mma.cuh"

namespace ff_wide {

using ff_mma::bf16;

// Row padding of a staged tile and the elements of a 16-byte copy: 8 bf16
// (a row stride of 2 KC + 16 bytes puts the eight rows an ldmatrix reads in
// eight different groups of four banks) or 4 f32 (a stride of 4 banks mod
// 8: fragment reads on 32 different banks, flash_attention_tf32.cuh).
template <typename T>
struct Pad;
template <>
struct Pad<bf16> {
  static constexpr int kPad = 8, kVec = 8;
};
template <>
struct Pad<float> {
  static constexpr int kPad = 4, kVec = 4;
};

// Wait until `threads` threads (the calling warp's included) arrive at
// barrier `id` (1..15; 0 is __syncthreads'); orders their shared-memory
// accesses.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Wait until at most n (0..7) committed cp.async groups are still in
// flight, n known only at run time.
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: ff_mma::cp_async_wait<0>(); break;
    case 1: ff_mma::cp_async_wait<1>(); break;
    case 2: ff_mma::cp_async_wait<2>(); break;
    case 3: ff_mma::cp_async_wait<3>(); break;
    case 4: ff_mma::cp_async_wait<4>(); break;
    case 5: ff_mma::cp_async_wait<5>(); break;
    case 6: ff_mma::cp_async_wait<6>(); break;
    default: ff_mma::cp_async_wait<7>(); break;
  }
}

// Stage rows [r0, r0 + ROWS) and columns [c0, c0 + ncols) of a (rows, d)
// matrix into columns [0, ncols) of a [ROWS][LD] tile, by the THREADS
// threads of a group (tid its index in the group); ncols <= COLS, a
// multiple of 16. Rows past `rows` and columns past d are zero. `vec` takes
// 16-byte cp.async copies, zero-filled past the ends; otherwise the same
// tile is written element by element, visible after the group's next
// barrier.
template <typename T, int ROWS, int COLS, int LD, int THREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int r0, int rows,
                                          int c0, int ncols, int d, bool vec, int tid) {
  constexpr int V = Pad<T>::kVec;
  if (vec) {
    constexpr int CH = COLS / V;  // 16-byte copies a row
    for (int i = tid; i < ROWS * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * V;
      if (c >= ncols) continue;
      const bool live = r0 + r < rows && c0 + c < d;
      ff_mma::cp_async_16(dst + r * LD + c, live ? src + (size_t)(r0 + r) * d + c0 + c : src,
                          live ? 16 : 0);
    }
  } else {
    for (int i = tid; i < ROWS * COLS; i += THREADS) {
      const int r = i / COLS, c = i % COLS;
      if (c >= ncols) continue;
      dst[r * LD + c] = (r0 + r < rows && c0 + c < d) ? src[(size_t)(r0 + r) * d + c0 + c]
                                                       : ff_flash::from_f32<T>(0.f);
    }
  }
}

// Columns [lo, lo + cols) of D over which group g of G sums its partial
// products: D cut into G slices of ceil(d / 16 G) * 16 columns, the last
// group taking what is left; cols rounded up to 16 (zero past d).
__device__ __forceinline__ void group_slice(int d, int G, int g, int& lo, int& cols) {
  const int slice = (d + 16 * G - 1) / (16 * G) * 16;
  lo = g * slice;
  cols = (max(0, min(d - lo, slice)) + 15) / 16 * 16;
}

__device__ __forceinline__ void store_pair(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}
__device__ __forceinline__ void store_pair(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}

}  // namespace ff_wide
