// Helpers shared by the flash-attention kernels: element conversion, the
// padded head-dim dispatch of the one-pass kernels and the grid fold.
//
// Head dims. A kernel is instantiated for a padded width DP of 32, 64, 128
// or 256 and takes any head dim d <= DP at run time: columns d..DP-1 of every
// staged tile are zero, so they add exactly 0 to each dot product, and they
// are never written back. Rows of the tensors in device memory have stride d.
//
// Grid. Blocks are numbered along x only, (b*h) * tiles + tile, so any B*H
// runs (the y dimension would stop at 65535).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>

namespace ff_flash {

constexpr int kMaxHeadDim = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Smallest padded width that holds d, or 0 when d is out of range.
inline int padded_head_dim(int d) {
  if (d <= 0 || d > kMaxHeadDim) return 0;
  if (d <= 32) return 32;
  if (d <= 64) return 64;
  if (d <= 128) return 128;
  return 256;
}

// Blocks of a grid of bh * ceil(s / tile) along x; 0 when it does not fit.
inline unsigned grid_blocks(int bh, int s, int tile) {
  const long long n = (long long)bh * ((s + tile - 1) / tile);
  return n > INT_MAX ? 0u : (unsigned)n;
}

}  // namespace ff_flash
