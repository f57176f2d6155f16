// Tensor-core building blocks for the bf16 flash-attention kernels on
// Hopper (sm_90a): `cp.async` copies into padded shared-memory tiles,
// `ldmatrix` fragment loads and the warp-level bf16 product
// `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`.
//
// Fragments of m16n8k16 (lane = 4 * group + tig, group 0..7, tig 0..3):
//   A (16 x 16, row-major)  a0 = (group,     2 tig + {0,1})
//                           a1 = (group + 8, 2 tig + {0,1})
//                           a2 = (group,     2 tig + 8 + {0,1})
//                           a3 = (group + 8, 2 tig + 8 + {0,1})
//   B (16 x 8, k x n)       b0 = (k = 2 tig + {0,1},     n = group)
//                           b1 = (k = 2 tig + 8 + {0,1}, n = group)
//   C (16 x 8, f32)         c0, c1 = (group, 2 tig + {0,1}); c2, c3 = (group + 8, ...)
// So the accumulators of two neighbouring n8 tiles are, packed to bf16, the
// A fragment of one k16 step (acc_a2 below): a product's result feeds the
// next product from registers, without a trip through shared memory.
//
// Tiles. A staged tile is [ROWS][DP + 8] bf16: the 16-byte pad per row puts
// the eight 16-byte rows an `ldmatrix` reads in eight different groups of
// four banks (row stride 2 DP + 16 bytes), so fragment loads are free of
// bank conflicts at every padded width. Columns d..DP-1 and rows past the
// end are zero, as in flash_attention_common.cuh.

#pragma once

#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace ff_mma {

using bf16 = __nv_bfloat16;

// Padded row stride of a staged tile of width DP, in elements.
template <int DP>
constexpr int kTileLd = DP + 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 reads nothing and writes zeros.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared; src_bytes 0 writes a zero.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// register i receives matrix i (row group, columns 2 tig, 2 tig + 1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// The same, each matrix transposed: register i receives matrix i's
// (rows 2 tig, 2 tig + 1; column group).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a * b on the tensor cores, bf16 operands, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Lane offsets of the address an ldmatrix_x4 lane gives, for a 16 x 16
// block at (row0, col0) of a tile:
//  * A operand (row-major 16 x 16): matrices (rows 0-7 | 8-15) x (cols 0-7 | 8-15)
//    in the order a0..a3: row lane % 16, column 8 (lane / 16).
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) << 3; }
//  * B operand from a tile whose rows are n and columns k (non-transposed
//    load), two n8 tiles: matrices (n 0-7, k 0-7), (n 0-7, k 8-15),
//    (n 8-15, k 0-7), (n 8-15, k 8-15) = b0, b1 of n tile 0, b0, b1 of n tile 1.
__device__ __forceinline__ int bn_row(int lane) { return ((lane >> 4) << 3) + (lane & 7); }
__device__ __forceinline__ int bn_col(int lane) { return ((lane >> 3) & 1) << 3; }
//  * B operand from a tile whose rows are k and columns n (transposed
//    load), two n8 tiles: matrices (k 0-7, n 0-7), (k 8-15, n 0-7),
//    (k 0-7, n 8-15), (k 8-15, n 8-15) = b0, b1 of n tile 0, b0, b1 of n tile 1.
__device__ __forceinline__ int bk_row(int lane) { return (((lane >> 3) & 1) << 3) + (lane & 7); }
__device__ __forceinline__ int bk_col(int lane) { return (lane >> 4) << 3; }

// Accumulators of n8 tiles 2j and 2j + 1 as the bf16 A fragment of k16 step j.
__device__ __forceinline__ void acc_a2(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Stage rows [r0, r0 + ROWS) of a (rows, d) bf16 matrix into a [ROWS][LD]
// tile; rows past `rows` and columns past d are zero. `vec` (d % 8 == 0 and a
// 16-byte aligned base) takes 16-byte cp.async copies, zero-filled past the
// ends (src-size 0), to be waited for with cp_async_wait; otherwise the same
// tile is written element by element, visible after the next barrier.
template <int ROWS, int DP, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int r0,
                                          int rows, int d, bool vec) {
  constexpr int LD = kTileLd<DP>;
  if (vec) {
    constexpr int CH = DP / 8;  // 16-byte chunks a row
    for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool live = r0 + r < rows && c < d;
      cp_async_16(dst + r * LD + c, live ? src + (size_t)(r0 + r) * d + c : src,
                  live ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += THREADS) {
      const int r = i / DP, c = i % DP;
      dst[r * LD + c] = (r0 + r < rows && c < d) ? src[(size_t)(r0 + r) * d + c]
                                                 : __float2bfloat16(0.f);
    }
  }
}

// n f32 values [i0, i0 + n) of a vector of `len` into shared memory, zero past len.
template <int THREADS>
__device__ __forceinline__ void load_vec(float* dst, const float* __restrict__ src, int i0,
                                         int n, int len) {
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const bool live = i0 + i < len;
    cp_async_4(dst + i, live ? src + i0 + i : src, live ? 4 : 0);
  }
}

// Write a warp's 16 x (8 NT) accumulators, times `mul`, as bf16 into rows
// row0.. and columns col0.. of a staged tile.
template <int DP, int NT>
__device__ __forceinline__ void stage_acc(bf16* tile, const float (&acc)[NT][4], int row0,
                                          int col0, float mul) {
  constexpr int LD = kTileLd<DP>;
  const int lane = threadIdx.x & 31, group = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = col0 + nt * 8 + 2 * tig;
    *reinterpret_cast<__nv_bfloat162*>(tile + (row0 + group) * LD + c) =
        __floats2bfloat162_rn(acc[nt][0] * mul, acc[nt][1] * mul);
    *reinterpret_cast<__nv_bfloat162*>(tile + (row0 + group + 8) * LD + c) =
        __floats2bfloat162_rn(acc[nt][2] * mul, acc[nt][3] * mul);
  }
}

// Write rows [r0, r0 + ROWS) of a staged tile to a (rows, d) bf16 matrix:
// 16-byte stores under `vec`, else element by element; nothing past the ends.
template <int ROWS, int DP, int THREADS>
__device__ __forceinline__ void store_tile(bf16* __restrict__ dst, const bf16* src, int r0,
                                           int rows, int d, bool vec) {
  constexpr int LD = kTileLd<DP>;
  if (vec) {
    constexpr int CH = DP / 8;
    for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      if (r0 + r < rows && c < d)
        *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * d + c) =
            *reinterpret_cast<const uint4*>(src + r * LD + c);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += THREADS) {
      const int r = i / DP, c = i % DP;
      if (r0 + r < rows && c < d) dst[(size_t)(r0 + r) * d + c] = src[r * LD + c];
    }
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace ff_mma
