// Tensor-core building blocks for the f32 flash-attention kernels on Hopper
// (sm_90a): f32 products on the TF32 tensor cores, split so that they keep
// f32 accuracy, with the f32 tiles in padded shared memory.
//
// Split TF32 ("3xTF32"). A TF32 operand keeps 10 of f32's 23 mantissa bits,
// about three decimal digits: one TF32 product per f32 product breaks the
// f32 contract. Each f32 operand x is split once into two TF32 values,
//   big = rna(x),  small = x - big (exact in f32),
// where rna rounds to TF32, to nearest with ties away from zero, as
// cvt.rna.tf32.f32 does (to_tf32 below), and small is handed to the tensor
// core as it is: an mma reads the top 19 bits of a TF32 operand, so small
// is truncated to TF32 there. A product a b becomes three products on the
// tensor cores, summed in f32 in this order:
//   small(a) big(b) + big(a) small(b) + big(a) big(b).
// The dropped small(a) small(b) term and small's truncation are about
// 2^-21 of |a b|, so the result lands within a few f32 ulps of an f32 sum:
// tests/test_torch_flash_attention_bwd.py holds a CPU model of this
// arithmetic against the JAX kernels within the card's f32 tolerance (1e-4
// of the largest gradient), and shows that a single TF32 product does not
// stay within it.
//
// Fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32
// (lane = 4 * group + tig, group 0..7, tig 0..3; one 32-bit value each):
//   A (16 x 8, row-major)  a0 = (group, tig)      a1 = (group + 8, tig)
//                          a2 = (group, tig + 4)  a3 = (group + 8, tig + 4)
//   B (8 x 8, k x n)       b0 = (k = tig, n = group)  b1 = (k = tig + 4, n = group)
//   C (16 x 8, f32)        c0, c1 = (group, 2 tig + {0,1}); c2, c3 = (group + 8, ...)
// An accumulator holds columns (2 tig, 2 tig + 1) where an A fragment wants
// k-columns (tig, tig + 4). A dot product does not care how its k index is
// labelled, so an n8 accumulator tile becomes the A fragment of one k8 step
// by relabelling: k-slot tig is column 2 tig and k-slot tig + 4 is column
// 2 tig + 1 (acc_a below), and the B operand of that step is read at the
// matching rows, 2 tig and 2 tig + 1 of the 8-row chunk (frag_b_krows). A
// product's result then feeds the next product from registers.
//
// Tiles. A staged tile is [ROWS][DP + 4] f32. With a row stride of 4 banks
// mod 32, the reads of an A fragment or of an n-major B fragment (bank
// 4 group + tig) and of a k-major B fragment at rows 2 tig, 2 tig + 1
// (bank 8 tig + group, + 4) hit 32 different banks: no conflicts. Columns
// d..DP-1 and rows past the end are zero, as in flash_attention_common.cuh.

#pragma once

#include <stddef.h>
#include <stdint.h>

#include "flash_attention_mma.cuh"

namespace ff_tf32 {

// Padded row stride of a staged f32 tile of width DP, in floats.
template <int DP>
constexpr int kTileLd = DP + 4;

// x rounded to TF32, to nearest with ties away from zero (the rounding of
// cvt.rna.tf32.f32), on the bits: adding half a TF32 ulp (0x1000) carries
// into the exponent where rounding up crosses a power of two, and the mask
// drops the 13 mantissa bits TF32 does not keep. A finite x rounds exactly
// as cvt.rna rounds it; +-inf stays +-inf.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small: big a TF32 value, small = x - big in f32, which the
// tensor core truncates to TF32 as it reads it. Three instructions. A NaN
// x (whose big the carry may wrap to -0) gives a NaN small, and +-inf a NaN
// small, so either reaches the products, as cvt.rna's NaN would. Measured
// on the H100 at the slice shape (dq + dkv): both halves by cvt.rna, which
// compiles to about eight instructions with its NaN and infinity cases,
// 0.351 + 0.455 ms; both by to_tf32 with a select that keeps a NaN's bits,
// 0.336 + 0.418 ms and a 56-byte spill at width 64; this, 0.271 + 0.328
// ms with no spill at any width.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// A split operand fragment: the big and the small halves.
template <int N>
struct Split {
  uint32_t big[N], small[N];
};

// d += a b, one TF32 product with f32 accumulation.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in f32 accuracy: three TF32 products, small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const Split<4>& a, const Split<2>& b) {
  mma(d, a.small, b.big[0], b.big[1]);
  mma(d, a.big, b.small[0], b.small[1]);
  mma(d, a.big, b.big[0], b.big[1]);
}

// The A fragment of rows [row0, row0 + 16) and columns [col0, col0 + 8) of
// a staged tile, split.
template <int LD>
__device__ __forceinline__ Split<4> frag_a(const float* tile, int row0, int col0) {
  const int lane = threadIdx.x & 31, group = lane >> 2, tig = lane & 3;
  const float* p = tile + (row0 + group) * LD + col0 + tig;
  Split<4> f;
  split(p[0], f.big[0], f.small[0]);
  split(p[8 * LD], f.big[1], f.small[1]);
  split(p[4], f.big[2], f.small[2]);
  split(p[8 * LD + 4], f.big[3], f.small[3]);
  return f;
}

// The B fragment of a tile whose rows are n and columns k: n rows
// [n0, n0 + 8), k columns [k0, k0 + 8), split.
template <int LD>
__device__ __forceinline__ Split<2> frag_b_nrows(const float* tile, int n0, int k0) {
  const int lane = threadIdx.x & 31, group = lane >> 2, tig = lane & 3;
  const float* p = tile + (n0 + group) * LD + k0 + tig;
  Split<2> f;
  split(p[0], f.big[0], f.small[0]);
  split(p[4], f.big[1], f.small[1]);
  return f;
}

// The B fragment of a tile whose rows are k and columns n, for an A
// fragment made by acc_a: k rows [k0, k0 + 8) in the relabelled order
// (k-slot tig is row 2 tig, k-slot tig + 4 is row 2 tig + 1), n columns
// [n0, n0 + 8), split.
template <int LD>
__device__ __forceinline__ Split<2> frag_b_krows(const float* tile, int k0, int n0) {
  const int lane = threadIdx.x & 31, group = lane >> 2, tig = lane & 3;
  const float* p = tile + (k0 + 2 * tig) * LD + n0 + group;
  Split<2> f;
  split(p[0], f.big[0], f.small[0]);
  split(p[LD], f.big[1], f.small[1]);
  return f;
}

// The A fragment of a tile that was split as it was staged (split_tile):
// big's bits in `big`, small's in `small`, at the same offsets. Two 32-bit
// loads for each value in place of one load and the split's three
// instructions.
template <int LD>
__device__ __forceinline__ Split<4> frag_a(const float* big, const float* small, int row0,
                                           int col0) {
  const int lane = threadIdx.x & 31, group = lane >> 2, tig = lane & 3;
  const int i = (row0 + group) * LD + col0 + tig;
  const int off[4] = {0, 8 * LD, 4, 8 * LD + 4};
  Split<4> f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    f.big[r] = __float_as_uint(big[i + off[r]]);
    f.small[r] = __float_as_uint(small[i + off[r]]);
  }
  return f;
}

// An n8 accumulator tile as the split A fragment of one k8 step, relabelled
// (see the top of this file): a0 = c0, a1 = c2, a2 = c1, a3 = c3.
__device__ __forceinline__ Split<4> acc_a(const float (&c)[4]) {
  Split<4> f;
  split(c[0], f.big[0], f.small[0]);
  split(c[2], f.big[1], f.small[1]);
  split(c[1], f.big[2], f.small[2]);
  split(c[3], f.big[3], f.small[3]);
  return f;
}

// Stage rows [r0, r0 + ROWS) of a (rows, d) f32 matrix into a [ROWS][LD]
// tile; rows past `rows` and columns past d are zero. `vec` (d % 4 == 0 and
// a 16-byte aligned base) takes 16-byte cp.async copies, zero-filled past
// the ends (src-size 0), to be waited for with cp_async_wait; otherwise the
// same tile is written element by element, visible after the next barrier.
template <int ROWS, int DP, int THREADS>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int r0,
                                          int rows, int d, bool vec) {
  constexpr int LD = kTileLd<DP>;
  if (vec) {
    constexpr int CH = DP / 4;  // 16-byte chunks a row
    for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 4;
      const bool live = r0 + r < rows && c < d;
      ff_mma::cp_async_16(dst + r * LD + c, live ? src + (size_t)(r0 + r) * d + c : src,
                          live ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += THREADS) {
      const int r = i / DP, c = i % DP;
      dst[r * LD + c] = (r0 + r < rows && c < d) ? src[(size_t)(r0 + r) * d + c] : 0.f;
    }
  }
}

// Split, times `mul`, the elements of a staged [ROWS][LD] tile that this
// thread staged (load_tile's walk over chunks under `vec`, else elements),
// once its own copies have landed (cp_async_wait): big in place of x, small
// into the same offsets of `small`. A thread reads only what it copied, so
// no barrier is needed before; one is needed before other warps read.
template <int ROWS, int DP, int THREADS>
__device__ __forceinline__ void split_tile(float* tile, float* small, float mul, bool vec) {
  constexpr int LD = kTileLd<DP>;
  if (vec) {
    constexpr int CH = DP / 4;
    for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
      const int o = (i / CH) * LD + (i % CH) * 4;
      float4 x = *reinterpret_cast<const float4*>(tile + o);
      uint4 b, s;
      split(x.x * mul, b.x, s.x);
      split(x.y * mul, b.y, s.y);
      split(x.z * mul, b.z, s.z);
      split(x.w * mul, b.w, s.w);
      *reinterpret_cast<uint4*>(tile + o) = b;
      *reinterpret_cast<uint4*>(small + o) = s;
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += THREADS) {
      const int o = (i / DP) * LD + i % DP;
      uint32_t b, s;
      split(tile[o] * mul, b, s);
      tile[o] = __uint_as_float(b);
      small[o] = __uint_as_float(s);
    }
  }
}

// Write a warp's 16 x (8 NT) accumulators, times `mul`, into rows row0..
// and columns col0.. of a staged tile.
template <int DP, int NT>
__device__ __forceinline__ void stage_acc(float* tile, const float (&acc)[NT][4], int row0,
                                          int col0, float mul) {
  constexpr int LD = kTileLd<DP>;
  const int lane = threadIdx.x & 31, group = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = col0 + nt * 8 + 2 * tig;
    *reinterpret_cast<float2*>(tile + (row0 + group) * LD + c) =
        make_float2(acc[nt][0] * mul, acc[nt][1] * mul);
    *reinterpret_cast<float2*>(tile + (row0 + group + 8) * LD + c) =
        make_float2(acc[nt][2] * mul, acc[nt][3] * mul);
  }
}

// Write rows [r0, r0 + ROWS) of a staged tile to a (rows, d) f32 matrix:
// 16-byte stores under `vec`, else element by element; nothing past the ends.
template <int ROWS, int DP, int THREADS>
__device__ __forceinline__ void store_tile(float* __restrict__ dst, const float* src, int r0,
                                           int rows, int d, bool vec) {
  constexpr int LD = kTileLd<DP>;
  if (vec) {
    constexpr int CH = DP / 4;
    for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 4;
      if (r0 + r < rows && c < d)
        *reinterpret_cast<float4*>(dst + (size_t)(r0 + r) * d + c) =
            *reinterpret_cast<const float4*>(src + r * LD + c);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += THREADS) {
      const int r = i / DP, c = i % DP;
      if (r0 + r < rows && c < d) dst[(size_t)(r0 + r) * d + c] = src[r * LD + c];
    }
  }
}

}  // namespace ff_tf32
