// Flash-attention backward for head dims above 256 on NVIDIA Hopper
// (sm_90a), on the tensor cores in both dtypes.
//
// Replaces, for D > 256, the TPU kernels `_dq_kernel` and `_dkv_kernel`
// (flexflow_tpu/kernels/flash_attention.py:59 and :79, launched by
// `_flash_bwd` at :369 and :380), as flash_attention_bwd.cu does up to
// D = 256. With S = scale Q K^T under the top-left -1e30 causal mask and the
// forward's lse:
//   P = exp(S - lse)    dP = dO V^T    delta = rowsum(dO * O)
//   dS = P * (dP - delta)
//   dQ = (dS K) scale              (ff_flash_attention_bwd_dq_wide)
//   dV = P^T dO, dK = dS^T Q scale (ff_flash_attention_bwd_dkv_wide)
// Inputs q, o, g (BH, Sq, D) and k, v (BH, Skv, D) in f32 or bf16, lse
// (BH, 1, Sq) f32, all contiguous; the gradients in the input type. Any
// D >= 1, any B*H, any lengths. As in the one-pass pair, the dq kernel
// computes delta once per query row, over all of D, in f32 from O as
// stored, and writes it to a (BH, Sq) f32 buffer; the dkv kernel, launched
// after it on the same stream, reads it and never reads O.
//
// Four kernels on one design: `flash_bwd_{dq,dkv}_kernel_wide_mma` (bf16
// `mma.sync` m16n8k16, flash_attention_mma.cuh; P and dS rounded to bf16
// before the second products, as the one-pass bf16 kernels do) and
// `flash_bwd_{dq,dkv}_kernel_wide_tf32x3` (f32 as split TF32: three TF32
// `mma.sync` m16n8k8 products for each f32 product, flash_attention_tf32.cuh;
// never one TF32 product).
//
// Why kernels of their own. A warp owns 16 rows of its kernel's output:
// dQ takes W / 2 f32 registers a thread for W columns, dK and dV together
// W. The one-pass kernels keep the whole row and stop at D 256 (dq: 128
// accumulators; dkv: two warps to 16 key rows, 128 each). Past it the head
// dim is cut two ways, as in flash_attention_fwd_wide.cu:
//
//  * The output columns. A block holds G groups of STRIPS warps over the
//    same R = 16 STRIPS rows (one 16-row strip a warp); group g owns W
//    output columns, [c0 + g W, c0 + (g + 1) W). The dq kernel runs G = 2
//    groups of 4 strips (64 query rows) with W = 144, 192 or 256, the
//    least that covers half of D. The dkv kernel has two designs, both
//    built and timed: (b) G = 2 groups of 4 strips (64 key rows) with W =
//    144, up to 288 columns; (a) G = 4 groups of 2 strips (32 key rows)
//    with W = 80 or 128, so that dK and dV stay at 128 registers a thread
//    at D 512. (b) is about 1.5x faster at D 264; (a) 1.5-1.6x faster at
//    D 512, where (b) needs two column chunks (PERF.md). Past G times the widest
//    W the grid also cuts D into column chunks, one block each (c0 = chunk
//    G W); every chunk computes S and dP again.
//  * The reductions over D. Every group needs all of S and dP for its rows
//    (S^T and dP^T in dkv). Group g sums them over its own slice of D (dq:
//    D / G rounded up to 16 columns, ff_wide::group_slice; dkv: its own
//    output columns, the balanced slice past one chunk); the G warps of a
//    strip swap the two partials (2 x 16 x BT f32 a warp) through shared
//    memory behind a named barrier of their 32 G threads and each sums them
//    in one order, group 0 first (with two groups, own + other: the same
//    sum), so every group holds the same P and dS bit for bit. The swap is
//    double buffered by tile where shared memory allows (one barrier a
//    tile), else a second barrier frees it.
//
// Loads. Each group streams its own tiles through a ring of NST slots by
// 16-byte cp.async, zero-filled past the ends, and syncs on a named barrier
// of its own threads. Per streamed tile (dq: BK keys; dkv: BQ queries):
// first the slice's chunks of KC columns for S and dP (dq: K and V; dkv: Q
// and dO, and in the last chunk's slot that tile's lse and delta), then
// those of the group's W output columns (dq: K, 2 KC columns a slot). The
// block's own rows' tensors for S and dP (dq: Q and dO; dkv: K and V) stay
// resident in shared memory over the group's slice where they fit (bf16
// dq, bf16 dkv up to 512 columns, f32 dkv design b), else they stream with
// the chunk they meet. With K and V resident the dkv kernel's slice is its
// output columns, so its ring holds a query tile's chunks and one more
// (W / KC + 1 slots): each chunk of Q and dO is loaded once and read by
// both products, a slot refilled only after its second use. Where d % 8
// (bf16) or d % 4 (f32) != 0 or a base is not 16-byte aligned, the same
// slots are written element by element. Tiles padded by 16 bytes a row
// (conflict-free ldmatrix and fragment reads).
//
// Shared memory at D 512 (one block of 256 threads an SM; DqTiles and
// DkvTiles give the tiles): dq bf16 (Q, dO resident, BK 32, KC 64, 3
// slots, swap single buffered) 218 KB; dq f32 (Q, dO streamed, BK 32, KC
// 32, 2 slots) 172 KB; dkv bf16 (a) (K, V resident, BQ 32, KC 64, 3 slots
// reused) 211 KB; dkv f32 (a) (K, V streamed, BQ 32, KC 32, 2 slots) 210
// KB. dQ takes 128 f32 registers a thread at W 256, dK and dV 128 at W
// 128; the bf16 dkv at W 128 and 144 runs at 255 registers with a
// 104-byte and an 8-byte spill, faster than the query tile of 16 that
// spills nothing. chip_smoke.py prints each instance's registers and stack.
//
// Products. bf16: S and dP by ldmatrix fragments; P and dS rounded to bf16
// and made the second products' A fragments straight from the accumulators
// (acc_a2); the B fragments of K (dq), dO and Q (dkv) by ldmatrix.trans;
// scale on S in f32 (in the exponent) and on dQ and dK at the end. f32: A
// and B fragments split as they are read (frag_a, frag_b_nrows); P and dS
// split into the second products' A fragments through the m16n8k8
// relabelling (acc_a), their B operands read k-major (frag_b_krows).
// Masked p is exactly 0 by a select; P, dP and dS never touch shared
// memory but for the swap.
//
// Both: under causal the dq kernel stops at the last key tile its rows can
// see and the dkv kernel starts at the first query tile that sees its
// keys (a key no query sees gets exactly 0); a strip's warps skip the
// products of a tile that holds only dead entries for the strip (still
// taking part in the group's loads); blocks go bh-major, so that a bh's
// streamed tensors are read from device memory about once; each block owns
// its output tile (no atomics: two runs agree bit for bit).
//
// Bound at B*H = 128, Sq = Skv = 512, D = 512 (H100 SXM, 3.35 TB/s): the
// function's 5 products are 171.8 GFLOP (half under causal); q, k, v, o,
// g, dq, dk, dv are 1074 MB in f32, 537 MB in bf16. bf16 (989 TFLOP/s):
// 0.174 ms of operations vs 0.160 ms of bytes -> 0.174 ms, bound by
// operations; f32 (494.7 TFLOP/s TF32 / 3 for f32-accurate products): 1.042
// ms of operations vs 0.321 ms of bytes -> 1.042 ms. As designed the pair
// does 7 products (S and dP in both kernels), 1.4x the function's. PERF.md
// gives the times against the bound, the plain version and SDPA's
// backward, and the variants timed (tools/torch_bwd_wide_variants.py).
//
// Where it is delicate: the swap's order (every group must sum the
// partials alike, or P and dS differ between the groups that share a row);
// the ring's slots (a tile's lse and delta live in its last S slot, which
// is not refilled before the output products; with reuse a slot is
// refilled only after its second use, and the cp.async groups still in
// flight at each wait are counted from that); ragged ends (rows past the
// lengths are zero-filled and their entries get p = 0 by a select); and
// registers (W is capped so that the accumulators leave room for S, dP and
// the fragments, with at most a small spill).

#include <math.h>

#include <initializer_list>
#include <type_traits>

#include "flash_attention_common.cuh"
#include "flash_attention_mma.cuh"
#include "flash_attention_tf32.cuh"
#include "flash_attention_wide.cuh"

namespace {

using ff_mma::bf16;
using ff_tf32::Split;
using ff_wide::load_tile;
using ff_wide::named_barrier;
using ff_wide::Pad;
using ff_wide::store_pair;

constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on the H100
constexpr int kDqGroups = 2, kDqStrips = 4;
constexpr int kDqMaxW = 256;  // dQ's 128 accumulators a thread
// dkv, design (a): four groups of two strips, dK and dV at most 128
// columns a group; design (b), up to 2 x 144 columns: two groups of four
constexpr int kDkvMaxW = 128, kDkvWideW = 144;

// Tiles of each dtype, chosen among the variants
// tools/torch_bwd_wide_variants.py times on an H100: the streamed tile BT
// (dq: keys; dkv: queries), columns of a staged chunk KC and ring slots a
// group NST, by the group width W and, in dkv, whether K and V are
// resident (RES, and then the ring reuses a tile's chunks).
template <typename T, int W>
struct DqTiles {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kBlock = kF32 && W <= 192 ? 64 : 32, kChunk = kF32 ? 32 : 64,
                       kStages = kF32 ? 2 : 3;
};
template <typename T, int W, bool RES>
struct DkvTiles {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr bool kReuse = RES;  // a tile's Q and dO chunks loaded once
  static constexpr int kBlock = kF32 ? (RES ? 16 : 32) : (RES ? 32 : 16);
  static constexpr int kChunk = kF32 ? (RES ? 48 : 32) : 64;
  static constexpr int kStages = kReuse ? (W + kChunk - 1) / kChunk + 1 : kF32 ? 2 : 3;
};

// The shared memory of a block, in this order: per group a ring of NST
// slots of SLOT elements (in each, the block's rows of its two tensors for
// S and dP unless RES, two BT-row tiles of the streamed ones, and VEC
// elements for a tile's lse and delta); with RES, per group the resident
// slices of the block's two tensors, [2][R][W + pad]; NB swap buffers of
// [G][STRIPS][2][16 x BT] f32; R f32 for the rows' delta (dq).
template <typename T, int G, int STRIPS, int W, int BT, int KC, int NST, bool RES, bool VEC>
struct Layout {
  static constexpr int R = 16 * STRIPS, GT = 32 * STRIPS, THREADS = G * GT;
  static constexpr int LD = KC + Pad<T>::kPad;   // a staged chunk
  static constexpr int LDR = W + Pad<T>::kPad;   // a resident slice
  static constexpr int AROWS = RES ? 0 : R;      // rows of each own tensor in a slot
  static constexpr int NVEC = VEC ? 2 * BT * (int)sizeof(float) / (int)sizeof(T) : 0;
  static constexpr int SLOT = (2 * AROWS + 2 * BT) * LD + NVEC;
  static constexpr size_t kRing = sizeof(T) * (size_t)G * NST * SLOT;
  static constexpr size_t kRes = RES ? sizeof(T) * (size_t)G * 2 * R * LDR : 0;
  static constexpr size_t kSwap = sizeof(float) * (size_t)G * STRIPS * 2 * 16 * BT;
  static constexpr size_t kBase = kRing + kRes + sizeof(float) * R;
  static constexpr int NB = kBase + 2 * kSwap <= kMaxSmem ? 2 : 1;
  static constexpr size_t kBytes = kBase + NB * kSwap;
  static_assert(W % 16 == 0 && BT % 16 == 0 && KC % 16 == 0, "tile shape");
  static_assert(NST >= 2, "a ring of two slots at least");
  static_assert(kBytes <= kMaxSmem, "a block's shared memory");
};

// Swap the calling warp's partial S and dP (N n8 tiles each) with the warps
// of its strip in the other groups through buf ([G][STRIPS][2][N * 32]
// float4) and sum all G partials in group order, group 0 first, into s and
// dp (with two groups, own + other, which is the same sum): every warp of
// the strip ends with the same values, bit for bit.
// `bar` is the strip's named barrier; `free_after` waits again, so that the
// buffer may be written at the next tile.
template <int G, int STRIPS, int N>
__device__ __forceinline__ void swap_sum(float (&s)[N][4], float (&dp)[N][4], float* buf,
                                         int grp, int strip, int bar, bool free_after) {
  const int lane = threadIdx.x & 31;
  float4* mine = reinterpret_cast<float4*>(buf) + (grp * STRIPS + strip) * 2 * N * 32;
#pragma unroll
  for (int nt = 0; nt < N; ++nt) {
    mine[nt * 32 + lane] = make_float4(s[nt][0], s[nt][1], s[nt][2], s[nt][3]);
    mine[(N + nt) * 32 + lane] = make_float4(dp[nt][0], dp[nt][1], dp[nt][2], dp[nt][3]);
  }
  named_barrier(bar, 32 * G);
  if constexpr (G == 2) {
    // a + b == b + a exactly: each adds the other group's partial to its own
    const float4* part =
        reinterpret_cast<const float4*>(buf) + ((1 - grp) * STRIPS + strip) * 2 * N * 32;
#pragma unroll
    for (int nt = 0; nt < N; ++nt) {
      const float4 x = part[nt * 32 + lane], y = part[(N + nt) * 32 + lane];
      s[nt][0] += x.x, s[nt][1] += x.y, s[nt][2] += x.z, s[nt][3] += x.w;
      dp[nt][0] += y.x, dp[nt][1] += y.y, dp[nt][2] += y.z, dp[nt][3] += y.w;
    }
    if (free_after) named_barrier(bar, 32 * G);
    return;
  }
#pragma unroll
  for (int g2 = 0; g2 < G; ++g2) {
    const float4* part = reinterpret_cast<const float4*>(buf) + (g2 * STRIPS + strip) * 2 * N * 32;
#pragma unroll
    for (int nt = 0; nt < N; ++nt) {
      const float4 x = part[nt * 32 + lane], y = part[(N + nt) * 32 + lane];
      if (g2 == 0) {
        s[nt][0] = x.x, s[nt][1] = x.y, s[nt][2] = x.z, s[nt][3] = x.w;
        dp[nt][0] = y.x, dp[nt][1] = y.y, dp[nt][2] = y.z, dp[nt][3] = y.w;
      } else {
        s[nt][0] += x.x, s[nt][1] += x.y, s[nt][2] += x.z, s[nt][3] += x.w;
        dp[nt][0] += y.x, dp[nt][1] += y.y, dp[nt][2] += y.z, dp[nt][3] += y.w;
      }
    }
  }
  if (free_after) named_barrier(bar, 32 * G);
}

// A lane's part of the dot product of two rows of d elements in device
// memory, in f32: 16-byte loads under `vec`, else one element at a time.
__device__ __forceinline__ float row_dot(const bf16* a, const bf16* b, int d, bool vec,
                                         int lane) {
  float sum = 0.f;
  if (vec) {
    for (int c = lane * 8; c < d; c += 32 * 8) {
      const uint4 x = *reinterpret_cast<const uint4*>(a + c);
      const uint4 y = *reinterpret_cast<const uint4*>(b + c);
      const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* ya = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 fx = __bfloat1622float2(xa[i]), fy = __bfloat1622float2(ya[i]);
        sum = fmaf(fx.x, fy.x, fmaf(fx.y, fy.y, sum));
      }
    }
  } else {
    for (int c = lane; c < d; c += 32)
      sum = fmaf(__bfloat162float(a[c]), __bfloat162float(b[c]), sum);
  }
  return sum;
}
__device__ __forceinline__ float row_dot(const float* a, const float* b, int d, bool vec,
                                         int lane) {
  float sum = 0.f;
  if (vec) {
    for (int c = lane * 4; c < d; c += 32 * 4) {
      const float4 x = *reinterpret_cast<const float4*>(a + c);
      const float4 y = *reinterpret_cast<const float4*>(b + c);
      sum = fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, fmaf(x.w, y.w, sum))));
    }
  } else {
    for (int c = lane; c < d; c += 32) sum = fmaf(a[c], b[c], sum);
  }
  return sum;
}

// Write a warp's 16 x W accumulators, times `mul`, to rows row_lo and
// row_lo + 8 and columns c0.. of a (rows, d) matrix: a thread's two
// neighbouring columns in one store under `vec` (d a multiple of the
// 16-byte copy, so a pair never straddles d), else one at a time; nothing
// past the ends.
template <typename T, int ND>
__device__ __forceinline__ void store_acc(T* __restrict__ out, const float (&acc)[ND][4],
                                          int row_lo, int rows, int c0, int d, float mul,
                                          bool vec) {
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + 8 * h;
    if (row >= rows) continue;
    T* orow = out + (size_t)row * d;
#pragma unroll
    for (int dt = 0; dt < ND; ++dt) {
      const int c = c0 + dt * 8 + 2 * tig;
      const float x0 = acc[dt][2 * h] * mul, x1 = acc[dt][2 * h + 1] * mul;
      if (vec) {
        if (c < d) store_pair(orow + c, x0, x1);
      } else {
        if (c < d) orow[c] = ff_flash::from_f32<T>(x0);
        if (c + 1 < d) orow[c + 1] = ff_flash::from_f32<T>(x1);
      }
    }
  }
}

// One mma-deep step kk of the partial S = A B^T and dP = A2 B2^T of a
// warp's 16 rows (A, A2 staged with row stride LDA, rows from rw) against
// the BT rows of B, B2 (row stride LD).
template <typename T, int LDA, int LD, int BT>
__device__ __forceinline__ void sdp_step(float (&s)[BT / 8][4], float (&dp)[BT / 8][4],
                                         const T* a, const T* a2, const T* b, const T* b2,
                                         int rw, int kk) {
  const int lane = threadIdx.x & 31;
  if constexpr (std::is_same<T, float>::value) {
    const Split<4> x = ff_tf32::frag_a<LDA>(a, rw, kk * 8);
    const Split<4> x2 = ff_tf32::frag_a<LDA>(a2, rw, kk * 8);
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt) {
      ff_tf32::mma3(s[nt], x, ff_tf32::frag_b_nrows<LD>(b, nt * 8, kk * 8));
      ff_tf32::mma3(dp[nt], x2, ff_tf32::frag_b_nrows<LD>(b2, nt * 8, kk * 8));
    }
  } else {
    uint32_t x[4], x2[4];
    const int a_off = (rw + ff_mma::a_row(lane)) * LDA + kk * 16 + ff_mma::a_col(lane);
    ff_mma::ldmatrix_x4(x, a + a_off);
    ff_mma::ldmatrix_x4(x2, a2 + a_off);
#pragma unroll
    for (int n2 = 0; n2 < BT / 16; ++n2) {
      uint32_t y[4], y2[4];
      const int b_off = (n2 * 16 + ff_mma::bn_row(lane)) * LD + kk * 16 + ff_mma::bn_col(lane);
      ff_mma::ldmatrix_x4(y, b + b_off);
      ff_mma::ldmatrix_x4(y2, b2 + b_off);
      ff_mma::mma_bf16(s[2 * n2], x, y[0], y[1]);
      ff_mma::mma_bf16(s[2 * n2 + 1], x, y[2], y[3]);
      ff_mma::mma_bf16(dp[2 * n2], x2, y2[0], y2[1]);
      ff_mma::mma_bf16(dp[2 * n2 + 1], x2, y2[2], y2[3]);
    }
  }
}

// The partial S and dP over one staged chunk of `cols` columns (a multiple
// of 16): a full chunk unrolled without a branch between its steps, so that
// the fragment loads of one step overlap the products of the last.
template <typename T, int LDA, int LD, int BT, int KC>
__device__ __forceinline__ void sdp_chunk(float (&s)[BT / 8][4], float (&dp)[BT / 8][4],
                                          const T* a, const T* a2, const T* b, const T* b2,
                                          int rw, int cols) {
  constexpr int KSTEP = std::is_same<T, float>::value ? 8 : 16;
  if (cols >= KC) {
#pragma unroll
    for (int kk = 0; kk < KC / KSTEP; ++kk) sdp_step<T, LDA, LD, BT>(s, dp, a, a2, b, b2, rw, kk);
  } else {
    for (int kk = 0; kk < cols / KSTEP; ++kk)
      sdp_step<T, LDA, LD, BT>(s, dp, a, a2, b, b2, rw, kk);
  }
}

// dQ scale for query rows [q0, q0 + 16 STRIPS) of one bh and output
// columns [c0 + g W, c0 + (g + 1) W) of group g (see the top of this file);
// chunk 0 also writes the rows' delta.
template <typename T, int STRIPS, int W, int BK, int KC, int NST, bool RES>
__device__ __forceinline__ void dq_wide(const T* __restrict__ q, const T* __restrict__ k,
                                        const T* __restrict__ v, const T* __restrict__ o,
                                        const T* __restrict__ g, const float* __restrict__ lse,
                                        float* __restrict__ delta, T* __restrict__ dq, int sq,
                                        int skv, int d, float scale, int causal, int vec,
                                        int nchunk, unsigned char* smem) {
  using L = Layout<T, kDqGroups, STRIPS, W, BK, KC, NST, RES, false>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int G = kDqGroups, R = L::R, GT = L::GT, LD = L::LD, SLOT = L::SLOT;
  constexpr int LDA = RES ? L::LDR : LD;  // Q and dO as the products read them
  constexpr int KROW = 2 * L::AROWS;      // K's first row in an S slot, V's KROW + BK
  constexpr int NK = BK / 8, ND = W / 8;  // n8 tiles of S / dP and of the group's dQ
  constexpr int NO = (W + 2 * KC - 1) / (2 * KC);  // output slots a key tile
  static_assert(W <= kDqMaxW, "dQ's accumulators");

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / STRIPS, strip = warp % STRIPS, tid = threadIdx.x % GT;
  const int group = lane >> 2, tig = lane & 3, rw = strip * 16;
  T* ring = reinterpret_cast<T*>(smem) + grp * NST * SLOT;
  T* res = reinterpret_cast<T*>(smem + L::kRing) + grp * 2 * R * L::LDR;
  float* xs = reinterpret_cast<float*>(smem + L::kRing + L::kRes);
  float* dls = xs + L::NB * L::kSwap / sizeof(float);

  // blocks go bh-major; within a bh the last query tiles, which carry the
  // most causal work, start first; a tile's column chunks side by side
  const int nq = (sq + R - 1) / R;
  const int per_bh = nq * nchunk;
  const int bh = blockIdx.x / per_bh, rest = blockIdx.x % per_bh;
  const int q0 = (nq - 1 - rest / nchunk) * R;
  const int chunk = rest % nchunk;
  const size_t qoff = (size_t)bh * sq * d, koff = (size_t)bh * skv * d;
  const T* qb = q + qoff;
  const T* gb = g + qoff;
  const T* kb = k + koff;
  const T* vb = v + koff;

  int s_lo, s_cols;
  ff_wide::group_slice(d, G, grp, s_lo, s_cols);
  const int n_s = max(1, (s_cols + KC - 1) / KC);  // S slots a key tile
  const int o_lo = (chunk * G + grp) * W;
  const int per_tile = n_s + NO;
  const int kv_end = causal ? min(skv, q0 + R) : skv;
  const int ntiles = (kv_end + BK - 1) / BK;
  const int items = ntiles * per_tile;

  // Item t of the group's stream into slot t % NST: per key tile, its S
  // slots (a chunk of K and of V, under Q's and dO's unless resident),
  // then its output slots (K over 2 KC of the group's columns, KC in each
  // half of the slot); one cp.async group a call, empty past the end.
  auto fetch = [&](int t) {
    if (t < items) {
      T* slot = ring + (t % NST) * SLOT;
      const int k0 = (t / per_tile) * BK, r = t % per_tile;
      if (r < n_s) {
        const int c0 = s_lo + r * KC, nc = min(KC, s_cols - r * KC);
        if constexpr (!RES) {
          load_tile<T, R, KC, LD, GT>(slot, qb, q0, sq, c0, nc, d, vec, tid);
          load_tile<T, R, KC, LD, GT>(slot + R * LD, gb, q0, sq, c0, nc, d, vec, tid);
        }
        load_tile<T, BK, KC, LD, GT>(slot + KROW * LD, kb, k0, skv, c0, nc, d, vec, tid);
        load_tile<T, BK, KC, LD, GT>(slot + (KROW + BK) * LD, vb, k0, skv, c0, nc, d, vec, tid);
      } else {
        const int c = (r - n_s) * 2 * KC;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int nc = min(KC, W - c - h * KC);
          if (nc > 0)
            load_tile<T, BK, KC, LD, GT>(slot + h * BK * LD, kb, k0, skv, o_lo + c + h * KC, nc,
                                         d, vec, tid);
        }
      }
    }
    ff_mma::cp_async_commit();
  };
  // Item t has landed for the whole group; the slot read at item t - 1 is
  // free again and takes item t + NST - 1.
  auto step = [&](int t) -> const T* {
    ff_mma::cp_async_wait<NST - 2>();
    named_barrier(1 + grp, GT);
    fetch(t + NST - 1);
    return ring + (t % NST) * SLOT;
  };

  if constexpr (RES) {  // the group's slices of Q and dO, a cp.async group of their own
    load_tile<T, R, W, L::LDR, GT>(res, qb, q0, sq, s_lo, s_cols, d, vec, tid);
    load_tile<T, R, W, L::LDR, GT>(res + R * L::LDR, gb, q0, sq, s_lo, s_cols, d, vec, tid);
    ff_mma::cp_async_commit();
  }
#pragma unroll
  for (int t = 0; t < NST - 1; ++t) fetch(t);

  // delta = rowsum(dO * O) over all of D for the block's rows, in f32 from
  // O as stored, while the first copies land: a warp a row at a time
  for (int r = warp; r < R; r += L::THREADS / 32) {
    const int row = q0 + r;
    float sum = row < sq ? row_dot(gb + (size_t)row * d, o + qoff + (size_t)row * d, d, vec, lane)
                         : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      dls[r] = sum;
      if (chunk == 0 && row < sq) delta[(size_t)bh * sq + row] = sum;
    }
  }
  __syncthreads();
  const int row_lo = q0 + rw + group, row_hi = row_lo + 8;
  const float lse_lo = row_lo < sq ? lse[(size_t)bh * sq + row_lo] * kLog2e : 0.f;
  const float lse_hi = row_hi < sq ? lse[(size_t)bh * sq + row_hi] * kLog2e : 0.f;
  const float dl_lo = dls[rw + group], dl_hi = dls[rw + group + 8];
  const float scale_log2 = scale * kLog2e;

  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  int t = 0;
  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BK;
    // Under causal, a tile whose first key lies past the strip's last row
    // holds only dead entries for the strip: p = 0 there, so the strip's
    // warps (in every group alike) skip it.
    const bool live = !causal || k0 <= q0 + rw + 15;

    // the partial S = Q K^T and dP = dO V^T over the group's slice of D
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int i = 0; i < NK; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
    for (int i = 0; i < n_s; ++i, ++t) {
      const T* slot = step(t);
      if (!live) continue;
      const T* qs = RES ? res + i * KC : slot;
      const T* gs = RES ? res + R * L::LDR + i * KC : slot + R * LD;
      sdp_chunk<T, LDA, LD, BK, KC>(s, dp, qs, gs, slot + KROW * LD, slot + (KROW + BK) * LD,
                                    rw, s_cols - i * KC);
    }

    // the whole S and dP from every group's partials, then dS = P (dP -
    // delta) in f32 into dp, masked entries exactly 0; bf16: dS as the A
    // fragments of dS K
    uint32_t ads[kF32 ? 1 : BK / 16][4];
    if (live) {
      swap_sum<G, STRIPS, NK>(s, dp, xs + (j % L::NB) * (L::kSwap / sizeof(float)), grp,
                                 strip, 1 + G + strip, L::NB == 1);
#pragma unroll
      for (int nt = 0; nt < NK; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? row_lo : row_hi;
          const int key = k0 + nt * 8 + 2 * tig + (e & 1);
          const bool keep = key < skv && row < sq && !(causal && row < key);
          const float p =
              keep ? exp2f(fmaf(s[nt][e], scale_log2, -(e < 2 ? lse_lo : lse_hi))) : 0.f;
          dp[nt][e] = p * (dp[nt][e] - (e < 2 ? dl_lo : dl_hi));
        }
      if constexpr (!kF32) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) ff_mma::acc_a2(ads[kk], dp[2 * kk], dp[2 * kk + 1]);
      }
    }

    // dQ += dS K over the group's W columns, 2 KC a slot
#pragma unroll
    for (int u = 0; u < NO; ++u, ++t) {
      const T* slot = step(t);
      if (!live) continue;
      if constexpr (kF32) {
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          const Split<4> a = ff_tf32::acc_a(dp[kk]);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int dt = 0; dt < KC / 8; ++dt) {
              const int c = u * 2 * KC + h * KC + dt * 8;
              if (c >= W) break;
              ff_tf32::mma3(acc[c / 8], a,
                            ff_tf32::frag_b_krows<LD>(slot + h * BK * LD, kk * 8, dt * 8));
            }
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
            for (int d2 = 0; d2 < KC / 16; ++d2) {
              const int c = u * 2 * KC + h * KC + d2 * 16;
              if (c >= W) break;
              uint32_t b[4];
              ff_mma::ldmatrix_x4_trans(b, slot + h * BK * LD +
                                               (kk * 16 + ff_mma::bk_row(lane)) * LD + d2 * 16 +
                                               ff_mma::bk_col(lane));
              ff_mma::mma_bf16(acc[c / 8], ads[kk], b[0], b[1]);
              ff_mma::mma_bf16(acc[c / 8 + 1], ads[kk], b[2], b[3]);
            }
      }
    }
  }
  ff_mma::cp_async_wait<0>();
  store_acc<T, ND>(dq + qoff, acc, row_lo, sq, o_lo, d, scale, vec);
}

// dK scale and dV for key rows [k0, k0 + R) of one bh and output columns
// [c0 + g W, c0 + (g + 1) W) of group g, in the transposed orientation (a
// warp's 16 keys are the rows of S^T and dP^T, so P^T and dS^T come out of
// the accumulators as A fragments). With the block's columns in one chunk
// a group's slice of D for S^T and dP^T is its own output columns, so with
// RU (reuse) a query tile's chunks of Q and dO stay in the ring, NST = W /
// KC + 1 slots, from the products of S^T and dP^T to those of dK and dV:
// each is loaded once, and a slot is refilled only after its second use.
template <typename T, int G, int STRIPS, int W, int BQ, int KC, int NST, bool RES, bool RU>
__device__ __forceinline__ void dkv_wide(const T* __restrict__ q, const T* __restrict__ k,
                                         const T* __restrict__ v, const T* __restrict__ g,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta, T* __restrict__ dk,
                                         T* __restrict__ dv, int sq, int skv, int d,
                                         float scale, int causal, int vec, int nchunk,
                                         unsigned char* smem) {
  using L = Layout<T, G, STRIPS, W, BQ, KC, NST, RES, true>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int R = L::R, GT = L::GT, LD = L::LD, SLOT = L::SLOT;
  constexpr int LDA = RES ? L::LDR : LD;  // K and V as the products read them
  constexpr int QROW = 2 * L::AROWS;      // Q's first row in a slot, dO's QROW + BQ
  constexpr int NQ = BQ / 8, ND = W / 8;  // n8 tiles of S^T / dP^T and of dK, dV
  constexpr int NO = (W + KC - 1) / KC;   // output chunks a query tile
  static_assert(W <= kDkvWideW, "dK's and dV's accumulators");
  static_assert(!RU || (RES && NST == NO + 1), "reuse: K and V resident, a slot a chunk + 1");

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / STRIPS, strip = warp % STRIPS, tid = threadIdx.x % GT;
  const int group = lane >> 2, tig = lane & 3, rw = strip * 16;
  T* ring = reinterpret_cast<T*>(smem) + grp * NST * SLOT;
  T* res = reinterpret_cast<T*>(smem + L::kRing) + grp * 2 * R * L::LDR;
  float* xs = reinterpret_cast<float*>(smem + L::kRing + L::kRes);

  // blocks go bh-major; within a bh the first key tiles, which carry the
  // most causal work, start first; a tile's column chunks side by side
  const int nk = (skv + R - 1) / R;
  const int per_bh = nk * nchunk;
  const int bh = blockIdx.x / per_bh, rest = blockIdx.x % per_bh;
  const int k0 = (rest / nchunk) * R;
  const int chunk = rest % nchunk;
  const size_t qoff = (size_t)bh * sq * d, koff = (size_t)bh * skv * d;
  const T* qb = q + qoff;
  const T* gb = g + qoff;
  const T* kb = k + koff;
  const T* vb = v + koff;
  const float* lseb = lse + (size_t)bh * sq;
  const float* deltab = delta + (size_t)bh * sq;

  // the group's slice of D for S^T and dP^T: its output columns when the
  // block's columns are one chunk, else a balanced slice of all of D
  const int o_lo = (chunk * G + grp) * W;
  int s_lo = o_lo, s_cols = (max(0, min(d - o_lo, W)) + 15) / 16 * 16;
  if (nchunk > 1) ff_wide::group_slice(d, G, grp, s_lo, s_cols);
  const int n_s = RU ? NO : max(1, (s_cols + KC - 1) / KC);  // S chunks a query tile
  const int per_tile = RU ? NO : n_s + NO;  // items a query tile
  // under causal, the first query tile that sees a key of the block
  const int qstart = causal ? (k0 / BQ) * BQ : 0;
  const int ntiles = qstart < sq ? (sq - qstart + BQ - 1) / BQ : 0;
  const int items = ntiles * per_tile;

  // Item t of the group's stream into slot t % NST: per query tile, its S
  // chunks (a chunk of Q and of dO, under K's and V's unless resident; the
  // last also takes the tile's lse and delta), then, unless RU, its output
  // chunks (Q and dO over KC of the group's columns).
  auto fetch = [&](int t) {
    if (t < items) {
      T* slot = ring + (t % NST) * SLOT;
      const int q0 = qstart + (t / per_tile) * BQ, r = t % per_tile;
      int c0, nc;
      if (r < n_s) {
        c0 = s_lo + r * KC;
        nc = min(KC, s_cols - r * KC);
        if constexpr (!RES) {
          load_tile<T, R, KC, LD, GT>(slot, kb, k0, skv, c0, nc, d, vec, tid);
          load_tile<T, R, KC, LD, GT>(slot + R * LD, vb, k0, skv, c0, nc, d, vec, tid);
        }
        if (r == n_s - 1) {
          float* vecs = reinterpret_cast<float*>(slot + (QROW + 2 * BQ) * LD);
          for (int i = tid; i < 2 * BQ; i += GT) {
            const int qi = q0 + i % BQ;
            const float* src = (i < BQ ? lseb : deltab) + qi;
            ff_mma::cp_async_4(vecs + i, qi < sq ? src : lseb, qi < sq ? 4 : 0);
          }
        }
      } else {
        c0 = o_lo + (r - n_s) * KC;
        nc = min(KC, W - (r - n_s) * KC);
      }
      load_tile<T, BQ, KC, LD, GT>(slot + QROW * LD, qb, q0, sq, c0, nc, d, vec, tid);
      load_tile<T, BQ, KC, LD, GT>(slot + (QROW + BQ) * LD, gb, q0, sq, c0, nc, d, vec, tid);
    }
    ff_mma::cp_async_commit();
  };
  // Item t has landed for the whole group. Without RU the slot read at
  // item t - 1 is free again and takes item t + NST - 1. With RU the ring
  // runs one tile and a chunk ahead: S chunk i of a tile waits for all but
  // the NO - i items fetched after it, and a slot is refilled (release)
  // after the chunk's output products.
  auto step = [&](int t, int i) -> const T* {
    if constexpr (RU) {
      ff_wide::cp_async_wait_n(NO - i);
    } else {
      ff_mma::cp_async_wait<NST - 2>();
    }
    named_barrier(1 + grp, GT);
    if constexpr (!RU) fetch(t + NST - 1);
    return ring + (t % NST) * SLOT;
  };
  auto release = [&](int t) {
    named_barrier(1 + grp, GT);
    fetch(t + NST);
  };

  if constexpr (RES) {  // the group's slices of K and V, a cp.async group of their own
    load_tile<T, R, W, L::LDR, GT>(res, kb, k0, skv, s_lo, s_cols, d, vec, tid);
    load_tile<T, R, W, L::LDR, GT>(res + R * L::LDR, vb, k0, skv, s_lo, s_cols, d, vec, tid);
  }
  ff_mma::cp_async_commit();  // with no query tile, the wait below still finds it
#pragma unroll
  for (int t = 0; t < (RU ? NST : NST - 1); ++t) fetch(t);

  const int key_lo = k0 + rw + group, key_hi = key_lo + 8;
  const float scale_log2 = scale * kLog2e;
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  int t = 0;
  for (int j = 0; j < ntiles; ++j) {
    const int q0 = qstart + j * BQ;
    // under causal, a tile whose last query lies before the strip's first
    // key holds only dead entries for the strip: skipped alike by its warps
    const bool live = !causal || q0 + BQ - 1 >= k0 + rw;

    // the partial S^T = K Q^T and dP^T = V dO^T over the group's slice of D
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.f;
    const float* vecs = nullptr;
    for (int i = 0; i < n_s; ++i, ++t) {
      const T* slot = step(t, i);
      vecs = reinterpret_cast<const float*>(slot + (QROW + 2 * BQ) * LD);
      if (!live) continue;
      const T* ks = RES ? res + i * KC : slot;
      const T* vs = RES ? res + R * L::LDR + i * KC : slot + R * LD;
      sdp_chunk<T, LDA, LD, BQ, KC>(st, dpt, ks, vs, slot + QROW * LD, slot + (QROW + BQ) * LD,
                                    rw, s_cols - i * KC);
    }

    // the whole S^T and dP^T from every group's partials; P^T into st and
    // dS^T = P^T (dP^T - delta) into dpt, masked entries exactly 0; lse and
    // delta from the last S slot, not refilled before the next wait
    uint32_t ap[kF32 ? 1 : BQ / 16][4], ads[kF32 ? 1 : BQ / 16][4];
    if (live) {
      swap_sum<G, STRIPS, NQ>(st, dpt, xs + (j % L::NB) * (L::kSwap / sizeof(float)), grp,
                              strip, 1 + G + strip, L::NB == 1);
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt) {
        const int qc = nt * 8 + 2 * tig;
        const float2 l2 = *reinterpret_cast<const float2*>(vecs + qc);
        const float2 dl = *reinterpret_cast<const float2*>(vecs + BQ + qc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = e < 2 ? key_lo : key_hi;
          const int qi = q0 + qc + (e & 1);
          const bool keep = qi < sq && key < skv && !(causal && qi < key);
          const float p = keep ? exp2f(fmaf(st[nt][e], scale_log2,
                                            -((e & 1) ? l2.y : l2.x) * kLog2e))
                               : 0.f;
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - ((e & 1) ? dl.y : dl.x));
        }
      }
      if constexpr (!kF32) {
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          ff_mma::acc_a2(ap[kk], st[2 * kk], st[2 * kk + 1]);
          ff_mma::acc_a2(ads[kk], dpt[2 * kk], dpt[2 * kk + 1]);
        }
      }
    }

    // dV += P^T dO and dK += dS^T Q over the group's W columns, KC a chunk:
    // with RU from the tile's own S chunks, each slot released after its
    // products; else from output items of their own
#pragma unroll
    for (int u = 0; u < NO; ++u) {
      const int tu = RU ? j * NO + u : t++;
      const T* slot = RU ? ring + (tu % NST) * SLOT : step(tu, 0);
      if (live) {
        const T* qs = slot + QROW * LD;
        const T* gs = qs + BQ * LD;
        if constexpr (kF32) {
#pragma unroll
          for (int kk = 0; kk < NQ; ++kk) {
            const Split<4> a = ff_tf32::acc_a(st[kk]);
            const Split<4> a2 = ff_tf32::acc_a(dpt[kk]);
#pragma unroll
            for (int dt = 0; dt < KC / 8; ++dt) {
              const int c = u * KC + dt * 8;
              if (c >= W) break;
              ff_tf32::mma3(dva[c / 8], a, ff_tf32::frag_b_krows<LD>(gs, kk * 8, dt * 8));
              ff_tf32::mma3(dka[c / 8], a2, ff_tf32::frag_b_krows<LD>(qs, kk * 8, dt * 8));
            }
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
            for (int d2 = 0; d2 < KC / 16; ++d2) {
              const int c = u * KC + d2 * 16;
              if (c >= W) break;
              uint32_t bg[4], bq[4];
              const int b_off =
                  (kk * 16 + ff_mma::bk_row(lane)) * LD + d2 * 16 + ff_mma::bk_col(lane);
              ff_mma::ldmatrix_x4_trans(bg, gs + b_off);
              ff_mma::ldmatrix_x4_trans(bq, qs + b_off);
              ff_mma::mma_bf16(dva[c / 8], ap[kk], bg[0], bg[1]);
              ff_mma::mma_bf16(dva[c / 8 + 1], ap[kk], bg[2], bg[3]);
              ff_mma::mma_bf16(dka[c / 8], ads[kk], bq[0], bq[1]);
              ff_mma::mma_bf16(dka[c / 8 + 1], ads[kk], bq[2], bq[3]);
            }
        }
      }
      if constexpr (RU) release(tu);
    }
  }
  ff_mma::cp_async_wait<0>();
  store_acc<T, ND>(dk + koff, dka, key_lo, skv, o_lo, d, scale, vec);
  store_acc<T, ND>(dv + koff, dva, key_lo, skv, o_lo, d, 1.f, vec);
}

template <int STRIPS, int W, int BK, int KC, int NST, bool RES>
__global__ void __launch_bounds__(kDqGroups * 32 * STRIPS, 1)
flash_bwd_dq_kernel_wide_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ o,
                             const bf16* __restrict__ g, const float* __restrict__ lse,
                             float* __restrict__ delta, bf16* __restrict__ dq, int sq, int skv,
                             int d, float scale, int causal, int vec, int nchunk) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  dq_wide<bf16, STRIPS, W, BK, KC, NST, RES>(q, k, v, o, g, lse, delta, dq, sq, skv, d, scale,
                                             causal, vec, nchunk, wide_smem);
}

template <int STRIPS, int W, int BK, int KC, int NST, bool RES>
__global__ void __launch_bounds__(kDqGroups * 32 * STRIPS, 1)
flash_bwd_dq_kernel_wide_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ o,
                                const float* __restrict__ g, const float* __restrict__ lse,
                                float* __restrict__ delta, float* __restrict__ dq, int sq,
                                int skv, int d, float scale, int causal, int vec, int nchunk) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  dq_wide<float, STRIPS, W, BK, KC, NST, RES>(q, k, v, o, g, lse, delta, dq, sq, skv, d, scale,
                                              causal, vec, nchunk, wide_smem);
}

template <int G, int STRIPS, int W, int BQ, int KC, int NST, bool RES, bool RU>
__global__ void __launch_bounds__(G * 32 * STRIPS, 1)
flash_bwd_dkv_kernel_wide_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ g,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int skv,
                              int d, float scale, int causal, int vec, int nchunk) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  dkv_wide<bf16, G, STRIPS, W, BQ, KC, NST, RES, RU>(q, k, v, g, lse, delta, dk, dv, sq, skv, d,
                                                     scale, causal, vec, nchunk, wide_smem);
}

template <int G, int STRIPS, int W, int BQ, int KC, int NST, bool RES, bool RU>
__global__ void __launch_bounds__(G * 32 * STRIPS, 1)
flash_bwd_dkv_kernel_wide_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const float* __restrict__ g,
                                 const float* __restrict__ lse, const float* __restrict__ delta,
                                 float* __restrict__ dk, float* __restrict__ dv, int sq, int skv,
                                 int d, float scale, int causal, int vec, int nchunk) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  dkv_wide<float, G, STRIPS, W, BQ, KC, NST, RES, RU>(q, k, v, g, lse, delta, dk, dv, sq, skv,
                                                      d, scale, causal, vec, nchunk, wide_smem);
}

template <typename T>
bool vec_ok(int d, std::initializer_list<const void*> ptrs) {
  if (d % Pad<T>::kVec != 0) return false;
  for (const void* p : ptrs)
    if (!ff_mma::aligned16(p)) return false;
  return true;
}

// Blocks of a grid of bh x tiles x chunks along x; 0 when it does not fit.
inline unsigned grid(int bh, int s, int rows, int nchunk) {
  const long long n = (long long)bh * ((s + rows - 1) / rows) * nchunk;
  return n > INT_MAX ? 0u : (unsigned)n;
}

template <typename T, int STRIPS, int W, int BK, int KC, int NST, bool RES>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o, const void* g,
                      const void* lse, void* delta, void* dq, int bh, int sq, int skv, int d,
                      float scale, int causal, cudaStream_t stream) {
  using L = Layout<T, kDqGroups, STRIPS, W, BK, KC, NST, RES, false>;
  const int nchunk = (d + kDqGroups * W - 1) / (kDqGroups * W);
  if (RES && nchunk > 1) return cudaErrorInvalidValue;  // a resident slice is at most W wide
  const unsigned blocks = grid(bh, sq, L::R, nchunk);
  if (blocks == 0) return cudaErrorInvalidValue;
  const int vec = vec_ok<T>(d, {q, k, v, o, g, dq});
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *ot = static_cast<const T*>(o),
          *gt = static_cast<const T*>(g);
  const float* lt = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  T* out = static_cast<T*>(dq);
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value) {
    auto kernel = flash_bwd_dq_kernel_wide_tf32x3<STRIPS, W, BK, KC, NST, RES>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L::kBytes);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, L::THREADS, L::kBytes, stream>>>(qt, kt, vt, ot, gt, lt, dl, out, sq, skv,
                                                       d, scale, causal, vec, nchunk);
  } else {
    auto kernel = flash_bwd_dq_kernel_wide_mma<STRIPS, W, BK, KC, NST, RES>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L::kBytes);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, L::THREADS, L::kBytes, stream>>>(qt, kt, vt, ot, gt, lt, dl, out, sq, skv,
                                                       d, scale, causal, vec, nchunk);
  }
  return cudaGetLastError();
}

template <typename T, int G, int STRIPS, int W, int BQ, int KC, int NST, bool RES, bool RU>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* g,
                       const void* lse, const void* delta, void* dk, void* dv, int bh, int sq,
                       int skv, int d, float scale, int causal, cudaStream_t stream) {
  using L = Layout<T, G, STRIPS, W, BQ, KC, NST, RES, true>;
  const int nchunk = (d + G * W - 1) / (G * W);
  if (RES && nchunk > 1) return cudaErrorInvalidValue;
  const unsigned blocks = grid(bh, skv, L::R, nchunk);
  if (blocks == 0) return cudaErrorInvalidValue;
  const int vec = vec_ok<T>(d, {q, k, v, g, dk, dv});
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *gt = static_cast<const T*>(g);
  const float *lt = static_cast<const float*>(lse), *dl = static_cast<const float*>(delta);
  T *dkt = static_cast<T*>(dk), *dvt = static_cast<T*>(dv);
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value) {
    auto kernel = flash_bwd_dkv_kernel_wide_tf32x3<G, STRIPS, W, BQ, KC, NST, RES, RU>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L::kBytes);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, L::THREADS, L::kBytes, stream>>>(qt, kt, vt, gt, lt, dl, dkt, dvt, sq, skv,
                                                       d, scale, causal, vec, nchunk);
  } else {
    auto kernel = flash_bwd_dkv_kernel_wide_mma<G, STRIPS, W, BQ, KC, NST, RES, RU>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L::kBytes);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, L::THREADS, L::kBytes, stream>>>(qt, kt, vt, gt, lt, dl, dkt, dvt, sq, skv,
                                                       d, scale, causal, vec, nchunk);
  }
  return cudaGetLastError();
}

// The dq kernel for head dim d: the block's columns in one chunk where G x
// 256 cover d, with W the least of 144, 192 and 256 that covers half of d
// and Q and dO resident where the dtype's tiles take them; past 512
// columns, chunks of G x 256 columns with Q and dO streamed.
template <typename T>
cudaError_t dispatch_dq(const void* q, const void* k, const void* v, const void* o,
                        const void* g, const void* lse, void* delta, void* dq, int bh, int sq,
                        int skv, int d, float scale, int causal, cudaStream_t s) {
  constexpr bool kRes = !std::is_same<T, float>::value;  // f32 Q and dO do not fit
  auto run = [&](auto w, auto res) {
    constexpr bool RES = decltype(res)::value;
    using Tl = DqTiles<T, decltype(w)::value>;
    return launch_dq<T, kDqStrips, decltype(w)::value, Tl::kBlock, Tl::kChunk, Tl::kStages,
                     RES>(q, k, v, o, g, lse, delta, dq, bh, sq, skv, d, scale, causal, s);
  };
  using Res = std::integral_constant<bool, kRes>;
  using Stream = std::integral_constant<bool, false>;
  using W144 = std::integral_constant<int, 144>;
  using W192 = std::integral_constant<int, 192>;
  using W256 = std::integral_constant<int, 256>;
  if (d > kDqGroups * kDqMaxW) return run(W256{}, Stream{});
  const int cols = (d + kDqGroups - 1) / kDqGroups;
  return cols <= 144 ? run(W144{}, Res{}) : cols <= 192 ? run(W192{}, Res{}) : run(W256{}, Res{});
}

// The dkv kernel for head dim d: up to 288 columns design (b), two groups
// of 144 columns over 64 key rows, K and V resident; up to 512 design (a),
// four groups of 80 or 128 columns over 32 key rows, K and V resident in
// bf16 and streamed in f32 (which lets the f32 query tile double); past 512
// columns, design (a) in chunks of 4 x 128 columns with K and V streamed.
template <typename T>
cudaError_t dispatch_dkv(const void* q, const void* k, const void* v, const void* g,
                         const void* lse, const void* delta, void* dk, void* dv, int bh,
                         int sq, int skv, int d, float scale, int causal, cudaStream_t s) {
  auto run = [&](auto groups, auto w, auto res) {
    constexpr int G = decltype(groups)::value;
    constexpr bool RES = decltype(res)::value;
    constexpr int W = decltype(w)::value;
    using Tl = DkvTiles<T, W, RES>;
    return launch_dkv<T, G, 8 / G, W, Tl::kBlock, Tl::kChunk, Tl::kStages, RES, Tl::kReuse>(
        q, k, v, g, lse, delta, dk, dv, bh, sq, skv, d, scale, causal, s);
  };
  using G2 = std::integral_constant<int, 2>;
  using G4 = std::integral_constant<int, 4>;
  using Res = std::integral_constant<bool, true>;
  using Stream = std::integral_constant<bool, false>;
  using W80 = std::integral_constant<int, 80>;
  using W128 = std::integral_constant<int, kDkvMaxW>;
  using W144 = std::integral_constant<int, kDkvWideW>;
  using ResA = std::integral_constant<bool, !std::is_same<T, float>::value>;
  if (d <= 2 * kDkvWideW) return run(G2{}, W144{}, Res{});
  if (d <= 4 * 80) return run(G4{}, W80{}, ResA{});
  if (d <= 4 * kDkvMaxW) return run(G4{}, W128{}, ResA{});
  return run(G4{}, W128{}, Stream{});
}

}  // namespace

extern "C" {

// The entries of flash_attention_bwd.cu for any head dim d >= 1 (the
// wrapper calls them above 256), with the same arguments. dtype: 0 =
// float32 (split TF32), 1 = bfloat16. delta is a (BH, Sq) f32 buffer: the dq
// kernel writes rowsum(dO * O) into it and the dkv kernel, launched after
// it on the same stream, reads it. Each returns the cudaError_t of its
// launch.
int ff_flash_attention_bwd_dq_wide(const void* q, const void* k, const void* v, const void* o,
                                   const void* g, const void* lse, void* delta, void* dq,
                                   int bh, int sq, int skv, int d, float scale, int causal,
                                   int dtype, void* stream) {
  if (bh <= 0 || sq <= 0 || skv <= 0 || d <= 0 || delta == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_dq<float>(q, k, v, o, g, lse, delta, dq, bh, sq, skv, d, scale, causal,
                                   s);
  if (dtype == 1)
    return (int)dispatch_dq<bf16>(q, k, v, o, g, lse, delta, dq, bh, sq, skv, d, scale, causal,
                                  s);
  return (int)cudaErrorInvalidValue;
}

int ff_flash_attention_bwd_dkv_wide(const void* q, const void* k, const void* v,
                                    const void* o, const void* g, const void* lse,
                                    const void* delta, void* dk, void* dv, int bh, int sq,
                                    int skv, int d, float scale, int causal, int dtype,
                                    void* stream) {
  (void)o;  // the dkv kernels read delta, never O
  if (bh <= 0 || sq <= 0 || skv <= 0 || d <= 0 || delta == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_dkv<float>(q, k, v, g, lse, delta, dk, dv, bh, sq, skv, d, scale,
                                    causal, s);
  if (dtype == 1)
    return (int)dispatch_dkv<bf16>(q, k, v, g, lse, delta, dk, dv, bh, sq, skv, d, scale,
                                   causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
