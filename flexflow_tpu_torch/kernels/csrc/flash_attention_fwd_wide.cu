// Flash-attention forward for head dims above 256 on NVIDIA Hopper (sm_90a),
// on the tensor cores in both dtypes.
//
// Replaces, for D > 256, the TPU kernel `_fwd_kernel`
// (flexflow_tpu/kernels/flash_attention.py:43, launched by `_flash_fwd` at
// :347), as flash_attention_fwd.cu does up to D = 256. For each
// (batch*head, query row):
//   O   = softmax(scale * Q K^T) V      (in the input type)
//   LSE = m + log(l)                    (f32, natural log)
// with the top-left -1e30 causal mask of `_causal_mask`. Layout as in
// flash_attention_fwd.cu: q (BH, Sq, D), k/v (BH, Skv, D), o (BH, Sq, D),
// lse (BH, 1, Sq), all contiguous; any D >= 1, any B*H, any lengths.
//
// Two kernels on one design: `flash_fwd_kernel_wide_mma` (bf16 `mma.sync`
// m16n8k16, flash_attention_mma.cuh) and `flash_fwd_kernel_wide_tf32x3`
// (f32 as split TF32: three TF32 `mma.sync` m16n8k8 products for each f32
// product, flash_attention_tf32.cuh; never one TF32 product).
//
// Why a kernel of its own. At 16 query rows a warp, O takes W / 2 f32
// registers a thread for W output columns; the one-pass kernels keep the
// whole row of O and stop at W = 256, where O alone takes 128 registers.
// Past it the head dim is cut two ways:
//
//  * The output columns. A block holds G groups of 4 warps over the same
//    64 query rows (one 16-row strip a warp); group g owns W output
//    columns, [c0 + g W, c0 + (g + 1) W). W is 144, 192 or 256, the least
//    that covers the block's share of D (D 264: two groups of 144, not
//    256 + 8). Above G * 256 columns the grid also cuts D into balanced
//    column chunks, one block each (c0 = chunk * G * W), and every chunk
//    computes S again; any D keeps working.
//  * The reduction of S = Q K^T over D. Every group needs all of S for its
//    rows. Group g computes the partial S over its own slice of D (D / G
//    columns, rounded to 16); the G warps of a strip swap their partials
//    through shared memory behind a named barrier of those 32 G threads
//    (not __syncthreads) and each sums them in the same order, group 0
//    first. Every group then holds the same S, so the same m, l and LSE,
//    bit for bit; group 0 of chunk 0 writes LSE. The partials are double
//    buffered by key tile, so one barrier a tile suffices.
//
// Loads. Each group streams its own tiles through a ring of three slots
// (two loads in flight) by 16-byte cp.async, zero-filled past the ends,
// and syncs on a named barrier of its own 128 threads: per key tile, first
// K over its slice of D in chunks of 64 columns, then V over its W output
// columns in chunks of 64. Q for the group's slice of D (at most 256
// columns while D <= 512) lands once and stays in shared memory; above
// that Q streams with K, a 64-row Q chunk over each K chunk, and is read
// again for every key tile. Key tiles are 64 rows in bf16 and 32 in f32
// (the f32 P fragments, split, take twice the registers). Where d % 8
// (bf16) or d % 4 (f32) != 0 or a base is not 16-byte aligned, the same
// slots are written element by element. Shared memory at D 512: bf16 184
// KB, f32 213 KB; one block (8 warps) an SM.
//
// Products. bf16: S by ldmatrix fragments of Q and K; P rounded to bf16 and
// made PV's A fragment straight from the accumulators (acc_a2); V's B
// fragments by ldmatrix.trans; scale applied to S in f32 (folded into the
// exponent), as flash_fwd_kernel_mma does. f32: Q scaled in f32 as it is
// read (as `_fwd_kernel` scales it) and split, K split per fragment
// (frag_b_nrows); P split into PV's A fragment through the m16n8k8
// relabelling (acc_a), V read k-major (frag_b_krows), as
// flash_fwd_kernel_tf32x3 does. The online softmax runs in f32 registers;
// P never touches shared memory.
//
// Both: under causal a block stops at the last key tile its rows can see,
// and a strip's warps skip the products of tiles whose first key lies past
// the strip's last row (still taking part in the group's loads); blocks go
// bh-major, each bh's query tiles last first (the most causal work first),
// so the blocks of one bh run together and its K and V are read from
// device memory about once; each block owns its output tile (no atomics:
// two runs agree bit for bit); rows past Sq write nothing.
//
// Bound at B*H = 128, Sq = Skv = 512, D = 512 (H100 SXM, 3.35 TB/s): the
// forward's 2 products are 68.7 GFLOP (half under causal); q, k, v, o are
// 537 MB in f32, 268 MB in bf16. bf16 (989 TFLOP/s): 0.069 ms of
// operations vs 0.080 ms of bytes -> 0.080 ms, bound by bytes; f32 (494.7
// TFLOP/s TF32 / 3 for f32-accurate products): 0.417 ms of operations vs
// 0.160 ms of bytes -> 0.417 ms. This design does the products once, plus
// the swap of S (one 16 x BK f32 tile a warp and key tile). With
// `mma.sync` and 16 query rows a warp, every K and V fragment read from
// shared memory feeds only two products, so the fragment reads, not the
// tensor cores, are the likely limit (the card's machine has no profiler
// of the SM's pipes to show it). PERF.md gives the times against the
// bound, the plain version and SDPA, and the variants timed.

#include <math.h>

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

constexpr int kGroups = 2;                   // G: groups of warps a block
constexpr int kStrips = 4;                   // 16-row strips of query rows a block
constexpr int kBlockQ = 16 * kStrips;        // query rows a block
constexpr int kGroupThreads = 32 * kStrips;  // a group: one warp a strip
constexpr int kThreads = kGroups * kGroupThreads;
constexpr int kMaxGroupCols = 256;           // the widest W, and the widest resident Q slice
constexpr float kLog2e = 1.4426950408889634f;

// The tiles of each dtype, chosen among the variants
// tools/torch_fwd_wide_variants.py times on an H100: key tile BK, columns
// of a staged chunk KC, ring slots a group NST.
template <typename T>
struct Tiles;
template <>
struct Tiles<bf16> {
  static constexpr int kBlockK = 64, kChunk = 64, kStages = 3;
};
template <>
struct Tiles<float> {
  static constexpr int kBlockK = 32, kChunk = 64, kStages = 3;
};

// 2^x by the SFU's approximation (relative error about 2^-22, denormal
// results flushed to 0), as in flash_attention_fwd.cu.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The split A fragment of rows [row0, row0 + 16) and columns [col0, col0 + 8)
// of a staged f32 tile, each value times `mul` in f32 before its split.
template <int LD>
__device__ __forceinline__ Split<4> frag_a_scaled(const float* tile, int row0, int col0,
                                                  float mul) {
  const int lane = threadIdx.x & 31, group = lane >> 2, tig = lane & 3;
  const float* p = tile + (row0 + group) * LD + col0 + tig;
  Split<4> f;
  ff_tf32::split(p[0] * mul, f.big[0], f.small[0]);
  ff_tf32::split(p[8 * LD] * mul, f.big[1], f.small[1]);
  ff_tf32::split(p[4] * mul, f.big[2], f.small[2]);
  ff_tf32::split(p[8 * LD + 4] * mul, f.big[3], f.small[3]);
  return f;
}

// Shared memory of a block: per group a ring of NST slots of BK rows of K
// or V (and, unless Q is resident, 64 rows of Q above them) and, with QRES,
// the group's resident [64][256 + pad] slice of Q; then the swapped partial
// S, double buffered: [2][G][kStrips][16 x BK] f32.
template <typename T, int BK, int KC, int NST, bool QRES>
constexpr size_t smem_bytes() {
  constexpr int LD = KC + Pad<T>::kPad, LDQ = kMaxGroupCols + Pad<T>::kPad;
  return sizeof(T) * (size_t)kGroups *
             (NST * ((QRES ? 0 : kBlockQ) + BK) * LD + (QRES ? kBlockQ * LDQ : 0)) +
         sizeof(float) * (size_t)2 * kGroups * kBlockQ * BK;
}

// The forward of one block: query rows [q0, q0 + 64) of one bh, output
// columns [c0, c0 + G W) (see the top of this file). QRES: the group's
// slice of D for S (at most 256 columns) lands in shared memory once and
// stays; otherwise Q streams with K, a chunk of each a slot.
template <typename T, int W, int BK, int KC, int NST, bool QRES>
__device__ __forceinline__ void fwd_wide(const T* __restrict__ q, const T* __restrict__ k,
                                         const T* __restrict__ v, T* __restrict__ o,
                                         float* __restrict__ lse, int sq, int skv, int d,
                                         float scale, int causal, int vec, int nchunk,
                                         unsigned char* smem) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int G = kGroups;
  constexpr int LD = KC + Pad<T>::kPad;                            // K, V (and Q) chunks
  constexpr int LDQ = QRES ? kMaxGroupCols + Pad<T>::kPad : LD;  // Q as the products read it
  constexpr int KSTEP = kF32 ? 8 : 16;   // depth of one mma
  constexpr int NK = BK / 8, ND = W / 8;  // n8 tiles of S, of the group's O
  constexpr int NV = (W + KC - 1) / KC;   // V chunks a key tile
  constexpr int KROW = QRES ? 0 : kBlockQ;  // K's first row in an S slot
  constexpr int SLOT = (KROW + BK) * LD;
  static_assert(W % 16 == 0 && W <= kMaxGroupCols && BK % 16 == 0 && KC % 16 == 0,
                "tile shape");
  static_assert(NST >= 2, "a ring of two slots at least");

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / kStrips, strip = warp % kStrips, tid = threadIdx.x % kGroupThreads;
  const int group = lane >> 2, tig = lane & 3, rw = strip * 16;
  T* ring = reinterpret_cast<T*>(smem) + grp * NST * SLOT;
  T* qres = reinterpret_cast<T*>(smem) + G * NST * SLOT + grp * kBlockQ * LDQ;
  float* xs = reinterpret_cast<float*>(
      smem + sizeof(T) * (size_t)G * (NST * SLOT + (QRES ? kBlockQ * LDQ : 0)));

  // blocks go bh-major; within a bh the last query tiles, which carry the
  // most causal work, start first; a tile's column chunks side by side
  const int nq = (sq + kBlockQ - 1) / kBlockQ;
  const int per_bh = nq * nchunk;
  const int bh = blockIdx.x / per_bh, rest = blockIdx.x % per_bh;
  const int q0 = (nq - 1 - rest / nchunk) * kBlockQ;
  const int chunk = rest % nchunk;
  const size_t qoff = (size_t)bh * sq * d, koff = (size_t)bh * skv * d;
  const T* qb = q + qoff;
  const T* kb = k + koff;
  const T* vb = v + koff;

  // the group's slice of D for S (s_cols columns from s_lo, in steps of 16,
  // zero past d) and its first output column
  int s_lo, s_cols;
  ff_wide::group_slice(d, G, grp, s_lo, s_cols);
  const int n_s = (s_cols + KC - 1) / KC;  // S chunks a key tile
  const int o_lo = (chunk * G + grp) * W;
  const int per_tile = n_s + NV;
  const int kv_end = causal ? min(skv, q0 + kBlockQ) : skv;
  const int ntiles = (kv_end + BK - 1) / BK;
  const int items = ntiles * per_tile;

  // Item t of the group's stream into slot t % NST: per key tile, its S
  // chunks (a K chunk, under a Q chunk unless Q is resident), then its V
  // chunks; one cp.async group a call, empty past the end.
  auto fetch = [&](int t) {
    if (t < items) {
      T* slot = ring + (t % NST) * SLOT;
      const int k0 = (t / per_tile) * BK, r = t % per_tile;
      if (r < n_s) {
        const int c0 = s_lo + r * KC, nc = min(KC, s_cols - r * KC);
        if constexpr (!QRES)
          load_tile<T, kBlockQ, KC, LD, kGroupThreads>(slot, qb, q0, sq, c0, nc, d, vec, tid);
        load_tile<T, BK, KC, LD, kGroupThreads>(slot + KROW * LD, kb, k0, skv, c0, nc, d, vec,
                                                tid);
      } else {
        const int u = r - n_s;
        load_tile<T, BK, KC, LD, kGroupThreads>(slot, vb, k0, skv, o_lo + u * KC,
                                                min(KC, W - u * KC), d, vec, tid);
      }
    }
    ff_mma::cp_async_commit();
  };
  // Item t has landed for the whole group; the slot read at item t - 1 is
  // free again and takes item t + NST - 1.
  auto step = [&](int t) -> const T* {
    ff_mma::cp_async_wait<NST - 2>();
    named_barrier(1 + grp, kGroupThreads);
    fetch(t + NST - 1);
    return ring + (t % NST) * SLOT;
  };

  // Row state of the thread's two rows (lo = group, hi = group + 8 of the
  // strip): the running max of the logits as the products give them (f32:
  // scaled, from the scaled Q; bf16: raw, scale > 0) and the thread's part
  // of the row sum, whose 4 parts are added at the end; sl turns a logit
  // into log2 units of the softmax.
  const int row_lo = q0 + rw + group, row_hi = row_lo + 8;
  const float sl = kF32 ? kLog2e : scale * kLog2e;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  if constexpr (QRES) {  // the group's slice of Q, in a cp.async group of its own
    load_tile<T, kBlockQ, kMaxGroupCols, LDQ, kGroupThreads>(qres, qb, q0, sq, s_lo, s_cols, d,
                                                             vec, tid);
    ff_mma::cp_async_commit();
  }
#pragma unroll
  for (int t = 0; t < NST - 1; ++t) fetch(t);
  int t = 0;
  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BK;
    // Under causal, a tile whose first key lies past the strip's last row
    // holds only dead entries for the strip: it would leave m, l and O as
    // they are, so the strip's warps (in every group alike) skip it.
    const bool live = !causal || k0 <= q0 + rw + 15;

    // the partial S = Q K^T over the group's slice of D, f32
    float s[NK][4];
#pragma unroll
    for (int i = 0; i < NK; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
    for (int i = 0; i < n_s; ++i, ++t) {
      const T* slot = step(t);
      const T* qs = QRES ? qres + i * KC : slot;
      const T* ks = slot + KROW * LD;
      if (!live) continue;
      // one mma-deep step of the chunk into S
      auto s_step = [&](int kk) {
        if constexpr (kF32) {
          const Split<4> a = frag_a_scaled<LDQ>(qs, rw, kk * 8, scale);
#pragma unroll
          for (int nt = 0; nt < NK; ++nt)
            ff_tf32::mma3(s[nt], a, ff_tf32::frag_b_nrows<LD>(ks, nt * 8, kk * 8));
        } else {
          uint32_t a[4];
          ff_mma::ldmatrix_x4(a, qs + (rw + ff_mma::a_row(lane)) * LDQ + kk * 16 +
                                     ff_mma::a_col(lane));
#pragma unroll
          for (int n2 = 0; n2 < BK / 16; ++n2) {
            uint32_t b[4];
            ff_mma::ldmatrix_x4(
                b, ks + (n2 * 16 + ff_mma::bn_row(lane)) * LD + kk * 16 + ff_mma::bn_col(lane));
            ff_mma::mma_bf16(s[2 * n2], a, b[0], b[1]);
            ff_mma::mma_bf16(s[2 * n2 + 1], a, b[2], b[3]);
          }
        }
      };
      // a full chunk unrolled without a branch between its steps, so that
      // the fragment loads of one step overlap the products of the last;
      // the slice's last chunk may hold fewer
      const int steps = min(KC, s_cols - i * KC) / KSTEP;
      if (steps == KC / KSTEP) {
#pragma unroll
        for (int kk = 0; kk < KC / KSTEP; ++kk) s_step(kk);
      } else {
        for (int kk = 0; kk < steps; ++kk) s_step(kk);
      }
    }

    // P of the tile as PV's A fragments: split TF32 (f32) or bf16
    typename std::conditional<kF32, Split<4>[NK], uint32_t[BK / 16][4]>::type ap;
    if (live) {
      // swap the partials with the strip's warp of the other group and sum
      // them, group 0 first: every group gets the same S
      float* buf = xs + (size_t)(j & 1) * G * kStrips * 16 * BK;
      float4* mine = reinterpret_cast<float4*>(buf + (grp * kStrips + strip) * 16 * BK);
#pragma unroll
      for (int nt = 0; nt < NK; ++nt)
        mine[nt * 32 + lane] = make_float4(s[nt][0], s[nt][1], s[nt][2], s[nt][3]);
      named_barrier(1 + G + strip, 32 * G);
#pragma unroll
      for (int g2 = 0; g2 < G; ++g2) {
        const float4* part =
            reinterpret_cast<const float4*>(buf + (g2 * kStrips + strip) * 16 * BK);
#pragma unroll
        for (int nt = 0; nt < NK; ++nt) {
          const float4 x = part[nt * 32 + lane];
          if (g2 == 0) {
            s[nt][0] = x.x;
            s[nt][1] = x.y;
            s[nt][2] = x.z;
            s[nt][3] = x.w;
          } else {
            s[nt][0] += x.x;
            s[nt][1] += x.y;
            s[nt][2] += x.z;
            s[nt][3] += x.w;
          }
        }
      }

      // A tile that reaches past Skv or past the strip's first row (the
      // causal diagonal) has dead entries: keys past Skv and, under causal,
      // keys past the row. They leave the row max as -inf and get p = 0 by
      // a select.
      const bool masked = k0 + BK > skv || (causal && k0 + BK - 1 > q0 + rw);
      auto dead = [&](int nt, int e) {
        const int key = k0 + nt * 8 + 2 * tig + (e & 1);
        return key >= skv || (causal && (e < 2 ? row_lo : row_hi) < key);
      };
      if (masked) {
#pragma unroll
        for (int nt = 0; nt < NK; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (dead(nt, e)) s[nt][e] = -INFINITY;
      }

      // online softmax in f32: the new row max over the row's 4 lanes, the
      // old sums and accumulators rescaled by alpha = 2^(sl (m_old - m_new))
      float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
      for (int nt = 0; nt < NK; ++nt) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      // a row that has seen no live key keeps -inf; 0 in its place keeps
      // alpha and p free of inf - inf (key 0 is live for every row, so no
      // row stays there past the first tile)
      const float ms_lo = mx_lo == -INFINITY ? 0.f : mx_lo * sl;
      const float ms_hi = mx_hi == -INFINITY ? 0.f : mx_hi * sl;
      const float alpha_lo = exp2_approx(m_lo * sl - ms_lo);
      const float alpha_hi = exp2_approx(m_hi * sl - ms_hi);
      m_lo = mx_lo;
      m_hi = mx_hi;
#pragma unroll
      for (int nt = 0; nt < NK; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nt][e] = exp2_approx(fmaf(s[nt][e], sl, -(e < 2 ? ms_lo : ms_hi)));
      if (masked) {
#pragma unroll
        for (int nt = 0; nt < NK; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (dead(nt, e)) s[nt][e] = 0.f;
      }
      l_lo *= alpha_lo;
      l_hi *= alpha_hi;
#pragma unroll
      for (int nt = 0; nt < NK; ++nt) {
        l_lo += s[nt][0] + s[nt][1];
        l_hi += s[nt][2] + s[nt][3];
      }
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        acc[i][0] *= alpha_lo;
        acc[i][1] *= alpha_lo;
        acc[i][2] *= alpha_hi;
        acc[i][3] *= alpha_hi;
      }
      if constexpr (kF32) {
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) ap[kk] = ff_tf32::acc_a(s[kk]);
      } else {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) ff_mma::acc_a2(ap[kk], s[2 * kk], s[2 * kk + 1]);
      }
    }

    // O += P V over the group's W columns, KC at a time; each key step
    // feeds the chunk's accumulators in turn, so neighbouring products are
    // independent
#pragma unroll
    for (int u = 0; u < NV; ++u, ++t) {
      const T* vs = step(t);
      if (!live) continue;
      if constexpr (kF32) {
#pragma unroll
        for (int kk = 0; kk < NK; ++kk)
#pragma unroll
          for (int dt = 0; dt < KC / 8; ++dt) {
            if (u * KC + dt * 8 >= W) break;
            ff_tf32::mma3(acc[u * KC / 8 + dt], ap[kk],
                          ff_tf32::frag_b_krows<LD>(vs, kk * 8, dt * 8));
          }
      } else {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int d2 = 0; d2 < KC / 16; ++d2) {
            if (u * KC + d2 * 16 >= W) break;
            uint32_t b[4];
            ff_mma::ldmatrix_x4_trans(
                b, vs + (kk * 16 + ff_mma::bk_row(lane)) * LD + d2 * 16 + ff_mma::bk_col(lane));
            ff_mma::mma_bf16(acc[u * KC / 8 + 2 * d2], ap[kk], b[0], b[1]);
            ff_mma::mma_bf16(acc[u * KC / 8 + 2 * d2 + 1], ap[kk], b[2], b[3]);
          }
      }
    }
  }
  ff_mma::cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = l_lo > 0.f ? 1.f / l_lo : 0.f;
  const float inv_hi = l_hi > 0.f ? 1.f / l_hi : 0.f;
  if (grp == 0 && chunk == 0 && tig == 0) {
    float* lseb = lse + (size_t)bh * sq;
    const float lm = kF32 ? 1.f : scale;  // the logits' scale left to apply
    if (row_lo < sq) lseb[row_lo] = m_lo * lm + logf(l_lo);
    if (row_hi < sq) lseb[row_hi] = m_hi * lm + logf(l_hi);
  }
  // O / l straight from the accumulators: a thread's two neighbouring
  // columns in one store under `vec` (d a multiple of the 16-byte copy, so
  // a pair never straddles d), else one at a time
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? row_hi : row_lo;
    if (row >= sq) continue;
    const float inv = h ? inv_hi : inv_lo;
    T* orow = o + qoff + (size_t)row * d;
#pragma unroll
    for (int dt = 0; dt < ND; ++dt) {
      const int c = o_lo + dt * 8 + 2 * tig;
      const float x0 = acc[dt][2 * h] * inv, x1 = acc[dt][2 * h + 1] * inv;
      if (vec) {
        if (c < d) store_pair(orow + c, x0, x1);
      } else {
        if (c < d) orow[c] = ff_flash::from_f32<T>(x0);
        if (c + 1 < d) orow[c + 1] = ff_flash::from_f32<T>(x1);
      }
    }
  }
}

template <int W, int BK, int KC, int NST, bool QRES>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel_wide_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, int sq, int skv, int d, float scale,
                          int causal, int vec, int nchunk) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  fwd_wide<bf16, W, BK, KC, NST, QRES>(q, k, v, o, lse, sq, skv, d, scale, causal, vec, nchunk,
                                       wide_smem);
}

template <int W, int BK, int KC, int NST, bool QRES>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel_wide_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, float* __restrict__ o,
                             float* __restrict__ lse, int sq, int skv, int d, float scale,
                             int causal, int vec, int nchunk) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  fwd_wide<float, W, BK, KC, NST, QRES>(q, k, v, o, lse, sq, skv, d, scale, causal, vec,
                                        nchunk, wide_smem);
}

template <typename T, int W, int BK, int KC, int NST, bool QRES>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                   int sq, int skv, int d, float scale, int causal, cudaStream_t stream) {
  const int nchunk = (d + kGroups * W - 1) / (kGroups * W);
  const long long blocks = (long long)bh * ((sq + kBlockQ - 1) / kBlockQ) * nchunk;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes<T, BK, KC, NST, QRES>();
  const int vec = d % Pad<T>::kVec == 0 && ff_mma::aligned16(q) && ff_mma::aligned16(k) &&
                  ff_mma::aligned16(v) && ff_mma::aligned16(o);
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  float* lt = static_cast<float*>(lse);
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value) {
    auto kernel = flash_fwd_kernel_wide_tf32x3<W, BK, KC, NST, QRES>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(qt, kt, vt, ot, lt, sq, skv, d, scale,
                                                         causal, vec, nchunk);
  } else {
    auto kernel = flash_fwd_kernel_wide_mma<W, BK, KC, NST, QRES>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(qt, kt, vt, ot, lt, sq, skv, d, scale,
                                                         causal, vec, nchunk);
  }
  return cudaGetLastError();
}

// The group width W for head dim d: the least of 144, 192 and 256 that
// covers a group's share of the block's columns, where the columns are cut
// into as few balanced chunks of at most G * 256 as d needs. Q stays
// resident where a group's slice of D for S is at most 256 columns (d <=
// 512).
template <typename T, int BK, int KC, int NST>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                     int sq, int skv, int d, float scale, int causal, cudaStream_t s) {
  constexpr int G = kGroups;
  const int chunks = (d + G * kMaxGroupCols - 1) / (G * kMaxGroupCols);
  const int cols = ((d + chunks - 1) / chunks + G - 1) / G;
  auto run = [&](auto w, auto qres) {
    return launch<T, decltype(w)::value, BK, KC, NST, decltype(qres)::value>(
        q, k, v, o, lse, bh, sq, skv, d, scale, causal, s);
  };
  using Q = std::integral_constant<bool, true>;
  using S = std::integral_constant<bool, false>;
  using W144 = std::integral_constant<int, 144>;
  using W192 = std::integral_constant<int, 192>;
  using W256 = std::integral_constant<int, 256>;
  if (chunks == 1)
    return cols <= 144 ? run(W144{}, Q{}) : cols <= 192 ? run(W192{}, Q{}) : run(W256{}, Q{});
  return cols <= 144 ? run(W144{}, S{}) : cols <= 192 ? run(W192{}, S{}) : run(W256{}, S{});
}

}  // namespace

extern "C" {

// The entry of flash_attention_fwd.cu for any head dim d >= 1 (the wrapper
// calls it above 256). dtype: 0 = float32 (split TF32), 1 = bfloat16.
// Returns the cudaError_t of the launch.
int ff_flash_attention_fwd_wide(const void* q, const void* k, const void* v, void* o,
                                void* lse, int bh, int sq, int skv, int d, float scale,
                                int causal, int dtype, void* stream) {
  if (bh <= 0 || sq <= 0 || skv <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    using F = Tiles<float>;
    return (int)dispatch<float, F::kBlockK, F::kChunk, F::kStages>(q, k, v, o, lse, bh, sq, skv,
                                                                   d, scale, causal, s);
  }
  if (dtype == 1) {
    using B = Tiles<bf16>;
    return (int)dispatch<bf16, B::kBlockK, B::kChunk, B::kStages>(q, k, v, o, lse, bh, sq, skv,
                                                                  d, scale, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
