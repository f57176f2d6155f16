// Flash-attention backward for NVIDIA Hopper (sm_90a): two kernels.
//
// Replaces the TPU kernels `_dq_kernel` and `_dkv_kernel`
// (flexflow_tpu/kernels/flash_attention.py:59 and :79, launched by `_flash_bwd`
// at :369 and :380). With S = (scale * Q) K^T, the causal mask (-1e30 where
// qpos < kpos, top-left aligned, as `_causal_mask`), and the forward's saved
// log-sum-exp:
//   P  = exp(S - lse)          dP = dO V^T
//   delta = rowsum(dO * O)     dS = P * (dP - delta)
//   dQ = (dS K) * scale        (ff_flash_attention_bwd_dq)
//   dV = P^T dO,  dK = dS^T (scale * Q)   (ff_flash_attention_bwd_dkv)
// Inputs q, o, g (BH, Sq, D) and k, v (BH, Skv, D) are f32 or bf16, lse
// (BH, 1, Sq) is f32; the gradients are written in the input type. delta
// reads O as stored (bf16 O in bf16), as `o_ref[0].astype(f32)` does. Any D
// up to 256 and any B*H (flash_attention_common.cuh). Both kernels own their
// output tiles outright: no atomics, no dQ scratch, and the result does not
// depend on the schedule, so two runs agree bit for bit. The cost is that S
// and dP are computed in both kernels: 7 products for the function's 5.
//
// bf16: the tensor cores (flash_bwd_dq_kernel_mma, flash_bwd_dkv_kernel_mma).
// Every product is `mma.sync.m16n8k16` with bf16 operands and f32
// accumulation (flash_attention_mma.cuh); tiles arrive by 16-byte `cp.async`
// copies into padded shared memory, two stages deep, and S, P, dP and dS
// never leave registers.
//  * dq: one 128-thread block per (bh, 64-query tile), each warp owning 16
//    query rows. It stages Q and dO once (and O, in the second K/V stage
//    before its first use), computes delta = rowsum(dO * O) in f32 for its
//    rows and writes it to a (BH, Sq) f32 buffer, reads lse, then
//    loops over key tiles with K and V double-buffered: S = Q K^T and
//    dP = dO V^T by mma, P = exp(S * scale - lse), dS = P * (dP - delta) in
//    f32 registers, dS rounded to bf16 A fragments in registers (two n8
//    accumulator tiles are one k16 A fragment), dQ += dS K with K's B
//    fragments by `ldmatrix.trans`. dQ * scale is written once. Under causal
//    it stops at the last key tile its rows can see.
//  * dkv: one block per (bh, 64-key tile), in the transposed orientation so
//    that P^T and dS^T come out of the accumulators as A fragments. It keeps
//    K and V in shared memory and dK and dV in f32 registers, and loops over
//    query tiles with Q, dO, lse and delta (the dq kernel's buffer: the two
//    launch in order on one stream) double-buffered: S^T = K Q^T,
//    dP^T = V dO^T, dV += P^T dO, dK += dS^T Q; dK * scale at the end. Under
//    causal it starts at the first query tile that sees a key of its tile; a
//    key no query sees gets exactly 0.
// Both grids go tile-major (all bh of one tile, then the next), the tiles
// with the most causal work first.
// Tiles: the dq kernel's key tile is 64 rows (32 at the padded width 256,
// where dQ's 128 accumulators a thread leave room for no more); the dkv
// kernel's query tile is 64 rows up to width 64 and 32 above. From width 128
// the dkv kernel runs 8 warps, two to each 16 key rows, each owning half of
// the dK/dV columns (a thread's 128 f32 accumulators of dK and dV at width
// 128 spilled, 256 at width 256 would not fit in registers); both warps of a
// pair compute the same S^T and dP^T, 1.5x the kernel's products there.
// Shared memory: 54 / 102 / 132 KiB (dq) and 55 / 68.5 / 132.5 KiB (dkv) at
// widths 64 / 128 / 256. At the slice shape (B*H 128, S 512) both grids
// have 1024 blocks. ptxas: no spills up to width 128; a few dozen bytes at
// width 256, where 255 registers are not enough.
// Where it is delicate:
//  * Ragged lengths (S = 200, 72; Sq != Skv under the top-left causal mask):
//    rows past the end are zero-filled by the copies (src-size 0), and their
//    entries get p = 0 exactly by a select, so no exp of them is used.
//  * Head dims not a multiple of 8: rows of stride d are not 16-byte
//    aligned, so when d % 8 != 0 (or a base pointer is not 16-byte aligned)
//    the same kernels load and store element by element into the same
//    shared layout.
//  * Bank conflicts: each tile row is padded by 16 bytes (see
//    flash_attention_mma.cuh), so `ldmatrix` reads are conflict-free.
//  * Numerics: scale multiplies S in f32 (and dQ, dK at the end), never a
//    bf16 Q tile: 1/sqrt(D) is a power of two only for some D. P and dS are
//    rounded to bf16 before the second products, as FlashAttention does;
//    tests/test_torch_flash_attention_bwd.py holds that rounding model
//    against the JAX kernels within the bf16 tolerance.
//
// f32: the tensor cores too, with split TF32 products
// (flash_bwd_dq_kernel_tf32x3, flash_bwd_dkv_kernel_tf32x3). Every product
// is `mma.sync.m16n8k8` with TF32 operands and f32 accumulation, done three
// times: each f32 operand is split into big + small TF32 values (big
// rounded to nearest, ties away, as cvt.rna.tf32.f32 rounds, in two integer
// instructions; small = x - big, which the tensor core truncates), and
// small*big + big*small + big*big are summed in f32
// (flash_attention_tf32.cuh), which keeps the result within a few f32 ulps
// of an f32 product. Never single-pass TF32: that moves a gradient by ~7e-4
// of its largest, 7x the card's f32 tolerance. The kernels follow the bf16
// pair's design: the same grids, block order, causal bounds, delta buffer
// (dq writes rowsum(dO * O) for its rows, dkv reads it and never reads O),
// 2-stage 16-byte `cp.async` ring (K/V in dq, Q/dO/lse/delta in dkv),
// zero-fill past ragged ends and element-wise loads when d % 4 != 0 or a
// base is not 16-byte aligned, tiles padded by 4 floats a row (conflict-free
// fragment reads), p = 0 exactly by a select on masked entries, and the
// output tile owned by one block. Where f32 differs:
//  * P and dS stay in f32 registers: an m16n8k8 accumulator holds columns
//    (2t, 2t+1) where an A fragment wants k-columns (t, t+4), so the
//    accumulator is relabelled as the next product's A fragment (column 2t
//    is k-slot t, 2t+1 is k-slot t+4), and that product's B operand is read
//    at rows 2t and 2t+1 of its 8-row chunk by 32-bit loads.
//  * Q and dO (dq) and K and V (dkv) are re-read from shared memory and
//    split each tile: held split across the loop they would take 128
//    registers a thread at width 64. K/V (dq) and Q/dO (dkv) are split as
//    their fragments are loaded.
//  * f32 tiles are twice the bf16 bytes, so the tiles shrink with the
//    width: dq's key tile is 64 / 32 / 32 / 16 rows and dkv's query tile
//    64 / 64 / 32 / 16 rows at widths 32 / 64 / 128 / 256; dq keeps 64
//    query rows (4 warps) and dkv 64 key rows (4 warps, 8 from width 128
//    with each warp pair splitting the dK/dV columns, as in bf16). Shared
//    memory 54 / 68 / 132 / 195 KiB (dq) and 55 / 103 / 132.5 / 195.25
//    KiB (dkv). The tile sizes and unrolling were chosen among variants
//    built and timed on the H100 (notes at dq_block_k, dkv_block_q).
//
// Bound at the slice shape (B*H = 128, Sq = Skv = 512, D = 64, H100 SXM:
// 494.7 TFLOP/s TF32 dense, so 164.9 TFLOP/s for f32-accurate products at
// three TF32 products each (67 TFLOP/s on the CUDA cores); 989 TFLOP/s bf16
// on the tensor cores; 3.35 TB/s). One unit = 2 * B*H * S^2 * D = 4.29
// GFLOP of one product.
//   The function: 5 products (S, dP, dQ, dK, dV) = 21.5 GFLOP; it reads q, k,
//   v, o, g and writes dq, dk, dv (8 tensors of 128 * 512 * 64) plus lse.
//     f32:  21.5e9 / 164.9e12 = 0.130 ms vs 134.5 MB / 3.35e12 = 0.040 ms
//           -> bound by operations, 0.130 ms (0.321 ms at 67 TFLOP/s)
//     bf16: 21.5e9 / 989e12 = 0.0217 ms vs 67.4 MB / 3.35e12 = 0.020 ms
//           -> bound by operations, 0.0217 ms
//   As designed: dq 3 products (12.9 GFLOP), dkv 4 (17.2 GFLOP), 30.1 GFLOP
//   in all, 1.4x the function's work: bf16 0.030 ms at the tensor cores'
//   peak; f32 90.2 GFLOP of TF32 work, 0.18 ms at the TF32 peak. Under
//   causal, about half of every operation count.

#include <math.h>

#include "flash_attention_common.cuh"
#include "flash_attention_mma.cuh"
#include "flash_attention_tf32.cuh"

namespace {

using namespace ff_flash;

// ---- bf16 on the tensor cores ----------------------------------------------

namespace mma {

using ff_mma::bf16;

constexpr int kWarpRows = 16;  // rows of a warp's m16 tiles
constexpr float kLog2e = 1.4426950408889634f;

// dq kernel: 4 warps x 16 query rows; key tile 64, 32 at width 256 (dQ's
// 128 f32 accumulators a thread leave room for S and dP of 32 keys only).
constexpr int kDqBlockQ = 64;
constexpr int kDqThreads = 128;
template <int DP>
__host__ __device__ constexpr int dq_block_k() { return DP == 256 ? 32 : 64; }
// Blocks an SM must hold at once, for the compiler's register budget: at
// width 64 four dq blocks (<= 128 registers) and three dkv blocks (<= 168)
// fit without spilling and ran the pair 7 % faster than the registers the
// compiler picks unbounded (162 and 222, three and two blocks). Width 32
// takes the same budget: told one block, the compiler grew its instances
// from 119 / 160 registers to 150 / 174, a block fewer an SM each.
template <int DP>
__host__ __device__ constexpr int dq_min_blocks() { return DP <= 64 ? 4 : 1; }
template <int DP>
__host__ __device__ constexpr int dkv_min_blocks() { return DP <= 64 ? 3 : 1; }

// dkv kernel: 4 x dkv_split warps over 64 key rows, each warp pair splitting
// the dK/dV columns from width 128 (a thread's 128 f32 accumulators of dK and
// dV at width 128 spilled); query tile 64 up to width 64, 32 above.
constexpr int kDkvBlockK = 64;
template <int DP>
__host__ __device__ constexpr int dkv_split() { return DP >= 128 ? 2 : 1; }
template <int DP>
__host__ __device__ constexpr int dkv_threads() { return 128 * dkv_split<DP>(); }
template <int DP>
__host__ __device__ constexpr int dkv_block_q() { return DP <= 64 ? 64 : 32; }

template <int DP>
constexpr size_t dq_smem_bytes() {
  // Q, dO; two stages of K, V; delta of the block's rows
  return sizeof(bf16) * (size_t)(2 * kDqBlockQ + 4 * dq_block_k<DP>()) * ff_mma::kTileLd<DP> +
         sizeof(float) * kDqBlockQ;
}

template <int DP>
constexpr size_t dkv_smem_bytes() {
  // K, V; two stages of Q, dO; two stages of lse, delta
  return sizeof(bf16) * (size_t)(2 * kDkvBlockK + 4 * dkv_block_q<DP>()) * ff_mma::kTileLd<DP> +
         sizeof(float) * 4 * dkv_block_q<DP>();
}

template <int DP>
__global__ void __launch_bounds__(kDqThreads, dq_min_blocks<DP>())
flash_bwd_dq_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ o,
                        const bf16* __restrict__ g, const float* __restrict__ lse,
                        float* __restrict__ delta, bf16* __restrict__ dq, int sq, int skv,
                        int d, float scale, int causal, int vec) {
  constexpr int BQ = kDqBlockQ, BK = dq_block_k<DP>(), LD = ff_mma::kTileLd<DP>;
  constexpr int NK = BK / 8, ND = DP / 8;  // n8 tiles of S/dP and of dQ
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* qs = reinterpret_cast<bf16*>(mma_smem);  // [BQ][LD]
  bf16* gs = qs + BQ * LD;                       // [BQ][LD], dO
  bf16* kvs = gs + BQ * LD;                      // [2 stages][K, V][BK][LD]
  float* deltas = reinterpret_cast<float*>(kvs + 4 * BK * LD);  // [BQ]

  // blocks go tile-major: the last query tiles of every bh, which carry the
  // most causal work, start first
  const int nq = (sq + BQ - 1) / BQ;
  const int nbh = gridDim.x / nq;
  const int bh = blockIdx.x % nbh;
  const int q0 = (nq - 1 - (int)(blockIdx.x / nbh)) * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = lane >> 2, tig = lane & 3, rw = warp * kWarpRows;
  const size_t qoff = (size_t)bh * sq * d, koff = (size_t)bh * skv * d;
  const int kv_end = causal ? min(skv, q0 + BQ) : skv;
  const int ntiles = (kv_end + BK - 1) / BK;

  // Q, dO, the first K/V stage, and O into the second stage (2 BK >= BQ
  // rows), which the loop's first prefetch overwrites after delta is taken
  bf16* os = kvs + 2 * BK * LD;
  ff_mma::load_tile<BQ, DP, kDqThreads>(qs, q + qoff, q0, sq, d, vec);
  ff_mma::load_tile<BQ, DP, kDqThreads>(gs, g + qoff, q0, sq, d, vec);
  ff_mma::load_tile<BK, DP, kDqThreads>(kvs, k + koff, 0, skv, d, vec);
  ff_mma::load_tile<BK, DP, kDqThreads>(kvs + BK * LD, v + koff, 0, skv, d, vec);
  ff_mma::load_tile<BQ, DP, kDqThreads>(os, o + qoff, q0, sq, d, vec);
  ff_mma::cp_async_commit();
  ff_mma::cp_async_wait<0>();
  __syncthreads();

  // delta = rowsum(dO * O) in f32 for the warp's rows, two lanes a row
  {
    const int r = rw + lane / 2, c0 = (lane & 1) * (DP / 2);
    float sum = 0.f;
#pragma unroll 8
    for (int c = c0; c < c0 + DP / 2; c += 2) {
      const float2 gv =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gs + r * LD + c));
      const float2 ov =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(os + r * LD + c));
      sum = fmaf(gv.x, ov.x, fmaf(gv.y, ov.y, sum));
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((lane & 1) == 0) {
      deltas[r] = sum;
      if (q0 + r < sq) delta[(size_t)bh * sq + q0 + r] = sum;
    }
  }
  __syncthreads();  // delta is in; O's stage may be refilled
  const int row_lo = q0 + rw + group, row_hi = row_lo + 8;
  const float lse_lo = row_lo < sq ? lse[(size_t)bh * sq + row_lo] * kLog2e : 0.f;
  const float lse_hi = row_hi < sq ? lse[(size_t)bh * sq + row_hi] * kLog2e : 0.f;
  const float dl_lo = deltas[rw + group], dl_hi = deltas[rw + group + 8];
  const float scale_log2 = scale * kLog2e;

  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BK;
    if (j + 1 < ntiles) {
      bf16* next = kvs + ((j + 1) & 1) * 2 * BK * LD;
      ff_mma::load_tile<BK, DP, kDqThreads>(next, k + koff, k0 + BK, skv, d, vec);
      ff_mma::load_tile<BK, DP, kDqThreads>(next + BK * LD, v + koff, k0 + BK, skv, d, vec);
    }
    ff_mma::cp_async_commit();
    ff_mma::cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    const bf16* ks = kvs + (j & 1) * 2 * BK * LD;
    const bf16* vs = ks + BK * LD;

    // S = Q K^T, dP = dO V^T for the warp's 16 rows x BK keys
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int i = 0; i < NK; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t aq[4], ag[4];
      const int a_off = (rw + ff_mma::a_row(lane)) * LD + kk * 16 + ff_mma::a_col(lane);
      ff_mma::ldmatrix_x4(aq, qs + a_off);
      ff_mma::ldmatrix_x4(ag, gs + a_off);
#pragma unroll
      for (int n2 = 0; n2 < BK / 16; ++n2) {
        uint32_t bk[4], bv[4];
        const int b_off = (n2 * 16 + ff_mma::bn_row(lane)) * LD + kk * 16 + ff_mma::bn_col(lane);
        ff_mma::ldmatrix_x4(bk, ks + b_off);
        ff_mma::ldmatrix_x4(bv, vs + b_off);
        ff_mma::mma_bf16(s[2 * n2], aq, bk[0], bk[1]);
        ff_mma::mma_bf16(s[2 * n2 + 1], aq, bk[2], bk[3]);
        ff_mma::mma_bf16(dp[2 * n2], ag, bv[0], bv[1]);
        ff_mma::mma_bf16(dp[2 * n2 + 1], ag, bv[2], bv[3]);
      }
    }

    // dS = P * (dP - delta) in f32, masked entries exactly 0, into dp
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row_lo : row_hi;
        const int key = k0 + nt * 8 + 2 * tig + (e & 1);
        const bool live = key < skv && row < sq && !(causal && row < key);
        const float p = live ? exp2f(fmaf(s[nt][e], scale_log2, -(e < 2 ? lse_lo : lse_hi)))
                             : 0.f;
        dp[nt][e] = p * (dp[nt][e] - (e < 2 ? dl_lo : dl_hi));
      }

    // dQ += dS K: dS as bf16 A fragments from registers, K by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ads[4];
      ff_mma::acc_a2(ads, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int d2 = 0; d2 < DP / 16; ++d2) {
        uint32_t b[4];
        ff_mma::ldmatrix_x4_trans(
            b, ks + (kk * 16 + ff_mma::bk_row(lane)) * LD + d2 * 16 + ff_mma::bk_col(lane));
        ff_mma::mma_bf16(acc[2 * d2], ads, b[0], b[1]);
        ff_mma::mma_bf16(acc[2 * d2 + 1], ads, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage's reads are done before it is refilled
  }
  ff_mma::cp_async_wait<0>();

  // dQ * scale through the Q tile (each warp rewrites only its own rows)
  ff_mma::stage_acc<DP>(qs, acc, rw, 0, scale);
  __syncthreads();
  ff_mma::store_tile<BQ, DP, kDqThreads>(dq + qoff, qs, q0, sq, d, vec);
}

template <int DP>
__global__ void __launch_bounds__(dkv_threads<DP>(), dkv_min_blocks<DP>())
flash_bwd_dkv_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ g,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int skv, int d,
                         float scale, int causal, int vec) {
  constexpr int BK = kDkvBlockK, BQ = dkv_block_q<DP>(), LD = ff_mma::kTileLd<DP>;
  constexpr int THREADS = dkv_threads<DP>();
  constexpr int DW = DP / dkv_split<DP>();  // dK/dV columns a warp owns
  constexpr int NQ = BQ / 8, ND = DW / 8;   // n8 tiles of S^T/dP^T and of dK/dV
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* ks = reinterpret_cast<bf16*>(mma_smem);  // [BK][LD]
  bf16* vs = ks + BK * LD;                       // [BK][LD]
  bf16* qgs = vs + BK * LD;                      // [2 stages][Q, dO][BQ][LD]
  float* vecs = reinterpret_cast<float*>(qgs + 4 * BQ * LD);  // [2 stages][lse, delta][BQ]

  // blocks go tile-major: the first key tiles of every bh, which carry the
  // most causal work, start first
  const int nk = (skv + BK - 1) / BK;
  const int nbh = gridDim.x / nk;
  const int bh = blockIdx.x % nbh;
  const int k0 = (int)(blockIdx.x / nbh) * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = lane >> 2, tig = lane & 3;
  const int rw = (warp & 3) * kWarpRows, cw = (warp >> 2) * DW;
  const size_t qoff = (size_t)bh * sq * d, koff = (size_t)bh * skv * d;
  const float* lseb = lse + (size_t)bh * sq;
  const float* deltab = delta + (size_t)bh * sq;
  const int qstart = causal ? (k0 / BQ) * BQ : 0;
  const int ntiles = qstart < sq ? (sq - qstart + BQ - 1) / BQ : 0;

  auto load_q_tile = [&](int stage, int q0) {
    bf16* qt = qgs + stage * 2 * BQ * LD;
    ff_mma::load_tile<BQ, DP, THREADS>(qt, q + qoff, q0, sq, d, vec);
    ff_mma::load_tile<BQ, DP, THREADS>(qt + BQ * LD, g + qoff, q0, sq, d, vec);
    ff_mma::load_vec<THREADS>(vecs + stage * 2 * BQ, lseb, q0, BQ, sq);
    ff_mma::load_vec<THREADS>(vecs + stage * 2 * BQ + BQ, deltab, q0, BQ, sq);
  };
  ff_mma::load_tile<BK, DP, THREADS>(ks, k + koff, k0, skv, d, vec);
  ff_mma::load_tile<BK, DP, THREADS>(vs, v + koff, k0, skv, d, vec);
  if (ntiles > 0) load_q_tile(0, qstart);
  ff_mma::cp_async_commit();

  const int key_lo = k0 + rw + group, key_hi = key_lo + 8;
  const float scale_log2 = scale * kLog2e;
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int q0 = qstart + j * BQ;
    if (j + 1 < ntiles) load_q_tile((j + 1) & 1, q0 + BQ);
    ff_mma::cp_async_commit();
    ff_mma::cp_async_wait<1>();  // this tile (and K, V) have landed
    __syncthreads();
    const bf16* qs = qgs + (j & 1) * 2 * BQ * LD;
    const bf16* gs = qs + BQ * LD;
    const float* lses = vecs + (j & 1) * 2 * BQ;
    const float* dels = lses + BQ;

    // S^T = K Q^T, dP^T = V dO^T for the warp's 16 keys x BQ queries
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t ak[4], av[4];
      const int a_off = (rw + ff_mma::a_row(lane)) * LD + kk * 16 + ff_mma::a_col(lane);
      ff_mma::ldmatrix_x4(ak, ks + a_off);
      ff_mma::ldmatrix_x4(av, vs + a_off);
#pragma unroll
      for (int n2 = 0; n2 < BQ / 16; ++n2) {
        uint32_t bq[4], bg[4];
        const int b_off = (n2 * 16 + ff_mma::bn_row(lane)) * LD + kk * 16 + ff_mma::bn_col(lane);
        ff_mma::ldmatrix_x4(bq, qs + b_off);
        ff_mma::ldmatrix_x4(bg, gs + b_off);
        ff_mma::mma_bf16(st[2 * n2], ak, bq[0], bq[1]);
        ff_mma::mma_bf16(st[2 * n2 + 1], ak, bq[2], bq[3]);
        ff_mma::mma_bf16(dpt[2 * n2], av, bg[0], bg[1]);
        ff_mma::mma_bf16(dpt[2 * n2 + 1], av, bg[2], bg[3]);
      }
    }

    // P^T into st, dS^T = P^T * (dP^T - delta) into dpt, masked entries 0
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
      const int qc = nt * 8 + 2 * tig;
      const float2 l2 = *reinterpret_cast<const float2*>(lses + qc);
      const float2 dl = *reinterpret_cast<const float2*>(dels + qc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = e < 2 ? key_lo : key_hi;
        const int qi = q0 + qc + (e & 1);
        const bool live = qi < sq && key < skv && !(causal && qi < key);
        const float p = live ? exp2f(fmaf(st[nt][e], scale_log2,
                                          -((e & 1) ? l2.y : l2.x) * kLog2e))
                             : 0.f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - ((e & 1) ? dl.y : dl.x));
      }
    }

    // dV += P^T dO, dK += dS^T Q over the warp's columns; dO and Q by
    // ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t ap[4], ads[4];
      ff_mma::acc_a2(ap, st[2 * kk], st[2 * kk + 1]);
      ff_mma::acc_a2(ads, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int d2 = 0; d2 < DW / 16; ++d2) {
        uint32_t bg[4], bq[4];
        const int b_off =
            (kk * 16 + ff_mma::bk_row(lane)) * LD + cw + d2 * 16 + ff_mma::bk_col(lane);
        ff_mma::ldmatrix_x4_trans(bg, gs + b_off);
        ff_mma::ldmatrix_x4_trans(bq, qs + b_off);
        ff_mma::mma_bf16(dva[2 * d2], ap, bg[0], bg[1]);
        ff_mma::mma_bf16(dva[2 * d2 + 1], ap, bg[2], bg[3]);
        ff_mma::mma_bf16(dka[2 * d2], ads, bq[0], bq[1]);
        ff_mma::mma_bf16(dka[2 * d2 + 1], ads, bq[2], bq[3]);
      }
    }
    __syncthreads();  // this stage's reads are done before it is refilled
  }
  ff_mma::cp_async_wait<0>();  // K and V too, when no query tile ran
  __syncthreads();

  // dK * scale and dV through the K and V tiles
  ff_mma::stage_acc<DP>(ks, dka, rw, cw, scale);
  ff_mma::stage_acc<DP>(vs, dva, rw, cw, 1.f);
  __syncthreads();
  ff_mma::store_tile<BK, DP, THREADS>(dk + koff, ks, k0, skv, d, vec);
  ff_mma::store_tile<BK, DP, THREADS>(dv + koff, vs, k0, skv, d, vec);
}

template <int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o,
                      const void* g, const void* lse, void* delta, void* dq, int bh, int sq,
                      int skv, int d, float scale, int causal, cudaStream_t stream) {
  const unsigned blocks = grid_blocks(bh, sq, kDqBlockQ);
  if (blocks == 0) return cudaErrorInvalidValue;
  constexpr size_t smem = dq_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel_mma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int vec = d % 8 == 0 && ff_mma::aligned16(q) && ff_mma::aligned16(k) &&
                  ff_mma::aligned16(v) && ff_mma::aligned16(o) && ff_mma::aligned16(g) &&
                  ff_mma::aligned16(dq);
  flash_bwd_dq_kernel_mma<DP><<<blocks, kDqThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(g),
      static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<bf16*>(dq), sq,
      skv, d, scale, causal, vec);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* g,
                       const void* lse, const void* delta, void* dk, void* dv, int bh, int sq,
                       int skv, int d, float scale, int causal, cudaStream_t stream) {
  const unsigned blocks = grid_blocks(bh, skv, kDkvBlockK);
  if (blocks == 0) return cudaErrorInvalidValue;
  constexpr size_t smem = dkv_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel_mma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int vec = d % 8 == 0 && ff_mma::aligned16(q) && ff_mma::aligned16(k) &&
                  ff_mma::aligned16(v) && ff_mma::aligned16(g) && ff_mma::aligned16(dk) &&
                  ff_mma::aligned16(dv);
  flash_bwd_dkv_kernel_mma<DP><<<blocks, dkv_threads<DP>(), smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq,
      skv, d, scale, causal, vec);
  return cudaGetLastError();
}

cudaError_t dispatch_dq(const void* q, const void* k, const void* v, const void* o,
                        const void* g, const void* lse, void* delta, void* dq, int bh, int sq,
                        int skv, int d, float scale, int causal, cudaStream_t s) {
  switch (padded_head_dim(d)) {
    case 32: return launch_dq<32>(q, k, v, o, g, lse, delta, dq, bh, sq, skv, d, scale, causal, s);
    case 64: return launch_dq<64>(q, k, v, o, g, lse, delta, dq, bh, sq, skv, d, scale, causal, s);
    case 128: return launch_dq<128>(q, k, v, o, g, lse, delta, dq, bh, sq, skv, d, scale, causal, s);
    case 256: return launch_dq<256>(q, k, v, o, g, lse, delta, dq, bh, sq, skv, d, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_dkv(const void* q, const void* k, const void* v, const void* g,
                         const void* lse, const void* delta, void* dk, void* dv, int bh,
                         int sq, int skv, int d, float scale, int causal, cudaStream_t s) {
  switch (padded_head_dim(d)) {
    case 32: return launch_dkv<32>(q, k, v, g, lse, delta, dk, dv, bh, sq, skv, d, scale, causal, s);
    case 64: return launch_dkv<64>(q, k, v, g, lse, delta, dk, dv, bh, sq, skv, d, scale, causal, s);
    case 128: return launch_dkv<128>(q, k, v, g, lse, delta, dk, dv, bh, sq, skv, d, scale, causal, s);
    case 256: return launch_dkv<256>(q, k, v, g, lse, delta, dk, dv, bh, sq, skv, d, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mma

// ---- f32 on the tensor cores, split TF32 ------------------------------------

namespace tf32 {

using ff_tf32::Split;
using ff_tf32::frag_a;
using ff_tf32::frag_b_krows;
using ff_tf32::frag_b_nrows;
using ff_tf32::mma3;

constexpr int kWarpRows = 16;  // rows of a warp's m16 tiles
constexpr float kLog2e = 1.4426950408889634f;

// dq kernel: 4 warps x 16 query rows; key tile 64 at width 32, 32 at 64
// and 128, 16 at 256, so that Q, dO and two K/V stages fit in shared
// memory, three blocks an SM at width 64. Chosen among variants timed on
// the H100 at the slice shape (with cvt.rna splits): at width 64 the
// 32-key tile, three blocks an SM and the S/dP loop over D left rolled ran
// dq in 0.351 ms against 0.381-0.392 for the 64-key tile; at width 128 a
// bound of one block an SM ran 0.93 ms against 1.30 unbounded.
constexpr int kDqBlockQ = 64;
constexpr int kDqThreads = 128;
template <int DP>
__host__ __device__ constexpr int dq_block_k() { return DP <= 32 ? 64 : DP <= 128 ? 32 : 16; }
template <int DP>
__host__ __device__ constexpr int dq_min_blocks() { return DP == 64 ? 3 : 1; }

// dkv kernel: 4 x dkv_split warps over 64 key rows, each warp pair
// splitting the dK/dV columns from width 128; query tile 64 up to width
// 64, 32 at 128 and 16 at 256 (halved, they ran 0.398 ms against 0.360
// at width 64). Its S^T/dP^T loop over D is left rolled: fully unrolled it
// spilled 24-96 bytes at widths 32 to 128 and ran 0.548 ms against
// 0.459-0.465 at width 64 (with cvt.rna splits); unrolled by two it ran
// as fast at width 64 and slower at 32 and 128.
constexpr int kDkvBlockK = 64;
template <int DP>
__host__ __device__ constexpr int dkv_split() { return DP >= 128 ? 2 : 1; }
template <int DP>
__host__ __device__ constexpr int dkv_threads() { return 128 * dkv_split<DP>(); }
template <int DP>
__host__ __device__ constexpr int dkv_block_q() { return DP <= 64 ? 64 : DP == 128 ? 32 : 16; }

template <int DP>
constexpr size_t dq_smem_bytes() {
  // Q, dO; two stages of K, V
  return sizeof(float) * (size_t)(2 * kDqBlockQ + 4 * dq_block_k<DP>()) * ff_tf32::kTileLd<DP>;
}

template <int DP>
constexpr size_t dkv_smem_bytes() {
  // K, V; two stages of Q, dO; two stages of lse, delta
  return sizeof(float) * ((size_t)(2 * kDkvBlockK + 4 * dkv_block_q<DP>()) * ff_tf32::kTileLd<DP> +
                          4 * dkv_block_q<DP>());
}

template <int DP>
__global__ void __launch_bounds__(kDqThreads, dq_min_blocks<DP>())
flash_bwd_dq_kernel_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ o,
                           const float* __restrict__ g, const float* __restrict__ lse,
                           float* __restrict__ delta, float* __restrict__ dq, int sq, int skv,
                           int d, float scale, int causal, int vec) {
  constexpr int BQ = kDqBlockQ, BK = dq_block_k<DP>(), LD = ff_tf32::kTileLd<DP>;
  constexpr int NK = BK / 8, ND = DP / 8;  // n8 tiles of S/dP and of dQ
  extern __shared__ __align__(16) unsigned char tf32_smem[];
  float* qs = reinterpret_cast<float*>(tf32_smem);  // [BQ][LD]
  float* gs = qs + BQ * LD;                          // [BQ][LD], dO
  float* kvs = gs + BQ * LD;                         // [2 stages][K, V][BK][LD]

  // blocks go tile-major: the last query tiles of every bh, which carry the
  // most causal work, start first
  const int nq = (sq + BQ - 1) / BQ;
  const int nbh = gridDim.x / nq;
  const int bh = blockIdx.x % nbh;
  const int q0 = (nq - 1 - (int)(blockIdx.x / nbh)) * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = lane >> 2, tig = lane & 3, rw = warp * kWarpRows;
  const size_t qoff = (size_t)bh * sq * d, koff = (size_t)bh * skv * d;
  const int kv_end = causal ? min(skv, q0 + BQ) : skv;
  const int ntiles = (kv_end + BK - 1) / BK;

  ff_tf32::load_tile<BQ, DP, kDqThreads>(qs, q + qoff, q0, sq, d, vec);
  ff_tf32::load_tile<BQ, DP, kDqThreads>(gs, g + qoff, q0, sq, d, vec);
  ff_tf32::load_tile<BK, DP, kDqThreads>(kvs, k + koff, 0, skv, d, vec);
  ff_tf32::load_tile<BK, DP, kDqThreads>(kvs + BK * LD, v + koff, 0, skv, d, vec);
  ff_mma::cp_async_commit();
  ff_mma::cp_async_wait<0>();
  __syncthreads();

  // delta = rowsum(dO * O) in f32 for the warp's rows, two lanes a row (O
  // read once, from device memory); each thread then takes the deltas of
  // its fragment rows group and group + 8 from the lanes that own them
  float dl_lo, dl_hi;
  {
    const int r = rw + lane / 2, row = q0 + r, c0 = (lane & 1) * (DP / 2);
    float sum = 0.f;
    if (row < sq) {
      const float* orow = o + qoff + (size_t)row * d;
#pragma unroll 8
      for (int c = c0; c < c0 + DP / 2; ++c)
        if (c < d) sum = fmaf(gs[r * LD + c], orow[c], sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((lane & 1) == 0 && row < sq) delta[(size_t)bh * sq + row] = sum;
    dl_lo = __shfl_sync(0xffffffffu, sum, 2 * group);
    dl_hi = __shfl_sync(0xffffffffu, sum, 2 * group + 16);
  }
  const int row_lo = q0 + rw + group, row_hi = row_lo + 8;
  const float lse_lo = row_lo < sq ? lse[(size_t)bh * sq + row_lo] * kLog2e : 0.f;
  const float lse_hi = row_hi < sq ? lse[(size_t)bh * sq + row_hi] * kLog2e : 0.f;
  const float scale_log2 = scale * kLog2e;

  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BK;
    if (j + 1 < ntiles) {
      float* next = kvs + ((j + 1) & 1) * 2 * BK * LD;
      ff_tf32::load_tile<BK, DP, kDqThreads>(next, k + koff, k0 + BK, skv, d, vec);
      ff_tf32::load_tile<BK, DP, kDqThreads>(next + BK * LD, v + koff, k0 + BK, skv, d, vec);
    }
    ff_mma::cp_async_commit();
    ff_mma::cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    const float* ks = kvs + (j & 1) * 2 * BK * LD;
    const float* vs = ks + BK * LD;

    // S = Q K^T, dP = dO V^T for the warp's 16 rows x BK keys
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int i = 0; i < NK; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll 1  // rolled: faster, see dq_block_k
    for (int kk = 0; kk < DP / 8; ++kk) {
      const Split<4> aq = frag_a<LD>(qs, rw, kk * 8);
      const Split<4> ag = frag_a<LD>(gs, rw, kk * 8);
#pragma unroll
      for (int nt = 0; nt < NK; ++nt) {
        mma3(s[nt], aq, frag_b_nrows<LD>(ks, nt * 8, kk * 8));
        mma3(dp[nt], ag, frag_b_nrows<LD>(vs, nt * 8, kk * 8));
      }
    }

    // dS = P * (dP - delta) in f32, masked entries exactly 0, into dp
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row_lo : row_hi;
        const int key = k0 + nt * 8 + 2 * tig + (e & 1);
        const bool live = key < skv && row < sq && !(causal && row < key);
        const float p = live ? exp2f(fmaf(s[nt][e], scale_log2, -(e < 2 ? lse_lo : lse_hi)))
                             : 0.f;
        dp[nt][e] = p * (dp[nt][e] - (e < 2 ? dl_lo : dl_hi));
      }

    // dQ += dS K: each n8 tile of dS is the A fragment of one k8 step,
    // relabelled, and K's B fragment is read at the matching key rows
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const Split<4> ads = ff_tf32::acc_a(dp[kk]);
#pragma unroll
      for (int dt = 0; dt < ND; ++dt) mma3(acc[dt], ads, frag_b_krows<LD>(ks, kk * 8, dt * 8));
    }
    __syncthreads();  // this stage's reads are done before it is refilled
  }
  ff_mma::cp_async_wait<0>();

  // dQ * scale through the Q tile (each warp rewrites only its own rows)
  ff_tf32::stage_acc<DP>(qs, acc, rw, 0, scale);
  __syncthreads();
  ff_tf32::store_tile<BQ, DP, kDqThreads>(dq + qoff, qs, q0, sq, d, vec);
}

template <int DP>
__global__ void __launch_bounds__(dkv_threads<DP>())
flash_bwd_dkv_kernel_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ g,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv, int sq, int skv,
                            int d, float scale, int causal, int vec) {
  constexpr int BK = kDkvBlockK, BQ = dkv_block_q<DP>(), LD = ff_tf32::kTileLd<DP>;
  constexpr int THREADS = dkv_threads<DP>();
  constexpr int DW = DP / dkv_split<DP>();  // dK/dV columns a warp owns
  constexpr int NQ = BQ / 8, ND = DW / 8;   // n8 tiles of S^T/dP^T and of dK/dV
  extern __shared__ __align__(16) unsigned char tf32_smem[];
  float* ks = reinterpret_cast<float*>(tf32_smem);  // [BK][LD]
  float* vs = ks + BK * LD;                          // [BK][LD]
  float* qgs = vs + BK * LD;                         // [2 stages][Q, dO][BQ][LD]
  float* vecs = qgs + 4 * BQ * LD;                   // [2 stages][lse, delta][BQ]

  // blocks go tile-major: the first key tiles of every bh, which carry the
  // most causal work, start first
  const int nk = (skv + BK - 1) / BK;
  const int nbh = gridDim.x / nk;
  const int bh = blockIdx.x % nbh;
  const int k0 = (int)(blockIdx.x / nbh) * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = lane >> 2, tig = lane & 3;
  const int rw = (warp & 3) * kWarpRows, cw = (warp >> 2) * DW;
  const size_t qoff = (size_t)bh * sq * d, koff = (size_t)bh * skv * d;
  const float* lseb = lse + (size_t)bh * sq;
  const float* deltab = delta + (size_t)bh * sq;
  const int qstart = causal ? (k0 / BQ) * BQ : 0;
  const int ntiles = qstart < sq ? (sq - qstart + BQ - 1) / BQ : 0;

  auto load_q_tile = [&](int stage, int q0) {
    float* qt = qgs + stage * 2 * BQ * LD;
    ff_tf32::load_tile<BQ, DP, THREADS>(qt, q + qoff, q0, sq, d, vec);
    ff_tf32::load_tile<BQ, DP, THREADS>(qt + BQ * LD, g + qoff, q0, sq, d, vec);
    ff_mma::load_vec<THREADS>(vecs + stage * 2 * BQ, lseb, q0, BQ, sq);
    ff_mma::load_vec<THREADS>(vecs + stage * 2 * BQ + BQ, deltab, q0, BQ, sq);
  };
  ff_tf32::load_tile<BK, DP, THREADS>(ks, k + koff, k0, skv, d, vec);
  ff_tf32::load_tile<BK, DP, THREADS>(vs, v + koff, k0, skv, d, vec);
  if (ntiles > 0) load_q_tile(0, qstart);
  ff_mma::cp_async_commit();

  const int key_lo = k0 + rw + group, key_hi = key_lo + 8;
  const float scale_log2 = scale * kLog2e;
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int q0 = qstart + j * BQ;
    if (j + 1 < ntiles) load_q_tile((j + 1) & 1, q0 + BQ);
    ff_mma::cp_async_commit();
    ff_mma::cp_async_wait<1>();  // this tile (and K, V) have landed
    __syncthreads();
    const float* qs = qgs + (j & 1) * 2 * BQ * LD;
    const float* gs = qs + BQ * LD;
    const float* lses = vecs + (j & 1) * 2 * BQ;
    const float* dels = lses + BQ;

    // S^T = K Q^T, dP^T = V dO^T for the warp's 16 keys x BQ queries
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.f;
#pragma unroll 1  // rolled: no spill, see dkv_block_q
    for (int kk = 0; kk < DP / 8; ++kk) {
      const Split<4> ak = frag_a<LD>(ks, rw, kk * 8);
      const Split<4> av = frag_a<LD>(vs, rw, kk * 8);
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt) {
        mma3(st[nt], ak, frag_b_nrows<LD>(qs, nt * 8, kk * 8));
        mma3(dpt[nt], av, frag_b_nrows<LD>(gs, nt * 8, kk * 8));
      }
    }

    // P^T into st, dS^T = P^T * (dP^T - delta) into dpt, masked entries 0
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
      const int qc = nt * 8 + 2 * tig;
      const float2 l2 = *reinterpret_cast<const float2*>(lses + qc);
      const float2 dl = *reinterpret_cast<const float2*>(dels + qc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = e < 2 ? key_lo : key_hi;
        const int qi = q0 + qc + (e & 1);
        const bool live = qi < sq && key < skv && !(causal && qi < key);
        const float p = live ? exp2f(fmaf(st[nt][e], scale_log2,
                                          -((e & 1) ? l2.y : l2.x) * kLog2e))
                             : 0.f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - ((e & 1) ? dl.y : dl.x));
      }
    }

    // dV += P^T dO, dK += dS^T Q over the warp's columns: each n8 tile of
    // P^T and dS^T is the A fragment of one k8 step, relabelled, and dO's
    // and Q's B fragments are read at the matching query rows
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk) {
      const Split<4> ap = ff_tf32::acc_a(st[kk]);
      const Split<4> ads = ff_tf32::acc_a(dpt[kk]);
#pragma unroll
      for (int dt = 0; dt < ND; ++dt) {
        mma3(dva[dt], ap, frag_b_krows<LD>(gs, kk * 8, cw + dt * 8));
        mma3(dka[dt], ads, frag_b_krows<LD>(qs, kk * 8, cw + dt * 8));
      }
    }
    __syncthreads();  // this stage's reads are done before it is refilled
  }
  ff_mma::cp_async_wait<0>();  // K and V too, when no query tile ran
  __syncthreads();

  // dK * scale and dV through the K and V tiles
  ff_tf32::stage_acc<DP>(ks, dka, rw, cw, scale);
  ff_tf32::stage_acc<DP>(vs, dva, rw, cw, 1.f);
  __syncthreads();
  ff_tf32::store_tile<BK, DP, THREADS>(dk + koff, ks, k0, skv, d, vec);
  ff_tf32::store_tile<BK, DP, THREADS>(dv + koff, vs, k0, skv, d, vec);
}

template <int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o,
                      const void* g, const void* lse, void* delta, void* dq, int bh, int sq,
                      int skv, int d, float scale, int causal, cudaStream_t stream) {
  const unsigned blocks = grid_blocks(bh, sq, kDqBlockQ);
  if (blocks == 0) return cudaErrorInvalidValue;
  constexpr size_t smem = dq_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel_tf32x3<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int vec = d % 4 == 0 && ff_mma::aligned16(q) && ff_mma::aligned16(k) &&
                  ff_mma::aligned16(v) && ff_mma::aligned16(g) && ff_mma::aligned16(dq);
  flash_bwd_dq_kernel_tf32x3<DP><<<blocks, kDqThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(o), static_cast<const float*>(g),
      static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<float*>(dq), sq,
      skv, d, scale, causal, vec);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* g,
                       const void* lse, const void* delta, void* dk, void* dv, int bh, int sq,
                       int skv, int d, float scale, int causal, cudaStream_t stream) {
  const unsigned blocks = grid_blocks(bh, skv, kDkvBlockK);
  if (blocks == 0) return cudaErrorInvalidValue;
  constexpr size_t smem = dkv_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel_tf32x3<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int vec = d % 4 == 0 && ff_mma::aligned16(q) && ff_mma::aligned16(k) &&
                  ff_mma::aligned16(v) && ff_mma::aligned16(g) && ff_mma::aligned16(dk) &&
                  ff_mma::aligned16(dv);
  flash_bwd_dkv_kernel_tf32x3<DP><<<blocks, dkv_threads<DP>(), smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), sq,
      skv, d, scale, causal, vec);
  return cudaGetLastError();
}

cudaError_t dispatch_dq(const void* q, const void* k, const void* v, const void* o,
                        const void* g, const void* lse, void* delta, void* dq, int bh, int sq,
                        int skv, int d, float scale, int causal, cudaStream_t s) {
  switch (padded_head_dim(d)) {
    case 32: return launch_dq<32>(q, k, v, o, g, lse, delta, dq, bh, sq, skv, d, scale, causal, s);
    case 64: return launch_dq<64>(q, k, v, o, g, lse, delta, dq, bh, sq, skv, d, scale, causal, s);
    case 128: return launch_dq<128>(q, k, v, o, g, lse, delta, dq, bh, sq, skv, d, scale, causal, s);
    case 256: return launch_dq<256>(q, k, v, o, g, lse, delta, dq, bh, sq, skv, d, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_dkv(const void* q, const void* k, const void* v, const void* g,
                         const void* lse, const void* delta, void* dk, void* dv, int bh,
                         int sq, int skv, int d, float scale, int causal, cudaStream_t s) {
  switch (padded_head_dim(d)) {
    case 32: return launch_dkv<32>(q, k, v, g, lse, delta, dk, dv, bh, sq, skv, d, scale, causal, s);
    case 64: return launch_dkv<64>(q, k, v, g, lse, delta, dk, dv, bh, sq, skv, d, scale, causal, s);
    case 128: return launch_dkv<128>(q, k, v, g, lse, delta, dk, dv, bh, sq, skv, d, scale, causal, s);
    case 256: return launch_dkv<256>(q, k, v, g, lse, delta, dk, dv, bh, sq, skv, d, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tf32

}  // namespace

extern "C" {

// dtype: 0 = float32 (the split-TF32 tensor-core kernels), 1 = bfloat16 (the
// bf16 tensor-core kernels). delta is a (BH, Sq) f32 buffer in both: the dq
// kernel writes rowsum(dO * O) into it and the dkv kernel, launched after it
// on the same stream, reads it. Each returns the cudaError_t of its launch.
int ff_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                              const void* o, const void* g, const void* lse, void* delta,
                              void* dq, int bh, int sq, int skv, int d, float scale,
                              int causal, int dtype, void* stream) {
  if (bh <= 0 || sq <= 0 || skv <= 0 || delta == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)tf32::dispatch_dq(q, k, v, o, g, lse, delta, dq, bh, sq, skv, d, scale, causal,
                                  s);
  if (dtype == 1)
    return (int)mma::dispatch_dq(q, k, v, o, g, lse, delta, dq, bh, sq, skv, d, scale, causal,
                                 s);
  return (int)cudaErrorInvalidValue;
}

int ff_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                               const void* o, const void* g, const void* lse,
                               const void* delta, void* dk, void* dv, int bh, int sq,
                               int skv, int d, float scale, int causal, int dtype,
                               void* stream) {
  (void)o;  // the dkv kernels read delta, never O
  if (bh <= 0 || sq <= 0 || skv <= 0 || delta == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)tf32::dispatch_dkv(q, k, v, g, lse, delta, dk, dv, bh, sq, skv, d, scale,
                                   causal, s);
  if (dtype == 1)
    return (int)mma::dispatch_dkv(q, k, v, g, lse, delta, dk, dv, bh, sq, skv, d, scale,
                                  causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
