// Flash-attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` (flexflow_tpu/kernels/flash_attention.py:43,
// launched by `_flash_fwd` at :347). For each (batch*head, query row):
//   O   = softmax(scale * Q K^T) V
//   LSE = m + log(l)                    (f32, natural log)
// Under `causal`, logits with qpos < kpos are set to -1e30, top-left aligned,
// as `_causal_mask` does. O is written in the input type.
//
// Layout: q (BH, Sq, D), k/v (BH, Skv, D), o (BH, Sq, D), lse (BH, 1, Sq), all
// contiguous. Any D up to 256 and any B*H: each kernel is built for a padded
// width of 32, 64, 128 or 256 with the columns past D zero, and blocks are
// numbered along the grid's x dimension only (flash_attention_common.cuh).
//
// Two kernels, one per input type.
//
// f32: `flash_fwd_kernel` on the CUDA cores (TF32 stays off). The TPU kernel
// holds a whole (Skv, D) K/V panel in 16 MB of VMEM and materialises a
// (block_q, Skv) logits tile. A Hopper block has at most 227 KB of shared
// memory, so this kernel streams K/V instead: one block of 256 threads per
// (bh, 64-query tile), a loop over 64-key tiles staged in shared memory as
// f32 (209 KB at the padded width 256, one block per SM there), and an online
// softmax (running max m, sum l and the output accumulator in f32 registers).
// Each thread owns 4 query rows x 4 key columns of the score tile and 4 rows x
// D/16 columns of the output; a row's 16 owners sit in one half-warp, so row
// max/sum reductions are 4 shuffles. Q/K/V rows are padded by one float so
// the column reads are free of bank conflicts; Q is scaled in f32 as it is
// staged. Keys past Skv are masked to -inf (their p is exactly 0).
//
// bf16: `flash_fwd_kernel_mma` on the tensor cores, the FlashAttention-2
// forward built from flash_attention_mma.cuh. 4 warps a block, 16 query rows
// a warp (64 a block). Q is staged once by cp.async; its A fragments are held
// in registers (DP/4 a thread) at widths 32 and 128 and re-read from its tile
// by ldmatrix at 64 and 256, where registers are short (q_in_registers). K
// and V come in 64-key tiles (32 at width 256) by 16-byte cp.async, two
// stages deep, so the next tile's copy overlaps this tile's products.
// S = Q K^T by mma.sync m16n8k16 with f32 sums, K's B fragments by ldmatrix;
// scale is applied to S in f32 (to the running max and the exponent: scale *
// log2e folded into one fmaf and the SFU's 2^x). The online softmax runs in
// f32 registers, a row's max over its 4 lanes by two shuffles; l sums the
// f32 p before any rounding; dead entries (keys past Skv, under causal keys
// past the row) get p = 0 by a select. P is rounded to bf16 and becomes the
// A fragment of O += P V straight from the accumulators (acc_a2), V's B
// fragments by ldmatrix.trans: P never touches shared memory. O / l is
// rounded to bf16 and leaves through the Q tile in 16-byte stores.
//
// Both kernels: causal blocks stop at the last key tile their rows can see,
// which skips only tiles whose every logit would be -1e30 and so contribute
// exactly 0; blocks with the most causal work start first; rows past Sq
// write nothing.
//
// Bound at the slice shape (B*H = 128, Sq = Skv = 512, D = 64, H100 SXM):
//   operations: 4 * 128 * 512 * 512 * 64 = 8.59 GFLOP (half under causal)
//   bytes:      q, k, v, o = 4 * 128 * 512 * 64 elements + lse (128 * 512 f32)
//   f32  (67 TFLOP/s CUDA cores; 3.35 TB/s): 8.59e9 / 67e12 = 0.128 ms vs
//        67.4 MB / 3.35e12 = 0.020 ms -> bound by operations, 0.128 ms
//   bf16 (989 TFLOP/s tensor cores): 8.59e9 / 989e12 = 0.0087 ms vs
//        33.8 MB / 3.35e12 = 0.0101 ms -> bound by bytes, 0.0101 ms
// mma.sync reaches a fraction of the tensor cores' peak (wgmma, TMA and warp
// specialisation are later work); chip_smoke.py measures how far each kernel
// sits from its bound.

#include <math.h>

#include "flash_attention_common.cuh"
#include "flash_attention_mma.cuh"

namespace {

using namespace ff_flash;

constexpr int kBlockQ = 64;    // query rows per block
constexpr int kBlockK = 64;    // keys per shared-memory tile
constexpr int kRows = kBlockQ / 16;  // query rows per thread
constexpr int kCols = kBlockK / 16;  // score columns per thread
constexpr float kMaskValue = -1e30f;  // the TPU kernel's NEG_INF

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(kBlockQ * (DP + 1) + 2 * kBlockK * (DP + 1) + kBlockQ * (kBlockK + 1));
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int skv, int d, float scale,
                 int causal) {
  constexpr int LD = DP + 1;        // padded row stride of the q/k/v tiles
  constexpr int LDP = kBlockK + 1;  // padded row stride of the p tile
  constexpr int DC = DP / 16;       // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                  // [kBlockQ][LD]
  float* ks = qs + kBlockQ * LD;     // [kBlockK][LD]
  float* vs = ks + kBlockK * LD;     // [kBlockK][LD]
  float* ps = vs + kBlockK * LD;     // [kBlockQ][LDP]

  const int nq = (sq + kBlockQ - 1) / kBlockQ;
  const int bh = blockIdx.x / nq;
  // the last query tiles carry the most causal work: start them first
  const int q0 = (nq - 1 - (int)(blockIdx.x % nq)) * kBlockQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const T* qb = q + (size_t)bh * sq * d;
  const T* kb = k + (size_t)bh * skv * d;
  const T* vb = v + (size_t)bh * skv * d;

  load_tile<T, DP, kBlockQ>(qs, qb, q0, sq, d, scale);

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  const int kv_end = causal ? min(skv, q0 + kBlockQ) : skv;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile's ks/vs/ps reads are done
    load_tile<T, DP, kBlockK>(ks, kb, k0, skv, d, 1.f);
    load_tile<T, DP, kBlockK>(vs, vb, k0, skv, d, 1.f);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int c = 0; c < DP; ++c) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= skv) {
          s[i][j] = -INFINITY;
        } else if (causal && qpos < kpos) {
          s[i][j] = kMaskValue;
        }
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // key k0 is in range, so mx is finite and so is m_new
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < kBlockK; ++c) {
      float pv[kRows], vv[DC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = vs[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sq) continue;
    T* orow = o + ((size_t)bh * sq + r) * d;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx + 16 * j;
      if (c < d) orow[c] = from_f32<T>(acc[i][j] / l[i]);
    }
    if (tx == 0) lse[(size_t)bh * sq + r] = m[i] + logf(l[i]);
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int sq, int skv, int d, float scale,
                   int causal, cudaStream_t stream) {
  const unsigned blocks = grid_blocks(bh, sq, kBlockQ);
  if (blocks == 0) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, DP><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      sq, skv, d, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v,
                              void* o, void* lse, int bh, int sq, int skv,
                              int d, float scale, int causal,
                              cudaStream_t stream) {
  switch (padded_head_dim(d)) {
    case 32: return launch<T, 32>(q, k, v, o, lse, bh, sq, skv, d, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, sq, skv, d, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, bh, sq, skv, d, scale, causal, stream);
    case 256: return launch<T, 256>(q, k, v, o, lse, bh, sq, skv, d, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---- bf16 on the tensor cores ----------------------------------------------

namespace mma {

using ff_mma::bf16;

constexpr int kBlockQ = 64;    // query rows a block: 4 warps x 16
constexpr int kThreads = 128;
constexpr int kWarpRows = 16;  // rows of a warp's m16 tiles
constexpr float kLog2e = 1.4426950408889634f;

// Key tile: 64, 32 at width 256 (O's 128 f32 accumulators a thread leave
// room for S of 32 keys only), as the dq kernel's (flash_attention_bwd.cu).
template <int DP>
__host__ __device__ constexpr int block_k() { return DP == 256 ? 32 : 64; }
// Q's A fragments stay in registers at widths 32 and 128. At 64 those 16
// registers are what spilled under the register budget of four blocks an SM
// (128 a thread), and re-reading Q by ldmatrix at each key tile ran faster
// on an H100 than three blocks an SM with Q in registers; at 256 O's
// accumulators leave no room.
template <int DP>
__host__ __device__ constexpr bool q_in_registers() { return DP == 32 || DP == 128; }
// Blocks an SM must hold at once, for the compiler's register budget: four
// at widths 32/64 (<= 128 registers), two at 128 (<= 255), one at 256.
template <int DP>
__host__ __device__ constexpr int min_blocks() { return DP <= 64 ? 4 : DP == 128 ? 2 : 1; }

// 2^x by the SFU's approximation (relative error about 2^-22, denormal
// results flushed to 0): one instruction where exp2f takes four, for each
// of the 1024 p of a warp's 64-key tile.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int DP>
constexpr size_t smem_bytes() {
  // Q; two stages of K, V
  return sizeof(bf16) * (size_t)(kBlockQ + 4 * block_k<DP>()) * ff_mma::kTileLd<DP>;
}

template <int DP>
__global__ void __launch_bounds__(kThreads, min_blocks<DP>())
flash_fwd_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int sq, int skv, int d, float scale,
                     int causal, int vec) {
  constexpr int BQ = kBlockQ, BK = block_k<DP>(), LD = ff_mma::kTileLd<DP>;
  constexpr int NK = BK / 8, ND = DP / 8, KD = DP / 16;  // n8 tiles of S, of O; k16 steps of D
  constexpr bool QREG = q_in_registers<DP>();
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* qs = reinterpret_cast<bf16*>(mma_smem);  // [BQ][LD]
  bf16* kvs = qs + BQ * LD;                      // [2 stages][K, V][BK][LD]

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

  // Q in a group of its own, so its fragments load while the first K/V
  // stage is still in flight
  ff_mma::load_tile<BQ, DP, kThreads>(qs, q + qoff, q0, sq, d, vec);
  ff_mma::cp_async_commit();
  ff_mma::load_tile<BK, DP, kThreads>(kvs, k + koff, 0, skv, d, vec);
  ff_mma::load_tile<BK, DP, kThreads>(kvs + BK * LD, v + koff, 0, skv, d, vec);
  ff_mma::cp_async_commit();
  ff_mma::cp_async_wait<1>();  // Q has landed
  __syncthreads();

  const int a_off = (rw + ff_mma::a_row(lane)) * LD + ff_mma::a_col(lane);
  uint32_t qf[QREG ? KD : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) ff_mma::ldmatrix_x4(qf[kk], qs + a_off + kk * 16);
  }

  // Row state of the thread's two rows (lo = group, hi = group + 8 of the
  // warp's 16): the running max of the raw logits q.k (scale > 0, so it is
  // the max of the scaled ones too) and the thread's part of the row sum,
  // whose 4 parts are added at the end.
  const int row_lo = q0 + rw + group, row_hi = row_lo + 8;
  const float scale_log2 = scale * kLog2e;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BK;
    if (j + 1 < ntiles) {
      bf16* next = kvs + ((j + 1) & 1) * 2 * BK * LD;
      ff_mma::load_tile<BK, DP, kThreads>(next, k + koff, k0 + BK, skv, d, vec);
      ff_mma::load_tile<BK, DP, kThreads>(next + BK * LD, v + koff, k0 + BK, skv, d, vec);
    }
    ff_mma::cp_async_commit();
    ff_mma::cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    const bf16* ks = kvs + (j & 1) * 2 * BK * LD;
    const bf16* vs = ks + BK * LD;

    // S = Q K^T for the warp's 16 rows x BK keys, f32
    float s[NK][4];
#pragma unroll
    for (int i = 0; i < NK; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      if constexpr (QREG) {
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = qf[kk][r];
      } else {
        ff_mma::ldmatrix_x4(a, qs + a_off + kk * 16);
      }
#pragma unroll
      for (int n2 = 0; n2 < BK / 16; ++n2) {
        uint32_t b[4];
        ff_mma::ldmatrix_x4(
            b, ks + (n2 * 16 + ff_mma::bn_row(lane)) * LD + kk * 16 + ff_mma::bn_col(lane));
        ff_mma::mma_bf16(s[2 * n2], a, b[0], b[1]);
        ff_mma::mma_bf16(s[2 * n2 + 1], a, b[2], b[3]);
      }
    }

    // A tile that reaches past Skv or past the warp's first row (the causal
    // diagonal) has dead entries: keys past Skv and, under causal, keys past
    // the row. They leave the row max as -inf and get p = 0 by a select.
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
    // old sums and accumulators rescaled by alpha = exp(scale (m_old - m_new))
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
    const float ms_lo = mx_lo == -INFINITY ? 0.f : mx_lo * scale_log2;
    const float ms_hi = mx_hi == -INFINITY ? 0.f : mx_hi * scale_log2;
    const float alpha_lo = exp2_approx(m_lo * scale_log2 - ms_lo);
    const float alpha_hi = exp2_approx(m_hi * scale_log2 - ms_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = exp2_approx(fmaf(s[nt][e], scale_log2, -(e < 2 ? ms_lo : ms_hi)));
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

    // O += P V: P rounded to bf16 as A fragments from registers, V by
    // ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ap[4];
      ff_mma::acc_a2(ap, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int d2 = 0; d2 < DP / 16; ++d2) {
        uint32_t b[4];
        ff_mma::ldmatrix_x4_trans(
            b, vs + (kk * 16 + ff_mma::bk_row(lane)) * LD + d2 * 16 + ff_mma::bk_col(lane));
        ff_mma::mma_bf16(acc[2 * d2], ap, b[0], b[1]);
        ff_mma::mma_bf16(acc[2 * d2 + 1], ap, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage's reads are done before it is refilled
  }
  ff_mma::cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = l_lo > 0.f ? 1.f / l_lo : 0.f;
  const float inv_hi = l_hi > 0.f ? 1.f / l_hi : 0.f;
  if (tig == 0) {
    float* lseb = lse + (size_t)bh * sq;
    if (row_lo < sq) lseb[row_lo] = m_lo * scale + logf(l_lo);
    if (row_hi < sq) lseb[row_hi] = m_hi * scale + logf(l_hi);
  }
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    acc[i][0] *= inv_lo;
    acc[i][1] *= inv_lo;
    acc[i][2] *= inv_hi;
    acc[i][3] *= inv_hi;
  }

  // O / l through the Q tile (each warp rewrites only its own rows)
  ff_mma::stage_acc<DP>(qs, acc, rw, 0, 1.f);
  __syncthreads();
  ff_mma::store_tile<BQ, DP, kThreads>(o + qoff, qs, q0, sq, d, vec);
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                   int sq, int skv, int d, float scale, int causal, cudaStream_t stream) {
  const unsigned blocks = grid_blocks(bh, sq, kBlockQ);
  if (blocks == 0) return cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel_mma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int vec = d % 8 == 0 && ff_mma::aligned16(q) && ff_mma::aligned16(k) &&
                  ff_mma::aligned16(v) && ff_mma::aligned16(o);
  flash_fwd_kernel_mma<DP><<<blocks, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), sq, skv, d, scale, causal, vec);
  return cudaGetLastError();
}

cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v, void* o, void* lse,
                              int bh, int sq, int skv, int d, float scale, int causal,
                              cudaStream_t s) {
  switch (padded_head_dim(d)) {
    case 32: return launch<32>(q, k, v, o, lse, bh, sq, skv, d, scale, causal, s);
    case 64: return launch<64>(q, k, v, o, lse, bh, sq, skv, d, scale, causal, s);
    case 128: return launch<128>(q, k, v, o, lse, bh, sq, skv, d, scale, causal, s);
    case 256: return launch<256>(q, k, v, o, lse, bh, sq, skv, d, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mma

}  // namespace

extern "C" {

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor-core
// kernel). Returns the cudaError_t of the launch.
int ff_flash_attention_fwd(const void* q, const void* k, const void* v,
                           void* o, void* lse, int bh, int sq, int skv, int d,
                           float scale, int causal, int dtype, void* stream) {
  if (bh <= 0 || sq <= 0 || skv <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_head_dim<float>(q, k, v, o, lse, bh, sq, skv, d, scale, causal, s);
  if (dtype == 1)
    return (int)mma::dispatch_head_dim(q, k, v, o, lse, bh, sq, skv, d, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

const char* ff_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
