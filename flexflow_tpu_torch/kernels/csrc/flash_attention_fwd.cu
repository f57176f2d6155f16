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
// Two kernels, one per input type, both on the tensor cores.
//
// f32: `flash_fwd_kernel_tf32x3`, the FlashAttention-2 forward with split
// TF32 products (flash_attention_tf32.cuh): each f32 product is three TF32
// `mma.sync` m16n8k8 products, small(a) big(b) + big(a) small(b) + big(a)
// big(b), which lands within a few f32 ulps of an f32 product; never one
// TF32 product, which misses the f32 tolerance. 4 warps a block, each
// owning 32 query rows (two m16 tiles, so that each K or V fragment a warp
// splits feeds two products) at widths 32 and 64, 16 rows at 128 and 256
// (warp_tiles). Q lands once by cp.async and is scaled in f32 and split
// into big and small TF32 tiles in shared memory, as the TPU kernel scales
// it (`q * scale`); its fragments are re-read at every key tile (held
// split in registers they would take 64 a thread at width 64). K and V
// come in by 16-byte cp.async, two stages deep, in tiles of block_k keys
// padded to kTileLd (conflict-free fragment reads), and are split as their
// fragments are read (splitting them once as each tile lands ran 1.2-1.7x
// slower on an H100, its tiles twice the bytes). Under
// causal a warp skips the key tiles past its last row. S = (scale Q) K^T
// has K's B fragments n-major (frag_b_nrows); the online softmax runs
// in f32 registers as in the bf16 kernel below (a row's max over its 4
// lanes by two shuffles, l summed over the f32 p, dead entries p = 0 by a
// select only in tiles that have them, 2^x by the SFU); P = exp(S - m)
// becomes the split A fragment of O += P V straight from the accumulators
// through the m16n8k8 relabelling (acc_a), V's B fragments k-major at rows
// 2 tig and 2 tig + 1 (frag_b_krows): P never touches shared memory. O / l
// leaves through the Q tile in 16-byte stores. Where d % 4 != 0 or a base
// is not 16-byte aligned, the same tiles are loaded and stored element by
// element.
//
// bf16: `flash_fwd_kernel_mma`, the same forward on bf16 `mma.sync`
// m16n8k16 (flash_attention_mma.cuh). Q is staged once by cp.async; its A
// fragments are held in registers (DP/4 a thread) at widths 32 and 128 and
// re-read from its tile by ldmatrix at 64 and 256, where registers are
// short (q_in_registers). K and V come in 64-key tiles (32 at width 256)
// by 16-byte cp.async, two stages deep. S = Q K^T with f32 sums, K's B
// fragments by ldmatrix; scale is applied to S in f32 (to the running max
// and the exponent: scale * log2e folded into one fmaf and the SFU's 2^x).
// P is rounded to bf16 and becomes the A fragment of O += P V straight from
// the accumulators (acc_a2), V's B fragments by ldmatrix.trans. O / l is
// rounded to bf16 and leaves through the Q tile in 16-byte stores.
//
// Both kernels: LSE = m + log(l) in f32 with the natural log (the backward
// kernels read it); causal blocks stop at the last key tile their rows can
// see, which skips only tiles whose every logit would be -1e30 and so
// contribute exactly 0; blocks with the most causal work start first; each
// block owns its output tile (no atomics: two runs agree bit for bit);
// rows past Sq write nothing.
//
// Bound at the slice shape (B*H = 128, Sq = Skv = 512, D = 64, H100 SXM;
// 3.35 TB/s):
//   operations: 4 * 128 * 512 * 512 * 64 = 8.59 GFLOP (half under causal)
//   bytes:      q, k, v, o = 4 * 128 * 512 * 64 elements + lse (128 * 512 f32)
//   f32  (494.7 TFLOP/s TF32, so 164.9 TFLOP/s for f32-accurate products at
//        three TF32 products each): 8.59e9 / 164.9e12 = 0.0521 ms vs
//        67.4 MB / 3.35e12 = 0.020 ms -> bound by operations, 0.0521 ms
//        (25.8 GFLOP of TF32 work as designed)
//   bf16 (989 TFLOP/s tensor cores): 8.59e9 / 989e12 = 0.0087 ms vs
//        33.8 MB / 3.35e12 = 0.0101 ms -> bound by bytes, 0.0101 ms
// mma.sync reaches a fraction of the tensor cores' peak (wgmma, TMA and warp
// specialisation are later work); chip_smoke.py measures how far each kernel
// sits from its bound.

#include <math.h>

#include "flash_attention_common.cuh"
#include "flash_attention_mma.cuh"
#include "flash_attention_tf32.cuh"

namespace {

using namespace ff_flash;

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the SFU's approximation (relative error about 2^-22, denormal
// results flushed to 0): one instruction where exp2f takes four, for each
// p of a warp's key tile.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- f32 on the tensor cores, split TF32 ------------------------------------

namespace tf32 {

using ff_tf32::Split;
using ff_tf32::mma3;

constexpr int kThreads = 128;  // 4 warps
constexpr size_t kSmemPerSm = 233472;  // an H100 SM's 228 KB, 1 KB of it reserved a block

// Tiles at padded width DP, chosen among variants timed on the H100
// (tools/torch_fwd_tf32_variants.py):
//  * block_k: keys a K/V tile; 64 at width 32, 32 at 64, 16 at 128 and 256,
//    so that the split Q tile and two stages of K and V fit two or more
//    blocks an SM up to width 128 (one at 256, where the split Q tile alone
//    takes 130 KB);
//  * warp_tiles: m16 tiles of query rows a warp, 2 at widths 32 and 64 (each
//    split K/V fragment then feeds two products), 1 at 128 and 256, where
//    O's accumulators (DP / 2 a tile) leave no room for two.
template <int DP>
__host__ __device__ constexpr int block_k() { return DP == 32 ? 64 : DP == 64 ? 32 : 16; }
template <int DP>
__host__ __device__ constexpr int warp_tiles() { return DP <= 64 ? 2 : 1; }

template <int MT>
__host__ __device__ constexpr int block_q() { return 4 * 16 * MT; }

template <int DP, int BK, int MT>
constexpr size_t smem_bytes() {
  // split Q (big, small); two stages of K, V
  return sizeof(float) * (size_t)(2 * block_q<MT>() + 4 * BK) * ff_tf32::kTileLd<DP>;
}
// Blocks an SM holds by shared memory, at most four: the register budget
// __launch_bounds__ gives the compiler (65536 / (128 * blocks) a thread).
template <int DP, int BK, int MT>
constexpr int min_blocks() {
  const size_t n = kSmemPerSm / (smem_bytes<DP, BK, MT>() + 1024);
  return n < 1 ? 1 : n > 4 ? 4 : (int)n;
}

template <int DP, int BK = block_k<DP>(), int MT = warp_tiles<DP>()>
__global__ void __launch_bounds__(kThreads, (min_blocks<DP, BK, MT>()))
flash_fwd_kernel_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int sq, int skv, int d, float scale,
                        int causal, int vec) {
  constexpr int BQ = block_q<MT>(), WR = 16 * MT, LD = ff_tf32::kTileLd<DP>;
  constexpr int NK = BK / 8, ND = DP / 8;  // n8 tiles of S, of O
  constexpr int STAGE = 2 * BK * LD;  // floats of a K/V stage
  extern __shared__ __align__(16) unsigned char tf32_smem[];
  float* qs = reinterpret_cast<float*>(tf32_smem);  // [BQ][LD], big(scale Q)
  float* qsm = qs + BQ * LD;                         // [BQ][LD], small(scale Q)
  float* kvs = qsm + BQ * LD;  // [2 stages][K, V][BK][LD]

  // blocks go tile-major: the last query tiles of every bh, which carry the
  // most causal work, start first
  const int nq = (sq + BQ - 1) / BQ;
  const int nbh = gridDim.x / nq;
  const int bh = blockIdx.x % nbh;
  const int q0 = (nq - 1 - (int)(blockIdx.x / nbh)) * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = lane >> 2, tig = lane & 3, rw = warp * WR;
  const size_t qoff = (size_t)bh * sq * d, koff = (size_t)bh * skv * d;
  const int kv_end = causal ? min(skv, q0 + BQ) : skv;
  const int ntiles = (kv_end + BK - 1) / BK;

  // Q in a group of its own, so that it is split while the first K/V stage
  // is still in flight
  ff_tf32::load_tile<BQ, DP, kThreads>(qs, q + qoff, q0, sq, d, vec);
  ff_mma::cp_async_commit();
  ff_tf32::load_tile<BK, DP, kThreads>(kvs, k + koff, 0, skv, d, vec);
  ff_tf32::load_tile<BK, DP, kThreads>(kvs + BK * LD, v + koff, 0, skv, d, vec);
  ff_mma::cp_async_commit();
  ff_mma::cp_async_wait<1>();  // this thread's part of Q has landed
  ff_tf32::split_tile<BQ, DP, kThreads>(qs, qsm, scale, vec);

  // Row state of the thread's rows: h = 0 is row group, h = 1 row group + 8
  // of each of the warp's m16 tiles mt. m is the running max of the scaled
  // logits, l the thread's part of the row sum (its 4 parts are added at
  // the end).
  auto row = [&](int mt, int h) { return q0 + rw + mt * 16 + group + 8 * h; };
  float m[MT][2], l[MT][2], acc[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[mt][h] = -INFINITY;
      l[mt][h] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < ND; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][i][e] = 0.f;
  }

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BK;
    if (j + 1 < ntiles) {
      float* next = kvs + ((j + 1) & 1) * STAGE;
      ff_tf32::load_tile<BK, DP, kThreads>(next, k + koff, k0 + BK, skv, d, vec);
      ff_tf32::load_tile<BK, DP, kThreads>(next + BK * LD, v + koff, k0 + BK, skv, d, vec);
    }
    ff_mma::cp_async_commit();
    ff_mma::cp_async_wait<1>();  // this thread's part of this tile has landed
    const float* ks = kvs + (j & 1) * STAGE;
    const float* vs = ks + BK * LD;
    __syncthreads();  // every thread's part of the tile (and of Q) is there

    // Under causal, a tile whose first key lies past the warp's last row
    // holds only dead entries for the warp: it would leave m, l and O as
    // they are, so the warp skips it.
    if (!causal || k0 <= q0 + rw + WR - 1) {
      // S = (scale Q) K^T for the warp's WR rows x BK keys
      float s[MT][NK][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < NK; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) {
        Split<4> aq[MT];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          aq[mt] = ff_tf32::frag_a<LD>(qs, qsm, rw + mt * 16, kk * 8);
#pragma unroll
        for (int nt = 0; nt < NK; ++nt) {
          const Split<2> b = ff_tf32::frag_b_nrows<LD>(ks, nt * 8, kk * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma3(s[mt][nt], aq[mt], b);
        }
      }

      // A tile that reaches past Skv or past the warp's first row (the
      // causal diagonal) has dead entries: keys past Skv, which the
      // zero-filled tile would give s = 0, and, under causal, keys past the
      // row. They leave the row max as -inf and get p = 0 by a select.
      const bool masked = k0 + BK > skv || (causal && k0 + BK - 1 > q0 + rw);
      auto dead = [&](int mt, int nt, int e) {
        const int key = k0 + nt * 8 + 2 * tig + (e & 1);
        return key >= skv || (causal && row(mt, e >> 1) < key);
      };

#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (masked) {
#pragma unroll
          for (int nt = 0; nt < NK; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (dead(mt, nt, e)) s[mt][nt][e] = -INFINITY;
        }
        // online softmax in f32: the new row max over the row's 4 lanes,
        // the old sums and accumulators rescaled by exp(m_old - m_new)
        float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
        for (int nt = 0; nt < NK; ++nt) {
          mx[0] = fmaxf(mx[0], fmaxf(s[mt][nt][0], s[mt][nt][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[mt][nt][2], s[mt][nt][3]));
        }
        float ms[2], alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int off = 1; off <= 2; off <<= 1)
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], off));
          // a row that has seen no live key keeps -inf; 0 in its place
          // keeps alpha and p free of inf - inf (key 0 is live for every
          // row, so no row stays there past its first tile)
          ms[h] = mx[h] == -INFINITY ? 0.f : mx[h] * kLog2e;
          alpha[h] = exp2_approx(m[mt][h] * kLog2e - ms[h]);
          m[mt][h] = mx[h];
        }
#pragma unroll
        for (int nt = 0; nt < NK; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[mt][nt][e] = exp2_approx(fmaf(s[mt][nt][e], kLog2e, -ms[e >> 1]));
        if (masked) {
#pragma unroll
          for (int nt = 0; nt < NK; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (dead(mt, nt, e)) s[mt][nt][e] = 0.f;
        }
        l[mt][0] *= alpha[0];
        l[mt][1] *= alpha[1];
#pragma unroll
        for (int nt = 0; nt < NK; ++nt) {
          l[mt][0] += s[mt][nt][0] + s[mt][nt][1];
          l[mt][1] += s[mt][nt][2] + s[mt][nt][3];
        }
#pragma unroll
        for (int i = 0; i < ND; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][i][e] *= alpha[e >> 1];
      }

      // O += P V: each n8 tile of P is the split A fragment of one k8 step,
      // relabelled, and V's B fragment is read at the matching key rows
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        Split<4> ap[MT];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) ap[mt] = ff_tf32::acc_a(s[mt][kk]);
#pragma unroll
        for (int dt = 0; dt < ND; ++dt) {
          const Split<2> b = ff_tf32::frag_b_krows<LD>(vs, kk * 8, dt * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma3(acc[mt][dt], ap[mt], b);
        }
      }
    }
    __syncthreads();  // this stage's reads are done before it is refilled
  }
  ff_mma::cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1)
        l[mt][h] += __shfl_xor_sync(0xffffffffu, l[mt][h], off);
      inv[h] = l[mt][h] > 0.f ? 1.f / l[mt][h] : 0.f;
      if (tig == 0 && row(mt, h) < sq)
        lse[(size_t)bh * sq + row(mt, h)] = m[mt][h] + logf(l[mt][h]);
    }
#pragma unroll
    for (int i = 0; i < ND; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][i][e] *= inv[e >> 1];
    // O / l through the Q tile (each warp rewrites only its own rows)
    ff_tf32::stage_acc<DP>(qs, acc[mt], rw + mt * 16, 0, 1.f);
  }
  __syncthreads();
  ff_tf32::store_tile<BQ, DP, kThreads>(o + qoff, qs, q0, sq, d, vec);
}

template <int DP, int BK = block_k<DP>(), int MT = warp_tiles<DP>()>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                   int sq, int skv, int d, float scale, int causal, cudaStream_t stream) {
  const unsigned blocks = grid_blocks(bh, sq, block_q<MT>());
  if (blocks == 0) return cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes<DP, BK, MT>();
  auto kernel = flash_fwd_kernel_tf32x3<DP, BK, MT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int vec = d % 4 == 0 && ff_mma::aligned16(q) && ff_mma::aligned16(k) &&
                  ff_mma::aligned16(v) && ff_mma::aligned16(o);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), sq, skv, d, scale, causal, vec);
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

}  // namespace tf32

// ---- bf16 on the tensor cores ----------------------------------------------

namespace mma {

using ff_mma::bf16;

constexpr int kBlockQ = 64;    // query rows a block: 4 warps x 16
constexpr int kThreads = 128;
constexpr int kWarpRows = 16;  // rows of a warp's m16 tiles

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

// dtype: 0 = float32 (the split-TF32 tensor-core kernel), 1 = bfloat16 (the
// bf16 tensor-core kernel). Returns the cudaError_t of the launch.
int ff_flash_attention_fwd(const void* q, const void* k, const void* v,
                           void* o, void* lse, int bh, int sq, int skv, int d,
                           float scale, int causal, int dtype, void* stream) {
  if (bh <= 0 || sq <= 0 || skv <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)tf32::dispatch_head_dim(q, k, v, o, lse, bh, sq, skv, d, scale, causal, s);
  if (dtype == 1)
    return (int)mma::dispatch_head_dim(q, k, v, o, lse, bh, sq, skv, d, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

const char* ff_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
