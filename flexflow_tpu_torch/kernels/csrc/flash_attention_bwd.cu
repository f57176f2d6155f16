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
// (BH, 1, Sq) is f32; all arithmetic is f32 and the gradients are written in
// the input type. delta reads O as stored (bf16 O in bf16), as
// `o_ref[0].astype(f32)` does. Any D up to 256 and any B*H
// (flash_attention_common.cuh).
//
// Design. The TPU's `_dkv_kernel` holds whole (Sq, D) Q, dO and O panels in
// VMEM; a Hopper block has 227 KB and blocks run in no order, so both kernels
// stream tiles through shared memory and own their outputs outright: no
// atomics, no second pass, and the result does not depend on the schedule.
//  * dq: one 256-thread block per (bh, 64-query tile). It stages scale * Q and
//    dO once, computes delta and loads lse for its rows, then loops over key
//    tiles of K and V and accumulates dQ in f32 registers (4 rows x DP/16
//    columns a thread). dS goes through shared memory between the two
//    products. Under causal it stops at the last key tile its rows can see.
//  * dkv: one block per (bh, key tile). It keeps K and V and accumulates dK
//    and dV in registers, and loops over 64-query tiles, staging scale * Q,
//    dO, lse and delta (recomputed per tile: D products a row) for each.
//    Under causal it starts at the first query tile that sees a key of its
//    tile; a key no query sees gets exactly 0, as the -1e30 mask gives.
// Masked entries get p = 0 directly (exp(-1e30 - lse) is exactly 0 in f32).
// Products run on the CUDA cores in f32, as in the forward kernel: `mma.sync`
// or `wgmma`, TMA and one fused pass are later work. The key tile is 64 rows
// up to the padded width 128 and 32 at 256, where the tiles take 201 KB (dq)
// and 210 KB (dkv) of shared memory.
//
// Bound at the slice shape (B*H = 128, Sq = Skv = 512, D = 64, H100 SXM:
// 67 TFLOP/s f32 on the CUDA cores, 989 TFLOP/s bf16 on the tensor cores,
// 3.35 TB/s). One unit = 2 * B*H * S^2 * D = 4.29 GFLOP of one product.
//   The function: 5 products (S, dP, dQ, dK, dV) = 21.5 GFLOP; it reads q, k,
//   v, o, g and writes dq, dk, dv (8 tensors of 128 * 512 * 64) plus lse.
//     f32:  21.5e9 / 67e12  = 0.321 ms vs 134.5 MB / 3.35e12 = 0.040 ms
//           -> bound by operations, 0.321 ms
//     bf16: 21.5e9 / 989e12 = 0.0217 ms vs 67.4 MB / 3.35e12 = 0.020 ms
//           -> bound by operations, 0.0217 ms
//   As designed the kernels recompute S and dP in both: dq does 3 products
//   (12.9 GFLOP; reads 5 tensors + lse, writes 1), dkv 4 (17.2 GFLOP; reads 5
//   + lse, writes 2): 7 products in all, 1.4x the function's work.
//     dq   f32 0.192 ms (operations), bf16 0.0151 ms (bytes, 50.6 MB)
//     dkv  f32 0.256 ms (operations), bf16 0.0176 ms (bytes, 59.0 MB)
//   Under causal, about half of every operation count.

#include <math.h>

#include "flash_attention_common.cuh"

namespace {

using namespace ff_flash;

constexpr int kBlockQ = 64;  // query rows per tile, both kernels

// Key rows per tile: 64, or 32 at the padded width 256 where 64 would not fit
// in shared memory.
template <int DP>
__host__ __device__ constexpr int block_k() { return DP == 256 ? 32 : 64; }

// delta[r] = rowsum(dO * O) and the saved lse for rows [q0, q0 + kBlockQ);
// rows past sq get 0. gs is the staged dO tile; O is read from device memory
// in its own type. One warp per row at a time.
template <typename T, int DP>
__device__ __forceinline__ void row_stats(float* lses, float* deltas,
                                          const float* gs, const T* __restrict__ ob,
                                          const float* __restrict__ lseb, int q0,
                                          int sq, int d) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kBlockQ; r += kWarps) {
    const int row = q0 + r;
    float sum = 0.f;
    if (row < sq)
      for (int c = lane; c < d; c += 32)
        sum = fmaf(gs[r * (DP + 1) + c], to_f32(ob[(size_t)row * d + c]), sum);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      deltas[r] = sum;
      lses[r] = row < sq ? lseb[row] : 0.f;
    }
  }
}

template <int DP>
constexpr size_t dq_smem_bytes() {
  constexpr int BK = block_k<DP>();
  return sizeof(float) * (size_t)(2 * kBlockQ * (DP + 1) + 2 * BK * (DP + 1) +
                                  kBlockQ * (BK + 1) + 2 * kBlockQ);
}

template <int DP>
constexpr size_t dkv_smem_bytes() {
  constexpr int BK = block_k<DP>();
  return sizeof(float) * (size_t)(2 * BK * (DP + 1) + 2 * kBlockQ * (DP + 1) +
                                  2 * BK * (kBlockQ + 1) + 2 * kBlockQ);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ g, const float* __restrict__ lse,
                    T* __restrict__ dq, int sq, int skv, int d, float scale,
                    int causal) {
  constexpr int BK = block_k<DP>();
  constexpr int LD = DP + 1;  // padded row stride of the q/g/k/v tiles
  constexpr int LDS = BK + 1;  // padded row stride of the dS tile
  constexpr int R = kBlockQ / 16;  // query rows per thread
  constexpr int C = BK / 16;       // key columns per thread
  constexpr int DC = DP / 16;      // dQ columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                 // [kBlockQ][LD], scale * Q
  float* gs = qs + kBlockQ * LD;    // [kBlockQ][LD], dO
  float* ks = gs + kBlockQ * LD;    // [BK][LD]
  float* vs = ks + BK * LD;         // [BK][LD]
  float* dss = vs + BK * LD;        // [kBlockQ][LDS], dS
  float* lses = dss + kBlockQ * LDS;  // [kBlockQ]
  float* deltas = lses + kBlockQ;     // [kBlockQ]

  const int nq = (sq + kBlockQ - 1) / kBlockQ;
  const int bh = blockIdx.x / nq;
  // the last query tiles carry the most causal work: start them first
  const int q0 = (nq - 1 - (int)(blockIdx.x % nq)) * kBlockQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t qoff = (size_t)bh * sq * d, koff = (size_t)bh * skv * d;

  load_tile<T, DP, kBlockQ>(qs, q + qoff, q0, sq, d, scale);
  load_tile<T, DP, kBlockQ>(gs, g + qoff, q0, sq, d, 1.f);
  __syncthreads();
  row_stats<T, DP>(lses, deltas, gs, o + qoff, lse + (size_t)bh * sq, q0, sq, d);

  float acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  const int kv_end = causal ? min(skv, q0 + kBlockQ) : skv;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // row stats written; the previous tile's reads are done
    load_tile<T, DP, BK>(ks, k + koff, k0, skv, d, 1.f);
    load_tile<T, DP, BK>(vs, v + koff, k0, skv, d, 1.f);
    __syncthreads();

    float s[R][C], dp[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DP; ++c) {
      float qv[R], gv[R], kv[C], vv[C];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qv[i] = qs[(ty + 16 * i) * LD + c];
        gv[i] = gs[(ty + 16 * i) * LD + c];
      }
#pragma unroll
      for (int j = 0; j < C; ++j) {
        kv[j] = ks[(tx + 16 * j) * LD + c];
        vv[j] = vs[(tx + 16 * j) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool live = kpos < skv && !(causal && q0 + r < kpos);
        const float p = live ? expf(s[i][j] - lses[r]) : 0.f;
        dss[r * LDS + tx + 16 * j] = p * (dp[i][j] - deltas[r]);
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float dsv[R], kv[DC];
#pragma unroll
      for (int i = 0; i < R; ++i) dsv[i] = dss[(ty + 16 * i) * LDS + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) kv[j] = ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sq) continue;
    T* row = dq + qoff + (size_t)r * d;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx + 16 * j;
      if (c < d) row[c] = from_f32<T>(acc[i][j] * scale);
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ o,
                     const T* __restrict__ g, const float* __restrict__ lse,
                     T* __restrict__ dk, T* __restrict__ dv, int sq, int skv,
                     int d, float scale, int causal) {
  constexpr int BK = block_k<DP>();
  constexpr int LD = DP + 1;        // padded row stride of the k/v/q/g tiles
  constexpr int LDP = kBlockQ + 1;  // padded row stride of the P^T, dS^T tiles
  constexpr int R = BK / 16;        // key rows per thread
  constexpr int C = kBlockQ / 16;   // query columns per thread
  constexpr int DC = DP / 16;       // dK/dV columns per thread
  extern __shared__ float smem[];
  float* ks = smem;                 // [BK][LD]
  float* vs = ks + BK * LD;         // [BK][LD]
  float* qs = vs + BK * LD;         // [kBlockQ][LD], scale * Q
  float* gs = qs + kBlockQ * LD;    // [kBlockQ][LD], dO
  float* pts = gs + kBlockQ * LD;   // [BK][LDP], P^T
  float* dsts = pts + BK * LDP;     // [BK][LDP], dS^T
  float* lses = dsts + BK * LDP;    // [kBlockQ]
  float* deltas = lses + kBlockQ;   // [kBlockQ]

  const int nk = (skv + BK - 1) / BK;
  const int bh = blockIdx.x / nk;
  // the first key tiles carry the most causal work and come first
  const int k0 = (int)(blockIdx.x % nk) * BK;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t qoff = (size_t)bh * sq * d, koff = (size_t)bh * skv * d;

  load_tile<T, DP, BK>(ks, k + koff, k0, skv, d, 1.f);
  load_tile<T, DP, BK>(vs, v + koff, k0, skv, d, 1.f);

  float dka[R][DC], dva[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int q0 = causal ? (k0 / kBlockQ) * kBlockQ : 0; q0 < sq; q0 += kBlockQ) {
    __syncthreads();  // the previous tile's reads are done
    load_tile<T, DP, kBlockQ>(qs, q + qoff, q0, sq, d, scale);
    load_tile<T, DP, kBlockQ>(gs, g + qoff, q0, sq, d, 1.f);
    __syncthreads();
    row_stats<T, DP>(lses, deltas, gs, o + qoff, lse + (size_t)bh * sq, q0, sq, d);
    __syncthreads();

    float s[R][C], dp[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DP; ++c) {
      float kv[R], vv[R], qv[C], gv[C];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        kv[i] = ks[(ty + 16 * i) * LD + c];
        vv[i] = vs[(ty + 16 * i) * LD + c];
      }
#pragma unroll
      for (int j = 0; j < C; ++j) {
        qv[j] = qs[(tx + 16 * j) * LD + c];
        gv[j] = gs[(tx + 16 * j) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int kpos = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int qr = tx + 16 * j;
        const bool live = q0 + qr < sq && !(causal && q0 + qr < kpos);
        const float p = live ? expf(s[i][j] - lses[qr]) : 0.f;
        pts[(ty + 16 * i) * LDP + qr] = p;
        dsts[(ty + 16 * i) * LDP + qr] = p * (dp[i][j] - deltas[qr]);
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < kBlockQ; ++c) {
      float pv[R], dsv[R], gv[DC], qv[DC];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pv[i] = pts[(ty + 16 * i) * LDP + c];
        dsv[i] = dsts[(ty + 16 * i) * LDP + c];
      }
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        gv[j] = gs[c * LD + tx + 16 * j];
        qv[j] = qs[c * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          dva[i][j] = fmaf(pv[i], gv[j], dva[i][j]);
          dka[i][j] = fmaf(dsv[i], qv[j], dka[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= skv) continue;
    T* krow = dk + koff + (size_t)r * d;
    T* vrow = dv + koff + (size_t)r * d;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx + 16 * j;
      if (c < d) {
        krow[c] = from_f32<T>(dka[i][j]);
        vrow[c] = from_f32<T>(dva[i][j]);
      }
    }
  }
}

template <typename T, int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o,
                      const void* g, const void* lse, void* dq, int bh, int sq,
                      int skv, int d, float scale, int causal, cudaStream_t stream) {
  const unsigned blocks = grid_blocks(bh, sq, kBlockQ);
  if (blocks == 0) return cudaErrorInvalidValue;
  constexpr size_t smem = dq_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, DP><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<T*>(dq), sq, skv, d, scale, causal);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* o,
                       const void* g, const void* lse, void* dk, void* dv, int bh,
                       int sq, int skv, int d, float scale, int causal,
                       cudaStream_t stream) {
  const unsigned blocks = grid_blocks(bh, skv, block_k<DP>());
  if (blocks == 0) return cudaErrorInvalidValue;
  constexpr size_t smem = dkv_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<T, DP><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<T*>(dk), static_cast<T*>(dv), sq,
      skv, d, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dq(const void* q, const void* k, const void* v, const void* o,
                        const void* g, const void* lse, void* dq, int bh, int sq,
                        int skv, int d, float scale, int causal, cudaStream_t s) {
  switch (padded_head_dim(d)) {
    case 32: return launch_dq<T, 32>(q, k, v, o, g, lse, dq, bh, sq, skv, d, scale, causal, s);
    case 64: return launch_dq<T, 64>(q, k, v, o, g, lse, dq, bh, sq, skv, d, scale, causal, s);
    case 128: return launch_dq<T, 128>(q, k, v, o, g, lse, dq, bh, sq, skv, d, scale, causal, s);
    case 256: return launch_dq<T, 256>(q, k, v, o, g, lse, dq, bh, sq, skv, d, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dkv(const void* q, const void* k, const void* v, const void* o,
                         const void* g, const void* lse, void* dk, void* dv, int bh,
                         int sq, int skv, int d, float scale, int causal,
                         cudaStream_t s) {
  switch (padded_head_dim(d)) {
    case 32:
      return launch_dkv<T, 32>(q, k, v, o, g, lse, dk, dv, bh, sq, skv, d, scale, causal, s);
    case 64:
      return launch_dkv<T, 64>(q, k, v, o, g, lse, dk, dv, bh, sq, skv, d, scale, causal, s);
    case 128:
      return launch_dkv<T, 128>(q, k, v, o, g, lse, dk, dv, bh, sq, skv, d, scale, causal, s);
    case 256:
      return launch_dkv<T, 256>(q, k, v, o, g, lse, dk, dv, bh, sq, skv, d, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Each returns the cudaError_t of its launch.
int ff_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                              const void* o, const void* g, const void* lse,
                              void* dq, int bh, int sq, int skv, int d, float scale,
                              int causal, int dtype, void* stream) {
  if (bh <= 0 || sq <= 0 || skv <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_dq<float>(q, k, v, o, g, lse, dq, bh, sq, skv, d, scale, causal, s);
  if (dtype == 1)
    return (int)dispatch_dq<__nv_bfloat16>(q, k, v, o, g, lse, dq, bh, sq, skv, d, scale,
                                           causal, s);
  return (int)cudaErrorInvalidValue;
}

int ff_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                               const void* o, const void* g, const void* lse,
                               void* dk, void* dv, int bh, int sq, int skv, int d,
                               float scale, int causal, int dtype, void* stream) {
  if (bh <= 0 || sq <= 0 || skv <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_dkv<float>(q, k, v, o, g, lse, dk, dv, bh, sq, skv, d, scale,
                                    causal, s);
  if (dtype == 1)
    return (int)dispatch_dkv<__nv_bfloat16>(q, k, v, o, g, lse, dk, dv, bh, sq, skv, d,
                                            scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
