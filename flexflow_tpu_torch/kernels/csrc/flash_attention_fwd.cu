// Flash-attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` (flexflow_tpu/kernels/flash_attention.py:43,
// launched by `_flash_fwd` at :347). For each (batch*head, query row):
//   O   = softmax(scale * Q K^T) V      (scale applied to Q in f32 first)
//   LSE = m + log(l)                    (f32)
// Under `causal`, logits with qpos < kpos are set to -1e30, top-left aligned,
// as `_causal_mask` does. Inputs are f32 or bf16; all arithmetic is f32; O is
// written in the input type.
//
// Layout: q (BH, Sq, D), k/v (BH, Skv, D), o (BH, Sq, D), lse (BH, 1, Sq), all
// contiguous. Any D up to 256 and any B*H: the kernel is built for a padded
// width of 32, 64, 128 or 256 with the columns past D zero, and blocks are
// numbered along the grid's x dimension only (flash_attention_common.cuh).
//
// Design. The TPU kernel holds a whole (Skv, D) K/V panel in 16 MB of VMEM and
// materialises a (block_q, Skv) logits tile. A Hopper block has at most 227 KB
// of shared memory, so this kernel streams K/V instead: one block of 256
// threads per (bh, 64-query tile), a loop over 64-key tiles staged in shared
// memory as f32 (209 KB of shared memory at the padded width 256, one block
// per SM there), and an online softmax (running max m, sum l and the output
// accumulator in f32 registers). Each thread owns 4 query rows x 4 key columns
// of the score tile and 4 rows x D/16 columns of the output; a row's 16 owners
// sit in one half-warp, so row max/sum reductions are 4 shuffles. Q/K/V rows
// are padded by one float so the column reads are free of bank conflicts.
// Keys past Skv are masked to -inf (their p is exactly 0); causal blocks stop
// at the last key tile their rows can see, which skips only tiles whose every
// logit would be -1e30 and so contribute exactly 0. Products run on the CUDA
// cores in f32: `wgmma`, TMA and a bf16 tensor-core path are later work.
//
// Bound at the slice shape (B*H = 128, Sq = Skv = 512, D = 64, H100 SXM):
//   operations: 4 * 128 * 512 * 512 * 64 = 8.59 GFLOP (half under causal)
//   bytes:      q, k, v, o = 4 * 128 * 512 * 64 elements + lse (128 * 512 f32)
//   f32  (67 TFLOP/s CUDA cores; 3.35 TB/s): 8.59e9 / 67e12 = 0.128 ms vs
//        67.4 MB / 3.35e12 = 0.020 ms -> bound by operations, 0.128 ms
//   bf16 (989 TFLOP/s tensor cores): 8.59e9 / 989e12 = 0.0087 ms vs
//        33.8 MB / 3.35e12 = 0.0101 ms -> bound by bytes, 0.0101 ms
// This kernel does its bf16 math on the CUDA cores too, so in bf16 it sits far
// above that bound; chip_smoke.py measures how far.

#include <math.h>

#include "flash_attention_common.cuh"

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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
int ff_flash_attention_fwd(const void* q, const void* k, const void* v,
                           void* o, void* lse, int bh, int sq, int skv, int d,
                           float scale, int causal, int dtype, void* stream) {
  if (bh <= 0 || sq <= 0 || skv <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_head_dim<float>(q, k, v, o, lse, bh, sq, skv, d, scale, causal, s);
  if (dtype == 1)
    return (int)dispatch_head_dim<__nv_bfloat16>(q, k, v, o, lse, bh, sq, skv, d, scale,
                                                 causal, s);
  return (int)cudaErrorInvalidValue;
}

const char* ff_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
