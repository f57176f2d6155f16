// Flash-attention backward for head dims above 256 on NVIDIA Hopper
// (sm_90a): the dq and dkv kernels, chunked over the head dim, on the CUDA
// cores. The forward for D > 256 runs on the tensor cores in
// flash_attention_fwd_wide.cu.
//
// Replaces, for D > 256, the same TPU kernels as flash_attention_bwd.cu:
// `_dq_kernel` and `_dkv_kernel` (flexflow_tpu/kernels/flash_attention.py:59,
// :79), which take any D. The math is theirs, line for line (see that file's
// notes): S = (scale * Q) K^T with the -1e30 causal mask, P = exp(S - lse),
// dP = dO V^T, delta = rowsum(dO * O), dS = P * (dP - delta); f32
// arithmetic, outputs in the input type. They read the forward's lse and
// compute delta from O themselves.
//
// Why separate kernels. The D <= 256 kernels stage whole (rows, D) tiles in
// shared memory; at a padded width of 512 even 32-row K/V tiles with a
// 64-row Q tile pass a block's 227 KB. Here every block owns one chunk of
// kChunk = 128 output columns (dQ, or dK and dV) and loops over the head dim
// in chunks of kChunk for the products that reduce over it: S and dP
// accumulate in registers across the chunks, then the block's own column
// chunk of K (dq) or Q and dO (dkv) is staged and the output chunk
// accumulates. Blocks of the same rows recompute S and dP once per output
// chunk (ceil(D / 128) times), so at D = 512 these kernels do about 4x the
// products of one pass: a simple, right kernel first. The tiles take 146 KB
// (dq) and 162 KB (dkv) of shared memory, and the head dim loop has no upper
// limit.
//
// Blocks are numbered along x only: ((bh * tiles) + tile) * chunks + chunk.
// Bound at B*H = 128, S = 512, D = 512 (H100 SXM, 67 TFLOP/s f32 CUDA cores,
// 989 TFLOP/s bf16, 3.35 TB/s): the backward's 5 products are 172 GFLOP,
// 2.6 ms in f32 on the CUDA cores (bound by operations) and 0.17 ms in bf16.
// chip_smoke.py prints each case's bound beside its time.

#include <math.h>

#include "flash_attention_common.cuh"

namespace {

using namespace ff_flash;

constexpr int kBlockQ = 64;    // query rows per tile
constexpr int kBlockK = 64;    // key rows per tile
constexpr int kChunk = 128;    // head-dim columns per chunk
constexpr int LD = kChunk + 1;  // padded row stride of a staged chunk
constexpr int LDT = 65;         // padded row stride of the 64 x 64 p/dS tiles
constexpr int kRows = 4;        // rows of a 64-row tile per thread
constexpr int kCols = 4;        // columns of a 64-column score tile per thread
constexpr int DC = kChunk / 16;  // output columns of a chunk per thread

// Stage rows [r0, r0 + 64) and columns [c0, c0 + kChunk) of a (rows, d)
// matrix into a [64][LD] f32 tile, times `mul`; rows past `rows` and columns
// past d are 0.
template <typename T>
__device__ __forceinline__ void load_chunk(float* dst, const T* __restrict__ src,
                                           int r0, int rows, int c0, int d, float mul) {
  for (int i = threadIdx.x; i < 64 * kChunk; i += kThreads) {
    const int r = i / kChunk, c = i % kChunk;
    dst[r * LD + c] = (r0 + r < rows && c0 + c < d)
                          ? to_f32(src[(size_t)(r0 + r) * d + c0 + c]) * mul
                          : 0.f;
  }
}

// delta[r] = rowsum(dO * O) over the whole head dim, read from device memory,
// and the saved lse, for rows [q0, q0 + 64); rows past sq get 0.
template <typename T>
__device__ __forceinline__ void row_stats(float* lses, float* deltas,
                                          const T* __restrict__ gb,
                                          const T* __restrict__ ob,
                                          const float* __restrict__ lseb, int q0,
                                          int sq, int d) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kBlockQ; r += kWarps) {
    const int row = q0 + r;
    float sum = 0.f;
    if (row < sq)
      for (int c = lane; c < d; c += 32)
        sum = fmaf(to_f32(gb[(size_t)row * d + c]), to_f32(ob[(size_t)row * d + c]), sum);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      deltas[r] = sum;
      lses[r] = row < sq ? lseb[row] : 0.f;
    }
  }
}

// acc[i][j] += a[ty + 16 i][c] * b[tx + 16 j][c] over one staged chunk
__device__ __forceinline__ void chunk_dot(float (&acc)[kRows][kCols], const float* a,
                                          const float* b) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 8
  for (int c = 0; c < kChunk; ++c) {
    float av[kRows], bv[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) av[i] = a[(ty + 16 * i) * LD + c];
#pragma unroll
    for (int j = 0; j < kCols; ++j) bv[j] = b[(tx + 16 * j) * LD + c];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += p[ty + 16 i][c] * m[c][tx + 16 j] over the 64 rows c of a
// staged chunk m, with p a [64][LDT] tile
__device__ __forceinline__ void tile_times_chunk(float (&acc)[kRows][DC], const float* p,
                                                 const float* m) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 8
  for (int c = 0; c < 64; ++c) {
    float pv[kRows], mv[DC];
#pragma unroll
    for (int i = 0; i < kRows; ++i) pv[i] = p[(ty + 16 * i) * LDT + c];
#pragma unroll
    for (int j = 0; j < DC; ++j) mv[j] = m[c * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pv[i], mv[j], acc[i][j]);
  }
}

constexpr size_t kDqSmem = sizeof(float) * (size_t)(4 * 64 * LD + 64 * LDT + 2 * kBlockQ);
constexpr size_t kDkvSmem =
    sizeof(float) * (size_t)(4 * 64 * LD + 2 * 64 * LDT + 2 * kBlockQ);

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ o,
                         const T* __restrict__ g, const float* __restrict__ lse,
                         T* __restrict__ dq, int sq, int skv, int d, float scale,
                         int causal) {
  extern __shared__ float smem[];
  float* qs = smem;             // [64][LD], a chunk of scale * Q
  float* gs = qs + 64 * LD;     // [64][LD], a chunk of dO
  float* ks = gs + 64 * LD;     // [64][LD], a chunk of K (last: the block's own)
  float* vs = ks + 64 * LD;     // [64][LD], a chunk of V
  float* dss = vs + 64 * LD;    // [64][LDT], dS
  float* lses = dss + 64 * LDT;  // [64]
  float* deltas = lses + kBlockQ;  // [64]

  const int nchunk = (d + kChunk - 1) / kChunk;
  const int nq = (sq + kBlockQ - 1) / kBlockQ;
  const int chunk = blockIdx.x % nchunk;
  const int tile = blockIdx.x / nchunk;
  const int bh = tile / nq;
  const int q0 = (nq - 1 - tile % nq) * kBlockQ;
  const int c0 = chunk * kChunk;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qoff = (size_t)bh * sq * d, koff = (size_t)bh * skv * d;

  row_stats<T>(lses, deltas, g + qoff, o + qoff, lse + (size_t)bh * sq, q0, sq, d);

  float acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  const int kv_end = causal ? min(skv, q0 + kBlockQ) : skv;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    float s[kRows][kCols] = {}, dp[kRows][kCols] = {};
    for (int dc = 0; dc < d; dc += kChunk) {
      __syncthreads();  // row stats written; the previous chunk's reads are done
      load_chunk<T>(qs, q + qoff, q0, sq, dc, d, scale);
      load_chunk<T>(gs, g + qoff, q0, sq, dc, d, 1.f);
      load_chunk<T>(ks, k + koff, k0, skv, dc, d, 1.f);
      load_chunk<T>(vs, v + koff, k0, skv, dc, d, 1.f);
      __syncthreads();
      chunk_dot(s, qs, ks);
      chunk_dot(dp, gs, vs);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool live = kpos < skv && !(causal && q0 + r < kpos);
        const float p = live ? expf(s[i][j] - lses[r]) : 0.f;
        dss[r * LDT + tx + 16 * j] = p * (dp[i][j] - deltas[r]);
      }
    }
    __syncthreads();  // the products' reads of ks are done; dS is written
    load_chunk<T>(ks, k + koff, k0, skv, c0, d, 1.f);
    __syncthreads();
    tile_times_chunk(acc, dss, ks);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sq) continue;
    T* row = dq + qoff + (size_t)r * d;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < d) row[c] = from_f32<T>(acc[i][j] * scale);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ o,
                          const T* __restrict__ g, const float* __restrict__ lse,
                          T* __restrict__ dk, T* __restrict__ dv, int sq, int skv, int d,
                          float scale, int causal) {
  extern __shared__ float smem[];
  float* ks = smem;             // [64][LD], a chunk of K
  float* vs = ks + 64 * LD;     // [64][LD], a chunk of V
  float* qs = vs + 64 * LD;     // [64][LD], a chunk of scale * Q (last: the block's own)
  float* gs = qs + 64 * LD;     // [64][LD], a chunk of dO (last: the block's own)
  float* pts = gs + 64 * LD;    // [64][LDT], P^T
  float* dsts = pts + 64 * LDT;  // [64][LDT], dS^T
  float* lses = dsts + 64 * LDT;  // [64]
  float* deltas = lses + kBlockQ;  // [64]

  const int nchunk = (d + kChunk - 1) / kChunk;
  const int nk = (skv + kBlockK - 1) / kBlockK;
  const int chunk = blockIdx.x % nchunk;
  const int tile = blockIdx.x / nchunk;
  const int bh = tile / nk;
  const int k0 = (tile % nk) * kBlockK;  // the first key tiles carry the most work
  const int c0 = chunk * kChunk;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qoff = (size_t)bh * sq * d, koff = (size_t)bh * skv * d;

  float dka[kRows][DC], dva[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int q0 = causal ? (k0 / kBlockQ) * kBlockQ : 0; q0 < sq; q0 += kBlockQ) {
    __syncthreads();  // the previous tile's reads are done
    row_stats<T>(lses, deltas, g + qoff, o + qoff, lse + (size_t)bh * sq, q0, sq, d);
    float s[kRows][kCols] = {}, dp[kRows][kCols] = {};
    for (int dc = 0; dc < d; dc += kChunk) {
      __syncthreads();
      load_chunk<T>(ks, k + koff, k0, skv, dc, d, 1.f);
      load_chunk<T>(vs, v + koff, k0, skv, dc, d, 1.f);
      load_chunk<T>(qs, q + qoff, q0, sq, dc, d, scale);
      load_chunk<T>(gs, g + qoff, q0, sq, dc, d, 1.f);
      __syncthreads();
      chunk_dot(s, ks, qs);   // s[i][j] = k_i . q_j
      chunk_dot(dp, vs, gs);  // dp[i][j] = v_i . dO_j
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int kpos = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int qr = tx + 16 * j;
        const bool live = q0 + qr < sq && !(causal && q0 + qr < kpos);
        const float p = live ? expf(s[i][j] - lses[qr]) : 0.f;
        pts[(ty + 16 * i) * LDT + qr] = p;
        dsts[(ty + 16 * i) * LDT + qr] = p * (dp[i][j] - deltas[qr]);
      }
    }
    __syncthreads();  // the products' reads of qs/gs are done; P^T, dS^T written
    load_chunk<T>(qs, q + qoff, q0, sq, c0, d, scale);
    load_chunk<T>(gs, g + qoff, q0, sq, c0, d, 1.f);
    __syncthreads();
    tile_times_chunk(dva, pts, gs);
    tile_times_chunk(dka, dsts, qs);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= skv) continue;
    T* krow = dk + koff + (size_t)r * d;
    T* vrow = dv + koff + (size_t)r * d;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < d) {
        krow[c] = from_f32<T>(dka[i][j]);
        vrow[c] = from_f32<T>(dva[i][j]);
      }
    }
  }
}

// Blocks of a grid of bh * ceil(s / tile) * ceil(d / kChunk); 0 when it
// does not fit the x dimension.
unsigned wide_blocks(int bh, int s, int tile, int d) {
  const long long n = (long long)bh * ((s + tile - 1) / tile) * ((d + kChunk - 1) / kChunk);
  return n > INT_MAX ? 0u : (unsigned)n;
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o,
                      const void* g, const void* lse, void* dq, int bh, int sq, int skv,
                      int d, float scale, int causal, cudaStream_t stream) {
  const unsigned blocks = wide_blocks(bh, sq, kBlockQ, d);
  if (blocks == 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDqSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wide_kernel<T><<<blocks, kThreads, kDqSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(g), static_cast<const float*>(lse),
      static_cast<T*>(dq), sq, skv, d, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* o,
                       const void* g, const void* lse, void* dk, void* dv, int bh, int sq,
                       int skv, int d, float scale, int causal, cudaStream_t stream) {
  const unsigned blocks = wide_blocks(bh, skv, kBlockK, d);
  if (blocks == 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDkvSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_wide_kernel<T><<<blocks, kThreads, kDkvSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(g), static_cast<const float*>(lse),
      static_cast<T*>(dk), static_cast<T*>(dv), sq, skv, d, scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The entries of flash_attention_bwd.cu for any head dim d >= 1 (the
// wrapper calls these above 256). dtype: 0 = float32, 1 = bfloat16. Each
// returns the cudaError_t of its launch.
int ff_flash_attention_bwd_dq_wide(const void* q, const void* k, const void* v,
                                   const void* o, const void* g, const void* lse, void* dq,
                                   int bh, int sq, int skv, int d, float scale, int causal,
                                   int dtype, void* stream) {
  if (bh <= 0 || sq <= 0 || skv <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dq<float>(q, k, v, o, g, lse, dq, bh, sq, skv, d, scale, causal, s);
  if (dtype == 1)
    return (int)launch_dq<__nv_bfloat16>(q, k, v, o, g, lse, dq, bh, sq, skv, d, scale,
                                         causal, s);
  return (int)cudaErrorInvalidValue;
}

int ff_flash_attention_bwd_dkv_wide(const void* q, const void* k, const void* v,
                                    const void* o, const void* g, const void* lse, void* dk,
                                    void* dv, int bh, int sq, int skv, int d, float scale,
                                    int causal, int dtype, void* stream) {
  if (bh <= 0 || sq <= 0 || skv <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dkv<float>(q, k, v, o, g, lse, dk, dv, bh, sq, skv, d, scale, causal,
                                  s);
  if (dtype == 1)
    return (int)launch_dkv<__nv_bfloat16>(q, k, v, o, g, lse, dk, dv, bh, sq, skv, d, scale,
                                          causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
