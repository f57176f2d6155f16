// MoE row movement for NVIDIA Hopper (sm_90a): row_gather and row_gather_sum.
//
// Replaces the TPU kernels `_row_gather_kernel` (flexflow_tpu/kernels/
// moe_kernels.py:41, launched by `row_gather` at :65) and
// `_row_gather_sum_kernel` (:74, launched by `row_gather_sum` at :105):
//   row_gather:      out[i, :] = scale[i] * x[idx[i], :]
//   row_gather_sum:  out[b, :] = sum_j w[b, j] * x[idx[b, j], :], j = 0..k-1 in order
// x (R_in, d) is f32 or bf16, idx int32, scale and w f32; the math is f32 and
// the output is written in x's type. Each product is rounded before its sum
// (__fmul_rn, __fadd_rn: no contraction into an FMA), as the TPU kernel's
// `acc += w * x` and the plain PyTorch versions compute it, so a kernel and
// its plain version agree bit for bit. The multiply is kept when a scale or
// weight is 0, so a non-finite source row propagates as it does there. An
// index outside [0, R_in) reads nothing and counts as a row of zeros (the
// plain versions raise on it); the routing never builds one.
//
// Design. The TPU kernels stage one row per sequential grid step through
// VMEM with scalar-prefetched indices, and row_gather_sum carries its sum in
// VMEM scratch across the grid's inner dimension. Here nothing is carried
// between blocks, and each output element is written once by one thread: no
// atomics, no scatter, and the result does not depend on the schedule.
// Rows move in 16-byte vectors (4 f32 or 8 bf16) where the row pitch and
// the base pointers allow (d = 784: 3136 B in f32, 1568 B in bf16), one
// element at a time otherwise.
//  * row_gather: each warp owns one output row (8 rows to a 256-thread
//    block), reads its index and scale once and walks the row's columns.
//  * row_gather_sum: each thread owns one (output row, vector) pair, so a
//    warp covers 32 neighbouring vectors of a row and the grid has as many
//    threads as the output has vectors: 64 rows x 196 f32 vectors at the
//    MoE model's shape is 49 blocks, where a warp a row filled 8 blocks on
//    132 SMs and each lane walked 7 vectors in turn. A thread reads its
//    row's k indices and weights and starts all k row loads (unrolled for
//    k = 2, the top-2 of every configuration here; in groups of four for
//    any other k) before it sums them in order.
//
// Bound: both kernels only move bytes. At the MoE model's main shape (batch
// 64, d 784, 5 experts, top-2, capacity 52) row_gather writes 260 rows of
// 3136 B from at most 64 source rows, ~1 MB in f32 (0.3 us at 3.35 TB/s), and
// row_gather_sum reads at most 128 rows and writes 64, ~0.6 MB: both are
// bound by launch latency, not by the card. At Mixtral-8x7B's widths (hidden
// 4096, 8 experts, top-2, 4096 tokens, bf16) row_gather moves ~168 MB (~50
// us). chip_smoke.py computes each run's bound from the rows its data reads.

#include <stdint.h>

#include "flash_attention_common.cuh"  // to_f32 / from_f32

namespace {

using ff_flash::from_f32;
using ff_flash::to_f32;

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;  // one warp per output row

// Load VEC consecutive elements at p as f32: one 16-byte load when VEC > 1.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    f[0] = to_f32(*p);
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = to_f32(e[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    *p = from_f32<T>(f[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f32<T>(f[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// The source row's VEC columns at c as f32, or zeros for an index out of range.
template <typename T, int VEC>
__device__ __forceinline__ void load_row_vec(const T* __restrict__ x, int src, int r_in,
                                             int d, int c, float (&f)[VEC]) {
  if (src >= 0 && src < r_in) {
    load_vec<T, VEC>(x + (size_t)src * d + c, f);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = 0.f;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                  const float* __restrict__ scale, T* __restrict__ out, int r_in,
                  int r_out, int d) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= r_out) return;
  const int lane = threadIdx.x % 32;
  const int src = idx[row];
  const float s = scale[row];
  T* orow = out + (size_t)row * d;
#pragma unroll 4
  for (int c = lane * VEC; c < d; c += 32 * VEC) {
    float f[VEC];
    load_row_vec<T, VEC>(x, src, r_in, d, c, f);
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = __fmul_rn(s, f[i]);
    store_vec<T, VEC>(orow + c, f);
  }
}

// K = 2: exactly two picks a row, loaded together; K = 0: any k, loaded in
// groups of four. The sum runs over j = 0..k-1 in order either way.
template <typename T, int VEC, int K>
__global__ void __launch_bounds__(kThreads)
row_gather_sum_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                      const float* __restrict__ w, T* __restrict__ out, int r_in, int nb,
                      int k, int d) {
  constexpr int G = K > 0 ? K : 4;  // rows loaded before they are summed
  const int vecs = (d + VEC - 1) / VEC;  // vectors a row (VEC divides d when VEC > 1)
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)nb * vecs) return;
  const int b = (int)(t / vecs), c = (int)(t % vecs) * VEC;
  if constexpr (K > 0) k = K;
  const int* ib = idx + (size_t)b * k;
  const float* wb = w + (size_t)b * k;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  for (int j0 = 0; j0 < k; j0 += G) {
    float wj[G], f[G][VEC];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      if (K > 0 || j0 + u < k) {
        wj[u] = wb[j0 + u];
        load_row_vec<T, VEC>(x, ib[j0 + u], r_in, d, c, f[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      if (K > 0 || j0 + u < k) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(wj[u], f[u][i]));
      }
    }
  }
  store_vec<T, VEC>(out + (size_t)b * d + c, acc);
}

// 16-byte vectors when every row starts on a 16-byte boundary.
template <typename T>
bool vectorizable(const void* x, const void* out, int d) {
  return ((size_t)d * sizeof(T)) % 16 == 0 && (uintptr_t)x % 16 == 0 &&
         (uintptr_t)out % 16 == 0;
}

unsigned row_blocks(int rows) { return (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock); }

template <typename T>
cudaError_t launch_gather(const void* x, const int* idx, const float* scale, void* out,
                          int r_in, int r_out, int d, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (vectorizable<T>(x, out, d))
    row_gather_kernel<T, V><<<row_blocks(r_out), kThreads, 0, stream>>>(
        xt, idx, scale, ot, r_in, r_out, d);
  else
    row_gather_kernel<T, 1><<<row_blocks(r_out), kThreads, 0, stream>>>(
        xt, idx, scale, ot, r_in, r_out, d);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_gather_sum_vec(const T* x, const int* idx, const float* w, T* out, int r_in,
                                  int nb, int k, int d, cudaStream_t stream) {
  const long long threads = (long long)nb * ((d + VEC - 1) / VEC);
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  if (k == 2)
    row_gather_sum_kernel<T, VEC, 2><<<blocks, kThreads, 0, stream>>>(x, idx, w, out, r_in, nb,
                                                                      k, d);
  else
    row_gather_sum_kernel<T, VEC, 0><<<blocks, kThreads, 0, stream>>>(x, idx, w, out, r_in, nb,
                                                                      k, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gather_sum(const void* x, const int* idx, const float* w, void* out,
                              int r_in, int nb, int k, int d, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (vectorizable<T>(x, out, d))
    return launch_gather_sum_vec<T, V>(xt, idx, w, ot, r_in, nb, k, d, stream);
  return launch_gather_sum_vec<T, 1>(xt, idx, w, ot, r_in, nb, k, d, stream);
}

}  // namespace

extern "C" {

// x (r_in, d), idx (r_out,) int32, scale (r_out,) f32, out (r_out, d), all
// contiguous; dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of
// the launch.
int ff_row_gather(const void* x, const void* idx, const void* scale, void* out, int r_in,
                  int r_out, int d, int dtype, void* stream) {
  if (r_in < 0 || r_out <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(idx);
  const float* sp = static_cast<const float*>(scale);
  if (dtype == 0) return (int)launch_gather<float>(x, ip, sp, out, r_in, r_out, d, s);
  if (dtype == 1)
    return (int)launch_gather<__nv_bfloat16>(x, ip, sp, out, r_in, r_out, d, s);
  return (int)cudaErrorInvalidValue;
}

// x (r_in, d), idx (b, k) int32, w (b, k) f32, out (b, d), all contiguous;
// dtype as above.
int ff_row_gather_sum(const void* x, const void* idx, const void* w, void* out, int r_in,
                      int b, int k, int d, int dtype, void* stream) {
  if (r_in < 0 || b <= 0 || k < 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(idx);
  const float* wp = static_cast<const float*>(w);
  if (dtype == 0) return (int)launch_gather_sum<float>(x, ip, wp, out, r_in, b, k, d, s);
  if (dtype == 1)
    return (int)launch_gather_sum<__nv_bfloat16>(x, ip, wp, out, r_in, b, k, d, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
