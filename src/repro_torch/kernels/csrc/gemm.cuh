// The port's tiled fp32 GEMM, shared by lstm_seq.cu (x @ w_x + b over all
// B*T rows) and the generated stage kernels (codegen/cuda_emit.py: the
// input-only rows of a MACC hoisted out of the step loop).
//
// One block of 256 threads computes one 64 x 64 tile of C = A @ W with
// 16-deep k-tiles of A and W staged in shared memory (the next one loaded
// into registers during the current one's products) and a 4 x 4 patch of C
// in each thread's registers: fp32 FMAs, no tensor cores, no TF32, so the
// results hold against the plain versions at fp32 rounding.
//
// `tile` takes its operands through functors, so a caller can read A as a
// lane function (a generated kernel's input row) and W as a row block of a
// concatenated ROM, fp32 or int8 codes dequantised as read (`rom`);
// `rows_gemm` is the plain form over row-major fp32 arrays (lstm_seq).

#pragma once

#include <stddef.h>
#include <stdint.h>

namespace gemm {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

// The tile of C at (blockIdx.y * BM, blockIdx.x * BN).  load_a(m, k) and
// load_w(k, n) are called for in-range indices only; store(m, n, acc) once
// per in-range element of C.
template <class LoadA, class LoadW, class Store>
__device__ __forceinline__ void tile(int M, int N, int K, LoadA load_a, LoadW load_w,
                                     Store store) {
  __shared__ float As[BK][BM + 4];  // A tile, stored k-major
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  // the next k-tile is loaded into registers while this one is multiplied
  constexpr int A_LOADS = BM * BK / THREADS;
  constexpr int W_LOADS = BK * BN / THREADS;
  float ra[A_LOADS], rw[W_LOADS];
  const auto fetch = [&](int k0) {
#pragma unroll
    for (int q = 0; q < A_LOADS; ++q) {
      const int i = tid + q * THREADS;
      const int gm = row0 + i / BK, gk = k0 + i % BK;
      ra[q] = (gm < M && gk < K) ? load_a(gm, gk) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < W_LOADS; ++q) {
      const int i = tid + q * THREADS;
      const int gk = k0 + i / BN, gn = col0 + i % BN;
      rw[q] = (gk < K && gn < N) ? load_w(gk, gn) : 0.0f;
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int q = 0; q < A_LOADS; ++q) {
      const int i = tid + q * THREADS;
      As[i % BK][i / BK] = ra[q];
    }
#pragma unroll
    for (int q = 0; q < W_LOADS; ++q) {
      const int i = tid + q * THREADS;
      Bs[i / BN][i % BN] = rw[q];
    }
    __syncthreads();
    if (k0 + BK < K) fetch(k0 + BK);
    // a k-tile's sum is added to the total as one term: K / BK + BK
    // roundings in a chain instead of K
    float tile_sum[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) tile_sum[i][j] = 0.0f;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[k][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) tile_sum[i][j] = fmaf(a[i], bv[j], tile_sum[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += tile_sum[i][j];
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = col0 + tx * TN + j;
      if (gn < N) store(gm, gn, acc[i][j]);
    }
  }
}

// One element of a weight ROM, fp32 or an int8 code times its column's
// scale (the shared int8 form x @ (w_q * s), dequantised as read).
__device__ __forceinline__ float rom(const float* w, size_t i, const float*, int) {
  return __ldg(w + i);
}
__device__ __forceinline__ float rom(const int8_t* w, size_t i, const float* scale, int n) {
  return (float)__ldg(w + i) * __ldg(scale + n);
}

// out[m * N + n] = sum_k x[m * K + k] * w[k * N + n] + bias[n], all row-major
// fp32.  Grid: (ceil(N / BN), ceil(M / BM)), THREADS threads, no dynamic smem.
__global__ void __launch_bounds__(THREADS)
rows_gemm(const float* __restrict__ x, const float* __restrict__ w,
          const float* __restrict__ bias, float* __restrict__ out, int M, int N, int K) {
  tile(
      M, N, K, [&](int m, int k) { return __ldg(x + (size_t)m * K + k); },
      [&](int k, int n) { return __ldg(w + (size_t)k * N + n); },
      [&](int m, int n, float acc) { out[(size_t)m * N + n] = acc + __ldg(bias + n); });
}

}  // namespace gemm
