// Mamba-1 selective scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssm_scan/kernel.py::ssm_scan (Pallas
// body _ssm_kernel):
//   h[t] = exp(delta_t * A) * h[t-1] + (delta_t * x_t) * B_t     per (b, d, n)
//   y[t] = sum_n h[t] * C_t
// over x, delta [Bsz, T, D], A [D, N], B, C [Bsz, T, N], from the carry h0
// [Bsz, D, N] (zeros when absent), giving y [Bsz, T, D] and h_final
// [Bsz, D, N], all fp32.  Unlike the TPU kernel, h0 is an input: a resumed
// scan (chunked prefill) runs here too, with no fallback.
//
// What bounds it on this card.  Per call it moves x, delta and y
// (12 * Bsz*T*D bytes) plus B, C, A and the two carries, and does about
// 6 fp32 operations and one exp per (b, t, d, n).  At Bsz=1, T=256, D=8192,
// N=16 that is 27 MB (8 us at 3.35 TB/s) against 0.2 GFLOP (3 us) and
// 33.5 M exps (8 us on the 16 SFU lanes per SM), so bytes and exps bound it
// about equally.  The time steps form a chain per state, so the parallelism
// is Bsz*D*N states (131 072 at that size, enough to fill the card at
// Bsz = 1), not Bsz*T*D*N.  What held the first version back was issue: one
// state a thread paid its shared loads, a full-precision expf and a 4-level
// shuffle tree for each state-step.
//
// What the design does about it.  Each state is one thread's register and
// the recurrence runs step by step in the plain version's order, with every
// rounding explicit (__fmul_rn, __fmaf_rn, __fadd_rn: no contraction left to
// the compiler), so a scan resumed from h_final at any step, unrolled copy
// or tail, gives the one-shot bits.  T is not split across blocks: the
// associative (a, b) composition would round differently at each split.
//  - a channel has L lanes, each owning S = 4 contiguous states
//    n = S*lane .. S*lane + S-1 (N = 16: L = 4, a warp covers 8 channels and a
//    block of 256 threads 64); B_t and C_t come in one 16-byte shared load
//    each, and y needs a log2(L)-level shuffle (2 at N = 16);
//  - the exp is ex2.approx.ftz(dt * A*log2e), one SFU instruction, with
//    A*log2e formed once per state (relative error about 2^-22; a result
//    below 2^-126 flushes to 0, which leaves h unchanged at this precision);
//  - the step loop is unrolled by U = 8 with every load of the 8 steps before
//    the first store of y, so that the exps and B, C loads of later steps,
//    which do not depend on h, issue while the h chain runs: only the fma
//    h = a*h + dx*B is serial, and the 8 shuffle sums overlap;
//  - chunks of TC steps of x and delta (the block's channels) and of B and C
//    arrive by cp.async into a double-buffered ring in shared memory: chunk
//    i+1 is in flight while chunk i is computed, one __syncthreads a chunk;
//    16-byte copies when D (and N, for B and C) are multiples of 4 and the
//    operands aligned, 4-byte copies otherwise; y goes out through a
//    double-buffered shared tile, coalesced, one chunk behind;
//  - any Bsz <= 65535, any T >= 1 (the last chunk runs only its valid steps,
//    so no padded step advances a state), any D (channels past D are
//    masked), N <= 128 (32 lanes x 4 states; padded states have A = 0 and
//    B = C = 0, so they stay 0 and add nothing).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TC = 32;           // time steps staged per chunk
constexpr int U = 8;             // time steps unrolled
constexpr int NST = 2;           // chunks in the cp.async ring
constexpr int MAX_N = 128;       // 32 lanes x 4 states a thread
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

template <int S>
__device__ __forceinline__ void load_states(const float* p, float (&v)[S]) {
  if constexpr (S == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else if constexpr (S == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x; v[1] = f.y;
  } else {
    v[0] = p[0];
  }
}

// Issue the copies of chunk (rows row0 .. row0+tv-1 of the [Bsz*T] time
// axis) into one ring stage: xs, ds [TC][CPB] for channels d0.., bs, cs
// [TC][NP].  Rows past tv and channels past D are zero-filled; B and C pads
// (n >= N) are never written (zeroed once at the start).
template <int CPB, int NP>
__device__ __forceinline__ void stage_chunk(
    const float* __restrict__ x, const float* __restrict__ delta,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    float* xs, float* ds, float* bs, float* cs,
    size_t row0, int tv, int d0, int D, int N, bool vec_x, bool vec_bc) {
  const int tid = threadIdx.x;
  if (vec_x) {
    constexpr int V = CPB / 4;                     // 16-byte vectors a row
    for (int e = tid; e < TC * V; e += THREADS) {
      const int t = e / V, c = (e - t * V) * 4;
      const bool ok = t < tv && d0 + c < D;
      const size_t g = (row0 + t) * (size_t)D + d0 + c;
      cp_async16(xs + t * CPB + c, ok ? x + g : x, ok);
      cp_async16(ds + t * CPB + c, ok ? delta + g : delta, ok);
    }
  } else {
    for (int e = tid; e < TC * CPB; e += THREADS) {
      const int t = e / CPB, c = e - t * CPB;
      const bool ok = t < tv && d0 + c < D;
      const size_t g = (row0 + t) * (size_t)D + d0 + c;
      cp_async4(xs + e, ok ? x + g : x, ok);
      cp_async4(ds + e, ok ? delta + g : delta, ok);
    }
  }
  const size_t gb = row0 * (size_t)N;
  if (vec_bc) {                                    // N == NP: rows are contiguous
    for (int e = tid * 4; e < TC * NP; e += THREADS * 4) {
      const bool ok = e < tv * N;
      cp_async16(bs + e, ok ? Bm + gb + e : Bm, ok);
      cp_async16(cs + e, ok ? Cm + gb + e : Cm, ok);
    }
  } else {
    for (int e = tid; e < TC * N; e += THREADS) {
      const int t = e / N, n = e - t * N;
      const bool ok = t < tv;
      cp_async4(bs + t * NP + n, ok ? Bm + gb + e : Bm, ok);
      cp_async4(cs + t * NP + n, ok ? Cm + gb + e : Cm, ok);
    }
  }
}

// UN consecutive time steps of the thread's S states of channel c.  All
// loads come before any store, so the compiler may issue the loads and exps
// of later steps while the serial fma chain of h runs; the UN sums over the
// channel's lanes then shuffle together.  Every rounding is explicit, so a
// step gives the same bits wherever it falls (unrolled, tail, after a resume).
template <int L, int S, int CPB, int NP, int UN>
__device__ __forceinline__ void scan_steps(int t0, int c, int lane, const float* xs,
                                           const float* ds, const float* bs, const float* cs,
                                           float* yt, const float (&a2)[S], float (&h)[S]) {
  float acc[UN];
#pragma unroll
  for (int u = 0; u < UN; ++u) {
    const int t = t0 + u;
    const float dt = ds[t * CPB + c];
    const float dx = __fmul_rn(dt, xs[t * CPB + c]);
    float bv[S], cv[S];
    load_states<S>(bs + t * NP + S * lane, bv);
    load_states<S>(cs + t * NP + S * lane, cv);
    acc[u] = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float a = ex2(__fmul_rn(dt, a2[s]));
      h[s] = __fmaf_rn(a, h[s], __fmul_rn(dx, bv[s]));
      acc[u] = __fmaf_rn(h[s], cv[s], acc[u]);
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
#pragma unroll
    for (int u = 0; u < UN; ++u)
      acc[u] = __fadd_rn(acc[u], __shfl_xor_sync(0xffffffffu, acc[u], off));
  if (lane == 0) {
#pragma unroll
    for (int u = 0; u < UN; ++u) yt[(t0 + u) * CPB + c] = acc[u];
  }
}

// L lanes per channel, S contiguous states per lane (N <= S * L).
template <int L, int S>
__global__ void __launch_bounds__(THREADS, 2)
ssm_scan_kernel(const float* __restrict__ x, const float* __restrict__ delta,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_out,
                int T, int D, int N, int vec_x, int vec_bc) {
  constexpr int CPB = THREADS / L;                  // channels per block
  constexpr int NP = L * S;                         // B, C row stride in shared memory
  constexpr int STAGE = 2 * TC * CPB + 2 * TC * NP;
  extern __shared__ __align__(16) float smem[];     // [NST][STAGE], then ys [2][TC][CPB]
  float* ys = smem + NST * STAGE;

  const int tid = threadIdx.x;
  const int c = tid / L;         // channel within the block
  const int lane = tid % L;      // lane within the channel
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CPB;
  const int d = d0 + c;
  const size_t row_b = (size_t)b * T;
  const int n_chunks = (T + TC - 1) / TC;

  if (NP > N) {                  // B, C pads: zero in every stage, never copied into
    for (int e = tid; e < NST * 2 * TC * NP; e += THREADS) {
      const int st = e / (2 * TC * NP), r = e - st * 2 * TC * NP;
      if (r % NP >= N) smem[st * STAGE + 2 * TC * CPB + r] = 0.f;
    }
  }
  // one cp.async group a chunk (empty past the last), so that waiting for
  // all but the NST-2 newest groups always means chunk ci has landed
  auto issue = [&](int ci) {
    if (ci < n_chunks) {
      const int t0 = ci * TC;
      float* st = smem + (ci % NST) * STAGE;
      stage_chunk<CPB, NP>(x, delta, Bm, Cm, st, st + TC * CPB, st + 2 * TC * CPB,
                           st + 2 * TC * CPB + TC * NP, row_b + t0,
                           T - t0 < TC ? T - t0 : TC, d0, D, N, vec_x, vec_bc);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int ci = 0; ci < NST - 1; ++ci) issue(ci);

  float a2[S], h[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = S * lane + s;
    const bool ok = d < D && n < N;
    a2[s] = ok ? A[(size_t)d * N + n] * LOG2E : 0.f;
    h[s] = (ok && h0 != nullptr) ? h0[((size_t)b * D + d) * N + n] : 0.f;
  }

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * TC;
    const int tv = T - t0 < TC ? T - t0 : TC;
    cp_async_wait<NST - 2>();
    __syncthreads();             // chunk ci landed; chunk ci-1's stage and y tile are free
    issue(ci + NST - 1);         // in flight during chunks ci .. ci+NST-2
    if (ci > 0) {                // chunk ci-1's y, complete since the barrier
      const float* yt = ys + ((ci - 1) & 1) * TC * CPB;
      for (int e = tid; e < TC * CPB; e += THREADS) {
        const int t = e / CPB, cc = e % CPB;
        if (d0 + cc < D) y[(row_b + t0 - TC + t) * (size_t)D + d0 + cc] = yt[e];
      }
    }

    const float* st = smem + (ci % NST) * STAGE;
    const float* xs = st;
    const float* ds = st + TC * CPB;
    const float* bs = st + 2 * TC * CPB;
    const float* cs = bs + TC * NP;
    float* yt = ys + (ci & 1) * TC * CPB;
    int t = 0;
    for (; t + U <= tv; t += U)
      scan_steps<L, S, CPB, NP, U>(t, c, lane, xs, ds, bs, cs, yt, a2, h);
    for (; t < tv; ++t) scan_steps<L, S, CPB, NP, 1>(t, c, lane, xs, ds, bs, cs, yt, a2, h);
  }
  __syncthreads();               // the last chunk's y tile is complete
  {
    const int t0 = (n_chunks - 1) * TC;
    const int tv = T - t0;
    const float* yt = ys + ((n_chunks - 1) & 1) * TC * CPB;
    for (int e = tid; e < tv * CPB; e += THREADS) {
      const int t = e / CPB, cc = e % CPB;
      if (d0 + cc < D) y[(row_b + t0 + t) * (size_t)D + d0 + cc] = yt[e];
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = S * lane + s;
    if (d < D && n < N) h_out[((size_t)b * D + d) * N + n] = h[s];
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int L, int S>
cudaError_t launch(const float* x, const float* delta, const float* A, const float* Bm,
                   const float* Cm, const float* h0, float* y, float* h_out,
                   int Bsz, int T, int D, int N, cudaStream_t stream) {
  constexpr int CPB = THREADS / L;
  constexpr int NP = L * S;
  // all of the kernel's shared memory is dynamic (no static arrays), so the
  // opt-in threshold is on this size alone
  const size_t smem = sizeof(float) * (NST * (2 * (size_t)TC * CPB + 2 * (size_t)TC * NP)
                                       + 2 * (size_t)TC * CPB);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ssm_scan_kernel<L, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int vec_x = D % 4 == 0 && aligned16(x) && aligned16(delta);
  const int vec_bc = N == NP && N % 4 == 0 && aligned16(Bm) && aligned16(Cm);
  const dim3 grid((D + CPB - 1) / CPB, Bsz);
  ssm_scan_kernel<L, S><<<grid, THREADS, smem, stream>>>(x, delta, A, Bm, Cm, h0, y, h_out,
                                                         T, D, N, vec_x, vec_bc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous fp32 arrays: x, delta
// [Bsz, T, D], A [D, N], B, C [Bsz, T, N], h0 [Bsz, D, N] or null (zeros),
// y [Bsz, T, D], h_out [Bsz, D, N].  Launches on `stream` and does not
// synchronise.  Returns the launch's cudaError_t (cudaErrorInvalidValue for
// sizes it does not take: N > 128, Bsz > 65535, or an empty axis).
int ssm_scan_f32(const float* x, const float* delta, const float* A, const float* Bm,
                 const float* Cm, const float* h0, float* y, float* h_out,
                 int Bsz, int T, int D, int N, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (Bsz < 1 || T < 1 || D < 1 || N < 1 || N > MAX_N || Bsz > 65535)
    return cudaErrorInvalidValue;
#define SSM_LAUNCH(l, s) \
  return launch<l, s>(x, delta, A, Bm, Cm, h0, y, h_out, Bsz, T, D, N, stream)
  if (N == 1) SSM_LAUNCH(1, 1);
  if (N == 2) SSM_LAUNCH(1, 2);
  if (N <= 4) SSM_LAUNCH(1, 4);
  if (N <= 8) SSM_LAUNCH(2, 4);
  if (N <= 16) SSM_LAUNCH(4, 4);
  if (N <= 32) SSM_LAUNCH(8, 4);
  if (N <= 64) SSM_LAUNCH(16, 4);
  SSM_LAUNCH(32, 4);
#undef SSM_LAUNCH
}

const char* ssm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
