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
// is Bsz*D*N states (131 072 at that size), not Bsz*T*D*N.
//
// What the design does about it.  The TPU kernel formed pairwise decay
// products exp(L_t - L_s) over sub-blocks of w steps to feed its matrix
// unit; here each state is one thread's register and the recurrence is run
// step by step, which is the plain version's order of operations (so a scan
// resumed from h0 at any step gives the same bits as one unbroken call):
//  - one thread owns the states n = lane, lane + L, ... of one channel, where
//    L = min(next power of two >= N, 32) lanes per channel sit in one warp
//    (N = 16: two channels per warp, 16 per block of 256 threads);
//  - y is the sum over the channel's lanes by __shfl_xor_sync;
//  - a chunk of TC steps of B_t and C_t (shared by every channel of the
//    block) and of x and delta for the block's channels is staged in shared
//    memory; the next chunk's values are loaded into registers (coalesced)
//    before the current chunk is computed, so the loads are in flight
//    during the compute; y goes out through a shared tile, coalesced;
//  - any Bsz, any T >= 1 (the last chunk runs only its valid steps, so no
//    padded step advances a state), any D (channels past D are masked),
//    N <= 128 (up to 4 states a thread).  expf, not __expf, and no fast math.
// Not done here, and left for later work: splitting T across blocks with the
// associative (a, b) composition, which would help at small Bsz*D.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;
constexpr int TC = 32;          // time steps staged per chunk
constexpr int MAX_N = 128;      // 32 lanes x 4 states a thread

// Load one chunk (rows row0 .. row0+tv-1 of the [Bsz*T] time axis) of x and
// delta for the block's channels and of B and C into registers.
template <int CPB, int RX, int RB>
__device__ __forceinline__ void fetch_chunk(
    const float* __restrict__ x, const float* __restrict__ delta,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    size_t row0, int tv, int d0, int D, int N,
    float (&rx)[RX], float (&rd)[RX], float (&rb)[RB], float (&rc)[RB]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < RX; ++k) {
    const int e = tid + k * THREADS;       // [TC, CPB] element
    const int t = e / CPB, c = e % CPB;
    const bool ok = e < TC * CPB && t < tv && d0 + c < D;
    const size_t g = (row0 + t) * (size_t)D + d0 + c;
    rx[k] = ok ? x[g] : 0.f;
    rd[k] = ok ? delta[g] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < RB; ++k) {
    const int e = tid + k * THREADS;       // [TC, N] element, contiguous in B and C
    const bool ok = e < tv * N;
    const size_t g = row0 * (size_t)N + e;
    rb[k] = ok ? Bm[g] : 0.f;
    rc[k] = ok ? Cm[g] : 0.f;
  }
}

template <int CPB, int RX, int RB>
__device__ __forceinline__ void stage_chunk(
    float* xs, float* ds, float* bs, float* cs, int N,
    const float (&rx)[RX], const float (&rd)[RX], const float (&rb)[RB], const float (&rc)[RB]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < RX; ++k) {
    const int e = tid + k * THREADS;
    if (e < TC * CPB) {
      xs[e] = rx[k];
      ds[e] = rd[k];
    }
  }
#pragma unroll
  for (int k = 0; k < RB; ++k) {
    const int e = tid + k * THREADS;
    if (e < TC * N) {
      bs[e] = rb[k];
      cs[e] = rc[k];
    }
  }
}

// L lanes per channel, S states per lane (N <= S * L).
template <int L, int S>
__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const float* __restrict__ x, const float* __restrict__ delta,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_out,
                int T, int D, int N) {
  constexpr int CPB = THREADS / L;                              // channels per block
  constexpr int RX = (TC * CPB + THREADS - 1) / THREADS;        // x, delta values a thread stages
  constexpr int RB = (TC * S * L + THREADS - 1) / THREADS;      // B, C values a thread stages
  extern __shared__ float smem[];
  float* xs = smem;              // [TC, CPB]
  float* ds = xs + TC * CPB;     // [TC, CPB]
  float* ys = ds + TC * CPB;     // [TC, CPB]
  float* bs = ys + TC * CPB;     // [TC, N]
  float* cs = bs + TC * N;       // [TC, N]

  const int tid = threadIdx.x;
  const int c = tid / L;         // channel within the block
  const int lane = tid % L;      // lane within the channel
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CPB;
  const int d = d0 + c;
  const size_t row_b = (size_t)b * T;

  float a_row[S], h[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = lane + s * L;
    const bool ok = d < D && n < N;
    a_row[s] = ok ? A[(size_t)d * N + n] : 0.f;
    h[s] = (ok && h0 != nullptr) ? h0[((size_t)b * D + d) * N + n] : 0.f;
  }

  float rx[RX], rd[RX], rb[RB], rc[RB];
  const int n_chunks = (T + TC - 1) / TC;
  fetch_chunk<CPB>(x, delta, Bm, Cm, row_b, T < TC ? T : TC, d0, D, N, rx, rd, rb, rc);
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * TC;
    const int tv = T - t0 < TC ? T - t0 : TC;
    stage_chunk<CPB>(xs, ds, bs, cs, N, rx, rd, rb, rc);
    __syncthreads();
    if (ci + 1 < n_chunks) {     // next chunk's loads run during this chunk
      const int t1 = t0 + TC;
      fetch_chunk<CPB>(x, delta, Bm, Cm, row_b + t1, T - t1 < TC ? T - t1 : TC, d0, D, N,
                       rx, rd, rb, rc);
    }
    for (int t = 0; t < tv; ++t) {
      const float dt = ds[t * CPB + c];
      const float dx = dt * xs[t * CPB + c];
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int n = lane + s * L;
        if (n < N) {
          const float a = expf(dt * a_row[s]);
          h[s] = a * h[s] + dx * bs[t * N + n];
          acc += h[s] * cs[t * N + n];
        }
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) ys[t * CPB + c] = acc;
    }
    __syncthreads();             // y tile complete; staging buffers free
    for (int e = tid; e < tv * CPB; e += THREADS) {
      const int t = e / CPB, cc = e % CPB;
      if (d0 + cc < D) y[(row_b + t0 + t) * (size_t)D + d0 + cc] = ys[e];
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = lane + s * L;
    if (d < D && n < N) h_out[((size_t)b * D + d) * N + n] = h[s];
  }
}

template <int L, int S>
cudaError_t launch(const float* x, const float* delta, const float* A, const float* Bm,
                   const float* Cm, const float* h0, float* y, float* h_out,
                   int Bsz, int T, int D, int N, cudaStream_t stream) {
  constexpr int CPB = THREADS / L;
  // all of the kernel's shared memory is dynamic (no static arrays), so the
  // opt-in threshold is on this size alone
  const size_t smem = sizeof(float) * (3 * (size_t)TC * CPB + 2 * (size_t)TC * N);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ssm_scan_kernel<L, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((D + CPB - 1) / CPB, Bsz);
  ssm_scan_kernel<L, S><<<grid, THREADS, smem, stream>>>(x, delta, A, Bm, Cm, h0, y, h_out,
                                                         T, D, N);
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
  int L = 1;
  while (L < N && L < 32) L <<= 1;
  const int S = (N + L - 1) / L;
#define SSM_LAUNCH(l, s) \
  return launch<l, s>(x, delta, A, Bm, Cm, h0, y, h_out, Bsz, T, D, N, stream)
  switch (L) {
    case 1: SSM_LAUNCH(1, 1);
    case 2: SSM_LAUNCH(2, 1);
    case 4: SSM_LAUNCH(4, 1);
    case 8: SSM_LAUNCH(8, 1);
    case 16: SSM_LAUNCH(16, 1);
    default:
      switch (S) {
        case 1: SSM_LAUNCH(32, 1);
        case 2: SSM_LAUNCH(32, 2);
        case 3: SSM_LAUNCH(32, 3);
        default: SSM_LAUNCH(32, 4);
      }
  }
#undef SSM_LAUNCH
}

const char* ssm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
