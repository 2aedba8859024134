// Fused LSTM over a sequence, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/lstm_cell/kernel.py::lstm_seq
// (Pallas body _lstm_kernel): y, h_T, c_T = LSTM(x; w_x, w_h, b; h0, c0) with
// gate order i, f, g, o, sigma(v) = 0.5 * (1 + tanh(0.5 * v)), h and c in
// fp32, and an optional ROM-LUT tanh (paper section IV-B).
//
// What bounds it on this card.  Per call the work is 2*B*T*(D+H)*4H FLOPs
// (4.3 GFLOP at B=1, T=256, D=H=1024) against 67 TFLOP/s of fp32 FMA outside
// the tensor cores, and about 32 MB of weights against 3.35 TB/s, so by the
// roofline it is bound by operations (about 64 us).  In practice it is bound
// by the recurrence: step t+1 needs all of h_t, so the T steps form a chain,
// and every step reads all of w_h ([H, 4H], 16 MB at full width) to do only
// 2*B*H*4H FLOPs.  At serving batch sizes each step is a short, latency-bound
// pass over w_h.
//
// What the design does about it.
//  (a) The part of the product that does not recur, zx = x @ w_x + b over
//      all B*T rows, is one tiled fp32 GEMM (shared-memory tiles, FMA, no
//      tensor cores and no TF32), parallel over every time step.
//  (b) The recurrence is one launch per time step from the host function
//      below (no Python in the loop).  Each block owns STEP_UNITS hidden
//      units for a tile of batch rows and computes all four gate columns of
//      those units, so the cell update needs no exchange between blocks.
//      The w_h columns are spread over H/STEP_UNITS blocks (128 at H=1024),
//      so one step reads w_h once across the whole card; at 16 MB it stays
//      resident in the 50 MB L2 from one step to the next.
//  Every block reads all of h_prev in a step, so h and c are ping-pong
//  buffers (read h_prev, write h_next), never updated in place.
//  Not done here, and left for later work: keeping w_h resident in shared
//  memory across the card, wgmma/TMA, and a persistent kernel with a grid
//  barrier instead of one launch per step.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// ---------------------------------------------------------------------------
// (a) input projection: zx[M, N] = x[M, K] @ w[K, N] + bias[N], row-major
// ---------------------------------------------------------------------------

constexpr int GEMM_BM = 64;
constexpr int GEMM_BN = 64;
constexpr int GEMM_BK = 16;
constexpr int GEMM_TM = 4;
constexpr int GEMM_TN = 4;
constexpr int GEMM_THREADS = (GEMM_BM / GEMM_TM) * (GEMM_BN / GEMM_TN);  // 256

__global__ void __launch_bounds__(GEMM_THREADS)
input_projection(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ zx,
                 int M, int N, int K) {
  __shared__ float As[GEMM_BK][GEMM_BM + 4];  // A tile, stored k-major
  __shared__ float Bs[GEMM_BK][GEMM_BN];

  const int tid = threadIdx.x;
  const int tx = tid % (GEMM_BN / GEMM_TN);
  const int ty = tid / (GEMM_BN / GEMM_TN);
  const int row0 = blockIdx.y * GEMM_BM;
  const int col0 = blockIdx.x * GEMM_BN;

  float acc[GEMM_TM][GEMM_TN];
#pragma unroll
  for (int i = 0; i < GEMM_TM; ++i)
#pragma unroll
    for (int j = 0; j < GEMM_TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += GEMM_BK) {
    for (int i = tid; i < GEMM_BM * GEMM_BK; i += GEMM_THREADS) {
      const int m = i / GEMM_BK, k = i % GEMM_BK;
      const int gm = row0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.0f;
    }
    for (int i = tid; i < GEMM_BK * GEMM_BN; i += GEMM_THREADS) {
      const int k = i / GEMM_BN, n = i % GEMM_BN;
      const int gk = k0 + k, gn = col0 + n;
      Bs[k][n] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < GEMM_BK; ++k) {
      float a[GEMM_TM], bv[GEMM_TN];
#pragma unroll
      for (int i = 0; i < GEMM_TM; ++i) a[i] = As[k][ty * GEMM_TM + i];
#pragma unroll
      for (int j = 0; j < GEMM_TN; ++j) bv[j] = Bs[k][tx * GEMM_TN + j];
#pragma unroll
      for (int i = 0; i < GEMM_TM; ++i)
#pragma unroll
        for (int j = 0; j < GEMM_TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < GEMM_TM; ++i) {
    const int gm = row0 + ty * GEMM_TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < GEMM_TN; ++j) {
      const int gn = col0 + tx * GEMM_TN + j;
      if (gn < N) zx[(size_t)gm * N + gn] = acc[i][j] + bias[gn];
    }
  }
}

// ---------------------------------------------------------------------------
// gate activations, exact or from the ROM table
// ---------------------------------------------------------------------------

// The reference's kernels/_lut.py::lut_interpolate: clamp to [-4, 4 - 1e-6),
// take the fractional table position, interpolate between entries i0 and
// min(i0 + 1, n - 1).  frac is not clipped, as in the reference.
__device__ __forceinline__ float lut_interpolate(float v, const float* lut, int n) {
  const float xf = fminf(fmaxf(v, -4.0f), 4.0f - 1e-6f);
  const float pos = (xf + 4.0f) / 8.0f * (float)n - 0.5f;
  const int i0 = min(max((int)floorf(pos), 0), n - 1);
  const float frac = pos - (float)i0;
  const int i1 = min(i0 + 1, n - 1);
  return lut[i0] * (1.0f - frac) + lut[i1] * frac;
}

__device__ __forceinline__ float act_tanh(float v, const float* lut, int n) {
  return n ? lut_interpolate(v, lut, n) : tanhf(v);
}

__device__ __forceinline__ float act_sigmoid(float v, const float* lut, int n) {
  return 0.5f * (1.0f + act_tanh(0.5f * v, lut, n));
}

// ---------------------------------------------------------------------------
// (b) one time step of the recurrence
// ---------------------------------------------------------------------------

constexpr int STEP_UNITS = 8;                           // hidden units per block
constexpr int STEP_COLS = 4 * STEP_UNITS;               // their four gate columns
constexpr int STEP_KSPLIT = 8;                          // warps sharing the contraction
constexpr int STEP_THREADS = STEP_COLS * STEP_KSPLIT;   // 256
constexpr int STEP_MAX_ROWS = 8;                        // batch rows per block
constexpr size_t STEP_SMEM_LIMIT = 200 * 1024;          // dynamic shared memory cap

// Grid: (ceil(H / STEP_UNITS), ceil(B / rows)).  Thread (ks, col) sums
// h_prev[r, k] * w_h[k, gate*H + j] over k = ks, ks + STEP_KSPLIT, ...; the
// STEP_KSPLIT partial sums meet in shared memory, and one thread per
// (row, unit) adds zx, applies the gates and writes c, h and y[:, t].
__global__ void __launch_bounds__(STEP_THREADS)
lstm_step(const float* __restrict__ zx, const float* __restrict__ w_h,
          const float* __restrict__ lut, int n_lut,
          const float* __restrict__ h_prev, const float* __restrict__ c_prev,
          float* __restrict__ h_next, float* __restrict__ c_next,
          float* __restrict__ y, int B, int T, int H, int t, int rows) {
  extern __shared__ float smem[];
  float* h_s = smem;                  // [rows, H] slice of h_prev
  float* lut_s = smem + (size_t)rows * H;
  __shared__ float part[STEP_KSPLIT][STEP_MAX_ROWS][STEP_COLS];

  const int tid = threadIdx.x;
  const int col = tid % STEP_COLS;
  const int ks = tid / STEP_COLS;
  const int gate = col / STEP_UNITS;
  const int j0 = blockIdx.x * STEP_UNITS;
  const int b0 = blockIdx.y * rows;
  const int nb = min(rows, B - b0);
  const size_t H4 = 4 * (size_t)H;

  for (int i = tid; i < nb * H; i += STEP_THREADS) h_s[i] = h_prev[(size_t)b0 * H + i];
  for (int i = tid; i < n_lut; i += STEP_THREADS) lut_s[i] = lut[i];
  __syncthreads();

  float acc[STEP_MAX_ROWS];
#pragma unroll
  for (int r = 0; r < STEP_MAX_ROWS; ++r) acc[r] = 0.0f;
  const int j = j0 + col % STEP_UNITS;
  if (j < H) {
    const float* wcol = w_h + (size_t)gate * H + j;
#pragma unroll 4
    for (int k = ks; k < H; k += STEP_KSPLIT) {
      const float wk = __ldg(wcol + (size_t)k * H4);
#pragma unroll
      for (int r = 0; r < STEP_MAX_ROWS; ++r)
        if (r < nb) acc[r] = fmaf(h_s[(size_t)r * H + k], wk, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < STEP_MAX_ROWS; ++r) part[ks][r][col] = acc[r];
  __syncthreads();

  if (tid < nb * STEP_UNITS) {
    const int r = tid / STEP_UNITS;
    const int u = tid % STEP_UNITS;
    const int jj = j0 + u;
    if (jj < H) {
      const int b = b0 + r;
      const float* zrow = zx + ((size_t)b * T + t) * H4;
      float z[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float s = zrow[(size_t)g * H + jj];
#pragma unroll
        for (int q = 0; q < STEP_KSPLIT; ++q) s += part[q][r][g * STEP_UNITS + u];
        z[g] = s;
      }
      const float* tab = lut_s;
      const float i_g = act_sigmoid(z[0], tab, n_lut);
      const float f_g = act_sigmoid(z[1], tab, n_lut);
      const float g_g = act_tanh(z[2], tab, n_lut);
      const float o_g = act_sigmoid(z[3], tab, n_lut);
      const size_t bj = (size_t)b * H + jj;
      const float c = f_g * c_prev[bj] + i_g * g_g;
      const float h = o_g * act_tanh(c, tab, n_lut);
      c_next[bj] = c;
      h_next[bj] = h;
      y[((size_t)b * T + t) * H + jj] = h;
    }
  }
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous fp32 arrays:
//   x [B, T, D], w_x [D, 4H], w_h [H, 4H], b [4H], h0 / c0 [B, H],
//   lut [n_lut] (ignored when n_lut == 0),
//   y [B, T, H], h_out / c_out [B, H] (outputs),
//   zx [B, T, 4H], h_buf / c_buf [2, B, H] (scratch).
// Launches on `stream` and does not synchronise.  Returns the cudaError_t
// of the first launch that failed, or 0.
int lstm_seq_f32(const float* x, const float* w_x, const float* w_h, const float* b,
                 const float* h0, const float* c0, const float* lut, int n_lut,
                 float* y, float* h_out, float* c_out,
                 float* zx, float* h_buf, float* c_buf,
                 int B, int T, int D, int H, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B < 1 || T < 1 || D < 1 || H < 1 || n_lut < 0) return cudaErrorInvalidValue;

  const int M = B * T;
  const int N = 4 * H;
  const dim3 ggrid((N + GEMM_BN - 1) / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM);
  input_projection<<<ggrid, GEMM_THREADS, 0, stream>>>(x, w_x, b, zx, M, N, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  int rows = B < STEP_MAX_ROWS ? B : STEP_MAX_ROWS;
  while (rows > 0 && ((size_t)rows * H + n_lut) * sizeof(float) > STEP_SMEM_LIMIT) --rows;
  if (rows == 0) return cudaErrorInvalidValue;
  const size_t smem = ((size_t)rows * H + n_lut) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lstm_step, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }

  const size_t BH = (size_t)B * H;
  const dim3 sgrid((H + STEP_UNITS - 1) / STEP_UNITS, (B + rows - 1) / rows);
  for (int t = 0; t < T; ++t) {
    const float* hp = t == 0 ? h0 : h_buf + ((t - 1) & 1) * BH;
    const float* cp = t == 0 ? c0 : c_buf + ((t - 1) & 1) * BH;
    float* hn = t == T - 1 ? h_out : h_buf + (t & 1) * BH;
    float* cn = t == T - 1 ? c_out : c_buf + (t & 1) * BH;
    lstm_step<<<sgrid, STEP_THREADS, smem, stream>>>(zx, w_h, lut, n_lut, hp, cp, hn, cn,
                                                     y, B, T, H, t, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return 0;
}

const char* lstm_seq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
