// Fused LSTM over a sequence, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/lstm_cell/kernel.py::lstm_seq
// (Pallas body _lstm_kernel): y, h_T, c_T = LSTM(x; w_x, w_h, b; h0, c0) with
// gate order i, f, g, o, sigma(v) = 0.5 * (1 + tanh(0.5 * v)), h and c in
// fp32, and an optional ROM-LUT tanh (paper section IV-B; lut.cuh).
//
// What bounds it on this card.  Per call the work is 2*B*T*(D+H)*4H FLOPs
// (4.3 GFLOP at B=1, T=256, D=H=1024) against 67 TFLOP/s of fp32 FMA outside
// the tensor cores, and about 32 MB of weights against 3.35 TB/s, so by the
// roofline it is bound by operations (about 64 us).  In practice it is bound
// by the recurrence: step t+1 needs all of h_t, so the T steps form a chain
// of B*H*4H-FMA steps, each far too small to fill the card, and a step costs
// what it takes to exchange h_t across the grid.
//
// What the design does about it: two launches per call.
//  (a) The part of the product that does not recur, zx = x @ w_x + b over
//      all B*T rows, is one tiled fp32 GEMM (gemm.cuh), parallel over every
//      time step.
//  (b) One persistent cooperative kernel runs all T steps.  Each block owns
//      STEP_UNITS hidden units (a unit tile) and computes all four gate
//      columns of them, so the cell update needs no exchange between blocks
//      and a step needs one grid barrier (grid_barrier.cuh), after h_t is
//      written.  The block's [H, 4 * STEP_UNITS] slice of w_h is loaded into
//      shared memory once, before step 0 (128 KiB at H = 1024 over 128
//      blocks), so a step reads only h_{t-1} (B*H floats, from L2) and zx.
//      When the slices do not fit (H too large for the grid the card can
//      hold), the same kernel reads w_h from global memory instead.  More
//      than STEP_MAX_ROWS batch rows are taken in row tiles inside the block.
//  Every block reads all of h_{t-1} in a step, so h and c are ping-pong
//  buffers (read h_prev, write h_next), never updated in place, and they are
//  read with plain loads: another block wrote them within this launch.
//  Not done here, and left for later work: wgmma/TMA, TF32, and keeping c in
//  registers across steps.

#include <cuda_runtime.h>
#include <stddef.h>

#include <mutex>

#include "gemm.cuh"
#include "grid_barrier.cuh"
#include "lut.cuh"

namespace {

// ---------------------------------------------------------------------------
// gate activations, exact or from the ROM table
// ---------------------------------------------------------------------------

// lut_interpolate (lut.cuh) with the table and its shifted partner, both in
// shared memory: lut1[i] = lut[min(i + 1, n - 1)].
__device__ __forceinline__ float act_tanh(float v, const float* lut, int n) {
  return n ? lut_interpolate(v, lut, lut + n, n) : tanhf(v);
}

__device__ __forceinline__ float act_sigmoid(float v, const float* lut, int n) {
  return 0.5f * (1.0f + act_tanh(0.5f * v, lut, n));
}

// ---------------------------------------------------------------------------
// (b) the recurrence, all T steps in one launch
// ---------------------------------------------------------------------------

constexpr int STEP_UNITS = 8;                           // hidden units per unit tile
constexpr int STEP_COLS = 4 * STEP_UNITS;               // their four gate columns
constexpr int STEP_KSPLIT = 8;                          // warps sharing the contraction
constexpr int STEP_THREADS = STEP_COLS * STEP_KSPLIT;   // 256
constexpr int STEP_MAX_ROWS = 8;                        // batch rows per row tile

struct StepArgs {
  const float* zx;     // [B, T, 4H] from (a); written by the previous launch
  const float* w_h;    // [H, 4H]
  const float* lut;    // [n_lut] or null
  const float* h0;
  const float* c0;
  float* h_buf;        // [2, B, H] ping-pong
  float* c_buf;
  float* h_out;
  float* c_out;
  float* y;            // [B, T, H]
  GridBarrier* bar;
  int n_lut, B, T, H;
  int rows;            // batch rows per row tile
  int resident;        // w_h slices in shared memory
};

// acc[r] += sum_k h_s[r, k] * w[k, col] over warp ks's contiguous share of
// k, for NB rows (a compile-time count, so that the loop issues only its
// loads and FMAs).  Resident slices are laid out [Hp / 4][STEP_COLS][4]:
// one 16-byte load gives a thread four k of its column, conflict-free across
// the warp, and the h rows are read four k at a time as broadcasts.
template <int NB>
__device__ __forceinline__ void dot_resident(const float* h_s, int Hp, const float4* w4,
                                             int ks, float* acc) {
  const int k4 = Hp / 4;
  const int per = (k4 + STEP_KSPLIT - 1) / STEP_KSPLIT;
  const int q1 = min(ks * per + per, k4);
#pragma unroll 2
  for (int q = ks * per; q < q1; ++q) {
    const float4 w = w4[(size_t)q * STEP_COLS];
#pragma unroll
    for (int r = 0; r < NB; ++r) {
      const float4 x = reinterpret_cast<const float4*>(h_s + (size_t)r * Hp)[q];
      acc[r] = fmaf(x.x, w.x, acc[r]);
      acc[r] = fmaf(x.y, w.y, acc[r]);
      acc[r] = fmaf(x.z, w.z, acc[r]);
      acc[r] = fmaf(x.w, w.w, acc[r]);
    }
  }
}

// The same sum with w read from global memory: column `wcol`, row stride ld.
template <int NB>
__device__ __forceinline__ void dot_global(const float* h_s, int Hp, int H, const float* wcol,
                                           size_t ld, int ks, float* acc) {
#pragma unroll 4
  for (int k = ks; k < H; k += STEP_KSPLIT) {
    const float w = __ldg(wcol + (size_t)k * ld);
#pragma unroll
    for (int r = 0; r < NB; ++r) acc[r] = fmaf(h_s[(size_t)r * Hp + k], w, acc[r]);
  }
}

#define LSTM_ROWS_CASE(n, CALL) \
  case n:                       \
    CALL(n);                    \
    break;
#define LSTM_DISPATCH_ROWS(nb, CALL)                                                      \
  switch (nb) {                                                                         \
    LSTM_ROWS_CASE(1, CALL) LSTM_ROWS_CASE(2, CALL) LSTM_ROWS_CASE(3, CALL)               \
    LSTM_ROWS_CASE(4, CALL) LSTM_ROWS_CASE(5, CALL) LSTM_ROWS_CASE(6, CALL)               \
    LSTM_ROWS_CASE(7, CALL) LSTM_ROWS_CASE(8, CALL)                                       \
  }

// Dynamic shared memory: [resident slices: tiles-per-block x Hp x STEP_COLS]
// [h rows: rows x Hp] [lut, lut shifted by one: 2 x n_lut], with Hp = H
// rounded up to a multiple of 4 (the pad is zero).  Thread (ks, col) sums
// h_prev[r, k] * w_h[k, gate*H + j] over its warp's share of k; the partial
// sums meet in `part`, and one thread per (row, unit) adds zx, applies the
// gates and writes c, h and y[:, t].
__global__ void __launch_bounds__(STEP_THREADS) lstm_persistent(StepArgs a) {
  extern __shared__ float smem[];
  __shared__ float part[STEP_KSPLIT][STEP_MAX_ROWS][STEP_COLS];

  const int tid = threadIdx.x;
  const int col = tid % STEP_COLS;
  const int ks = tid / STEP_COLS;
  const int gate = col / STEP_UNITS;
  const int H = a.H;
  const size_t H4 = 4 * (size_t)H;
  const size_t BH = (size_t)a.B * H;
  const int Hp = (H + 3) / 4 * 4;
  const int tiles = (H + STEP_UNITS - 1) / STEP_UNITS;
  const int per_block = (tiles + gridDim.x - 1) / gridDim.x;
  float* w_s = smem;                                                   // resident slices
  float* h_s = smem + (a.resident ? (size_t)per_block * Hp * STEP_COLS : 0);
  float* lut_s = h_s + (size_t)a.rows * Hp;

  for (int i = tid; i < a.n_lut; i += STEP_THREADS) {
    lut_s[i] = a.lut[i];
    lut_s[a.n_lut + i] = a.lut[min(i + 1, a.n_lut - 1)];
  }
  if (a.resident) {
    int lt = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++lt) {
      float* ws = w_s + (size_t)lt * Hp * STEP_COLS;
      for (int i = tid; i < Hp * STEP_COLS; i += STEP_THREADS) {   // i = (q, c, e)
        const int e = i % 4, c = i / 4 % STEP_COLS, k = i / (4 * STEP_COLS) * 4 + e;
        const int j = tile * STEP_UNITS + c % STEP_UNITS;
        ws[i] = j < H && k < H
                    ? __ldg(a.w_h + (size_t)k * H4 + (size_t)(c / STEP_UNITS) * H + j)
                    : 0.0f;
      }
    }
  }

  for (int t = 0; t < a.T; ++t) {
    const float* hp = t == 0 ? a.h0 : a.h_buf + ((t - 1) & 1) * BH;
    const float* cp = t == 0 ? a.c0 : a.c_buf + ((t - 1) & 1) * BH;
    float* hn = t == a.T - 1 ? a.h_out : a.h_buf + (t & 1) * BH;
    float* cn = t == a.T - 1 ? a.c_out : a.c_buf + (t & 1) * BH;
    for (int b0 = 0; b0 < a.B; b0 += a.rows) {
      const int nb = min(a.rows, a.B - b0);
      __syncthreads();  // h_s of the previous row tile is no longer read
      for (int i = tid; i < nb * Hp; i += STEP_THREADS) {
        const int r = i / Hp, k = i - r * Hp;
        h_s[i] = k < H ? hp[(size_t)(b0 + r) * H + k] : 0.0f;
      }
      __syncthreads();
      int lt = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++lt) {
        const int j0 = tile * STEP_UNITS;
        // the gate thread's zx and c_prev do not depend on h: in flight
        // during the contraction
        const int gr = tid / STEP_UNITS;
        const int gj = j0 + tid % STEP_UNITS;
        const bool gate_thread = tid < nb * STEP_UNITS && gj < H;
        float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float c_prev = 0.0f;
        if (gate_thread) {
          const float* zrow = a.zx + ((size_t)(b0 + gr) * a.T + t) * H4;
#pragma unroll
          for (int g = 0; g < 4; ++g) z[g] = __ldg(zrow + (size_t)g * H + gj);
          c_prev = cp[(size_t)(b0 + gr) * H + gj];
        }
        float acc[STEP_MAX_ROWS];
#pragma unroll
        for (int r = 0; r < STEP_MAX_ROWS; ++r) acc[r] = 0.0f;
        const int j = j0 + col % STEP_UNITS;
        if (j < H) {
          if (a.resident) {
            const float4* w4 =
                reinterpret_cast<const float4*>(w_s + (size_t)lt * Hp * STEP_COLS) + col;
#define LSTM_DOT(n) dot_resident<n>(h_s, Hp, w4, ks, acc)
            LSTM_DISPATCH_ROWS(nb, LSTM_DOT)
#undef LSTM_DOT
          } else {
            const float* wcol = a.w_h + (size_t)gate * H + j;
#define LSTM_DOT(n) dot_global<n>(h_s, Hp, H, wcol, H4, ks, acc)
            LSTM_DISPATCH_ROWS(nb, LSTM_DOT)
#undef LSTM_DOT
          }
        }
#pragma unroll
        for (int r = 0; r < STEP_MAX_ROWS; ++r) part[ks][r][col] = acc[r];
        __syncthreads();

        if (gate_thread) {
          const int u = tid % STEP_UNITS;
#pragma unroll
          for (int g = 0; g < 4; ++g) {
#pragma unroll
            for (int q = 0; q < STEP_KSPLIT; ++q) z[g] += part[q][gr][g * STEP_UNITS + u];
          }
          const float* tab = lut_s;
          const float i_g = act_sigmoid(z[0], tab, a.n_lut);
          const float f_g = act_sigmoid(z[1], tab, a.n_lut);
          const float g_g = act_tanh(z[2], tab, a.n_lut);
          const float o_g = act_sigmoid(z[3], tab, a.n_lut);
          const size_t bj = (size_t)(b0 + gr) * H + gj;
          const float c = f_g * c_prev + i_g * g_g;
          const float h = o_g * act_tanh(c, tab, a.n_lut);
          cn[bj] = c;
          hn[bj] = h;
          a.y[((size_t)(b0 + gr) * a.T + t) * H + gj] = h;
        }
        __syncthreads();  // part is rewritten by the next unit tile
      }
    }
    if (t + 1 < a.T && !grid_sync(a.bar)) return;
  }
}

// The launch configuration of (b) for device `dev`: grid, residency,
// dynamic shared memory and batch rows per row tile (at most `rows`).  The
// grid is one block per unit tile, at most as many as can be resident at
// once (so the grid barrier cannot hang); the slices are resident when they
// fit beside the h rows and the tables in the opt-in shared memory.
struct StepConfig {
  int grid, resident, rows;
  size_t smem;
};

cudaError_t step_config_query(int dev, int rows, int H, int n_lut, StepConfig* cfg) {
  int sms = 0, optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, lstm_persistent);
  if (err != cudaSuccess) return err;
  const size_t limit = (size_t)optin - fa.sharedSizeBytes;   // the static `part` counts too
  // the whole opt-in, before the occupancy query, which reads it: above
  // 48 KB in all, the static `part` included, a launch without it is
  // refused; set to the most, it serves every configuration of the device
  err = cudaFuncSetAttribute(lstm_persistent, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)limit);
  if (err != cudaSuccess) return err;

  const int tiles = (H + STEP_UNITS - 1) / STEP_UNITS;
  const size_t Hp = (H + 3) / 4 * 4;
  while (rows > 0 && (rows * Hp + 2 * (size_t)n_lut) * sizeof(float) > limit) --rows;
  if (rows == 0) return cudaErrorInvalidValue;
  const size_t base = (rows * Hp + 2 * (size_t)n_lut) * sizeof(float);
  const auto slices = [&](int grid) {
    return (size_t)((tiles + grid - 1) / grid) * Hp * STEP_COLS * sizeof(float);
  };
  int grid = tiles < sms ? tiles : sms;
  const int resident = base + slices(grid) <= limit;
  size_t smem = base + (resident ? slices(grid) : 0);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lstm_persistent, STEP_THREADS,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // more co-resident blocks than SMs (small H): more of the unit tiles at
  // once; slices(grid) only shrinks, so the occupancy found still holds
  const int more = per_sm * sms < tiles ? per_sm * sms : tiles;
  if (more > grid) {
    grid = more;
    smem = base + (resident ? slices(grid) : 0);
  }
  cfg->grid = grid;
  cfg->resident = resident;
  cfg->rows = rows;
  cfg->smem = smem;
  return cudaSuccess;
}

// step_config_query, kept for the last 16 (device, row tile, H, n_lut): the
// attribute and occupancy queries would otherwise cost host time on every
// call.  B enters only through its row tile, min(B, STEP_MAX_ROWS).
cudaError_t step_config(int B, int H, int n_lut, StepConfig* cfg) {
  struct Entry {
    int dev, rows, H, n_lut;
    StepConfig cfg;
  };
  static std::mutex mu;
  static Entry cache[16];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int rows = B < STEP_MAX_ROWS ? B : STEP_MAX_ROWS;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used && i < 16; ++i) {
    const Entry& e = cache[i];
    if (e.dev == dev && e.rows == rows && e.H == H && e.n_lut == n_lut) {
      *cfg = e.cfg;
      return cudaSuccess;
    }
  }
  err = step_config_query(dev, rows, H, n_lut, cfg);
  if (err != cudaSuccess) return err;
  cache[used++ % 16] = {dev, rows, H, n_lut, *cfg};
  return cudaSuccess;
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous fp32 arrays:
//   x [B, T, D], w_x [D, 4H], w_h [H, 4H], b [4H], h0 / c0 [B, H],
//   lut [n_lut] (ignored when n_lut == 0),
//   y [B, T, H], h_out / c_out [B, H] (outputs),
//   zx [B * T * 4H + 4] (scratch: the pre-activations, then the grid
//   barrier's four words), h_buf / c_buf [2, B, H] (scratch).
// Two launches on `stream`: the input GEMM and the persistent recurrence
// (cooperative).  Then it waits for the stream, to read the barrier's error
// word.  Returns the cudaError_t of the first call that failed,
// GRID_BARRIER_TIMEOUT (-1) if a barrier passed its deadline, or 0.
int lstm_seq_f32(const float* x, const float* w_x, const float* w_h, const float* b,
                 const float* h0, const float* c0, const float* lut, int n_lut,
                 float* y, float* h_out, float* c_out,
                 float* zx, float* h_buf, float* c_buf,
                 int B, int T, int D, int H, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B < 1 || T < 1 || D < 1 || H < 1 || n_lut < 0) return cudaErrorInvalidValue;

  const int M = B * T;
  const int N = 4 * H;
  const dim3 ggrid((N + gemm::BN - 1) / gemm::BN, (M + gemm::BM - 1) / gemm::BM);
  gemm::rows_gemm<<<ggrid, gemm::THREADS, 0, stream>>>(x, w_x, b, zx, M, N, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  StepConfig cfg;
  err = step_config(B, H, n_lut, &cfg);
  if (err != cudaSuccess) return err;
  GridBarrier* bar = reinterpret_cast<GridBarrier*>(zx + (size_t)M * N);
  StepArgs a = {zx, w_h, lut, h0, c0, h_buf, c_buf, h_out, c_out, y, bar,
                n_lut, B, T, H, cfg.rows, cfg.resident};
  void* args[] = {&a};
  return grid_barrier_launch((const void*)lstm_persistent, cfg.grid, STEP_THREADS, args,
                             cfg.smem, bar, stream);
}

// The persistent kernel's configuration at these sizes, for reports:
// out = [grid, resident (0/1), dynamic shared memory bytes].
int lstm_seq_config(int B, int H, int n_lut, int* out) {
  if (B < 1 || H < 1 || n_lut < 0) return cudaErrorInvalidValue;
  StepConfig cfg;
  const cudaError_t err = step_config(B, H, n_lut, &cfg);
  if (err != cudaSuccess) return err;
  out[0] = cfg.grid;
  out[1] = cfg.resident;
  out[2] = (int)cfg.smem;
  return 0;
}

// The serial floor: the persistent kernel's grid at these sizes running
// T - 1 grid barriers (one a step) and nothing else.  `bar` holds 4 words.
int lstm_seq_serial_floor(int B, int T, int H, int n_lut, void* bar, void* stream_ptr) {
  StepConfig cfg;
  const cudaError_t err = step_config(B, H, n_lut, &cfg);
  if (err != cudaSuccess) return err;
  return grid_barrier_run_probe(cfg.grid, STEP_THREADS, T - 1, -1,
                                static_cast<GridBarrier*>(bar),
                                static_cast<cudaStream_t>(stream_ptr));
}

// `n` grid barriers over `grid` blocks, block `missing` never arriving
// (-1: none): what a refused launch and a broken barrier return.
int lstm_seq_barrier_probe(int grid, int n, int missing, void* bar, void* stream_ptr) {
  return grid_barrier_run_probe(grid, STEP_THREADS, n, missing, static_cast<GridBarrier*>(bar),
                                static_cast<cudaStream_t>(stream_ptr));
}

const char* lstm_seq_error_string(int code) { return grid_barrier_error_string(code); }

}  // extern "C"
