// Blocked online-softmax GQA attention (FlashAttention), for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention (Pallas body _flash_kernel):
//   s[i, j] = (q_i . k_j) * scale            scale = hd^-0.5
//   s[i, j] = softcap * tanh(s / softcap)    when softcap > 0
//   s[i, j] = -2^30 where masked             causal: j <= i; window: j > i - window
//   out_i   = sum_j softmax_j(s[i, :]) v_j
// over q [B, S, H, hd] and k, v [B, T, KV, hd], head h reading kv head
// h / (H / KV) in place (no copy of k or v per head), giving out
// [B, S, H, hd], all fp32.  Query i and key j both count from 0, so the
// masks are top-left aligned when S != T, as the TPU kernel's iotas are.
//
// What bounds it on this card.  Each visible (query, key) pair costs 2·hd
// fp32 operations for the score and 2·hd for the weighted sum of v; the
// bytes are q, k, v read once and out written once.  At one phi4-mini layer
// (S = T = 2048, H = 24, hd = 128, causal) that is 25.8 GFLOP against
// 50 MB, so fp32 operations bound it (0.385 ms at 67 TFLOP/s), as they do
// for every prefill shape of the configs.  This kernel does its products on
// the fp32 FMA units, not the tensor cores: a first version that is right
// (the plain version's tolerance of 1e-5 in fp32); wgmma and TMA are later
// work.
//
// What the design does about it.  The TPU kernel walked the key axis as a
// sequential grid dimension with (m, l, acc) in VMEM scratch; here one block
// of 256 threads owns one (b, h, tile of 64 queries) and loops over tiles of
// 64 keys itself, with (m, l, acc) in registers:
//  - the q tile is staged in shared memory once; each k/v tile is staged in
//    its turn (rows of q and k padded to hd + 1 floats, so the 16 key rows a
//    warp reads at one d fall in 16 banks);
//  - thread (ty, tx) of a 16 x 16 grid owns query rows ty + 16 i and key
//    columns tx + 16 j (i, j < 4) of the score tile; the 16 threads of a row
//    are 16 lanes of one warp, which reduce the row's max and sum with
//    __shfl_xor_sync;
//  - p goes through shared memory, and each thread accumulates the output
//    columns tx + 16 n (n < ceil(hd / 16)) of its four rows;
//  - a masked score is the finite -2^30, never -inf: a row whose first
//    tiles are all masked picks up p = 1 there, and exp(-2^30 - m) = 0
//    exactly removes them once a visible key arrives.  So a tile that the
//    causal or window mask hides from every row of the block is skipped
//    with the same bits, unless some row of the block sees no key at all
//    (window rows past T - 1 + window), which then needs every tile to get
//    the plain version's uniform average;
//  - keys past T (the ragged last tile) are absent, not masked: p = 0;
//  - any S and T >= 1 (S != T, prime lengths, S = 1), any H that is a
//    multiple of KV, any hd <= 256.  expf and tanhf, no fast math.
// Shared memory: 4·(128·(hd + 1) + 64·hd + 64·65) bytes, 115 KB at hd = 128
// and 209 KB at hd = 256, above the 48 KB default, so the launch opts in.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;            // queries per block
constexpr int BK = 64;            // keys per staged tile
constexpr int THREADS = 256;      // a 16 x 16 grid of (ty, tx)
constexpr int RQ = BQ / 16;       // query rows a thread owns
constexpr int CK = BK / 16;       // score columns a thread owns per tile
constexpr int LDP = BK + 1;       // row stride of the p tile
constexpr int MAX_HD = 256;
constexpr float NEG_INF = -1073741824.0f;   // -2^30, the reference's NEG_INF

size_t smem_bytes(int hd) {
  return sizeof(float) * ((size_t)(BQ + BK) * (hd + 1) + (size_t)BK * hd + (size_t)BQ * LDP);
}

// ND = ceil(hd / 16): output columns a thread owns in each of its rows
template <int ND>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int S, int T, int H, int KV, int hd,
                       int causal, int window, float softcap, float scale) {
  extern __shared__ float smem[];
  const int ldq = hd + 1;
  float* qs = smem;                   // [BQ][hd + 1]
  float* ks = qs + BQ * ldq;          // [BK][hd + 1]
  float* vs = ks + BK * ldq;          // [BK][hd]
  float* ps = vs + BK * hd;           // [BQ][BK + 1]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t q_stride = (size_t)H * hd;     // between positions of q and out
  const size_t k_stride = (size_t)KV * hd;    // between positions of k and v
  const float* qb = q + (size_t)b * S * q_stride + (size_t)h * hd;
  const float* kb = k + (size_t)b * T * k_stride + (size_t)kvh * hd;
  const float* vb = v + (size_t)b * T * k_stride + (size_t)kvh * hd;

  // the q tile; rows past S are zeros and their outputs are never stored
  for (int e = tid; e < BQ * hd; e += THREADS) {
    const int r = e / hd, d = e - r * hd;
    qs[r * ldq + d] = q0 + r < S ? qb[(size_t)(q0 + r) * q_stride + d] : 0.f;
  }

  float m[RQ], l[RQ], acc[RQ][ND];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[i][n] = 0.f;
  }

  // the key tiles this block visits (see the header on skipping)
  const int q_last = min(q0 + BQ, S) - 1;
  int kt_begin = 0, kt_end = (T + BK - 1) / BK;
  const bool every_row_sees_a_key = window <= 0 || q_last < T - 1 + window;
  if (every_row_sees_a_key) {
    if (causal) kt_end = min(kt_end, q_last / BK + 1);
    const int first_visible = q0 - window + 1;     // row q0's first visible key
    if (window > 0 && first_visible > 0) kt_begin = first_visible / BK;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    const int kc = min(BK, T - k0);               // keys present in this tile
    __syncthreads();                              // the last tile's reads are done
    for (int e = tid; e < BK * hd; e += THREADS) {
      const int r = e / hd, d = e - r * hd;
      const bool ok = r < kc;
      const size_t g = (size_t)(k0 + r) * k_stride + d;
      ks[r * ldq + d] = ok ? kb[g] : 0.f;
      vs[r * hd + d] = ok ? vb[g] : 0.f;
    }
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = qs[(ty + 16 * i) * ldq + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = ks[(tx + 16 * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = -INFINITY;                       // over this thread's present keys
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int c = tx + 16 * j, kj = k0 + c;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool visible = true;
        if (causal) visible = kj <= qi;
        if (window > 0) visible = visible && kj > qi - window;
        x = visible ? x : NEG_INF;
        s[i][j] = x;
        if (c < kc) mx = fmaxf(mx, x);
      }
      // the row's 16 threads are lanes (ty & 1) * 16 + 0..15 of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int c = tx + 16 * j;
        const float p = c < kc ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * LDP + c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < ND; ++n) acc[i][n] *= alpha;
    }
    __syncthreads();                              // the p tile is complete

    for (int c = 0; c < kc; ++c) {
      float pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = ps[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int d = tx + 16 * n;
        if (d < hd) {
          const float vv = vs[c * hd + d];
#pragma unroll
          for (int i = 0; i < RQ; ++i) acc[i][n] = fmaf(pv[i], vv, acc[i][n]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];   // the reference's guard
    float* orow = o + ((size_t)b * S + qi) * q_stride + (size_t)h * hd;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int d = tx + 16 * n;
      if (d < hd) orow[d] = acc[i][n] / denom;
    }
  }
}

template <int ND>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int B, int S, int T, int H, int KV, int hd,
                   int causal, int window, float softcap, float scale, cudaStream_t stream) {
  // all of the kernel's shared memory is dynamic (no static arrays), so the
  // opt-in threshold is on this size alone
  const size_t smem = smem_bytes(hd);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<ND>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attention_kernel<ND><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, S, T, H, KV, hd, causal, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous fp32 arrays: q and out
// [B, S, H, hd], k and v [B, T, KV, hd].  causal is 0 or 1; window <= 0
// means no window; softcap <= 0 means no softcap; scale multiplies q . k.
// Launches on `stream` and does not synchronise.  Returns the launch's
// cudaError_t (cudaErrorInvalidValue for sizes it does not take: an empty
// axis, H not a multiple of KV, hd > 256, B or H > 65535).
int flash_attention_f32(const float* q, const float* k, const float* v, float* o,
                        int B, int S, int T, int H, int KV, int hd,
                        int causal, int window, float softcap, float scale,
                        void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B < 1 || S < 1 || T < 1 || H < 1 || KV < 1 || hd < 1 || hd > MAX_HD
      || H % KV != 0 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
#define FA_LAUNCH(nd) \
  return launch<nd>(q, k, v, o, B, S, T, H, KV, hd, causal, window, softcap, scale, stream)
  switch ((hd + 15) / 16) {
    case 1: FA_LAUNCH(1);
    case 2: FA_LAUNCH(2);
    case 3: FA_LAUNCH(3);
    case 4: FA_LAUNCH(4);
    case 5: FA_LAUNCH(5);
    case 6: FA_LAUNCH(6);
    case 7: FA_LAUNCH(7);
    case 8: FA_LAUNCH(8);
    case 9: FA_LAUNCH(9);
    case 10: FA_LAUNCH(10);
    case 11: FA_LAUNCH(11);
    case 12: FA_LAUNCH(12);
    case 13: FA_LAUNCH(13);
    case 14: FA_LAUNCH(14);
    case 15: FA_LAUNCH(15);
    default: FA_LAUNCH(16);
  }
#undef FA_LAUNCH
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
