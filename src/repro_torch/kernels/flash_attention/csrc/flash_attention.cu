// Blocked online-softmax GQA attention (FlashAttention-2), for Hopper (sm_90a).
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
// operations for the score and 2·hd for the weighted sum of v, and one exp;
// the bytes are q, k, v read once and out written once.  At one phi4-mini
// layer (S = T = 2048, H = 24, hd = 128, causal) that is 25.8 GFLOP against
// 50 MB: operations bound it at every prefill shape of the configs.  The
// fp32 bar (1e-5 against the plain version) rules out plain TF32 (about
// 1e-3 off at that shape), so the fastest fp32-accurate units are the
// tensor cores in 3xTF32: each operand split as hi = tf32(x), lo = tf32(x -
// hi), and hi·hi + hi·lo + lo·hi summed in fp32 — three TF32 products, the
// work of 165 TFLOP/s at the 495 TFLOP/s dense TF32 peak, 2.5x the fp32
// FMA units' 67.
//
// What the design does about it.  The TPU kernel walked the key axis as a
// sequential grid dimension with (m, l, acc) in VMEM scratch; here a block
// of BQ / 16 warps owns one (b, h, tile of BQ queries) and loops over tiles
// of BK keys itself:
//  - each warp owns 16 query rows.  S = Q K^T and O += P V are
//    mma.sync.m16n8k8 TF32 products with fp32 accumulators in registers,
//    each done as 3xTF32 (hi and lo rounded as cvt.rna.tf32.f32 does);
//  - the softmax runs in registers: a thread holds two rows (g, g + 8) of
//    the score tile, and the row max and sum reduce over the quad that holds
//    the row.  P stays in registers: the score fragment (columns 2t, 2t+1)
//    is the PV product's A fragment once key 2t is taken as k-index t and
//    key 2t+1 as t + 4, so V's fragment reads rows 2t and 2t+1.  P is re-split
//    to hi/lo for that product;
//  - the tensor cores' fp32 accumulation does not round to nearest as an
//    fp32 add does, so a sum carried inside the mma accumulators drifts with
//    its length: P·V summed over every key tile there was 8.6e-6 off the
//    plain version at 2048 keys (hd 128), 4.2e-6 and 2.1e-6 with the keys
//    shared among 2 and 4 blocks.  So each tile's P·V goes into a zeroed
//    fragment (at most 64 keys) and is folded into the output by one fp32
//    FMA, o = alpha·o + tile, rounding as the plain version's sum does.  The
//    scores sum over hd only; there the cross terms keep their own
//    fragment, added to hi·hi once per tile;
//  - the exps are ex2.approx.ftz((s - m)·log2e), one SFU instruction each
//    (relative error about 2^-22); softcap is tanhf;
//  - K and V tiles arrive by cp.async into a 2-stage ring: tile j+1 is in
//    flight while tile j is computed, one __syncthreads a tile.  Q, K and V
//    rows are padded to hdp + 4 floats (hdp: hd rounded up to a multiple of 8
//    in the instantiated set), so the fragment loads of a warp fall in 32
//    distinct banks; the pad columns hd .. hdp-1 are zero-filled;
//  - a block owns BQ = 64 queries (4 warps) at every shape.  Blocks of 32 or
//    16 queries put more blocks on the card for short prompts (smollm-135m's
//    24-256 tokens over 9 heads: 9-36 blocks of 64), but were slower at every
//    shape measured, 16 to 2048 tokens: a block of fewer warps stages its
//    k/v tiles with fewer threads and hides less latency.  BK is 64 keys up
//    to hdp 64, 32 up to hdp 128 and 16 above, so at hd 128 a block takes
//    101 KB of shared memory and two fit on an SM;
//  - what does fill the card for a short prompt is splitting the key axis:
//    when the (b, h, q tile) blocks are fewer than the SMs, the host
//    (flash_attention_splits) shares each q tile's key tiles among up to 8
//    blocks, each writing its unnormalised sum with its (m, l) to a
//    workspace, and a second launch (combine_kernel) merges them with the
//    online softmax's own rescaling.  At smollm's 256-token prompt that is
//    4 shares of 36 blocks; at 2048 tokens no split, one launch;
//  - a masked score is the finite -2^30, never -inf: a row whose first
//    tiles are all masked picks up p = 1 there, and exp(-2^30 - m) = 0
//    exactly removes them once a visible key arrives.  So a tile that the
//    causal or window mask hides from every row of the block is skipped
//    with the same bits, unless some row of the block sees no key at all
//    (window rows past T - 1 + window), which then needs every tile to get
//    the plain version's uniform average; a warp skips, by the same rule,
//    the tiles hidden from its own 16 rows;
//  - keys past T (the ragged last tile) are absent, not masked: p = 0, and
//    their K and V rows are zero-filled;
//  - any S and T >= 1 (S != T, prime lengths, S = 1), any H that is a
//    multiple of KV, any hd <= 256; l == 0 divides by 1.  The exps above are
//    the one approximate instruction: the build takes no fast-math flag.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int MAX_HD = 256;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;               // queries a block: 16 a warp
constexpr int MAX_SPLITS = 8;                // key shares a q tile may be split into
constexpr float NEG_INF = -1073741824.0f;   // -2^30, the reference's NEG_INF
constexpr float LOG2E = 1.4426950408889634f;

// HD8 = hdp / 8: d-steps of 8 in the padded head dimension
template <int HD8>
struct Tile {
  static constexpr int HDP = HD8 * 8;
  static constexpr int LD = HDP + 4;                         // row stride in shared memory
  static constexpr int BK = HD8 <= 8 ? 64 : (HD8 <= 16 ? 32 : 16);
  static constexpr int NB = BK / 8;                          // score n-blocks a tile
  // o's column blocks whose tile sums are held at once: all of them (one
  // independent mma chain each) up to hdp 128; 8 above, where all would spill
  static constexpr int EB = HD8 <= 16 ? HD8 : 8;
};

template <int HD8>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BQ + 4 * Tile<HD8>::BK) * Tile<HD8>::LD;
}

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), each rounded to
// nearest with ties away as cvt.rna.tf32.f32 does: add half a unit of the
// 10-bit mantissa, then drop the 13 low bits.  The mma ignores an operand's
// 13 low bits, so lo is passed without the mask.  Four integer and float
// instructions; the cvt itself compiles to about eight here (it also tests
// for inf and NaN, which finite q, k, v and p never are).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a·b in 3xTF32: the two small cross terms first, then hi·hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d, al, bh[0], bh[1]);
  mma(d, ah, bl[0], bl[1]);
  mma(d, ah, bh[0], bh[1]);
}

// Copy rows 0 .. rows-1 of a [., hd] matrix with row stride `stride` into
// dst [rows][LD]: rows past nvalid and columns hd .. HDP-1 are zero-filled.
template <int HDP, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, size_t stride,
                                          int rows, int nvalid, int hd, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {                                   // hd % 4 == 0, 16-byte aligned rows
    constexpr int V = HDP / 4;
    for (int e = tid; e < rows * V; e += THREADS) {
      const int r = e / V, c = (e - r * V) * 4;
      const bool ok = r < nvalid && c < hd;
      cp_async16(dst + r * LD + c, ok ? src + r * stride + c : src, ok);
    }
  } else {
    for (int e = tid; e < rows * HDP; e += THREADS) {
      const int r = e / HDP, c = e - r * HDP;
      const bool ok = r < nvalid && c < hd;
      cp_async4(dst + r * LD + c, ok ? src + r * stride + c : src, ok);
    }
  }
}

// The key tiles [begin, end) that rows q_first .. q_last must visit (see the
// header on skipping).
__host__ __device__ __forceinline__ void tile_range(int q_first, int q_last, int T, int BK,
                                                    int causal, int window, int& begin,
                                                    int& end) {
  begin = 0;
  end = (T + BK - 1) / BK;
  if (window <= 0 || q_last < T - 1 + window) {   // every row sees a key
    if (causal && q_last / BK + 1 < end) end = q_last / BK + 1;
    const int first_visible = q_first - window + 1;
    if (window > 0 && first_visible > 0) begin = first_visible / BK;
  }
}

template <int HD8>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ ws, int S, int T, int H, int KV, int hd,
                       int causal, int window, float softcap, float scale, int vec,
                       int splits) {
  using C = Tile<HD8>;
  constexpr int LD = C::LD, BK = C::BK, NB = C::NB;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [BQ][LD]
  float* ks = qs + BQ * LD;           // [2][BK][LD]
  float* vs = ks + 2 * BK * LD;       // [2][BK][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;     // the mma fragments' group and thread
  const int q0 = blockIdx.x / splits * BQ, sp = blockIdx.x % splits;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t q_stride = (size_t)H * hd;     // between positions of q and out
  const size_t k_stride = (size_t)KV * hd;    // between positions of k and v
  const float* qb = q + ((size_t)b * S + q0) * q_stride + (size_t)h * hd;
  const float* kb = k + (size_t)b * T * k_stride + (size_t)kvh * hd;
  const float* vb = v + (size_t)b * T * k_stride + (size_t)kvh * hd;

  int kt_begin, kt_end;
  tile_range(q0, min(q0 + BQ, S) - 1, T, BK, causal, window, kt_begin, kt_end);
  if (splits > 1) {                           // this block's share of the key tiles
    const int n = kt_end - kt_begin;
    kt_end = kt_begin + n * (sp + 1) / splits;
    kt_begin += n * sp / splits;
  }
  const int wq0 = q0 + 16 * warp;             // this warp's first row
  const bool active = wq0 < S;
  int w_begin = kt_begin, w_end = kt_end;
  if (active) {
    tile_range(wq0, min(wq0 + 16, S) - 1, T, BK, causal, window, w_begin, w_end);
    w_begin = max(w_begin, kt_begin);
    w_end = min(w_end, kt_end);
  }

  // the q tile (rows past S are zeros; their outputs are never stored) and
  // the first k/v tile, one group
  load_tile<C::HDP, LD>(qs, qb, q_stride, BQ, S - q0, hd, vec);
  if (kt_begin < kt_end) {
    const int k0 = kt_begin * BK;
    load_tile<C::HDP, LD>(ks, kb + (size_t)k0 * k_stride, k_stride, BK, T - k0, hd, vec);
    load_tile<C::HDP, LD>(vs, vb + (size_t)k0 * k_stride, k_stride, BK, T - k0, hd, vec);
  }
  cp_async_commit();

  float acc[HD8][4];
#pragma unroll
  for (int e = 0; e < HD8; ++e)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[e][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float* qw = qs + 16 * warp * LD;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    cp_async_wait_all();
    __syncthreads();              // tile kt landed; every warp is done with tile kt-1
    if (kt + 1 < kt_end) {        // tile kt+1 flies during tile kt
      const int k1 = (kt + 1) * BK;
      float* kn = ks + (st ^ 1) * BK * LD;
      float* vn = vs + (st ^ 1) * BK * LD;
      load_tile<C::HDP, LD>(kn, kb + (size_t)k1 * k_stride, k_stride, BK, T - k1, hd, vec);
      load_tile<C::HDP, LD>(vn, vb + (size_t)k1 * k_stride, k_stride, BK, T - k1, hd, vec);
      cp_async_commit();
    }
    if (!active || kt < w_begin || kt >= w_end) continue;   // warp-uniform
    const int k0 = kt * BK;
    const float* kst = ks + st * BK * LD;
    const float* vst = vs + st * BK * LD;

    // s = q k^T over the tile: A = q rows (g, g+8) x d (t, t+4); B = k row
    // (n0 + g) x d (t, t+4); C = rows (g, g+8) x keys n0 + (2t, 2t+1)
    float sc[NB][4], sx[NB][4];                 // hi·hi, and the two cross terms
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[j][i] = sx[j][i] = 0.f;
#pragma unroll 2
    for (int ks8 = 0; ks8 < HD8; ++ks8) {
      const float* qr = qw + g * LD + ks8 * 8 + t4;
      uint32_t ah[4], al[4];
      split(qr[0], ah[0], al[0]);
      split(qr[8 * LD], ah[1], al[1]);
      split(qr[4], ah[2], al[2]);
      split(qr[8 * LD + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float* kr = kst + (j * 8 + g) * LD + ks8 * 8 + t4;
        uint32_t bh[2], bl[2];
        split(kr[0], bh[0], bl[0]);
        split(kr[4], bh[1], bl[1]);
        mma(sx[j], al, bh[0], bh[1]);
        mma(sx[j], ah, bl[0], bl[1]);
        mma(sc[j], ah, bh[0], bh[1]);
      }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[j][i] += sx[j][i];

    // online softmax of rows g (r = 0) and g + 8 (r = 1), in registers
    float alpha[2];                             // each row's rescaling of o
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = wq0 + g + 8 * r;
      float mx = -INFINITY;                   // over this thread's present keys
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kj = k0 + j * 8 + 2 * t4 + c;
          float x = sc[j][2 * r + c] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          bool visible = true;
          if (causal) visible = kj <= qi;
          if (window > 0) visible = visible && kj > qi - window;
          x = visible ? x : NEG_INF;
          sc[j][2 * r + c] = x;
          if (kj < T) mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = ex2((m[r] - m_new) * LOG2E);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kj = k0 + j * 8 + 2 * t4 + c;
          const float p = kj < T ? ex2((sc[j][2 * r + c] - m_new) * LOG2E) : 0.f;
          sc[j][2 * r + c] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = alpha[r] * l[r] + sum;
      m[r] = m_new;
    }

    // o = alpha·o + p v: A = p rows (g, g+8) x k-index (t, t+4) = keys
    // n0 + (2t, 2t+1), which is sc[j] as it stands; B = v rows n0 + (2t,
    // 2t+1) x column e0 + g.  The tile's sum is its own fragment, folded
    // into acc in fp32 (see the header)
    uint32_t ph[NB][4], pl[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      split(sc[j][0], ph[j][0], pl[j][0]);
      split(sc[j][2], ph[j][1], pl[j][1]);
      split(sc[j][1], ph[j][2], pl[j][2]);
      split(sc[j][3], ph[j][3], pl[j][3]);
    }
    // EB column blocks at a time (see Tile): their mma chains interleave
#pragma unroll
    for (int e0 = 0; e0 < HD8; e0 += C::EB) {
      float pv[C::EB][4] = {};
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < C::EB; ++e) {
          const float* vr = vst + (j * 8 + 2 * t4) * LD + (e0 + e) * 8 + g;
          uint32_t bh[2], bl[2];
          split(vr[0], bh[0], bl[0]);
          split(vr[LD], bh[1], bl[1]);
          mma3(pv[e], ph[j], pl[j], bh, bl);
        }
#pragma unroll
      for (int e = 0; e < C::EB; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[e0 + e][i] = __fmaf_rn(acc[e0 + e][i], alpha[i >> 1], pv[e][i]);
    }
  }

  if (!active) return;
  const size_t rows = (size_t)gridDim.z * S * H;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = wq0 + g + 8 * r;
    if (qi >= S) continue;
    const size_t row = ((size_t)b * S + qi) * H + h;
    // one block: the output; a share of the keys: the unnormalised partial
    // sum with its (m, l), which combine_kernel merges
    const float denom = splits > 1 ? 1.f : (l[r] == 0.f ? 1.f : l[r]);  // the reference's guard
    float* orow = splits > 1 ? ws + (sp * rows + row) * hd : o + row * hd;
#pragma unroll
    for (int e = 0; e < HD8; ++e) {
      const int d = e * 8 + 2 * t4;
      if (d < hd) orow[d] = acc[e][2 * r] / denom;
      if (d + 1 < hd) orow[d + 1] = acc[e][2 * r + 1] / denom;
    }
    if (splits > 1 && t4 == 0) {
      float* ml = ws + splits * rows * hd + (sp * rows + row) * 2;
      ml[0] = m[r];
      ml[1] = l[r];
    }
  }
}

// Merge the key shares' partial sums of each output row: with M the largest
// m, out = sum_i 2^((m_i - M) log2 e) acc_i / sum_i 2^((m_i - M) log2 e) l_i,
// the online softmax's own rescaling, so a share that saw only masked keys
// (m = -2^30) drops out exactly and a row that sees no key at all averages
// every share's keys uniformly, as one block would.
__global__ void __launch_bounds__(256)
combine_kernel(const float* __restrict__ ws, float* __restrict__ o, size_t rows, int hd,
               int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * hd) return;
  const size_t row = i / hd;
  const float* ml = ws + splits * rows * hd;
  float mx = NEG_INF;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[(s * rows + row) * 2]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = ex2((ml[(s * rows + row) * 2] - mx) * LOG2E);
    den += w * ml[(s * rows + row) * 2 + 1];
    num += w * ws[s * rows * hd + i];
  }
  o[i] = num / (den == 0.f ? 1.f : den);                 // the reference's guard
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int HD8>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, float* ws,
                   int B, int S, int T, int H, int KV, int hd, int causal, int window,
                   float softcap, float scale, int splits, cudaStream_t stream) {
  // all of the kernel's shared memory is dynamic (no static arrays), so the
  // opt-in threshold is on this size alone
  constexpr size_t smem = smem_bytes<HD8>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<HD8>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int vec = hd % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  const dim3 grid((S + BQ - 1) / BQ * splits, H, B);
  flash_attention_kernel<HD8><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, ws, S, T, H, KV, hd, causal, window, softcap, scale, vec, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = (size_t)B * S * H * hd;
  combine_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(ws, o, (size_t)B * S * H, hd,
                                                                  splits);
  return cudaGetLastError();
}

// BK of the instantiation that takes this hd (see the dispatch below)
int key_tile(int hd) {
  const int hd8 = (hd + 7) / 8;
  return hd8 <= 8 ? Tile<8>::BK : hd8 <= 16 ? Tile<16>::BK : Tile<32>::BK;
}

}  // namespace

extern "C" {

// How many shares to split the key axis into (1: none), for `sm_count` SMs:
// when the (b, h, q tile) blocks fill fewer than all of them, each block's
// key tiles are shared among up to MAX_SPLITS blocks, as many as it takes
// to reach twice the SM count but no more than the longest block has tiles.
int flash_attention_splits(int B, int S, int T, int H, int hd, int causal, int window,
                           int sm_count) {
  if (B < 1 || S < 1 || T < 1 || H < 1 || hd < 1) return 1;   // flash_attention_f32 refuses
  const int q_tiles = (S + BQ - 1) / BQ;
  const long blocks = (long)B * H * q_tiles;
  if (blocks >= sm_count) return 1;
  const int bk = key_tile(hd);
  int longest = 1;
  for (int t = 0; t < q_tiles; ++t) {
    int begin, end;
    tile_range(t * BQ, (t * BQ + BQ < S ? t * BQ + BQ : S) - 1, T, bk, causal, window, begin,
               end);
    if (end - begin > longest) longest = end - begin;
  }
  const int want = (int)((2L * sm_count + blocks - 1) / blocks);
  const int splits = want < longest ? want : longest;
  return splits < MAX_SPLITS ? splits : MAX_SPLITS;
}

// All pointers are device pointers to contiguous fp32 arrays: q and out
// [B, S, H, hd], k and v [B, T, KV, hd], and, when splits > 1, the
// workspace ws of splits * B * S * H * (hd + 2) floats (else null).
// causal is 0 or 1; window <= 0 means no window; softcap <= 0 means no
// softcap; scale multiplies q . k.  Launches on `stream` (one kernel, or
// two when splits > 1) and does not synchronise.  Returns the launches'
// cudaError_t (cudaErrorInvalidValue for sizes it does not take: an empty
// axis, H not a multiple of KV, hd > 256, B or H > 65535, splits outside
// 1 .. MAX_SPLITS or without a workspace).
int flash_attention_f32(const float* q, const float* k, const float* v, float* o, float* ws,
                        int B, int S, int T, int H, int KV, int hd,
                        int causal, int window, float softcap, float scale, int splits,
                        void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B < 1 || S < 1 || T < 1 || H < 1 || KV < 1 || hd < 1 || hd > MAX_HD
      || H % KV != 0 || B > 65535 || H > 65535 || splits < 1 || splits > MAX_SPLITS
      || (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
#define FA_LAUNCH(hd8) \
  return launch<hd8>(q, k, v, o, ws, B, S, T, H, KV, hd, causal, window, softcap, scale, \
                     splits, stream)
  // hd is padded with zeros to the next instantiated multiple of 8
  const int hd8 = (hd + 7) / 8;
  if (hd8 <= 2) FA_LAUNCH(2);
  if (hd8 <= 4) FA_LAUNCH(4);
  if (hd8 <= 6) FA_LAUNCH(6);
  if (hd8 <= 8) FA_LAUNCH(8);
  if (hd8 <= 10) FA_LAUNCH(10);
  if (hd8 <= 12) FA_LAUNCH(12);
  if (hd8 <= 16) FA_LAUNCH(16);
  if (hd8 <= 24) FA_LAUNCH(24);
  FA_LAUNCH(32);
#undef FA_LAUNCH
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
