// int8 x int8 -> int32 matmul with a float rescale, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/int8_matmul/kernel.py::int8_matmul
// (Pallas body _kernel): out[m, n] = float(acc) * a_scale[m] * b_scale[n],
// acc = sum_k a[m, k] * b[k, n] in int32, for a [M, K] and b [K, N] int8
// (row-major), a_scale [M, 1] and b_scale [1, N] fp32, out [M, N] fp32.
// The paper's DSP48E1 MACC with its wide accumulator (section IV-B).
//
// Bit-exact with the plain version by construction: integer sums do not
// depend on their order, and the rescale is the same two fp32 products in
// the same order (acc * a_scale first), which the compiler cannot fuse.
//
// What bounds it on this card.  At a falcon-mamba prefill's x projection
// (M=256, K=4096, N=8192) the call moves 43 MB (a, b, the scales and the
// fp32 output; 13 us at 3.35 TB/s) and does 17 G integer operations (9 us
// at the int8 tensor cores' 1979 TOP/s), so bytes bound it.
//
// What the design does about it.  The int8 tensor cores through
// mma.sync.m16n8k32 (s8 x s8 -> s32).  A block of 8 warps computes a
// 128 x 128 output tile over K in steps of 64; each warp owns 64 x 32 of it
// (4 x 4 mma tiles, 64 int32 accumulators a thread).  Staging:
//  - a ring of STAGES shared buffers filled by cp.async (16 bytes a copy),
//    so that STAGES - 1 tiles' loads are in flight while the mmas run;
//  - a's tile lands as is (k contiguous in a row, as the mma's row-major A
//    operand wants), its 16-byte chunks XOR-swizzled by row so that the
//    fragment reads meet no bank conflict;
//  - b is [K, N] with n contiguous, but the mma's B operand wants four
//    consecutive k of one column in a word, and no load transposes bytes.
//    b's tile lands row-major; then each thread reads 8 n of four k rows,
//    transposes the 4 x 4 byte blocks in registers with __byte_perm and
//    stores one word per column into a column-major tile (words swizzled:
//    no conflict on the fragment reads, two-way on these stores).
// Any M, K, N: when K % 16 == 0, N % 16 == 0 and the pointers are 16-byte
// aligned the copies are cp.async with a zero fill past the edges;
// otherwise a byte-wise path with a mask per element stores the same tiles.
// Not done here, and left for later work: wgmma from shared memory.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;                      // bytes of k per tile
constexpr int ROW_WORDS = BK / 4;           // a's rows and b's columns: 16 words
constexpr int B_ROW_WORDS = BN / 4;         // b's raw rows: 32 words
constexpr int STAGES = 3;
constexpr int WARPS_M = 2;
constexpr int WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;   // 256
constexpr int WM = BM / WARPS_M;            // 64: four m16 tiles a warp
constexpr int WN = BN / WARPS_N;            // 32: four n8 tiles a warp
constexpr int MT = WM / 16;
constexpr int NT = WN / 8;
constexpr int A_WORDS = BM * ROW_WORDS;     // one stage of a
constexpr int B_WORDS = BK * B_ROW_WORDS;   // one stage of raw b
constexpr int SMEM_BYTES = 4 * (STAGES * (A_WORDS + B_WORDS) + BN * ROW_WORDS);

// word offset of (row, word column c) in a's tile: 16-byte chunks swizzled
// by row bits 1..2, so the 8 rows of a fragment read hit 8 chunk slots
__device__ __forceinline__ int a_word(int row, int c) {
  return row * ROW_WORDS + ((((c >> 2) ^ ((row >> 1) & 3)) << 2) | (c & 3));
}

// word offset of (column n, word column c) in b's column tile: words
// swizzled by column bits 1..2 (fragment reads) and 3..6 (the stores)
__device__ __forceinline__ int b_word(int n, int c) {
  return n * ROW_WORDS + (c ^ ((((n >> 1) & 3) << 2) ^ ((n >> 3) & 15)));
}

__device__ __forceinline__ void cp_async16(uint32_t* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N)); }

// bytes p[0..15] with the ones at or past `valid` read as zero, as a word set
__device__ __forceinline__ uint4 load16_masked(const int8_t* p, int valid) {
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < valid) w[i / 4] |= (uint32_t)(uint8_t)p[i] << (8 * (i % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Start the copies of the k-tile at k0 into stage (As, Bs): a [BM x BK]
// as 512 16-byte chunks, b [BK x BN] as 512; two of each a thread.
template <bool VEC>
__device__ __forceinline__ void issue_tile(uint32_t* As, uint32_t* Bs, const int8_t* __restrict__ a,
                                           const int8_t* __restrict__ b, int M, int N, int K,
                                           int m0, int n0, int k0, int tid) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int c = tid + THREADS * p;
    const int row = c / 4, ch = c % 4, m = m0 + row, k = k0 + 16 * ch;
    uint32_t* dst = As + a_word(row, 4 * ch);
    const bool in = m < M && k < K;
    if (VEC)
      cp_async16(dst, in ? a + (size_t)m * K + k : a, in);
    else
      *reinterpret_cast<uint4*>(dst) = load16_masked(a + (size_t)m * K + k, in ? K - k : 0);
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int c = tid + THREADS * p;
    const int row = c / 8, ch = c % 8, kk = k0 + row, n = n0 + 16 * ch;
    uint32_t* dst = Bs + row * B_ROW_WORDS + 4 * ch;
    const bool in = kk < K && n < N;
    if (VEC)
      cp_async16(dst, in ? b + (size_t)kk * N + n : b, in);
    else
      *reinterpret_cast<uint4*>(dst) = load16_masked(b + (size_t)kk * N + n, in ? N - n : 0);
  }
}

// r0..r3: four k rows of four n bytes each -> w[j]: the four k of column j
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3,
                                           uint32_t* w) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t2 = __byte_perm(r0, r1, 0x7362), t3 = __byte_perm(r2, r3, 0x7362);
  w[0] = __byte_perm(t0, t1, 0x5410);
  w[1] = __byte_perm(t0, t1, 0x7632);
  w[2] = __byte_perm(t2, t3, 0x5410);
  w[3] = __byte_perm(t2, t3, 0x7632);
}

// raw b (row-major) -> column tile: a thread takes k rows 4 kq .. 4 kq + 3
// and columns 8 ng .. 8 ng + 7
__device__ __forceinline__ void transpose_b(const uint32_t* Bs, uint32_t* Bt, int tid) {
  const int ng = tid % 16, kq = tid / 16;
  uint2 r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r[i] = *reinterpret_cast<const uint2*>(Bs + (4 * kq + i) * B_ROW_WORDS + 2 * ng);
  uint32_t w[8];
  transpose4(r[0].x, r[1].x, r[2].x, r[3].x, w);
  transpose4(r[0].y, r[1].y, r[2].y, r[3].y, w + 4);
#pragma unroll
  for (int j = 0; j < 8; ++j) Bt[b_word(8 * ng + j, kq)] = w[j];
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                   const float* __restrict__ a_scale, const float* __restrict__ b_scale,
                   float* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* const As = smem;                              // [STAGES][A_WORDS]
  uint32_t* const Bs = smem + STAGES * A_WORDS;           // [STAGES][B_WORDS]
  uint32_t* const Bt = Bs + STAGES * B_WORDS;             // [BN * ROW_WORDS]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;              // the mma's group and thread in group
  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int n_tiles = (K + BK - 1) / BK;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles)
      issue_tile<VEC>(As + st * A_WORDS, Bs + st * B_WORDS, a, b, M, N, K, m0, n0, st * BK, tid);
    cp_async_commit();
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt % STAGES;
    cp_async_wait<STAGES - 2>();          // this thread's copies of tile kt have landed
    __syncthreads();                      // everyone's; and tile kt - 1 is no longer read
    transpose_b(Bs + st * B_WORDS, Bt, tid);
    const int next = kt + STAGES - 1;
    if (next < n_tiles)
      issue_tile<VEC>(As + (next % STAGES) * A_WORDS, Bs + (next % STAGES) * B_WORDS, a, b,
                      M, N, K, m0, n0, next * BK, tid);
    cp_async_commit();
    __syncthreads();                      // the column tile is complete
    const uint32_t* A = As + st * A_WORDS;
#pragma unroll
    for (int kw = 0; kw < ROW_WORDS; kw += 8) {       // two k32 steps a tile
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm + 16 * i + g;
        af[i][0] = A[a_word(r, kw + t)];
        af[i][1] = A[a_word(r + 8, kw + t)];
        af[i][2] = A[a_word(r, kw + 4 + t)];
        af[i][3] = A[a_word(r + 8, kw + 4 + t)];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = wn + 8 * j + g;
        bf[j][0] = Bt[b_word(n, kw + t)];
        bf[j][1] = Bt[b_word(n, kw + 4 + t)];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {                     // rows g and g + 8 of the mma tile
      const int m = m0 + wm + 16 * i + g + 8 * h;
      if (m >= M) continue;
      const float sa = a_scale[m];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + 8 * j + 2 * t + e;
          if (n < N) out[(size_t)m * N + n] = (float)acc[i][j][2 * h + e] * sa * b_scale[n];
        }
      }
    }
  }
}

template <bool VEC>
cudaError_t launch(const int8_t* a, const int8_t* b, const float* a_scale, const float* b_scale,
                   float* out, int M, int N, int K, cudaStream_t stream) {
  // above 48 KB of shared memory a kernel must opt in (all of it is dynamic)
  const cudaError_t rc = cudaFuncSetAttribute(int8_matmul_kernel<VEC>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              SMEM_BYTES);
  if (rc != cudaSuccess) return rc;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_kernel<VEC><<<grid, THREADS, SMEM_BYTES, stream>>>(a, b, a_scale, b_scale, out,
                                                                 M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a [M, K], b [K, N] int8; a_scale [M], b_scale [N], out [M, N] fp32; all
// device pointers to contiguous arrays.  Launches on `stream` and does not
// synchronise.  Returns the launch's cudaError_t.
int int8_matmul_s8(const int8_t* a, const int8_t* b, const float* a_scale,
                   const float* b_scale, float* out, int M, int N, int K,
                   void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (M < 1 || N < 1 || K < 1 || (M + BM - 1) / BM > 65535) return cudaErrorInvalidValue;
  const bool vec = K % 16 == 0 && N % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0
                   && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  return vec ? launch<true>(a, b, a_scale, b_scale, out, M, N, K, stream)
             : launch<false>(a, b, a_scale, b_scale, out, M, N, K, stream);
}

const char* int8_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
