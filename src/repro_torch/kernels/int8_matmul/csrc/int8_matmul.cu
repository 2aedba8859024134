// int8 x int8 -> int32 matmul with a float rescale, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/int8_matmul/kernel.py::int8_matmul
// (Pallas body _kernel, pallas_call at :62): out[m, n] = float(acc) *
// a_scale[m] * b_scale[n], acc = sum_k a[m, k] * b[k, n] in int32, for a
// [M, K] and b [K, N] int8 (row-major), a_scale [M, 1] and b_scale [1, N]
// fp32, out [M, N] fp32.  The paper's DSP48E1 MACC with its wide
// accumulator (section IV-B).  Bit-exact with the plain version: integer
// sums do not depend on their order, and the rescale is the same two fp32
// products in the same order (acc * a_scale first), which cannot fuse.
//
// What bounds it on this card.  Bytes, at both timed shapes: at a
// falcon-mamba prefill's x projection (M=256, K=4096, N=8192) the call must
// move 43.0 MB (a 1 MiB, b 32 MiB, the fp32 out 8 MiB, the scales): 12.8 us
// at 3.35 TB/s, against 8.7 us for its 17.2 G integer operations at the
// int8 tensor cores' 1979 TOP/s.  At M=1 (a decode-sized product) it must
// move 33.6 MB, nearly all of it b: 10.0 us.  Inside the card, what TMA
// delivers from L2 to shared memory bounds it as much: tiles that re-read a
// and b multiply those bytes (128 MiB at M=256 with the mma.sync kernel's
// 128 x 128 tiles), and a TMA stream of them ran at about 3.3 TB/s on an
// H100 80GB HBM3 at 700 W.
//
// The s8 rule.  wgmma reads an 8-bit operand from shared memory only
// K-major (k contiguous); the transpose flags exist for f16/bf16 alone.
// a is K-major as it lies, b ([K, N], n contiguous) is not.
//
// What the design (the TMA path) does about it.
//  - Swap-AB: a block computes out^T = b^T a^T.  b's tile is wgmma's A
//    operand, from registers, where no layout rule applies: each thread
//    loads 32-bit words of the tile as TMA left it (MN-major) and turns
//    each 4 x 4 block of bytes with __byte_perm into whole fragments.  a's
//    tile is the B operand, read by a descriptor straight from shared
//    memory, where TMA put it K-major with the 128-byte swizzle.  The token
//    count becomes wgmma's N extent: M = 1 costs an n8 tile.
//  - A block covers 128 n (two m64 wgmma tiles) and all of M up to 256
//    rows (16, 32, 64, 128 or 256; larger M takes several such tiles), so
//    b is read from L2 once.  Its two consumer warpgroups take half of
//    those rows each.  The tiles' rows stand for n in the order
//    n = 4 (8 warp + group) + 2 tile + half, so a thread's four rows are
//    four consecutive n: one 32-bit load per k row feeds all four, and the
//    epilogue stores them as one 16-byte float4 per m.
//  - K is split over a cluster of two blocks: each sums one half of the k
//    tiles, then sends the rows the other finishes into the other's idle
//    ring through distributed shared memory, and adds what it received
//    (int32: exact).  Twice the blocks, each with half the bytes.
//  - Staging: TMA (cp.async.bulk.tensor.2d) into a ring of 4-8 stages of
//    128 k bytes with a full and an empty mbarrier each; one thread of the
//    producer warpgroup issues the copies, and setmaxnreg hands its
//    registers to the consumers.  A consumer issues one wgmma group per k32
//    step (8 live fragment registers, so that its accumulators, up to 128,
//    fit the 168 registers ptxas compiles it with); the other warpgroup's
//    group runs while it builds the next.  No block-wide barrier in the k
//    loop.
//  - L2 -> shared bytes: at 256 x 4096 x 8192, a 64 MiB (128 blocks x half
//    of a's 1 MiB) + b 32 MiB = 96 MiB, against the mma.sync kernel's 128
//    MiB; at 1 x 4096 x 8192, b 32 MiB + a's one real row 256 KiB (rows
//    past M are zeros that TMA makes, not reads), about the 33.6 MB that
//    HBM must move.
//  - Epilogue: (float)acc * a_scale[m], then * b_scale[n], stored 16 bytes
//    at a time; rows past M and columns past N are not stored.  One launch
//    a call.
// TMA needs a 16-byte-aligned base and pitch: K % 16 == 0, N % 16 == 0 and
// a, b, out 16-byte aligned.  Other shapes and operands that start inside a
// 16-byte word take the byte-wise path: the mma.sync.m16n8k32 kernel that
// came before, which loads its tiles byte by byte with a mask and
// transposes b's tile in registers (int8_matmul_s8_plan says which path a
// call takes).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---- the TMA path -------------------------------------------------------------

constexpr int TBN = 128;                 // n a block covers: two m64 wgmma tiles
constexpr int TBK = 128;                 // bytes of k a stage holds: four k32 steps
constexpr int CONSUMERS = 2;             // consumer warpgroups: each takes half the block's rows
// and one producer warpgroup, of which one thread issues the copies: whole
// warpgroups, so that setmaxnreg's exchange balances (ptxas sizes a partial
// warpgroup as a whole one): 3 x 128 x 168 registers at launch, 128 x 40 +
// 256 x 232 after
constexpr int T_THREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert(128 * PRODUCER_REGS + 128 * CONSUMERS * CONSUMER_REGS <= 65536,
              "the consumers' registers come from the producer's");
constexpr int RING_BYTES = 196608;       // shared memory for the ring

// BMW: a's rows one consumer warpgroup takes (wgmma's N); a block takes 2 BMW
template <int BMW>
__host__ __device__ constexpr int stages_for() {
  return RING_BYTES / (2 * BMW * TBK + TBK * TBN) < 8 ? RING_BYTES / (2 * BMW * TBK + TBK * TBN)
                                                      : 8;
}

template <int BMW>
__host__ __device__ constexpr size_t tma_smem_bytes() {
  return (size_t)stages_for<BMW>() * (2 * BMW * TBK + TBK * TBN) + 1024;   // + the alignment
}

// wgmma.m64nNk32.s32.s8.s8 with A (b's tile) from registers and B (a's
// tile) from shared memory: d[64 x N] += A[64 x 32] B[32 x N]
template <int N>
struct WgmmaS8;

template <>
struct WgmmaS8<8> {
  static __device__ __forceinline__ void mma(int* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct WgmmaS8<16> {
  static __device__ __forceinline__ void mma(int* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct WgmmaS8<32> {
  static __device__ __forceinline__ void mma(int* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct WgmmaS8<64> {
  static __device__ __forceinline__ void mma(int* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct WgmmaS8<128> {
  static __device__ __forceinline__ void mma(int* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

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

// A pair of blocks (a cluster along x) computes out[m0 : m0 + 2 BMW, n0 :
// n0 + 128]: block r of the pair sums over the r-th half of K, and the pair
// adds its two partial sums through distributed shared memory.
template <int BMW>
__global__ void __launch_bounds__(T_THREADS, 1)
int8_matmul_tma(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                const float* __restrict__ a_scale, const float* __restrict__ b_scale,
                float* __restrict__ out, int M, int N, int K) {
  constexpr int BM = 2 * BMW;                  // a's rows a block takes
  constexpr int STAGES = stages_for<BMW>();
  constexpr int A_BYTES = BM * TBK;            // a's tile: BM rows of 128 k bytes
  constexpr int B_BYTES = TBK * TBN;           // b's tile: 128 k rows of 128 n bytes
  static_assert(BMW * 128 * 4 <= STAGES * A_BYTES, "a warpgroup's partial sums fit in a's ring");
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  // the swizzled tiles need 1024-byte alignment
  uint8_t* const As = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const Bs = As + STAGES * A_BYTES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rank = (int)hopper::cluster_ctarank();   // the half of K this block sums
  const int n0 = (blockIdx.x / 2) * TBN, m0 = blockIdx.y * BM;
  const int k_tiles = (K + TBK - 1) / TBK, half_k = (k_tiles + 1) / 2;
  const int kt0 = rank * half_k, kt1 = min(k_tiles, kt0 + half_k);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(hopper::smem_u32(&full[s]), 1);                // the producer's arrival
      hopper::mbar_init(hopper::smem_u32(&empty[s]), 4 * CONSUMERS);   // every consumer warp's
    }
    hopper::fence_mbarrier_init();
  }
  __syncthreads();

  if (warp >= 4 * CONSUMERS) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    hopper::regs_release<PRODUCER_REGS>();
    if (warp == 4 * CONSUMERS && lane == 0) {
      for (int kt = kt0; kt < kt1; ++kt) {
        const int i = kt - kt0, s = i % STAGES;
        if (i >= STAGES) hopper::mbar_wait(hopper::smem_u32(&empty[s]), (i / STAGES - 1) & 1);
        const uint32_t bar = hopper::smem_u32(&full[s]);
        hopper::mbar_arrive_expect_tx(bar, A_BYTES + B_BYTES);
        hopper::tma_load_2d(hopper::smem_u32(Bs + s * B_BYTES), &map_b, bar, n0, kt * TBK);
        hopper::tma_load_2d(hopper::smem_u32(As + s * A_BYTES), &map_a, bar, kt * TBK, m0);
      }
    }
    hopper::cluster_sync();                    // the pair's exchange (below)
    hopper::cluster_sync();
  } else {
    // ---- consumer warpgroups: warpgroup wg takes a's rows wg BMW .. ----
    hopper::regs_claim<CONSUMER_REGS>();
    const int wg = warp / 4, wq = warp % 4, g = lane / 4, t = lane % 4;
    const int nb = 32 * wq + 4 * g;            // this thread's four columns (bytes of b's rows)
    int acc0[BMW / 2], acc1[BMW / 2];          // tiles 0 and 1: n = nb + 2 tile + half
#pragma unroll
    for (int i = 0; i < BMW / 2; ++i) acc0[i] = acc1[i] = 0;
    for (int kt = kt0; kt < kt1; ++kt) {
      const int i = kt - kt0, s = i % STAGES;
      hopper::mbar_wait(hopper::smem_u32(&full[s]), (i / STAGES) & 1);
      const uint8_t* const B = Bs + s * B_BYTES;
      const uint32_t a_addr = hopper::smem_u32(As + s * A_BYTES + wg * BMW * TBK);
#pragma unroll
      for (int kk = 0; kk < TBK / 32; ++kk) {
        // k rows 4t..4t+3 and 16+4t..16+4t+3 of this k32 step, four n each
        // (a row's 16-byte chunks are swizzled by its low bits), turned into
        // rows g and g + 8 of each tile: registers 0-1 k 4t.., 2-3 k 16+4t..
        // (the mma.m16n8k32 A layout, one warp's 16 rows).  One group a
        // step keeps the live fragments to 8 registers; the other
        // warpgroup's group runs meanwhile.
        uint32_t r[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int k = 32 * kk + 4 * t + (q & 3) + 16 * (q >> 2);
          r[q] = *reinterpret_cast<const uint32_t*>(
              B + k * TBN + ((((nb >> 4) ^ (k & 7)) << 4) | (nb & 15)));
        }
        uint32_t lo[4], hi[4];
        transpose4(r[0], r[1], r[2], r[3], lo);
        transpose4(r[4], r[5], r[6], r[7], hi);
        const uint32_t f0[4] = {lo[0], lo[1], hi[0], hi[1]};
        const uint32_t f1[4] = {lo[2], lo[3], hi[2], hi[3]};
        const uint64_t desc = hopper::desc_k_major_sw128(a_addr + 32 * kk);
        hopper::wgmma_fence();
        WgmmaS8<BMW>::mma(acc0, f0, desc);
        WgmmaS8<BMW>::mma(acc1, f1, desc);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
      }
      if (lane == 0) hopper::mbar_arrive(hopper::smem_u32(&empty[s]));
    }
#pragma unroll
    for (int i = 0; i < BMW / 2; ++i) {
      hopper::fence_operand(acc0[i]);
      hopper::fence_operand(acc1[i]);
    }
    // Block r stores the rows of warpgroup r.  Once both rings are idle
    // (every load has landed and been read), warpgroup 1 - r sends its sums
    // into the other block's ring; then warpgroup r adds them (int32: exact).
    int4* const red = reinterpret_cast<int4*>(As);     // [BMW / 4][128 threads]
    const int wt = tid % 128;
    hopper::cluster_sync();
    if (wg != rank) {
      int4* const peer = hopper::map_to_cta(red, rank ^ 1);
#pragma unroll
      for (int i = 0; i < BMW / 8; ++i) {
        peer[i * 128 + wt] = make_int4(acc0[4 * i], acc0[4 * i + 1], acc0[4 * i + 2], acc0[4 * i + 3]);
        peer[(BMW / 8 + i) * 128 + wt] =
            make_int4(acc1[4 * i], acc1[4 * i + 1], acc1[4 * i + 2], acc1[4 * i + 3]);
      }
    }
    hopper::cluster_sync();
    if (wg == rank) {
#pragma unroll
      for (int i = 0; i < BMW / 8; ++i) {
        const int4 p0 = red[i * 128 + wt], p1 = red[(BMW / 8 + i) * 128 + wt];
        acc0[4 * i] += p0.x; acc0[4 * i + 1] += p0.y; acc0[4 * i + 2] += p0.z; acc0[4 * i + 3] += p0.w;
        acc1[4 * i] += p1.x; acc1[4 * i + 1] += p1.y; acc1[4 * i + 2] += p1.z; acc1[4 * i + 3] += p1.w;
      }
      // accumulator j, e of a tile: column m = 8j + 2t + e, rows g (half 0)
      // and g + 8 (half 1) at registers 4j + e and 4j + 2 + e
      const int n = n0 + nb, mw = m0 + wg * BMW;
      if (n < N) {                             // N % 16 == 0: n + 3 < N too
        const float sb0 = b_scale[n], sb1 = b_scale[n + 1], sb2 = b_scale[n + 2],
                    sb3 = b_scale[n + 3];
#pragma unroll
        for (int j = 0; j < BMW / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = mw + 8 * j + 2 * t + e;
            if (m >= M) continue;
            const float sa = a_scale[m];
            float4 v;
            v.x = (float)acc0[4 * j + e] * sa * sb0;
            v.y = (float)acc0[4 * j + 2 + e] * sa * sb1;
            v.z = (float)acc1[4 * j + e] * sa * sb2;
            v.w = (float)acc1[4 * j + 2 + e] * sa * sb3;
            *reinterpret_cast<float4*>(out + (size_t)m * N + n) = v;
          }
        }
      }
    }
  }
}

template <int BMW>
cudaError_t launch_tma(const int8_t* a, const int8_t* b, const float* a_scale,
                       const float* b_scale, float* out, int M, int N, int K,
                       cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  cudaError_t rc = hopper::encode_u8_2d(&map_a, a, M, K, K, 2 * BMW, TBK);
  if (rc != cudaSuccess) return rc;
  rc = hopper::encode_u8_2d(&map_b, b, K, N, N, TBK, TBN);
  if (rc != cudaSuccess) return rc;
  const size_t smem = tma_smem_bytes<BMW>();
  rc = cudaFuncSetAttribute(int8_matmul_tma<BMW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)smem);
  if (rc != cudaSuccess) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * ((N + TBN - 1) / TBN), (M + 2 * BMW - 1) / (2 * BMW));
  cfg.blockDim = dim3(T_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = cudaLaunchKernelEx(&cfg, int8_matmul_tma<BMW>, map_a, map_b, a_scale, b_scale, out, M, N,
                          K);
  return rc != cudaSuccess ? rc : cudaGetLastError();
}

// ---- the byte-wise path: mma.sync.m16n8k32 ----------------------------------------
//
// A block of 8 warps computes a 128 x 128 output tile over K in steps of
// 64; each warp owns 64 x 32 of it (4 x 4 mma tiles, 64 int32 accumulators
// a thread).  a's tile lands as is (k contiguous in a row, as the mma's
// row-major A operand wants), its 16-byte chunks XOR-swizzled by row so
// that the fragment reads meet no bank conflict; b's tile lands row-major,
// then each thread reads 8 n of four k rows, transposes the 4 x 4 byte
// blocks with transpose4 and stores one word per column into a
// column-major tile.  Every element is loaded with a mask, so any M, K, N
// and any byte offset of the operands is taken.

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

// bytes p[0..15] with the ones at or past `valid` read as zero, as a word set
__device__ __forceinline__ uint4 load16_masked(const int8_t* p, int valid) {
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < valid) w[i / 4] |= (uint32_t)(uint8_t)p[i] << (8 * (i % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Store the k-tile at k0 into stage (As, Bs): a [BM x BK] as 512 16-byte
// chunks, b [BK x BN] as 512; two of each a thread.
__device__ __forceinline__ void load_tile(uint32_t* As, uint32_t* Bs, const int8_t* __restrict__ a,
                                          const int8_t* __restrict__ b, int M, int N, int K,
                                          int m0, int n0, int k0, int tid) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int c = tid + THREADS * p;
    const int row = c / 4, ch = c % 4, m = m0 + row, k = k0 + 16 * ch;
    const bool in = m < M && k < K;
    *reinterpret_cast<uint4*>(As + a_word(row, 4 * ch)) =
        load16_masked(a + (size_t)m * K + k, in ? K - k : 0);
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int c = tid + THREADS * p;
    const int row = c / 8, ch = c % 8, kk = k0 + row, n = n0 + 16 * ch;
    const bool in = kk < K && n < N;
    *reinterpret_cast<uint4*>(Bs + row * B_ROW_WORDS + 4 * ch) =
        load16_masked(b + (size_t)kk * N + n, in ? N - n : 0);
  }
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

__global__ void __launch_bounds__(THREADS)
int8_matmul_bytes(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
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
  for (int st = 0; st < STAGES - 1; ++st)
    if (st < n_tiles)
      load_tile(As + st * A_WORDS, Bs + st * B_WORDS, a, b, M, N, K, m0, n0, st * BK, tid);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt % STAGES;
    __syncthreads();                      // tile kt is stored; tile kt - 1 is no longer read
    transpose_b(Bs + st * B_WORDS, Bt, tid);
    const int next = kt + STAGES - 1;
    if (next < n_tiles)
      load_tile(As + (next % STAGES) * A_WORDS, Bs + (next % STAGES) * B_WORDS, a, b,
                M, N, K, m0, n0, next * BK, tid);
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

cudaError_t launch_bytes(const int8_t* a, const int8_t* b, const float* a_scale,
                         const float* b_scale, float* out, int M, int N, int K,
                         cudaStream_t stream) {
  // above 48 KB of shared memory a kernel must opt in (all of it is dynamic)
  const cudaError_t rc = cudaFuncSetAttribute(int8_matmul_bytes,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              SMEM_BYTES);
  if (rc != cudaSuccess) return rc;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_bytes<<<grid, THREADS, SMEM_BYTES, stream>>>(a, b, a_scale, b_scale, out, M, N, K);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// The path a call with these operands takes: 1 for TMA, with a's rows a
// block takes (*bm) and the blocks of a cluster (*cluster); 0 for the
// byte-wise path.
int int8_matmul_s8_plan(const void* a, const void* b, const void* out, int M, int N, int K,
                        int* bm, int* cluster) {
  const bool tma = K % 16 == 0 && N % 16 == 0 && aligned16(a) && aligned16(b) && aligned16(out);
  *bm = !tma ? BM : M <= 16 ? 16 : M <= 32 ? 32 : M <= 64 ? 64 : M <= 128 ? 128 : 256;
  *cluster = tma ? 2 : 1;
  return tma ? 1 : 0;
}

// a [M, K], b [K, N] int8; a_scale [M], b_scale [N], out [M, N] fp32; all
// device pointers to contiguous arrays.  Launches on `stream` and does not
// synchronise.  Returns the launch's cudaError_t.
int int8_matmul_s8(const int8_t* a, const int8_t* b, const float* a_scale,
                   const float* b_scale, float* out, int M, int N, int K,
                   void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (M < 1 || N < 1 || K < 1 || (M + 127) / 128 > 65535) return cudaErrorInvalidValue;
  int bm, cluster;
  if (!int8_matmul_s8_plan(a, b, out, M, N, K, &bm, &cluster))
    return launch_bytes(a, b, a_scale, b_scale, out, M, N, K, stream);
  switch (bm) {
    case 16: return launch_tma<8>(a, b, a_scale, b_scale, out, M, N, K, stream);
    case 32: return launch_tma<16>(a, b, a_scale, b_scale, out, M, N, K, stream);
    case 64: return launch_tma<32>(a, b, a_scale, b_scale, out, M, N, K, stream);
    case 128: return launch_tma<64>(a, b, a_scale, b_scale, out, M, N, K, stream);
    default: return launch_tma<128>(a, b, a_scale, b_scale, out, M, N, K, stream);
  }
}

const char* int8_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
