// Hopper's own parts for hand-written sm_90a kernels: TMA tensor maps and
// bulk tensor copies, mbarrier rings, thread-block clusters, wgmma matrix
// descriptors and fences, and setmaxnreg.  First used by int8_matmul.cu.
//
// The PTX here exists only for sm_90a (wgmma, setmaxnreg) or sm_90 (TMA,
// mbarrier, clusters); nvcc checks it, on the machine with the card.
//
// A wait on an mbarrier that lasts past HOPPER_WAIT_DEADLINE_NS on
// %globaltimer traps: a ring whose byte counts or arrivals are wrong becomes
// a launch error in the caller, never a hung card.
//
// Tensor maps are encoded on the host by the driver's cuTensorMapEncodeTiled,
// reached through the runtime's driver entry point, so nothing links
// against libcuda.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define HOPPER_WAIT_DEADLINE_NS 1000000000ull  // 1 s

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long clock_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// ---- mbarrier ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA) and to
// the other blocks of the cluster
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also expects `bytes` more of transactions in this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// until the phase of parity `parity` has completed; traps past the deadline
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = clock_ns();
  for (uint32_t spins = 1;; ++spins) {
    if (mbar_try_wait(bar, parity)) return;
    if ((spins & 255) == 0 && clock_ns() - t0 > HOPPER_WAIT_DEADLINE_NS) __trap();
  }
}

// ---- clusters ---------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;" ::: "memory");
}

// the generic address of *p's counterpart in block `cta` of the cluster
// (distributed shared memory: plain loads and stores reach it)
template <class T>
__device__ __forceinline__ T* map_to_cta(T* p, uint32_t cta) {
  uint64_t q;
  asm volatile("mapa.u64 %0, %1, %2;" : "=l"(q) : "l"(reinterpret_cast<uint64_t>(p)), "r"(cta));
  return reinterpret_cast<T*>(q);
}

// ---- TMA --------------------------------------------------------------------

// box at (c0 innermost, c1) of `map` into shared `dst`, completing on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// ---- wgmma ------------------------------------------------------------------

// A K-major operand tile in shared memory as TMA writes it with
// CU_TENSOR_MAP_SWIZZLE_128B: rows of 128 bytes of k, 8-row atoms of 1024
// bytes (the tile 1024-aligned).  The leading offset is unused for this
// layout; the stride offset steps over one atom.  A k step of `b` bytes
// inside the 128 adds b to the start address: the swizzle is applied to the
// address the descriptor forms.
__device__ __forceinline__ uint64_t desc_k_major_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32)
         | ((uint64_t)1 << 62);
}

// orders the registers written before it (A fragments, accumulators) ahead
// of the wgmma that follows
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// until at most N committed groups of this warp are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of r across a wgmma
__device__ __forceinline__ void fence_operand(int& r) { asm volatile("" : "+r"(r) :: "memory"); }

// ---- setmaxnreg (a whole warpgroup; the roles' paths must not rejoin) ------

template <int N>
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void regs_claim() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(N));
}

// ---- host: tensor maps --------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, looked up once; null if unavailable
inline EncodeTiled encode_tiled_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                            cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                   cudaEnableDefault, &q);
#endif
    return (rc == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A row-major [rows, cols] byte matrix at `base` (16-byte aligned, `pitch`
// a multiple of 16) cut into boxes of box_rows x box_cols bytes, swizzled
// by 128 bytes (box_cols <= 128); reads past the edges give zeros.
inline cudaError_t encode_u8_2d(CUtensorMap* map, const void* base, uint64_t rows,
                                uint64_t cols, uint64_t pitch, uint32_t box_rows,
                                uint32_t box_cols) {
  const EncodeTiled encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {pitch};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
