// A grid-wide barrier for a persistent kernel whose blocks are all
// co-resident, shared by lstm_seq.cu and the generated stage kernels
// (codegen/cuda_emit.py).
//
// One counter in device memory, zeroed before the launch: each block's
// thread 0 fences and adds one to it, and waits (acquire loads) until the
// count reaches the end of its round, the next multiple of the grid size.
// One atomic per block and barrier, and no reset on the critical path.  It
// is only correct when every block of the grid is resident at once, so the
// kernels that use it are launched with cudaLaunchCooperativeKernel, which
// refuses a grid that cannot be (cudaErrorCooperativeLaunchTooLarge)
// instead of letting it hang.  The count must stay below 2^31 in a launch:
// grid size x barriers, about 16 million steps at 132 blocks.  It needs no
// cooperative_groups, so no relocatable device code (-rdc) either.
//
// A spin that lasts past GRID_BARRIER_DEADLINE_NS on %globaltimer writes
// the error word and gives up, and so does every block that sees the error
// word set: the kernel returns, and grid_barrier_launch() turns the word
// into GRID_BARRIER_TIMEOUT for the host function to return.  A broken
// barrier becomes an exception in the caller, never a hung card.
//
// Memory ordering: whatever a block wrote before the barrier is visible to
// every block after it (__syncthreads, then a device-scope fence before the
// arrival and after the wait).  Data exchanged through it must be read
// with plain loads: not through `const __restrict__` pointers and not with
// __ldg, whose read-only path may serve a stale line within one launch.

#pragma once

#include <cuda_runtime.h>

#define GRID_BARRIER_DEADLINE_NS 1000000000ull  // 1 s
#define GRID_BARRIER_TIMEOUT (-1)               // host-side return code

struct GridBarrier {
  unsigned int count;   // arrivals so far in this launch
  unsigned int error;   // set by a spin past its deadline
  unsigned int pad[2];
};

__device__ __forceinline__ unsigned long long grid_barrier_clock_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned int grid_barrier_load(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every thread of every block calls it; returns false in every thread of
// the block when the barrier is broken (the caller then returns).
__device__ __forceinline__ bool grid_sync(GridBarrier* bar) {
  __shared__ int grid_barrier_ok;
  __syncthreads();
  if (threadIdx.x == 0) {
    int ok = 1;
    const unsigned int n = gridDim.x * gridDim.y * gridDim.z;
    __threadfence();
    const unsigned int arrived = atomicAdd(&bar->count, 1u);
    const unsigned int target = arrived - arrived % n + n;   // the end of this round
    const unsigned long long t0 = grid_barrier_clock_ns();
    unsigned int spins = 0;
    while ((int)(grid_barrier_load(&bar->count) - target) < 0) {
      if ((++spins & 63) != 0) continue;
      if (grid_barrier_load(&bar->error)) {
        ok = 0;
        break;
      }
      if (grid_barrier_clock_ns() - t0 > GRID_BARRIER_DEADLINE_NS) {
        atomicExch(&bar->error, 1u);
        ok = 0;
        break;
      }
    }
    __threadfence();
    grid_barrier_ok = ok;
  }
  __syncthreads();
  return grid_barrier_ok != 0;
}

namespace {

// An empty persistent kernel: `n` grid barriers and nothing else.  Timed at
// a stage's grid and barrier count it gives the serial floor of the chain.
// Block `missing` (-1: none) returns at once and never arrives, which breaks
// the first barrier: the tests' way to see the deadline raise.
__global__ void grid_barrier_probe(GridBarrier* bar, int n, int missing) {
  if ((int)blockIdx.x == missing) return;
  for (int i = 0; i < n; ++i)
    if (!grid_sync(bar)) return;
}

}  // namespace

// Zero the barrier word on `stream` before a cooperative launch.
static inline cudaError_t grid_barrier_reset(GridBarrier* bar, cudaStream_t stream) {
  return cudaMemsetAsync(bar, 0, sizeof(GridBarrier), stream);
}

// The cooperative launch of `kernel`, then its barrier's error word (read
// back with a synchronising copy).  Returns the launch's error (cleared, so
// that the next cudaGetLastError() does not see it again),
// GRID_BARRIER_TIMEOUT for a broken barrier, or 0.
static inline int grid_barrier_launch(const void* kernel, int grid, int threads, void** args,
                                      size_t smem, GridBarrier* bar, cudaStream_t stream) {
  cudaError_t err = grid_barrier_reset(bar, stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(threads), args, smem, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  unsigned int broken = 0;
  err = cudaMemcpyAsync(&broken, &bar->error, sizeof(broken), cudaMemcpyDeviceToHost, stream);
  if (err != cudaSuccess) return err;
  err = cudaStreamSynchronize(stream);
  if (err != cudaSuccess) return err;
  return broken ? GRID_BARRIER_TIMEOUT : 0;
}

// `n` barriers over `grid` blocks of `threads`, launched as the stage
// kernels are; returns as grid_barrier_launch does.
static inline int grid_barrier_run_probe(int grid, int threads, int n, int missing,
                                         GridBarrier* bar, cudaStream_t stream) {
  void* args[] = {&bar, &n, &missing};
  return grid_barrier_launch((const void*)grid_barrier_probe, grid, threads, args, 0, bar,
                             stream);
}

static inline const char* grid_barrier_error_string(int code) {
  return code == GRID_BARRIER_TIMEOUT
             ? "grid barrier passed its 1 s deadline (a block never arrived)"
             : cudaGetErrorString(static_cast<cudaError_t>(code));
}
