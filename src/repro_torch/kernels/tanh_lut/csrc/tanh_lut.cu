// Elementwise ROM-LUT tanh with linear interpolation, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/tanh_lut/kernel.py::tanh_lut
// (Pallas body _kernel): y = lut_interpolate(x) over a flattened x of any
// size, with the table lut [n] and its shifted partner (paper section IV-B).
//
// What bounds it on this card: bytes.  Each element is read once and written
// once (8 bytes) for a handful of FLOPs, so at 3.35 TB/s the bound is
// 8 * size / 3.35e12 s.  The design: one grid-stride pass with neighbouring
// threads on neighbouring elements (coalesced loads and stores); each block
// first copies the table and the shifted table into shared memory, so the
// per-element gather is a shared-memory load.  Any size is accepted: the
// TPU kernel's block-halving (kernel.py:37-39) has no counterpart, the last
// grid-stride pass is masked instead.  The interpolation itself is lut.cuh's
// lut_interpolate, shared with lstm_seq.cu and the generated stage kernels.

#include <cuda_runtime.h>
#include <stddef.h>

#include "lut.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
tanh_lut_kernel(const float* __restrict__ x, const float* __restrict__ lut,
                float* __restrict__ y, long long size, int n) {
  extern __shared__ float tab[];  // [lut, lut shifted by one], 2 * n
  for (int i = threadIdx.x; i < n; i += THREADS) {
    tab[i] = lut[i];
    tab[n + i] = lut[min(i + 1, n - 1)];
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < size; i += stride)
    y[i] = lut_interpolate(x[i], tab, tab + n, n);
}

}  // namespace

extern "C" {

// x, y: device pointers to `size` contiguous fp32 values; lut: [n] fp32.
// `blocks` caps the grid (the wrapper passes a few blocks per SM).  Launches
// on `stream` and does not synchronise.  Returns the launch's cudaError_t.
int tanh_lut_f32(const float* x, const float* lut, float* y, long long size, int n,
                 int blocks, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (size < 1 || n < 1 || blocks < 1) return cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)n * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        tanh_lut_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long need = (size + THREADS - 1) / THREADS;
  const int grid = need < blocks ? (int)need : blocks;
  tanh_lut_kernel<<<grid, THREADS, smem, stream>>>(x, lut, y, size, n);
  return cudaGetLastError();
}

const char* tanh_lut_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
