// ROM-LUT interpolation (paper section IV-B), shared by every kernel of the
// port that reads the tanh table: lstm_seq.cu, tanh_lut.cu and the generated
// stage kernels (codegen/cuda_emit.py).  One definition, so the three cannot
// drift apart.
//
// The reference's kernels/_lut.py::lut_interpolate: clamp v to
// [-4, 4 - 1e-6), take the fractional table position, interpolate between
// lut[i0] and lut1[i0], where lut1 is lut shifted left by one entry with the
// last entry repeated (kernels/_lut.py::shifted_table).  frac is not clipped,
// as in the reference: values below the first sample centre are
// extrapolated linearly, values above the last one stay flat.  On the TPU the
// gather was a one-hot x table matmul; here it is a direct indexed load.

#pragma once

#define REPRO_LUT_RANGE 4.0f

__device__ __forceinline__ float lut_interpolate(float v, const float* lut,
                                                 const float* lut1, int n) {
  const float xf = fminf(fmaxf(v, -REPRO_LUT_RANGE), REPRO_LUT_RANGE - 1e-6f);
  const float pos = (xf + REPRO_LUT_RANGE) / (2.0f * REPRO_LUT_RANGE) * (float)n - 0.5f;
  const int i0 = min(max((int)floorf(pos), 0), n - 1);
  const float frac = pos - (float)i0;
  return lut[i0] * (1.0f - frac) + lut1[i0] * frac;
}
