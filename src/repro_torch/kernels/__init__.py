"""Hand-written Hopper kernels, each beside its plain PyTorch version.

  lstm_cell   — fused LSTM over a sequence (CUDA C++, ``csrc/lstm_seq.cu``)
  tanh_lut    — the ROM-LUT tanh (CUDA C++, ``csrc/tanh_lut.cu``) and its table
  int8_matmul — the int8 weight packer ``quantize_per_channel`` (the kernel waits)

``csrc/lut.cuh`` holds the one ``__device__ lut_interpolate`` of every kernel
that reads the tanh table (``lstm_seq``, ``tanh_lut`` and the generated stage
kernels of ``repro_torch.codegen``); ``_build.py`` builds every CUDA source.

A wrapper (``ops.py``) launches the kernel for a CUDA tensor and takes the
plain version (``ref.py``) for a CPU tensor; it never falls back from one to
the other.
"""
