"""Hand-written Hopper kernels, each beside its plain PyTorch version.

  lstm_cell   — fused LSTM over a sequence (CUDA C++, ``csrc/lstm_seq.cu``)
  tanh_lut    — the ROM-LUT tanh (CUDA C++, ``csrc/tanh_lut.cu``) and its table
  ssm_scan    — the Mamba-1 selective scan (CUDA C++, ``csrc/ssm_scan.cu``)
  int8_matmul — int8 × int8 → int32 MACC matmul (CUDA C++, ``csrc/int8_matmul.cu``)
                and its quantizers (``quantize_per_channel`` also packs the
                generated stage kernel's int8 ROMs)
  flash_attention — online-softmax GQA attention with causal / window masks
                and softcap (CUDA C++, ``csrc/flash_attention.cu``)

``csrc/lut.cuh`` holds the one ``__device__ lut_interpolate`` of every kernel
that reads the tanh table (``lstm_seq``, ``tanh_lut`` and the generated stage
kernels of ``repro_torch.codegen``); ``_build.py`` builds every CUDA source.

A wrapper (``ops.py``) launches the kernel for a CUDA tensor and takes the
plain version (``ref.py``) for a CPU tensor; it never falls back from one to
the other.  No kernel has a backward pass (nor has the reference's): a
launch under autograd, with grad enabled and an input that requires grad,
raises ``NotImplementedError`` (``_build.refuse_grad``) instead of returning
a result whose gradients would stop at the kernel.
"""
