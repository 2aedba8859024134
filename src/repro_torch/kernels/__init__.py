"""Hand-written Hopper kernels, each beside its plain PyTorch version.

  lstm_cell — fused LSTM over a sequence (CUDA C++, ``csrc/lstm_seq.cu``)
  tanh_lut  — the ROM tanh table (``make_lut``); its standalone kernel waits

A wrapper (``ops.py``) launches the kernel for a CUDA tensor and takes the
plain version (``ref.py``) for a CPU tensor; it never falls back from one to
the other.
"""
