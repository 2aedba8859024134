"""ROM-LUT tanh: ``ops.tanh_lut`` (wrapper, launch counter), ``kernel`` (CUDA
build and binding of ``csrc/tanh_lut.cu``), ``ref`` (``make_lut`` and the
plain version ``tanh_lut_ref``)."""
