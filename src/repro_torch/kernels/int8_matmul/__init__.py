"""int8 MACC matmul: ``ops.int8_matmul`` (wrapper, launch counter),
``ops.quantize_per_channel`` / ``quantize_rows`` / ``quantized_matmul``,
``kernel`` (CUDA build and binding of ``csrc/int8_matmul.cu``), ``ref`` (the
plain versions)."""
