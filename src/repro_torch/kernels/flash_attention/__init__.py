"""Blocked online-softmax GQA attention: ``ops.flash_attention`` (wrapper,
launch counter), ``kernel`` (CUDA build and binding of
``csrc/flash_attention.cu``), ``ref`` (the plain PyTorch version)."""
