"""Mamba-1 selective scan: ``ops.ssm_scan`` (wrapper, launch counter),
``kernel`` (CUDA build and binding of ``csrc/ssm_scan.cu``), ``ref`` (the
plain PyTorch version, a time loop)."""
