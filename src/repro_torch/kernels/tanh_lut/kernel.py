"""Bind the Hopper ``tanh_lut`` kernel (``csrc/tanh_lut.cu``): ``nvcc`` at first
use into ``build/`` (``kernels/_build.py``), a plain C interface, ``ctypes``.

:func:`tanh_lut` takes CUDA tensors only and raises on anything else; the
plain version for CPU tensors is ``ref.tanh_lut_ref``, chosen by
``ops.tanh_lut``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "tanh_lut.cu"
BLOCKS_PER_SM = 8
MAX_TABLE = 2 ** 14      # 2 tables of 16k floats: 128 KB of shared memory

_lib: ctypes.CDLL | None = None


def build() -> Path:
    return _build.build("tanh_lut", SOURCE)


def load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("tanh_lut", SOURCE)
        lib.tanh_lut_f32.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.tanh_lut_f32.restype = ctypes.c_int
        lib.tanh_lut_error_string.argtypes = [ctypes.c_int]
        lib.tanh_lut_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def tanh_lut(x: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream: fp32 CUDA ``x`` (any shape,
    at least one element) and ``lut [n]`` in, fp32 ``y`` of x's shape out."""
    if x.device.type != "cuda":
        raise RuntimeError(f"tanh_lut kernel needs CUDA tensors, got {x.device}")
    for name, t in (("x", x), ("lut", lut)):
        if t.device != x.device:
            raise RuntimeError(f"tanh_lut kernel: {name} is on {t.device}, expected {x.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"tanh_lut kernel: {name} must be float32, got {t.dtype}")
    if lut.dim() != 1 or not 1 <= lut.shape[0] <= MAX_TABLE:
        raise ValueError(f"tanh_lut kernel: table of shape {tuple(lut.shape)}; "
                         f"needs [n] with 1 <= n <= {MAX_TABLE}")
    if x.numel() < 1:
        raise ValueError("tanh_lut kernel: empty input")
    x = x.contiguous()
    lut = lut.contiguous()
    y = torch.empty_like(x)
    lib = load()
    blocks = BLOCKS_PER_SM * torch.cuda.get_device_properties(x.device).multi_processor_count
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.tanh_lut_f32(x.data_ptr(), lut.data_ptr(), y.data_ptr(), x.numel(),
                              lut.shape[0], blocks, stream)
    if rc != 0:
        raise RuntimeError(f"tanh_lut kernel launch failed: cudaError {rc} "
                           f"({lib.tanh_lut_error_string(rc).decode()})")
    return y


__all__ = ["SOURCE", "build", "load", "tanh_lut"]
