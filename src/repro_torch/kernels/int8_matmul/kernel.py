"""Bind the Hopper ``int8_matmul`` kernel (``csrc/int8_matmul.cu``): ``nvcc`` at
first use into ``build/`` (``kernels/_build.py``), a plain C interface,
``ctypes``.

:func:`int8_matmul` takes CUDA tensors only and raises on anything else; the
plain version for CPU tensors is ``ref.int8_matmul_ref``, chosen by
``ops.int8_matmul``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "int8_matmul.cu"

_lib: ctypes.CDLL | None = None


def build() -> Path:
    """Compile the library unless it is already built; returns its path."""
    return _build.build("int8_matmul", SOURCE)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library once per process."""
    global _lib
    if _lib is None:
        lib = _build.load("int8_matmul", SOURCE)
        lib.int8_matmul_s8.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.int8_matmul_s8.restype = ctypes.c_int
        lib.int8_matmul_error_string.argtypes = [ctypes.c_int]
        lib.int8_matmul_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, numel: int,
           device: torch.device) -> None:
    if t.device != device:
        raise RuntimeError(f"int8_matmul kernel: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"int8_matmul kernel: {name} must be {dtype}, got {t.dtype}")
    if t.numel() != numel:
        raise ValueError(f"int8_matmul kernel: {name} has shape {tuple(t.shape)}, "
                         f"expected {numel} elements")
    if not t.is_contiguous():
        raise ValueError(f"int8_matmul kernel: {name} must be contiguous")


def int8_matmul(a_q: torch.Tensor, b_q: torch.Tensor, a_scale: torch.Tensor,
                b_scale: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream: int8 ``a_q [M,K]``, ``b_q
    [K,N]``, fp32 ``a_scale [M,1]``, ``b_scale [1,N]`` on the card in, fp32
    ``[M,N]`` out.  Raises on a non-CUDA tensor or a mismatched shape."""
    if a_q.device.type != "cuda":
        raise RuntimeError(f"int8_matmul kernel needs CUDA tensors, got {a_q.device}")
    if a_q.dim() != 2 or b_q.dim() != 2 or a_q.shape[1] != b_q.shape[0]:
        raise ValueError(f"int8_matmul kernel: a {tuple(a_q.shape)} @ b {tuple(b_q.shape)}")
    M, K = a_q.shape
    N = b_q.shape[1]
    if min(M, K, N) < 1:
        raise ValueError(f"int8_matmul kernel: empty product M={M}, K={K}, N={N}")
    dev = a_q.device
    for name, t, dtype, numel in (("a_q", a_q, torch.int8, M * K), ("b_q", b_q, torch.int8, K * N),
                                  ("a_scale", a_scale, torch.float32, M),
                                  ("b_scale", b_scale, torch.float32, N)):
        _check(name, t, dtype, numel, dev)
    lib = load()
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.int8_matmul_s8(a_q.data_ptr(), b_q.data_ptr(), a_scale.data_ptr(),
                                b_scale.data_ptr(), out.data_ptr(), M, N, K, stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: cudaError {rc} "
                           f"({lib.int8_matmul_error_string(rc).decode()})")
    return out


__all__ = ["SOURCE", "build", "int8_matmul", "load"]
