"""Bind the Hopper ``ssm_scan`` kernel (``csrc/ssm_scan.cu``): ``nvcc`` at first
use into ``build/`` (``kernels/_build.py``), a plain C interface, ``ctypes``.

:func:`ssm_scan` takes CUDA tensors only and raises on anything else; the
plain version for CPU tensors is ``ref.ssm_scan_ref``, chosen by
``ops.ssm_scan``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu"
MAX_N = 128          # 32 lanes x 4 states a thread (ssm_scan.cu)
MAX_BATCH = 65535    # the grid's y extent

_lib: ctypes.CDLL | None = None


def build() -> Path:
    """Compile the library unless it is already built; returns its path."""
    return _build.build("ssm_scan", SOURCE)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library once per process."""
    global _lib
    if _lib is None:
        lib = _build.load("ssm_scan", SOURCE)
        lib.ssm_scan_f32.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.ssm_scan_f32.restype = ctypes.c_int
        lib.ssm_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssm_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.device != device:
        raise RuntimeError(f"ssm_scan kernel: {name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"ssm_scan kernel: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"ssm_scan kernel: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"ssm_scan kernel: {name} must be contiguous")


def ssm_scan(x: torch.Tensor, delta: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, h0: torch.Tensor | None = None):
    """Launch the kernel on the current stream: contiguous fp32 CUDA tensors
    in (``h0`` None means zeros), fp32 ``(y [Bsz,T,D], h_final [Bsz,D,N])``
    out.  Raises on a non-CUDA tensor or a size the kernel does not take."""
    if x.device.type != "cuda":
        raise RuntimeError(f"ssm_scan kernel needs CUDA tensors, got {x.device}")
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"ssm_scan kernel: x {tuple(x.shape)}, A {tuple(A.shape)}; "
                         "needs x [Bsz, T, D] and A [D, N]")
    Bsz, T, D = x.shape
    N = A.shape[1]
    if min(Bsz, T, D, N) < 1 or N > MAX_N or Bsz > MAX_BATCH:
        raise ValueError(f"ssm_scan kernel: Bsz={Bsz}, T={T}, D={D}, N={N}; needs every "
                         f"size >= 1, N <= {MAX_N} and Bsz <= {MAX_BATCH}")
    dev = x.device
    for name, t, shape in (("x", x, (Bsz, T, D)), ("delta", delta, (Bsz, T, D)),
                           ("A", A, (D, N)), ("B", B, (Bsz, T, N)), ("C", C, (Bsz, T, N))):
        _check(name, t, shape, dev)
    if h0 is not None:
        _check("h0", h0, (Bsz, D, N), dev)

    lib = load()
    y = torch.empty((Bsz, T, D), dtype=torch.float32, device=dev)
    h_out = torch.empty((Bsz, D, N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ssm_scan_f32(x.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
                              C.data_ptr(), None if h0 is None else h0.data_ptr(),
                              y.data_ptr(), h_out.data_ptr(), Bsz, T, D, N, stream)
    if rc != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: cudaError {rc} "
                           f"({lib.ssm_scan_error_string(rc).decode()})")
    return y, h_out


__all__ = ["MAX_N", "SOURCE", "build", "load", "ssm_scan"]
