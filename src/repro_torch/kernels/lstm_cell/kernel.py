"""Bind the Hopper ``lstm_seq`` kernel (``csrc/lstm_seq.cu``).

Route: ``nvcc`` compiles the source into a shared library with a plain C
interface, loaded with ``ctypes`` (``kernels/_build.py``: built at first use
into ``build/`` at the root of the checkout, named by a hash of the source,
the shared headers and the flags).  Nothing is built or loaded when this
module is imported.

:func:`lstm_seq` takes CUDA tensors only and raises on anything else: the
plain PyTorch version for CPU tensors lives in ``ref.py`` and is chosen by
``ops.lstm_seq``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "lstm_seq.cu"

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib: ctypes.CDLL | None = None


def build() -> Path:
    """Compile the library unless it is already built; returns its path."""
    return _build.build("lstm_seq", SOURCE)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library once per process."""
    global _lib
    if _lib is None:
        lib = _build.load("lstm_seq", SOURCE)
        lib.lstm_seq_f32.argtypes = [_P] * 7 + [_I] + [_P] * 6 + [_I] * 4 + [_P]
        lib.lstm_seq_f32.restype = _I
        lib.lstm_seq_error_string.argtypes = [_I]
        lib.lstm_seq_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.device != device:
        raise RuntimeError(f"lstm_seq kernel: {name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"lstm_seq kernel: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"lstm_seq kernel: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"lstm_seq kernel: {name} must be contiguous")


def lstm_seq(x: torch.Tensor, w_x: torch.Tensor, w_h: torch.Tensor, b: torch.Tensor,
             h0: torch.Tensor, c0: torch.Tensor, lut: torch.Tensor | None = None):
    """Launch the kernel on the current stream: fp32 CUDA tensors in, fp32
    ``(y [B,T,H], h [B,H], c [B,H])`` out.  Raises on a non-CUDA tensor."""
    if x.device.type != "cuda":
        raise RuntimeError(f"lstm_seq kernel needs CUDA tensors, got {x.device}")
    B, T, D = x.shape
    H = w_h.shape[0]
    if T < 1 or B < 1:
        raise ValueError(f"lstm_seq kernel: empty input of shape {tuple(x.shape)}")
    dev = x.device
    for name, t, shape in (("x", x, (B, T, D)), ("w_x", w_x, (D, 4 * H)),
                           ("w_h", w_h, (H, 4 * H)), ("b", b, (4 * H,)),
                           ("h0", h0, (B, H)), ("c0", c0, (B, H))):
        _check(name, t, shape, dev)
    n_lut = 0 if lut is None else int(lut.shape[0])
    if lut is not None:
        _check("lut", lut, (n_lut,), dev)

    lib = load()
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty((B, T, H), **f32)
    h_out = torch.empty((B, H), **f32)
    c_out = torch.empty((B, H), **f32)
    zx = torch.empty((B, T, 4 * H), **f32)
    h_buf = torch.empty((2, B, H), **f32)
    c_buf = torch.empty((2, B, H), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lstm_seq_f32(
            x.data_ptr(), w_x.data_ptr(), w_h.data_ptr(), b.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), None if lut is None else lut.data_ptr(), n_lut,
            y.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
            zx.data_ptr(), h_buf.data_ptr(), c_buf.data_ptr(),
            B, T, D, H, stream)
    if rc != 0:
        msg = lib.lstm_seq_error_string(rc).decode()
        raise RuntimeError(f"lstm_seq kernel launch failed: cudaError {rc} ({msg})")
    return y, h_out, c_out


__all__ = ["SOURCE", "build", "load", "lstm_seq"]
