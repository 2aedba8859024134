"""Bind the Hopper ``lstm_seq`` kernel (``csrc/lstm_seq.cu``).

Route: ``nvcc`` compiles the source into a shared library with a plain C
interface, loaded with ``ctypes`` (``kernels/_build.py``: built at first use
into ``build/`` at the root of the checkout, named by a hash of the source,
the shared headers and the flags).  Nothing is built or loaded when this
module is imported.

:func:`lstm_seq` takes CUDA tensors only and raises on anything else: the
plain PyTorch version for CPU tensors lives in ``ref.py`` and is chosen by
``ops.lstm_seq``.  A call is two CUDA launches (the input GEMM and the
persistent recurrence) and waits for the stream at its end, to read the
grid barrier's error word (counted in ``_build.host_syncs()``); :func:`config`
reports the persistent kernel's grid and whether ``w_h`` is resident in
shared memory.
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
        lib.lstm_seq_config.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
        lib.lstm_seq_config.restype = _I
        lib.lstm_seq_serial_floor.argtypes = [_I, _I, _I, _I, _P, _P]
        lib.lstm_seq_serial_floor.restype = _I
        lib.lstm_seq_barrier_probe.argtypes = [_I, _I, _I, _P, _P]
        lib.lstm_seq_barrier_probe.restype = _I
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
    zx = torch.empty((B * T * 4 * H + _build.GRID_BARRIER_WORDS,), **f32)   # + the grid barrier's words
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
    _raise_on(lib, rc)
    _build.count_host_sync()
    return y, h_out, c_out


def _raise_on(lib: ctypes.CDLL, rc: int) -> None:
    if rc != 0:
        msg = lib.lstm_seq_error_string(rc).decode()
        raise RuntimeError(f"lstm_seq kernel launch failed: code {rc} ({msg})")


def config(B: int, H: int, n_lut: int = 0) -> dict:
    """The persistent kernel's launch configuration on the current card at
    these sizes: ``grid`` blocks, ``weights_resident`` (w_h slices held in
    shared memory), ``smem_bytes`` of dynamic shared memory."""
    lib = load()
    out = (_I * 3)()
    _raise_on(lib, lib.lstm_seq_config(B, H, n_lut, out))
    return {"grid": out[0], "weights_resident": bool(out[1]), "smem_bytes": out[2]}


def _barrier_call(fn, *args) -> None:
    dev = torch.device("cuda", torch.cuda.current_device())
    bar = torch.empty((_build.GRID_BARRIER_WORDS,), dtype=torch.int32, device=dev)
    _raise_on(load(), fn(*args, bar.data_ptr(), torch.cuda.current_stream(dev).cuda_stream))


def serial_floor(B: int, T: int, H: int, n_lut: int = 0) -> None:
    """Launch the serial floor of one call on the current stream: the
    persistent kernel's grid at these sizes running its T - 1 grid barriers
    and no work (for timing; not counted as a launch of the kernel)."""
    _barrier_call(load().lstm_seq_serial_floor, B, T, H, n_lut)


def barrier_probe(grid: int, n: int, missing: int = -1) -> None:
    """``n`` grid barriers over ``grid`` cooperative blocks, block
    ``missing`` never arriving (-1: none).  Raises as a launch of the kernel
    does: on a grid too large to be co-resident, and on a barrier past its
    1 s deadline."""
    _barrier_call(load().lstm_seq_barrier_probe, grid, n, missing)


__all__ = ["SOURCE", "barrier_probe", "build", "config", "load", "lstm_seq", "serial_floor"]
