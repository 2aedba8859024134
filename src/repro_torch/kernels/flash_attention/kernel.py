"""Bind the Hopper ``flash_attention`` kernel (``csrc/flash_attention.cu``):
``nvcc`` at first use into ``build/`` (``kernels/_build.py``), a plain C
interface, ``ctypes``.

:func:`flash_attention` takes contiguous fp32 CUDA tensors only and raises on
anything else; the plain version for CPU tensors is
``ref.flash_attention_ref``, chosen by ``ops.flash_attention``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MAX_HD = 256         # the widest instantiated head dimension (flash_attention.cu)
MAX_GRID_YZ = 65535  # H and B ride the grid's y and z extents
Q_TILE = 64          # query rows a block: 4 warps of 16 (flash_attention.cu)
MAX_SPLITS = 8       # key shares a q tile may be split into (flash_attention.cu)

_lib: ctypes.CDLL | None = None


def build() -> Path:
    """Compile the library unless it is already built; returns its path."""
    return _build.build("flash_attention", SOURCE)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library once per process."""
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention", SOURCE)
        lib.flash_attention_f32.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                                            + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
        lib.flash_attention_f32.restype = ctypes.c_int
        lib.flash_attention_splits.argtypes = [ctypes.c_int] * 8
        lib.flash_attention_splits.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def splits(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True, window: int = 0) -> int:
    """The key shares the kernel splits each q tile into on q's card (1:
    none, one launch; more: a second, combining launch), from the shapes
    and the card's SM count (``flash_attention_splits`` in the source)."""
    B, S, H, hd = q.shape
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    return load().flash_attention_splits(B, S, k.shape[1], H, hd, int(bool(causal)),
                                         int(window), sms)


def launches_per_call(n_splits: int) -> int:
    """The CUDA launches of one call with ``n_splits`` key shares: the
    kernel, and ``combine_kernel`` after it when the key axis is split."""
    return 1 if n_splits == 1 else 2


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, n_splits: int | None = None) -> torch.Tensor:
    """Launch the kernel on the current stream: q [B,S,H,hd], k and v
    [B,T,KV,hd], contiguous fp32 CUDA tensors; returns fp32 [B,S,H,hd].
    ``n_splits`` forces the key shares (1 .. ``MAX_SPLITS``); None takes
    :func:`splits`.  Raises on a non-CUDA tensor or a shape the kernel does
    not take."""
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention kernel needs CUDA tensors, got {q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)}, k {tuple(k.shape)}; "
                         "needs q [B, S, H, hd] and k, v [B, T, KV, hd]")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if (tuple(k.shape) != (B, T, KV, hd) or tuple(v.shape) != tuple(k.shape)
            or min(B, S, T, H, KV, hd) < 1 or H % KV or hd > MAX_HD
            or max(B, H) > MAX_GRID_YZ):
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; needs k and v [B, T, KV, hd] with the "
                         f"batch and hd of q, every size >= 1, H a multiple of KV, "
                         f"hd <= {MAX_HD}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise RuntimeError(f"flash_attention kernel: {name} is on {t.device}, "
                               f"expected {q.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"flash_attention kernel: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernel: {name} must be contiguous")

    lib = load()
    if n_splits is None:
        n_splits = splits(q, k, causal=causal, window=window)
    if not 1 <= n_splits <= MAX_SPLITS:
        raise ValueError(f"flash_attention kernel: {n_splits} key shares, needs 1 .. {MAX_SPLITS}")
    out = torch.empty_like(q)
    # the shares' unnormalised partial sums and their (m, l), merged by the
    # second launch
    ws = (torch.empty(n_splits * B * S * H * (hd + 2), dtype=torch.float32, device=q.device)
          if n_splits > 1 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                     None if ws is None else ws.data_ptr(),
                                     B, S, T, H, KV, hd, int(bool(causal)), int(window),
                                     float(softcap), hd ** -0.5, n_splits, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {rc} "
                           f"({lib.flash_attention_error_string(rc).decode()})")
    return out


__all__ = ["MAX_HD", "MAX_SPLITS", "Q_TILE", "SOURCE", "build", "flash_attention",
           "launches_per_call", "load", "splits"]
