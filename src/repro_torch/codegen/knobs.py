"""Per-backend knob metadata; the port's counterpart of
``repro/codegen/knobs.py``, with the port's backend names (``eager`` where
the reference says ``xla``, ``kernel`` where it says ``pallas``).

The synthesis knobs — unroll ``j``, C-slow factor, fixed-point word width,
and the reference's TPU tiling knobs — are not uniformly valid: the eager
scan has no fixed-point path for recurrent cells, the ssm cell has no
activation units so the kernel's LUT mode needs the int8 MACC
(``bits <= 8``), the rtlsim word width is clamped to
``[WORD_BITS_MIN, WORD_BITS_MAX]``, and ``double_buffer``/``chunk``/
``block_b`` only exist on the kernel backend (where the card accepts them
without effect).  This module is the single source of those rules and of
the tuner's default grids, and the rules mirror
:func:`repro_torch.core.synthesis._quant_analysis`.
"""

from __future__ import annotations

import functools

# ---------------------------------------------------------------------------
# Word-width validity: the ONE table every width check imports.
#
# The fixed-point word length is bounded below by the AF address select
# (Create_AF reads bits [W-2 -: AF_ADDR_BITS], so W-2 >= AF_ADDR_BITS) and
# above by int64 exactness of the simulators (2W-bit products/accumulators
# must fit a signed 64-bit word).  rtlsim, the Verilog emitter, the
# fixed-point golden model and the static analyzer all consume these
# instead of re-stating the rule.
# ---------------------------------------------------------------------------
WORD_BITS_MIN = 8
WORD_BITS_MAX = 32


def word_bits_reason(bits: int) -> str | None:
    """Why ``bits`` is not a legal fixed-point word width — or None."""
    if not WORD_BITS_MIN <= bits <= WORD_BITS_MAX:
        return (f"word width {bits} outside rtlsim's [{WORD_BITS_MIN}, "
                f"{WORD_BITS_MAX}] (AF addr select needs W-2 >= 6 bits; "
                "2W-bit accumulators must stay exact in int64)")
    return None


# Default search grid per knob (the reference's): the predict pass is cheap
# but the measure pass builds, so the default space stays a few dozen
# candidates wide.  Callers override any axis.  The last three are the
# reference's TPU tiling grids; they build the same kernel on the card, so
# the port's tuner (repro_torch.tune.space) has no such axes.
DEFAULT_UNROLL = (1, 2, 4)
DEFAULT_C_SLOW = (1, 2, 4)
DEFAULT_QUANT_BITS = (None, 8)
DEFAULT_DOUBLE_BUFFER = (True, False)
DEFAULT_CHUNK = (None,)
DEFAULT_BLOCK_B = (None,)


@functools.lru_cache(maxsize=None)
def _cell_has_af(cell: str) -> bool:
    """Does the cell's datapath contain activation-function units?  (The
    kernel's LUT quantization mode only exists when there is an AF to ROM.)"""
    if cell == "mlp":
        return True
    from .builders import CELL_GRAPHS

    return bool(CELL_GRAPHS[cell](2, 2).af_nodes())


def quant_reason(backend: str, cell: str, bits: int | None) -> str | None:
    """Why ``quant_bits=bits`` is invalid for (backend, cell) — or None if
    it is valid.  Mirrors ``synthesis._quant_analysis`` exactly."""
    if bits is None:
        return None
    # the bit path (rtlsim vs golden model) only exists for legal widths
    reason = word_bits_reason(bits)
    if reason is not None:
        return f"quant_bits={bits} is not verifiable: {reason}"
    if cell == "mlp":
        return None  # fixed-point SNR analysis runs on every backend
    if backend == "eager":
        return (f"quant_bits={bits} with cell='{cell}' has no eager path "
                "(no LUT gates / int8 MACC on the scan backend)")
    if backend == "verilog":
        return None  # quant_bits is the RTL word width
    if backend == "kernel":
        if _cell_has_af(cell) or bits <= 8:
            return None
        return (f"quant_bits={bits} on af-free cell '{cell}' has nothing to "
                "quantize on the kernel (no AF ROM; int8 MACC needs bits <= 8)")
    return f"unknown backend '{backend}'"


def knob_reason(backend: str, cell: str, *, unroll: int = 1, c_slow: int = 1,
                quant_bits: int | None = None, double_buffer: bool = True,
                chunk: int | None = None,
                block_b: int | None = None) -> str | None:
    """Full-candidate validity check: first reason the combination cannot be
    synthesized, or None when it can."""
    if unroll < 1:
        return f"unroll={unroll} must be >= 1"
    if c_slow < 1:
        return f"c_slow={c_slow} must be >= 1"
    reason = quant_reason(backend, cell, quant_bits)
    if reason is not None:
        return reason
    if backend != "kernel":
        if not double_buffer:
            return f"double_buffer=False only exists on kernel (got {backend})"
        if chunk is not None or block_b is not None:
            return f"chunk/block_b only exist on kernel (got {backend})"
    else:
        if chunk is not None and chunk < 1:
            return f"chunk={chunk} must be >= 1"
        if block_b is not None and block_b < 1:
            return f"block_b={block_b} must be >= 1"
    return None


def normalize_pallas_knobs(backend: str, double_buffer: bool,
                           chunk: int | None, block_b: int | None):
    """Collapse the kernel-only tiling knobs (the reference's Pallas knobs)
    to their defaults on other backends, so two knob settings that build the
    same artifact are one candidate."""
    if backend != "kernel":
        return True, None, None
    return double_buffer, chunk, block_b


__all__ = [
    "DEFAULT_BLOCK_B",
    "DEFAULT_CHUNK",
    "DEFAULT_C_SLOW",
    "DEFAULT_DOUBLE_BUFFER",
    "DEFAULT_QUANT_BITS",
    "DEFAULT_UNROLL",
    "WORD_BITS_MAX",
    "WORD_BITS_MIN",
    "knob_reason",
    "normalize_pallas_knobs",
    "quant_reason",
    "word_bits_reason",
]
