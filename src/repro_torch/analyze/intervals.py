"""Word-space interval domain for the fixed-point datapath; the port's
counterpart of ``repro/analyze/intervals.py``, with the same bounds.

The analyzer proves per-bus-lane bounds on the **signed words** the emitted
RTL computes — the same ``Q(4.W-4)`` two's-complement words
:mod:`repro_torch.codegen.rtlsim` simulates — so "can this wrap?" is answered in
the exact arithmetic the hardware performs, not in a float approximation.

Every transfer function here mirrors one rtlsim primitive and is **sound**:
if each input word lies in its input interval, the output word lies in the
output interval.  Two facts carry the load:

* the serial MACC's per-cycle 2W-bit wraps compose to a single wrap of the
  exact sum (wrap is a ring homomorphism mod ``2^(2W)``), so bounding the
  exact accumulator sum and checking it against ``±2^(2W-1)`` is exact —
  when the bound fits, no intermediate wrap happened either;
* the Create_AF address (:func:`repro_torch.codegen.rtlsim.af_addr`) is monotone
  nondecreasing in its input *including* the clamp, so the ROM words
  reachable from an interval are exactly the slice
  ``rom[addr(lo) .. addr(hi)]`` — which keeps sigmoid gate bounds strictly
  inside ``[0, scale]`` instead of the useless full word range.

Whenever a bound escapes its word range the lane is **widened** to the full
word range (still sound — a wrapped value is *some* word) and a flag is
raised via the ``flag(kind, lanes, detail)`` callback; the range pass
turns flags into :class:`repro_torch.analyze.report.Finding`\\ s with step/stage
context.  All arithmetic is exact at any width: bounds are Python ints,
per-lane transfers run on int64 lane arrays (every word fits), and the MACC
transfer (the one O(in × out) step) runs as float64 products on the weight
ROM's device — exact because every partial sum is an integer below 2^53,
splitting the operands into 16-bit limbs where it would not be.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.codegen.af_samples import AF_ADDR_BITS

FlagFn = Callable[[str, list[int], str], None]


def _no_flag(_kind: str, _lanes: list[int], _detail: str) -> None:
    return None


def word_min(bits: int) -> int:
    return -(1 << (bits - 1))


def word_max(bits: int) -> int:
    return (1 << (bits - 1)) - 1


@dataclasses.dataclass(frozen=True)
class Bd:
    """Per-lane closed interval of signed words: lane i ∈ [lo[i], hi[i]]."""

    lo: tuple[int, ...]
    hi: tuple[int, ...]

    def __post_init__(self):
        if len(self.lo) != len(self.hi):
            raise ValueError("lo/hi lane mismatch")

    @property
    def lanes(self) -> int:
        return len(self.lo)

    @classmethod
    def point(cls, vals: Sequence[int]) -> "Bd":
        t = tuple(int(v) for v in vals)
        return cls(t, t)

    @classmethod
    def span(cls, lo: int, hi: int, lanes: int) -> "Bd":
        return cls((int(lo),) * lanes, (int(hi),) * lanes)

    @classmethod
    def full(cls, width: int, lanes: int) -> "Bd":
        return cls.span(word_min(width), word_max(width), lanes)

    def join(self, other: "Bd") -> "Bd":
        return Bd(tuple(min(a, b) for a, b in zip(self.lo, other.lo)),
                  tuple(max(a, b) for a, b in zip(self.hi, other.hi)))

    def contains(self, other: "Bd") -> bool:
        return all(sl <= ol and oh <= sh
                   for sl, ol, oh, sh
                   in zip(self.lo, other.lo, other.hi, self.hi))

    def contains_values(self, lo_obs, hi_obs) -> bool:
        """Do observed per-lane extremes (e.g. rtlsim ``wire_ranges``) lie
        inside the proven interval?"""
        return all(sl <= int(ol) and int(oh) <= sh
                   for sl, ol, oh, sh in zip(self.lo, lo_obs, hi_obs, self.hi))

    def amp(self) -> int:
        """Largest absolute word over all lanes."""
        return max(max(abs(a), abs(b)) for a, b in zip(self.lo, self.hi))


def _lanes(vals) -> np.ndarray:
    """Bound endpoints as an int64 lane array (every word of a ``Bd`` fits)."""
    return np.asarray(vals, dtype=np.int64)


def _bd(lo: np.ndarray, hi: np.ndarray) -> Bd:
    return Bd(tuple(lo.tolist()), tuple(hi.tolist()))


def _range_check(lo: np.ndarray, hi: np.ndarray, bits: int, kind: str,
                 flag: FlagFn) -> tuple[np.ndarray, np.ndarray]:
    """Clamp-or-flag: lanes whose bound escapes the ``bits``-wide word range
    are widened to the full range (a wrapped word is still some word) and
    reported under ``kind``.  ``lo``/``hi`` are int64 lane arrays, or
    object arrays of Python ints where a sum may leave int64."""
    wmin, wmax = word_min(bits), word_max(bits)
    bad = np.flatnonzero((lo < wmin) | (hi > wmax))
    if bad.size:
        worst = int(max(np.abs(lo[bad]).max(), np.abs(hi[bad]).max()))
        flag(kind, bad.tolist(), f"{bad.size}/{len(lo)} lane(s) reach |{worst}| "
             f"vs ±2^{bits - 1} at {bits} bits")
        lo, hi = lo.copy(), hi.copy()
        lo[bad], hi[bad] = wmin, wmax
    return lo, hi


def _qalign(lo: np.ndarray, hi: np.ndarray, width: int,
            flag: FlagFn) -> tuple[np.ndarray, np.ndarray]:
    """The ``[2W-5 -: W]`` result select: arithmetic >> (W-4) — floor
    division, exact on interval endpoints — then the W-bit wrap check."""
    s = width - 4
    return _range_check(lo >> s, hi >> s, width, "qalign-clip", flag)


@dataclasses.dataclass(frozen=True)
class MaccRom:
    """A weight ROM ``[in, out]`` of signed words prepared for
    :func:`macc_bd`, on its own device: the positive and negative parts
    side by side (``[in, 2*out]``, int64 and float64) and the largest
    column sum of ``|w|``."""

    split: torch.Tensor
    split64: torch.Tensor
    colsum: int

    @classmethod
    def of(cls, w_rows) -> "MaccRom":
        w = torch.as_tensor(w_rows, dtype=torch.int64)
        split = torch.cat([w.clamp(min=0), w.clamp(max=0)], dim=1)
        return cls(split, split.to(torch.float64), int(w.abs().sum(dim=0).max()))


def _exact_mm(x: np.ndarray, rom: MaccRom) -> np.ndarray:
    """``x @ rom.split`` for int64 ``x [r, in]``, exactly.  While no partial
    sum can reach 2^53 one float64 product on the ROM's device is exact in
    any summation order; past that both operands split into 16-bit limbs
    (each limb product below 2^32, so exact for a fan-in up to 2^21) that
    recombine as Python ints."""
    f64, dev = torch.float64, rom.split.device
    if int(np.abs(x).max()) * rom.colsum < 1 << 53:
        return (torch.as_tensor(x, dtype=f64, device=dev) @ rom.split64).to(
            torch.int64).cpu().numpy()
    if x.shape[1] >= 1 << 21:
        raise ValueError(f"MACC fan-in {x.shape[1]} is past the exact limb range 2^21")
    r, m = x.shape[0], rom.split.shape[1]
    xs = np.concatenate([x & 0xFFFF, x >> 16])                            # [2r, in]
    ws = torch.cat([rom.split & 0xFFFF, rom.split >> 16], dim=1).to(f64)  # [in, 2m]
    p = (torch.as_tensor(xs, dtype=f64, device=dev) @ ws).to(torch.int64)
    p = p.cpu().numpy().astype(object)
    ll, lh, hl, hh = p[:r, :m], p[:r, m:], p[r:, :m], p[r:, m:]
    return (hh << 32) + ((lh + hl) << 16) + ll


def macc_bd(x: Bd, w_rows, width: int,
            bias: Bd | None = None, flag: FlagFn = _no_flag) -> Bd:
    """Create_Layer transfer: interval of the exact accumulator sum, checked
    against the 2W register (``acc-wrap``), Q-aligned (``qalign-clip``),
    plus the W-bit bias add (``bias-wrap``).

    ``w_rows`` is the quantized weight ROM as ``[in][out]`` signed words —
    the same orientation ``rtlsim.macc_layer`` consumes — as a
    :class:`MaccRom` (the products run on its device), an int64 tensor or
    nested lists.  Per lane the lower bound takes ``x.lo`` against the
    positive weights and ``x.hi`` against the negative ones, the upper
    bound the reverse.
    """
    rom = w_rows if isinstance(w_rows, MaccRom) else MaccRom.of(w_rows)
    n = rom.split.shape[1] // 2
    p = _exact_mm(np.stack([_lanes(x.lo), _lanes(x.hi)]), rom)
    lo2 = p[0, :n] + p[1, n:]   # x.lo·w⁺ + x.hi·w⁻
    hi2 = p[1, :n] + p[0, n:]   # x.hi·w⁺ + x.lo·w⁻
    lo2, hi2 = _range_check(lo2, hi2, 2 * width, "acc-wrap", flag)
    lo, hi = _qalign(lo2, hi2, width, flag)
    if bias is not None:
        lo, hi = _range_check(lo + _lanes(bias.lo), hi + _lanes(bias.hi), width,
                              "bias-wrap", flag)
    return _bd(lo, hi)


def af_addr_int(v: int, width: int) -> int:
    """Pure-int mirror of :func:`repro_torch.codegen.rtlsim.af_addr` (one word)."""
    biased = v + (1 << (width - 2))
    if biased < 0:
        return 0
    if biased >= (1 << (width - 1)):
        return (1 << AF_ADDR_BITS) - 1
    return biased >> (width - 2 - (AF_ADDR_BITS - 1))


def _af_addr_lanes(v: np.ndarray, width: int) -> np.ndarray:
    """:func:`af_addr_int` over a lane array."""
    biased = v + (1 << (width - 2))
    addr = np.where(biased >= (1 << (width - 1)), (1 << AF_ADDR_BITS) - 1,
                    biased >> (width - 2 - (AF_ADDR_BITS - 1)))
    return np.where(biased < 0, 0, addr)


def _rom_hulls(rom: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``lo[i, j], hi[i, j]`` = min, max of ``rom[i..j]`` (for ``i <= j``)."""
    n = len(rom)
    lo = np.zeros((n, n), np.int64)
    hi = np.zeros((n, n), np.int64)
    for i in range(n):
        lo[i, i:] = np.minimum.accumulate(rom[i:])
        hi[i, i:] = np.maximum.accumulate(rom[i:])
    return lo, hi


def af_bd(x: Bd, fn: str, rom: Sequence[int] | None, width: int,
          flag: FlagFn = _no_flag) -> Bd:
    """Create_AF transfer.  ROM functions bound via the reachable-address
    slice (monotone address ⇒ exactly ``rom[addr(lo)..addr(hi)]``); lanes
    whose interval pokes outside the ROM domain ``[-2^(W-2), 2^(W-2))``
    read the clamped end entries — sound, but flagged ``af-domain`` because
    the saturation silently flattens the activation."""
    if fn == "identity":
        return x
    xl, xh = _lanes(x.lo), _lanes(x.hi)
    if fn == "relu":
        return _bd(np.maximum(xl, 0), np.maximum(xh, 0))
    if rom is None:
        raise ValueError(f"af '{fn}' needs its ROM words")
    hull_lo, hull_hi = _rom_hulls(_lanes(rom))
    a_lo, a_hi = _af_addr_lanes(xl, width), _af_addr_lanes(xh, width)
    half = 1 << (width - 2)
    outside = np.flatnonzero((xl < -half) | (xh >= half))
    if outside.size:
        flag("af-domain", outside.tolist(),
             f"{outside.size}/{x.lanes} lane(s) can leave the {fn} ROM "
             f"domain [-2^{width - 2}, 2^{width - 2}) — clamped to the end "
             "entries")
    return _bd(hull_lo[a_lo, a_hi], hull_hi[a_lo, a_hi])


def af_domain_lanes(x: Bd, width: int,
                    entire: bool = False) -> list[int]:
    """Lanes whose interval leaves the AF ROM domain; with ``entire=True``
    only lanes whose WHOLE interval is outside (the always-saturating case
    ``ir.Stage.validate`` rejects)."""
    half = 1 << (width - 2)
    xl, xh = _lanes(x.lo), _lanes(x.hi)
    if entire:
        return np.flatnonzero((xh < -half) | (xl >= half)).tolist()
    return np.flatnonzero((xl < -half) | (xh >= half)).tolist()


def mul_bd(a: Bd, b: Bd, width: int, flag: FlagFn = _no_flag) -> Bd:
    """Gate-algebra ``mul``: 4-corner product interval on the 2W lane
    product (``mul-wrap``), then the same Q-align select as the MACC.
    (Corner products of two 32-bit words fit int64.)"""
    al, ah, bl, bh = _lanes(a.lo), _lanes(a.hi), _lanes(b.lo), _lanes(b.hi)
    c = np.stack([al * bl, al * bh, ah * bl, ah * bh])
    lo2, hi2 = _range_check(c.min(axis=0), c.max(axis=0), 2 * width, "mul-wrap", flag)
    return _bd(*_qalign(lo2, hi2, width, flag))


def addsub_raw(op: str, a: Bd, b: Bd) -> tuple[np.ndarray, np.ndarray]:
    """Pre-wrap-check add/sub bounds (the lerp refinement needs them)."""
    al, ah, bl, bh = _lanes(a.lo), _lanes(a.hi), _lanes(b.lo), _lanes(b.hi)
    if op == "add":
        return al + bl, ah + bh
    return al - bh, ah - bl


def checked(lo: np.ndarray, hi: np.ndarray, width: int, kind: str,
            flag: FlagFn = _no_flag) -> Bd:
    """Raw bounds → ``Bd`` after the W-bit wrap check (``kind``)."""
    return _bd(*_range_check(lo, hi, width, kind, flag))


def addsub_bd(op: str, a: Bd, b: Bd, width: int,
              flag: FlagFn = _no_flag) -> Bd:
    """Gate-algebra ``add``/``sub`` at W bits (``add-wrap``/``sub-wrap``)."""
    return checked(*addsub_raw(op, a, b), width, f"{op}-wrap", flag)


def lerp_lanes(a: Bd, x: Bd, z: Bd, width: int) -> list[int]:
    """Lanes where ``add(a, mul(z, sub(x, a)))`` provably stays in
    ``hull(a, x)`` — the GRU write-back ``h' = n + z·(h − n)``.

    Per lane, with ``t = z/scale ∈ [0, 1]`` and ``d = x − a`` unwrapped,
    the result is ``a + floor(t·d)``; for integer ``d`` that floor lies in
    ``[min(0, d), max(0, d)]``, so the sum lies in ``hull(a, x)`` exactly —
    naive interval arithmetic loses the ``x``/``a`` correlation and
    diverges on every GRU.  Conditions per lane: ``0 ≤ z ≤ scale`` and the
    ``sub`` cannot wrap.
    """
    scale = 1 << (width - 4)
    ok = ((_lanes(z.lo) >= 0) & (_lanes(z.hi) <= scale)
          & (_lanes(x.lo) - _lanes(a.hi) >= word_min(width))
          & (_lanes(x.hi) - _lanes(a.lo) <= word_max(width)))
    return np.flatnonzero(ok).tolist()


__all__ = [
    "Bd",
    "FlagFn",
    "MaccRom",
    "addsub_bd",
    "addsub_raw",
    "af_addr_int",
    "af_bd",
    "af_domain_lanes",
    "checked",
    "lerp_lanes",
    "macc_bd",
    "mul_bd",
    "word_max",
    "word_min",
]
