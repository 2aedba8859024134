"""Design-space enumeration over the synthesis knobs (paper Fig. 10); the
port's counterpart of ``repro/tune/space.py``, with the port's backend
names (``eager`` where the reference says ``xla``, ``kernel`` where it says
``pallas``).

A :class:`Candidate` is one point of the space: the base spec with
``unroll`` / ``c_slow`` / ``quant_bits`` overridden, plus the backend.
:func:`enumerate_space` expands the cross product, drops combinations the
:mod:`repro_torch.codegen.knobs` rules mark invalid for *some* of the
requested backends, and raises at once when a knob value is invalid for
*every* requested backend — a typo'd grid fails at enumeration, not
minutes into the measure pass.

The reference also enumerates its TPU tiling knobs (``double_buffer`` /
``chunk`` / ``block_b``) and folds them away on the backends where they do
nothing.  On the card they do nothing on every backend (the generated
kernel ignores them, and ``synthesis._cache_key`` leaves them out), so
they are not axes here: the reference's ``…|pallas|u1|c1|db0`` and
``…|pallas|u1|c1`` are the port's one ``…|kernel|u1|c1``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Sequence

from repro_torch.codegen import knobs

#: the reference's name for each of the port's backends.  Rankings break
#: ties on the key under these names, so one grid ranks, and an odd budget
#: measures, the same candidates in the same order as the reference's.
REFERENCE_BACKEND = {"eager": "xla", "kernel": "pallas", "verilog": "verilog"}


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One knob assignment.  ``spec`` already carries the spec-level knobs
    (unroll / c_slow / quant_bits baked into the frozen dataclass)."""

    spec: Any               # NetworkSpec (duck-typed: no import cycle)
    backend: str

    @property
    def key(self) -> str:
        """The predicted-vs-measured ledger key this candidate lands on
        (batch-less form; the search adds the batch at measure time)."""
        from repro_torch.core.synthesis import _ledger_key

        return _ledger_key(self.spec, None, self.backend)

    @property
    def order_key(self) -> str:
        """:attr:`key` under the reference's backend names: the tie-break
        of every ranking."""
        return self.key.replace(f"|{self.backend}|",
                                f"|{REFERENCE_BACKEND[self.backend]}|", 1)

    def knobs_dict(self) -> dict:
        return {"backend": self.backend,
                "unroll": self.spec.unroll,
                "c_slow": self.spec.c_slow,
                "quant_bits": self.spec.quant_bits}

    def synth_kwargs(self) -> dict:
        """kwargs that reproduce this candidate through ``synthesize()``."""
        return {"backend": self.backend}


def baseline_candidate(spec, backend: str = "eager") -> Candidate:
    """The default-synthesis reference point every tune run must beat:
    ``unroll=1, c_slow=1``, no quantization."""
    base = dataclasses.replace(spec, unroll=1, c_slow=1, quant_bits=None)
    return Candidate(spec=base, backend=backend)


def enumerate_space(spec, *,
                    backends: Sequence[str] = ("eager", "kernel"),
                    unroll: Sequence[int] = knobs.DEFAULT_UNROLL,
                    c_slow: Sequence[int] = knobs.DEFAULT_C_SLOW,
                    quant_bits: Sequence[int | None] = knobs.DEFAULT_QUANT_BITS,
                    ) -> list[Candidate]:
    """Cross product of the knob grids, validity-filtered.

    A knob *value* that :func:`repro_torch.codegen.knobs.knob_reason` rejects
    for every requested backend raises ``ValueError`` with the per-backend
    reasons — partial validity (e.g. ``quant_bits=8`` valid on kernel,
    invalid on eager for a recurrent cell) just prunes those pairs.
    """
    from repro_torch.codegen import BACKENDS

    for b in backends:
        if b not in BACKENDS:
            raise ValueError(f"unknown backend '{b}'; available: {BACKENDS}")
    if not backends:
        raise ValueError("enumerate_space: at least one backend required")

    # fail fast on knob values invalid everywhere
    for name, values in (("unroll", unroll), ("c_slow", c_slow),
                         ("quant_bits", quant_bits)):
        for v in values:
            reasons = {b: knobs.knob_reason(b, spec.cell, **{name: v})
                       for b in backends}
            if all(r is not None for r in reasons.values()):
                detail = "; ".join(f"{b}: {r}" for b, r in reasons.items())
                raise ValueError(
                    f"{name}={v!r} is invalid for every requested backend "
                    f"({detail})")

    out: list[Candidate] = []
    for b, u, c, q in itertools.product(backends, unroll, c_slow, quant_bits):
        if knobs.knob_reason(b, spec.cell, unroll=u, c_slow=c,
                             quant_bits=q) is not None:
            continue
        out.append(Candidate(
            spec=dataclasses.replace(spec, unroll=u, c_slow=c, quant_bits=q),
            backend=b))
    return out


__all__ = ["Candidate", "REFERENCE_BACKEND", "baseline_candidate",
           "enumerate_space"]
