"""Pareto-front math for the tuner's objective × resource trade-off; a copy
of ``repro/tune/pareto.py``.

Pure functions over point lists (minimization in every coordinate), kept
free of tuner types so the math is unit-testable on synthetic points.
"""

from __future__ import annotations

from typing import Sequence


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """True when ``a`` is at least as good as ``b`` in every coordinate and
    strictly better in one (minimization)."""
    if len(a) != len(b):
        raise ValueError(f"dimension mismatch: {len(a)} vs {len(b)}")
    return all(x <= y for x, y in zip(a, b)) and any(
        x < y for x, y in zip(a, b))


def pareto_front(points: Sequence[Sequence[float]]) -> list[int]:
    """Indices of the non-dominated points, in input order.

    Duplicates of a frontier point are all kept (none dominates the other),
    so a caller that wants one representative dedups upstream.  O(n²) — the
    tuner's measured set is tens of points, never more.
    """
    out = []
    for i, p in enumerate(points):
        if not any(dominates(q, p) for j, q in enumerate(points) if j != i):
            out.append(i)
    return out


__all__ = ["dominates", "pareto_front"]
