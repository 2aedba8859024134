"""Leveled structured logger for the library's human-facing output.

A copy of the JAX package's ``obs/log.py``: one chokepoint for the
library's printed output that respects ``REPRO_LOG``:

    REPRO_LOG=quiet   nothing (CI log hygiene, library embedding)
    REPRO_LOG=info    default — byte-identical to the old prints
    REPRO_LOG=debug   info plus ``debug()`` lines (prefixed ``[debug]``)

Structured fields are appended as ``key=value`` pairs only when given, so
benchmark/example output is unchanged by default.  The level is read from
the environment at call time (cheap; lets tests and drivers flip it without
re-imports).
"""

from __future__ import annotations

import os
import sys

_LEVELS = {"quiet": 0, "info": 1, "debug": 2}


def level() -> int:
    return _LEVELS.get(os.environ.get("REPRO_LOG", "info").lower(), 1)


def _render(msg: str, fields: dict) -> str:
    if fields:
        tail = " ".join(f"{k}={v}" for k, v in fields.items())
        return f"{msg} {tail}" if msg else tail
    return msg


def info(msg: str = "", **fields) -> None:
    if level() >= 1:
        print(_render(msg, fields), flush=True)


def debug(msg: str = "", **fields) -> None:
    if level() >= 2:
        print(_render(f"[debug] {msg}", fields), flush=True)


def warning(msg: str = "", **fields) -> None:
    """Warnings go to stderr and survive everything but ``quiet``."""
    if level() >= 1:
        print(_render(f"[warn] {msg}", fields), file=sys.stderr, flush=True)


def fmt_or_na(value, fmt: str = "{:.3e}") -> str:
    """Format a numeric value, or 'n/a' for None/non-numeric — so absent
    ``cost_analysis`` fields (flops=None) render instead of raising inside
    an f-string format spec."""
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return "n/a"
    return fmt.format(value)


__all__ = ["debug", "fmt_or_na", "info", "level", "warning"]
