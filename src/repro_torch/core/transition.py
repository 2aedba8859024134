"""j-step state-transition accounting (paper §II-C, Fig. 3); the port keeps
only :func:`serial_depth_estimate` of ``repro/core/transition.py`` so far.

The composition operators and the chunked linear recurrences of the
reference module come with the SSM family (ROADMAP, Queue 1).
"""

from __future__ import annotations

import math


def serial_depth_estimate(T: int, j: int) -> int:
    """Dependency-chain length of the j-step form: T/j serial applications
    (+ log2(j) tree depth inside each Φ composition, which pipelines)."""
    return T // j + max(0, math.ceil(math.log2(max(j, 1))))


__all__ = ["serial_depth_estimate"]
