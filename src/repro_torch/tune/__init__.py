"""Design-space auto-tuner — the paper's Fig. 10 optimization loop; the
port's counterpart of ``repro/tune``.

The paper's promise is a *systematic* design flow: sweep the synthesis
knobs (unroll ``j``, C-slow factor, fixed-point word width), measure, pick
the implementation that meets the latency / throughput / resource target.
This package closes that loop over the port's backends on the card:

    enumerate (codegen.knobs validity)            tune/space.py
      → predict (rtlsim cycles + IR resources     tune/search.py
                 + static analysis, no build)
      → measure top-k (synthesize memo cache,
                 wall-clock into the obs ledger)
      → validate winner (verify.difftest: float
                 parity ≤1e-5 + rtlsim bit-exact)
      → Pareto report (repro.tune/v1 JSON +       tune/pareto.py,
                 obs-style table)                 tune/report.py

Entry points::

    from repro_torch.core.synthesis import synthesize
    result = synthesize(spec, optimize="latency", budget=8)

    python -m repro_torch.tune --cell lstm --optimize throughput
"""

from __future__ import annotations

from .pareto import dominates, pareto_front
from .report import TUNE_SCHEMA, format_table, result_doc, write_doc
from .search import (
    DEFAULT_BUDGET,
    OBJECTIVES,
    Scored,
    TuneResult,
    measure_candidate,
    predict_candidate,
    predict_rank,
    resource_score,
    static_profile,
    tune,
)
from .space import REFERENCE_BACKEND, Candidate, baseline_candidate, enumerate_space

__all__ = [
    "Candidate",
    "DEFAULT_BUDGET",
    "OBJECTIVES",
    "REFERENCE_BACKEND",
    "Scored",
    "TUNE_SCHEMA",
    "TuneResult",
    "baseline_candidate",
    "dominates",
    "enumerate_space",
    "format_table",
    "measure_candidate",
    "pareto_front",
    "predict_candidate",
    "predict_rank",
    "resource_score",
    "result_doc",
    "static_profile",
    "tune",
    "write_doc",
]
