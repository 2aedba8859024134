"""Predicted-vs-measured ledger — the Fig. 10 loop's instrumentation; the
port's copy of ``repro/obs/ledger.py``, with the same row schema.

The paper's design flow is an optimization loop: synthesize, *measure*
cycles/resources, re-tune.  The repo produces the predictions already —
rtlsim's FSM cycle model (``fsm_cycle_estimate``) and the program's MACC
flops and peak bytes — and this ledger joins them, per synthesized
program, against wall-clock measured through the same span layer, so the
design-space tuner (:mod:`repro_torch.tune`) can rank candidates by
*predicted* cost and validate the ranking against *measured* runtime
without re-running a whole benchmark suite.

Keys are free-form program ids (``synthesize()`` uses
``"<spec.name>|<backend>|u<unroll>|c<c_slow>[|q<bits>][|b<batch>]"`` plus
``[|db0][|ch<chunk>][|bb<block_b>]`` for non-default kernel launch knobs).
``predict()`` and ``measure()`` may arrive in any order and accumulate;
``report()`` emits the join with derived columns:

* ``implied_clock_mhz`` — the FPGA clock at which the predicted FSM cycle
  count would equal the measured wall time: ``fsm_cycles / wall_us`` — the
  direct paper-hardware ↔ device-runtime exchange rate;
* ``measured_gflops`` — predicted flops over measured wall time.
"""

from __future__ import annotations

import json
import threading


class Ledger:
    def __init__(self):
        self._lock = threading.Lock()
        # key -> {"predicted": {...}, "measured": {...}}
        self._rows: dict[str, dict] = {}

    def _row(self, key: str, shard: int | None = None) -> dict:
        row = self._rows.get(key)
        if row is None:
            row = self._rows[key] = {
                "predicted": {},
                "measured": {"calls": 0, "wall_s_total": 0.0,
                             "wall_s_best": None},
            }
        if shard is not None:
            row["shard"] = int(shard)
        return row

    def predict(self, key: str, shard: int | None = None, **vals) -> None:
        """Attach predicted quantities (``fsm_cycles``, ``flops``,
        ``peak_bytes``, ...); None values are dropped.  ``shard`` tags the
        row with the data shard it belongs to (mesh-aware serving rows)."""
        with self._lock:
            self._row(key, shard)["predicted"].update(
                {k: v for k, v in vals.items() if v is not None})

    def measure(self, key: str, wall_s: float, shard: int | None = None,
                **vals) -> None:
        """Record one measured execution (best-of is the reported number —
        same convention as the benchmark harness's median-of-iters).
        ``shard`` tags the row with its data shard, exported as the
        ``shard`` column ``repro.obs.check`` validates."""
        with self._lock:
            m = self._row(key, shard)["measured"]
            m["calls"] += 1
            m["wall_s_total"] += wall_s
            if m["wall_s_best"] is None or wall_s < m["wall_s_best"]:
                m["wall_s_best"] = wall_s
            m.update({k: v for k, v in vals.items() if v is not None})

    def timed(self, key: str) -> bool:
        """Has ``key`` at least one measured execution?"""
        with self._lock:
            row = self._rows.get(key)
            return row is not None and row["measured"]["wall_s_best"] is not None

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    def reset(self) -> None:
        with self._lock:
            self._rows.clear()

    def report(self, match: str | None = None) -> list[dict]:
        """Joined rows, one per program, with derived columns.  ``match``
        filters to keys containing the substring (program-key filter for
        the tuner's measure pass and the report CLI)."""
        out = []
        with self._lock:
            items = sorted(self._rows.items())
        if match is not None:
            items = [(k, v) for k, v in items if match in k]
        for key, row in items:
            p, m = row["predicted"], row["measured"]
            rec = {"program": key,
                   "fsm_cycles": p.get("fsm_cycles"),
                   "flops": p.get("flops"),
                   "peak_bytes": p.get("peak_bytes"),
                   "predicted": dict(p),
                   "measured_wall_us": (None if m["wall_s_best"] is None
                                        else m["wall_s_best"] * 1e6),
                   "measured_calls": m["calls"]}
            if "shard" in row:
                rec["shard"] = row["shard"]
            extra = {k: v for k, v in m.items()
                     if k not in ("calls", "wall_s_total", "wall_s_best")}
            if extra:
                rec["measured"] = extra
            wall = m["wall_s_best"]
            if wall and p.get("fsm_cycles"):
                rec["implied_clock_mhz"] = p["fsm_cycles"] / (wall * 1e6)
            if wall and p.get("flops"):
                rec["measured_gflops"] = p["flops"] / wall / 1e9
            out.append(rec)
        return out

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.report(), indent=indent)

    def format_table(self, match: str | None = None) -> str:
        """Human-readable predicted-vs-measured table (README format)."""
        rows = self.report(match)
        if not rows:
            return "(ledger empty — nothing synthesized/measured yet)"
        hdr = f"{'program':<44} {'fsm_cycles':>10} {'flops':>12} " \
              f"{'wall_us':>10} {'clk_MHz':>8}"
        lines = [hdr, "-" * len(hdr)]
        for r in rows:
            fc = r["fsm_cycles"]
            fl = r["flops"]
            wu = r["measured_wall_us"]
            ck = r.get("implied_clock_mhz")
            lines.append(
                f"{r['program']:<44} "
                f"{fc if fc is not None else 'n/a':>10} "
                f"{f'{fl:.3e}' if fl is not None else 'n/a':>12} "
                f"{f'{wu:.1f}' if wu is not None else 'n/a':>10} "
                f"{f'{ck:.2f}' if ck is not None else 'n/a':>8}")
        return "\n".join(lines)


__all__ = ["Ledger"]
