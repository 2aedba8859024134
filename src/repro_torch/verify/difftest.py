"""Seeded cross-backend differential fuzz harness; the port's counterpart of
``repro/verify/difftest.py`` (the same seeds give the same specs and
inputs).

For each seed, generate a random :class:`~repro_torch.core.synthesis.NetworkSpec`
(cell × shape × seq_len × quant_bits × c_slow × unroll × batch) and a random
input, then check the executable contract on ``--device`` (default: the
card):

* **float paths** — ``ref`` (the unlowered ``create_top_module``; for the
  ssm, which it does not build, a plain float32 recurrence over the
  program's weights), the eager backend, and the generated CUDA stage kernel
  (its plain version, the plan interpreter, on the CPU) — agree to
  ``FLOAT_ATOL`` (1e-5, fp32);
* **bit path** — the bit-accurate RTL simulator
  (:mod:`repro_torch.codegen.rtlsim`) is bit-exact, word for word, against
  the independent fixed-point golden model (:mod:`repro_torch.verify.golden`)
  at the spec's word width.

Any divergence is a parity bug; it gets fixed, or the seed is committed to
:data:`XFAILS` with a note so the regression is pinned.

CLI::

    python -m repro_torch.verify.difftest --seeds 50           # seeds 0..49
    python -m repro_torch.verify.difftest --seeds 5 --start 100 -v
    python -m repro_torch.verify.difftest --regen-goldens OUT_DIR
        # the golden specs' RTL, written only under OUT_DIR
    python -m repro_torch.verify.difftest --seeds 50 --trace-ranges
        # analyzer soundness: rtlsim-observed per-wire min/max must lie
        # inside the repro_torch.analyze proven interval on every seed
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import time
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs import log

FLOAT_ATOL = 1e-5
FLOAT_RTOL = 1e-5

# seed -> reason.  Divergences found by the fuzzer that are documented
# rather than fixed land here; difftest reports them as xfail (and flags
# them loudly if they start passing).
XFAILS: dict[int, str] = {}


def golden_specs():
    """Compact specs, one per cell (the reference's golden-file specs)."""
    from repro_torch.core.synthesis import NetworkSpec

    return {
        "mlp_case_study_q16": NetworkSpec(3, 4, 4, 2, quant_bits=16),
        "lstm_h4_q16": NetworkSpec(2, 1, 4, 2, cell="lstm", seq_len=6,
                                   quant_bits=16),
        "gru_h4_q16": NetworkSpec(2, 1, 4, 2, cell="gru", seq_len=6,
                                  quant_bits=16),
        "ssm_h4_q16": NetworkSpec(2, 1, 4, 2, cell="ssm", seq_len=6,
                                  quant_bits=16),
    }


# ---------------------------------------------------------------------------
# Spec generation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Case:
    seed: int
    spec: Any               # NetworkSpec (duck-typed: no import cycle)
    batch: int

    def describe(self) -> str:
        s = self.spec
        return (f"seed={self.seed} {s.cell} in={s.num_inputs} "
                f"layers={s.num_hidden_layers}x{s.nodes_per_layer} "
                f"out={s.num_outputs} T={s.seq_len} act={s.activation} "
                f"q={s.quant_bits} c={s.c_slow} j={s.unroll} B={self.batch}")


def gen_case(seed: int) -> Case:
    """Deterministic spec from a seed — odd sizes (primes) on purpose, to
    stress ragged tiles alongside the round shapes."""
    from repro_torch.core.synthesis import NetworkSpec

    rng = np.random.default_rng(seed)
    cell = str(rng.choice(["mlp", "lstm", "gru", "ssm"]))
    nodes = int(rng.choice([2, 3, 4, 5, 7, 8]))
    spec = NetworkSpec(
        num_inputs=int(rng.integers(1, 6)),
        num_hidden_layers=int(rng.integers(1, 4)),
        nodes_per_layer=nodes,
        num_outputs=int(rng.integers(1, 4)),
        activation=str(rng.choice(["tanh", "sigmoid", "relu"]))
        if cell == "mlp" else "tanh",
        cell=cell,
        seq_len=0 if cell == "mlp" else int(rng.choice(
            [1, 2, 5, 7, 12, 33, 40],
            p=[0.18, 0.18, 0.18, 0.18, 0.18, 0.05, 0.05])),
        unroll=int(rng.choice([1, 1, 2, 4])),
        c_slow=int(rng.choice([1, 1, 1, 2, 3])),
        quant_bits=(None if rng.random() < 0.4
                    else int(rng.choice([8, 10, 12, 14, 16, 18, 20]))),
        seed=int(rng.integers(0, 2 ** 31)),
    )
    batch = int(rng.choice([1, 2, 3, 4, 9], p=[0.24, 0.24, 0.24, 0.18, 0.1]))
    return Case(seed=seed, spec=spec, batch=batch)


def case_input(case: Case) -> np.ndarray:
    s = case.spec
    rng = np.random.default_rng(case.seed + 1)
    shape = (case.batch, s.num_inputs) if s.cell == "mlp" \
        else (case.batch, s.seq_len, s.num_inputs)
    if s.c_slow > 1:
        shape = (s.c_slow,) + shape
    return rng.uniform(-1.0, 1.0, size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# The float paths
# ---------------------------------------------------------------------------

def ref_forward(spec, u: torch.Tensor, device) -> torch.Tensor:
    """The unlowered path: ``create_top_module`` for mlp/lstm/gru; a plain
    float32 recurrence over the program's weights for the ssm (which the
    Table-I constructors never built)."""
    if spec.cell == "ssm":
        from repro_torch.codegen import build_program

        prog = build_program(spec, device)
        x = u.reshape((-1,) + tuple(u.shape[(2 if spec.c_slow > 1 else 1):]))
        for st in prog.stages:
            p = st.params
            h = torch.zeros((x.shape[0], p["a"].shape[-1]), dtype=torch.float32,
                            device=x.device)
            ys = []
            for t in range(x.shape[1]):
                h = p["a"][0] * h + (x[:, t] @ p["w_in"] + p["b"][0])
                ys.append(h)
            x = torch.stack(ys, dim=1)
        y = h @ prog.C.T
        if spec.c_slow > 1:
            y = y.reshape((spec.c_slow, -1) + tuple(y.shape[1:]))
        return y
    from repro_torch.core.synthesis import create_top_module

    params, fwd = create_top_module(spec, device)
    return fwd(params, u)


def float_legs(spec, u: torch.Tensor, device) -> dict[str, torch.Tensor]:
    """``ref``, ``eager`` and ``kernel`` outputs for ``u`` on ``device``."""
    from repro_torch.codegen import compile_spec

    ys = {"ref": ref_forward(spec, u, device)}
    for backend in ("eager", "kernel"):
        params, fwd = compile_spec(spec, backend, device=device)
        ys[backend] = fwd(params, u)
    return ys


# ---------------------------------------------------------------------------
# One case end-to-end
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CaseResult:
    case: Case
    ok: bool
    float_err: float        # max |eager - kernel|, |eager - ref|
    bit_exact: bool
    max_code_delta: int     # 0 when bit-exact
    error: str | None = None
    elapsed_s: float = 0.0

    def line(self) -> str:
        status = "ok" if self.ok else "FAIL"
        msg = f" [{self.error}]" if self.error else ""
        return (f"[{status}] {self.case.describe()} "
                f"float_err={self.float_err:.2e} "
                f"bit={'exact' if self.bit_exact else self.max_code_delta}"
                f" ({self.elapsed_s:.1f}s){msg}")


def run_case(case: Case, device=None) -> CaseResult:
    from repro_torch.codegen import build_program, rtlsim
    from repro_torch.verify import golden

    dev = resolve_device(device)
    t0 = time.perf_counter()
    spec, u_np = case.spec, case_input(case)
    u = torch.as_tensor(u_np, device=dev)
    err_msgs = []

    with torch.no_grad():
        ys = float_legs(spec, u, dev)
    y_e = ys["eager"]
    errs = {k: float((ys[k] - y_e).abs().max()) if y_e.numel() else 0.0
            for k in ("kernel", "ref")}
    float_err = max(errs.values())
    for k in ("kernel", "ref"):
        if not torch.allclose(ys[k], y_e, atol=FLOAT_ATOL, rtol=FLOAT_RTOL):
            err_msgs.append(f"{k}≠eager ({errs[k]:.2e})")

    # bit path: rtlsim vs the independent fixed-point golden model
    width = spec.quant_bits or rtlsim.DEFAULT_WIDTH
    prog = build_program(spec, dev)
    sim = rtlsim.simulate(prog, u_np, width=width, device=dev)
    ref_codes = golden.fixed_forward(prog, u_np, width=width, device=dev)
    bit_exact = bool(torch.equal(sim.y_codes, ref_codes))
    max_delta = 0 if bit_exact else int((sim.y_codes - ref_codes).abs().max())
    if not bit_exact:
        err_msgs.append(f"rtlsim≠golden (max Δcode {max_delta})")

    return CaseResult(
        case=case,
        ok=not err_msgs,
        float_err=float_err,
        bit_exact=bit_exact,
        max_code_delta=max_delta,
        error="; ".join(err_msgs) or None,
        elapsed_s=time.perf_counter() - t0,
    )


@dataclasses.dataclass
class RangeCaseResult:
    """``--trace-ranges``: analyzer-vs-rtlsim containment for one case."""

    case: Case
    ok: bool
    wires: int              # wires with both a proven bound and observations
    violations: list[str]   # observed values outside the proven interval
    flagged_errors: int     # error-grade analyzer findings (should be 0)
    error: str | None = None
    elapsed_s: float = 0.0

    def line(self) -> str:
        status = "ok" if self.ok else "FAIL"
        msg = f" [{self.error}]" if self.error else ""
        viol = f" violations={self.violations[:2]}" if self.violations else ""
        return (f"[{status}] {self.case.describe()} wires={self.wires} "
                f"flagged={self.flagged_errors}{viol} "
                f"({self.elapsed_s:.1f}s){msg}")


def trace_ranges_case(case: Case, device=None) -> RangeCaseResult:
    """Soundness ground truth: every per-wire min/max rtlsim observes must
    lie inside the analyzer's proven interval, and no standard-width case
    may draw an error-grade overflow finding (false positive).  Purely
    build_program + analyze + rtlsim — no backend build.
    """
    from repro_torch.analyze import analyze_program
    from repro_torch.codegen import build_program, rtlsim

    dev = resolve_device(device)
    t0 = time.perf_counter()
    spec, u = case.spec, case_input(case)
    width = spec.quant_bits or rtlsim.DEFAULT_WIDTH
    prog = build_program(spec, dev)
    res = analyze_program(prog, width=width)
    sim = rtlsim.simulate(prog, u, width=width, collect_ranges=True, device=dev)

    violations: list[str] = []
    wires = 0
    for key, (lo, hi) in sorted(sim.wire_ranges.items()):
        bd = res.wires.get(key)
        if bd is None:
            violations.append(f"{key}: observed but no proven bound")
            continue
        wires += 1
        if not bd.contains_values(lo, hi):
            violations.append(
                f"{key}: observed [{int(np.min(lo))}, {int(np.max(hi))}] "
                f"escapes proven [{min(bd.lo)}, {max(bd.hi)}]")
    flagged = sum(1 for f in res.findings if f.severity == "error")
    err_msgs = []
    if violations:
        err_msgs.append(f"{len(violations)} containment violation(s)")
    if flagged:
        err_msgs.append(f"{flagged} error-grade finding(s) at shipped width")
    return RangeCaseResult(
        case=case,
        ok=not err_msgs,
        wires=wires,
        violations=violations,
        flagged_errors=flagged,
        error="; ".join(err_msgs) or None,
        elapsed_s=time.perf_counter() - t0,
    )


def run_trace_ranges(seeds, verbose: bool = False, device=None):
    """``--trace-ranges`` over a seed batch; crash = failure, as ever."""
    results, failures = [], []
    for seed in seeds:
        case = gen_case(seed)
        try:
            res = trace_ranges_case(case, device)
        except Exception as exc:  # noqa: BLE001 — a crash is a finding too
            res = RangeCaseResult(case=case, ok=False, wires=0,
                                  violations=[], flagged_errors=0,
                                  error=f"{type(exc).__name__}: {exc}")
        if verbose or not res.ok:
            log.info(res.line())
        if not res.ok and seed not in XFAILS:
            failures.append(res)
        results.append(res)
    return results, failures


def validate_candidate(spec, batch: int = 2, seed: int = 0,
                       device=None) -> CaseResult:
    """Single-candidate parity gate: the full differential contract on ONE
    spec — ref / eager / kernel float parity ≤ ``FLOAT_ATOL`` and rtlsim
    bit-exactness against the fixed-point golden model at the spec's word
    width.  A crash counts as a failure (``ok=False`` with the exception
    recorded), never an escape."""
    case = Case(seed=seed, spec=spec, batch=batch)
    try:
        return run_case(case, device)
    except Exception as exc:  # noqa: BLE001 — record, never escape
        return CaseResult(case=case, ok=False, float_err=float("nan"),
                          bit_exact=False, max_code_delta=-1,
                          error=f"{type(exc).__name__}: {exc}")


def run_seeds(seeds, verbose: bool = False, device=None):
    """Run a batch of seeds; returns (results, failures-excluding-xfails)."""
    results, failures = [], []
    for seed in seeds:
        case = gen_case(seed)
        try:
            res = run_case(case, device)
        except Exception as exc:  # noqa: BLE001 — a crash is a finding too
            res = CaseResult(case=case, ok=False, float_err=float("nan"),
                             bit_exact=False, max_code_delta=-1,
                             error=f"{type(exc).__name__}: {exc}")
        if verbose or not res.ok:
            log.info(res.line())
        if not res.ok and seed not in XFAILS:
            failures.append(res)
        if res.ok and seed in XFAILS:
            log.info(f"[xpass] seed={seed} documented as xfail "
                     f"({XFAILS[seed]}) but passes — remove it")
        results.append(res)
    return results, failures


# ---------------------------------------------------------------------------
# Golden regeneration + CLI
# ---------------------------------------------------------------------------

def regen_goldens(out_dir: pathlib.Path, device=None) -> list[pathlib.Path]:
    """Write the golden specs' RTL under ``out_dir`` (and nowhere else),
    cross-checking each program rtlsim-vs-golden-model first so a broken
    emitter can't be frozen into a golden."""
    from repro_torch.codegen import build_program, emit_program, rtlsim
    from repro_torch.verify import golden

    dev = resolve_device(device)
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for name, spec in golden_specs().items():
        prog = build_program(spec, dev)
        u = case_input(Case(seed=0, spec=spec, batch=2))
        sim = rtlsim.simulate(prog, u, device=dev)
        ref = golden.fixed_forward(prog, u, device=dev)
        if not torch.equal(sim.y_codes, ref):
            raise AssertionError(
                f"refusing to write golden '{name}': rtlsim disagrees with "
                "the fixed-point golden model")
        path = out_dir / f"{name}.v"
        path.write_text(emit_program(prog))
        written.append(path)
        log.info(f"wrote {path}")
    return written


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.verify.difftest", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", type=int, default=20,
                    help="number of seeds to fuzz (default 20)")
    ap.add_argument("--start", type=int, default=0,
                    help="first seed (default 0)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print every case, not just failures")
    ap.add_argument("--regen-goldens", metavar="OUT_DIR", default=None,
                    help="write the golden specs' RTL into OUT_DIR")
    ap.add_argument("--trace-ranges", action="store_true",
                    help="analyzer soundness mode: check rtlsim-observed "
                    "per-wire min/max against repro_torch.analyze proven "
                    "bounds (no backend build)")
    ap.add_argument("--device", default=None,
                    help="where the cases run (default: the card; 'cpu' "
                    "runs the plain versions on the host)")
    args = ap.parse_args(argv)
    resolve_device(args.device)     # a missing card raises here, not once a case

    if args.regen_goldens is not None:
        regen_goldens(pathlib.Path(args.regen_goldens), args.device)
        return 0

    t0 = time.perf_counter()
    seeds = range(args.start, args.start + args.seeds)
    if args.trace_ranges:
        results, failures = run_trace_ranges(seeds, args.verbose, args.device)
        n_wires = sum(r.wires for r in results)
        log.info(f"difftest --trace-ranges: "
                 f"{sum(r.ok for r in results)}/{len(results)} ok, "
                 f"{len(failures)} failures, {n_wires} wire bounds checked "
                 f"({time.perf_counter() - t0:.1f}s)")
        return 1 if failures else 0
    results, failures = run_seeds(seeds, args.verbose, args.device)
    n_xfail = sum(1 for r in results if not r.ok and r.case.seed in XFAILS)
    log.info(f"difftest: {sum(r.ok for r in results)}/{len(results)} ok, "
             f"{len(failures)} failures, {n_xfail} xfail "
             f"({time.perf_counter() - t0:.1f}s)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
