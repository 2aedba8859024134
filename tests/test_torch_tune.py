"""The port's Fig. 10 auto-tuner (``repro_torch.tune``) on the CPU against
the JAX reference's (``repro.tune``).

The port names its backends ``eager`` and ``kernel`` where the reference
says ``xla`` and ``pallas``; every comparison maps the names.  The port
has no axes for the reference's TPU tiling knobs (``double_buffer``/
``chunk``/``block_b``), which build the same kernel on the card, so a
reference candidate tagged ``|db0`` folds into the same port candidate as
its untagged twin.

Held here: the knob grids and validity rules; the folding, case by case; on
programs bridged from the reference (``bridge.program_from_jax``), the
predict phase's numbers (``static_snr_db`` within 1e-9, the rest equal) and
the ranking at an odd and an even budget; with the same stub timer and
validator on both sides, the winner, the measured order, the Pareto front
and the parity rejects; the ``repro.tune/v1`` document against the port's
``check_tune_doc``; and one real CPU run of ``synthesize(optimize=)``.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import codegen as jcg  # noqa: E402
from repro.codegen import knobs as jknobs  # noqa: E402
from repro.configs import paper_mlp as j_paper  # noqa: E402
from repro.core.synthesis import NetworkSpec as JSpec  # noqa: E402
from repro.tune import search as jsearch  # noqa: E402
from repro.tune import tune as jtune  # noqa: E402
from repro.verify.difftest import CaseResult as JCaseResult  # noqa: E402
from repro_torch import obs as obs_lib  # noqa: E402
from repro_torch.bridge import program_from_jax  # noqa: E402
from repro_torch.codegen import knobs  # noqa: E402
from repro_torch.core import synthesis  # noqa: E402
from repro_torch.core.synthesis import NetworkSpec, _cache_key, _ledger_key  # noqa: E402
from repro_torch.obs.check import check_tune_doc  # noqa: E402
from repro_torch.tune import (  # noqa: E402
    REFERENCE_BACKEND,
    Candidate,
    TuneResult,
    baseline_candidate,
    dominates,
    enumerate_space,
    measure_candidate,
    pareto_front,
    predict_rank,
    result_doc,
    search,
    tune,
)
from repro_torch.tune.__main__ import main as tune_main  # noqa: E402
from repro_torch.verify.difftest import CaseResult, validate_candidate  # noqa: E402

MLP = NetworkSpec(3, 2, 4, 2)
LSTM = NetworkSpec(2, 1, 4, 2, cell="lstm", seq_len=4)
# the reference's tune suite's two case studies (benchmarks/tune_suite.py)
CASE_STUDY = NetworkSpec(3, 4, 4, 2)
LSTM_H4 = NetworkSpec(2, 1, 4, 2, cell="lstm", seq_len=6)
SMOKE_GRID = {"unroll": (1, 2), "c_slow": (1, 2), "quant_bits": (None, 8)}
# the reference's --smoke grid also pins its TPU tiling axis
REF_SMOKE_GRID = {**SMOKE_GRID, "double_buffer": (True,)}
TILING = ("double_buffer", "chunk", "block_b")

PORT_BACKENDS = ("eager", "kernel")
REF_BACKENDS = ("xla", "pallas")
TO_PORT = {v: k for k, v in REFERENCE_BACKEND.items()}


def jspec(spec):
    return JSpec(**dataclasses.asdict(spec))


def to_ref(key: str) -> str:
    """A port candidate key under the reference's backend names."""
    parts = key.split("|")
    parts[1] = REFERENCE_BACKEND[parts[1]]
    return "|".join(parts)


def folded(ref_key: str) -> str:
    """The port key a reference candidate key lands on: the backend renamed
    and the TPU tiling tags dropped."""
    parts = ref_key.split("|")
    parts[1] = TO_PORT[parts[1]]
    return "|".join(p for p in parts
                    if not (p == "db0" or p.startswith(("ch", "bb"))))


def dedup(keys):
    return list(dict.fromkeys(keys))


@pytest.fixture
def bridged(monkeypatch):
    """The predict phase builds every spec from the reference's weights."""
    def build(spec, device=None):
        jprog = jcg.build_program(jspec(spec))
        return program_from_jax(jax.tree.map(np.asarray, jprog.params), spec, device="cpu")

    monkeypatch.setattr(search, "build_program", build)
    search._STATIC_PROFILE_CACHE.clear()
    jsearch._STATIC_PROFILE_CACHE.clear()
    yield
    search._STATIC_PROFILE_CACHE.clear()
    jsearch._STATIC_PROFILE_CACHE.clear()


# ---------------------------------------------------------------------------
# knob grids, validity and the space
# ---------------------------------------------------------------------------

def test_knob_grids_and_rules_are_the_reference_s():
    for name in ("DEFAULT_UNROLL", "DEFAULT_C_SLOW", "DEFAULT_QUANT_BITS",
                 "DEFAULT_DOUBLE_BUFFER", "DEFAULT_CHUNK", "DEFAULT_BLOCK_B"):
        assert getattr(knobs, name) == getattr(jknobs, name), name
    for port_b, ref_b in (("eager", "xla"), ("kernel", "pallas"), ("verilog", "verilog")):
        for cell in ("mlp", "lstm", "gru", "ssm"):
            for bits in (None, 4, 8, 12, 16, 32, 64):
                assert (knobs.quant_reason(port_b, cell, bits) is None) == \
                    (jknobs.quant_reason(ref_b, cell, bits) is None), (port_b, cell, bits)


def test_enumerate_rejects_value_invalid_everywhere():
    with pytest.raises(ValueError, match="invalid for every requested"):
        enumerate_space(LSTM, backends=("eager",), quant_bits=(12,))
    with pytest.raises(ValueError, match="outside rtlsim"):
        enumerate_space(MLP, quant_bits=(4,))
    with pytest.raises(ValueError, match="invalid for every requested"):
        enumerate_space(NetworkSpec(2, 1, 4, 2, cell="ssm", seq_len=4),
                        backends=("kernel",), quant_bits=(16,))
    with pytest.raises(ValueError, match="unknown backend"):
        enumerate_space(MLP, backends=("eager", "xla"))
    with pytest.raises(ValueError, match="unroll=0"):
        enumerate_space(MLP, unroll=(0,))
    # the TPU tiling knobs are no axes of the port's space: setting one is
    # an error, never a grid that changes no candidate
    for name in TILING:
        with pytest.raises(TypeError, match=name):
            enumerate_space(MLP, **{name: (None,)})


def test_enumerate_prunes_partial_validity():
    cands = enumerate_space(LSTM, unroll=(1,), c_slow=(1,), quant_bits=(None, 8))
    assert {(c.backend, c.spec.quant_bits) for c in cands} == \
        {("eager", None), ("kernel", None), ("kernel", 8)}


FOLD_CASES = {
    "lstm_default_grid": (LSTM, {}),
    "case_study_default_grid": (CASE_STUDY, {}),
    "lstm_h4_default_grid": (LSTM_H4, {}),
    "ssm_kernel_tiling": (NetworkSpec(2, 1, 4, 2, cell="ssm", seq_len=4),
                          dict(unroll=(1,), c_slow=(1, 2), quant_bits=(None, 8),
                               chunk=(None, 4), block_b=(None, 2))),
}


@pytest.mark.parametrize("name", sorted(FOLD_CASES))
def test_candidates_fold_as_the_reference_aliases(name):
    """Each port candidate is the fold of one or more reference candidates:
    ``…|pallas|u1|c1|db0`` (and ``|ch4``, ``|bb2``) folds into
    ``…|kernel|u1|c1``; every reference candidate lands on a port one."""
    spec, grid = FOLD_CASES[name]
    ours = enumerate_space(spec, **{k: v for k, v in grid.items() if k not in TILING})
    theirs = jsearch.enumerate_space(jspec(spec), backends=REF_BACKENDS, **grid)
    groups: dict[str, list[str]] = {}
    for c in theirs:
        groups.setdefault(folded(c.key), []).append(c.key)
    assert [c.key for c in ours] == list(groups)
    assert [f.name for f in dataclasses.fields(Candidate)] == ["spec", "backend"]
    # the aliases: a kernel candidate stands for every tiling of the reference's
    for c in ours:
        tags = sorted(k[len(to_ref(c.key)):] for k in groups[c.key])
        if c.backend == "eager":
            assert tags == [""]
        else:
            n_db = len(grid.get("double_buffer", jknobs.DEFAULT_DOUBLE_BUFFER))
            n_ch = len(grid.get("chunk", jknobs.DEFAULT_CHUNK))
            n_bb = len(grid.get("block_b", jknobs.DEFAULT_BLOCK_B))
            assert len(tags) == n_db * n_ch * n_bb and tags[0] == ""


def test_candidate_key_and_cache_key():
    cand = Candidate(spec=dataclasses.replace(LSTM, unroll=2, quant_bits=8),
                     backend="kernel")
    assert cand.key == "lstm_2i_1x4_2o|kernel|u2|c1|q8"
    assert cand.order_key == "lstm_2i_1x4_2o|pallas|u2|c1|q8"
    # the tiling knobs build the same kernel on the card: not in the memo key
    assert _cache_key(cand.spec, 2, cand.backend, torch.device("cpu")) == \
        (cand.spec, 2, "kernel", "cpu")
    assert cand.synth_kwargs() == {"backend": "kernel"}
    assert cand.knobs_dict() == {"backend": "kernel", "unroll": 2, "c_slow": 1,
                                 "quant_bits": 8}
    assert baseline_candidate(LSTM) == Candidate(LSTM, "eager")


# ---------------------------------------------------------------------------
# predict phase on bridged programs
# ---------------------------------------------------------------------------

PREDICT_SPECS = {
    "mlp": MLP,
    "lstm": LSTM,
    "case_study": CASE_STUDY,
    "gru": NetworkSpec(2, 2, 4, 2, cell="gru", seq_len=4),
    "ssm": NetworkSpec(2, 2, 5, 2, cell="ssm", seq_len=4),
    "fig10_a": NetworkSpec(**dataclasses.asdict(j_paper.FIG10_A)),
}


@pytest.mark.parametrize("name", sorted(PREDICT_SPECS))
def test_predict_phase_matches_reference(bridged, name):
    spec = PREDICT_SPECS[name]
    ours = {s.key: s.predicted
            for s in predict_rank(enumerate_space(spec), "latency", 2, "cpu")}
    theirs = {folded(s.key): s.predicted
              for s in jsearch.predict_rank(
                  jsearch.enumerate_space(jspec(spec), backends=REF_BACKENDS), "latency", 2)}
    assert set(ours) == set(theirs)
    for key, want in theirs.items():
        got = dict(ours[key])
        want = dict(want)
        a, b = got.pop("static_snr_db"), want.pop("static_snr_db")
        assert (a is None) == (b is None) and (a is None or abs(a - b) <= 1e-9), key
        assert got == want, key


@pytest.mark.parametrize("objective", ["latency", "throughput", "resources"])
@pytest.mark.parametrize("budget", [3, 4])
def test_ranking_matches_reference(objective, budget):
    """Ties (each eager/kernel pair of one schedule) break as the
    reference's: its order with the aliases folded, and on an alias-free
    grid the same top-``budget``."""
    for grid, ref_grid in (({}, {}), (SMOKE_GRID, REF_SMOKE_GRID)):
        ours = [s.key for s in predict_rank(enumerate_space(LSTM_H4, **grid), objective, 2,
                                            "cpu")]
        theirs = [s.key for s in jsearch.predict_rank(
            jsearch.enumerate_space(jspec(LSTM_H4), backends=REF_BACKENDS, **ref_grid),
            objective, 2)]
        assert ours == dedup(folded(k) for k in theirs)
        if grid:
            assert [to_ref(k) for k in ours[:budget]] == theirs[:budget]
    with pytest.raises(ValueError, match="unknown objective"):
        predict_rank(enumerate_space(LSTM, **SMOKE_GRID), "power", 2, "cpu")


# ---------------------------------------------------------------------------
# pareto math
# ---------------------------------------------------------------------------

def test_dominates_and_front_synthetic():
    from repro.tune import dominates as jdominates
    from repro.tune import pareto_front as jpareto_front

    pts = [(3.0, 1.0), (1.0, 3.0), (2.0, 2.0), (4.0, 4.0), (2.0, 2.0)]
    assert pareto_front(pts) == jpareto_front(pts) == [0, 1, 2, 4]
    for a, b in ((1.0, 1.0), (2.0, 2.0)), ((1.0, 2.0), (1.0, 3.0)), ((1.0, 3.0), (2.0, 2.0)):
        assert dominates(a, b) == jdominates(a, b)
    assert not dominates((1.0, 1.0), (1.0, 1.0))
    with pytest.raises(ValueError):
        dominates((1.0,), (1.0, 2.0))
    assert pareto_front([]) == []


# ---------------------------------------------------------------------------
# the loop with stub timers and validators on both sides
# ---------------------------------------------------------------------------

def _stub_measure(walls: dict, calls: list, name):
    def fn(cand, batch):
        calls.append(name(cand.key))
        return {"wall_us": walls.get(name(cand.key), 500.0), "ledger_key": cand.key}
    return fn


def _validator(ok_type, broken: set):
    def fn(spec, batch=2, **kw):
        if (spec.unroll, spec.c_slow, spec.quant_bits) in broken:
            return ok_type(case=None, ok=False, float_err=1.0, bit_exact=False,
                           max_code_delta=99, error="injected parity break")
        return ok_type(case=None, ok=True, float_err=0.0, bit_exact=True, max_code_delta=0)
    return fn


STUB_CASES = {
    # spec, objective, budget, walls by reference key, broken (u, c, q), prune
    "lstm_h4_budget3": (LSTM_H4, "latency", 3,
                        {"lstm_2i_1x4_2o|xla|u2|c1": 10.0, "lstm_2i_1x4_2o|xla|u1|c1": 40.0},
                        set(), False),
    "lstm_h4_budget4_parity_break": (LSTM_H4, "latency", 4,
                                     {"lstm_2i_1x4_2o|pallas|u2|c1": 5.0,
                                      "lstm_2i_1x4_2o|xla|u2|c1": 10.0},
                                     {(2, 1, None)}, False),
    "case_study_all_ties": (CASE_STUDY, "latency", 5, {}, set(), False),
    "case_study_throughput": (CASE_STUDY, "throughput", 3,
                              {"nn_3i_4x4_2o|pallas|u2|c2|q8": 200.0}, set(), False),
    "lstm_h4_resources": (LSTM_H4, "resources", 3, {}, set(), False),
    "fig10_a_pruned": (NetworkSpec(**dataclasses.asdict(j_paper.FIG10_A)), "latency", 3,
                       {}, set(), True),
}


@pytest.mark.parametrize("name", sorted(STUB_CASES))
def test_stubbed_loop_matches_reference(bridged, name):
    spec, objective, budget, walls, broken, prune = STUB_CASES[name]
    runs = []
    for fn, backends, grid, name_of, ok_type, kw in (
            (tune, PORT_BACKENDS, SMOKE_GRID, to_ref, CaseResult, {"device": "cpu"}),
            (jtune, REF_BACKENDS, REF_SMOKE_GRID, lambda k: k, JCaseResult, {})):
        calls = []
        res = fn(jspec(spec) if fn is jtune else spec, optimize=objective, budget=budget,
                 batch=2, backends=backends, space_kwargs=grid, analyze_prune=prune,
                 measure_fn=_stub_measure(walls, calls, name_of),
                 validate_fn=_validator(ok_type, broken), **kw)
        runs.append({
            "calls": calls,
            "scored": [name_of(s.key) for s in res.scored],
            "best": name_of(res.best.key),
            "baseline": name_of(res.baseline.key),
            "measured": [(name_of(s.key), s.measured["objective"], s.validated)
                         for s in res.measured],
            "pareto": [name_of(s.key) for s in res.pareto],
            "rejects": [(name_of(s.key), s.parity_error) for s in res.measured
                        if s.validated is False],
            "speedup": res.speedup,
        })
        if fn is tune:
            assert isinstance(res, TuneResult) and res.report is None
            assert res.cache_key == (res.best.cand.spec, 2, res.best.cand.backend, "cpu")
            assert check_tune_doc(result_doc(res)) == []
    assert runs[0] == runs[1]
    if broken:
        assert runs[0]["rejects"]
    if prune:
        assert len(runs[0]["scored"]) < len(enumerate_space(spec, **SMOKE_GRID))


def test_everything_broken_raises_and_budget_is_checked():
    with pytest.raises(RuntimeError, match="difftest parity gate"):
        tune(LSTM, budget=2, batch=2, backends=("eager",),
             space_kwargs={"unroll": (1, 2), "c_slow": (1,), "quant_bits": (None,)},
             measure_fn=_stub_measure({}, [], to_ref),
             validate_fn=_validator(CaseResult, {(1, 1, None), (2, 1, None)}), device="cpu")
    with pytest.raises(ValueError, match="budget"):
        tune(LSTM, budget=0, device="cpu")


def test_report_doc_schema_roundtrip():
    result = tune(LSTM, budget=2, batch=2, backends=("eager",),
                  space_kwargs={"unroll": (1, 2), "c_slow": (1,), "quant_bits": (None,)},
                  measure_fn=_stub_measure({}, [], to_ref),
                  validate_fn=_validator(CaseResult, set()), device="cpu")
    doc = json.loads(json.dumps(result_doc(result), default=str))
    assert check_tune_doc(doc) == []
    assert doc["schema"] == "repro.tune/v1"
    assert doc["best"]["key"] in {c["key"] for c in doc["candidates"]}
    assert doc["best"]["repro"]["synthesize_kwargs"]["backend"] == "eager"
    broken = dict(doc)
    broken.pop("best")
    assert any("best" in e for e in check_tune_doc(broken))
    table = result.table()
    for s in result.measured:
        assert s.key in table


# ---------------------------------------------------------------------------
# the real loop on the CPU
# ---------------------------------------------------------------------------

def test_validate_candidate_real_ok():
    res = validate_candidate(MLP, batch=2, device="cpu")
    assert res.ok and res.float_err <= 1e-5 and res.bit_exact


def test_a_memo_hit_without_a_timed_row_is_timed_again():
    """A memo hit writes no ledger row, so ``synthesize(measure=True)``
    times a build that was memoized untimed, or built first under a tiling
    alias; a measured candidate is never dropped for want of a row."""
    spec = NetworkSpec(2, 1, 3, 2, cell="lstm", seq_len=3, seed=1919)
    synthesis.synthesize(spec, batch=2, backend="kernel", measure=False, device="cpu")
    got = measure_candidate(Candidate(spec, "kernel"), 2, device="cpu")
    assert got["ledger_key"] == "lstm_2i_1x3_2o|kernel|u1|c1|b2" and got["wall_us"] > 0
    timed = synthesis.synthesize(spec, batch=2, backend="kernel", device="cpu")
    assert timed.cache_hit       # timed under its key: the memo answers
    alias = synthesis.synthesize(spec, batch=2, backend="kernel", double_buffer=False,
                                 device="cpu")
    assert not alias.cache_hit
    assert obs_lib.OBS.ledger.timed("lstm_2i_1x3_2o|kernel|u1|c1|b2|db0")
    again = synthesis.synthesize(spec, batch=2, backend="kernel", double_buffer=False,
                                 device="cpu")
    assert again.cache_hit


def test_synthesize_optimize_runs_the_loop_on_the_cpu():
    result = synthesis.synthesize(LSTM_H4, optimize="latency", budget=2, batch=2,
                                  device="cpu")
    assert isinstance(result, TuneResult)
    best = result.best
    assert best.validated and best.gate.ok and best.gate.float_err <= 1e-5
    assert result.report is not None and result.report.backend == best.cand.backend
    assert result.cache_key == (best.cand.spec, 2, best.cand.backend, "cpu")
    rows = {r["program"]: r for r in obs_lib.OBS.ledger.report()}
    for s in result.measured:
        assert s.measured["wall_us"] > 0
        assert rows[s.measured["ledger_key"]]["measured_wall_us"] == s.measured["wall_us"]
    assert len(result.measured) == 3     # the top 2 and the eager baseline
    assert check_tune_doc(result.to_doc()) == []


def test_cli_smoke_writes_a_valid_document(tmp_path):
    out = tmp_path / "tune.json"
    assert tune_main(["--cell", "lstm", "--smoke", "--device", "cpu",
                      "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert check_tune_doc(doc) == [] and len(doc["measured"]) == 4
    assert {c["knobs"]["backend"] for c in doc["candidates"]} == {"eager", "kernel"}
