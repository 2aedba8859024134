"""The port's static analyzer on the CPU against the JAX reference's.

Programs cross over through ``bridge``; the ``repro.analyze/v1`` documents
(proven bounds, SNR model, findings, summary) must equal the reference's
exactly, for the registered cells and the paper's specs at 8, 16 and 32
bits, for an AF-domain violation and a waived finding built on purpose, and
for hand-built hazardous programs.  The interval transfers are held against
the reference's on random intervals, and the proven bounds against the
port's rtlsim.  The source lints give the reference's findings on the
reference's fixtures, flag each of torch's host-sync spellings, read only
the port's tree, and find nothing on this one.
"""

import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import analyze as ja  # noqa: E402
from repro import codegen as jcg  # noqa: E402
from repro.analyze import intervals as ji  # noqa: E402
from repro.analyze import ranges as jranges  # noqa: E402
from repro.analyze import lint as jlint  # noqa: E402
from repro.analyze.hazards import analyze_hazards as j_hazards  # noqa: E402
from repro.codegen import ir as jir  # noqa: E402
from repro.configs import paper_mlp as j_paper  # noqa: E402
from repro.core.synthesis import NetworkSpec as JSpec  # noqa: E402
from repro_torch import analyze as pa  # noqa: E402
from repro_torch.analyze import __main__ as pa_main  # noqa: E402
from repro_torch.analyze import intervals as pi  # noqa: E402
from repro_torch.analyze import lint as plint  # noqa: E402
from repro_torch.analyze import ranges as pranges  # noqa: E402
from repro_torch.analyze.hazards import analyze_hazards as p_hazards  # noqa: E402
from repro_torch.bridge import program_from_jax  # noqa: E402
from repro_torch.codegen import ir as pir  # noqa: E402
from repro_torch.codegen import rtlsim  # noqa: E402
from repro_torch.codegen.builders import registered_cells  # noqa: E402
from repro_torch.core.synthesis import NetworkSpec  # noqa: E402
from repro_torch.obs.check import check_analyze_doc  # noqa: E402


def bridged(jspec):
    jprog = jcg.build_program(jspec)
    pprog = program_from_jax(jax.tree.map(np.asarray, jprog.params),
                             NetworkSpec(**dataclasses.asdict(jspec)), device="cpu")
    return jprog, pprog


SPECS = {
    "mlp": JSpec(3, 2, 4, 2),
    "lstm": JSpec(2, 1, 4, 2, cell="lstm", seq_len=4),
    "lstm_2x5_j3_c2": JSpec(3, 2, 5, 2, cell="lstm", seq_len=4, unroll=3, c_slow=2),
    "gru": JSpec(2, 2, 4, 2, cell="gru", seq_len=4),
    "ssm": JSpec(2, 2, 5, 2, cell="ssm", seq_len=4),
    "case_study": j_paper.CASE_STUDY,
    "fig10_a": j_paper.FIG10_A,
    "mlp_sigmoid": JSpec(4, 3, 6, 3, activation="sigmoid"),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_analysis_documents_match_reference(name):
    jprog, pprog = bridged(SPECS[name])
    for width in (8, 16, 32):
        want = ja.analyze_program(jprog, width=width)
        got = pa.analyze_program(pprog, width=width)
        assert got.to_doc() == want.to_doc(), width
        assert got.wires == {k: pa.Bd(v.lo, v.hi) for k, v in want.wires.items()}
        assert [f.to_dict() for f in got.findings] == [f.to_dict() for f in want.findings]
        assert check_analyze_doc(got.to_doc()) == []


def _underwidth(jspec):
    """Saturating-large weights at 8 bits: the step-0 MACC provably leaves
    the word range (the reference's own under-width fixture)."""
    jprog, pprog = bridged(jspec)
    jst, pst = jprog.stages[0], pprog.stages[0]
    jst.params["W"] = jnp.full_like(jst.params["W"], 6.0)
    jst.params["b"] = jnp.zeros_like(jst.params["b"])
    pst.params["W"] = torch.full_like(pst.params["W"], 6.0)
    pst.params["b"] = torch.zeros_like(pst.params["b"])
    return jprog, pprog


def test_a_waived_finding_matches_reference_and_passes_the_gate():
    jprog, pprog = _underwidth(JSpec(2, 1, 4, 2, cell="lstm", seq_len=3, quant_bits=8))
    res = pa.analyze_program(pprog, width=8)
    assert not res.ok and all(f.step == 0 for f in res.errors)
    with pytest.raises(pa.AnalysisError) as exc:
        pa.gate(res)
    assert exc.value.findings == res.errors
    reasons = [f"{f.id}=known saturating-weight fixture" for f in res.errors]
    got = pa.analyze_program(pprog, width=8, waivers=pa.WaiverRegistry.parse(reasons))
    want = ja.analyze_program(jprog, width=8, waivers=ja.WaiverRegistry.parse(reasons))
    assert got.ok
    pa.gate(got)
    assert got.to_doc() == want.to_doc()
    assert got.to_doc()["summary"]["waived"] == len(reasons) >= 1
    # the proven bounds still contain what the simulator observes
    sim = rtlsim.simulate(pprog, np.ones((1, 3, 2), np.float32), width=8,
                          collect_ranges=True, device="cpu")
    for key, (lo, hi) in sim.wire_ranges.items():
        assert got.wires[key].contains_values(lo, hi), key


def test_waivers_need_a_reason_and_the_cli_form():
    with pytest.raises(ValueError):
        pa.WaiverRegistry().waive("kind:s.n", "  ")
    with pytest.raises(ValueError):
        pa.WaiverRegistry.parse(["no-equals-sign"])
    reg = pa.WaiverRegistry.parse(["acc-wrap:s.z=why"])
    assert "acc-wrap:s.z" in reg and len(reg) == 1 and reg.reason("acc-wrap:s.z") == "why"


def _domain_stage(ir, lib, value):
    b = ir.GraphBuilder()
    b.input("u", 4)
    b.state("x", 4)
    b.const("big", (1, 4))
    b.add("z", "x", "big")
    b.af("y", "z", "tanh")
    b.update("x", "y")
    return ir.Stage("s", b.build(), ir.Schedule(steps=1), {"big": lib.full((1, 4), value)})


def test_af_domain_violation_built_on_purpose():
    pst = _domain_stage(pir, torch, 100.0)
    jst = _domain_stage(jir, jnp, 100.0)
    assert pranges.af_domain_violations(pst, None) == \
        jranges.af_domain_violations(jst, None) == ["y"]
    with pytest.raises(ValueError, match="ROM domain"):
        pst.validate()
    _domain_stage(pir, torch, 0.5).validate()
    # the analyzer flags the clamp (af-domain) on the same lanes as the reference
    jprog = jir.Program(spec=None, stages=[jst], C=jnp.ones((1, 4)), readout_state="x")
    pprog = pir.Program(spec=None, stages=[pst], C=torch.ones((1, 4)), readout_state="x")
    want = ja.analyze_program(jprog, width=16)
    got = pa.analyze_program(pprog, width=16)
    assert got.to_doc() == want.to_doc()
    assert any(f.kind == "af-domain" for f in got.findings)


def _hazard_programs(ir, lib):
    def prog(stages, readout=None):
        return ir.Program(spec=None, stages=stages, C=lib.zeros((1, 2)),
                          readout_state=readout or next(iter(stages[-1].graph.states)))

    def stage(name, g, steps=2, unroll=1, c_slow=1):
        return ir.Stage(name, g, ir.Schedule(steps=steps, unroll=unroll, c_slow=c_slow), {})

    b = ir.GraphBuilder()
    b.input("u", 2)
    b.state("x", 2)
    b.add("y", "u", "x")
    b.add("orphan", "u", "u")
    unwritten = ir.DatapathGraph(list(b._nodes), dict(b._states), {}, "y")

    b = ir.GraphBuilder()
    b.input("u", 2)
    b.state("x", 2)
    b.state("w", 2)
    b.add("y", "u", "x")
    b.update("x", "y")
    b.update("w", "y")
    alias = b.build()

    def tiny(output=True):
        b = ir.GraphBuilder()
        b.input("u", 2)
        b.state("x", 2)
        b.add("y", "u", "x")
        b.update("x", "y")
        return b.build(output="y" if output else None)

    b = ir.GraphBuilder()
    b.input("u", 2)
    b.state("x", 2)
    b.add("y", b.macc("z", "u", b.const("W", (2, 2))), "x")
    b.update("x", "y")
    macc = b.build(output="y")

    return [prog([stage("s", unwritten)]), prog([stage("s", alias)], "x"),
            prog([stage("a", tiny()), stage("b", tiny(), steps=0, c_slow=3)]),
            prog([stage("a", tiny(False)), stage("b", tiny())]),
            prog([stage("s", macc, unroll=5)])]


def test_hazards_match_reference():
    jp, pp = _hazard_programs(jir, jnp), _hazard_programs(pir, torch)
    kinds = set()
    for j, p in zip(jp, pp):
        got = [f.to_dict() for f in p_hazards(p)]
        assert got == [f.to_dict() for f in j_hazards(j)]
        kinds |= {f["kind"] for f in got}
    assert {"state-unwritten", "dead-node", "writeback-alias", "state-unread",
            "unreachable-stage", "schedule-mismatch", "cascade-break",
            "unroll-excess"} <= kinds
    for name in ("mlp", "lstm", "gru", "ssm"):
        _, pprog = bridged(SPECS[name])
        assert not [f for f in p_hazards(pprog) if f.severity == "error"]


def _rand_bd(rng, lanes, width, spread=None):
    spread = spread or (1 << (width - 2))
    a = rng.integers(-spread, spread, size=lanes)
    b = rng.integers(-spread, spread, size=lanes)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    return tuple(int(v) for v in lo), tuple(int(v) for v in hi)


def _flags():
    seen = []
    return seen, lambda kind, lanes, detail: seen.append((kind, len(lanes), detail))


@pytest.mark.parametrize("width", [8, 16, 24, 32])
def test_interval_transfers_match_reference(width):
    """Random intervals, some past the word range so every wrap kind fires;
    32-bit words at fan-in 64 take the exact limb path."""
    rng = np.random.default_rng(width)
    for trial in range(4):
        spread = (1 << (width - 1)) if trial % 2 else None
        n_in, n_out = (64, 9) if trial < 2 else (5, 3)
        x = _rand_bd(rng, n_in, width, spread)
        w = rng.integers(-(1 << (width - 1)), 1 << (width - 1), size=(n_in, n_out)).tolist()
        bias = _rand_bd(rng, n_out, width, spread)
        a, b = _rand_bd(rng, n_out, width, spread), _rand_bd(rng, n_out, width, spread)
        jf, jflag = _flags()
        pf, pflag = _flags()
        for jfun, pfun in (
                (lambda f: ji.macc_bd(ji.Bd(*x), w, width, bias=ji.Bd(*bias), flag=f),
                 lambda f: pi.macc_bd(pi.Bd(*x), w, width, bias=pi.Bd(*bias), flag=f)),
                (lambda f: ji.mul_bd(ji.Bd(*a), ji.Bd(*b), width, flag=f),
                 lambda f: pi.mul_bd(pi.Bd(*a), pi.Bd(*b), width, flag=f)),
                (lambda f: ji.addsub_bd("add", ji.Bd(*a), ji.Bd(*b), width, flag=f),
                 lambda f: pi.addsub_bd("add", pi.Bd(*a), pi.Bd(*b), width, flag=f)),
                (lambda f: ji.addsub_bd("sub", ji.Bd(*a), ji.Bd(*b), width, flag=f),
                 lambda f: pi.addsub_bd("sub", pi.Bd(*a), pi.Bd(*b), width, flag=f))):
            want, got = jfun(jflag), pfun(pflag)
            assert (got.lo, got.hi) == (want.lo, want.hi)
        fmt = rtlsim.default_format(width)
        for fn in ("tanh", "sigmoid", "gelu", "silu", "relu", "identity"):
            rom = None if fn in ("relu", "identity") else rtlsim.af_rom(fn, fmt).tolist()
            want = ji.af_bd(ji.Bd(*a), fn, rom, width, flag=jflag)
            got = pi.af_bd(pi.Bd(*a), fn, rom, width, flag=pflag)
            assert (got.lo, got.hi) == (want.lo, want.hi)
        z = _rand_bd(rng, n_out, width, 1 << (width - 4))
        assert pi.lerp_lanes(pi.Bd(*a), pi.Bd(*b), pi.Bd(*z), width) == \
            ji.lerp_lanes(ji.Bd(*a), ji.Bd(*b), ji.Bd(*z), width)
        for entire in (False, True):
            assert pi.af_domain_lanes(pi.Bd(*a), width, entire) == \
                ji.af_domain_lanes(ji.Bd(*a), width, entire)
        assert pf == jf
    # every lane at the largest word against all-largest weights: the
    # accumulator provably leaves its 2W bits
    top = (1 << (width - 1)) - 1
    x, w = (top,) * 64, [[top] * 3 for _ in range(64)]
    want = ji.macc_bd(ji.Bd(x, x), w, width, flag=jflag)
    got = pi.macc_bd(pi.Bd(x, x), w, width, flag=pflag)
    assert (got.lo, got.hi) == (want.lo, want.hi) and pf == jf
    assert {k for k, _, _ in pf} >= {"acc-wrap", "qalign-clip", "bias-wrap", "add-wrap",
                                     "sub-wrap"}


@pytest.mark.parametrize("name", ["mlp", "lstm_2x5_j3_c2", "gru", "ssm"])
def test_observed_ranges_inside_proven_bounds(name):
    _, pprog = bridged(SPECS[name])
    spec = pprog.spec
    res = pa.analyze_program(pprog, width=16)
    shape = (4, spec.num_inputs) if spec.cell == "mlp" else (4, spec.seq_len, spec.num_inputs)
    if spec.c_slow > 1:
        shape = (spec.c_slow,) + shape
    u = np.random.default_rng(0).uniform(-1.0, 1.0, size=shape).astype(np.float32)
    sim = rtlsim.simulate(pprog, u, width=16, collect_ranges=True, device="cpu")
    assert sim.wire_ranges
    for key, (lo, hi) in sim.wire_ranges.items():
        assert res.wires[key].contains_values(lo, hi), key


def test_bounds_invariant_under_c_slow_and_unroll():
    base = pa.analyze_ranges(bridged(SPECS["lstm"])[1], width=16)
    folded = pa.analyze_ranges(bridged(dataclasses.replace(
        SPECS["lstm"], c_slow=2, unroll=2))[1], width=16)
    assert base.wires == folded.wires


def test_cli_runs_gates_and_writes_a_checked_document(tmp_path, capsys):
    out = tmp_path / "analyze.json"
    rc = pa_main.main(["--all-cells", "--bits", "8,16", "--device", "cpu",
                       "--out", str(out)])
    doc = json.loads(out.read_text())
    assert check_analyze_doc(doc) == []
    assert len(doc["runs"]) == 2 * len(registered_cells())
    failed = any(r["summary"]["errors"] for r in doc["runs"])
    assert rc == (1 if failed else 0)
    assert "[analyze]" in capsys.readouterr().out
    # one cell with its errors waived exits 0
    spec = NetworkSpec(8, 1, 32, 8)
    res = pa.analyze_spec(spec, device="cpu")
    waive = [f"--waive={f.id}=known" for f in res.errors]
    argv = ["--cell", "mlp", "--inputs", "8", "--nodes", "32", "--outputs", "8",
            "--bits", "18", "--device", "cpu"]
    assert pa_main.main(argv) == (1 if res.errors else 0)
    assert pa_main.main(argv + waive) == 0


# ---------------------------------------------------------------------------
# the source lints
# ---------------------------------------------------------------------------

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]

# the reference's jit-safety fixture (tests/test_analyze.py)
JIT_UNSAFE_SRC = '''
import time
from repro import obs as obs_lib

def build(program):
    OBS = obs_lib.OBS
    OBS.metrics.counter("compiles", "ok").inc()   # depth 1: sanctioned

    def kernel(x_ref, o_ref):
        OBS.metrics.counter("steps", "bad").inc() # traced: flagged
        t = time.perf_counter()                   # traced: flagged
        o_ref[...] = x_ref[...] * t

    def run(u):
        u.block_until_ready()                     # traced: flagged
        print("step")                             # traced: flagged
        return u

    return kernel, run
'''


def _drift_fixture():
    """The reference's metrics-drift fixture, assembled from pieces so that
    neither package's ``lint_src`` matches this file."""
    sub = '["counters"]'
    reg = {"m.py": 'M.counter' + '("hits", "d", kind="full")'}
    refs = {"t.py": f'snap{sub}["hits{{kind=full}}"]\n'
                    f'snap{sub}["renamed_metric"]'}
    return reg, refs


def test_lints_give_the_reference_findings_on_its_fixtures():
    got = [f.to_dict() for f in plint.lint_jit_safety({"fixture.py": JIT_UNSAFE_SRC})]
    want = [f.to_dict() for f in jlint.lint_jit_safety({"fixture.py": JIT_UNSAFE_SRC})]
    assert got == want and len(got) == 4
    got = [f.to_dict() for f in plint.lint_metrics_drift(*_drift_fixture())]
    want = [f.to_dict() for f in jlint.lint_metrics_drift(*_drift_fixture())]
    assert got == want and [f["node"] for f in got] == ["renamed_metric"]
    broken = {"bad.py": "def f(:\n"}
    assert [f.to_dict() for f in plint.lint_jit_safety(broken)] == \
        [f.to_dict() for f in jlint.lint_jit_safety(broken)]


@pytest.mark.parametrize("call,name", [
    ("torch.cuda.synchronize()", "torch.cuda.synchronize"),
    ("y.item()", "y.item"),
    ("y.cpu()", "y.cpu"),
    ("y.tolist()", "y.tolist"),
    ("(y - 1).abs().max().item()", "<expr>.item"),
])
def test_jit_safety_flags_each_torch_host_sync(call, name):
    nested = f"def wrap(lib):\n    def fwd(y):\n        {call}\n        return y\n    return fwd\n"
    [f] = plint.lint_jit_safety({"k.py": nested})
    assert (f.kind, f.severity, f.node) == ("jit-unsafe-call", "error", f"fwd.{name}")
    assert "host sync" in f.detail
    # at the wrapper's own level (depth 1) the same call is sanctioned
    assert plint.lint_jit_safety({"k.py": f"def wrap(y):\n    {call}\n"}) == []


def _write(root: pathlib.Path, rel: str, text: str) -> None:
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


def test_lint_src_reads_only_the_port_s_tree(tmp_path):
    sub = '["counters"]'
    unsafe = "def wrap(lib):\n    def fwd(y):\n        return y.item()\n    return fwd\n"
    _write(tmp_path, "src/repro_torch/kernels/k/ops.py", unsafe)
    _write(tmp_path, "src/repro_torch/codegen/kernel_backend.py", unsafe)
    _write(tmp_path, "src/repro_torch/obs/check.py",
           'OBS.metrics.counter' + '("served", "ok")\n' + f'snap{sub}["served"]\n')
    _write(tmp_path, "src/repro/kernels/k/ops.py", unsafe)          # the reference's
    _write(tmp_path, "tests/test_torch_x.py", f'snap{sub}["port_only"]\n')
    _write(tmp_path, "tests/test_x.py", f'snap{sub}["reference_only"]\n')
    found = sorted((f.kind, pathlib.Path(f.stage).name, f.node)
                   for f in plint.lint_src(str(tmp_path)))
    assert found == [("jit-unsafe-call", "kernel_backend.py", "fwd.y.item"),
                     ("jit-unsafe-call", "ops.py", "fwd.y.item"),
                     ("metrics-drift", "test_torch_x.py", "port_only")]
    assert pa_main.main(["--lint-src", "--repo-root", str(tmp_path), "--device", "cpu"]) == 1


def test_lint_src_is_clean_on_this_tree(tmp_path):
    assert [f.detail for f in pa.lint_src(str(REPO_ROOT))] == []
    out = tmp_path / "analyze.json"
    assert pa_main.main(["--lint-src", "--repo-root", str(REPO_ROOT), "--device", "cpu",
                         "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert check_analyze_doc(doc) == []
    assert doc["lint"]["findings"] == [] and doc["lint"]["summary"]["clean"] is True
