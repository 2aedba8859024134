"""The port's differential fuzz harness on the CPU against the JAX
reference's: the same seeds give the same specs, batches and inputs; every
seed holds the port's contract (``ref`` ≡ ``eager`` ≡ ``kernel`` to 1e-5,
rtlsim ≡ golden word for word) and the analyzer's bounds contain what
rtlsim observes; ``--regen-goldens`` writes only where it is told.
"""

import dataclasses
import pathlib

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import codegen as jcg  # noqa: E402
from repro.codegen import rtlsim as jr  # noqa: E402
from repro.verify import difftest as jdt  # noqa: E402
from repro_torch.bridge import program_from_jax  # noqa: E402
from repro_torch.codegen import emit_program, rtlsim  # noqa: E402
from repro_torch.core.synthesis import NetworkSpec  # noqa: E402
from repro_torch.verify import difftest as pdt  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_gen_case_gives_the_reference_specs_and_inputs():
    for seed in range(50):
        j, p = jdt.gen_case(seed), pdt.gen_case(seed)
        assert dataclasses.asdict(p.spec) == dataclasses.asdict(j.spec), seed
        assert (p.seed, p.batch, p.describe()) == (j.seed, j.batch, j.describe())
        np.testing.assert_array_equal(pdt.case_input(p), jdt.case_input(j))
    assert {k: dataclasses.asdict(v) for k, v in pdt.golden_specs().items()} == \
        {k: dataclasses.asdict(v) for k, v in jdt.golden_specs().items()}
    assert (pdt.FLOAT_ATOL, pdt.FLOAT_RTOL) == (jdt.FLOAT_ATOL, jdt.FLOAT_RTOL)


@pytest.mark.parametrize("seed", range(20))
def test_seed_holds_the_contract(seed):
    res = pdt.run_case(pdt.gen_case(seed), device="cpu")
    assert res.ok, res.line()
    assert res.bit_exact and res.max_code_delta == 0 and res.float_err <= 1e-5


@pytest.mark.parametrize("seed", [1, 5, 9, 14, 18])
def test_seed_bit_path_on_bridged_weights_is_the_reference(seed):
    """The same case's program with the reference's weights: the port's
    rtlsim words equal the reference's rtlsim words."""
    case = jdt.gen_case(seed)
    jprog = jcg.build_program(case.spec)
    pprog = program_from_jax(jax.tree.map(np.asarray, jprog.params),
                             NetworkSpec(**dataclasses.asdict(case.spec)), device="cpu")
    u = jdt.case_input(case)
    width = case.spec.quant_bits or jr.DEFAULT_WIDTH
    np.testing.assert_array_equal(
        rtlsim.simulate(pprog, u, width=width, device="cpu").y_codes.numpy(),
        jr.simulate(jprog, u, width=width).y_codes)


def test_trace_ranges_finds_no_violation_and_no_false_positive():
    results, failures = pdt.run_trace_ranges(range(12), device="cpu")
    assert not failures, [r.line() for r in failures]
    assert all(r.flagged_errors == 0 and r.wires > 0 for r in results)


def test_run_seeds_and_the_cli(capsys):
    results, failures = pdt.run_seeds(range(3), verbose=True, device="cpu")
    assert len(results) == 3 and not failures
    assert pdt.main(["--seeds", "2", "--start", "20", "--device", "cpu"]) == 0
    assert pdt.main(["--seeds", "2", "--trace-ranges", "--device", "cpu"]) == 0


def test_validate_candidate_records_a_crash():
    ok = pdt.validate_candidate(NetworkSpec(3, 1, 4, 2, cell="gru", seq_len=3), device="cpu")
    assert ok.ok and ok.error is None
    bad = pdt.validate_candidate(NetworkSpec(3, 1, 4, 2, quant_bits=40), device="cpu")
    assert not bad.ok and "ValueError" in bad.error and bad.max_code_delta == -1


def test_regen_goldens_writes_only_the_named_directory(tmp_path):
    before = {p: p.read_bytes() for p in (ROOT / "tests" / "golden").glob("*.v")}
    out = tmp_path / "goldens"
    assert pdt.main(["--regen-goldens", str(out), "--device", "cpu"]) == 0
    names = sorted(p.name for p in out.iterdir())
    assert names == sorted(f"{n}.v" for n in pdt.golden_specs())
    from repro_torch.codegen import build_program

    for name, spec in pdt.golden_specs().items():
        assert (out / f"{name}.v").read_text() == emit_program(build_program(spec, "cpu"))
    assert {p: p.read_bytes() for p in (ROOT / "tests" / "golden").glob("*.v")} == before
    with pytest.raises(SystemExit):          # the directory is not optional
        pdt.main(["--regen-goldens"])
