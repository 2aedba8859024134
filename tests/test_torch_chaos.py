"""The port's seeded chaos suite (``repro_torch.verify.chaos``) on the CPU
against the JAX reference's (``repro.verify.chaos``).

Both suites run on the smoke config with the reference's parameters
(``lm.init_params(cfg, PRNGKey(0))``, bridged in through
``bridge.params_from_jax``) and seed 0.  For every scenario, ``name``,
``passed``, the fault hits and the finish-reason counts (and the other
non-clock details) must equal the reference's.  Only wall-clock fields are
left out: ``stall_watchdog``'s ``wall_s``, and its ``decode.dispatch`` hit
count, which is the number of ticks that fit in the watchdog's 0.25 s.
``rtlsim_seu``'s flips are compared on a program bridged from the
reference's.  Then the suite document against ``check_chaos_doc`` and the
CLI's exit code.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import codegen as jcg  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
from repro.core.synthesis import NetworkSpec as JSpec  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.verify import chaos as jchaos  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.synthesis import NetworkSpec  # noqa: E402
from repro_torch.obs.check import check_chaos_doc  # noqa: E402
from repro_torch.runtime import faults as fl  # noqa: E402
from repro_torch.verify import chaos  # noqa: E402

ARCHS = ("smollm-135m", "paper-lstm")
SCENARIOS = ("quarantine_step", "quarantine_block", "dispatch_retry", "stall_watchdog",
             "splice_corruption", "slow_tick", "deadlines", "synth_fallback", "rtlsim_seu")
# the detail fields read off a clock or holding the backend's own name
CLOCK_FIELDS = {"wall_s"}


@pytest.fixture(scope="module")
def suites():
    """Both suites on each arch, the port's on the reference's weights."""
    out = {}
    for arch in ARCHS:
        jcfg = jax_configs.get_smoke_config(arch)
        p_j = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
        params = bridge.params_from_jax(jax.tree.map(np.asarray, p_j), get_smoke_config(arch),
                                        "cpu")
        ours = chaos.run_suite(seed=0, arch=arch, device="cpu", params=params)
        theirs = jchaos.run_suite(seed=0, arch=arch)
        out[arch] = (ours, theirs)
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_matches_reference(suites, arch, name):
    ours, theirs = (next(sc for sc in doc["scenarios"] if sc["name"] == name)
                    for doc in suites[arch])
    assert ours["passed"] is theirs["passed"] is True
    got, want = dict(ours["faults"]), dict(theirs["faults"])
    if name == "stall_watchdog":      # ticks within the watchdog's 0.25 s
        assert got.pop("decode.dispatch") >= 1 and want.pop("decode.dispatch") >= 1
    assert got == want
    d_got = {k: v for k, v in ours["detail"].items() if k not in CLOCK_FIELDS}
    d_want = {k: v for k, v in theirs["detail"].items() if k not in CLOCK_FIELDS}
    if name == "synth_fallback":      # the backend asked for, by its own name
        assert (d_got.pop("fallback_from"), d_want.pop("fallback_from")) == ("eager", "xla")
    if name == "rtlsim_seu":          # the flips on the suite's own weights: below
        d_got.pop("flips"), d_want.pop("flips")
    assert d_got == d_want


@pytest.mark.parametrize("arch", ARCHS)
def test_suite_document_matches_reference(suites, arch):
    ours, theirs = suites[arch]
    assert check_chaos_doc(ours) == []
    assert ours["passed"] is theirs["passed"] is True
    assert ours["all_classes_hit"] is theirs["all_classes_hit"] is True
    assert set(ours["fault_classes"]) == set(theirs["fault_classes"]) == set(fl.FAULT_POINTS)
    assert [sc["name"] for sc in ours["scenarios"]] == list(SCENARIOS)
    assert {k: v for k, v in ours.items() if k not in ("scenarios", "fault_classes")} == \
        {k: v for k, v in theirs.items() if k not in ("scenarios", "fault_classes")}


def test_rtlsim_seu_flips_match_reference_on_a_bridged_program():
    for seed in (0, 3):
        jspec = JSpec(num_inputs=4, num_hidden_layers=3, nodes_per_layer=8, num_outputs=2,
                      quant_bits=16, seed=seed)
        jprog = jcg.build_program(jspec)
        prog = bridge.program_from_jax(jax.tree.map(np.asarray, jprog.params),
                                       NetworkSpec(**dataclasses.asdict(jspec)), device="cpu")
        ours = chaos.scenario_rtlsim_seu(seed, device="cpu", program=prog)
        theirs = jchaos.scenario_rtlsim_seu(seed)
        assert ours["passed"] is theirs["passed"] is True
        assert ours["faults"] == theirs["faults"] == {"rtlsim.seu": 1}
        assert json.loads(json.dumps(ours["detail"], default=str)) == \
            json.loads(json.dumps(theirs["detail"], default=str))


def test_cli_exit_code_and_document(tmp_path, monkeypatch):
    out = tmp_path / "chaos.json"
    assert chaos.main(["--seed", "0", "--device", "cpu", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert check_chaos_doc(doc) == [] and doc["passed"] and doc["arch"] == "smollm-135m"
    # a failed scenario fails the run
    failing = dict(doc, passed=False)
    monkeypatch.setattr(chaos, "run_suite", lambda **kw: failing)
    assert chaos.main(["--device", "cpu"]) == 1
