"""The port's ``synthesize()`` flow, Table-I API and state-space core on the
CPU against the JAX reference.

Reports (params, output shape, serial depth, quant mode, ledger keys with the
port's backend names: ``eager`` ↔ ``xla``, ``kernel`` ↔ ``pallas``), the numpy
fixed-point analysis (bit-identical), memoisation, a failed kernel build
raising, the ``"ref"`` backend against ``"eager"``, and the scan executors'
equivalence properties.  Weights cross over as numpy arrays where the two
packages are compared; bar 1e-5 in fp32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import codegen as jcg  # noqa: E402
from repro.configs import paper_mlp as j_paper  # noqa: E402
from repro.core import cslow as j_cslow  # noqa: E402
from repro.core import quantization as j_quant  # noqa: E402
from repro.core import synthesis as j_synth  # noqa: E402
from repro.core.state_space import mlp_forward as j_mlp_forward  # noqa: E402
from repro.recurrent import cells as j_cells  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.bridge import program_from_jax  # noqa: E402
from repro_torch.configs import paper_mlp  # noqa: E402
from repro_torch.core import cslow, quantization, synthesis  # noqa: E402
from repro_torch.core.state_space import (  # noqa: E402
    mlp_forward, nn_state_space, run_direct, run_scan)
from repro_torch.core.synthesis import NetworkSpec  # noqa: E402
from repro_torch.recurrent import cells  # noqa: E402

BACKEND = {"eager": "xla", "kernel": "pallas", "ref": "ref"}


def _pspec(jspec):
    return NetworkSpec(**dataclasses.asdict(jspec))


def _t(a):
    return torch.as_tensor(np.array(a))


REPORT_CASES = {
    "case_study": (j_paper.CASE_STUDY, "eager", 2),
    "fig10_a_unroll_cslow": (dataclasses.replace(j_paper.FIG10_A, unroll=4, c_slow=4), "eager", None),
    "lstm": (j_synth.NetworkSpec(4, 2, 6, 3, cell="lstm", seq_len=5), "eager", 2),
    "lstm_q12_lut": (j_synth.NetworkSpec(4, 1, 6, 3, cell="lstm", seq_len=5, quant_bits=12),
                     "kernel", 2),
    "ssm_q8_int8": (j_synth.NetworkSpec(4, 1, 6, 3, cell="ssm", seq_len=5, quant_bits=8),
                    "kernel", 2),
}


@pytest.mark.parametrize("name", sorted(REPORT_CASES))
def test_reports_match_reference(name):
    jspec, backend, batch = REPORT_CASES[name]
    jr = j_synth.synthesize(jspec, batch=batch, backend=BACKEND[backend], measure=False)
    pr = synthesis.synthesize(_pspec(jspec), batch=batch, backend=backend,
                              measure=False, device="cpu")
    assert pr.backend == backend and pr.fallback_from is None and not pr.cache_hit
    assert (pr.num_params, pr.output_shape, pr.serial_depth) == \
        (jr.num_params, jr.output_shape, jr.serial_depth)
    if jspec.cell != "mlp":        # an mlp's SNR depends on its weights (below)
        assert pr.quant == jr.quant
    jkey = j_synth._ledger_key(jspec, batch, BACKEND[backend])
    pkey = synthesis._ledger_key(_pspec(jspec), batch, backend)
    assert pkey == jkey.replace(f"|{BACKEND[backend]}|", f"|{backend}|")
    [row] = obs.OBS.ledger.report(match=pkey)
    assert row["fsm_cycles"] == jcg.rtlsim.fsm_cycle_estimate(jcg.build_program(jspec))
    assert row["flops"] == pr.flops > 0
    assert pr.peak_bytes is None                    # no card: nothing to read
    assert (pr.hlo_bytes > 0) == (backend == "kernel")
    assert pr.backend in pr.summary()


def test_ledger_keys_name_the_kernel_knobs():
    spec = _pspec(j_paper.CASE_STUDY)
    for kw in (dict(double_buffer=False), dict(chunk=16), dict(block_b=4),
               dict(chunk=8, block_b=2, double_buffer=False)):
        assert synthesis._ledger_key(spec, 8, "kernel", **kw) == \
            j_synth._ledger_key(j_paper.CASE_STUDY, 8, "pallas", **kw).replace("pallas", "kernel")
    # on the card the tiling knobs build the same kernel: one memo entry
    synthesis.synthesize_cache_clear()
    small = NetworkSpec(3, 1, 4, 2, cell="ssm", seq_len=3)
    synthesis.synthesize(small, backend="kernel", measure=False, device="cpu")
    r = synthesis.synthesize(small, backend="kernel", chunk=16, block_b=4,
                             double_buffer=False, measure=False, device="cpu")
    assert r.cache_hit and synthesis.synthesize_cache_info() == {"entries": 1}


@pytest.mark.parametrize("bits", [10, 16])
def test_mlp_quant_analysis_matches_reference_on_bridged_weights(bits):
    jspec = dataclasses.replace(j_paper.CASE_STUDY, quant_bits=bits)
    jprog = jcg.build_program(jspec)
    pprog = program_from_jax(jax.tree.map(np.asarray, jprog.params), _pspec(jspec), device="cpu")
    assert synthesis._quant_analysis(_pspec(jspec), "kernel", pprog) == \
        j_synth._quant_analysis(jspec, "pallas", jprog)


def test_snr_sweep_is_the_reference_bit_for_bit():
    r = np.random.default_rng(0)
    W, b = r.normal(size=(3, 5, 5)) / 2, r.normal(size=(3, 5)) / 4
    beta, C = r.normal(size=(5, 2)), r.normal(size=(2, 5))
    for mode in ("interp", "lut", "exact"):
        got = quantization.snr_sweep(W, b, beta, C, [8, 12, 20, 32], num_inputs=64,
                                     seed=3, tanh_mode=mode)
        want = j_quant.snr_sweep(W, b, beta, C, [8, 12, 20, 32], num_inputs=64,
                                 seed=3, tanh_mode=mode)
        for (wg, sg), (ww, sw) in zip(got, want):
            assert wg == ww
            np.testing.assert_array_equal(sg, sw)


def test_synthesize_memoizes_and_records_the_ledger():
    synthesis.synthesize_cache_clear()
    spec = NetworkSpec(3, 2, 4, 2, cell="gru", seq_len=4)
    r1 = synthesis.synthesize(spec, batch=3, backend="kernel", device="cpu")
    r2 = synthesis.synthesize(spec, batch=3, backend="kernel", device="cpu")
    assert not r1.cache_hit and r2.cache_hit
    assert dataclasses.replace(r2, cache_hit=False) == r1
    assert synthesis.synthesize_cache_info() == {"entries": 1}
    synthesis.synthesize(spec, batch=3, backend="eager", device="cpu")
    assert synthesis.synthesize_cache_info() == {"entries": 2}
    [row] = obs.OBS.ledger.report(match=synthesis._ledger_key(spec, 3, "kernel"))
    assert row["measured_calls"] >= 2 and row["measured_wall_us"] > 0


@pytest.mark.parametrize("kw", [dict(cell="mlp", num_hidden_layers=4, c_slow=2),
                                dict(cell="lstm", seq_len=6, c_slow=2),
                                dict(cell="gru", seq_len=5, unroll=3)])
def test_ref_backend_equals_eager_and_kernel(kw):
    spec = NetworkSpec(num_inputs=3, num_hidden_layers=kw.pop("num_hidden_layers", 2),
                       nodes_per_layer=5, num_outputs=2, **kw)
    shape = (3, 3) if spec.cell == "mlp" else (3, spec.seq_len, 3)
    shape = ((spec.c_slow,) if spec.c_slow > 1 else ()) + shape
    u = torch.as_tensor(np.random.default_rng(1).normal(size=shape).astype(np.float32))
    ys = {}
    for backend in ("ref", "eager", "kernel"):
        fwd, params = synthesis.build_forward(spec, backend, device="cpu")
        ys[backend] = fwd(params, u)
    torch.testing.assert_close(ys["eager"], ys["ref"], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(ys["kernel"], ys["ref"], atol=1e-5, rtol=1e-5)


def test_create_top_module_matches_reference_on_bridged_weights():
    for jspec in (j_paper.CASE_STUDY, j_synth.NetworkSpec(3, 2, 4, 2, cell="lstm", seq_len=5)):
        jp, jf = j_synth.create_top_module(jspec)
        pp, pf = synthesis.create_top_module(_pspec(jspec), device="cpu")
        np_jp = jax.tree.map(np.asarray, jp)
        pp = {k: ([{n: _t(x) for n, x in c.items()} for c in v] if k == "cells" else _t(v))
              for k, v in np_jp.items()}
        shape = (jspec.num_inputs,) if jspec.cell == "mlp" else (jspec.seq_len, jspec.num_inputs)
        u = np.random.default_rng(2).normal(size=(4,) + shape).astype(np.float32)
        want = jax.vmap(jf, in_axes=(None, 0))(jp, jnp.asarray(u))
        np.testing.assert_allclose(pf(pp, torch.as_tensor(u)).numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


def test_unported_options_raise_and_name_the_roadmap():
    spec = paper_mlp.CASE_STUDY
    for kw in (dict(optimize="latency"), dict(budget=4), dict(mesh=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            synthesis.synthesize(spec, device="cpu", **kw)
    # the bit path and the static gate are ported
    assert synthesis.synthesize(spec, backend="verilog", measure=False, device="cpu").rtl
    assert synthesis.synthesize(spec, analyze=True, measure=False, device="cpu").analysis
    with pytest.raises(ValueError, match="unknown backend"):
        synthesis.synthesize(spec, backend="xla", device="cpu")
    with pytest.raises(ValueError, match="quant_bits"):
        synthesis.synthesize(NetworkSpec(3, 1, 4, 2, cell="lstm", seq_len=3, quant_bits=12),
                             backend="eager", device="cpu")


VERILOG_CASES = {
    "case_study": j_paper.CASE_STUDY,
    "fig10_a_q12_u2": dataclasses.replace(j_paper.FIG10_A, quant_bits=12, unroll=2),
    "lstm_q16_c2": j_synth.NetworkSpec(2, 1, 4, 2, cell="lstm", seq_len=6, quant_bits=16,
                                       c_slow=2),
    "ssm_q24": j_synth.NetworkSpec(2, 2, 4, 2, cell="ssm", seq_len=5, quant_bits=24),
    "gru": j_synth.NetworkSpec(2, 1, 4, 2, cell="gru", seq_len=4),
}


@pytest.mark.parametrize("name", sorted(VERILOG_CASES))
def test_verilog_backend_matches_reference_report(name):
    from repro_torch import codegen

    jspec = VERILOG_CASES[name]
    jr = j_synth.synthesize(jspec, batch=2, backend="verilog", measure=False)
    pr = synthesis.synthesize(_pspec(jspec), batch=2, backend="verilog", measure=False,
                              device="cpu")
    assert (pr.backend, pr.fallback_from, pr.output_shape, pr.serial_depth, pr.num_params) == \
        (jr.backend, jr.fallback_from, jr.output_shape, jr.serial_depth, jr.num_params)
    if jspec.cell != "mlp":          # an mlp's SNR depends on its weights
        assert pr.quant == jr.quant
        assert jspec.quant_bits is None or pr.quant["mode"] == "rtl-width"
    # the RTL is the port's emission of the port's program (the reference's
    # bytes on the same weights are held in test_torch_verilog.py)
    assert pr.rtl == codegen.emit_program(codegen.build_program(_pspec(jspec), "cpu"))
    got, want = dataclasses.asdict(pr.resources), dataclasses.asdict(jr.resources)
    assert {k: v for k, v in got.items() if not k.startswith("xla_")} == \
        {k: v for k, v in want.items() if not k.startswith("xla_")}
    assert pr.resources.xla_flops == pr.flops and pr.resources.xla_peak_bytes is None
    assert synthesis._ledger_key(_pspec(jspec), 2, "verilog") == \
        j_synth._ledger_key(jspec, 2, "verilog")
    assert "rtl=" in pr.summary()


def test_verilog_falls_back_to_ref_only_on_an_injected_fault(monkeypatch):
    from repro_torch.codegen import eager_backend
    from repro_torch.runtime import faults

    synthesis.synthesize_cache_clear()
    spec = NetworkSpec(3, 1, 4, 2, cell="lstm", seq_len=3, quant_bits=14)
    plan = faults.FaultPlan([faults.FaultSpec("synth.compile", times=3)])
    with faults.active(plan):
        r = synthesis.synthesize(spec, backend="verilog", measure=False, backoff_s=0,
                                 device="cpu")
    assert (r.backend, r.fallback_from) == ("ref", "verilog")
    assert r.rtl and r.resources.width_bits == 14     # emission is unaffected
    assert r.quant is None                             # not expressible on ref
    assert synthesis.synthesize_cache_info() == {"entries": 0}

    def broken(*a, **kw):
        raise RuntimeError("eager build failed")

    monkeypatch.setattr(eager_backend, "compile_program", broken)
    with pytest.raises(RuntimeError, match="eager build failed"):
        synthesis.synthesize(spec, backend="verilog", device="cpu")


def test_analyze_gate_attaches_raises_and_honours_waivers():
    from repro_torch.analyze import AnalysisError, WaiverRegistry
    from repro_torch.obs.check import check_analyze_doc

    synthesis.synthesize_cache_clear()
    r = synthesis.synthesize(paper_mlp.CASE_STUDY, measure=False, analyze=True, device="cpu")
    assert r.analysis["schema"] == "repro.analyze/v1" and check_analyze_doc(r.analysis) == []
    assert r.analysis["summary"]["errors"] == 0
    # a memo hit re-runs the gate; a plain memo hit carries no stale analysis
    r2 = synthesis.synthesize(paper_mlp.CASE_STUDY, measure=False, analyze=True, device="cpu")
    assert r2.cache_hit and r2.analysis == r.analysis
    r3 = synthesis.synthesize(paper_mlp.CASE_STUDY, measure=False, device="cpu")
    assert r3.cache_hit and r3.analysis is None
    # FIG10_A's seeded weights wrap its hidden MACC at 18 bits: gated
    with pytest.raises(AnalysisError) as exc:
        synthesis.synthesize(paper_mlp.FIG10_A, backend="kernel", measure=False,
                             analyze=True, device="cpu")
    ids = sorted(f.id for f in exc.value.findings)
    assert ids and synthesis.synthesize_cache_info() == {"entries": 1}
    waivers = WaiverRegistry({i: "seeded weights, known" for i in ids})
    for backend in ("kernel", "verilog"):
        rw = synthesis.synthesize(paper_mlp.FIG10_A, backend=backend, measure=False,
                                  analyze=True, waivers=waivers, device="cpu")
        assert rw.analysis["summary"]["waived"] == len(ids)
        assert rw.analysis["summary"]["errors"] == 0


def test_failed_kernel_build_raises(monkeypatch):
    """No backend gives way to another: a failed build of the generated
    kernel reaches the caller under the default options."""
    from repro_torch.codegen import kernel_backend

    def broken(*a, **kw):
        raise RuntimeError("kernel build failed")

    monkeypatch.setattr(kernel_backend, "compile_program", broken)
    synthesis.synthesize_cache_clear()
    spec = NetworkSpec(3, 1, 4, 2, cell="gru", seq_len=3)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        synthesis.synthesize(spec, backend="kernel", device="cpu")
    assert synthesis.synthesize_cache_info() == {"entries": 0}


# ---------------------------------------------------------------------------
# the state-space core and the cells' StateSpaceModel views
# ---------------------------------------------------------------------------

def test_scan_direct_and_cslow_equivalences():
    r = np.random.default_rng(4)
    N, M, C = 5, 4, 3
    W = torch.as_tensor(r.normal(size=(N, M, M)).astype(np.float32)) / 2
    b = torch.as_tensor(r.normal(size=(N, M)).astype(np.float32))
    x0 = torch.as_tensor(r.normal(size=(C, M)).astype(np.float32))
    model = nn_state_space(torch.tanh)
    stacked = {"W": W, "b": b}
    xs, ys = run_scan(model, stacked, x0[0], None)
    xd, yd = run_direct(model, [{"W": W[k], "b": b[k]} for k in range(N)], x0[0], None)
    torch.testing.assert_close(xs, xd)
    torch.testing.assert_close(ys, yd)
    fin_s, ys_s = cslow.cslow_scan(model, stacked, x0, None, C)
    fin_v, ys_v = cslow.cslow_vectorized(model, stacked, x0, None)
    for c in range(C):
        xc, yc = run_scan(model, stacked, x0[c], None)
        torch.testing.assert_close(fin_s[c], xc)
        torch.testing.assert_close(fin_v[c], xc, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(ys_s[c], yc)
    with pytest.raises(ValueError, match="length"):
        cslow.cslow_scan(model, None, x0, None, C)
    u = torch.arange(24.0).reshape(2, 3, 4)
    assert torch.equal(cslow.unfold_streams(cslow.fold_streams(u), 2), u)
    assert cslow.pipeline_schedule(3, 4) == j_cslow.pipeline_schedule(3, 4)
    assert cslow.pipeline_utilization(4, 8) == j_cslow.pipeline_utilization(4, 8)


def test_mlp_forward_matches_reference():
    r = np.random.default_rng(6)
    W, b = r.normal(size=(3, 4, 4)).astype(np.float32), r.normal(size=(3, 4)).astype(np.float32)
    beta, C = r.normal(size=(4, 2)).astype(np.float32), r.normal(size=(2, 4)).astype(np.float32)
    u = r.normal(size=(2,)).astype(np.float32)
    for act in ("tanh", "sigmoid", "gelu", "silu", "relu", "identity"):
        got = mlp_forward(*map(torch.as_tensor, (W, b, beta, C, u)), activation_name=act)
        want = j_mlp_forward(*map(jnp.asarray, (W, b, beta, C, u)), activation_name=act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_run_cell_matches_reference(cell):
    ctor = j_cells.lstm_params if cell == "lstm" else j_cells.gru_params
    p = ctor(jax.random.PRNGKey(0), 3, 5)
    us = np.random.default_rng(3).normal(size=(6, 2, 3)).astype(np.float32)
    carry_j, ys_j = j_cells.run_cell(cell, p, jnp.asarray(us))
    carry_p, ys_p = cells.run_cell(cell, {k: _t(v) for k, v in p.items()}, torch.as_tensor(us))
    np.testing.assert_allclose(ys_p.numpy(), np.asarray(ys_j), atol=1e-5, rtol=1e-5)
    for a, b in zip(jax.tree.leaves(carry_j), carry_p if cell == "lstm" else [carry_p]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="unknown recurrent cell"):
        cells.make_cell("ssm", {})
