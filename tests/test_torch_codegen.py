"""The port's code generator on the CPU against the JAX reference.

IR structure, the one-step evaluator, the eager backend (vs ``xla_backend``),
the generated kernel's plain version — the lowered plan's interpreter — (vs
``pallas_backend`` in interpret mode, its default here), the int8 packer and
the FSM cycle model.  Weights are drawn by the reference and cross over as
numpy arrays (``bridge.program_from_jax``); inputs are made with numpy from a
seed.  Bars: 1e-6 one step, 1e-5 over a run in fp32 (the reference's
difftest bar between its XLA and Pallas backends), 2e-5 with LUT gates or int8
ROMs (fp32 sums taken in another order feed a table lookup or a rescale),
bit-exact int8 codes and scales, equal cycle counts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import codegen as jcg  # noqa: E402
from repro.codegen import pallas_backend as jpb  # noqa: E402
from repro.codegen import rtlsim as jrtl  # noqa: E402
from repro.codegen import xla_backend as jxla  # noqa: E402
from repro.core.synthesis import NetworkSpec as JSpec  # noqa: E402
from repro.kernels.int8_matmul.ops import quantize_per_channel as j_qpc  # noqa: E402
from repro.kernels.tanh_lut.ref import make_lut as j_make_lut  # noqa: E402
from repro_torch import codegen as pcg  # noqa: E402
from repro_torch.bridge import program_from_jax  # noqa: E402
from repro_torch.codegen import cuda_emit, eager_backend, kernel_backend, lower  # noqa: E402
from repro_torch.codegen import rtlsim as prtl  # noqa: E402
from repro_torch.codegen.ir import GraphBuilder, Schedule, Stage, eval_graph  # noqa: E402
from repro_torch.core.state_space import resolve_activation  # noqa: E402
from repro_torch.core.synthesis import NetworkSpec  # noqa: E402
from repro_torch.kernels.int8_matmul.ops import quantize_per_channel  # noqa: E402
from repro_torch.kernels.tanh_lut.ref import make_lut  # noqa: E402

CELLS = ("mlp", "lstm", "gru", "ssm")


def _spec(cell, **kw):
    base = dict(num_inputs=3, num_hidden_layers=2, nodes_per_layer=5, num_outputs=2)
    if cell == "mlp":
        base.update(num_hidden_layers=4, nodes_per_layer=6)
    else:
        base.update(cell=cell, seq_len=7)
    base.update(kw)
    return JSpec(**base)


def _bridge(jspec):
    """(reference program, port program with the same weights)."""
    jprog = jcg.build_program(jspec)
    np_params = jax.tree.map(np.asarray, jprog.params)
    pspec = NetworkSpec(**dataclasses.asdict(jspec))
    return jprog, program_from_jax(np_params, pspec, device="cpu")


def _input(jspec, B, seed=0):
    r = np.random.default_rng(seed)
    shape = (B, jspec.num_inputs) if jspec.cell == "mlp" \
        else (B, jspec.seq_len, jspec.num_inputs)
    u = r.normal(size=shape)
    if jspec.c_slow > 1:
        u = r.normal(size=(jspec.c_slow,) + shape)
    return u.astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# IR structure and the one-step evaluator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", CELLS)
def test_node_lists_match_reference(cell):
    jprog = jcg.build_program(_spec(cell))
    pprog = pcg.build_program(NetworkSpec(**dataclasses.asdict(_spec(cell))), device="cpu")
    assert len(jprog.stages) == len(pprog.stages)
    for js, ps in zip(jprog.stages, pprog.stages):
        jg, pg = js.graph, ps.graph
        assert [dataclasses.astuple(n) for n in pg.nodes] == \
            [dataclasses.astuple(n) for n in jg.nodes]
        assert (pg.states, pg.updates, pg.output) == (jg.states, jg.updates, jg.output)
        assert dataclasses.astuple(ps.schedule) == dataclasses.astuple(js.schedule)
        assert {k: tuple(v.shape) for k, v in ps.params.items()} == \
            {k: tuple(v.shape) for k, v in js.params.items()}
        assert pg.quantizable_weights() == jg.quantizable_weights()
        assert pg.macc_flops_per_step() == jg.macc_flops_per_step()
        assert pg.rom_elements(7) == jg.rom_elements(7)
    assert pprog.num_params() == jprog.num_params()
    assert pprog.readout_state == jprog.readout_state


@pytest.mark.parametrize("cell", CELLS)
def test_eval_graph_one_step_matches_reference(cell):
    jprog, pprog = _bridge(_spec(cell))
    g_j, g_p = jprog.stages[0].graph, pprog.stages[0].graph
    r = np.random.default_rng(1)
    states = {s: r.normal(size=(3, w)).astype(np.float32) for s, w in g_j.states.items()}
    inp = g_j.input_node()
    u = None if inp is None else r.normal(size=(3, inp.width)).astype(np.float32)
    jp, pp = jprog.stages[0].params, pprog.stages[0].params
    per_step = {n.name for n in g_j.consts(per_step=True)}
    get_j = lambda n: jp[n][2] if n in per_step else jp[n]
    get_p = lambda n: pp[n][2] if n in per_step else pp[n]
    new_j, out_j = jcg.eval_graph(
        g_j, consts=get_j, states={k: jnp.asarray(v) for k, v in states.items()},
        u=None if u is None else jnp.asarray(u),
        act=lambda fn: {"sigmoid": jax.nn.sigmoid, "tanh": jnp.tanh}[fn])
    new_p, out_p = eval_graph(
        g_p, consts=get_p, states={k: torch.as_tensor(v) for k, v in states.items()},
        u=None if u is None else torch.as_tensor(u), act=resolve_activation)
    for s in g_j.states:
        _close(new_p[s], new_j[s], 1e-6)
    if out_j is not None:
        _close(out_p, out_j, 1e-6)


def test_graph_validation_rejects_malformed():
    from repro_torch.codegen.ir import DatapathGraph, Node

    bad = DatapathGraph(
        nodes=[Node("x", "state", (), 4), Node("z", "macc", ("x", "missing_w"), 4)],
        states={"x": 4}, updates={"x": "z"})
    with pytest.raises(ValueError, match="before definition"):
        bad.validate()
    g = GraphBuilder()
    g.state("x", 4)
    with pytest.raises(ValueError, match="write-back"):
        g.build()
    with pytest.raises(ValueError, match="unroll"):
        Schedule(steps=3).with_unroll(0)


# ---------------------------------------------------------------------------
# eager backend vs the reference's XLA backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c_slow", [1, 2])
@pytest.mark.parametrize("unroll", [1, 2])
@pytest.mark.parametrize("cell", CELLS)
def test_eager_backend_matches_xla_backend(cell, unroll, c_slow):
    jspec = _spec(cell, unroll=unroll, c_slow=c_slow)
    jprog, pprog = _bridge(jspec)
    u = _input(jspec, B=3, seed=unroll + c_slow)
    y_j = jxla.compile_program(jprog)(jprog.params, jnp.asarray(u))
    y_p = eager_backend.compile_program(pprog, device="cpu")(pprog.params, torch.as_tensor(u))
    assert tuple(y_p.shape) == y_j.shape
    _close(y_p, y_j, 1e-5)


@pytest.mark.parametrize("T", [33, 40])
@pytest.mark.parametrize("cell", ["lstm", "gru", "ssm"])
def test_eager_backend_edge_shapes(cell, T):
    """The difftest's chunk/block-boundary shapes: T in {33, 40}, B = 9."""
    jspec = _spec(cell, seq_len=T, num_hidden_layers=1)
    jprog, pprog = _bridge(jspec)
    u = _input(jspec, B=9, seed=T)
    y_j = jxla.compile_program(jprog)(jprog.params, jnp.asarray(u))
    y_p = eager_backend.compile_program(pprog, device="cpu")(pprog.params, torch.as_tensor(u))
    _close(y_p, y_j, 1e-5)


# ---------------------------------------------------------------------------
# the generated kernel's plain version vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

KERNEL_CASES = {
    # name: (cell, quant_bits, lut bits, B, T)
    "lstm": ("lstm", None, None, 3, 9),
    "gru": ("gru", None, None, 2, 7),
    "ssm": ("ssm", None, None, 9, 5),
    "mlp": ("mlp", None, None, 4, None),
    "lstm_lut": ("lstm", None, 6, 2, 6),
    "lstm_int8_lut": ("lstm", 8, 6, 2, 5),
    "gru_int8": ("gru", 8, None, 2, 5),
    "mlp_int8": ("mlp", 8, None, 5, None),
}


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_kernel_plan_matches_pallas_interpret(name):
    cell, qbits, lbits, B, T = KERNEL_CASES[name]
    jspec = _spec(cell, **({} if T is None else {"seq_len": T}), num_hidden_layers=
                  4 if cell == "mlp" else 1)
    jprog, pprog = _bridge(jspec)
    j_lut = None if lbits is None else j_make_lut(lbits)
    p_lut = None if lbits is None else make_lut(lbits)
    jst, pst = jprog.stages[0], pprog.stages[0]
    j_run = jpb.compile_stage(jst, lut=j_lut, quant_bits=qbits)
    p_run = kernel_backend.compile_stage(pst, lut=p_lut, quant_bits=qbits)
    r = np.random.default_rng(7)
    x0 = {s: r.normal(size=(B, w)).astype(np.float32) for s, w in jst.graph.states.items()}
    us = None if T is None else r.normal(size=(B, T, jspec.num_inputs)).astype(np.float32)
    jc = jpb.prequantize_consts(jst.graph, jst.params, qbits)
    pc = kernel_backend.prequantize_consts(pst.graph, pst.params, qbits)
    fin_j, ys_j = j_run(jc, {k: jnp.asarray(v) for k, v in x0.items()},
                        None if us is None else jnp.asarray(us))
    fin_p, ys_p = p_run(pc, {k: torch.as_tensor(v) for k, v in x0.items()},
                        None if us is None else torch.as_tensor(us))
    tol = 1e-5 if qbits is None and lbits is None else 2e-5
    for s in fin_j:
        _close(fin_p[s], fin_j[s], tol)
    assert (ys_p is None) == (ys_j is None)
    if ys_j is not None:
        _close(ys_p, ys_j, tol)


def test_plan_lane_maps_on_a_macc_fed_through_gate_algebra():
    """A graph the registered cells do not cover: a macc whose input row is
    a concat of slices of another macc and of an input, and whose bias is a
    lane function — the lowering's lane arithmetic against eval_graph."""
    g = GraphBuilder()
    u = g.input("u", 3)
    h = g.state("h", 4)
    z1 = g.macc("z1", g.concat("cat", u, h), g.const("W1", (7, 6)), g.const("b1", (1, 6)))
    mix = g.concat("mix", g.slice("s0", z1, 4, 6), g.af("a", g.slice("s1", z1, 0, 3), "gelu"),
                   g.slice("uu", u, 1, 3))
    z2 = g.macc("z2", mix, g.const("W2", (7, 4)), g.sub("bias", h, g.af("t", h, "silu")))
    h_new = g.add("h_next", g.af("r", z2, "relu"), g.mul("hh", h, g.af("sg", h, "sigmoid")))
    g.update("h", h_new)
    graph = g.build(output=z1)
    r = np.random.default_rng(3)
    consts = {n.name: torch.as_tensor(r.normal(size=n.attr("shape")).astype(np.float32))
              for n in graph.consts()}
    B, T = 3, 4
    x0 = {"h": torch.as_tensor(r.normal(size=(B, 4)).astype(np.float32))}
    us = torch.as_tensor(r.normal(size=(B, T, 3)).astype(np.float32))
    plan = lower.lower(graph)
    fin, ys = lower.interpret(plan, consts, x0, us, T)
    table = lower.activation_table(None)
    states = dict(x0)
    want = []
    for t in range(T):
        states, out = eval_graph(graph, consts=consts.__getitem__, states=states,
                                 u=us[:, t], act=table.__getitem__)
        want.append(out)
    torch.testing.assert_close(fin["h"], states["h"], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(ys, torch.stack(want, 1), atol=1e-6, rtol=1e-6)
    src = cuda_emit.emit(plan)
    assert src == cuda_emit.emit(lower.lower(graph))     # deterministic text
    assert src.count("__global__") == len(plan.maccs) + 1
    assert "int run_stage(void** bufs, int B, int T, int n_lut, void* stream_ptr)" in src
    assert "cublas" not in src.lower() and "cudnn" not in src.lower()


def test_lowering_rejects_what_the_kernel_cannot_run():
    g = GraphBuilder()
    h = g.state("h", 4)
    W = g.const("W", (4, 4))
    g.update("h", g.add("h2", g.macc("z", h, W), g.af("bad", h, "tanh")))
    graph = g.build()
    with pytest.raises(ValueError, match="quantizable"):
        lower.lower(graph, int8_weights=("nope",))
    g2 = GraphBuilder()
    h2 = g2.state("h", 4)
    M = g2.const("M", (4, 4))
    g2.update("h", g2.add("sum", h2, M))   # a matrix ROM read elementwise
    with pytest.raises(NotImplementedError, match="matrix const"):
        lower.lower(g2.build())


def test_kernel_wrapper_refuses_tensors_off_the_card():
    """A CPU tensor takes the plan's interpreter; any other device goes to the
    kernel, which needs CUDA tensors and raises — never the plain path."""
    stage = Stage("s", pcg.CELL_GRAPHS["ssm"](3, 4), Schedule(steps=1), {})
    run = kernel_backend.compile_stage(stage)
    meta = dict(device="meta")
    consts = {"a": torch.empty((1, 4), **meta), "w_in": torch.empty((3, 4), **meta),
              "b": torch.empty((1, 4), **meta)}
    with pytest.raises(RuntimeError, match="CUDA"):
        run(consts, {"h": torch.empty((2, 4), **meta)}, torch.empty((2, 5, 3), **meta))


# ---------------------------------------------------------------------------
# int8 packing and the FSM cycle model
# ---------------------------------------------------------------------------

def test_quantize_per_channel_and_prequantize_are_bit_exact():
    r = np.random.default_rng(5)
    w = r.normal(size=(2, 9, 6)).astype(np.float32)
    w[0, :, 1] = 0.0                         # an all-zero channel: the 1e-8 floor
    w[1, :, 2] = np.float32(0.5) * np.arange(9, dtype=np.float32) / 127  # halves
    for axis in (-2, -1, 0):
        q_j, s_j = j_qpc(jnp.asarray(w), axis=axis)
        q_p, s_p = quantize_per_channel(torch.as_tensor(w), axis=axis)
        assert q_p.dtype == torch.int8 and s_p.dtype == torch.float32
        np.testing.assert_array_equal(q_p.numpy(), np.asarray(q_j))
        np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_j))
    for cell in CELLS:
        jprog, pprog = _bridge(_spec(cell))
        for js, ps in zip(jprog.stages, pprog.stages):
            cj = jpb.prequantize_consts(js.graph, js.params, 8)
            cp = kernel_backend.prequantize_consts(ps.graph, ps.params, 8)
            assert set(cp) == set(cj)
            for k in cj:
                np.testing.assert_array_equal(cp[k].numpy(), np.asarray(cj[k]))
            assert kernel_backend.prequantize_consts(ps.graph, ps.params, 12) is ps.params


@pytest.mark.parametrize("kw", [
    dict(cell="mlp"), dict(cell="mlp", unroll=3, c_slow=2),
    dict(cell="lstm"), dict(cell="lstm", unroll=2, c_slow=3, num_hidden_layers=3),
    dict(cell="gru", unroll=4), dict(cell="ssm", c_slow=2),
])
def test_fsm_cycle_estimate_matches_reference(kw):
    cell = kw.pop("cell")
    jspec = _spec(cell, **kw)
    jprog = jcg.build_program(jspec)
    pprog = pcg.build_program(NetworkSpec(**dataclasses.asdict(jspec)), device="cpu")
    for T in (None, 11):
        assert prtl.fsm_cycle_estimate(pprog, T) == jrtl.fsm_cycle_estimate(jprog, T)
