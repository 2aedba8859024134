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


@pytest.mark.parametrize("hoist", [True, False], ids=["split", "unsplit"])
@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_kernel_plan_matches_pallas_interpret(name, hoist):
    """The plan's interpreter in both modes (the kernel's split of each
    macc, and one sum over the whole row) against the Pallas kernel."""
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
    x0_p = {k: torch.as_tensor(v) for k, v in x0.items()}
    us_p = None if us is None else torch.as_tensor(us)
    if hoist:   # the stage runner's CPU path: the interpreter's default, split mode
        fin_p, ys_p = p_run(pc, x0_p, us_p)
    else:
        fin_p, ys_p = lower.interpret(p_run.plan, pc, x0_p, us_p,
                                      T if T is not None else pst.schedule.steps, p_lut,
                                      hoist=False)
    tol = 1e-5 if qbits is None and lbits is None else 2e-5
    for s in fin_j:
        _close(fin_p[s], fin_j[s], tol)
    assert (ys_p is None) == (ys_j is None)
    if ys_j is not None:
        _close(ys_p, ys_j, tol)


def _algebra_graph():
    """A graph the registered cells do not cover: z1 reads concat(u, h), z2
    reads slices of z1 and of u through gate algebra, with a lane-function
    bias."""
    g = GraphBuilder()
    u = g.input("u", 3)
    h = g.state("h", 4)
    z1 = g.macc("z1", g.concat("cat", u, h), g.const("W1", (7, 6)), g.const("b1", (1, 6)))
    mix = g.concat("mix", g.slice("s0", z1, 4, 6), g.af("a", g.slice("s1", z1, 0, 3), "gelu"),
                   g.slice("uu", u, 1, 3))
    z2 = g.macc("z2", mix, g.const("W2", (7, 4)), g.sub("bias", h, g.af("t", h, "silu")))
    g.update("h", g.add("h_next", g.af("r", z2, "relu"), g.mul("hh", h, g.af("sg", h, "sigmoid"))))
    return g.build(output=z1)


def test_plan_lane_maps_on_a_macc_fed_through_gate_algebra():
    """A graph the registered cells do not cover: a macc whose input row is
    a concat of slices of another macc and of an input, and whose bias is a
    lane function — the lowering's lane arithmetic against eval_graph."""
    graph = _algebra_graph()
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
    # one hoisting GEMM per hoisted or split macc (z1), one persistent kernel
    assert src.count("__global__") == sum(m.hoist is not None for m in plan.maccs) + 1
    assert "int run_stage(void** bufs, int B, int T, int n_lut, void* stream_ptr)" in src
    assert "cublas" not in src.lower() and "cudnn" not in src.lower()


def _sum_graph():
    """A macc over u + h: the input reaches it only through gate algebra."""
    g = GraphBuilder()
    u = g.input("u", 4)
    h = g.state("h", 4)
    z = g.macc("z", g.add("uh", u, h), g.const("W", (4, 4)), g.const("b", (1, 4)))
    g.update("h", g.af("h_next", z, "tanh"))
    return g.build(output=z)


@pytest.mark.parametrize("name,want", [
    # (macc, kind, hoisted rows of W, bias moved with them)
    ("lstm", [("z", "split", (0, 5), True)]),
    ("gru", [("zx", "hoisted", (0, 5), True), ("zh", "recurrent", None, False)]),
    ("ssm", [("drive", "hoisted", (0, 5), True)]),
    ("mlp", [("z", "recurrent", None, False)]),
    ("algebra", [("z1", "split", (0, 3), True), ("z2", "recurrent", None, False)]),
    ("u_plus_h", [("z", "recurrent", None, False)]),
])
def test_lowering_classifies_each_macc(name, want):
    graphs = {"mlp": lambda: pcg.builders.mlp_graph(6, "tanh"), "algebra": _algebra_graph,
              "u_plus_h": _sum_graph}
    graph = graphs[name]() if name in graphs else pcg.CELL_GRAPHS[name](5, 4)
    plan = lower.lower(graph)
    assert [(m.name, m.kind, m.hoist, m.bias_hoisted) for m in plan.maccs] == want
    for m in plan.maccs:
        k0, k1 = m.step_rows
        hoisted = 0 if m.hoist is None else m.hoist[1] - m.hoist[0]
        assert k1 - k0 + hoisted == m.k
    layout = cuda_emit.buffer_layout(plan)
    assert [n for r, n in layout if r == "pre"] == [m.name for m in plan.maccs if m.hoist]
    assert layout[-1] == ("barrier", "barrier")


@pytest.mark.parametrize("name", sorted(KERNEL_CASES) + ["algebra"])
def test_split_interpreter_matches_unsplit(name):
    """The kernel's split of each macc, ``(x_in @ W_in + b) + x_state @
    W_state``, against one sum over the whole row, on every kernel case."""
    if name == "algebra":
        graph, qbits, lbits, B, T = _algebra_graph(), None, None, 3, 6
        steps = T
    else:
        cell, qbits, lbits, B, T = KERNEL_CASES[name]
        graph = pcg.builders.mlp_graph(6, "tanh") if cell == "mlp" \
            else pcg.CELL_GRAPHS[cell](3, 5)
        steps = 4 if T is None else T
    r = np.random.default_rng(11)
    consts = {}
    for n in graph.consts():
        shape = ((steps,) if n.attr("per_step") else ()) + tuple(n.attr("shape"))
        consts[n.name] = torch.as_tensor(r.normal(size=shape).astype(np.float32))
    qnames = tuple(graph.quantizable_weights()) if qbits else ()
    stage = Stage("s", graph, Schedule(steps=steps), consts)
    consts = kernel_backend.prequantize_consts(graph, consts, qbits)
    plan = lower.lower(graph, lut=lbits is not None, int8_weights=qnames)
    lut = None if lbits is None else make_lut(lbits)
    x0 = {s: torch.as_tensor(r.normal(size=(B, w)).astype(np.float32))
          for s, w in stage.graph.states.items()}
    inp = graph.input_node()
    us = None if inp is None else torch.as_tensor(
        r.normal(size=(B, steps, inp.width)).astype(np.float32))
    fin_s, ys_s = lower.interpret(plan, consts, x0, us, steps, lut, hoist=True)
    fin_u, ys_u = lower.interpret(plan, consts, x0, us, steps, lut, hoist=False)
    for k in fin_u:
        torch.testing.assert_close(fin_s[k], fin_u[k], atol=1e-5, rtol=1e-5)
    assert (ys_s is None) == (ys_u is None)
    if ys_u is not None:
        torch.testing.assert_close(ys_s, ys_u, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cell,D,H,sms,smem,resident,grid", [
    ("lstm", 1024, 1024, 132, 227 * 1024, True, 128),    # [1024, 4096] over 128 blocks
    ("gru", 1024, 1024, 132, 227 * 1024, True, 96),      # zh [1024, 3072] over 96
    ("lstm", 1024, 1024, 114, 227 * 1024, False, 114),   # 114 SMs: 2 slices, 256 KiB
    ("lstm", 1000, 400, 132, 227 * 1024, True, 50),      # the 1400-wide case
    ("lstm", 4096, 4096, 132, 227 * 1024, False, 132),   # 512 tiles: 4 slices of 512 KiB
    ("gru", 1024, 1024, 132, 100 * 1024, False, 96),     # a card with less shared memory
    ("lstm", 1024, 1024, 64, 227 * 1024, False, 64),     # fewer SMs: 2 slices a block
])
def test_residency_arithmetic(cell, D, H, sms, smem, resident, grid):
    """The one decision of grid and residency, and the constants the
    emitter writes from it into the source the card runs."""
    plan = lower.lower(pcg.CELL_GRAPHS[cell](D, H))
    got = cuda_emit.residency(plan, sm_count=sms, smem_limit=smem)
    assert (got["weights_resident"], got["grid"]) == (resident, grid)
    assert got["static_bytes"] + got["smem_bytes"] <= smem
    if resident:
        step = [m for m in plan.maccs if m.kind != "hoisted"][0]
        per_block = -(-(-(-step.n // cuda_emit.MACC_COLS)) // grid)
        assert got["smem_bytes"] >= per_block * H * cuda_emit.MACC_COLS * 4
    src = cuda_emit.emit(plan, sm_count=sms, smem_limit=smem)
    for name, v in (("GRID", grid), ("RESIDENT", int(resident)), ("SMEM", got["smem_bytes"])):
        assert f"constexpr int {name} = {v};" in src


def test_residency_keeps_int8_codes_and_skips_per_step_pages():
    g = pcg.CELL_GRAPHS["lstm"](1024, 2048)     # 2 slices a block: 512 KiB fp32, 128 KiB int8
    fp32 = cuda_emit.residency(lower.lower(g))
    int8 = cuda_emit.residency(lower.lower(g, int8_weights=tuple(g.quantizable_weights())))
    assert not fp32["weights_resident"] and int8["weights_resident"]   # 1/4 of the bytes
    mlp = cuda_emit.residency(lower.lower(pcg.builders.mlp_graph(1024, "tanh")))
    assert not mlp["weights_resident"]       # per-step pages are read at their step


@pytest.mark.parametrize("name,before,before_update,per_step", [
    ("lstm", {"z": False}, True, 2),
    ("gru", {"zh": False}, True, 2),
    ("ssm", {}, False, 1),                    # nothing in the step: only the closing barrier
    ("mlp", {"z": False}, True, 2),
    ("algebra", {"z1": False, "z2": True}, True, 3),   # z2's row reads z1 of the same step
    ("u_plus_h", {"z": False}, True, 2),
])
def test_barrier_plan_follows_what_each_phase_reads(name, before, before_update, per_step):
    """A grid barrier stands before each phase that reads a macc buffer
    other blocks wrote since the last one, and the emitted kernel runs
    exactly those."""
    graphs = {"mlp": lambda: pcg.builders.mlp_graph(6, "tanh"), "algebra": _algebra_graph,
              "u_plus_h": _sum_graph}
    graph = graphs[name]() if name in graphs else pcg.CELL_GRAPHS[name](5, 4)
    plan = lower.lower(graph)
    got = cuda_emit.barrier_plan(plan)
    assert (got["before"], got["before_update"], got["per_step"]) == \
        (before, before_update, per_step)
    src = cuda_emit.emit(plan)
    body = src[src.index("stage_persistent(Args args)"):src.index("cudaError_t stage_ready_()")]
    assert body.count("grid_sync(a.bar)") == per_step
    assert f"constexpr int BARRIERS_PER_STEP = {per_step};" in src


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
