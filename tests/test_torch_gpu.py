"""The port's CUDA kernels on the card, against their plain PyTorch versions:
``lstm_seq``, the generated stage kernel (``codegen_stage``), ``tanh_lut``,
``ssm_scan``, ``int8_matmul`` and ``flash_attention``; the bit path
(rtlsim, the golden model, the analyzer, the Verilog emission) on the card
against the same calls on the CPU, word for word; and the Fig. 10 tuner and
the chaos suite on the card.

Every test here needs a CUDA device (a CUDA kernel has no CPU mode) and
skips without one.  On a machine with the card (which has no JAX, so the
JAX-configuring ``tests/conftest.py`` is not loaded):

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_gpu.py

Tolerance: 1e-5 (atol = rtol) at small widths, 1e-4 at full width, where
fp32 sums over a 2048-long contraction are taken in another order than
cuBLAS's and compound over the time steps; 1e-6 for ``tanh_lut``, the same
arithmetic as its plain version up to FMA contraction; 1e-4 for ``ssm_scan``
(the same step-by-step recurrence, rounded differently by FMA contraction
and by the order of the sum over N; 3e-2 for bf16 inputs); ``int8_matmul``
bit-exact; 1e-5 for ``flash_attention`` in fp32 (an online softmax over key
tiles against one softmax over the row) and 2e-2 with bf16 inputs (the
result rounded to bf16).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's CUDA kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, B, T, D, H, seed=0):
    r = np.random.default_rng(seed)
    arrs = (r.normal(size=(B, T, D)), r.normal(size=(D, 4 * H)) / np.sqrt(D),
            r.normal(size=(H, 4 * H)) / np.sqrt(H), r.normal(size=(4 * H,)) * 0.2,
            r.normal(size=(B, H)), r.normal(size=(B, H)))
    return [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in arrs]


def _close(got, want, tol):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, atol=tol, rtol=tol)


@pytest.mark.parametrize("B,T,D,H,tol,resident", [
    (1, 16, 8, 8, 1e-5, True),
    (3, 7, 12, 16, 1e-5, True),       # prime T, ragged hidden tile
    (2, 1, 8, 8, 1e-5, True),         # T = 1
    (11, 5, 20, 36, 1e-5, True),      # B over one row tile, H not a multiple of 8
    (8, 37, 1024, 1024, 1e-4, True),  # full width: 128 blocks of 128 KiB slices
    (1, 256, 1024, 1024, 1e-4, True),  # the prefill shape
    (64, 9, 1024, 1024, 1e-4, True),   # 8 row tiles in every block
    (2, 5, 64, 2048, 1e-4, False),    # 256 unit tiles: w_h read from global memory
    (1, 1, 1024, 1024, 1e-4, True),   # T = 1 at full width: no barrier at all
])
def test_lstm_seq_kernel_matches_plain(cuda, B, T, D, H, tol, resident):
    from repro_torch.kernels.lstm_cell import kernel, ops

    assert kernel.config(B, H)["weights_resident"] is resident
    args = _case(cuda, B, T, D, H)
    _close(ops.lstm_seq(*args), ops.lstm_seq_ref(*args), tol)


@pytest.mark.parametrize("B,T,D,H,tol", [
    (2, 24, 8, 12, 2e-6),       # tests/test_recurrent.py's bar
    (4, 5, 1024, 1024, 1e-4),   # 4 rows of h and two 4096-entry tables: over 48 KB of smem
])
def test_lstm_seq_kernel_lut_mode(cuda, B, T, D, H, tol):
    from repro_torch.kernels.lstm_cell import ops
    from repro_torch.kernels.tanh_lut.ref import make_lut

    args = _case(cuda, B, T, D, H, seed=5)
    lut = make_lut(12, device=cuda)
    for g, w in zip(ops.lstm_seq(*args, lut=lut), ops.lstm_seq_lut_ref(*args, lut)):
        torch.testing.assert_close(g, w, atol=tol, rtol=max(tol, 1e-5))


def test_lstm_seq_kernel_resume_and_launch_count(cuda):
    """[0:T] == [0:T/2] then resumed from (h, c); one launch per call."""
    from repro_torch.kernels.lstm_cell import ops

    x, w_x, w_h, b, h0, c0 = _case(cuda, 2, 32, 8, 8, seed=4)
    ops.lstm_seq.launches = 0
    y, h, c = ops.lstm_seq(x, w_x, w_h, b, h0, c0)
    y_a, h_a, c_a = ops.lstm_seq(x[:, :16], w_x, w_h, b, h0, c0)
    y_b, h_b, c_b = ops.lstm_seq(x[:, 16:], w_x, w_h, b, h_a, c_a)
    assert ops.lstm_seq.launches == 3
    _close((torch.cat([y_a, y_b], 1), h_b, c_b), (y, h, c), 1e-5)


@pytest.mark.parametrize("B,T,D,H,chunk", [(2, 32, 8, 8, 16), (1, 256, 1024, 1024, 64),
                                           (3, 70, 1024, 1024, 64), (2, 9, 64, 2048, 4)])
def test_lstm_seq_kernel_chunked_resume_matches_one_shot(cuda, B, T, D, H, chunk):
    """A prefill in chunks, each resumed from the last chunk's (h, c), gives
    the one-shot result (the chunked serving path)."""
    from repro_torch.kernels.lstm_cell import ops

    x, w_x, w_h, b, h0, c0 = _case(cuda, B, T, D, H, seed=9)
    y, h, c = ops.lstm_seq(x, w_x, w_h, b, h0, c0)
    ys, hc, cc = [], h0, c0
    for t0 in range(0, T, chunk):
        y_k, hc, cc = ops.lstm_seq(x[:, t0:t0 + chunk], w_x, w_h, b, hc, cc)
        ys.append(y_k)
    _close((torch.cat(ys, 1), hc, cc), (y, h, c), 1e-5)


def _kernel_launches(fn) -> list[str]:
    """The CUDA kernel launches that ``fn`` makes, as torch.profiler's CUDA
    activity records them: the runtime's launch calls (``cudaLaunchKernel``,
    ``cudaLaunchCooperativeKernel``), each with the name of the kernel it
    started where the trace links the two (memsets and copies are not
    launches)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    kernels = {e.id: e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA}
    launches = []
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("cudaLaunch"):
            names = [k.name for k in getattr(e, "kernels", [])] or [kernels.get(e.id, e.name)]
            launches.append(names[0])
    return launches


@pytest.mark.parametrize("B,T,H", [(1, 256, 1024), (11, 7, 36), (2, 5, 2048)])
def test_lstm_seq_kernel_is_two_launches(cuda, B, T, H):
    from repro_torch.kernels.lstm_cell import ops

    args = _case(cuda, B, T, 64, H)
    ops.lstm_seq(*args)          # built and loaded outside the window
    names = _kernel_launches(lambda: ops.lstm_seq(*args))
    assert len(names) == 2, names


def test_grid_barrier_refuses_a_grid_too_large_and_raises_past_its_deadline(cuda):
    """A cooperative grid that cannot be co-resident is refused (never hangs),
    and a barrier one block never reaches raises after its 1 s deadline;
    the card stays usable after both."""
    from repro_torch.kernels.lstm_cell import kernel

    kernel.barrier_probe(8, 50)                     # a working barrier
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with pytest.raises(RuntimeError, match="launch failed"):
        kernel.barrier_probe(sms * 64, 1)           # 64 blocks of 256 threads an SM
    with pytest.raises(RuntimeError, match="deadline"):
        kernel.barrier_probe(8, 3, missing=5)
    kernel.barrier_probe(8, 50)
    x = torch.ones(4, device=cuda)
    assert float((x * 2).sum()) == 8.0


def test_lstm_seq_kernel_rejects_wrong_dtype(cuda):
    from repro_torch.kernels.lstm_cell import kernel

    x, w_x, w_h, b, h0, c0 = _case(cuda, 1, 4, 8, 8)
    with pytest.raises(ValueError, match="float32"):
        kernel.lstm_seq(x.double(), w_x, w_h, b, h0, c0)


def test_use_pallas_prefill_matches_plain_path(cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm

    cfg = get_smoke_config("paper-lstm")
    params = lm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    toks = torch.as_tensor([[3, 1, 4, 1, 5, 9, 2, 6, 5]], device=cuda)
    lg_p, c_p = lm.prefill(params, cfg, toks)
    lg_k, c_k = lm.prefill(params, dataclasses.replace(cfg, use_pallas=True), toks)
    torch.testing.assert_close(lg_k, lg_p, atol=1e-5, rtol=1e-5)
    _close(c_k["groups"]["b0_recurrent"].values(), c_p["groups"]["b0_recurrent"].values(), 1e-5)


@pytest.mark.parametrize("chunk", [0, 4])
def test_server_counts_the_prefill_kernels_host_round_trips(cuda, chunk):
    """Each lstm_seq call waits for its barrier word on the host: the server
    reports one round-trip per layer of every prefill call, apart from
    ``decode_syncs``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.lstm_cell import ops
    from repro_torch.models import lm
    from repro_torch.runtime.server import DecodeServer, Request

    cfg = dataclasses.replace(get_smoke_config("paper-lstm"), use_pallas=True)
    params = lm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    srv = DecodeServer(cfg, params, num_slots=2, max_seq=32, prefill_chunk=chunk)
    for i in range(3):
        srv.submit(Request(uid=i, prompt=[3, 1, 4, 1, 5, 9][: 3 + i], max_new_tokens=2))
    launches = ops.lstm_seq.launches
    srv.run_until_drained()
    calls = 3 if chunk == 0 else sum(-(-(3 + i) // chunk) for i in range(3))
    assert ops.lstm_seq.launches - launches == cfg.n_layers * calls
    assert srv.prefill_kernel_syncs == cfg.n_layers * calls


# ---------------------------------------------------------------------------
# the generated stage kernel (codegen) and the ROM-LUT tanh
# ---------------------------------------------------------------------------

def _chained_graph(D, H, n1):
    """Two step maccs in a chain, each wider than one 32-column tile: z1
    reads concat(u, h); z2 reads slices of z1 (both ends, so columns of
    several tiles) and of u through gate algebra, with a lane-function bias;
    the register update ends in tanh, so the chain stays bounded over T."""
    from repro_torch.codegen.ir import GraphBuilder

    g = GraphBuilder()
    u = g.input("u", D)
    h = g.state("h", H)
    z1 = g.macc("z1", g.concat("cat", u, h), g.const("W1", (D + H, n1)), g.const("b1", (1, n1)))
    mix = g.concat("mix", g.slice("s0", z1, n1 - 40, n1),
                   g.af("a", g.slice("s1", z1, 0, 33), "gelu"), g.slice("uu", u, 1, 3))
    z2 = g.macc("z2", mix, g.const("W2", (75, H)), g.sub("bias", h, g.af("t", h, "silu")))
    g.update("h", g.af("h_next", g.add("hz", g.af("r", z2, "relu"),
                                       g.mul("hh", h, g.af("sg", h, "sigmoid"))), "tanh"))
    return g.build(output=z1)


def _stage_case(dev, cell, D, H, B, T, seed=0, graph=None):
    """A bare cell stage (or ``graph``) with random weights, registers and
    inputs on ``dev``."""
    from repro_torch.codegen import CELL_GRAPHS, Schedule, Stage
    from repro_torch.codegen.builders import mlp_graph

    r = np.random.default_rng(seed)
    if graph is None:
        graph = mlp_graph(H, "tanh") if cell == "mlp" else CELL_GRAPHS[cell](D, H)
    steps = T
    consts = {}
    for n in graph.consts():
        shape = ((steps,) if n.attr("per_step") else ()) + tuple(n.attr("shape"))
        consts[n.name] = torch.as_tensor(
            r.normal(size=shape) / np.sqrt(max(shape[-2], 1)), dtype=torch.float32, device=dev)
    x0 = {s: torch.as_tensor(r.normal(size=(B, w)), dtype=torch.float32, device=dev)
          for s, w in graph.states.items()}
    us = None if cell == "mlp" else torch.as_tensor(
        r.normal(size=(B, T, D)), dtype=torch.float32, device=dev)
    return Stage(cell, graph, Schedule(steps=steps), consts), consts, x0, us


@pytest.mark.parametrize("cell,D,H,B,T,quant,lut_bits,tol,resident", [
    ("lstm", 8, 8, 1, 16, None, None, 1e-5, True),
    ("lstm", 12, 20, 11, 7, None, None, 1e-5, True),     # B over one row tile, prime T
    ("gru", 9, 5, 3, 1, None, None, 1e-5, True),         # T = 1
    ("ssm", 16, 33, 9, 5, None, None, 1e-5, False),      # all hoisted: nothing in the step
    ("mlp", 0, 32, 64, 31, None, None, 1e-5, False),     # per-step ROM pages (FIG10_B width)
    ("lstm", 8, 12, 2, 9, None, 8, 1e-5, True),          # LUT gates
    ("gru", 8, 12, 2, 9, 8, None, 1e-5, True),           # int8 shared ROMs, resident as codes
    ("mlp", 0, 16, 5, 6, 8, None, 1e-5, False),          # int8 per-step pages
    ("lstm", 1024, 1024, 8, 37, None, None, 1e-4, True),  # full width
    ("lstm", 1024, 1024, 1, 256, None, None, 1e-4, True),  # the prefill shape
    ("gru", 1024, 1024, 1, 256, None, None, 1e-4, True),
    ("lstm", 1000, 400, 8, 3, None, None, 1e-4, True),    # the 1400-wide case
    ("lstm", 64, 2048, 2, 5, None, None, 1e-4, False),    # 2 slices a block: read from global
    ("gru", 64, 2048, 2, 5, 8, None, 1e-4, True),         # the same as int8 codes: resident
    ("lstm", 1024, 1024, 64, 5, None, None, 1e-4, True),  # B = 64: 8 row tiles a block
    ("lstm", 1024, 1024, 3, 1, None, None, 1e-4, True),   # T = 1 at full width
])
def test_codegen_stage_kernel_matches_plain(cuda, cell, D, H, B, T, quant, lut_bits, tol,
                                            resident):
    from repro_torch.codegen import eager_backend, kernel_backend, lower
    from repro_torch.kernels.tanh_lut.ref import make_lut

    stage, consts, x0, us = _stage_case(cuda, cell, D, H, B, T)
    lut = None if lut_bits is None else make_lut(lut_bits, device=cuda)
    run = kernel_backend.compile_stage(stage, lut=lut, quant_bits=quant)
    packed = kernel_backend.prequantize_consts(stage.graph, consts, quant)
    launches = kernel_backend.codegen_stage.launches
    fin, ys = run(packed, x0, us)
    assert kernel_backend.codegen_stage.launches == launches + 1
    torch.cuda.synchronize()
    assert kernel_backend.launch_config(run.source)["weights_resident"] is resident
    for hoist in (True, False):      # the kernel's split, and one sum over the row
        fin_p, ys_p = lower.interpret(run.plan, packed, x0, us, T, lut, hoist=hoist)
        _close(list(fin.values()) + ([] if ys is None else [ys]),
               [fin_p[k] for k in fin] + ([] if ys_p is None else [ys_p]), tol)
    if quant is None and lut is None and cell != "mlp":   # the independent oracle
        fin_e, ys_e = eager_backend.compile_stage(stage)(consts, x0, us)
        _close([fin[k] for k in fin_e] + [ys], list(fin_e.values()) + [ys_e], tol)


@pytest.mark.parametrize("D,H,n1,B,T", [
    (16, 64, 96, 3, 7),       # z1 over 3 tiles, z2 over 2
    (24, 200, 256, 11, 5),    # 8 tiles of z1, B over one row tile
])
def test_codegen_chained_step_maccs_match_plain(cuda, D, H, n1, B, T):
    """A step macc that reads another of the same step, across column tiles
    that other blocks compute: the grid barrier between them."""
    from repro_torch.codegen import eager_backend, kernel_backend, lower

    stage, consts, x0, us = _stage_case(cuda, "chained", D, H, B, T,
                                        graph=_chained_graph(D, H, n1))
    run = kernel_backend.compile_stage(stage)
    assert [m.kind for m in run.plan.maccs] == ["split", "recurrent"]
    cfg = kernel_backend.launch_config(run.source)
    assert cfg["barriers_per_step"] == 3 and cfg["grid"] >= 3
    fin, ys = run(consts, x0, us)
    torch.cuda.synchronize()
    for hoist in (True, False):
        fin_p, ys_p = lower.interpret(run.plan, consts, x0, us, T, hoist=hoist)
        _close([fin["h"], ys], [fin_p["h"], ys_p], 1e-5)
    fin_e, ys_e = eager_backend.compile_stage(stage)(consts, x0, us)
    _close([fin["h"], ys], [fin_e["h"], ys_e], 1e-5)


def test_codegen_cslow_batch_matches_plain(cuda):
    """C-slow 4 over B = 16 of the Fig. 10 MLP: the kernel's batch of 64
    carries every stream."""
    from repro_torch.codegen import build_program, eager_backend, kernel_backend, lower
    from repro_torch.configs.paper_mlp import FIG10_B
    from repro_torch.core.cslow import fold_streams, unfold_streams

    spec = dataclasses.replace(FIG10_B, c_slow=4)
    prog = build_program(spec, cuda)
    u = torch.as_tensor(np.random.default_rng(2).normal(size=(4, 16, spec.num_inputs)),
                        dtype=torch.float32, device=cuda)
    y_k = kernel_backend.compile_program(prog)(prog.params, u)
    st = prog.stages[0]
    x0 = {"x": fold_streams(u) @ prog.beta.T}
    for hoist in (True, False):
        fin_p, _ = lower.interpret(kernel_backend.compile_stage(st).plan, st.params, x0, None,
                                   st.schedule.steps, hoist=hoist)
        _close([y_k], [unfold_streams(fin_p["x"] @ prog.C.T, 4)], 1e-5)
    _close([y_k], [eager_backend.compile_program(prog)(prog.params, u)], 1e-5)


@pytest.mark.parametrize("cell,want", [("lstm", 2), ("gru", 2), ("ssm", 2), ("mlp", 1)])
def test_codegen_stage_kernel_launches_per_call(cuda, cell, want):
    """One GEMM per hoisted or split macc and one persistent launch: two for
    a stage with an input, one for an autonomous stage."""
    from repro_torch.codegen import kernel_backend

    stage, consts, x0, us = _stage_case(cuda, cell, 64, 96, 2, 12)
    run = kernel_backend.compile_stage(stage)
    run(consts, x0, us)
    names = _kernel_launches(lambda: run(consts, x0, us))
    assert len(names) == want, names


def test_codegen_use_codegen_prefill_matches_plain_path(cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm

    for cell in ("lstm", "gru"):
        cfg = dataclasses.replace(get_smoke_config("paper-lstm"), rnn_cell=cell)
        params = lm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
        toks = torch.as_tensor([[3, 1, 4, 1, 5, 9, 2, 6, 5]], device=cuda)
        lg_p, _ = lm.prefill(params, cfg, toks)
        lg_k, _ = lm.prefill(params, dataclasses.replace(cfg, use_codegen=True), toks)
        torch.testing.assert_close(lg_k, lg_p, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("size,bits", [(1, 6), (1023, 8), (1 << 20, 12), (77777, 14)])
def test_tanh_lut_kernel_matches_plain(cuda, size, bits):
    from repro_torch.kernels.tanh_lut import ops
    from repro_torch.kernels.tanh_lut.ref import make_lut, tanh_lut_ref

    x = torch.randn(size, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1)) * 3
    lut = make_lut(bits, device=cuda)
    launches = ops.tanh_lut.launches
    y = ops.tanh_lut(x, lut)
    assert ops.tanh_lut.launches == launches + 1
    torch.testing.assert_close(y, tanh_lut_ref(x, lut), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# the selective scan and the int8 MACC matmul
# ---------------------------------------------------------------------------

def _scan_case(dev, Bsz, T, D, N, seed=0, carry=False):
    r = np.random.default_rng(seed)
    arrs = [r.normal(size=(Bsz, T, D)), r.uniform(0.001, 0.8, size=(Bsz, T, D)),
            -np.exp(r.normal(size=(D, N)) * 0.5), r.normal(size=(Bsz, T, N)),
            r.normal(size=(Bsz, T, N)),
            r.normal(size=(Bsz, D, N)) if carry else np.zeros((Bsz, D, N))]
    return [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in arrs]


@pytest.mark.parametrize("Bsz,T,D,N", [
    (1, 32, 8, 4), (2, 64, 32, 8), (3, 97, 1000, 16),   # prime T, ragged D
    (2, 1, 7, 16),                                      # T = 1
    (1, 40, 24, 1), (1, 33, 40, 5), (2, 19, 9, 40),     # N: 1, odd, two states a lane
    (1, 9, 6, 128),                                     # the widest N taken
    (1, 256, 8192, 16),                                 # a falcon-mamba-7b prefill
])
@pytest.mark.parametrize("carry", [False, True])
def test_ssm_scan_kernel_matches_plain(cuda, Bsz, T, D, N, carry):
    from repro_torch.kernels.ssm_scan import ops

    x, dl, A, B, C, h0 = _scan_case(cuda, Bsz, T, D, N, seed=T + N, carry=carry)
    launches = ops.ssm_scan.launches
    got = ops.ssm_scan(x, dl, A, B, C, h0=h0 if carry else None)
    assert ops.ssm_scan.launches == launches + 1
    torch.cuda.synchronize()
    _close(got, ops.ssm_scan_ref(x, dl, A, B, C, h0), 1e-4)


def test_ssm_scan_kernel_bf16_and_resume(cuda):
    """bf16 inputs are computed in fp32 (y in bf16, h in fp32); a scan split
    at any step and resumed from h_final gives the one-shot bits."""
    from repro_torch.kernels.ssm_scan import ops

    x, dl, A, B, C, h0 = _scan_case(cuda, 2, 70, 48, 16, seed=3)
    bf = [t.to(torch.bfloat16) for t in (x, dl, B, C)]
    y, h = ops.ssm_scan(bf[0], bf[1], A, bf[2], bf[3])
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    y_r, h_r = ops.ssm_scan_ref(bf[0], bf[1], A, bf[2], bf[3], h0)
    torch.testing.assert_close(y.float(), y_r, atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(h, h_r, atol=1e-4, rtol=1e-4)
    y_full, h_full = ops.ssm_scan(x, dl, A, B, C)
    y1, h_mid = ops.ssm_scan(x[:, :37], dl[:, :37], A, B[:, :37], C[:, :37])
    y2, h_end = ops.ssm_scan(x[:, 37:].contiguous(), dl[:, 37:].contiguous(), A,
                             B[:, 37:].contiguous(), C[:, 37:].contiguous(), h0=h_mid)
    assert torch.equal(torch.cat([y1, y2], 1), y_full) and torch.equal(h_end, h_full)


@pytest.mark.parametrize("T", [24, 64, 255])
def test_ssm_scan_kernel_at_served_lengths(cuda, T):
    """falcon-mamba-7b's width at prompt lengths the server prefills: a short
    prompt, the chunked prefill's chunk, and one step short of 256 (a ragged
    last chunk and a tail past the unrolled steps)."""
    from repro_torch.kernels.ssm_scan import ops

    x, dl, A, B, C, h0 = _scan_case(cuda, 1, T, 8192, 16, seed=T)
    got = ops.ssm_scan(x, dl, A, B, C)
    torch.cuda.synchronize()
    _close(got, ops.ssm_scan_ref(x, dl, A, B, C, h0), 1e-4)


@pytest.mark.parametrize("Bsz,T,D,N", [
    (1, 21, 12, 2), (2, 17, 9, 3),                      # two and three states on one lane
    (1, 40, 33, 6), (1, 29, 24, 13),                    # a lane's four states cut short
    (2, 45, 20, 100),                                   # 32 lanes, 28 padded states
])
@pytest.mark.parametrize("carry", [False, True])
def test_ssm_scan_kernel_ragged_states(cuda, Bsz, T, D, N, carry):
    """N that the kernel's 4 states a lane do not divide: the padded states
    stay zero and add nothing to y."""
    from repro_torch.kernels.ssm_scan import ops

    x, dl, A, B, C, h0 = _scan_case(cuda, Bsz, T, D, N, seed=7 * N + T, carry=carry)
    got = ops.ssm_scan(x, dl, A, B, C, h0=h0 if carry else None)
    torch.cuda.synchronize()
    _close(got, ops.ssm_scan_ref(x, dl, A, B, C, h0), 1e-4)


@pytest.mark.parametrize("D,N,split", [(8192, 16, 101), (8192, 16, 3), (1000, 16, 61),
                                       (48, 13, 29), (40, 128, 45)])
def test_ssm_scan_kernel_resume_off_the_unroll(cuda, D, N, split):
    """A scan split at a step that is neither a multiple of the 8 unrolled
    steps nor of the 32-step chunk, resumed from h_final, gives the one-shot
    bits: every step rounds the same way wherever it falls."""
    from repro_torch.kernels.ssm_scan import ops

    x, dl, A, B, C, _ = _scan_case(cuda, 1, 200, D, N, seed=split)
    y_full, h_full = ops.ssm_scan(x, dl, A, B, C)
    y1, h_mid = ops.ssm_scan(x[:, :split], dl[:, :split], A, B[:, :split], C[:, :split])
    y2, h_end = ops.ssm_scan(x[:, split:], dl[:, split:], A, B[:, split:], C[:, split:],
                             h0=h_mid)
    assert torch.equal(torch.cat([y1, y2], 1), y_full) and torch.equal(h_end, h_full)


def test_ssm_scan_kernel_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels.ssm_scan import kernel

    x, dl, A, B, C, _ = _scan_case(cuda, 1, 4, 8, 4)
    with pytest.raises(ValueError, match="float32"):
        kernel.ssm_scan(x.double(), dl, A, B, C)
    x, dl, A, B, C, _ = _scan_case(cuda, 1, 2, 3, 129)
    with pytest.raises(ValueError, match="N <= 128"):
        kernel.ssm_scan(x, dl, A, B, C)


def test_mamba1_use_pallas_prefill_matches_plain_path(cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.ssm_scan import ops
    from repro_torch.models import lm

    cfg = get_smoke_config("falcon-mamba-7b")
    params = lm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    toks = torch.as_tensor([[3, 1, 4, 1, 5, 9, 2, 6, 5]], device=cuda)
    lg_p, c_p = lm.prefill(params, cfg, toks)
    launches = ops.ssm_scan.launches
    lg_k, c_k = lm.prefill(params, dataclasses.replace(cfg, use_pallas=True), toks)
    assert ops.ssm_scan.launches == launches + cfg.n_layers
    torch.testing.assert_close(lg_k, lg_p, atol=1e-5, rtol=1e-5)
    _close(c_k["groups"]["b0_mamba1"].values(), c_p["groups"]["b0_mamba1"].values(), 1e-5)


@pytest.mark.parametrize("M,K,N", [(32, 64, 16), (33, 100, 77), (3, 5, 7), (1, 4096, 8192),
                                   (256, 4096, 512), (130, 65, 200), (130, 4112, 144),
                                   (257, 48, 8200)])
def test_int8_matmul_kernel_bit_exact(cuda, M, K, N):
    from repro_torch.kernels.int8_matmul import ops

    r = np.random.default_rng(M + K + N)
    a = torch.as_tensor(r.integers(-128, 128, size=(M, K)), dtype=torch.int8, device=cuda)
    b = torch.as_tensor(r.integers(-128, 128, size=(K, N)), dtype=torch.int8, device=cuda)
    a_s = torch.as_tensor(r.uniform(0.01, 0.1, size=(M, 1)), dtype=torch.float32, device=cuda)
    b_s = torch.as_tensor(r.uniform(0.01, 0.1, size=(1, N)), dtype=torch.float32, device=cuda)
    launches = ops.int8_matmul.launches
    got = ops.int8_matmul(a, b, a_s, b_s)
    assert ops.int8_matmul.launches == launches + 1
    want = ops.int8_matmul_ref(a, b, a_s, b_s)
    assert torch.equal(got, want)
    # the plain version on the card (float64 accumulate) equals the CPU's int32 one
    assert torch.equal(want.cpu(), ops.int8_matmul_ref(a.cpu(), b.cpu(), a_s.cpu(), b_s.cpu()))


def test_int8_matmul_kernel_unaligned_operands(cuda):
    """Operands that start one byte into their storage take the byte-wise
    loads and give the same bits."""
    from repro_torch.kernels.int8_matmul import ops

    M, K, N = 64, 128, 256
    r = np.random.default_rng(7)
    a_buf = torch.as_tensor(r.integers(-128, 128, size=M * K + 1), dtype=torch.int8, device=cuda)
    b_buf = torch.as_tensor(r.integers(-128, 128, size=K * N + 1), dtype=torch.int8, device=cuda)
    a, b = a_buf[1:].view(M, K), b_buf[1:].view(K, N)
    a_s = torch.as_tensor(r.uniform(0.01, 0.1, size=(M, 1)), dtype=torch.float32, device=cuda)
    b_s = torch.as_tensor(r.uniform(0.01, 0.1, size=(1, N)), dtype=torch.float32, device=cuda)
    assert a.data_ptr() % 16 and b.data_ptr() % 8
    assert torch.equal(ops.int8_matmul(a, b, a_s, b_s), ops.int8_matmul_ref(a, b, a_s, b_s))


def test_quantized_matmul_on_the_card_matches_the_cpu(cuda):
    from repro_torch.kernels.int8_matmul import ops

    r = np.random.default_rng(0)
    a = torch.as_tensor(r.normal(size=(64, 300)), dtype=torch.float32)
    b = torch.as_tensor(r.normal(size=(300, 96)), dtype=torch.float32)
    got = ops.quantized_matmul(a.to(cuda), b.to(cuda))
    assert torch.equal(got.cpu(), ops.quantized_matmul(a, b))


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

# tests/test_kernels.py's five cases, then S != T, S = T = 1, rows that see
# no key (S > T with a window), and hd 128 with gemma3's 1024 window
FLASH_CASES = [
    dict(B=2, S=64, T=64, H=4, KV=2, hd=32, causal=True, window=0, softcap=0.0),
    dict(B=1, S=128, T=128, H=8, KV=8, hd=64, causal=True, window=32, softcap=0.0),
    dict(B=2, S=64, T=64, H=4, KV=1, hd=16, causal=False, window=0, softcap=0.0),
    dict(B=1, S=96, T=96, H=2, KV=2, hd=80, causal=True, window=0, softcap=20.0),
    dict(B=1, S=64, T=64, H=9, KV=3, hd=64, causal=True, window=0, softcap=0.0),
    dict(B=1, S=37, T=100, H=4, KV=2, hd=32, causal=True, window=0, softcap=0.0),
    dict(B=1, S=1, T=1, H=3, KV=1, hd=16, causal=True, window=0, softcap=0.0),
    dict(B=2, S=100, T=37, H=4, KV=2, hd=32, causal=True, window=8, softcap=0.0),
    dict(B=1, S=1300, T=1300, H=4, KV=2, hd=128, causal=True, window=1024, softcap=0.0),
]


def _flash_case(dev, c, dtype, seed=0):
    r = np.random.default_rng(seed)
    arrs = (r.normal(size=(c["B"], c["S"], c["H"], c["hd"])),
            r.normal(size=(c["B"], c["T"], c["KV"], c["hd"])),
            r.normal(size=(c["B"], c["T"], c["KV"], c["hd"])))
    return [torch.as_tensor(a, dtype=torch.float32, device=dev).to(dtype) for a in arrs]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: f"S{c['S']}_T{c['T']}_H{c['H']}_hd{c['hd']}_w{c['window']}")
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):
    from repro_torch.kernels.flash_attention import kernel, ops

    q, k, v = _flash_case(cuda, case, dtype)
    kw = {n: case[n] for n in ("causal", "window", "softcap")}
    calls, launches = ops.flash_attention.calls, ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, **kw)
    n_splits = kernel.splits(q, k, causal=case["causal"], window=case["window"])
    assert ops.flash_attention.calls == calls + 1
    assert ops.flash_attention.launches == launches + kernel.launches_per_call(n_splits)
    want = ops.flash_attention_ref(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape and bool(torch.isfinite(got).all())
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("S", [24, 64, 256])
def test_flash_attention_kernel_at_smollm_served_shapes(cuda, S, dtype):
    """smollm-135m's one-shot prefills: S = T of 24-256 tokens, 9 heads over
    3 kv heads, hd 64: 9 to 36 blocks, most of the first one's rows past S."""
    from repro_torch.kernels.flash_attention import ops

    c = dict(B=1, S=S, T=S, H=9, KV=3, hd=64)
    q, k, v = _flash_case(cuda, c, dtype, seed=S)
    got = ops.flash_attention(q, k, v)
    want = ops.flash_attention_ref(q, k, v)
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [2048, 4096])
def test_flash_attention_kernel_at_long_prompts(cuda, S, causal):
    """A block sums up to S keys at hd 128 (no window, no key split at these
    grids): the error must not grow with them past the fp32 bar."""
    from repro_torch.kernels.flash_attention import ops

    c = dict(B=1, S=S, T=S, H=8, KV=4, hd=128)
    q, k, v = _flash_case(cuda, c, torch.float32, seed=S + causal)
    torch.testing.assert_close(ops.flash_attention(q, k, v, causal=causal),
                               ops.flash_attention_ref(q, k, v, causal=causal),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hd,causal,window,softcap", [(20, True, 0, 0.0), (20, False, 5, 0.0),
                                                      (7, True, 0, 15.0), (130, True, 0, 0.0)])
def test_flash_attention_kernel_head_dim_not_a_multiple_of_8(cuda, hd, causal, window, softcap):
    """hd padded with zeros to the instantiated width (20 -> 32, 7 -> 16,
    130 -> 192); hd 7 and 130 also take the 4-byte copies."""
    from repro_torch.kernels.flash_attention import ops

    c = dict(B=2, S=45, T=45, H=4, KV=2, hd=hd)
    q, k, v = _flash_case(cuda, c, torch.float32, seed=hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    torch.testing.assert_close(ops.flash_attention(q, k, v, **kw),
                               ops.flash_attention_ref(q, k, v, **kw), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S,T,window,softcap", [(63, 63, 0, 0.0), (65, 65, 0, 0.0),
                                                 (129, 129, 40, 0.0), (80, 200, 0, 0.0),
                                                 (200, 80, 17, 0.0), (130, 130, 0, 25.0)])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_kernel_at_tile_edges(cuda, S, T, window, softcap, hd):
    """Lengths one short of and one past the 64-query tile and the 64- or
    32-key tile (hd 64 and 128), S != T both ways, with a window whose
    rows skip different key tiles warp by warp, against the plain version at
    the fp32 bar."""
    from repro_torch.kernels.flash_attention import ops

    c = dict(B=1, S=S, T=T, H=4, KV=2, hd=hd)
    q, k, v = _flash_case(cuda, c, torch.float32, seed=S + T + hd)
    kw = dict(causal=True, window=window, softcap=softcap)
    torch.testing.assert_close(ops.flash_attention(q, k, v, **kw),
                               ops.flash_attention_ref(q, k, v, **kw), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n_splits", [1, 2, 3, 8])
@pytest.mark.parametrize("case", [FLASH_CASES[i] for i in (0, 1, 3, 5, 7, 8)],
                         ids=lambda c: f"S{c['S']}_T{c['T']}_H{c['H']}_hd{c['hd']}_w{c['window']}")
def test_flash_attention_kernel_key_splits(cuda, case, n_splits):
    """The key axis shared among n blocks and merged by the second launch
    (more shares than a q tile has key tiles leave some empty), on masks,
    windows, softcap, S != T and rows that see no key, against the plain
    version at the fp32 bar."""
    from repro_torch.kernels.flash_attention import kernel, ops

    q, k, v = _flash_case(cuda, case, torch.float32, seed=n_splits)
    kw = {n: case[n] for n in ("causal", "window", "softcap")}
    torch.testing.assert_close(kernel.flash_attention(q, k, v, n_splits=n_splits, **kw),
                               ops.flash_attention_ref(q, k, v, **kw), atol=1e-5, rtol=1e-5)


def test_flash_attention_kernel_splits_only_a_short_grid(cuda):
    """The host splits the key axis only when the (b, h, q tile) blocks fill
    fewer than the card's SMs, and then into at most as many shares as the
    longest q tile has key tiles; each split call is two launches."""
    from repro_torch.kernels.flash_attention import kernel

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for (S, H, KV, hd) in ((2048, 24, 8, 128), (256, 9, 3, 64), (64, 9, 3, 64), (1000, 1, 1, 32)):
        q, k, _ = _flash_case(cuda, dict(B=1, S=S, T=S, H=H, KV=KV, hd=hd), torch.float32)
        n = kernel.splits(q, k)
        blocks = H * -(-S // kernel.Q_TILE)
        bk = 64 if hd <= 64 else 32
        assert 1 <= n <= kernel.MAX_SPLITS
        assert n == 1 if blocks >= sms else n <= -(-S // bk)
    q, k, v = _flash_case(cuda, dict(B=1, S=256, T=256, H=9, KV=3, hd=64), torch.float32)
    if kernel.splits(q, k) > 1:
        from torch.profiler import ProfilerActivity, profile

        kernel.flash_attention(q, k, v)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            kernel.flash_attention(q, k, v)
            torch.cuda.synchronize()
        assert sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU
                   and e.name.startswith("cudaLaunch")) == 2


def test_flash_attention_kernel_takes_strided_views(cuda):
    """q, k, v as the attention block hands them over: slices of one fused
    projection, not contiguous; the wrapper makes them so."""
    from repro_torch.kernels.flash_attention import ops

    r = np.random.default_rng(3)
    qkv = torch.as_tensor(r.normal(size=(2, 40, 6 + 2 + 2, 32)), dtype=torch.float32, device=cuda)
    q, k, v = qkv[:, :, :6], qkv[:, :, 6:8], qkv[:, :, 8:]
    assert not q.is_contiguous()
    torch.testing.assert_close(ops.flash_attention(q, k, v), ops.flash_attention_ref(q, k, v),
                               atol=1e-5, rtol=1e-5)


def test_flash_attention_kernel_rejects_what_it_does_not_take(cuda):
    """No fallback: a CPU tensor handed to the kernel, or a shape it does not
    take on the card, raises instead of running the plain version."""
    from repro_torch.kernels.flash_attention import kernel, ops

    q, k, v = _flash_case(cuda, FLASH_CASES[0], torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel.flash_attention(q.cpu(), k.cpu(), v.cpu())
    with pytest.raises(ValueError, match="float32"):
        kernel.flash_attention(q.double(), k, v)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.flash_attention(q.transpose(1, 2), k, v)
    launches = ops.flash_attention.launches
    for bad in ((q, k[:, :, :1].expand(-1, -1, 3, -1), v),      # H = 4 not a multiple of KV = 3
                (q, k, v[:, :10]),                                # k and v of different lengths
                (q[..., :0], k[..., :0], v[..., :0])):            # hd = 0
        with pytest.raises(ValueError):
            ops.flash_attention(*bad)
    big = torch.zeros((1, 2, 1, 257), device=cuda)
    with pytest.raises(ValueError, match="hd <= 256"):
        ops.flash_attention(big, big, big)
    assert ops.flash_attention.launches == launches


def test_dense_use_pallas_prefill_matches_plain_path(cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import lm

    for arch in ("smollm-135m", "phi4-mini-3.8b"):
        cfg = get_smoke_config(arch)
        params = lm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
        toks = torch.as_tensor([[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]], device=cuda)
        lg_p, c_p = lm.prefill(params, cfg, toks)
        launches = ops.flash_attention.launches
        lg_k, c_k = lm.prefill(params, dataclasses.replace(cfg, use_pallas=True), toks)
        assert ops.flash_attention.launches == launches + cfg.n_layers
        torch.testing.assert_close(lg_k, lg_p, atol=1e-5, rtol=1e-5)
        _close(c_k["groups"]["b0_attn"].values(), c_p["groups"]["b0_attn"].values(), 1e-5)


# ---------------------------------------------------------------------------
# the serving stack's state on the card: prefix-cache checkpoints, faults
# ---------------------------------------------------------------------------

SHARED_PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]          # two chunks of 4
LONG_PROMPT = SHARED_PROMPT + [8, 7, 8, 2, 5]


def _served_entries(cfg, params, cuda, prompts, cache=True):
    """Serve ``prompts`` one after another (chunks of 4) with or without the
    prefix cache; returns the tokens and the server."""
    from repro_torch.runtime import DecodeServer, Request

    srv = DecodeServer(cfg, params, num_slots=2, max_seq=48, prefill_chunk=4,
                       prefix_cache_bytes=(64 << 20) if cache else 0, device=cuda)
    toks = []
    for uid, prompt in enumerate(prompts):
        srv.submit(Request(uid=uid, prompt=list(prompt), max_new_tokens=5))
        toks.append(list(srv.run_until_drained()[-1].out_tokens))
    return toks, srv


def _entry(srv, length):
    (node,) = [n for n in srv.prefix_cache._entry_nodes if n.entry.length == length]
    return node.entry


def test_mamba1_prefill_resumed_from_a_stored_checkpoint_on_the_card(cuda):
    """A chunked falcon-mamba prefill resumed from a stored boundary state
    (through ``ssm_scan``'s h0) gives the cold run's tokens and the cold
    run's state bits at the prompt's end."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.ssm_scan import ops
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_smoke_config("falcon-mamba-7b"), use_pallas=True)
    params = lm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    cold_toks, cold = _served_entries(cfg, params, cuda, [LONG_PROMPT])
    launches = ops.ssm_scan.launches
    warm_toks, warm = _served_entries(cfg, params, cuda, [SHARED_PROMPT, LONG_PROMPT])
    assert warm.stats()["prefix_cache"]["partial_hits"] == 1
    # 2 chunks for the shared prompt, 2 more (8..12, 12..13) for the resume
    assert ops.ssm_scan.launches - launches == 4 * cfg.n_layers
    assert warm_toks[1] == cold_toks[0]
    got, want = _entry(warm, len(LONG_PROMPT)), _entry(cold, len(LONG_PROMPT))
    for g, w in zip(tree_leaves(got.caches) + [got.logits], tree_leaves(want.caches) + [want.logits]):
        assert g.device.type == "cuda" and torch.equal(g, w)


@pytest.mark.parametrize("arch", ["smollm-135m", "falcon-mamba-7b", "paper-lstm"])
def test_stored_checkpoints_on_the_card_are_not_aliased(cuda, arch):
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_smoke_config(arch), use_pallas=True)
    params = lm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    _, srv = _served_entries(cfg, params, cuda, [LONG_PROMPT])
    entries = [n.entry for n in srv.prefix_cache._entry_nodes]
    before = [[t.clone() for t in tree_leaves(e.caches) + [e.logits]] for e in entries]
    from repro_torch.runtime import Request

    rng = np.random.default_rng(0)
    for uid in range(1, 5):
        prompt = SHARED_PROMPT[:4] + [int(t) for t in rng.integers(1, cfg.vocab, 7)]
        srv.submit(Request(uid=uid, prompt=prompt, max_new_tokens=6))
    srv.submit(Request(uid=9, prompt=list(LONG_PROMPT), max_new_tokens=6))
    srv.run_until_drained()
    torch.cuda.synchronize()
    assert srv.stats()["prefix_cache"]["hits"] == 1
    for e, want in zip(entries, before):
        for t, w in zip(tree_leaves(e.caches) + [e.logits], want):
            assert t.device.type == "cuda" and torch.equal(t, w)


def test_injected_compile_fault_hops_and_a_real_launch_error_does_not(cuda, monkeypatch):
    from repro_torch import obs
    from repro_torch.codegen import kernel_backend
    from repro_torch.core import synthesis
    from repro_torch.runtime import faults

    spec = synthesis.NetworkSpec(4, 2, 8, 2, cell="gru", seq_len=5)
    m = obs.OBS.metrics
    hops = lambda: int(m.value("synth_fallback", from_backend="kernel", to="eager"))  # noqa: E731
    synthesis.synthesize_cache_clear()
    before, retries = hops(), int(m.value("synth_retries"))
    plan = faults.FaultPlan([faults.FaultSpec("synth.compile", times=3)], seed=0)
    with faults.active(plan):
        rep = synthesis.synthesize(spec, batch=2, backend="kernel", backoff_s=0.0, device=cuda)
    assert (rep.backend, rep.fallback_from) == ("eager", "kernel")
    assert hops() == before + 1 and int(m.value("synth_retries")) == retries + 2
    # the degraded report is not memoized: a fault-free call runs the kernel
    launches = kernel_backend.codegen_stage.launches
    rep = synthesis.synthesize(spec, batch=2, backend="kernel", device=cuda)
    assert (rep.backend, rep.fallback_from, rep.cache_hit) == ("kernel", None, False)
    assert kernel_backend.codegen_stage.launches > launches

    # a launch that the card refuses raises through synthesize(fallback=True)
    real_bind = kernel_backend._bind

    class Refused:
        def __init__(self, lib):
            self._lib = lib

        def __getattr__(self, name):
            return getattr(self._lib, name)

        def run_stage(self, *args):
            return 2            # as a launch that fails with cudaErrorMemoryAllocation

    monkeypatch.setattr(kernel_backend, "_bind", lambda lib: Refused(real_bind(lib)))
    synthesis.synthesize_cache_clear()
    launches = kernel_backend.codegen_stage.launches
    with faults.active(faults.FaultPlan([], seed=0)), \
            pytest.raises(RuntimeError, match="codegen_stage kernel launch failed"):
        synthesis.synthesize(spec, batch=2, backend="kernel", fallback=True, device=cuda)
    assert hops() == before + 1 and kernel_backend.codegen_stage.launches == launches
    assert synthesis.synthesize_cache_info() == {"entries": 0}


# ---------------------------------------------------------------------------
# the bit path on the card: rtlsim, the golden model, the analyzer's
# products and the Verilog emission, each equal to the same call on the CPU
# ---------------------------------------------------------------------------

def _program_on(prog, dev):
    """``prog`` with every weight moved to ``dev``."""
    return dataclasses.replace(
        prog, C=prog.C.to(dev), beta=None if prog.beta is None else prog.beta.to(dev),
        stages=[dataclasses.replace(st, params={k: v.to(dev) for k, v in st.params.items()})
                for st in prog.stages])


def _bit_inputs(spec, scale, seed=0):
    shape = (3, spec.num_inputs) if spec.cell == "mlp" else (3, spec.seq_len, spec.num_inputs)
    if spec.c_slow > 1:
        shape = (spec.c_slow,) + shape
    return np.random.default_rng(seed).uniform(-scale, scale, size=shape).astype(np.float32)


BIT_CELLS = [dict(cell="mlp", num_hidden_layers=3), dict(cell="mlp", activation="sigmoid"),
             dict(cell="lstm", seq_len=5, unroll=3), dict(cell="gru", seq_len=4, c_slow=2),
             dict(cell="ssm", seq_len=6)]


@pytest.mark.parametrize("width", [8, 18, 32])
@pytest.mark.parametrize("kw", BIT_CELLS, ids=lambda kw: "_".join(map(str, kw.values())))
def test_rtlsim_and_golden_on_the_card_equal_the_cpu(cuda, width, kw):
    """Input scale 6 saturates the ROM addresses and, at 8 bits, wraps the
    MACC accumulators: the card wraps exactly where the CPU does."""
    from repro_torch.codegen import build_program, rtlsim
    from repro_torch.core.synthesis import NetworkSpec
    from repro_torch.verify import golden

    kw = dict(kw)
    spec = NetworkSpec(3, kw.pop("num_hidden_layers", 2), 6, 2, quant_bits=width, **kw)
    prog = build_program(spec, cuda)
    cpu = _program_on(prog, "cpu")
    u = _bit_inputs(spec, 6.0)
    on_card = rtlsim.simulate(prog, u, collect_ranges=True, device=cuda)
    on_cpu = rtlsim.simulate(cpu, u, collect_ranges=True, device="cpu")
    assert on_card.y_codes.device.type == "cuda"
    assert torch.equal(on_card.y_codes.cpu(), on_cpu.y_codes)
    assert on_card.cycles == on_cpu.cycles
    for k, v in on_cpu.final_states.items():
        assert torch.equal(on_card.final_states[k].cpu(), v)
    for k, (lo, hi) in on_cpu.wire_ranges.items():
        np.testing.assert_array_equal(on_card.wire_ranges[k][0], lo)
        np.testing.assert_array_equal(on_card.wire_ranges[k][1], hi)
    g_card = golden.fixed_forward(prog, u, device=cuda)
    assert torch.equal(g_card.cpu(), golden.fixed_forward(cpu, u, device="cpu"))
    assert torch.equal(g_card, on_card.y_codes)


@pytest.mark.parametrize("width,unroll", [(8, 1), (32, 1), (32, 3)])
def test_full_range_macc_wraps_identically_on_the_card(cuda, width, unroll):
    from repro_torch.codegen import rtlsim

    r = np.random.default_rng(width + unroll)
    half = 1 << (width - 1)
    x = torch.as_tensor(r.integers(-half, half, size=(5, 2048), dtype=np.int64))
    w = torch.as_tensor(r.integers(-half, half, size=(2048, 96), dtype=np.int64))
    got = rtlsim.macc_layer(x.to(cuda), w.to(cuda), width, unroll=unroll)
    assert torch.equal(got.cpu(), rtlsim.macc_layer(x, w, width, unroll=unroll))


def test_verilog_from_card_parameters_equals_the_cpu_emission(cuda):
    from repro_torch.codegen import build_program, emit_program, report_program
    from repro_torch.configs.paper_mlp import FIG10_A
    from repro_torch.core import synthesis
    from repro_torch.core.synthesis import NetworkSpec

    for spec in (FIG10_A, NetworkSpec(2, 2, 4, 2, cell="lstm", seq_len=3, quant_bits=32)):
        prog = build_program(spec, cuda)
        text = emit_program(prog)
        assert text == emit_program(_program_on(prog, "cpu"))
        synthesis.synthesize_cache_clear()
        rep = synthesis.synthesize(spec, backend="verilog", measure=False, device=cuda)
        assert rep.backend == "verilog" and rep.rtl == text
        assert rep.resources == dataclasses.replace(report_program(prog),
                                                    xla_flops=rep.flops,
                                                    xla_peak_bytes=rep.peak_bytes)
        assert rep.peak_bytes is not None


def test_analysis_with_card_resident_weights_equals_the_cpu(cuda):
    from repro_torch.analyze import analyze_program
    from repro_torch.codegen import build_program
    from repro_torch.core.synthesis import NetworkSpec

    for spec in (NetworkSpec(16, 2, 64, 4, cell="lstm", seq_len=3),
                 NetworkSpec(8, 3, 32, 4, cell="ssm", seq_len=3)):
        prog = build_program(spec, cuda)
        for width in (8, 18, 32):
            assert analyze_program(prog, width=width).to_doc() == \
                analyze_program(_program_on(prog, "cpu"), width=width).to_doc()


@pytest.mark.parametrize("seed", [1, 4, 9, 14])
def test_difftest_case_on_the_card(cuda, seed):
    from repro_torch.codegen import kernel_backend
    from repro_torch.verify import difftest

    kernel_backend.codegen_stage.launches = 0
    res = difftest.run_case(difftest.gen_case(seed), device=cuda)
    assert res.ok, res.line()
    assert kernel_backend.codegen_stage.launches >= 1


def test_a_requested_card_that_is_absent_raises(cuda, monkeypatch):
    """With no card, the bit path's entry points raise rather than run on
    the CPU."""
    from repro_torch.analyze import analyze_spec
    from repro_torch.codegen import build_program, rtlsim
    from repro_torch.core import synthesis
    from repro_torch.core.synthesis import NetworkSpec
    from repro_torch.verify import difftest, golden

    spec = NetworkSpec(3, 2, 4, 2)
    prog = build_program(spec, "cpu")
    u = np.zeros((1, 3), np.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: rtlsim.simulate(prog, u), lambda: golden.fixed_forward(prog, u),
                 lambda: rtlsim.simulate(prog, u, device="cuda"),
                 lambda: analyze_spec(spec),
                 lambda: synthesis.synthesize(spec, backend="verilog", device="cuda"),
                 lambda: difftest.main(["--seeds", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# ---------------------------------------------------------------------------
# the Fig. 10 loop and the chaos suite on the card
# ---------------------------------------------------------------------------

def test_tune_kernel_only_winner_passes_the_gate_on_the_card(cuda):
    """A kernel-only tune of the h4 lstm: every measured candidate built and
    timed through the generated stage kernel on the card, and the winner
    validated there (float legs within 1e-5, rtlsim bit-exact)."""
    from repro_torch.codegen import kernel_backend
    from repro_torch.core.synthesis import NetworkSpec
    from repro_torch.tune import tune

    kernel_backend.codegen_stage.launches = 0
    result = tune(NetworkSpec(2, 1, 4, 2, cell="lstm", seq_len=6), "latency", budget=3,
                  batch=2, backends=("kernel",),
                  space_kwargs={"unroll": (1, 2), "c_slow": (1, 2), "quant_bits": (None, 8)},
                  device=cuda)
    best = result.best
    assert best.validated and best.gate.ok and best.gate.bit_exact, best.gate.line()
    assert best.gate.float_err <= 1e-5
    assert result.report.backend == "kernel" and result.report.fallback_from is None
    assert len(result.measured) == 3 and all(s.measured["wall_us"] > 0 for s in result.measured)
    assert kernel_backend.codegen_stage.launches >= len(result.measured)


@pytest.mark.parametrize("arch", ["smollm-135m", "paper-lstm"])
def test_chaos_suite_passes_on_the_card(cuda, arch):
    """The nine scenarios on the smoke config with use_pallas: every fault
    class fires and is contained, and the arch's prefill kernel ran."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
    from repro_torch.kernels.lstm_cell import ops as lstm_ops
    from repro_torch.obs.check import check_chaos_doc
    from repro_torch.verify.chaos import run_suite

    kernel, counter = ((fa_kernel, fa_ops.flash_attention) if arch == "smollm-135m"
                       else (lstm_kernel, lstm_ops.lstm_seq))
    kernel.load()   # build before the timed scenarios (the watchdog's 30 s bound)
    counter.launches = 0
    cfg = dataclasses.replace(get_smoke_config(arch), use_pallas=True)
    doc = run_suite(seed=0, arch=arch, device=cuda, cfg=cfg)
    failed = [sc for sc in doc["scenarios"] if not sc["passed"]]
    assert doc["passed"] and doc["all_classes_hit"] and not failed, failed
    assert check_chaos_doc(doc) == []
    assert counter.launches >= 1
