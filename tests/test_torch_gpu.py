"""The port's CUDA kernels on the card, against their plain PyTorch versions:
``lstm_seq``, the generated stage kernel (``codegen_stage``), ``tanh_lut``,
``ssm_scan``, ``int8_matmul`` and ``flash_attention``; the bit path
(rtlsim, the golden model, the analyzer, the Verilog emission) on the card
against the same calls on the CPU, word for word; the Fig. 10 tuner and
the chaos suite on the card; gemma3's sliding-window layers, tail and
ring-buffer splice and internlm2 through ``flash_attention`` and the
server's drivers; and zamba2's Mamba-2 / SSD blocks (plain PyTorch on the
card, held against the CPU) and its shared block through
``flash_attention`` and the server; the MoE FFN at olmoe's width, MLA's
absorbed decode at deepseek's and int8 quantization on the card against
the CPU, and olmoe's attention (shape g) through ``flash_attention``;
hubert's non-causal attention and llama-vision's 8-query GQA (shapes h and
i) through ``flash_attention``, and both models' smoke prefills against the
plain path; and training: ``train_loss`` gradients on the card against the CPU, every
kernel wrapper refusing autograd (and launching without it), a
``Trainer`` whose checkpoint restores onto the card, and ``Trainer(mesh=)``
on gloo ranks sharing the card, dense and MoE.

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
                                   (257, 48, 8200),
                                   # the TMA path: blocks of 16 to 256 rows of a, a
                                   # warpgroup with no row below M, partial last m
                                   # tiles, one k tile (the pair's second half empty)
                                   # and odd counts of them, K tails
                                   (1, 16, 128), (8, 32, 256), (64, 48, 8192),
                                   (65, 4112, 256), (255, 48, 8192), (257, 16, 384),
                                   (300, 32, 1024), (1024, 4112, 64),
                                   # the byte-wise path: N or K off a multiple of 16
                                   (8, 4112, 200), (255, 16, 24), (1024, 48, 200),
                                   (300, 4112, 8), (1, 32, 8200)])
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


@pytest.mark.parametrize("path", ["tma", "bytewise"])
def test_int8_matmul_kernel_full_code_range(cuda, path):
    """Every code from -128 to 127 at K = 4096, with a row of a and a column
    of b all -128 (the largest products), on both paths."""
    from repro_torch.kernels.int8_matmul import kernel, ops

    M, K, N = 64, 4096, 256 if path == "tma" else 200
    r = np.random.default_rng(11)
    a = r.integers(-128, 128, size=(M, K))
    b = r.integers(-128, 128, size=(K, N))
    a[:, :256] = np.arange(-128, 128)
    b[:256, :] = np.arange(-128, 128)[:, None]
    a[0, :] = -128
    b[:, 0] = -128
    a = torch.as_tensor(a, dtype=torch.int8, device=cuda)
    b = torch.as_tensor(b, dtype=torch.int8, device=cuda)
    a_s = torch.as_tensor(r.uniform(0.01, 0.1, size=(M, 1)), dtype=torch.float32, device=cuda)
    b_s = torch.as_tensor(r.uniform(0.01, 0.1, size=(1, N)), dtype=torch.float32, device=cuda)
    assert kernel.plan(a, b)["path"] == path
    assert torch.equal(ops.int8_matmul(a, b, a_s, b_s), ops.int8_matmul_ref(a, b, a_s, b_s))


@pytest.mark.parametrize("M,K,N,offset,want", [
    (1, 4096, 8192, 0, {"path": "tma", "bm": 16, "cluster": 2}),
    (17, 4096, 8192, 0, {"path": "tma", "bm": 32, "cluster": 2}),
    (33, 4096, 8192, 0, {"path": "tma", "bm": 64, "cluster": 2}),
    (100, 4096, 8192, 0, {"path": "tma", "bm": 128, "cluster": 2}),
    (256, 4096, 8192, 0, {"path": "tma", "bm": 256, "cluster": 2}),
    (257, 16, 384, 0, {"path": "tma", "bm": 256, "cluster": 2}),
    (64, 4096, 8200, 0, {"path": "bytewise", "bm": 128, "cluster": 1}),
    (64, 4104, 8192, 0, {"path": "bytewise", "bm": 128, "cluster": 1}),
    (64, 128, 256, 1, {"path": "bytewise", "bm": 128, "cluster": 1}),
])
def test_int8_matmul_kernel_path(cuda, M, K, N, offset, want):
    """Which path and tile the library takes: TMA where K and N are
    multiples of 16 and the operands 16-byte aligned (a block's rows of a
    from M, up to 256; a pair of blocks splitting K), else the byte-wise
    mma.sync kernel."""
    from repro_torch.kernels.int8_matmul import kernel

    a = torch.zeros(M * K + offset, dtype=torch.int8, device=cuda)[offset:].view(M, K)
    b = torch.zeros(K * N + offset, dtype=torch.int8, device=cuda)[offset:].view(K, N)
    assert kernel.plan(a, b) == want


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


# ---------------------------------------------------------------------------
# gemma3 (sliding-window layers, the unstacked tail, ring-buffer caches) and
# internlm2 on the card
# ---------------------------------------------------------------------------

GEMMA_WIDE = dict(d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512, vocab=512,
                  sliding_window=96)


def _gemma3(cuda, use_pallas=False, **over):
    """gemma3 at 14 layers (two 5:1 groups and the 2-layer tail), random
    weights from a seed on the card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_smoke_config("gemma3-27b"), n_layers=14,
                              use_pallas=use_pallas, **over)
    return cfg, lm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)


def _plain_greedy(cfg, params, prompt, n, max_seq, dev):
    """The model's greedy loop on the plain path: the prompt as one chunk
    from a fresh cache, then decode steps (no server, no splice)."""
    from repro_torch.models import lm

    pcfg = dataclasses.replace(cfg, use_pallas=False)
    caches = lm.init_cache(pcfg, 1, max_seq, dev)
    lg, caches = lm.prefill_chunk(params, pcfg, torch.as_tensor([prompt], device=dev), caches, 0)
    out = [int(lg[0].argmax())]
    while len(out) < n:
        lg, caches = lm.decode_step(params, pcfg, torch.as_tensor([[out[-1]]], device=dev),
                                    caches, len(prompt) + len(out) - 1)
        out.append(int(lg[0].argmax()))
    return out


@pytest.mark.parametrize("over,S", [({}, 40), (GEMMA_WIDE, 200)], ids=["smoke_w16", "wide_w96"])
def test_gemma3_use_pallas_prefill_matches_plain_path(cuda, over, S):
    """14 flash_attention calls a prefill, the 12 local ones windowed; the
    prompt is longer than the window (several 64-key tiles in the wide case)."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import lm

    cfg, params = _gemma3(cuda, **over)
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab, (2, S)), device=cuda)
    lg_p, c_p = lm.prefill(params, cfg, toks)
    fa = ops.flash_attention
    fa.calls = fa.window_calls = 0
    lg_k, c_k = lm.prefill(params, dataclasses.replace(cfg, use_pallas=True), toks)
    assert (fa.calls, fa.window_calls) == (14, 12)
    torch.testing.assert_close(lg_k, lg_p, atol=1e-4, rtol=1e-4)
    for top in ("groups", "tail"):
        for name, leaves in c_p[top].items():
            _close(c_k[top][name].values(), leaves.values(), 1e-4)


def test_internlm2_use_pallas_prefill_matches_plain_path(cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import lm

    cfg = get_smoke_config("internlm2-20b")
    params = lm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab, (1, 70)), device=cuda)
    lg_p, _ = lm.prefill(params, cfg, toks)
    ops.flash_attention.calls = 0
    lg_k, _ = lm.prefill(params, dataclasses.replace(cfg, use_pallas=True), toks)
    assert ops.flash_attention.calls == cfg.n_layers
    torch.testing.assert_close(lg_k, lg_p, atol=1e-5, rtol=1e-5)


def test_ring_splice_on_the_card_equals_the_cpu(cuda):
    """A one-shot prefill's 37 positions spliced into rings of 16 (groups
    and tail) and a full-attention leaf of 40: the card's slots equal the
    CPU's bit for bit."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.runtime import splice_cache

    cfg = dataclasses.replace(get_smoke_config("gemma3-27b"), n_layers=14)
    gen = torch.Generator().manual_seed(5)
    dst = lm.init_cache(cfg, 3, 40, "cpu")
    src = lm.init_cache(cfg, 1, 37, "cpu")       # every leaf 37 positions long
    src["groups"] = {n: {k: torch.randn(2, 1, 37, 2, 16, generator=gen) for k in ("k", "v")}
                     for n in src["groups"]}
    src["tail"] = {n: {k: torch.randn(1, 37, 2, 16, generator=gen) for k in ("k", "v")}
                   for n in src["tail"]}
    for top in dst:
        for leaves in dst[top].values():
            for t in leaves.values():
                t.normal_(generator=gen)
    on_card = lambda tree: {top: {n: {k: t.to(cuda) for k, t in lv.items()}  # noqa: E731
                                  for n, lv in sub.items()} for top, sub in tree.items()}
    want = splice_cache(on_card(dst), on_card(src), 1, 40)    # card
    got = splice_cache(dst, src, 1, 40)                       # CPU
    for top in got:
        for n, leaves in got[top].items():
            for k, t in leaves.items():
                assert torch.equal(want[top][n][k].cpu(), t)
    ring = got["tail"]["t0_attn_local"]["k"]
    slots = torch.arange(21, 37) % 16
    assert torch.equal(ring[1, slots], src["tail"]["t0_attn_local"]["k"][0, 21:])


@pytest.mark.parametrize("use_pallas", [False, True])
def test_gemma3_drivers_give_the_plain_greedy_tokens_on_the_card(cuda, use_pallas):
    """Prompts either side of W = 16, decode past it, two slots: step(),
    step_block(), and chunked step() with the prefix cache twice (the second
    pass all hits) give equal tokens, equal to the plain greedy loop; the
    kernel runs 14 times a one-shot prefill and never in a chunk."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.runtime import DecodeServer, Request

    cfg, params = _gemma3(cuda, use_pallas=use_pallas)
    rng = np.random.default_rng(4)
    traffic = [([int(t) for t in rng.integers(1, cfg.vocab, n)], m)
               for n, m in ((20, 12), (7, 20), (33, 8), (16, 10), (17, 14))]

    def run(srv, block=False, uid0=0):
        ops.flash_attention.calls = 0
        for i, (p, m) in enumerate(traffic):
            srv.submit(Request(uid=uid0 + i, prompt=p, max_new_tokens=m))
        done = srv.run_until_drained(persistent=block)
        return ({r.uid - uid0: list(r.out_tokens) for r in done if r.uid >= uid0},
                ops.flash_attention.calls)

    mk = lambda **kw: DecodeServer(cfg, params, num_slots=2, max_seq=64, block_k=4,  # noqa: E731
                                   device=cuda, **kw)
    step, c_step = run(mk())
    block, c_block = run(mk(), block=True)
    srv = mk(prefill_chunk=4, prefix_cache_bytes=64 << 20)
    chunked, c_chunk = run(srv)
    again, _ = run(srv, uid0=100)
    assert srv.stats()["prefix_cache"]["hits"] == len(traffic)
    assert step == block == chunked == again
    assert c_step == c_block == (14 * len(traffic) if use_pallas else 0) and c_chunk == 0
    for i, (p, m) in enumerate(traffic):
        assert step[i] == _plain_greedy(cfg, params, p, m, 64, cuda), i


def test_gemma3_quarantined_slot_is_scrubbed_on_the_card(cuda):
    """NaN in every cache row of a live slot, tail rings included: the slot
    is quarantined and scrubbed, and the next request in it (shorter than
    the window) gives the plain greedy loop's tokens."""
    from repro_torch.runtime import DecodeServer, Request

    cfg, params = _gemma3(cuda, use_pallas=True)
    srv = DecodeServer(cfg, params, num_slots=2, max_seq=64, device=cuda)
    srv.submit(Request(uid=0, prompt=list(range(1, 21)), max_new_tokens=30))
    srv.submit(Request(uid=1, prompt=list(range(3, 12)), max_new_tokens=30))
    srv.step()
    b = [r.uid if r is not None else None for r in srv.slot_req].index(0)
    srv._poison_slot(b)
    assert bool(torch.isnan(srv.caches["tail"]["t1_attn_local"]["v"][b]).all())
    srv.step()
    assert srv.quarantined[b]
    prompt = [7, 3, 9, 1, 4, 4]
    srv.submit(Request(uid=2, prompt=prompt, max_new_tokens=12))
    done = {r.uid: r for r in srv.run_until_drained()}
    assert done[0].finish_reason == "error:nonfinite"
    assert done[2].finish_reason == "max_tokens"
    assert done[2].out_tokens == _plain_greedy(cfg, params, prompt, 12, 64, cuda)


# ---------------------------------------------------------------------------
# zamba2 (Mamba-2 / SSD blocks, the shared block with per-application LoRA)
# on the card
# ---------------------------------------------------------------------------

ZAMBA_MID = dict(d_model=512, ssm_state=64, mamba_headdim=64, n_heads=8, n_kv_heads=8,
                 head_dim=64, d_ff=1024, shared_attn_lora_rank=32)


def _zamba2(dev, use_pallas=False, **over):
    """zamba2 smoke (2 groups of mamba2, mamba2, shared_attn + a 2-block
    tail), random weights from a seed on ``dev``, with the leaves the
    reference initialises to constants drawn anew, nonzero (LoRA B, Mamba's
    Δ initialisation for ``dt_bias``, ``D``, the conv biases), as
    ``chip_smoke.perturb_hybrid`` draws them."""
    import math

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_smoke_config("zamba2-1.2b"), use_pallas=use_pallas, **over)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_params(cfg, gen, device=dev)
    randn = lambda t: torch.randn(t.shape, generator=gen, device=t.device)  # noqa: E731
    for top in ("groups", "tail"):
        for name, blk in params[top].items():
            if name.endswith("_shared_attn"):
                for leaf in ("qB", "kB", "vB"):
                    t = blk["lora"][leaf]
                    t.copy_(randn(t) / math.sqrt(t.shape[-2]))
            else:
                m = blk["mamba"]
                u = torch.rand(m["dt_bias"].shape, generator=gen, device=dev)
                dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
                m["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))
                m["D"].copy_(1.0 + 0.5 * randn(m["D"]))
                for leaf in ("conv_b_x", "conv_b_bc"):
                    m[leaf].copy_(0.5 * randn(m[leaf]))
    return cfg, params


@pytest.mark.parametrize("pieces", [(131,), (256,), (100, 60), (160, 96), (512,)])
def test_mamba2_prefill_and_decode_on_the_card_match_the_cpu(cuda, pieces):
    """A mid-width Mamba-2 block (d_model 512, 16 heads of 64, N 64): the
    SSD scan in one piece (131: chunks of 1; 256 and 512: chunks of 128) or
    resumed through ``state=`` (a piece of 160 runs five chunks of 32), then
    8 decode steps, on the card against the same calls on the CPU (1e-4:
    the projections are summed in another order, and an ulp of Δ moves the
    chunked scan by ~2e-5 at these widths)."""
    from repro_torch._tree import tree_map
    from repro_torch.models import ssm

    cfg, params = _zamba2("cpu", **ZAMBA_MID)
    p_cpu = tree_map(lambda t: t[0], params["groups"]["b0_mamba2"]["mamba"])
    p_card = tree_map(lambda t: t.to(cuda), p_cpu)
    r = np.random.default_rng(sum(pieces))
    u = torch.as_tensor(r.normal(size=(2, sum(pieces), cfg.d_model)), dtype=torch.float32)
    ud = torch.as_tensor(r.normal(size=(2, 8, cfg.d_model)), dtype=torch.float32)
    st_c = st_g = None
    s = 0
    for n in pieces:
        y_c, st_c = ssm.mamba2_prefill(p_cpu, cfg, u[:, s:s + n], state=st_c)
        y_g, st_g = ssm.mamba2_prefill(p_card, cfg, u[:, s:s + n].to(cuda), state=st_g)
        _close([y_g.cpu()], [y_c], 1e-4)
        s += n
    for t in range(8):
        y_c, st_c = ssm.mamba2_decode(p_cpu, cfg, ud[:, t:t + 1], st_c)
        y_g, st_g = ssm.mamba2_decode(p_card, cfg, ud[:, t:t + 1].to(cuda), st_g)
        _close([y_g.cpu()], [y_c], 1e-4)
    _close([st_g["h"].cpu(), st_g["conv"]["x"].cpu(), st_g["conv"]["bc"].cpu()],
           [st_c["h"], st_c["conv"]["x"], st_c["conv"]["bc"]], 1e-4)


@pytest.mark.parametrize("over,S", [({}, 131), (ZAMBA_MID, 300)], ids=["smoke", "mid"])
def test_zamba2_use_pallas_prefill_matches_plain_path(cuda, over, S):
    """One flash_attention call per shared-block application (2 a prefill),
    the rest of the stack identical on both paths."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import lm

    cfg, params = _zamba2(cuda, **over)
    toks = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab, (2, S)), device=cuda)
    lg_p, c_p = lm.prefill(params, cfg, toks)
    ops.flash_attention.calls = 0
    lg_k, c_k = lm.prefill(params, dataclasses.replace(cfg, use_pallas=True), toks)
    assert ops.flash_attention.calls == 2
    torch.testing.assert_close(lg_k, lg_p, atol=1e-4, rtol=1e-4)
    k_p = c_p["groups"]["b2_shared_attn"]["k"]
    _close([c_k["groups"]["b2_shared_attn"]["k"]], [k_p], 1e-4)
    _close([c_k["tail"]["t1_mamba2"]["h"]], [c_p["tail"]["t1_mamba2"]["h"]], 1e-4)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_zamba2_two_slot_serve_gives_the_plain_greedy_tokens_on_the_card(cuda, use_pallas):
    """Prompts of 7-160 tokens on two slots: step(), step_block(), and
    chunked step() with the prefix cache twice (the second pass all hits)
    give equal tokens, equal to the plain greedy loop; the kernel runs twice
    a one-shot prefill and never in a chunk."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.runtime import DecodeServer, Request

    cfg, params = _zamba2(cuda, use_pallas=use_pallas)
    rng = np.random.default_rng(6)
    traffic = [([int(t) for t in rng.integers(1, cfg.vocab, n)], m)
               for n, m in ((20, 12), (7, 10), (131, 6), (160, 5))]

    def run(srv, block=False, uid0=0):
        ops.flash_attention.calls = 0
        for i, (p, m) in enumerate(traffic):
            srv.submit(Request(uid=uid0 + i, prompt=p, max_new_tokens=m))
        done = srv.run_until_drained(persistent=block)
        return ({r.uid - uid0: list(r.out_tokens) for r in done if r.uid >= uid0},
                ops.flash_attention.calls)

    mk = lambda **kw: DecodeServer(cfg, params, num_slots=2, max_seq=192, block_k=4,  # noqa: E731
                                   device=cuda, **kw)
    step, c_step = run(mk())
    block, c_block = run(mk(), block=True)
    srv = mk(prefill_chunk=16, prefix_cache_bytes=64 << 20)
    chunked, c_chunk = run(srv)
    again, _ = run(srv, uid0=100)
    assert srv.stats()["prefix_cache"]["hits"] == len(traffic)
    assert step == block == chunked == again
    assert c_step == c_block == (2 * len(traffic) if use_pallas else 0) and c_chunk == 0
    for i, (p, m) in enumerate(traffic):
        assert step[i] == _plain_greedy(cfg, params, p, m, 192, cuda), i


# ---------------------------------------------------------------------------
# the MoE family (olmoe, deepseek with MLA) and weight-only int8 serving
# ---------------------------------------------------------------------------

def test_moe_apply_on_the_card_matches_the_cpu_at_olmoe_width(cuda):
    """olmoe's MoE FFN at its published widths (D 2048, 64 experts of 1024,
    top-8) on 256 tokens: the routing ids equal, then y within 1e-5 of
    max |y| and the aux loss.  The bar is relative to the largest output:
    with the reference's initialisation (expert weights scaled by the
    expert count, not the fan-in) y reaches ~200, and fp32 sums over the
    2048- and 1024-long contractions in cuBLAS's order leave ~2e-4 absolute
    on elements near zero after cancellation."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("olmoe-1b-7b")
    p = moe.moe_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    x = torch.randn((1, 256, cfg.d_model), generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    p_cpu = {k: v.cpu() for k, v in p.items()}
    e, _, _ = moe.route(p, cfg, x)
    e_cpu, _, _ = moe.route(p_cpu, cfg, x.cpu())
    assert torch.equal(e.cpu(), e_cpu)
    y, aux = moe.moe_apply(p, cfg, x)
    y_cpu, aux_cpu = moe.moe_apply(p_cpu, cfg, x.cpu())
    assert float((y.cpu() - y_cpu).abs().max()) <= 1e-5 * float(y_cpu.abs().max())
    torch.testing.assert_close(aux.cpu(), aux_cpu, atol=1e-6, rtol=1e-6)


def test_quantize_int8_codes_on_the_card_equal_the_cpu(cuda):
    """Codes and scales bit-equal on the card and the CPU (a true division
    by 127 on both: the card's division by a Python scalar would be a
    product with its reciprocal), per channel and whole-tensor."""
    from repro_torch.core.quantization import quantize_int8

    x = torch.randn((64, 2048, 96), generator=torch.Generator(device=cuda).manual_seed(2),
                    device=cuda)
    for axis in (-2, -1, None):
        q, s = quantize_int8(x, axis)
        q_cpu, s_cpu = quantize_int8(x.cpu(), axis)
        assert torch.equal(q.cpu(), q_cpu) and torch.equal(s.cpu(), s_cpu), axis


def test_mla_absorbed_decode_equals_naive_prefill_at_deepseek_width(cuda):
    """One deepseek-v2-lite MLA layer at its published widths (r 512, dr 64,
    16 heads of 128 + 64): the absorbed decode, token by token and as one
    chunk, gives the naive prefill's outputs within 1e-5 of max |out|."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention

    cfg = get_config("deepseek-v2-lite-16b")
    gen = torch.Generator(device=cuda).manual_seed(3)
    p = attention.mla_params(gen, cfg)
    S = 48
    x = torch.randn((1, S, cfg.d_model), generator=gen, device=cuda)
    with torch.no_grad():
        naive, _ = attention.mla_prefill(p, cfg, x)
        cache = {"c_kv": torch.zeros((1, S, cfg.kv_lora_rank), device=cuda),
                 "k_rope": torch.zeros((1, S, cfg.qk_rope_head_dim), device=cuda)}
        outs = []
        c = cache
        for t in range(S):
            o, c = attention.mla_decode(p, cfg, x[:, t:t + 1], c, t)
            outs.append(o)
        chunk, _ = attention.mla_decode(p, cfg, x, cache, 0)
    scale = float(naive.abs().max())
    assert float((torch.cat(outs, 1) - naive).abs().max()) <= 1e-5 * scale
    assert float((chunk - naive).abs().max()) <= 1e-5 * scale


def test_flash_attention_at_olmoe_prefill_shape(cuda):
    """Shape (g): one olmoe-1b-7b layer of a 2048-token prefill (B 1, MHA
    16/16 at hd 128, causal), held to the fp32 bar against the plain
    version."""
    from repro_torch.kernels.flash_attention import ops

    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn((1, 2048, 16, 128), generator=gen, device=cuda) for _ in range(3))
    torch.testing.assert_close(ops.flash_attention(q, k, v), ops.flash_attention_ref(q, k, v),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-lite-16b"])
def test_moe_smoke_use_pallas_prefill_matches_plain_path(cuda, arch):
    """The smoke configs on the card: the one-shot prefill under
    ``use_pallas`` (olmoe's attention through ``flash_attention``;
    deepseek's MLA has no kernel) against the plain path, routing ids
    first, then the logits within 1e-5 of max |logit|."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm, moe

    cfg = dataclasses.replace(get_smoke_config(arch), use_pallas=True)
    params = lm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    rng = np.random.default_rng(7)
    orig = moe.moe_apply
    for n in (20, 7, 33, 64):
        toks = torch.as_tensor([[int(t) for t in rng.integers(1, cfg.vocab, n)]], device=cuda)
        ids = {}
        for pallas in (True, False):
            log = ids[pallas] = []

            def spy(p, c, x, group_size=moe.DEFAULT_GROUP_SIZE, log=log):
                log.append(moe.route(p, c, x)[0])
                return orig(p, c, x, group_size)

            moe.moe_apply = spy
            try:
                with torch.no_grad():
                    lg, _ = lm.prefill(params, dataclasses.replace(cfg, use_pallas=pallas), toks)
            finally:
                moe.moe_apply = orig
            ids[pallas].append(lg)
        *e_k, lk = ids[True]
        *e_p, lp = ids[False]
        assert all(torch.equal(a, b) for a, b in zip(e_k, e_p)), n
        assert float((lk - lp).abs().max()) <= 1e-5 * float(lp.abs().max()), n


# ---------------------------------------------------------------------------
# training on the card: plain PyTorch end to end, no kernel under autograd
# ---------------------------------------------------------------------------

def _train_batch(vocab, B=2, S=32, seed=0):
    r = np.random.default_rng(seed)
    labels = r.integers(0, vocab, (B, S))
    labels[0, :3] = -1
    return {"tokens": torch.as_tensor(r.integers(0, vocab, (B, S)), dtype=torch.int32),
            "labels": torch.as_tensor(labels, dtype=torch.int32)}


@pytest.mark.parametrize("arch,tol", [("smollm-135m", 1e-5), ("paper-lstm", 1e-5),
                                      ("falcon-mamba-7b", 1e-5), ("zamba2-1.2b", 1e-4)])
def test_train_loss_grads_on_the_card_match_the_cpu(cuda, arch, tol):
    """The same smoke parameters and batch on the card and on the host's CPU:
    the loss and each gradient leaf within ``tol`` of that leaf's max |g|."""
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.optim.adamw import value_and_grad

    cfg = get_smoke_config(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = _train_batch(cfg.vocab)
    loss_fn = lambda p, b: lm.train_loss(p, cfg, b)
    (l_c, m_c), g_c = value_and_grad(loss_fn, params, batch)
    (l_g, m_g), g_g = value_and_grad(loss_fn, tree_map(lambda t: t.to(cuda), params),
                                     tree_map(lambda t: t.to(cuda), batch))
    assert l_g.device.type == "cuda"
    torch.testing.assert_close(l_g.cpu(), l_c, atol=0, rtol=tol)
    for k in m_c:
        torch.testing.assert_close(m_g[k].cpu(), m_c[k], atol=1e-7, rtol=tol)
    for a, b in zip(tree_leaves(g_g), tree_leaves(g_c), strict=True):
        assert a.device.type == "cuda"
        scale = float(b.abs().max().clamp(min=1e-30))
        assert float((a.cpu() - b).abs().max()) <= tol * scale


def test_kernel_wrappers_refuse_autograd_and_launch_without_it(cuda):
    """Under grad, with an input that requires grad, every wrapper raises
    before it launches (no launch counted); under ``torch.no_grad()`` the
    same call launches once, as before."""
    from repro_torch.codegen import kernel_backend
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.int8_matmul import ops as i8
    from repro_torch.kernels.lstm_cell import ops as lstm
    from repro_torch.kernels.ssm_scan import ops as scan
    from repro_torch.kernels.tanh_lut import ops as lut_ops
    from repro_torch.kernels.tanh_lut.ref import make_lut

    x, w_x, w_h, b, h0, c0 = _case(cuda, 2, 8, 16, 16)
    sx, sdl, sA, sB, sC, _ = _scan_case(cuda, 1, 16, 8, 4)
    r = np.random.default_rng(3)
    q, k, v = (torch.as_tensor(r.normal(size=(1, 32, 2, 16)), dtype=torch.float32, device=cuda)
               for _ in range(3))
    a8 = torch.ones((4, 8), dtype=torch.int8, device=cuda)
    b8 = torch.ones((8, 4), dtype=torch.int8, device=cuda)
    a_s, b_s = torch.full((4, 1), 0.5, device=cuda), torch.full((1, 4), 0.25, device=cuda)
    stage, consts, x0, us = _stage_case(cuda, "lstm", 8, 8, 1, 4)
    run = kernel_backend.compile_stage(stage)
    lut = make_lut(8, device=cuda)
    calls = [
        (lstm.lstm_seq, lambda t: lstm.lstm_seq(x, t, w_h, b, h0, c0), w_x),
        (scan.ssm_scan, lambda t: scan.ssm_scan(sx, t, sA, sB, sC), sdl),
        (fa.flash_attention, lambda t: fa.flash_attention(t, k, v), q),
        (lut_ops.tanh_lut, lambda t: lut_ops.tanh_lut(t, lut), x),
        (i8.int8_matmul, lambda t: i8.int8_matmul(a8, b8, t, b_s), a_s),
        (kernel_backend.codegen_stage,
         lambda t: run(consts, {**x0, "h": t}, us), x0["h"]),
    ]
    for counter, call, arg in calls:
        before = counter.launches
        with pytest.raises(NotImplementedError, match="no backward pass.*item 11"):
            call(arg.detach().clone().requires_grad_(True))
        assert counter.launches == before
        with torch.no_grad():
            call(arg.detach().clone().requires_grad_(True))
        call(arg)                       # no input requires grad: launches as before
        assert counter.launches == before + 2
    torch.cuda.synchronize()


def test_use_pallas_train_loss_raises_on_the_card(cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.optim.adamw import value_and_grad

    cfg = dataclasses.replace(get_smoke_config("smollm-135m"), use_pallas=True)
    params = lm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    batch = {k: t.to(cuda) for k, t in _train_batch(cfg.vocab).items()}
    with pytest.raises(NotImplementedError, match="flash_attention"):
        value_and_grad(lambda p, b: lm.train_loss(p, cfg, b), params, batch)


def test_trainer_on_the_card_checkpoints_and_restores_onto_the_card(cuda, tmp_path):
    """Three steps of the smoke config on the card, no kernel launched; the
    checkpoint restores onto the card, equal to the trained state."""
    from repro_torch import optim
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = dataclasses.replace(get_smoke_config("smollm-135m"), vocab=64)
    launches = fa.flash_attention.launches
    tr = Trainer(cfg, TrainerConfig(total_steps=3, ckpt_every=2, ckpt_dir=str(tmp_path),
                                    log_every=1),
                 optim.AdamWConfig(lr_peak=3e-3, warmup_steps=1, total_steps=3),
                 DataConfig(vocab=64, seq_len=32, global_batch=8, branching=3))
    res = tr.run()
    assert fa.flash_attention.launches == launches
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
    assert all(t.device.type == "cuda" for t in tree_leaves((tr.params, tr.opt_state)))
    template = {"params": tree_map(torch.zeros_like, tr.params),
                "opt": optim.init(tr.params)}
    restored, meta = CheckpointManager(str(tmp_path)).restore(template)
    assert meta["step"] == 3
    for got, want in zip(tree_leaves(restored), tree_leaves({"params": tr.params,
                                                             "opt": tr.opt_state}), strict=True):
        assert got.device.type == "cuda" and got.dtype == want.dtype
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the mesh slice: ShardPlan serving in both layouts, synthesize's TP and DP,
# expert-parallel MoE.  One card: several ranks share cuda:0 over gloo (the
# serving control plane and the TP all-reduce take CUDA tensors there), and
# NCCL runs at world size 1 (it refuses two ranks on one card).
# ---------------------------------------------------------------------------

def _mesh_traffic(vocab):
    rng = np.random.default_rng(0)
    return [([int(t) for t in rng.integers(1, vocab, size=int(rng.integers(2, 9)))], 6)
            for _ in range(8)]


def _mesh_serve(cfg, params, dev, plan=None, block=False, **kw):
    from repro_torch.runtime import DecodeServer, Request

    srv = DecodeServer(cfg, params, num_slots=8, max_seq=48, block_k=4, plan=plan,
                       device=dev, **kw)
    for i, (p, m) in enumerate(_mesh_traffic(cfg.vocab)):
        srv.submit(Request(uid=i, prompt=p, max_new_tokens=m))
    return {r.uid: list(r.out_tokens) for r in srv.run_until_drained(persistent=block)}, srv


def _lstm_pallas(dev):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_smoke_config("paper-lstm"), use_pallas=True)
    return cfg, lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)


@pytest.mark.parametrize("block", [False, True], ids=["step", "step_block"])
def test_folded_dp8_use_pallas_serving_gives_the_unsharded_tokens(cuda, block):
    from repro_torch.kernels.lstm_cell import ops
    from repro_torch.launch.mesh import AXES, AbstractMesh
    from repro_torch.runtime import ShardPlan

    cfg, params = _lstm_pallas(cuda)
    base, _ = _mesh_serve(cfg, params, cuda, block=block)
    launches = ops.lstm_seq.launches
    folded, srv = _mesh_serve(cfg, params, cuda, ShardPlan(AbstractMesh((1, 8, 1), AXES),
                                                           fold_data=True), block=block)
    assert folded == base
    assert ops.lstm_seq.launches - launches == cfg.n_layers * 8     # one prefill a request
    by_shard = srv.stats()["mesh"]["decoded_tokens_by_shard"]
    assert sum(by_shard) == srv.decoded_tokens and sum(t > 0 for t in by_shard) > 1


def _ranks_card_serving(rank, world, block):
    from repro_torch.kernels.lstm_cell import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.runtime import ShardPlan

    dev = torch.device("cuda", 0)
    cfg, params = _lstm_pallas(dev)
    plan = ShardPlan(make_local_mesh(dp=world, tp=1))
    launches = ops.lstm_seq.launches
    toks, srv = _mesh_serve(cfg, params, dev, plan, block=block)
    mine = sum(1 for r in srv.completed if r.shard == plan.local_shard)
    return toks, ops.lstm_seq.launches - launches, mine * cfg.n_layers


@pytest.mark.parametrize("backend,world", [("gloo", 2), ("nccl", 1)])
def test_sharded_use_pallas_serving_on_the_card(cuda, backend, world):
    """Each rank launches lstm_seq for its own shard's prefills only, and
    the tokens are the unsharded server's."""
    from repro_torch.launch.spawn import run_ranks

    cfg, params = _lstm_pallas(cuda)
    base, _ = _mesh_serve(cfg, params, cuda)
    for block in (False, True):
        results = run_ranks(_ranks_card_serving, world, (block,), backend=backend,
                            timeout_s=300)
        for toks, launched, own in results:
            assert toks == base
            assert launched == own > 0


def _ranks_card_synthesis(rank, world, backend):
    from repro_torch.codegen import build_program, eager_backend, kernel_backend
    from repro_torch.core.synthesis import NetworkSpec, synthesize
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import comm

    dev = torch.device("cuda", 0)
    out = {}
    with torch.no_grad():
        spec = NetworkSpec(8, 2, 64, 4, cell="lstm", seq_len=16)
        prog = build_program(spec, dev)
        u = torch.as_tensor(np.random.default_rng(1).normal(size=(8, 16, 8)),
                            dtype=torch.float32, device=dev)
        one = eager_backend.compile_program(prog, device=dev)(prog.params, u)
        mesh = make_local_mesh(dp=1, tp=world)
        comm.reset_counts()
        tp = eager_backend.compile_program(prog, mesh=mesh, device=dev)(prog.params, u)
        out["tp_err"] = float((tp - one).abs().max())
        out["tp_reduces"] = comm.COUNTS["all_reduce"]
        spec_c = NetworkSpec(8, 1, 64, 4, cell="lstm", seq_len=16, c_slow=2 * world)
        prog_c = build_program(spec_c, dev)
        uc = torch.as_tensor(np.random.default_rng(2).normal(size=(2 * world, 4, 16, 8)),
                             dtype=torch.float32, device=dev)
        k_one = kernel_backend.compile_program(prog_c, device=dev)(prog_c.params, uc)
        k_dp = kernel_backend.compile_program(prog_c, mesh=make_local_mesh(dp=world, tp=1),
                                              device=dev)(prog_c.params, uc)
        out["dp_err"] = float((k_dp - k_one).abs().max())
        r = synthesize(spec, batch=8, backend="eager", mesh=mesh, measure=False, device=dev)
        out["backend"] = r.backend
    return out


@pytest.mark.parametrize("backend,world", [("gloo", 2), ("nccl", 1)])
def test_mesh_synthesis_on_the_card(cuda, backend, world):
    """Eager TP across the ranks within 1e-4 of one device (another
    summation order); the kernel backend's DP within 1e-4 of its unsharded
    launch (the kernel's grid takes another batch)."""
    from repro_torch.launch.spawn import run_ranks

    for out in run_ranks(_ranks_card_synthesis, world, (backend,), backend=backend,
                         timeout_s=300):
        assert out["tp_err"] < 1e-4 and out["dp_err"] < 1e-4, out
        assert out["tp_reduces"] == (2 * 16 if world > 1 else 0), out
        assert out["backend"] == "eager"


def _ranks_card_ep(rank, world):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe
    from repro_torch.parallel import comm
    from repro_torch.parallel.ep_moe import ep_moe_apply

    dev = torch.device("cuda", 0)
    cfg = get_config("olmoe-1b-7b")
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.device(dev):
        p = moe.moe_params(g, cfg)
    x = torch.randn(256, cfg.d_model, generator=g, device=dev) * 0.5
    comm.reset_counts()
    with torch.no_grad():
        y = ep_moe_apply(p, cfg, x, make_local_mesh())
        y_ref, _ = moe.moe_apply(p, cfg, x[None], group_size=256)
    return float((y - y_ref[0]).abs().max()), comm.COUNTS["all_to_all_single"]


def test_ep_moe_at_olmoe_widths_on_the_card_under_nccl(cuda):
    """NCCL's all_to_all at world size 1 (the largest world one card
    allows), 64 experts top-8 at d_model 2048."""
    from repro_torch.launch.spawn import run_ranks

    [(err, a2a)] = run_ranks(_ranks_card_ep, 1, backend="nccl", timeout_s=300)
    assert a2a == 2 and err < 2e-4, (err, a2a)


# -- training on a mesh: ZeRO shards over gloo ranks sharing the card and one
# NCCL rank, the compressed all-reduce and the pipeline on CUDA tensors ------

def _ranks_card_mesh_train(rank, world, tmp):
    """The smoke smollm through Trainer(mesh=(world, 1)) on cuda:0, then the
    compressed all-reduce of one leaf and the pipeline on CUDA tensors."""
    from repro_torch import optim
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import comm
    from repro_torch.parallel.compression import compress_leaf
    from repro_torch.parallel.pipeline import pipeline_apply, sequential_reference
    from repro_torch.runtime import Trainer, TrainerConfig
    from torch.distributed.device_mesh import DeviceMesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = make_local_mesh(world, 1)
    stages = DeviceMesh("cpu" if world > 1 else "cuda", torch.arange(world),
                        mesh_dim_names=("stage",))
    cfg = get_smoke_config("smollm-135m")
    t = Trainer(cfg, TrainerConfig(total_steps=3, ckpt_every=3, ckpt_dir=f"{tmp}/mesh",
                                   log_every=1, microbatches=2, ckpt_async=False),
                optim.AdamWConfig(lr_peak=3e-4, warmup_steps=2, total_steps=6),
                DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8), mesh, device=dev)
    res = t.run()
    out = {"steps": [(m["loss"], m["grad_norm"]) for m in res["metrics"]]}
    g = torch.randn(64, 32, generator=torch.Generator(device=dev).manual_seed(rank),
                    device=dev)
    comm.reset_counts()
    mean, _ = compress_leaf(g, torch.zeros_like(g), mesh.get_group("data"))
    exact = comm.all_reduce(g.clone(), mesh.get_group("data")) / world
    scale = comm.all_reduce_max(g.abs().max(), mesh.get_group("data")) / 127
    out["compression"] = (float((mean - exact).abs().max() / scale),
                          comm.COUNTS["all_reduce_int32"])
    gen = torch.Generator(device=dev).manual_seed(5)
    p = {"w": torch.randn(world, 64, 64, generator=gen, device=dev) / 8,
         "b": torch.randn(world, 64, generator=gen, device=dev)}
    x = torch.randn(6, 8, 64, generator=gen, device=dev)
    stage = lambda q, h: torch.tanh(h @ q["w"] + q["b"])  # noqa: E731
    comm.reset_counts()
    y = pipeline_apply(stage, p, x, stages)
    out["pipeline"] = (float((y - sequential_reference(stage, p, x)).abs().max()),
                       comm.COUNTS["ppermute"])
    return out


@pytest.mark.parametrize("backend,world", [("gloo", 2), ("nccl", 1)])
def test_mesh_training_on_the_card(cuda, tmp_path, backend, world):
    """Trainer(mesh=) on the card gives mesh=None's first loss and grad norm
    within 1e-5 relative, and at world 1 every step exactly; the compressed
    all-reduce within one int8 step of the exact mean with an int32
    payload; the pipeline within 1e-5 of the sequential run with C + P − 1
    transfers.

    Over two ranks cuBLAS sums each weight gradient's rows in two halves,
    and AdamW's first updates are ±lr wherever |g| is near 0, so a rounding
    gap in such a g moves a parameter by up to 2·lr: on this 48-wide model
    the later steps' grad norms moved 7.1e-5 relative at lr 3e-3 (measured
    on an H100), so they are held at 1e-4 with lr 3e-4.  (At full width,
    phase 23 of chip_smoke.py holds every step to 1e-5.)"""
    from repro_torch import optim
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.launch.spawn import run_ranks
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = get_smoke_config("smollm-135m")
    t = Trainer(cfg, TrainerConfig(total_steps=3, ckpt_every=3, ckpt_dir=str(tmp_path / "one"),
                                   log_every=1, microbatches=2, ckpt_async=False),
                optim.AdamWConfig(lr_peak=3e-4, warmup_steps=2, total_steps=6),
                DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8), device=cuda)
    want = [(m["loss"], m["grad_norm"]) for m in t.run()["metrics"]]
    for out in run_ranks(_ranks_card_mesh_train, world, (str(tmp_path),), backend=backend,
                         timeout_s=300):
        if world == 1:
            assert out["steps"] == want
        np.testing.assert_allclose(out["steps"][0], want[0], rtol=1e-5)
        np.testing.assert_allclose(out["steps"], want, rtol=1e-4)
        assert out["compression"][0] <= 1.0 and out["compression"][1] == 1
        assert out["pipeline"][0] <= 1e-5 and out["pipeline"][1] == 6 + world - 1


# -- MoE training on a data mesh: two gloo ranks sharing the card ------------

def _ranks_card_moe_mesh(rank, world, tmp, group_size):
    """The olmoe smoke config through Trainer(mesh=(world, 1)) on cuda:0."""
    from repro_torch import optim
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.runtime import Trainer, TrainerConfig

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"), moe_group_size=group_size)
    t = Trainer(cfg, TrainerConfig(total_steps=3, ckpt_every=3, ckpt_dir=f"{tmp}/moe{rank}",
                                   log_every=1, microbatches=2, ckpt_async=False),
                optim.AdamWConfig(lr_peak=3e-4, warmup_steps=2, total_steps=6),
                DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8),
                make_local_mesh(world, 1), device=dev)
    return [(m["loss"], m["grad_norm"]) for m in t.run()["metrics"]]


@pytest.mark.parametrize("groups,group_size", [("aligned", 32), ("spanning", 0)])
def test_moe_mesh_training_on_the_card(cuda, tmp_path, groups, group_size):
    """The olmoe smoke config over dp = 2 gloo ranks sharing the card
    (MoE groups over the global microbatch: a 32-token group inside a
    rank's rows, or the default one spanning both) gives mesh=None's losses
    and grad norms within 1e-5 at the first step and 1e-4 after (the
    48-wide smoke model's bar in test_mesh_training_on_the_card)."""
    from repro_torch import optim
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.launch.spawn import run_ranks
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"), moe_group_size=group_size)
    t = Trainer(cfg, TrainerConfig(total_steps=3, ckpt_every=3, ckpt_dir=str(tmp_path / "one"),
                                   log_every=1, microbatches=2, ckpt_async=False),
                optim.AdamWConfig(lr_peak=3e-4, warmup_steps=2, total_steps=6),
                DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8), device=cuda)
    want = [(m["loss"], m["grad_norm"]) for m in t.run()["metrics"]]
    for got in run_ranks(_ranks_card_moe_mesh, 2, (str(tmp_path), group_size), backend="gloo",
                         timeout_s=300):
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        np.testing.assert_allclose(got, want, rtol=1e-4)


# ---------------------------------------------------------------------------
# cross-attention and the encoder frontend: llama-3.2-vision-90b, hubert-xlarge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [dict(H=16, KV=16, hd=80, causal=False),
                                   dict(H=64, KV=8, hd=128, causal=True)],
                         ids=["h_hubert_nc", "i_llama"])
def test_flash_attention_at_hubert_and_llama_shapes(cuda, shape):
    """Shapes (h) and (i) cut to S = T = 256: hubert's non-causal MHA at hd
    80 and llama-vision's GQA, 8 query heads a KV head, at hd 128; the fp32
    bar against the plain version."""
    from repro_torch.kernels.flash_attention import kernel, ops

    gen = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((1, 256, shape["H"], shape["hd"]), generator=gen, device=cuda)
    k, v = (torch.randn((1, 256, shape["KV"], shape["hd"]), generator=gen, device=cuda)
            for _ in range(2))
    launches = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=shape["causal"])
    assert ops.flash_attention.launches - launches == kernel.launches_per_call(
        kernel.splits(q, k, causal=shape["causal"]))
    torch.testing.assert_close(got, ops.flash_attention_ref(q, k, v, causal=shape["causal"]),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "hubert-xlarge"])
def test_vlm_and_encoder_use_pallas_prefill_matches_plain_path(cuda, arch):
    """The smoke configs on the card, the VLM's cross gates open (0.5) and
    its memory drawn: the one-shot prefill under ``use_pallas`` (every
    self-attention layer through ``flash_attention``, non-causal for the
    encoder) against the plain path, within 1e-5 of max |logit|."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import lm

    cfg = get_smoke_config(arch)
    params = lm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    rng = np.random.default_rng(8)
    memory = None
    if cfg.family == "vlm":
        params["groups"]["b4_cross"]["cross"]["gate"].fill_(0.5)
        memory = torch.as_tensor(rng.normal(size=(1, cfg.frontend_tokens, cfg.frontend_dim)),
                                 dtype=torch.float32, device=cuda)
        x = torch.as_tensor(rng.integers(0, cfg.vocab, (1, 45)), device=cuda)
    else:
        x = torch.as_tensor(rng.normal(size=(1, 45, cfg.frontend_dim)), dtype=torch.float32,
                            device=cuda)
    lg_p, _ = lm.prefill(params, cfg, x, memory=memory)
    ops.flash_attention.calls = 0
    lg_k, _ = lm.prefill(params, dataclasses.replace(cfg, use_pallas=True), x, memory=memory)
    n_attn = sum(k != "cross" for k in cfg.layer_pattern) * cfg.n_groups
    assert ops.flash_attention.calls == n_attn
    assert float((lg_k - lg_p).abs().max()) <= 1e-5 * float(lg_p.abs().max())


# ---------------------------------------------------------------------------
# tensor-parallel compute along ``model``: internlm2 smoke at tp = 2, two
# gloo ranks sharing the card, and the two kernels at their per-rank shapes
# ---------------------------------------------------------------------------

def _ranks_card_tp(rank, world):
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.parallel import tensor_parallel as tp
    from repro_torch.parallel.sharding import model_shard
    from repro_torch.runtime import ShardPlan

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_local_mesh(1, 2)
    plan = ShardPlan(mesh)
    cfg = get_smoke_config("internlm2-20b")
    params = plan.local_params(cfg, lm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev))
    x = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab, (2, 40)), device=dev)
    out = {}
    with model_shard(mesh):
        for use_pallas in (False, True):
            c = dataclasses.replace(cfg, use_pallas=use_pallas)
            calls = ops.flash_attention.calls
            lg, caches = lm.prefill(params, c, x)
            out[use_pallas] = (tp.join_vocab(lg, cfg.vocab).cpu().numpy(),
                               ops.flash_attention.calls - calls,
                               tuple(caches["groups"]["b0_attn"]["k"].shape))
    return out


def test_internlm2_at_tp2_use_pallas_prefill_matches_plain_on_the_card(cuda):
    """Each of two gloo ranks on cuda:0 computes internlm2 smoke on its 3
    query and 1 KV head, ``flash_attention`` once a layer on that shard;
    the joined logits within 1e-5 of max |logit| of the plain path's."""
    from repro_torch.launch.spawn import run_ranks

    for out in run_ranks(_ranks_card_tp, 2, backend="gloo", timeout_s=300):
        plain, calls_p, kshape = out[False]
        kern, calls_k, _ = out[True]
        assert calls_p == 0 and calls_k == 2 and kshape == (2, 2, 40, 1, 16)
        assert np.max(np.abs(kern - plain)) <= 1e-5 * np.max(np.abs(plain))


def test_flash_attention_kernel_at_the_tp2_rank_shape(cuda):
    """Shape (j): internlm2-20b's rank at tp = 2 (24 of 48 query heads, 4
    of 8 KV heads, hd 128), causal, at 2048 tokens."""
    from repro_torch.kernels.flash_attention import kernel, ops

    case = dict(B=1, S=2048, T=2048, H=24, KV=4, hd=128)
    q, k, v = _flash_case(cuda, case, torch.float32, seed=9)
    launches = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=True)
    assert ops.flash_attention.launches - launches == kernel.launches_per_call(
        kernel.splits(q, k, causal=True))
    torch.testing.assert_close(got, ops.flash_attention_ref(q, k, v, causal=True),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("T", [64, 256])
def test_ssm_scan_kernel_at_the_tp2_rank_channels(cuda, T):
    """falcon-mamba-7b's rank at tp = 2: 4096 of its 8192 inner channels."""
    from repro_torch.kernels.ssm_scan import ops

    x, dl, A, B, C, h0 = _scan_case(cuda, 1, T, 4096, 16, seed=T, carry=True)
    launches = ops.ssm_scan.launches
    got = ops.ssm_scan(x, dl, A, B, C, h0=h0)
    assert ops.ssm_scan.launches == launches + 1
    torch.cuda.synchronize()
    _close(got, ops.ssm_scan_ref(x, dl, A, B, C, h0), 1e-4)


# ---------------------------------------------------------------------------
# MoE experts and MLA heads on the model shard: olmoe smoke at tp = 2, two
# gloo ranks sharing the card, and flash_attention at a rank's olmoe heads
# ---------------------------------------------------------------------------

def _ranks_card_tp_moe(rank, world):
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm, moe
    from repro_torch.parallel import tensor_parallel as tp
    from repro_torch.parallel.sharding import model_shard
    from repro_torch.runtime import ShardPlan

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_local_mesh(1, 2)
    plan = ShardPlan(mesh)
    cfg = get_smoke_config("olmoe-1b-7b")
    params = plan.local_params(cfg, lm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev))
    x = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab, (2, 40)), device=dev)
    out, inner = {}, moe.route
    with model_shard(mesh):
        for use_pallas in (False, True):
            c = dataclasses.replace(cfg, use_pallas=use_pallas)
            calls, ids = ops.flash_attention.calls, []

            def spy(p, c_, h, data=None):
                r = inner(p, c_, h, data)
                ids.append(r[0].cpu().numpy())
                return r

            moe.route = spy
            try:
                lg, caches = lm.prefill(params, c, x)
            finally:
                moe.route = inner
            out[use_pallas] = (tp.join_vocab(lg, cfg.vocab).cpu().numpy(),
                               ops.flash_attention.calls - calls,
                               tuple(caches["groups"]["b0_moe"]["k"].shape),
                               tuple(params["groups"]["b0_moe"]["moe"]["w_in"].shape), ids)
    return out


def test_olmoe_at_tp2_use_pallas_prefill_matches_plain_on_the_card(cuda):
    """Each of two gloo ranks on cuda:0 computes olmoe smoke on its 2 of 4
    heads (``flash_attention`` once a layer) and its 4 of 8 experts; with
    the same routing on both paths, the joined logits within 1e-5 of max
    |logit| of the plain path's."""
    from repro_torch.launch.spawn import run_ranks

    for out in run_ranks(_ranks_card_tp_moe, 2, backend="gloo", timeout_s=300):
        plain, calls_p, kshape, wshape, ids_p = out[False]
        kern, calls_k, _, _, ids_k = out[True]
        assert calls_p == 0 and calls_k == 2 and kshape == (2, 2, 40, 2, 16)
        assert wshape == (2, 4, 64, 48)
        assert all(np.array_equal(a, b) for a, b in zip(ids_p, ids_k, strict=True))
        assert np.max(np.abs(kern - plain)) <= 1e-5 * np.max(np.abs(plain))


def test_flash_attention_kernel_at_the_olmoe_tp2_rank_shape(cuda):
    """Shape (k): olmoe-1b-7b's rank at tp = 2 (8 of 16 query and KV heads,
    hd 128), causal, at 2048 tokens."""
    from repro_torch.kernels.flash_attention import kernel, ops

    case = dict(B=1, S=2048, T=2048, H=8, KV=8, hd=128)
    q, k, v = _flash_case(cuda, case, torch.float32, seed=11)
    launches = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=True)
    assert ops.flash_attention.launches - launches == kernel.launches_per_call(
        kernel.splits(q, k, causal=True))
    torch.testing.assert_close(got, ops.flash_attention_ref(q, k, v, causal=True),
                               atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# cross-attention and the encoder on the model shard: llama-vision and hubert
# smoke at tp = 2, two gloo ranks sharing the card, and flash_attention at
# their ranks' heads
# ---------------------------------------------------------------------------

def _ranks_card_tp_cross(rank, world, arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.parallel import tensor_parallel as tp
    from repro_torch.parallel.sharding import model_shard
    from repro_torch.runtime import ShardPlan

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_local_mesh(1, 2)
    plan = ShardPlan(mesh)
    cfg = get_smoke_config(arch)
    params = plan.draw_local(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(8)
    memory = None
    if cfg.family == "vlm":
        params["groups"]["b4_cross"]["cross"]["gate"].fill_(0.5)
        memory = torch.as_tensor(rng.normal(size=(2, cfg.frontend_tokens, cfg.frontend_dim)),
                                 dtype=torch.float32, device=dev)
        x = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 40)), device=dev)
    else:
        x = torch.as_tensor(rng.normal(size=(2, 40, cfg.frontend_dim)), dtype=torch.float32,
                            device=dev)
    out = {}
    with torch.no_grad(), model_shard(mesh):
        for use_pallas in (False, True):
            c = dataclasses.replace(cfg, use_pallas=use_pallas)
            calls = ops.flash_attention.calls
            lg, _ = lm.forward(params, c, x, memory=memory)
            out[use_pallas] = (tp.join_vocab(lg, cfg.vocab).cpu().numpy(),
                               ops.flash_attention.calls - calls)
    out["wq"] = tuple(params["groups"]["b0_attn"]["attn"]["wq"].shape)
    return out


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "hubert-xlarge"])
def test_vlm_and_encoder_at_tp2_use_pallas_forward_matches_plain_on_the_card(cuda, arch):
    """Each of two gloo ranks on cuda:0 computes the smoke config on its 2
    of 4 query heads (``flash_attention`` once a self-attention layer,
    non-causal for the encoder; llama's cross blocks, gates open, on its
    heads too, plain); the joined logits of every position within 1e-5 of
    max |logit| of the plain path's."""
    from repro_torch.launch.spawn import run_ranks

    for out in run_ranks(_ranks_card_tp_cross, 2, (arch,), backend="gloo", timeout_s=300):
        plain, calls_p = out[False]
        kern, calls_k = out[True]
        n_attn = 4 if arch == "llama-3.2-vision-90b" else 2     # the smoke configs' layers
        assert calls_p == 0 and calls_k == n_attn
        assert out["wq"][-1] == 2 * 16
        assert np.max(np.abs(kern - plain)) <= 1e-5 * np.max(np.abs(plain))


@pytest.mark.parametrize("case", [dict(H=8, KV=8, hd=80, causal=False),
                                  dict(H=32, KV=4, hd=128, causal=True)],
                         ids=["l_hubert_tp2", "m_llama_vision_tp2"])
def test_flash_attention_kernel_at_the_cross_and_encoder_tp2_rank_shapes(cuda, case):
    """Shapes (l) and (m): hubert-xlarge's rank at tp = 2 (8 of 16 heads,
    hd 80, non-causal) and llama-3.2-vision-90b's (32 of 64 query and 4 of
    8 KV heads, hd 128, causal), at 2048 tokens."""
    from repro_torch.kernels.flash_attention import kernel, ops

    shape = dict(B=1, S=2048, T=2048, H=case["H"], KV=case["KV"], hd=case["hd"])
    q, k, v = _flash_case(cuda, shape, torch.float32, seed=13)
    launches = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=case["causal"])
    assert ops.flash_attention.launches - launches == kernel.launches_per_call(
        kernel.splits(q, k, causal=case["causal"]))
    torch.testing.assert_close(got, ops.flash_attention_ref(q, k, v, causal=case["causal"]),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", [dict(H=3, KV=1), dict(H=4, KV=1)],
                         ids=["n_internlm2_tp16", "o_llama_vision_tp16"])
def test_flash_attention_kernel_at_the_tp16_rank_shapes(cuda, case):
    """Shapes (n) and (o): internlm2-20b's and llama-3.2-vision-90b's rank
    at tp = 16 (3 and 4 query heads against the one KV head they read, hd
    128), causal, at 2048 tokens."""
    from repro_torch.kernels.flash_attention import kernel, ops

    shape = dict(B=1, S=2048, T=2048, H=case["H"], KV=case["KV"], hd=128)
    q, k, v = _flash_case(cuda, shape, torch.float32, seed=17)
    launches = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=True)
    assert ops.flash_attention.launches - launches == kernel.launches_per_call(
        kernel.splits(q, k, causal=True))
    torch.testing.assert_close(got, ops.flash_attention_ref(q, k, v, causal=True),
                               atol=1e-5, rtol=1e-5)


def _ranks_card_tp_heads(rank, world):
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.parallel import tensor_parallel as tp
    from repro_torch.parallel.sharding import model_shard
    from repro_torch.runtime import ShardPlan

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_local_mesh(1, world)
    out = {}
    # the exact join of 8-column blocks (half a head of 16), and its adjoint:
    # each rank weighs the whole with its own numbers
    full = torch.as_tensor(np.random.default_rng(0).normal(size=(2, 5, 8 * world)),
                           dtype=torch.float32, device=dev)
    mine = full[..., rank * 8:(rank + 1) * 8].clone().requires_grad_(True)
    w = torch.as_tensor(np.random.default_rng(1 + rank).normal(size=(2, 5, 8 * world)),
                        dtype=torch.float32, device=dev)
    with model_shard(mesh):
        (joined,) = tp.join_heads(mine)
        (joined * w).sum().backward()
    out["joined_equal"] = torch.equal(joined.detach(), full)
    out["grad"] = mine.grad.cpu().numpy()
    # internlm2 smoke at tp = 4: 1.5 query heads and half a KV head a rank
    cfg = get_smoke_config("internlm2-20b")
    params = ShardPlan(mesh).draw_local(cfg, torch.Generator(device=dev).manual_seed(0),
                                        device=dev)
    x = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab, (2, 40)), device=dev)
    with torch.no_grad(), model_shard(mesh):
        for use_pallas in (False, True):
            c = dataclasses.replace(cfg, use_pallas=use_pallas)
            calls = ops.flash_attention.calls
            lg, caches = lm.prefill(params, c, x)
            out[use_pallas] = (tp.join_vocab(lg, cfg.vocab).cpu().numpy(),
                               ops.flash_attention.calls - calls,
                               tuple(caches["groups"]["b0_attn"]["k"].shape))
    return out


def test_heads_cut_into_halves_on_four_gloo_ranks_on_the_card(cuda):
    """Four gloo ranks on cuda:0: ``join_heads`` joins each rank's half
    head bit for bit, and its backward gives each rank the sum over the
    ranks of the gradient's block; internlm2 smoke (6 query and 2 KV heads
    of 16: 24 and 8 columns a rank) through ``flash_attention`` on the
    query heads covering each rank's ``wo`` rows (2 heads, against the KV
    head they read), the cache holding both KV heads; the joined logits
    within 1e-5 of max |logit| of the plain path's."""
    from repro_torch.launch.spawn import run_ranks

    world = 4
    ws = [np.random.default_rng(1 + r).normal(size=(2, 5, 8 * world)) for r in range(world)]
    total = np.sum(ws, axis=0).astype(np.float32)
    for rank, out in enumerate(run_ranks(_ranks_card_tp_heads, world, backend="gloo",
                                         timeout_s=300)):
        assert out["joined_equal"]
        np.testing.assert_allclose(out["grad"], total[..., rank * 8:(rank + 1) * 8],
                                   rtol=1e-6, atol=1e-6)
        plain, calls_p, kshape = out[False]
        kern, calls_k, _ = out[True]
        assert calls_p == 0 and calls_k == 2 and kshape == (2, 2, 40, 2, 16)
        assert np.max(np.abs(kern - plain)) <= 1e-5 * np.max(np.abs(plain))
