"""The port's CUDA kernels on the card, against their plain PyTorch versions:
``lstm_seq``, the generated stage kernel (``codegen_stage``) and ``tanh_lut``.

Every test here needs a CUDA device (a CUDA kernel has no CPU mode) and
skips without one.  On a machine with the card (which has no JAX, so the
JAX-configuring ``tests/conftest.py`` is not loaded):

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_gpu.py

Tolerance: 1e-5 (atol = rtol) at small widths, 1e-4 at full width, where
fp32 sums over a 2048-long contraction are taken in another order than
cuBLAS's and compound over the time steps; 1e-6 for ``tanh_lut``, the same
arithmetic as its plain version up to FMA contraction.
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


@pytest.mark.parametrize("B,T,D,H,tol", [
    (1, 16, 8, 8, 1e-5),
    (3, 7, 12, 16, 1e-5),       # prime T, ragged hidden tile
    (2, 1, 8, 8, 1e-5),         # T = 1
    (11, 5, 20, 36, 1e-5),      # B over one batch tile, H not a multiple of 8
    (8, 37, 1024, 1024, 1e-4),  # full width
])
def test_lstm_seq_kernel_matches_plain(cuda, B, T, D, H, tol):
    from repro_torch.kernels.lstm_cell import ops

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


# ---------------------------------------------------------------------------
# the generated stage kernel (codegen) and the ROM-LUT tanh
# ---------------------------------------------------------------------------

def _stage_case(dev, cell, D, H, B, T, seed=0):
    """A bare cell stage with random weights, registers and inputs on ``dev``."""
    from repro_torch.codegen import CELL_GRAPHS, Schedule, Stage
    from repro_torch.codegen.builders import mlp_graph

    r = np.random.default_rng(seed)
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


@pytest.mark.parametrize("cell,D,H,B,T,quant,lut_bits,tol", [
    ("lstm", 8, 8, 1, 16, None, None, 1e-5),
    ("lstm", 12, 20, 11, 7, None, None, 1e-5),     # B over one row tile, prime T
    ("gru", 9, 5, 3, 1, None, None, 1e-5),         # T = 1
    ("ssm", 16, 33, 9, 5, None, None, 1e-5),
    ("mlp", 0, 32, 64, 31, None, None, 1e-5),      # per-step ROM pages (FIG10_B width)
    ("lstm", 8, 12, 2, 9, None, 8, 1e-5),          # LUT gates
    ("gru", 8, 12, 2, 9, 8, None, 1e-5),           # int8 shared ROMs
    ("mlp", 0, 16, 5, 6, 8, None, 1e-5),           # int8 per-step pages
    ("lstm", 1024, 1024, 8, 37, None, None, 1e-4),  # full width
    ("lstm", 1000, 400, 8, 3, None, None, 1e-4),    # 8 rows x 1400: over 48 KB of smem
])
def test_codegen_stage_kernel_matches_plain(cuda, cell, D, H, B, T, quant, lut_bits, tol):
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
    fin_p, ys_p = lower.interpret(run.plan, packed, x0, us, T, lut)
    _close(list(fin.values()) + ([] if ys is None else [ys]),
           [fin_p[k] for k in fin] + ([] if ys_p is None else [ys_p]), tol)
    if quant is None and lut is None and cell != "mlp":   # the independent oracle
        fin_e, ys_e = eager_backend.compile_stage(stage)(consts, x0, us)
        _close([fin[k] for k in fin_e] + [ys], list(fin_e.values()) + [ys_e], tol)


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
