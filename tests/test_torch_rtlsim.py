"""The port's bit-accurate RTL simulator and its fixed-point golden model on
the CPU against the JAX reference's.

Programs cross over through ``bridge``.  Output words, real outputs, final
state registers, FSM cycles, observed wire ranges and injected single-event
upsets must equal the reference's exactly, at every legal width and with
words that overflow and wrap; the port's rtlsim must equal the port's golden
model word for word.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import codegen as jcg  # noqa: E402
from repro.codegen import rtlsim as jr  # noqa: E402
from repro.core.synthesis import NetworkSpec as JSpec  # noqa: E402
from repro.runtime import faults as jfaults  # noqa: E402
from repro.verify import golden as jg  # noqa: E402
from repro_torch.bridge import program_from_jax  # noqa: E402
from repro_torch.codegen import rtlsim as pr  # noqa: E402
from repro_torch.core.synthesis import NetworkSpec  # noqa: E402
from repro_torch.runtime import faults as pfaults  # noqa: E402
from repro_torch.verify import golden as pg  # noqa: E402

CPU = torch.device("cpu")


def bridged(jspec):
    jprog = jcg.build_program(jspec)
    pprog = program_from_jax(jax.tree.map(np.asarray, jprog.params),
                             NetworkSpec(**dataclasses.asdict(jspec)), device="cpu")
    return jprog, pprog


def inputs(spec, batch=3, scale=1.0, seed=0):
    shape = (batch, spec.num_inputs) if spec.cell == "mlp" \
        else (batch, spec.seq_len, spec.num_inputs)
    if spec.c_slow > 1:
        shape = (spec.c_slow,) + shape
    return np.random.default_rng(seed).uniform(-scale, scale, size=shape).astype(np.float32)


# input scale 6 drives the AF ROMs' clamps and, at narrow widths, wraps
CASES = {
    "mlp_tanh_q8_wraps": (JSpec(3, 4, 5, 2, quant_bits=8), 6.0),
    "mlp_sigmoid_q16_j3": (JSpec(4, 3, 5, 2, activation="sigmoid", quant_bits=16, unroll=3), 1.0),
    "mlp_relu_q32_c2": (JSpec(3, 2, 4, 2, activation="relu", quant_bits=32, c_slow=2), 6.0),
    "mlp_gelu_q24": (JSpec(3, 2, 4, 3, activation="gelu", quant_bits=24), 3.0),
    "mlp_silu_q30": (JSpec(3, 2, 4, 3, activation="silu", quant_bits=30), 3.0),
    "lstm_q18_j2": (JSpec(2, 2, 4, 2, cell="lstm", seq_len=6, unroll=2), 1.0),
    "lstm_q8_wraps": (JSpec(3, 1, 5, 2, cell="lstm", seq_len=5, quant_bits=8), 6.0),
    "lstm_q32_c3_j4": (JSpec(2, 1, 4, 2, cell="lstm", seq_len=4, quant_bits=32, c_slow=3,
                             unroll=4), 6.0),
    "gru_q24_c2": (JSpec(2, 2, 4, 2, cell="gru", seq_len=5, quant_bits=24, c_slow=2), 1.0),
    "gru_q8": (JSpec(3, 1, 7, 1, cell="gru", seq_len=7, quant_bits=8), 6.0),
    "ssm_q12_j4": (JSpec(2, 2, 5, 2, cell="ssm", seq_len=7, quant_bits=12, unroll=4), 6.0),
    "ssm_q32": (JSpec(2, 3, 4, 2, cell="ssm", seq_len=9, quant_bits=32), 6.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_simulate_matches_reference(name):
    jspec, scale = CASES[name]
    jprog, pprog = bridged(jspec)
    u = inputs(jspec, scale=scale)
    a = jr.simulate(jprog, u, collect_ranges=True)
    b = pr.simulate(pprog, u, collect_ranges=True, device=CPU)
    np.testing.assert_array_equal(b.y_codes.numpy(), a.y_codes)
    np.testing.assert_array_equal(b.y.numpy(), a.y)
    assert (b.cycles, b.width, b.fmt.total_bits, b.fmt.frac_bits) == \
        (a.cycles, a.width, a.fmt.total_bits, a.fmt.frac_bits)
    assert b.cycles == pr.fsm_cycle_estimate(pprog, T=None if jspec.cell == "mlp"
                                             else jspec.seq_len)
    assert sorted(b.final_states) == sorted(a.final_states)
    for k, v in a.final_states.items():
        np.testing.assert_array_equal(b.final_states[k].numpy(), v)
    assert sorted(b.wire_ranges) == sorted(a.wire_ranges)
    for k, (lo, hi) in a.wire_ranges.items():
        np.testing.assert_array_equal(b.wire_ranges[k][0], lo)
        np.testing.assert_array_equal(b.wire_ranges[k][1], hi)
    assert b.seu_flips == a.seu_flips == []


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden_model_matches_reference_and_rtlsim(name):
    jspec, scale = CASES[name]
    jprog, pprog = bridged(jspec)
    u = inputs(jspec, scale=scale, seed=1)
    want = jg.fixed_forward(jprog, u)
    got = pg.fixed_forward(pprog, u, device=CPU)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(pr.simulate(pprog, u, device=CPU).y_codes, got)
    # the word width argument overrides the spec's
    for width in (8, 20, 32):
        np.testing.assert_array_equal(pg.fixed_forward(pprog, u, width=width, device=CPU).numpy(),
                                      jg.fixed_forward(jprog, u, width=width))


def test_an_overflowing_macc_wraps_as_the_reference_does():
    """All weights +127 (6.0 at 8 bits), inputs 1.0 (word 16): the exact
    Q-aligned MACC word is (2·16·127) >> 4 = 254, past the 8-bit word range,
    so the bus wraps negative although every operand is positive."""
    jspec = JSpec(2, 1, 4, 2, cell="lstm", seq_len=3, quant_bits=8)
    jprog, pprog = bridged(jspec)
    jst = jprog.stages[0]
    jst.params["W"] = jax.numpy.full_like(jst.params["W"], 6.0)
    jst.params["b"] = jax.numpy.zeros_like(jst.params["b"])
    pprog.stages[0].params["W"] = torch.full_like(pprog.stages[0].params["W"], 6.0)
    pprog.stages[0].params["b"] = torch.zeros_like(pprog.stages[0].params["b"])
    u = np.ones((1, 3, 2), np.float32)
    a = jr.simulate(jprog, u, collect_ranges=True)
    b = pr.simulate(pprog, u, collect_ranges=True, device=CPU)
    z_lo = b.wire_ranges["layer0.z"][0]
    assert int(z_lo.min()) < 0 and (2 * 16 * 127) >> 4 > 127
    np.testing.assert_array_equal(z_lo, a.wire_ranges["layer0.z"][0])
    np.testing.assert_array_equal(b.y_codes.numpy(), a.y_codes)
    np.testing.assert_array_equal(pg.fixed_forward(pprog, u, device=CPU).numpy(), a.y_codes)


@pytest.mark.parametrize("seed,payload", [(3, {}), (11, {"state": "c", "bit": 7}),
                                          (5, {"index": 1})])
def test_seu_injection_matches_reference(seed, payload):
    jspec = JSpec(2, 2, 4, 2, cell="lstm", seq_len=6, quant_bits=16)
    jprog, pprog = bridged(jspec)
    u = inputs(jspec)
    jplan = jfaults.FaultPlan([jfaults.FaultSpec("rtlsim.seu", prob=0.5, times=3,
                                                 payload=payload)], seed=seed)
    pplan = pfaults.FaultPlan([pfaults.FaultSpec("rtlsim.seu", prob=0.5, times=3,
                                                 payload=payload)], seed=seed)
    a = jr.simulate(jprog, u, fault_plan=jplan)
    b = pr.simulate(pprog, u, fault_plan=pplan, device=CPU)
    assert a.seu_flips and b.seu_flips == a.seu_flips
    np.testing.assert_array_equal(b.y_codes.numpy(), a.y_codes)
    assert pplan.report() == jplan.report()
    # the ambient plan is consulted too, and the flips move the words off
    # the golden model's
    with pfaults.active(pfaults.FaultPlan([pfaults.FaultSpec("rtlsim.seu", times=6)],
                                          seed=seed)):
        c = pr.simulate(pprog, u, device=CPU)
    assert len(c.seu_flips) == 6
    assert not torch.equal(c.y_codes, pg.fixed_forward(pprog, u, device=CPU))


@pytest.mark.parametrize("width", [8, 18, 32])
def test_word_primitives_match_reference(width):
    r = np.random.default_rng(width)
    v = r.integers(-(1 << 62), 1 << 62, size=4096, dtype=np.int64)
    w = r.integers(-(1 << (width - 1)), 1 << (width - 1), size=4096, dtype=np.int64)
    t, tw = torch.as_tensor(v), torch.as_tensor(w)
    for bits in (width, 2 * width):
        np.testing.assert_array_equal(pr.wrap(t, bits).numpy(), jr.wrap(v, bits))
    np.testing.assert_array_equal(pr.macc_word(t, width).numpy(), jr.macc_word(v, width))
    np.testing.assert_array_equal(pr.af_addr(tw, width).numpy(), jr.af_addr(w, width))
    fmt = pr.default_format(width)
    x = r.uniform(-10, 10, size=257)
    np.testing.assert_array_equal(pr.words_of(x, fmt).numpy(), jr.words_of(x, fmt))
    for fn in ("tanh", "sigmoid", "gelu", "silu"):
        np.testing.assert_array_equal(pr.af_rom(fn, fmt).numpy(), jr.af_rom(fn, fmt))


@pytest.mark.parametrize("width,unroll", [(8, 1), (18, 3), (32, 1), (32, 4)])
def test_macc_layer_matches_the_serial_reference(width, unroll):
    """Full-range words at 32 bits overflow int64 products' sum: the limb
    GEMM must wrap exactly as the reference's serial int64 loop does."""
    r = np.random.default_rng(unroll)
    half = 1 << (width - 1)
    x = r.integers(-half, half, size=(3, 37), dtype=np.int64)
    wq = r.integers(-half, half, size=(37, 11), dtype=np.int64)
    b = r.integers(-half, half, size=11, dtype=np.int64)
    got = pr.macc_layer(torch.as_tensor(x), torch.as_tensor(wq), width,
                        bias=torch.as_tensor(b), unroll=unroll)
    np.testing.assert_array_equal(got.numpy(), jr.macc_layer(x, wq, width, bias=b,
                                                             unroll=unroll))


def test_illegal_width_and_input_rank_raise():
    _, pprog = bridged(JSpec(2, 1, 3, 1))
    for width in (7, 33):
        with pytest.raises(ValueError, match="rtlsim"):
            pr.simulate(pprog, np.zeros((1, 2), np.float32), width=width, device=CPU)
        with pytest.raises(ValueError, match="golden model"):
            pg.fixed_forward(pprog, np.zeros((1, 2), np.float32), width=width, device=CPU)
    with pytest.raises(ValueError, match="expected u.ndim=2"):
        pr.simulate(pprog, np.zeros((1, 1, 2), np.float32), device=CPU)
