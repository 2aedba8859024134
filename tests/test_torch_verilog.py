"""The port's Verilog emitter, its resource report, the AF-ROM sample table
and the knob rules on the CPU against the JAX reference.

RTL text must be byte-identical to the reference's emission for the same
program and weights: the weights cross over through ``bridge`` (never
against ``tests/golden/*.v``, which predate the installed JAX's random
stream).  The AF ROMs hold the reference's float32 samples; the words they
quantize to are held against JAX at every legal width, 8 to 32.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import codegen as jcg  # noqa: E402
from repro.codegen import knobs as jknobs  # noqa: E402
from repro.codegen import verilog as jv  # noqa: E402
from repro.configs import paper_mlp as j_paper  # noqa: E402
from repro.core.quantization import FixedPointFormat as JFmt  # noqa: E402
from repro.core.state_space import ACTIVATIONS as J_ACTS  # noqa: E402
from repro.core.synthesis import NetworkSpec as JSpec  # noqa: E402
from repro.verify import difftest as jdt  # noqa: E402
from repro_torch.bridge import program_from_jax  # noqa: E402
from repro_torch.codegen import af_samples, knobs, verilog  # noqa: E402
from repro_torch.core.quantization import FixedPointFormat  # noqa: E402
from repro_torch.core.synthesis import NetworkSpec  # noqa: E402

ROM_FNS = ("gelu", "sigmoid", "silu", "tanh")


def bridged(jspec):
    """The reference's program for ``jspec`` and the port's carrying the
    same weights (on the CPU)."""
    jprog = jcg.build_program(jspec)
    pprog = program_from_jax(jax.tree.map(np.asarray, jprog.params),
                             NetworkSpec(**dataclasses.asdict(jspec)), device="cpu")
    return jprog, pprog


SPECS = {**jdt.golden_specs(),
         "case_study": j_paper.CASE_STUDY, "fig10_a": j_paper.FIG10_A,
         "fig10_b": j_paper.FIG10_B,
         "lstm_j3_c2": JSpec(3, 2, 5, 2, cell="lstm", seq_len=4, unroll=3, c_slow=2),
         "mlp_sigmoid_q12": JSpec(4, 3, 6, 3, activation="sigmoid", quant_bits=12)}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_rtl_is_the_reference_text(name):
    jprog, pprog = bridged(SPECS[name])
    assert verilog.emit_program(pprog) == jv.emit_program(jprog)


@pytest.mark.parametrize("seed", range(20))
def test_rtl_of_difftest_seeds_is_the_reference_text(seed):
    jprog, pprog = bridged(jdt.gen_case(seed).spec)
    assert verilog.emit_program(pprog) == jv.emit_program(jprog)


@pytest.mark.parametrize("bits", [23, 24, 27, 32])
@pytest.mark.parametrize("act", ["tanh", "gelu", "silu", "sigmoid"])
def test_rtl_at_wide_words_keeps_the_reference_rom_words(bits, act):
    """At 23 bits and more, ROM words quantized from torch's own activations
    would differ from the reference's; the sample table keeps them equal."""
    jprog, pprog = bridged(JSpec(3, 2, 4, 2, activation=act, quant_bits=bits))
    assert verilog.emit_program(pprog) == jv.emit_program(jprog)


@pytest.mark.parametrize("bits", [23, 32])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_recurrent_rtl_at_wide_words(cell, bits):
    jprog, pprog = bridged(JSpec(2, 1, 4, 2, cell=cell, seq_len=3, quant_bits=bits))
    assert verilog.emit_program(pprog) == jv.emit_program(jprog)


@pytest.mark.parametrize("fn", ROM_FNS)
def test_af_samples_are_the_reference_float32_values(fn):
    n = 2 ** af_samples.AF_ADDR_BITS
    centers = (np.arange(n) + 0.5) / n * 8.0 - 4.0
    want = np.asarray(J_ACTS[fn](centers.astype(np.float32)))
    assert want.dtype == np.float32
    np.testing.assert_array_equal(np.asarray(af_samples.samples(fn), np.float32), want)
    # the table holds float32 values exactly
    assert all(float(np.float32(v)) == v for v in af_samples.samples(fn))


@pytest.mark.parametrize("fn", ROM_FNS)
def test_af_rom_words_match_the_reference_at_every_width(fn):
    for bits in range(knobs.WORD_BITS_MIN, knobs.WORD_BITS_MAX + 1):
        got = verilog._af_rom_entries(fn, FixedPointFormat(bits, bits - 4))
        want = jv._af_rom_entries(fn, JFmt(bits, bits - 4))
        assert got == want, (fn, bits)
        assert verilog.create_af(fn, bits) == jv.create_af(fn, bits)


def test_af_samples_cover_the_rom_activations_only():
    assert sorted(af_samples.SAMPLES) == list(ROM_FNS)
    assert verilog.AF_ADDR_BITS == jv.AF_ADDR_BITS == af_samples.AF_ADDR_BITS
    with pytest.raises(ValueError, match="no ROM samples"):
        af_samples.samples("relu")
    for fn in ("relu", "identity"):       # combinational in the RTL
        assert verilog.create_af(fn, 18) == jv.create_af(fn, 18)


@pytest.mark.parametrize("name", ["case_study", "fig10_a", "lstm_j3_c2", "ssm_h4_q16"])
def test_resource_report_matches_reference(name):
    jprog, pprog = bridged(SPECS[name])
    got = dataclasses.asdict(verilog.report_program(pprog))
    want = dataclasses.asdict(jv.report_program(jprog))
    assert got == want
    assert verilog.report_program(pprog).summary() == jv.report_program(jprog).summary()


def test_emit_program_refuses_an_illegal_width():
    _, pprog = bridged(JSpec(3, 1, 4, 2))
    pprog.spec = dataclasses.replace(pprog.spec, quant_bits=33)
    with pytest.raises(ValueError, match="verilog backend: quant_bits=33"):
        verilog.emit_program(pprog)


def test_module_emitters_match_reference():
    assert verilog.create_mult(18) == jv.create_mult(18)
    r = np.random.default_rng(0)
    coeffs, bias = r.normal(size=(2, 5, 7)), r.normal(size=(2, 5))
    for kw in (dict(per_step=True, steps=2, has_bias=True, coeffs=coeffs, bias=bias),
               dict(per_step=False, steps=4, coeffs=coeffs[0])):
        args = ("Create_Layer_x", 7, 5, 20, 3)
        assert verilog.create_layer(*args, **kw) == jv.create_layer(*args, **kw)
        # tensors on the host read as the same float64 values
        kw_t = {k: torch.as_tensor(v, dtype=torch.float64) if isinstance(v, np.ndarray) else v
                for k, v in kw.items()}
        assert verilog.create_layer(*args, **kw_t) == jv.create_layer(*args, **kw)


PORT_BACKEND = {"xla": "eager", "pallas": "kernel", "verilog": "verilog"}


@pytest.mark.parametrize("ref_backend", sorted(PORT_BACKEND))
def test_knob_rules_mirror_the_reference(ref_backend):
    backend = PORT_BACKEND[ref_backend]
    for cell in ("mlp", "lstm", "gru", "ssm"):
        for bits in (None, 4, 8, 12, 32, 33):
            got = knobs.quant_reason(backend, cell, bits)
            want = jknobs.quant_reason(ref_backend, cell, bits)
            assert (got is None) == (want is None), (backend, cell, bits)
        for kw in (dict(unroll=0), dict(c_slow=0), dict(double_buffer=False),
                   dict(chunk=8), dict(chunk=0), dict(block_b=0), dict(quant_bits=12)):
            got = knobs.knob_reason(backend, cell, **kw)
            want = jknobs.knob_reason(ref_backend, cell, **kw)
            assert (got is None) == (want is None), (backend, cell, kw)
        assert knobs.normalize_pallas_knobs(backend, False, 4, 2) == \
            jknobs.normalize_pallas_knobs(ref_backend, False, 4, 2)
    for bits in range(6, 36):
        assert (knobs.word_bits_reason(bits) is None) == (jknobs.word_bits_reason(bits) is None)
