"""The port stands alone: no JAX, nothing of the reference package, and no
silent CPU path when the card is asked for."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_the_reference_package():
    files = _port_files()
    assert len(files) > 20
    names = {str(f.relative_to(PORT)) for f in files if PORT in f.parents}
    for module in ("models/ssm.py", "core/transition.py", "configs/falcon_mamba_7b.py",
                   "kernels/ssm_scan/ops.py", "kernels/ssm_scan/kernel.py",
                   "kernels/ssm_scan/ref.py", "kernels/int8_matmul/ops.py",
                   "kernels/int8_matmul/kernel.py", "kernels/int8_matmul/ref.py",
                   "models/attention.py", "configs/smollm_135m.py", "configs/phi4_mini_3_8b.py",
                   "kernels/flash_attention/ops.py", "kernels/flash_attention/kernel.py",
                   "kernels/flash_attention/ref.py", "runtime/faults.py",
                   "runtime/prefix_cache.py", "runtime/loadgen.py", "obs/check.py",
                   "obs/report.py", "launch/serve.py", "codegen/knobs.py",
                   "codegen/af_samples.py", "codegen/verilog.py", "codegen/rtlsim.py",
                   "verify/__init__.py", "verify/golden.py", "verify/difftest.py",
                   "analyze/__init__.py", "analyze/__main__.py", "analyze/intervals.py",
                   "analyze/report.py", "analyze/waivers.py", "analyze/ranges.py",
                   "analyze/errors.py", "analyze/hazards.py", "analyze/lint.py",
                   "verify/chaos.py", "tune/__init__.py", "tune/__main__.py",
                   "tune/space.py", "tune/pareto.py", "tune/search.py", "tune/report.py"):
        assert module in names, module
    bad = {str(f.relative_to(ROOT)): sorted(_imported_roots(f) & FORBIDDEN) for f in files}
    assert {k: v for k, v in bad.items() if v} == {}
    # the match is on the exact module name: repro_torch is not repro
    assert "repro_torch" in _imported_roots(PORT / "models" / "lm.py")


def test_importing_every_port_module_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(len(bad), bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120, check=True)
    assert out.stdout.strip() == "0 []", out.stdout + out.stderr


def test_entry_points_default_to_the_card():
    """Without ``device=``, the entry points ask for CUDA and raise on a
    machine without it — they never run on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.lstm_cell import ops
    from repro_torch.models import lm
    from repro_torch.runtime.server import DecodeServer

    cfg = get_smoke_config("paper-lstm")
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(cfg, torch.Generator().manual_seed(0))
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeServer(cfg, params, num_slots=2, max_seq=16)
    # a tensor that is not on the CPU goes to the kernel, never to the plain path
    x = torch.empty((1, 3, 8), device="meta")
    w_x, w_h, b = (torch.empty(s, device="meta") for s in ((8, 32), (8, 32), (32,)))
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.lstm_seq(x, w_x, w_h, b)

    # the generator's entry points: program, backends, synthesize, runner
    from repro_torch import codegen
    from repro_torch.codegen import eager_backend, kernel_backend
    from repro_torch.configs.paper_mlp import CASE_STUDY
    from repro_torch.core import synthesis
    from repro_torch.kernels.tanh_lut import ops as lut_ops

    for call in (lambda: codegen.build_program(CASE_STUDY),
                 lambda: codegen.compile_spec(CASE_STUDY, "kernel"),
                 lambda: synthesis.synthesize(CASE_STUDY, backend="kernel"),
                 lambda: synthesis.create_top_module(CASE_STUDY),
                 lambda: codegen.cell_stage_runner("gru", 4, 3)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    prog = codegen.build_program(CASE_STUDY, device="cpu")
    for backend in (eager_backend, kernel_backend):
        with pytest.raises(RuntimeError, match="CUDA"):
            backend.compile_program(prog)
    with pytest.raises(RuntimeError, match="CUDA"):
        lut_ops.tanh_lut(torch.empty(4, device="meta"), torch.empty(64, device="meta"))

    # the Mamba-1 slice: falcon-mamba's parameters, the selective scan and
    # the int8 MACC matmul
    from repro_torch.kernels.int8_matmul import ops as i8_ops
    from repro_torch.kernels.ssm_scan import ops as scan_ops

    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(get_smoke_config("falcon-mamba-7b"), torch.Generator().manual_seed(0))
    meta = lambda *shape, **kw: torch.empty(shape, device="meta", **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        scan_ops.ssm_scan(meta(1, 3, 8), meta(1, 3, 8), meta(8, 4), meta(1, 3, 4), meta(1, 3, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        i8_ops.int8_matmul(meta(2, 3, dtype=torch.int8), meta(3, 4, dtype=torch.int8),
                           meta(2, 1), meta(1, 4))
    assert scan_ops.ssm_scan.launches == 0 and i8_ops.int8_matmul.launches == 0

    # the dense slice: smollm's parameters and the attention kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops

    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(get_smoke_config("smollm-135m"), torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        fa_ops.flash_attention(meta(1, 4, 3, 16), meta(1, 4, 1, 16), meta(1, 4, 1, 16))
    assert fa_ops.flash_attention.launches == 0

    # the bit path and its tools: rtlsim, the golden model, the analyzer's
    # program, difftest's cases
    import numpy as np

    from repro_torch.analyze import analyze_spec
    from repro_torch.codegen import rtlsim
    from repro_torch.verify import difftest, golden

    u = np.zeros((1, CASE_STUDY.num_inputs), np.float32)
    for call in (lambda: rtlsim.simulate(prog, u), lambda: golden.fixed_forward(prog, u),
                 lambda: analyze_spec(CASE_STUDY),
                 lambda: synthesis.synthesize(CASE_STUDY, backend="verilog"),
                 lambda: difftest.run_case(difftest.gen_case(0)),
                 lambda: difftest.main(["--seeds", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
