#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``src/repro_torch``) on one card.

    python3 chip_smoke.py            # from the root of a checkout, one CUDA card

Phases, one line per case (any failure exits non-zero and prints no result):

1. device — the card, its power limit, and the build of every kernel of the
   run from the sources in the checkout: ``lstm_seq.cu``, ``tanh_lut.cu``
   and every generated stage kernel, one ``nvcc`` each, all started together
   (into ``build/``);
2. ``lstm_seq`` vs its plain PyTorch version at full width, and its time
   beside the plain version's, one library call's and its bound;
3. serve — full-width ``paper-lstm`` (random weights from a seed) with
   ``use_pallas=True`` through ``DecodeServer``: 16 greedy requests under
   ``step()``, ``step_block()`` and chunked prefill; identical tokens across
   the three, ``lstm_seq`` launches counted at every prefill, and prefill
   logits held against the plain path;
4. ``codegen_stage`` — the generated stage kernel against the plan's
   interpreter (its plain version) and, for fp32, the eager backend, on
   twelve cases (cells at D = H = 1024, the Fig. 10 MLPs, LUT, int8,
   C-slow); its time at the prefill shape for lstm and gru beside the plain
   version, ``torch.nn.LSTM``/``GRU`` and ``lstm_seq``;
5. ``tanh_lut`` against its plain version, its time, and one drive of its
   entry point on a full-width prefill's gate pre-activations (no path of
   the port calls it, so its ``launches`` in the summary are 0);
6. serve ``use_codegen`` — full-width ``paper-gru`` and ``paper-lstm`` with
   ``use_codegen=True`` under ``step()`` and ``step_block()``, after one
   untimed prefill that builds the stage runners: every layer of every
   prefill through the generated kernel;
7. synth — ``synthesize(..., backend="kernel", fallback=False)`` on the
   paper's specs and full-width recurrent specs, each forward held against
   the eager backend (int8 against its plain version);
8. profile — the ``use_pallas`` ``step()`` run once more under
   ``torch.profiler``.

Then the kernel summary (one JSON line), the card's name and power limit as
``nvidia-smi`` reports them, and the result line.  Each phase prints its
seconds.  The script imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# fp32 peak outside the tensor cores and memory rate of one H100 SXM
# (NVIDIA data sheet; rates at the 700 W power limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

TOL = 1e-4          # kernel vs plain on the card, atol = rtol
LUT_TOL = 1e-6      # tanh_lut vs plain: the same fp32 arithmetic (up to FMA contraction)
LOGITS_ATOL = 1e-3  # fast-path prefill logits vs the plain path
SYNTH_TOL = 1e-3    # synthesize()'s forward vs eager (atol = rtol; 8 layers x 256 steps)
N_REQUESTS = 16
MAX_NEW = 32
NUM_SLOTS = 8
MAX_SEQ = 512
BLOCK_K = 8
CHUNK = 64
REPS = 20
WIDTH = 1024

PHASE_T0 = [time.perf_counter()]


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def phase_done(name: str) -> None:
    now = time.perf_counter()
    say("phase_time", name=name, seconds=f"{now - PHASE_T0[0]:.1f}")
    PHASE_T0[0] = now


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def flush_l2(buf: torch.Tensor) -> None:
    buf.add_(1.0)  # 128 MB write: evicts the 50 MB L2 between timed runs


def time_ms(fn, buf: torch.Tensor, reps: int = REPS) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after warm-up,
    with a cold L2 at the start of every run."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        flush_l2(buf)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def check_close(label: str, got, want, tol: float) -> float:
    """Every pair finite, of one shape, and within atol = rtol = ``tol``."""
    for g, w in zip(got, want):
        require(g.shape == w.shape and bool(torch.isfinite(g).all()),
                f"{label}: shape {tuple(g.shape)} vs {tuple(w.shape)} or non-finite values")
        err = (g - w).abs()
        require(bool((err <= tol + tol * w.abs()).all()),
                f"{label}: differs from the plain version by {float(err.max()):.3e}")
    return max_err(got, want)


def bound_ms(flops: float, n_bytes: float) -> tuple[float, str]:
    """The least time for the work: operations at the fp32 peak, or bytes
    (each input read once, each output written once) at the memory rate."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, n_bytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def lstm_inputs(gen, B, T, D, H, carry: bool):
    dev = gen.device
    x = torch.randn((B, T, D), generator=gen, device=dev)
    w_x = torch.randn((D, 4 * H), generator=gen, device=dev) / math.sqrt(D)
    w_h = torch.randn((H, 4 * H), generator=gen, device=dev) / math.sqrt(H)
    b = torch.randn((4 * H,), generator=gen, device=dev) * 0.2
    if carry:
        h0 = torch.randn((B, H), generator=gen, device=dev)
        c0 = torch.randn((B, H), generator=gen, device=dev)
    else:
        h0 = torch.zeros((B, H), device=dev)
        c0 = torch.zeros((B, H), device=dev)
    return x, w_x, w_h, b, h0, c0


def lstm_bound_ms(B, T, D, H) -> tuple[float, str]:
    """lstm_seq on these shapes: 2·B·T·(D+H)·4H operations; bytes of x, W,
    b, h0, c0 in and y, h, c out."""
    flops = 2.0 * B * T * (D + H) * 4 * H
    n_bytes = 4.0 * (B * T * D + (D + H) * 4 * H + 4 * H + 2 * B * H
                     + B * T * H + 2 * B * H)
    return bound_ms(flops, n_bytes)


def stage_bound_ms(graph, consts: dict, B: int, T: int) -> tuple[float, str]:
    """A generated stage on these shapes: macc_flops_per_step · B · T
    operations; bytes of the input, every const ROM (at its stored width),
    x0 in and y, finals out."""
    flops = float(graph.macc_flops_per_step()) * B * T
    inp = graph.input_node()
    out = graph.node(graph.output).width if graph.output is not None else 0
    n_bytes = sum(t.numel() * t.element_size() for t in consts.values())
    n_bytes += 4.0 * (B * T * (inp.width if inp is not None else 0)
                      + 2 * B * sum(graph.states.values()) + B * T * out)
    return bound_ms(flops, n_bytes)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import codegen
    from repro_torch.codegen import eager_backend, kernel_backend, lower
    from repro_torch.codegen.builders import mlp_graph
    from repro_torch.codegen.ir import Schedule, Stage
    from repro_torch.configs import get_config
    from repro_torch.configs.paper_lstm import gru_config
    from repro_torch.configs.paper_mlp import CASE_STUDY, FIG10_A, FIG10_B
    from repro_torch.core import synthesis
    from repro_torch.core.cslow import fold_streams, unfold_streams
    from repro_torch.core.synthesis import NetworkSpec
    from repro_torch.kernels import _build
    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
    from repro_torch.kernels.lstm_cell import ops as lstm_ops
    from repro_torch.kernels.tanh_lut import kernel as lut_kernel
    from repro_torch.kernels.tanh_lut import ops as lut_ops
    from repro_torch.kernels.tanh_lut.ref import make_lut, tanh_lut_ref
    from repro_torch.models import lm
    from repro_torch.obs import Observability
    from repro_torch.runtime.server import DecodeServer, Request

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    l2 = torch.zeros(32 * 1024 * 1024, device=dev)
    D = H = WIDTH

    # -- 1. device and build ---------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    card = smi.strip()

    def stage_of(cell: str, T: int, width: int = WIDTH, d_in: int = WIDTH) -> Stage:
        graph = mlp_graph(width, "tanh") if cell == "mlp" else codegen.CELL_GRAPHS[cell](d_in, width)
        return Stage(cell, graph, Schedule(steps=T), {})

    lut6 = make_lut(6, device=dev)
    variants = [(stage_of(c, 1), None, None) for c in ("lstm", "gru", "ssm", "mlp")]
    variants += [(stage_of("lstm", 1), lut6, None), (stage_of("lstm", 1), None, 8),
                 (stage_of("lstm", 1), lut6, 8), (stage_of("mlp", 1), None, 8),
                 (stage_of("mlp", 1, width=32), None, None),
                 (stage_of("mlp", 1, width=CASE_STUDY.nodes_per_layer), None, None)]
    sources = [kernel_backend.compile_stage(st, lut=lut, quant_bits=q).source
               for st, lut, q in variants]
    t0 = time.perf_counter()
    paths = _build.build_many([("lstm_seq", lstm_kernel.SOURCE), ("tanh_lut", lut_kernel.SOURCE)]
                              + [(kernel_backend.LIBRARY, s) for s in sources])
    build_s = time.perf_counter() - t0
    lstm_kernel.load()
    lut_kernel.load()
    say("device", torch=torch.__version__, cuda=torch.version.cuda,
        kind=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count(),
        card=repr(card), build_s=f"{build_s:.2f}", libraries=len(paths))
    for path in paths:
        for ln in path.with_suffix(".log").read_text().splitlines():
            if "registers" in ln or "spill" in ln:
                say("ptxas", library=path.name, line=repr(ln.strip()))
    phase_done("device_and_build")

    # -- 2. lstm_seq vs plain at full width ---------------------------------
    cfg = dataclasses.replace(get_config("paper-lstm"), use_pallas=True)
    cases = [("B1_T256_zero_carry", 1, 256, False, None),
             ("B8_T37_random_carry", 8, 37, True, None),
             ("B8_T1_random_carry", 8, 1, True, None),
             ("lut12_B4_T64_random_carry", 4, 64, True, make_lut(12, device=dev))]
    lstm_err = 0.0
    for name, B, T, carry, lut in cases:
        args = lstm_inputs(gen, B, T, D, H, carry)
        got = lstm_ops.lstm_seq(*args, lut=lut)
        want = (lstm_ops.lstm_seq_ref(*args) if lut is None
                else lstm_ops.lstm_seq_lut_ref(*args, lut))
        torch.cuda.synchronize()
        errs = [check_close(f"lstm_seq {name} {what}", [g], [w], TOL)
                for what, g, w in zip(("y", "h", "c"), got, want)]
        lstm_err = max(lstm_err, *errs)
        say("kernel_vs_plain", kernel="lstm_seq", case=name, D=D, H=H,
            max_abs_err_y_h_c=",".join(f"{e:.3e}" for e in errs), tol=TOL, ok=True)

    # timing at the main path's shape: a one-shot prefill of a 256-token
    # prompt, one call per layer (B=1, T=256, D=H=1024)
    B, T = 1, 256
    args = lstm_inputs(gen, B, T, D, H, carry=False)
    x, w_x, w_h, b, h0, c0 = args
    lstm_ms = time_ms(lambda: lstm_ops.lstm_seq(*args), l2)
    lstm_plain_ms = time_ms(lambda: lstm_ops.lstm_seq_ref(*args), l2)
    cudnn = torch.nn.LSTM(D, H, batch_first=True).to(dev)   # yardstick only
    with torch.no_grad():
        cudnn.weight_ih_l0.copy_(w_x.T)
        cudnn.weight_hh_l0.copy_(w_h.T)
        cudnn.bias_ih_l0.copy_(b)
        cudnn.bias_hh_l0.zero_()
        y_lib, _ = cudnn(x, (h0[None], c0[None]))
        y_k, _, _ = lstm_ops.lstm_seq(*args)
        lib_err = float((y_lib - y_k).abs().max())
        lstm_lib_ms = time_ms(lambda: cudnn(x, (h0[None], c0[None])), l2)
    lstm_bound, lstm_bound_by = lstm_bound_ms(B, T, D, H)
    say("kernel_time", kernel="lstm_seq", B=B, T=T, D=D, H=H, ms=f"{lstm_ms:.4f}",
        plain_ms=f"{lstm_plain_ms:.4f}", library_ms=f"{lstm_lib_ms:.4f}",
        library="torch.nn.LSTM(cuDNN)", library_max_abs_diff=f"{lib_err:.3e}",
        bound_ms=f"{lstm_bound:.4f}", bound_by=lstm_bound_by, reps=REPS, card=repr(card))
    del cudnn
    phase_done("lstm_seq")

    # -- 3. serve full-width paper-lstm (use_pallas) --------------------------
    rng = np.random.default_rng(1)
    lengths = rng.integers(16, 257, size=N_REQUESTS)
    lengths[0] = 256
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).tolist() for n in lengths]

    def serve(mcfg, params, label: str, block: bool, counter, **kw):
        """Drive ``DecodeServer`` over the 16 requests; ``counter`` is the
        wrapper whose launches this run must show at every prefill."""
        obs = Observability(trace=True)
        srv = DecodeServer(mcfg, params, num_slots=NUM_SLOTS, max_seq=MAX_SEQ,
                           block_k=BLOCK_K, obs=obs, **kw)
        for i, p in enumerate(prompts):
            srv.submit(Request(uid=i, prompt=p, max_new_tokens=MAX_NEW))
        torch.cuda.synchronize()
        counter.launches = 0
        t0 = time.perf_counter()
        done = srv.run_until_drained(persistent=block)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = counter.launches
        decode_ms = sum(ev["dur"] for ev in obs.tracer.events()
                        if ev.get("name") in ("decode_step", "decode_block")) / 1e3
        st = srv.stats()
        require(len(done) == N_REQUESTS,
                f"{mcfg.name} {label}: {len(done)} of {N_REQUESTS} requests retired")
        for r in done:
            require(r.finish_reason == "max_tokens" and len(r.out_tokens) == MAX_NEW,
                    f"{mcfg.name} {label}: request {r.uid} ended {r.finish_reason} "
                    f"after {len(r.out_tokens)} tokens")
        n_prefills = (sum(math.ceil(n / kw["prefill_chunk"]) for n in lengths)
                      if kw.get("prefill_chunk") else N_REQUESTS)
        require(launches >= mcfg.n_layers * n_prefills,
                f"{mcfg.name} {label}: {launches} kernel launches for {n_prefills} prefill "
                f"calls of {mcfg.n_layers} layers")
        say("serve", arch=mcfg.name, driver=label, requests=len(done), wall_ms=f"{wall_ms:.1f}",
            decode_tok_s=f"{st['decoded_tokens'] / (decode_ms / 1e3):.1f}",
            prefill_ms_per_prompt=f"{(wall_ms - decode_ms) / N_REQUESTS:.2f}",
            decode_syncs=st["decode_syncs"], decoded_tokens=st["decoded_tokens"],
            syncs_per_token=f"{st['syncs_per_token']:.4f}",
            kernel_launches=launches, prefill_calls=n_prefills, card=repr(card))
        return {r.uid: r.out_tokens for r in done}, launches, wall_ms

    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    n_params = lm.param_count(params)
    say("serve_setup", arch=cfg.name, n_layers=cfg.n_layers, d_model=D, rnn_hidden=H,
        vocab=cfg.vocab, params=n_params, param_mb=f"{4 * n_params / 1e6:.1f}",
        requests=N_REQUESTS, prompt_lens=f"{int(lengths.min())}-{int(lengths.max())}",
        max_new_tokens=MAX_NEW, num_slots=NUM_SLOTS, max_seq=MAX_SEQ)
    with torch.no_grad():
        tok_step, n1, _ = serve(cfg, params, "step", False, lstm_ops.lstm_seq)
        tok_block, n2, _ = serve(cfg, params, "step_block", True, lstm_ops.lstm_seq)
        tok_chunk, n3, _ = serve(cfg, params, f"step+prefill_chunk={CHUNK}", False,
                                 lstm_ops.lstm_seq, prefill_chunk=CHUNK)
        require(tok_step == tok_block, "step() and step_block() tokens differ")
        require(tok_step == tok_chunk, "one-shot and chunked prefill tokens differ")
        toks = torch.as_tensor([prompts[0]], device=dev)
        lg_k, caches = lm.prefill(params, cfg, toks)
        lg_p, _ = lm.prefill(params, dataclasses.replace(cfg, use_pallas=False), toks)
        require(lg_k.shape == (1, cfg.vocab) and bool(torch.isfinite(lg_k).all()),
                f"prefill logits of shape {tuple(lg_k.shape)} or non-finite")
        require(caches["groups"]["b0_recurrent"]["h"].shape == (cfg.n_layers, 1, H),
                "prefill cache has the wrong layout")
        logit_diff = float((lg_k - lg_p).abs().max())
        require(logit_diff <= LOGITS_ATOL,
                f"use_pallas prefill logits differ from the plain path by {logit_diff:.3e}")
    say("serve_check", arch=cfg.name, path="use_pallas", identical_tokens=True,
        prompt_len=len(prompts[0]), prefill_logits_max_abs_diff=f"{logit_diff:.3e}",
        atol=LOGITS_ATOL)
    phase_done("serve_use_pallas")

    # -- 4a. codegen_stage vs plain -------------------------------------------
    def rand_consts(graph, T: int, q: int | None):
        consts = {}
        for n in graph.consts():
            shape = ((T,) if n.attr("per_step") else ()) + tuple(n.attr("shape"))
            scale = 1.0 / math.sqrt(shape[-2]) if shape[-2] > 1 else 0.2
            consts[n.name] = torch.randn(shape, generator=gen, device=dev) * scale
        if "a" in consts:                      # a stable ssm decay in (0.5, 0.95)
            consts["a"] = 0.5 + 0.45 * torch.rand(consts["a"].shape, generator=gen, device=dev)
        return kernel_backend.prequantize_consts(graph, consts, q)

    def run_case(label: str, stage: Stage, B: int, T: int, *, lut=None, q=None,
                 zero_carry=False, consts=None, x0=None):
        graph = stage.graph
        consts = rand_consts(graph, T, q) if consts is None else consts
        if x0 is None:
            x0 = {s: (torch.zeros if zero_carry else torch.randn)(
                      (B, w), **({} if zero_carry else {"generator": gen}), device=dev)
                  for s, w in graph.states.items()}
        inp = graph.input_node()
        us = None if inp is None else torch.randn((B, T, inp.width), generator=gen, device=dev)
        run = kernel_backend.compile_stage(stage, lut=lut, quant_bits=q)
        fin, ys = run(consts, x0, us)
        torch.cuda.synchronize()
        got = [fin[k] for k in sorted(fin)] + ([] if ys is None else [ys])
        fin_p, ys_p = lower.interpret(run.plan, consts, x0, us, T, lut)
        err = check_close(f"codegen_stage {label}", got,
                          [fin_p[k] for k in sorted(fin_p)] + ([] if ys_p is None else [ys_p]), TOL)
        err_e = None
        if lut is None and q is None:            # fp32: the independent oracle too
            fin_e, ys_e = eager_backend.compile_stage(stage)(consts, x0, us)
            err_e = check_close(f"codegen_stage {label} vs eager", got,
                                [fin_e[k] for k in sorted(fin_e)]
                                + ([] if ys_e is None else [ys_e]), TOL)
        say("kernel_vs_plain", kernel="codegen_stage", case=label, B=B, T=T,
            max_abs_err=f"{err:.3e}",
            max_abs_err_eager="n/a" if err_e is None else f"{err_e:.3e}", tol=TOL, ok=True)
        return max(err, err_e or 0.0)

    def mlp_case(spec, B, q=None):
        prog = codegen.build_program(spec, dev)
        st = prog.stages[0]
        u = torch.randn((B, spec.num_inputs), generator=gen, device=dev)
        x0 = {"x": u @ prog.beta.T}
        consts = kernel_backend.prequantize_consts(st.graph, st.params, q)
        return st, consts, x0

    codegen_err = {"lstm": 0.0, "gru": 0.0}
    with torch.no_grad():
        for label, cell, B, T, zero in (("lstm_B1_T256_zero_carry", "lstm", 1, 256, True),
                                        ("lstm_B8_T37_random_carry", "lstm", 8, 37, False),
                                        ("lstm_B3_T1", "lstm", 3, 1, False),
                                        ("gru_B1_T256", "gru", 1, 256, True),
                                        ("gru_B8_T37", "gru", 8, 37, False),
                                        ("ssm_B8_T37", "ssm", 8, 37, False)):
            e = run_case(label, stage_of(cell, T), B, T, zero_carry=zero)
            if cell in codegen_err:
                codegen_err[cell] = max(codegen_err[cell], e)
        fig10_b = mlp_case(FIG10_B, 64)
        run_case("mlp_FIG10_B_31x32_B64", fig10_b[0], 64, FIG10_B.num_hidden_layers,
                 consts=fig10_b[1], x0=fig10_b[2])
        wide = NetworkSpec(WIDTH, 8, WIDTH, WIDTH)
        st, consts, x0 = mlp_case(wide, 64)
        run_case("mlp_8x1024_B64", st, 64, 8, consts=consts, x0=x0)
        codegen_err["lstm"] = max(codegen_err["lstm"], run_case(
            "lstm_lut_q16_B4_T64", stage_of("lstm", 64), 4, 64,
            lut=make_lut(min(max(16 // 2, 6), 10), device=dev)))
        codegen_err["lstm"] = max(codegen_err["lstm"], run_case(
            "lstm_int8_q8_B4_T64", stage_of("lstm", 64), 4, 64, q=8))
        st, consts, x0 = mlp_case(wide, 64, q=8)
        run_case("mlp_int8_8x1024_B64", st, 64, 8, q=8, consts=consts, x0=x0)
        # C-slow 4 on the Fig. 10 MLP: the kernel's batch carries all C·B streams
        cs_spec = dataclasses.replace(FIG10_B, c_slow=4)
        prog = codegen.build_program(cs_spec, dev)
        u = torch.randn((4, 64, FIG10_B.num_inputs), generator=gen, device=dev)
        y_k = kernel_backend.compile_program(prog)(prog.params, u)
        y_e = eager_backend.compile_program(prog)(prog.params, u)
        st = prog.stages[0]
        run = kernel_backend.compile_stage(st)
        fin_p, _ = lower.interpret(run.plan, st.params,
                                   {"x": fold_streams(u) @ prog.beta.T}, None, st.schedule.steps)
        y_p = unfold_streams(fin_p["x"] @ prog.C.T, 4)
        torch.cuda.synchronize()
        err = check_close("codegen_stage cslow4", [y_k], [y_p], TOL)
        err_e = check_close("codegen_stage cslow4 vs eager", [y_k], [y_e], TOL)
        say("kernel_vs_plain", kernel="codegen_stage", case="mlp_FIG10_B_cslow4_B64",
            shape=tuple(y_k.shape), max_abs_err=f"{err:.3e}", max_abs_err_eager=f"{err_e:.3e}",
            tol=TOL, ok=True)
    phase_done("codegen_vs_plain")

    # -- 4b. codegen_stage time at the prefill shape ----------------------------
    codegen_time = {}
    with torch.no_grad():
        for cell in ("lstm", "gru"):
            B, T = 1, 256
            stage = stage_of(cell, T)
            consts = rand_consts(stage.graph, T, None)
            x0 = {s: torch.zeros((B, w), device=dev) for s, w in stage.graph.states.items()}
            us = torch.randn((B, T, D), generator=gen, device=dev)
            run = kernel_backend.compile_stage(stage)
            k_ms = time_ms(lambda: run(consts, x0, us), l2)
            p_ms = time_ms(lambda: lower.interpret(run.plan, consts, x0, us, T), l2, reps=3)
            _, ys = run(consts, x0, us)
            if cell == "lstm":
                lib = torch.nn.LSTM(D, H, batch_first=True).to(dev)
                lib.weight_ih_l0.copy_(consts["W"][:D].T)
                lib.weight_hh_l0.copy_(consts["W"][D:].T)
                lib.bias_ih_l0.copy_(consts["b"][0])
                lib.bias_hh_l0.zero_()
                call = lambda: lib(us, (x0["h"][None], x0["c"][None]))
            else:
                # torch's GRU candidate: n = tanh(W_in u + b_in + r·(W_hn h + b_hn)),
                # the graph's form (builders.gru_graph) with b → bias_ih, bh_n → b_hn
                lib = torch.nn.GRU(D, H, batch_first=True).to(dev)
                lib.weight_ih_l0.copy_(consts["w_x"].T)
                lib.weight_hh_l0.copy_(consts["w_h"].T)
                lib.bias_ih_l0.copy_(consts["b"][0])
                lib.bias_hh_l0.copy_(torch.cat([torch.zeros(2 * H, device=dev),
                                                consts["bh_n"][0]]))
                call = lambda: lib(us, x0["h"][None])
            y_lib, _ = call()
            lib_diff = float((y_lib - ys).abs().max())
            require(lib_diff <= LOGITS_ATOL,
                    f"codegen_stage {cell}: torch.nn.{type(lib).__name__} differs by {lib_diff:.3e}")
            l_ms = time_ms(call, l2)
            bnd, by = stage_bound_ms(stage.graph, consts, B, T)
            codegen_time[cell] = (k_ms, p_ms, l_ms, bnd, by)
            extra = {}
            if cell == "lstm":
                extra = dict(lstm_seq_ms=f"{lstm_ms:.4f}",
                             generated_over_hand_written=f"{k_ms / lstm_ms:.3f}")
            say("kernel_time", kernel=f"codegen_stage[{cell}]", B=B, T=T, D=D, H=H,
                ms=f"{k_ms:.4f}", us_per_step=f"{1e3 * k_ms / T:.2f}", plain_ms=f"{p_ms:.4f}",
                library_ms=f"{l_ms:.4f}", library=f"torch.nn.{type(lib).__name__}(cuDNN)",
                library_max_abs_diff=f"{lib_diff:.3e}", bound_ms=f"{bnd:.4f}", bound_by=by,
                **extra, reps=REPS, card=repr(card))
            del lib
    phase_done("codegen_time")

    # -- 5. tanh_lut -----------------------------------------------------------
    lut_err = 0.0
    for size in (1, 1023, 1 << 24):
        for bits in (6, 8, 12):
            xs = torch.randn(size, generator=gen, device=dev) * 3
            table = make_lut(bits, device=dev)
            got = lut_ops.tanh_lut(xs, table)
            torch.cuda.synchronize()
            e = check_close(f"tanh_lut size={size} bits={bits}", [got],
                            [tanh_lut_ref(xs, table)], LUT_TOL)
            lut_err = max(lut_err, e)
            say("kernel_vs_plain", kernel="tanh_lut", size=size, bits=bits,
                max_abs_err=f"{e:.3e}", tol=LUT_TOL, ok=True)
    big = torch.randn(1 << 26, generator=gen, device=dev) * 3
    table = make_lut(12, device=dev)
    lut_ms = time_ms(lambda: lut_ops.tanh_lut(big, table), l2)
    lut_plain_ms = time_ms(lambda: tanh_lut_ref(big, table), l2)
    # about 10 fp32 operations and 8 bytes (read x, write y) per element
    lut_bound, lut_bound_by = bound_ms(10.0 * big.numel(), 8.0 * big.numel())
    say("kernel_time", kernel="tanh_lut", size=big.numel(), bits=12, ms=f"{lut_ms:.4f}",
        plain_ms=f"{lut_plain_ms:.4f}", library_ms="none", bound_ms=f"{lut_bound:.4f}",
        bound_by=lut_bound_by, reps=REPS, card=repr(card))
    del big
    # the entry point's drive: the ROM-LUT tanh of one full-width prefill's
    # gate pre-activations (x @ w_x + b for a 256-token prompt)
    with torch.no_grad():
        z = x @ w_x + b
        lut_ops.tanh_lut.launches = 0
        act = lut_ops.tanh_lut(z, make_lut(10, device=dev))
        torch.cuda.synchronize()
        lut_launches = lut_ops.tanh_lut.launches
    require(lut_launches >= 1 and act.shape == z.shape and bool(torch.isfinite(act).all()),
            "tanh_lut: the drive of its entry point did not launch the kernel")
    say("lut_path", shape=tuple(z.shape), tanh_lut_launches=lut_launches)
    phase_done("tanh_lut")

    # -- 6. serve use_codegen: full-width paper-gru and paper-lstm ----------------
    codegen_launches = {}
    del params
    torch.cuda.empty_cache()
    with torch.no_grad():
        for base in (gru_config(), get_config("paper-lstm")):
            ccfg = dataclasses.replace(base, use_codegen=True)
            cparams = lm.init_params(ccfg, torch.Generator(device=dev).manual_seed(0))
            # untimed: lowers and emits the stage runner and makes its first
            # launch, as phase 2 did for lstm_seq before the use_pallas runs
            lm.prefill(cparams, ccfg, toks)
            torch.cuda.synchronize()
            tok_s, m1, _ = serve(ccfg, cparams, "step", False, kernel_backend.codegen_stage)
            tok_b, m2, _ = serve(ccfg, cparams, "step_block", True, kernel_backend.codegen_stage)
            require(tok_s == tok_b, f"{ccfg.name} use_codegen: step() and step_block() tokens differ")
            codegen_launches[ccfg.rnn_cell] = m1 + m2
            # one 256-token prefill on each path (runners built and warm)
            paths = {"use_codegen": ccfg, "plain": dataclasses.replace(ccfg, use_codegen=False)}
            if ccfg.rnn_cell == "lstm":
                paths["use_pallas"] = dataclasses.replace(ccfg, use_codegen=False, use_pallas=True)
            logits, prefill_ms = {}, {}
            for path, pcfg in paths.items():
                lm.prefill(cparams, pcfg, toks)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits[path], _ = lm.prefill(cparams, pcfg, toks)
                torch.cuda.synchronize()
                prefill_ms[path] = (time.perf_counter() - t0) * 1e3
            lg_c, lg_p = logits["use_codegen"], logits["plain"]
            require(lg_c.shape == (1, ccfg.vocab) and bool(torch.isfinite(lg_c).all()),
                    f"{ccfg.name} use_codegen prefill logits non-finite")
            diff = float((lg_c - lg_p).abs().max())
            require(diff <= LOGITS_ATOL,
                    f"{ccfg.name} use_codegen prefill logits differ from the plain path by {diff:.3e}")
            agree = "n/a"
            if ccfg.rnn_cell == "lstm":   # information only: same weights as phase 3
                same = sum(a == b for u in tok_s for a, b in zip(tok_s[u], tok_step[u]))
                agree = f"{same}/{N_REQUESTS * MAX_NEW}"
            say("serve_check", arch=ccfg.name, path="use_codegen", identical_tokens=True,
                prefill_logits_max_abs_diff=f"{diff:.3e}", atol=LOGITS_ATOL,
                tokens_agreeing_with_use_pallas=agree, prompt_len=toks.shape[1],
                **{f"prefill_ms_{k}": f"{v:.2f}" for k, v in prefill_ms.items()})
            del cparams
            torch.cuda.empty_cache()
    phase_done("serve_use_codegen")

    # -- 7. synthesize(backend="kernel") ----------------------------------------
    synth_specs = [("CASE_STUDY", CASE_STUDY, 8),
                   ("FIG10_A_u4_c4", dataclasses.replace(FIG10_A, unroll=4, c_slow=4), 8),
                   ("FIG10_B", FIG10_B, 8)]
    for cell in ("lstm", "gru", "ssm"):
        synth_specs.append((f"{cell}_8x1024_T256", NetworkSpec(
            WIDTH, 8, WIDTH, WIDTH, cell=cell, seq_len=256), 8))
    for bits in (8, 12):
        synth_specs.append((f"lstm_8x1024_T256_q{bits}", NetworkSpec(
            WIDTH, 8, WIDTH, WIDTH, cell="lstm", seq_len=256, quant_bits=bits), 8))
    with torch.no_grad():
        for label, spec, batch in synth_specs:
            kernel_backend.codegen_stage.launches = 0
            report = synthesis.synthesize(spec, batch=batch, backend="kernel",
                                          fallback=False, device=dev)
            require(report.backend == "kernel" and report.fallback_from is None,
                    f"synth {label}: built on {report.backend} (fallback from {report.fallback_from})")
            require(kernel_backend.codegen_stage.launches >= 1,
                    f"synth {label}: no generated-kernel launch")
            fwd_k, p_k = synthesis.build_forward(spec, "kernel", device=dev)
            shape = (batch, spec.num_inputs) if spec.cell == "mlp" \
                else (batch, spec.seq_len, spec.num_inputs)
            if spec.c_slow > 1:
                shape = (spec.c_slow,) + shape
            u = torch.randn(shape, generator=gen, device=dev)
            y_k = fwd_k(p_k, u)
            if spec.quant_bits is None:
                fwd_e, p_e = synthesis.build_forward(spec, "eager", device=dev)
                want, against = fwd_e(p_e, u), "eager"
            else:   # int8 / LUT: the kernel backend's plain version, on CPU copies
                p_cpu = {"stages": [{k: v.cpu() for k, v in sp.items()} for sp in p_k["stages"]],
                         "C": p_k["C"].cpu()}
                want, against = fwd_k(p_cpu, u.cpu()).to(dev), "plain"
            torch.cuda.synchronize()
            require(tuple(y_k.shape) == report.output_shape,
                    f"synth {label}: y of shape {tuple(y_k.shape)}, report says {report.output_shape}")
            err = check_close(f"synth {label} vs {against}", [y_k], [want], SYNTH_TOL)
            say("synth", spec=label, against=against, max_abs_err=f"{err:.3e}",
                max_abs_y=f"{float(want.abs().max()):.3e}", tol=SYNTH_TOL,
                summary=repr(report.summary()))
    phase_done("synth")

    # -- 8. where the time goes: the use_pallas step() run under the profiler ---
    from torch.profiler import ProfilerActivity, profile

    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        tok_prof, _, prof_wall_ms = serve(cfg, params, "step(profiled)", False, lstm_ops.lstm_seq)
    require(tok_prof == tok_step, "the profiled step() run's tokens differ")
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    say("profile", driver="step", wall_ms=f"{prof_wall_ms:.1f}",
        device_busy_ms=f"{busy_ms:.1f}" if kernels else "not_measured",
        device_idle_share=f"{1 - busy_ms / prof_wall_ms:.3f}" if kernels else "not_measured",
        card=repr(card))
    for e in kernels[:8]:
        say("profile_top", kernel=repr(e.key[:70]), calls=e.count,
            device_ms=f"{e.self_device_time_total / 1e3:.2f}",
            share=f"{e.self_device_time_total / 1e3 / busy_ms:.3f}")
    phase_done("profile")

    summary = {"kernels": [{
        "name": "lstm_seq",
        "route": "cuda",
        "source": "src/repro_torch/kernels/lstm_cell/csrc/lstm_seq.cu",
        "replaces": "src/repro/kernels/lstm_cell/kernel.py:87",
        "launches": n1 + n2 + n3,
        "max_abs_err": lstm_err,
        "ms": lstm_ms,
        "plain_ms": lstm_plain_ms,
        "bound_ms": lstm_bound,
        "bound_by": lstm_bound_by,
        "library_ms": lstm_lib_ms,
    }] + [{
        "name": f"codegen_stage[{cell}]",
        "route": "cuda",
        "source": "src/repro_torch/codegen/cuda_emit.py",
        "replaces": "src/repro/codegen/pallas_backend.py:125",
        "launches": codegen_launches[cell],
        "max_abs_err": codegen_err[cell],
        "ms": codegen_time[cell][0],
        "plain_ms": codegen_time[cell][1],
        "bound_ms": codegen_time[cell][3],
        "bound_by": codegen_time[cell][4],
        "library_ms": codegen_time[cell][2],
    } for cell in ("lstm", "gru")] + [{
        "name": "tanh_lut",
        "route": "cuda",
        "source": "src/repro_torch/kernels/tanh_lut/csrc/tanh_lut.cu",
        "replaces": "src/repro/kernels/tanh_lut/kernel.py:32",
        "launches": 0,     # no path of the port calls it (see lut_path above)
        "note": "standalone op: no path of the port or the reference calls it",
        "max_abs_err": lut_err,
        "ms": lut_ms,
        "plain_ms": lut_plain_ms,
        "bound_ms": lut_bound,
        "bound_by": lut_bound_by,
        "library_ms": None,
    }]}
    print(json.dumps(summary), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
