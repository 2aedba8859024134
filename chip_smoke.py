#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``src/repro_torch``) on one card.

    python3 chip_smoke.py            # from the root of a checkout, one CUDA card

Phases, one line each (any failure exits non-zero and prints no result):

1. device — the card, its power limit, and the build of every kernel of the
   main path from the sources in the checkout (``nvcc``, into ``build/``);
2. kernel vs plain — each kernel against its plain PyTorch version on the
   card, at the widths the main path gives it, with the stated tolerance,
   and its time beside the plain version's, one library call's and its bound;
3. serve — full-width ``paper-lstm`` (random weights from a seed) with
   ``use_pallas=True`` through ``DecodeServer``: 16 greedy requests under
   ``step()``, ``step_block()`` and chunked prefill; identical tokens across
   the three, kernel launches counted at every prefill, and prefill logits
   held against the plain path; then the ``step()`` run once more under
   ``torch.profiler`` for the device's busy time and its top kernels.

Then the kernel summary (one JSON line), the card's name and power limit as
``nvidia-smi`` reports them, and the result line.  The script imports nothing
of JAX and nothing of the JAX package.
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

TOL = 1e-4          # kernel vs plain on the card, atol = rtol (see phase 2)
LOGITS_ATOL = 1e-3  # use_pallas prefill logits vs the plain path
N_REQUESTS = 16
MAX_NEW = 32
NUM_SLOTS = 8
MAX_SEQ = 512
BLOCK_K = 8
CHUNK = 64
REPS = 20


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


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
    """Least time for lstm_seq on these shapes: operations 2·B·T·(D+H)·4H
    at the fp32 peak, or bytes (each input read once, each output written
    once) at the memory rate — whichever is larger."""
    flops = 2.0 * B * T * (D + H) * 4 * H
    n_bytes = 4.0 * (B * T * D + (D + H) * 4 * H + 4 * H + 2 * B * H   # x, W, b, h0, c0
                     + B * T * H + 2 * B * H)                          # y, h, c
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, n_bytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
    from repro_torch.kernels.lstm_cell import ops as lstm_ops
    from repro_torch.kernels.tanh_lut.ref import make_lut
    from repro_torch.models import lm
    from repro_torch.obs import Observability
    from repro_torch.runtime.server import DecodeServer, Request

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. device and build ---------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    card = smi.strip()
    t0 = time.perf_counter()
    lib_path = lstm_kernel.build()
    build_s = time.perf_counter() - t0
    lstm_kernel.load()
    ptxas = [ln.strip() for ln in lib_path.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    say("device", torch=torch.__version__, cuda=torch.version.cuda,
        kind=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count(),
        card=repr(card), build_s=f"{build_s:.2f}", library=lib_path.name)
    for ln in ptxas:
        say("ptxas", line=repr(ln))

    # -- 2. kernel vs plain at full width ---------------------------------
    cfg = dataclasses.replace(get_config("paper-lstm"), use_pallas=True)
    D, H = cfg.d_model, cfg.rnn_hidden_actual
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [("B1_T256_zero_carry", 1, 256, False, None),
             ("B8_T37_random_carry", 8, 37, True, None),
             ("B8_T1_random_carry", 8, 1, True, None),
             ("lut12_B4_T64_random_carry", 4, 64, True, make_lut(12, device=dev))]
    max_err = 0.0
    for name, B, T, carry, lut in cases:
        args = lstm_inputs(gen, B, T, D, H, carry)
        got = lstm_ops.lstm_seq(*args, lut=lut)
        want = (lstm_ops.lstm_seq_ref(*args) if lut is None
                else lstm_ops.lstm_seq_lut_ref(*args, lut))
        torch.cuda.synchronize()
        errs = []
        for what, g, w in zip(("y", "h", "c"), got, want):
            require(g.shape == w.shape and bool(torch.isfinite(g).all()),
                    f"lstm_seq {name}: {what} has shape {tuple(g.shape)} or non-finite values")
            err = (g - w).abs()
            errs.append(float(err.max()))
            require(bool((err <= TOL + TOL * w.abs()).all()),
                    f"lstm_seq {name}: {what} differs from the plain version by {errs[-1]:.3e}")
        max_err = max(max_err, *errs)
        say("kernel_vs_plain", kernel="lstm_seq", case=name, D=D, H=H,
            max_abs_err_y_h_c=",".join(f"{e:.3e}" for e in errs), tol=TOL, ok=True)

    # timing at the main path's shape: a one-shot prefill of a 256-token
    # prompt, one call per layer (B=1, T=256, D=H=1024)
    B, T = 1, 256
    args = lstm_inputs(gen, B, T, D, H, carry=False)
    x, w_x, w_h, b, h0, c0 = args
    l2 = torch.zeros(32 * 1024 * 1024, device=dev)
    kernel_ms = time_ms(lambda: lstm_ops.lstm_seq(*args), l2)
    plain_ms = time_ms(lambda: lstm_ops.lstm_seq_ref(*args), l2)
    cudnn = torch.nn.LSTM(D, H, batch_first=True).to(dev)   # yardstick only
    with torch.no_grad():
        cudnn.weight_ih_l0.copy_(w_x.T)
        cudnn.weight_hh_l0.copy_(w_h.T)
        cudnn.bias_ih_l0.copy_(b)
        cudnn.bias_hh_l0.zero_()
        y_lib, _ = cudnn(x, (h0[None], c0[None]))
        y_k, _, _ = lstm_ops.lstm_seq(*args)
        lib_err = float((y_lib - y_k).abs().max())
        library_ms = time_ms(lambda: cudnn(x, (h0[None], c0[None])), l2)
    bound_ms, bound_by = lstm_bound_ms(B, T, D, H)
    say("kernel_time", kernel="lstm_seq", B=B, T=T, D=D, H=H, ms=f"{kernel_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
        library="torch.nn.LSTM(cuDNN)", library_max_abs_diff=f"{lib_err:.3e}",
        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by, reps=REPS, card=repr(card))
    del l2, cudnn

    # -- 3. serve full-width paper-lstm ------------------------------------
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    n_params = lm.param_count(params)
    rng = np.random.default_rng(1)
    lengths = rng.integers(16, 257, size=N_REQUESTS)
    lengths[0] = 256
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).tolist() for n in lengths]
    say("serve_setup", arch=cfg.name, n_layers=cfg.n_layers, d_model=D, rnn_hidden=H,
        vocab=cfg.vocab, params=n_params, param_mb=f"{4 * n_params / 1e6:.1f}",
        requests=N_REQUESTS, prompt_lens=f"{int(lengths.min())}-{int(lengths.max())}",
        max_new_tokens=MAX_NEW, num_slots=NUM_SLOTS, max_seq=MAX_SEQ)

    def serve(label: str, block: bool, **kw):
        obs = Observability(trace=True)
        srv = DecodeServer(cfg, params, num_slots=NUM_SLOTS, max_seq=MAX_SEQ,
                           block_k=BLOCK_K, obs=obs, **kw)
        for i, p in enumerate(prompts):
            srv.submit(Request(uid=i, prompt=p, max_new_tokens=MAX_NEW))
        torch.cuda.synchronize()
        lstm_ops.lstm_seq.launches = 0
        t0 = time.perf_counter()
        done = srv.run_until_drained(persistent=block)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = lstm_ops.lstm_seq.launches
        decode_ms = sum(ev["dur"] for ev in obs.tracer.events()
                        if ev.get("name") in ("decode_step", "decode_block")) / 1e3
        st = srv.stats()
        require(len(done) == N_REQUESTS, f"{label}: {len(done)} of {N_REQUESTS} requests retired")
        for r in done:
            require(r.finish_reason == "max_tokens" and len(r.out_tokens) == MAX_NEW,
                    f"{label}: request {r.uid} ended {r.finish_reason} "
                    f"after {len(r.out_tokens)} tokens")
        n_prefills = (sum(math.ceil(n / kw["prefill_chunk"]) for n in lengths)
                      if kw.get("prefill_chunk") else N_REQUESTS)
        require(launches >= cfg.n_layers * n_prefills,
                f"{label}: {launches} lstm_seq launches for {n_prefills} prefill calls "
                f"of {cfg.n_layers} layers")
        say("serve", driver=label, requests=len(done), wall_ms=f"{wall_ms:.1f}",
            decode_tok_s=f"{st['decoded_tokens'] / (decode_ms / 1e3):.1f}",
            prefill_ms_per_prompt=f"{(wall_ms - decode_ms) / N_REQUESTS:.2f}",
            decode_syncs=st["decode_syncs"], decoded_tokens=st["decoded_tokens"],
            syncs_per_token=f"{st['syncs_per_token']:.4f}",
            lstm_seq_launches=launches, prefill_calls=n_prefills, card=repr(card))
        return {r.uid: r.out_tokens for r in done}, launches, wall_ms

    with torch.no_grad():
        tok_step, n1, _ = serve("step", block=False)
        tok_block, n2, _ = serve("step_block", block=True)
        tok_chunk, n3, _ = serve(f"step+prefill_chunk={CHUNK}", block=False, prefill_chunk=CHUNK)
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
    say("serve_check", identical_tokens=True, prompt_len=len(prompts[0]),
        prefill_logits_max_abs_diff=f"{logit_diff:.3e}", atol=LOGITS_ATOL)

    # -- where the time goes: the step() run once more under the profiler --
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        tok_prof, _, prof_wall_ms = serve("step(profiled)", block=False)
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

    summary = {"kernels": [{
        "name": "lstm_seq",
        "route": "cuda",
        "source": "src/repro_torch/kernels/lstm_cell/csrc/lstm_seq.cu",
        "replaces": "src/repro/kernels/lstm_cell/kernel.py:87",
        "launches": n1 + n2 + n3,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]}
    print(json.dumps(summary), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
