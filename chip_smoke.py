#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``src/repro_torch``) on one card.

    python3 chip_smoke.py            # from the root of a checkout, one CUDA card

Phases, one line per case (any failure exits non-zero and prints no result):

1. device — the card, its power limit, and the build of every kernel of the
   run from the sources in the checkout: ``lstm_seq.cu``, ``tanh_lut.cu``,
   ``ssm_scan.cu``, ``int8_matmul.cu``, ``flash_attention.cu`` and every
   generated stage kernel, one ``nvcc`` each, all started together (into
   ``build/``);
2. ``lstm_seq`` vs its plain PyTorch version at full width, and its time
   beside the plain version's, one library call's (``over_library``) and
   its bound, with its CUDA launches per call (which must be 2: the input
   GEMM and the persistent recurrence), whether ``w_h`` was resident in
   shared memory, its serial floor (the persistent grid running only its
   barriers), the fixed cost of a call (that grid's launch at T = 1 with
   the host's wait for the barrier word) and its time at the chunked
   path's T = 64;
3. serve — full-width ``paper-lstm`` (random weights from a seed) with
   ``use_pallas=True`` through ``DecodeServer``: 16 greedy requests under
   ``step()``, ``step_block()`` and chunked prefill; identical tokens across
   the three, ``lstm_seq`` launched once per layer of every prefill call,
   each launch one host round-trip (``kernel_syncs``), and prefill logits
   held against the plain path;
4. ``codegen_stage`` — the generated stage kernel against the plan's
   interpreter (its plain version) and, for fp32, the eager backend, on
   thirteen cases (cells at D = H = 1024, the Fig. 10 MLPs, LUT, int8,
   C-slow, two step maccs in a chain over several column tiles); its time
   at the prefill shape for lstm and gru beside the plain version,
   ``torch.nn.LSTM``/``GRU`` and ``lstm_seq``, with the same launch count
   (2), residency, serial floor, fixed cost and T = 64 figures as phase 2;
5. ``tanh_lut`` against its plain version, its time, and one drive of its
   entry point on a full-width prefill's gate pre-activations (no path of
   the port calls it, so its ``launches`` in the summary are 0);
6. serve ``use_codegen`` — full-width ``paper-gru`` and ``paper-lstm`` with
   ``use_codegen=True`` under ``step()`` and ``step_block()``, after one
   untimed prefill that builds the stage runners: every layer of every
   prefill through the generated kernel, once;
7. synth — ``synthesize(..., backend="kernel", fallback=False)`` on the
   paper's specs and full-width recurrent specs, each forward held against
   the eager backend (int8 against its plain version), beside the spread of
   two plain evaluations (the eager backend on the host's CPU against
   itself on the card);
8. profile — the ``use_pallas`` ``step()`` run once more under
   ``torch.profiler``;
9. ``ssm_scan`` against its plain version (a falcon-mamba prefill's shapes,
   ragged D with prime T, T = 1, bf16 inputs, a nonzero carry), a scan
   resumed at step 100 bit-identical to the one-shot scan, and its time at
   T = 256 and at the chunked prefill's T = 64 beside the plain version's
   and its bound, with its launches per call (which must be 1);
10. ``int8_matmul`` bit-exact against its plain version, and its time beside
   the plain version's, ``torch._int_mm``'s and its bound (no path of the
   port calls it, so its ``launches`` in the summary are 0);
11. ``flash_attention`` against its plain version (the reference's five
   kernel cases in fp32 and bf16, S != T, S = T = 1, rows that see no key,
   hd 128 with a 1024 window), and its time at two ``smollm-135m`` layers
   (64 and 256 tokens), one ``phi4-mini-3.8b`` layer and gemma3's
   local-layer shape, each held to the fp32 bar, beside the plain
   version's, ``F.scaled_dot_product_attention``'s, its bound on the
   tensor cores in 3xTF32 and the fp32-FMA bound (``fma_bound_ms``), with
   its q tile, the key shares the host chose and its launches per call
   (which must be 1, or 2 where the key axis is split, as the wrapper
   counts them); then the fp32 bar at 512 to 8192 keys (hd 128);
12. serve mamba — full-width ``falcon-mamba-7b`` (64 layers, 7.3 B fp32
   parameters from a seed) with ``use_pallas=True`` through ``DecodeServer``
   under ``step()``, ``step_block()`` and chunked prefill: identical tokens,
   ``ssm_scan`` launched once per layer of every prefill call, prefill
   logits held against the plain path; then its ``step()`` run under
   ``torch.profiler``;
13. serve smollm — full-width ``smollm-135m`` (30 layers, 135 M fp32
   parameters from a seed) with ``use_pallas=True`` under the same three
   drivers: identical tokens, ``flash_attention`` called once per layer
   of every one-shot prefill and never by a chunk (chunks attend over the
   cache in plain PyTorch), with one CUDA launch a call or two where the
   prompt's length splits the key axis, a 256-token prefill's logits held
   against the plain path; then its ``step()`` run under
   ``torch.profiler``;
14. prefill phi4 — full-width ``phi4-mini-3.8b`` (32 layers, 3.8 B fp32
   parameters, after falcon-mamba's tree is freed): one 256-token prefill
   through the kernel (32 calls, 64 launches: 96 blocks of 64 queries
   leave SMs idle, so the key axis is split) and on the plain path.

15. serve_loadgen — the seeded ``repro_torch.runtime.loadgen`` trace (32
   requests, Poisson arrivals 0.25 ticks apart, prompts of 8-63 and 128-256
   tokens and two fleets sharing a 128-token prefix, 32 new tokens each)
   replayed twice (cold, then the same prompts under fresh uids) at full
   width with ``use_pallas``: ``paper-lstm`` (after phase 8) under ``step()``
   without the prefix cache, chunked ``step()`` and adaptive ``step_block()``
   with a 256 MB cache, and the chunked run under ``AsyncServer`` (equal
   digests, full and partial hits, fewer prompt steps, each server's
   ``kernel_syncs`` its own ``lstm_seq`` calls); ``decode.nan_logits``,
   ``decode.dispatch`` and ``tick.slow`` injected at full width;
   ``falcon-mamba-7b`` (in phase 12, on its loaded weights) chunked without
   and with a 1 GiB cache that evicts (``ssm_scan`` launched once a layer
   of every chunk run); ``smollm-135m`` (in phase 13) unchunked with a 256 MB
   cache (``flash_attention`` 30 calls a miss, none in the all-hit second
   pass); then ``python -m repro_torch.launch.serve`` and ``python -m
   repro_torch.obs.report`` as subprocesses on the card, and ``python -m
   repro_torch.obs.check`` on the four documents they write.  Each model's
   prefill logits are held against ``use_pallas=False`` at every distinct
   prompt length of the trace, one-shot and/or chunked as its servers
   prefill.

16. bit_path (run after phase 7) — the paper's fixed-point path at the
   published widths of the synthesis cells, ``NetworkSpec(1024, 8, 1024,
   1024, seq_len=256)``: ``rtlsim.simulate`` against
   ``golden.fixed_forward`` word for word (lstm at 18, 24 and 32 bits; gru,
   ssm and mlp at 18), with their seconds, FSM cycles and largest |code|;
   the ``ref``, ``eager`` and ``kernel`` float legs on the same cells
   (kernel and ref against eager within 1e-4 of max(1, max|y|), the
   generated kernel launched); rtlsim and the golden model on the card
   against the same calls on the CPU at 4 × 64 cells and 8, 18 and 32 bits;
   ``synthesize(backend="verilog")`` on the paper's three specs and the four
   golden specs against the emission from CPU copies of the weights (sha256,
   bytes, the resource report); the static gate
   (``synthesize(backend="kernel", analyze=True)``) on the paper's specs and
   the 8 × 1024 lstm, refused until their error findings are waived, with
   the analysis seconds; then ``python -m repro_torch.verify.difftest``
   (also ``--regen-goldens`` into ``build/bit_path/``) and ``python -m
   repro_torch.analyze`` as subprocesses, each exiting 0.

17. tune_chaos (run last) — ``synthesize(spec, optimize="latency", budget=6,
   batch=2)`` (the Fig. 10 auto-tuner: the default grid over unroll, C-slow,
   quant_bits and the eager and kernel backends) on the reference's two tune
   case studies (``NetworkSpec(3, 4, 4, 2)``, the h4 lstm at T = 6) and the
   8 × 1024 lstm of phase 16 at T = 256: per cell the candidates enumerated,
   pruned and measured, the winner (built, and validated on the card by the
   difftest gate: float legs and rtlsim against golden), its speedup over
   default synthesis, the Pareto front, predicted FSM cycles beside measured
   µs, the seconds in the predict, measure and validate spans and the
   generated kernel's launches, and the candidates ``analyze_prune`` drops
   (the error-grade overflow findings of the predict pass); on the two case
   studies a second run with ``analyze_prune=True``, whose winner must stay
   (the reference's tune-suite assertion); ``repro.tune/v1`` documents
   under ``build/tune_chaos/``; the chaos suite's prefills (its 6-token
   prompts) on the kernel path against ``use_pallas=False``, then the suite
   (nine scenarios, every fault class) at full width on ``smollm-135m``
   (``flash_attention``) and ``paper-lstm`` (``lstm_seq``) with
   ``use_pallas``; ``python -m repro_torch.verify.chaos`` and ``python -m
   repro_torch.analyze --lint-src`` as subprocesses, each exiting 0, and
   ``python -m repro_torch.obs.check`` on every document.

Then the kernel summary (one JSON line), the card's name and power limit as
``nvidia-smi`` reports them, and the result line.  Each phase prints its
seconds.  The script imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import json
import math
import os
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
# int8 and TF32 tensor cores, dense (NVIDIA data sheet), for the int8
# matmul's and the attention's bounds
PEAK_INT8_OPS = 1979e12
PEAK_TF32_FLOPS = 495e12
# exps: the SFU's 16 lanes per SM per clock (CUDA programming guide's
# throughput table, compute capability 9.0) x 132 SMs x 1.98 GHz boost
PEAK_EXP_PER_S = 16 * 132 * 1.98e9

TOL = 1e-4          # kernel vs plain on the card, atol = rtol
BF16_TOL = 3e-2     # ssm_scan with bf16 inputs (y rounded to bf16), the reference's bar
LUT_TOL = 1e-6      # tanh_lut vs plain: the same fp32 arithmetic (up to FMA contraction)
LOGITS_ATOL = 1e-3  # fast-path prefill logits vs the plain path
SYNTH_TOL = 1e-3    # synthesize()'s forward vs eager (atol = rtol; 8 layers x 256 steps)
# falcon-mamba use_pallas prefill logits vs the plain path, relative to the
# largest |logit|: 64 layers compound the kernel's rounding (FMA contraction,
# the order of the sum over N) with the rest of the stack's
MAMBA_LOGITS_RTOL = 1e-3
# flash_attention vs plain on the card: fp32 at the reference kernel's own
# bar (an online softmax over key tiles against one softmax over the row);
# bf16 inputs give a bf16 result, one bf16 rounding apart
ATTN_TOL = 1e-5
ATTN_BF16_TOL = 2e-2
# dense use_pallas prefill logits vs the plain path, relative to the largest
# |logit|: 30-32 layers compound the kernel's rounding with the stack's
DENSE_LOGITS_RTOL = 1e-3
N_REQUESTS = 16
MAX_NEW = 32
NUM_SLOTS = 8
MAX_SEQ = 512
BLOCK_K = 8
CHUNK = 64
REPS = 20
HOST_COVER_CYCLES = 1_000_000   # about 0.5 ms of the card's clock (time_ms)
WIDTH = 1024

# the serve_loadgen phase's traffic (repro_torch.runtime.loadgen.TraceSpec;
# vocab is each model's)
LOADGEN_TRACE = dict(num_requests=32, mean_interarrival_ticks=0.25, short_len=(8, 64),
                     long_len=(128, 257), long_frac=0.25, fleet_frac=0.4, num_fleets=2,
                     fleet_prefix_len=128, fleet_suffix_len=(1, 33), max_new_tokens=32, seed=0)
LOADGEN_UID_OFFSET = 1000        # the second pass's uids

# the bit_path phase: sequence steps and batch of its full-width cells, the
# float legs' bar (ref and kernel against eager, relative to the largest |y|
# where that exceeds 1: the 8-layer ssm's linear state reaches ~1e6), and
# the seeds its difftest subprocess runs (each builds its own stage kernels)
BIT_T = 256
BIT_BATCH = 2
BIT_FLOAT_TOL = 1e-4
BIT_DIFFTEST_SEEDS = 6

# the tune_chaos phase: the measure budget and batch of each tune run (the
# reference's tune suite: budget 6, batch 2)
TUNE_BUDGET = 6
TUNE_BATCH = 2

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
    with a cold L2 at the start of every run.  After the flush the card
    spins for HOST_COVER_CYCLES, so that the host has enqueued all of ``fn``
    (0.06-0.1 ms through the Python wrappers) before the start event fires:
    without it a kernel shorter than the host's enqueue was timed with the
    host's time in it."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        flush_l2(buf)
        torch.cuda._sleep(HOST_COVER_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def launches_per_call(fn) -> int:
    """The CUDA kernel launches one call of ``fn`` makes, from torch.profiler's
    CUDA activity: the runtime's launch calls (``cudaLaunchKernel``,
    ``cudaLaunchCooperativeKernel``); memsets and copies are not launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.name.startswith("cudaLaunch"))


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


def bound_ms(t_ops_s: float, n_bytes: float) -> tuple[float, str]:
    """The least time for the work: the larger of ``t_ops_s``, the seconds
    its operations take at their unit's peak, and the bytes (each input read
    once, each output written once) at the memory rate."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops_s, t_bytes), ("operations" if t_ops_s >= t_bytes else "bytes")


def scan_bound_ms(Bsz, T, D, N) -> tuple[float, str]:
    """ssm_scan on these shapes: x, delta in and y out (Bsz·T·D each), B and
    C (Bsz·T·N each), A (D·N), h0 in and h_final out (Bsz·D·N each), fp32;
    per (b, t, d, n) about 6 fp32 operations and one exp, the slower of the
    two units counting."""
    states = float(Bsz) * T * D * N
    n_bytes = 4.0 * (3 * Bsz * T * D + 2 * Bsz * T * N + D * N + 2 * Bsz * D * N)
    t_ops = max(6.0 * states / PEAK_FP32_FLOPS, states / PEAK_EXP_PER_S)
    return bound_ms(t_ops, n_bytes)


def int8_bound_ms(M, K, N) -> tuple[float, str]:
    """int8_matmul on these shapes: a, b (int8), the two scales in and the
    fp32 output out; 2·M·K·N integer operations at the int8 tensor cores'
    rate."""
    n_bytes = 1.0 * (M * K + K * N) + 4.0 * (M + N + M * N)
    return bound_ms(2.0 * M * K * N / PEAK_INT8_OPS, n_bytes)


def attn_pairs(S, T, causal: bool, window: int) -> int:
    """The (query, key) pairs that the masks leave visible, per (b, h)."""
    qpos = torch.arange(S)[:, None]
    kpos = torch.arange(T)[None, :]
    mask = kpos <= qpos if causal else torch.ones((S, T), dtype=torch.bool)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    return int(mask.sum())


def attn_bound_ms(B, S, T, H, KV, hd, causal: bool, window: int) -> tuple[float, str, float]:
    """flash_attention on these shapes: 4·hd operations per visible (query,
    key) pair (the score and the weighted sum of v) done fp32-accurate on the
    card's fastest units, the tensor cores in 3xTF32 (three TF32 products),
    beside one exp per pair at the SFU rate; q, k, v read and out written
    once, fp32.  Also returns ``fma_bound_ms``: the same operations on the
    fp32 FMA units, the bound that rows before the tensor-core kernel used."""
    pairs = B * H * attn_pairs(S, T, causal, window)
    flops = 4.0 * hd * pairs
    n_bytes = 4.0 * (2 * B * S * H * hd + 2 * B * T * KV * hd)
    bnd, by = bound_ms(max(3 * flops / PEAK_TF32_FLOPS, pairs / PEAK_EXP_PER_S), n_bytes)
    return bnd, by, bound_ms(flops / PEAK_FP32_FLOPS, n_bytes)[0]


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
    return bound_ms(flops / PEAK_FP32_FLOPS, n_bytes)


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
    return bound_ms(flops / PEAK_FP32_FLOPS, n_bytes)



# ---------------------------------------------------------------------------
# phase 15: serve_loadgen
# ---------------------------------------------------------------------------

def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def replay_async(srv, trace, offset: int) -> dict:
    """The trace's requests all at once through ``AsyncServer`` (its ticks on
    the front-end's tick thread); a loadgen-shaped report."""
    from repro_torch.runtime import AsyncServer, Request, loadgen

    async def drive():
        front = AsyncServer(srv)
        try:
            return await asyncio.gather(*(front.generate(Request(
                uid=it.uid + offset, prompt=list(it.prompt), max_new_tokens=it.max_new_tokens))
                for it in trace.items))
        finally:
            front.close()

    t0 = time.perf_counter()
    done = asyncio.run(drive())
    sync(srv.device)
    wall = time.perf_counter() - t0
    decoded = srv.stats()["decoded_tokens"]
    return {"wall_s": wall, "ticks": "n/a", "decoded_tokens": decoded,
            "throughput_tok_s": decoded / wall, "completed": len(done),
            "tokens_digest": loadgen.tokens_digest(
                {r.uid - offset: list(r.out_tokens) for r in done})}


def loadgen_serve(mcfg, mparams, label: str, counter, dev, card: str, *,
                  persistent_kernel: bool = False, block: bool = False,
                  use_async: bool = False, faults=None, **kw) -> dict:
    """Replay LOADGEN_TRACE twice on one fresh server (cold, then the same
    prompts under fresh uids) with the kernel wrapper ``counter``'s counts
    set to 0 just before each pass and read just after; one ``[loadgen]``
    line per pass.  Every request must retire with its 32 tokens (unless a
    fault plan is given), and the server's ``prefill_kernel_syncs`` must be
    its own calls of ``counter`` when that is a persistent kernel (else 0)."""
    from repro_torch.runtime import DecodeServer, loadgen

    trace = loadgen.make_trace(loadgen.TraceSpec(vocab=mcfg.vocab, **LOADGEN_TRACE))
    srv = DecodeServer(mcfg, mparams, num_slots=NUM_SLOTS, max_seq=MAX_SEQ, block_k=BLOCK_K,
                       persistent=block, faults=faults, device=dev, **kw)
    passes = []
    for i, offset in enumerate((0, LOADGEN_UID_OFFSET)):
        srv.reset_stats()
        sync(dev)
        counter.launches = 0
        if hasattr(counter, "calls"):
            counter.calls = 0
        rep = (replay_async(srv, trace, offset) if use_async
               else loadgen.replay(srv, trace, uid_offset=offset))
        calls = getattr(counter, "calls", counter.launches)
        st = srv.stats()
        pc = st.get("prefix_cache", {})
        mine = [r for r in srv.completed if offset <= r.uid < offset + LOADGEN_UID_OFFSET]
        if faults is None:
            require(len(mine) == len(trace.items)
                    and all(r.finish_reason == "max_tokens"
                            and len(r.out_tokens) == LOADGEN_TRACE["max_new_tokens"]
                            for r in mine),
                    f"{mcfg.name} loadgen {label} pass {i}: not every request retired "
                    f"with {LOADGEN_TRACE['max_new_tokens']} tokens")
        require(srv.prefill_kernel_syncs == (calls if persistent_kernel else 0),
                f"{mcfg.name} loadgen {label} pass {i}: {srv.prefill_kernel_syncs} kernel "
                f"syncs for {calls} calls of its kernel")
        row = dict(rep=rep, calls=calls, launches=counter.launches, stats=st, pc=pc,
                   outs={r.uid - offset: (list(r.out_tokens), r.finish_reason) for r in mine},
                   chunks_run=st["prefill"]["chunks_run"],
                   prompt_steps=st["prefill"]["prompt_steps_computed"])
        passes.append(row)
        say("loadgen", arch=mcfg.name, run=label, pass_=i, ticks=rep["ticks"],
            wall_s=f"{rep['wall_s']:.3f}", decoded_tokens=rep["decoded_tokens"],
            tok_s=f"{rep['throughput_tok_s']:.1f}", digest=rep["tokens_digest"],
            prompt_steps=row["prompt_steps"], chunks=row["chunks_run"], kernel_calls=calls,
            kernel_launches=counter.launches, kernel_syncs=srv.prefill_kernel_syncs,
            hits=pc.get("hits", "n/a"), partial_hits=pc.get("partial_hits", "n/a"),
            misses=pc.get("misses", "n/a"), evictions=pc.get("evictions", "n/a"),
            steps_saved=pc.get("prompt_steps_saved", "n/a"),
            checkpoint_bytes=pc.get("bytes_in_use", "n/a"), entries=pc.get("entries", "n/a"),
            dispatch_retries=st["health"]["dispatch_retries"], card=repr(card))
    return {"passes": passes, "digests": [p["rep"]["tokens_digest"] for p in passes],
            "launches": sum(p["launches"] for p in passes),
            "calls": sum(p["calls"] for p in passes)}


def loadgen_plain_check(mcfg, mparams, dev, card: str, modes: tuple[str, ...], tol: float,
                        relative: bool, prompts: list[list[int]] | None = None,
                        tag: str = "loadgen_check") -> None:
    """Hold the kernel path's prefill logits against the plain path's
    (``use_pallas=False``) on ``prompts`` (default: one prompt of each
    distinct length of LOADGEN_TRACE), prefilled as the phase's servers do:
    ``oneshot`` in one call, ``chunked`` in CHUNK-token chunks chained from
    a fresh cache (a chunk resumed from a stored checkpoint starts from the
    same state).  The gap is absolute, or relative to the largest plain
    |logit| when ``relative``."""
    from repro_torch.models import lm
    from repro_torch.runtime import loadgen

    def logits_of(cfg, toks, mode):
        if mode == "oneshot":
            return lm.prefill(mparams, cfg, toks)[0]
        caches = lm.init_cache(cfg, 1, MAX_SEQ, dev)
        for pos in range(0, toks.shape[1], CHUNK):
            logits, caches = lm.prefill_chunk(mparams, cfg, toks[:, pos:pos + CHUNK], caches, pos)
        return logits

    if prompts is None:
        trace = loadgen.make_trace(loadgen.TraceSpec(vocab=mcfg.vocab, **LOADGEN_TRACE))
        by_len = {}
        for it in trace.items:
            by_len.setdefault(len(it.prompt), list(it.prompt))
        prompts = [by_len[n] for n in sorted(by_len)]
    plain = dataclasses.replace(mcfg, use_pallas=False)
    worst = 0.0
    with torch.no_grad():
        for prompt in prompts:
            n = len(prompt)
            toks = torch.as_tensor([prompt], device=dev)
            for mode in modes:
                got, want = logits_of(mcfg, toks, mode), logits_of(plain, toks, mode)
                require(got.shape == (1, mcfg.vocab) and bool(torch.isfinite(got).all()),
                        f"{mcfg.name} {mode} prefill of {n} tokens: logits of shape "
                        f"{tuple(got.shape)} or non-finite")
                gap = float((got - want).abs().max())
                if relative:
                    gap /= float(want.abs().max())
                require(gap <= tol, f"{mcfg.name} {mode} prefill of {n} tokens: the kernel "
                        f"path's logits differ from the plain path's by {gap:.3e} > {tol}")
                worst = max(worst, gap)
    say(tag, arch=mcfg.name, vs="use_pallas=False", prompts=len(prompts),
        prompt_lengths=len({len(p) for p in prompts}), modes="+".join(modes),
        max_gap=f"{worst:.3e}", tol=tol, gap="relative" if relative else "absolute",
        card=repr(card))


def serve_loadgen_lstm(cfg, params, prompts, dev, card: str,
                       cache_bytes: int = 256 << 20) -> int:
    """paper-lstm: four runs of the trace (no cache one-shot ``step()``;
    chunked ``step()`` with the cache; chunked adaptive ``step_block()`` with
    the cache; the chunked run under ``AsyncServer``), then the three fault
    runs.  Returns the ``lstm_seq`` calls of the four runs."""
    from repro_torch.kernels.lstm_cell import ops as lstm_ops
    from repro_torch.runtime import DecodeServer, Request
    from repro_torch.runtime import faults as fl

    lstm = lstm_ops.lstm_seq
    kw = dict(dev=dev, card=card, persistent_kernel=True)
    with torch.no_grad():
        runs = {
            "step": loadgen_serve(cfg, params, "step", lstm, **kw),
            "chunked_cache": loadgen_serve(cfg, params, f"step+chunk{CHUNK}+cache", lstm,
                                           prefill_chunk=CHUNK, prefix_cache_bytes=cache_bytes,
                                           **kw),
            "block_adaptive_cache": loadgen_serve(
                cfg, params, f"step_block+chunk{CHUNK}+adaptive+cache", lstm, block=True,
                prefill_chunk=CHUNK, prefill_adaptive=True, prefix_cache_bytes=cache_bytes, **kw),
            "async_chunked_cache": loadgen_serve(
                cfg, params, f"AsyncServer+chunk{CHUNK}+cache", lstm, use_async=True,
                prefill_chunk=CHUNK, prefix_cache_bytes=cache_bytes, **kw),
        }
        digests = {name: run["digests"] for name, run in runs.items()}
        want = digests["step"][0]
        require(all(d == want for ds in digests.values() for d in ds),
                f"{cfg.name} loadgen: tokens digests differ across runs and passes: {digests}")
        cached = runs["chunked_cache"]["passes"]
        full = sum(p["pc"]["hits"] for p in cached)
        partial = sum(p["pc"]["partial_hits"] for p in cached)
        require(full > 0 and partial > 0,
                f"{cfg.name} loadgen: {full} full and {partial} partial prefix hits")
        require(cached[1]["pc"]["hits"] == LOADGEN_TRACE["num_requests"]
                and cached[1]["prompt_steps"] == 0,
                f"{cfg.name} loadgen: the second pass with the cache is not all full hits")
        steps = {name: sum(p["prompt_steps"] for p in run["passes"])
                 for name, run in runs.items()}
        require(steps["chunked_cache"] < steps["step"],
                f"{cfg.name} loadgen: {steps['chunked_cache']} prompt steps with the cache, "
                f"{steps['step']} without")
        loadgen_plain_check(cfg, params, dev, card, ("oneshot", "chunked"), LOGITS_ATOL,
                            relative=False)

        # faults at full width, against the fault-free step() run's first pass
        clean = runs["step"]["passes"][0]["outs"]
        plan = fl.FaultPlan([fl.FaultSpec("decode.nan_logits", after=40)], seed=0)
        nan_run = loadgen_serve(cfg, params, "step+decode.nan_logits", lstm, faults=plan, **kw)
        got = nan_run["passes"][0]["outs"]
        bad = [u for u, (_, reason) in got.items() if reason == "error:nonfinite"]
        require(plan.hits == {"decode.nan_logits": 1} and len(bad) == 1
                and len(got) == len(clean)
                and all(got[u] == clean[u] for u in got if u not in bad)
                and nan_run["passes"][1]["outs"] == clean,
                f"{cfg.name} decode.nan_logits: quarantined {bad}; the survivors must "
                "equal the fault-free run")
        plan = fl.FaultPlan([fl.FaultSpec("decode.dispatch", after=10, times=3)], seed=0)
        disp_run = loadgen_serve(cfg, params, "step+decode.dispatch", lstm, faults=plan, **kw)
        retries = disp_run["passes"][0]["stats"]["health"]["dispatch_retries"]
        require(plan.hits == {"decode.dispatch": 3} and retries == 3
                and disp_run["digests"] == [want] * 2,
                f"{cfg.name} decode.dispatch: {retries} retries, digests {disp_run['digests']}")
        # a tick slower than the watchdog's bound that makes no progress (its
        # decode dispatch fails once) aborts the work in flight
        plan = fl.FaultPlan([fl.FaultSpec("tick.slow", after=2, delay_s=0.5),
                             fl.FaultSpec("decode.dispatch", after=2)], seed=0)
        srv = DecodeServer(cfg, params, num_slots=NUM_SLOTS, max_seq=MAX_SEQ, faults=plan,
                           watchdog_s=0.25, device=dev)
        stalled = [Request(uid=u, prompt=prompts[u], max_new_tokens=MAX_NEW) for u in range(4)]
        for r in stalled:
            srv.submit(r)
        srv.run_until_drained()
        health = srv.health()
        require(all(r.finish_reason == "error:stalled" for r in stalled)
                and health["status"] == "stalled" and health["stalled_events"] == 1,
                f"{cfg.name} tick.slow: {[r.finish_reason for r in stalled]}, health {health}")
    say("loadgen_faults", arch=cfg.name, nan_logits_quarantined_uid=bad[0],
        nan_logits_survivors_identical=True, dispatch_retries=retries,
        dispatch_digest_unchanged=True, stall_reason="error:stalled",
        stall_health=health["status"], watchdog_s=health["watchdog_s"], card=repr(card))
    return sum(run["launches"] for run in runs.values())


def serve_loadgen_mamba(mcfg, mparams, dev, card: str, cache_bytes: int = 1 << 30) -> int:
    """falcon-mamba-7b: the trace chunked, without and with a cache whose
    budget forces evictions: a checkpoint at full width is 64 layers ×
    (8192·16 + 3·8192) fp32, about 38 MiB, so 1 GiB holds about 26 and the
    trace's ~90 chunk boundaries and prompt ends evict.  Returns the
    ``ssm_scan`` launches."""
    from repro_torch.kernels.ssm_scan import ops as scan_ops

    kw = dict(dev=dev, card=card, prefill_chunk=CHUNK)
    with torch.no_grad():
        runs = {"chunked": loadgen_serve(mcfg, mparams, f"step+chunk{CHUNK}",
                                         scan_ops.ssm_scan, **kw),
                "chunked_cache": loadgen_serve(mcfg, mparams, f"step+chunk{CHUNK}+cache",
                                               scan_ops.ssm_scan,
                                               prefix_cache_bytes=cache_bytes, **kw)}
    digests = [d for run in runs.values() for d in run["digests"]]
    require(len(set(digests)) == 1, f"{mcfg.name} loadgen: digests differ: {digests}")
    cached = runs["chunked_cache"]["passes"]
    require(sum(p["pc"]["partial_hits"] for p in cached) > 0
            and sum(p["pc"]["evictions"] for p in cached) > 0,
            f"{mcfg.name} loadgen: no partial hit or no eviction under the budget")
    for name, run in runs.items():
        for i, p in enumerate(run["passes"]):
            require(p["launches"] == mcfg.n_layers * p["chunks_run"],
                    f"{mcfg.name} loadgen {name} pass {i}: {p['launches']} ssm_scan "
                    f"launches for {p['chunks_run']} chunks of {mcfg.n_layers} layers")
    loadgen_plain_check(mcfg, mparams, dev, card, ("chunked",), MAMBA_LOGITS_RTOL, relative=True)
    return sum(run["launches"] for run in runs.values())


def serve_loadgen_smollm(scfg, sparams, dev, card: str,
                         cache_bytes: int = 256 << 20) -> tuple[int, int]:
    """smollm-135m: the trace unchunked with a cache that holds every
    prompt.  Returns ``flash_attention``'s calls and launches."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    with torch.no_grad():
        run = loadgen_serve(scfg, sparams, "step+cache", fa_ops.flash_attention, dev=dev,
                            card=card, prefix_cache_bytes=cache_bytes)
    first, second = run["passes"]
    require(first["calls"] == scfg.n_layers * first["pc"]["misses"] and first["calls"] > 0,
            f"{scfg.name} loadgen: {first['calls']} flash_attention calls for "
            f"{first['pc']['misses']} misses of {scfg.n_layers} layers")
    require(second["calls"] == 0 and second["pc"]["hits"] == LOADGEN_TRACE["num_requests"],
            f"{scfg.name} loadgen: {second['calls']} flash_attention calls in the second pass")
    require(run["digests"][0] == run["digests"][1],
            f"{scfg.name} loadgen: digests differ: {run['digests']}")
    loadgen_plain_check(scfg, sparams, dev, card, ("oneshot",), DENSE_LOGITS_RTOL, relative=True)
    return run["calls"], run["launches"]


def serve_loadgen_entry_points(card: str, device: str = "cuda") -> None:
    """``python -m repro_torch.launch.serve`` and ``python -m
    repro_torch.obs.report`` as subprocesses (started together), then
    ``python -m repro_torch.obs.check`` on the four documents they write."""
    docs = ROOT / "build" / "serve_loadgen"
    docs.mkdir(parents=True, exist_ok=True)
    files = {k: docs / f"{k}.json" for k in ("loadgen", "trace", "metrics", "ledger")}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    commands = {
        "launch.serve": [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "paper-lstm",
                         "--loadgen", "--prefill-chunk", "4", "--prefix-cache", "64",
                         "--loadgen-out", str(files["loadgen"]), "--trace-out", str(files["trace"]),
                         "--metrics-out", str(files["metrics"]), "--device", device],
        "obs.report": [sys.executable, "-m", "repro_torch.obs.report", "--backends", "eager",
                       "kernel", "--out", str(files["ledger"]), "--device", device],
    }
    procs = {name: subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, cmd in commands.items()}
    for name, proc in procs.items():
        try:
            text, _ = proc.communicate(timeout=300)
        finally:
            proc.kill()
            proc.wait()
        for ln in text.splitlines()[-8:]:
            say("entry_point", command=name, line=repr(ln))
        require(proc.returncode == 0, f"python -m repro_torch.{name} exited {proc.returncode}")
    check = subprocess.run([sys.executable, "-m", "repro_torch.obs.check",
                            *map(str, files.values())], env=env, cwd=ROOT, capture_output=True,
                           text=True, timeout=120)
    require(check.returncode == 0,
            f"repro_torch.obs.check refused the documents:\n{check.stdout}{check.stderr}")
    served = json.loads(files["loadgen"].read_text())
    ledger = json.loads(files["ledger"].read_text())["ledger"]
    require(served["completed"] == served["requests"] and ledger
            and any("|kernel|" in row["program"] for row in ledger),
            "the entry points' documents are incomplete")
    say("entry_points", serve_digest=served["tokens_digest"], serve_ticks=served["ticks"],
        serve_tok_s=f"{served['throughput_tok_s']:.1f}", ledger_programs=len(ledger),
        obs_check="ok", card=repr(card))


# ---------------------------------------------------------------------------
# phase 16: bit_path
# ---------------------------------------------------------------------------

def _program_on(prog, dev):
    """``prog`` with every weight copied to ``dev``."""
    return dataclasses.replace(
        prog, C=prog.C.to(dev), beta=None if prog.beta is None else prog.beta.to(dev),
        stages=[dataclasses.replace(st, params={k: v.to(dev) for k, v in st.params.items()})
                for st in prog.stages])


def _uniform(gen, shape, scale=1.0) -> torch.Tensor:
    return (torch.rand(shape, generator=gen) * 2 - 1) * scale


def bit_path(dev, card: str, T: int = BIT_T, difftest_seeds: int = BIT_DIFFTEST_SEEDS
             ) -> dict[str, int]:
    """The paper's fixed-point path on the card: rtlsim against the golden
    model at full width, the ref/eager/kernel float legs on the same cells,
    the card against the CPU word for word, ``synthesize(backend="verilog")``
    against the emission from CPU copies of the weights, the static gate
    (``synthesize(backend="kernel", analyze=True)``), and the difftest and
    analyze CLIs as subprocesses.  Returns the generated stage kernel's
    launches by cell (the float legs and the gated synthesis)."""
    from repro_torch.analyze import AnalysisError, WaiverRegistry, analyze_program
    from repro_torch.codegen import build_program, emit_program, kernel_backend, rtlsim
    from repro_torch.configs.paper_mlp import CASE_STUDY, FIG10_A, FIG10_B
    from repro_torch.core import synthesis
    from repro_torch.core.synthesis import NetworkSpec
    from repro_torch.obs.check import check_analyze_doc
    from repro_torch.verify import difftest, golden

    gen = torch.Generator().manual_seed(16)
    cpu = torch.device("cpu")
    launches = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # -- 16a/b. full width: the bit contract, then the float legs -------------
    for cell in ("lstm", "gru", "ssm", "mlp"):
        spec = NetworkSpec(WIDTH, 8, WIDTH, WIDTH, cell=cell, seq_len=0 if cell == "mlp" else T)
        prog = build_program(spec, dev)
        u = _uniform(gen, (BIT_BATCH, WIDTH) if cell == "mlp" else (BIT_BATCH, T, WIDTH))
        for width in ((18, 24, 32) if cell == "lstm" else (18,)):
            sync()
            t0 = time.perf_counter()
            sim = rtlsim.simulate(prog, u, width=width, device=dev)
            sync()
            t1 = time.perf_counter()
            ref = golden.fixed_forward(prog, u, width=width, device=dev)
            sync()
            t2 = time.perf_counter()
            require(sim.y_codes.device.type == dev.type and torch.equal(sim.y_codes, ref),
                    f"bit_path {cell} W={width}: rtlsim differs from the golden model in "
                    f"{int((sim.y_codes != ref).sum())} words")
            want_cycles = rtlsim.fsm_cycle_estimate(prog, None if cell == "mlp" else T)
            require(sim.cycles == want_cycles,
                    f"bit_path {cell} W={width}: {sim.cycles} cycles, the FSM model says "
                    f"{want_cycles}")
            say("bit_path", step="bit_contract", cell=cell, layers=8, width_lanes=WIDTH,
                word_bits=width, B=BIT_BATCH, T=T if cell != "mlp" else 0, bit_exact=True,
                rtlsim_s=f"{t1 - t0:.2f}", golden_s=f"{t2 - t1:.2f}", fsm_cycles=sim.cycles,
                max_abs_code=int(ref.abs().max()), card=repr(card))
        del prog
        kernel_backend.codegen_stage.launches = 0
        with torch.no_grad():
            ys = difftest.float_legs(spec, u.to(dev), dev)
        sync()
        launches[cell] = kernel_backend.codegen_stage.launches
        require(launches[cell] >= 1, f"bit_path {cell}: no generated-kernel launch")
        y = ys["eager"]
        scale = max(1.0, float(y.abs().max()))
        errs = {k: float((ys[k] - y).abs().max()) for k in ("kernel", "ref")}
        require(all(bool(torch.isfinite(v).all()) and v.shape == y.shape for v in ys.values())
                and max(errs.values()) <= BIT_FLOAT_TOL * scale,
                f"bit_path {cell}: float legs differ from eager by {errs} (max |y| {scale:.3e})")
        say("bit_path", step="float_legs", cell=cell, T=T if cell != "mlp" else 0,
            kernel_vs_eager=f"{errs['kernel']:.3e}", ref_vs_eager=f"{errs['ref']:.3e}",
            max_abs_y=f"{scale:.3e}", tol=f"{BIT_FLOAT_TOL}*max(1,max|y|)",
            codegen_launches=launches[cell])
        del ys
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- 16c. the card against the CPU, word for word, at 4 x 64 ---------------
    for cell in ("lstm", "gru", "ssm", "mlp"):
        for width in (8, 18, 32):
            spec = NetworkSpec(64, 4, 64, 64, cell=cell, seq_len=0 if cell == "mlp" else 32,
                               quant_bits=width)
            prog = build_program(spec, dev)
            host = _program_on(prog, cpu)
            u = _uniform(gen, (4, 64) if cell == "mlp" else (4, 32, 64), scale=4.0)
            a = rtlsim.simulate(prog, u, collect_ranges=True, device=dev)
            b = rtlsim.simulate(host, u, collect_ranges=True, device=cpu)
            g = golden.fixed_forward(prog, u, device=dev)
            same = (torch.equal(a.y_codes.cpu(), b.y_codes) and a.cycles == b.cycles
                    and all(torch.equal(a.final_states[k].cpu(), v)
                            for k, v in b.final_states.items())
                    and all(np.array_equal(a.wire_ranges[k][i], v[i])
                            for k, v in b.wire_ranges.items() for i in (0, 1))
                    and torch.equal(g.cpu(), golden.fixed_forward(host, u, device=cpu))
                    and torch.equal(g, a.y_codes))
            require(same, f"bit_path {cell} 4x64 W={width}: the card differs from the CPU")
            say("bit_path", step="card_vs_cpu", cell=cell, shape="4x64", word_bits=width,
                equal=True, max_abs_code=int(g.abs().max()))

    # -- 16d. synthesize(backend="verilog") ------------------------------------
    verilog_specs = {"CASE_STUDY": CASE_STUDY, "FIG10_A": FIG10_A, "FIG10_B": FIG10_B,
                     **difftest.golden_specs()}
    for label, spec in verilog_specs.items():
        report = synthesis.synthesize(spec, backend="verilog", measure=False, fallback=False,
                                      device=dev)
        host_rtl = emit_program(_program_on(build_program(spec, dev), cpu))
        require(report.backend == "verilog" and report.rtl == host_rtl,
                f"bit_path verilog {label}: the RTL differs from the CPU copies' emission")
        say("bit_path", step="verilog", spec=label,
            sha256=hashlib.sha256(report.rtl.encode()).hexdigest()[:16],
            bytes=len(report.rtl.encode()), resources=repr(report.resources.summary()))

    # -- 16e. the static gate ----------------------------------------------------
    gate_specs = {"CASE_STUDY": CASE_STUDY, "FIG10_A": FIG10_A, "FIG10_B": FIG10_B,
                  f"lstm_8x{WIDTH}_T{T}": NetworkSpec(WIDTH, 8, WIDTH, WIDTH, cell="lstm",
                                                      seq_len=T)}
    for label, spec in gate_specs.items():
        prog = build_program(spec, dev)
        t0 = time.perf_counter()
        res = analyze_program(prog)
        analysis_s = time.perf_counter() - t0
        del prog
        kernel_backend.codegen_stage.launches = 0
        waived = 0
        try:
            report = synthesis.synthesize(spec, backend="kernel", analyze=True, measure=False,
                                          fallback=False, device=dev)
            require(res.ok, f"bit_path gate {label}: passed with unwaived errors")
        except AnalysisError as exc:
            ids = sorted(f.id for f in exc.findings)
            require(ids == sorted(f.id for f in res.errors),
                    f"bit_path gate {label}: the gate's findings differ from the analysis")
            waivers = WaiverRegistry({i: "seeded weights, known" for i in ids})
            report = synthesis.synthesize(spec, backend="kernel", analyze=True, measure=False,
                                          fallback=False, waivers=waivers, device=dev)
            waived = len(ids)
        sync()
        cell = spec.cell
        launches[cell] = launches.get(cell, 0) + kernel_backend.codegen_stage.launches
        doc = report.analysis
        require(report.backend == "kernel" and check_analyze_doc(doc) == []
                and doc["summary"]["waived"] == waived and doc["summary"]["errors"] == 0
                and doc["static_snr_db"] == res.to_doc()["static_snr_db"],
                f"bit_path gate {label}: report {doc['summary']}")
        say("bit_path", step="static_gate", spec=label, errors=len(res.errors), waived=waived,
            warnings=doc["summary"]["warnings"], static_snr_db=doc["static_snr_db"],
            min_safe_width=doc["min_safe_width"], converged=doc["converged"],
            iters=doc["iters"], analysis_s=f"{analysis_s:.2f}", card=repr(card))

    # -- 16f. the CLIs as subprocesses ---------------------------------------------
    docs = ROOT / "build" / "bit_path"
    docs.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    commands = {
        "verify.difftest": [sys.executable, "-m", "repro_torch.verify.difftest",
                            "--seeds", str(difftest_seeds)],
        "verify.difftest --regen-goldens": [sys.executable, "-m", "repro_torch.verify.difftest",
                                            "--regen-goldens", str(docs / "goldens")],
        "analyze": [sys.executable, "-m", "repro_torch.analyze", "--all-cells",
                    "--bits", "8,16,32", "--out", str(docs / "analyze.json")],
    }
    if dev.type != "cuda":
        for cmd in commands.values():
            cmd += ["--device", "cpu"]
    for name, cmd in commands.items():
        t0 = time.perf_counter()
        run = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True,
                             timeout=600)
        for ln in (run.stdout + run.stderr).splitlines()[-4:]:
            say("bit_path_cli", command=repr(name), line=repr(ln))
        require(run.returncode == 0, f"python -m repro_torch.{name} exited {run.returncode}")
        say("bit_path", step="cli", command=repr(name), exit=0,
            seconds=f"{time.perf_counter() - t0:.1f}")
    require(check_analyze_doc(json.loads((docs / "analyze.json").read_text())) == []
            and len(list((docs / "goldens").glob("*.v"))) == 4,
            "bit_path: the CLIs' documents are incomplete")
    return launches


# ---------------------------------------------------------------------------
# phase 17: tune_chaos
# ---------------------------------------------------------------------------

def tune_chaos(dev, card: str, T: int = BIT_T) -> dict:
    """The paper's Fig. 10 loop and the chaos suite on the card:
    ``synthesize(optimize="latency")`` on the reference's two tune case
    studies and the full-width lstm of phase 16 (the default grid, backends
    eager and kernel; on the case studies then ``analyze_prune=True``, whose
    winner must be the same), each ``repro.tune/v1`` document under
    ``build/tune_chaos/``; the chaos suite on full-width ``smollm-135m`` and
    ``paper-lstm`` (``use_pallas``), its prefills first held against the
    plain path; then ``python -m repro_torch.verify.chaos`` and
    ``python -m repro_torch.analyze --lint-src`` as subprocesses and ``python
    -m repro_torch.obs.check`` on every document.  Returns the launches of
    the generated stage kernel by tuned cell (``"tune"``), and of
    ``flash_attention`` (and its calls) and ``lstm_seq`` in the suite (by
    arch), each count set to 0 just before its run."""
    from repro_torch.codegen import kernel_backend
    from repro_torch.configs import get_config
    from repro_torch.core import synthesis
    from repro_torch.core.synthesis import NetworkSpec
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.lstm_cell import ops as lstm_ops
    from repro_torch.models import lm
    from repro_torch.obs import OBS
    from repro_torch.obs.check import check_chaos_doc, check_tune_doc
    from repro_torch.tune import TuneResult, enumerate_space, tune, write_doc
    from repro_torch.verify import chaos

    docs = ROOT / "build" / "tune_chaos"
    docs.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    launches: dict = {"tune": {}}

    # -- 17a. the Fig. 10 loop ------------------------------------------------------
    case_studies = {"mlp_case_study": NetworkSpec(3, 4, 4, 2),
                    "lstm_h4": NetworkSpec(2, 1, 4, 2, cell="lstm", seq_len=6)}
    cells = {**case_studies,
             f"lstm_8x{WIDTH}_T{T}": NetworkSpec(WIDTH, 8, WIDTH, WIDTH, cell="lstm",
                                                 seq_len=T)}

    def span_seconds() -> dict[str, float]:
        """Seconds in each of the tuner's phases since the last call (its
        ``tune.predict`` / ``tune.measure`` / ``tune.validate`` spans)."""
        out = {"predict": 0.0, "measure": 0.0, "validate": 0.0}
        for ev in OBS.tracer.events():
            phase = ev["name"].removeprefix("tune.")
            if ev["name"].startswith("tune.") and phase in out:
                out[phase] += ev["dur"] / 1e6
        OBS.tracer.reset()
        return out

    OBS.tracer.enabled = True
    for label, spec in cells.items():
        space = enumerate_space(spec)
        OBS.tracer.reset()
        kernel_backend.codegen_stage.launches = 0
        t0 = time.perf_counter()
        result = synthesis.synthesize(spec, optimize="latency", budget=TUNE_BUDGET,
                                      batch=TUNE_BATCH, device=dev)
        sync(dev)
        tune_s = time.perf_counter() - t0
        n_launch = launches["tune"][label] = kernel_backend.codegen_stage.launches
        spans = span_seconds()
        best = result.best
        require(isinstance(result, TuneResult) and best.validated and best.gate.ok
                and result.report is not None and result.report.backend == best.cand.backend,
                f"tune {label}: the winner {best.key} was not validated and built")
        require(n_launch >= 1, f"tune {label}: no generated-kernel launch")
        # analyze_prune keeps the candidates without error-grade overflow
        # findings, and the baseline: the first run's predictions decide it
        base = result.baseline.cand
        kept = [s.key for s in result.scored
                if not s.predicted["overflow_errors"] or s.cand == base]
        winner_pruned = bool(best.predicted["overflow_errors"])
        runs = {"": result}
        pruned_fields = {}
        if label in case_studies:
            # the reference's tune-suite assertion, on its own case studies:
            # pruning keeps the winner
            pruned = runs["_pruned"] = tune(spec, "latency", TUNE_BUDGET, TUNE_BATCH,
                                            analyze_prune=True, device=dev)
            require([s.key for s in pruned.scored] == kept,
                    f"tune {label}: the pruned run kept {len(pruned.scored)} candidates, "
                    f"the first run's findings {len(kept)}")
            require(pruned.best.key == best.key,
                    f"tune {label}: analyzer pruning changed the winner ({best.key} -> "
                    f"{pruned.best.key})")
            pruned_fields = dict(pruned_winner=pruned.best.key,
                                 **{f"pruned_{k}_s": f"{v:.2f}"
                                    for k, v in span_seconds().items()})
        for tag, res in runs.items():
            doc = write_doc(res, str(docs / f"tune_{label}{tag}.json"))
            require(check_tune_doc(doc) == [], f"tune {label}{tag}: {check_tune_doc(doc)}")
        say("tune", cell=label, enumerated=len(space), pruned=len(space) - len(kept),
            measured=len(result.measured), winner=best.key,
            speedup=f"{result.speedup:.3f}" if result.speedup else "n/a",
            pareto=len(result.pareto), winner_gate_float_err=f"{best.gate.float_err:.3e}",
            winner_bit_exact=best.gate.bit_exact, winner_pruned_by_analyzer=winner_pruned,
            codegen_launches=n_launch, tune_s=f"{tune_s:.2f}",
            **{f"{k}_s": f"{v:.2f}" for k, v in spans.items()}, **pruned_fields,
            card=repr(card))
        for s in result.measured:
            say("tune_measured", cell=label, candidate=s.key,
                predicted_fsm_cycles=s.predicted["fsm_cycles"],
                overflow_errors=s.predicted["overflow_errors"],
                measured_us=f"{s.measured['wall_us']:.1f}", validated=s.validated)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    OBS.tracer.enabled = False

    # -- 17b. the chaos suite at full width ----------------------------------------
    for arch, counter, tol, relative in (
            ("smollm-135m", fa_ops.flash_attention, DENSE_LOGITS_RTOL, True),
            ("paper-lstm", lstm_ops.lstm_seq, LOGITS_ATOL, False)):
        cfg = dataclasses.replace(get_config(arch), use_pallas=True)
        params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        # the suite's prefills (its 6-token prompts, one per request) on the
        # kernel path against the plain path, before the counts start
        loadgen_plain_check(cfg, params, dev, card, ("oneshot",), tol, relative,
                            prompts=[r.prompt for r in chaos._requests(cfg, 4, 0)],
                            tag="chaos_check")
        sync(dev)
        counter.launches = 0
        if hasattr(counter, "calls"):
            counter.calls = 0
        t0 = time.perf_counter()
        doc = chaos.run_suite(seed=0, arch=arch, device=dev, cfg=cfg, params=params)
        sync(dev)
        n_launch = launches[arch] = counter.launches
        launches[f"{arch}_calls"] = getattr(counter, "calls", n_launch)
        for sc in doc["scenarios"]:
            say("chaos", arch=arch, scenario=sc["name"], passed=sc["passed"],
                faults=repr(sc["faults"]), reasons=repr(sc["detail"].get("reasons")))
        say("chaos_suite", arch=arch, passed=doc["passed"],
            all_classes_hit=doc["all_classes_hit"], kernel_launches=n_launch,
            seconds=f"{time.perf_counter() - t0:.1f}", card=repr(card))
        require(doc["passed"] and doc["all_classes_hit"] and check_chaos_doc(doc) == [],
                f"chaos {arch}: {[sc['name'] for sc in doc['scenarios'] if not sc['passed']]}")
        require(n_launch >= 1, f"chaos {arch}: its kernel was never launched")
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- 17c. the CLIs as subprocesses -------------------------------------------------
    chaos_doc = docs / "chaos.json"
    commands = {
        "verify.chaos": [sys.executable, "-m", "repro_torch.verify.chaos", "--seed", "0",
                         "--out", str(chaos_doc)],
        "analyze --lint-src": [sys.executable, "-m", "repro_torch.analyze", "--lint-src"],
    }
    if dev.type != "cuda":
        for cmd in commands.values():
            cmd += ["--device", "cpu"]
    for name, cmd in commands.items():
        t0 = time.perf_counter()
        run = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True,
                             timeout=600)
        for ln in (run.stdout + run.stderr).splitlines()[-3:]:
            say("tune_chaos_cli", command=repr(name), line=repr(ln))
        require(run.returncode == 0, f"python -m repro_torch.{name} exited {run.returncode}")
        say("tune_chaos", step="cli", command=repr(name), exit=0,
            seconds=f"{time.perf_counter() - t0:.1f}")
    check = subprocess.run([sys.executable, "-m", "repro_torch.obs.check", str(chaos_doc),
                            *map(str, sorted(docs.glob("tune_*.json")))], env=env, cwd=ROOT,
                           capture_output=True, text=True, timeout=120)
    require(check.returncode == 0,
            f"repro_torch.obs.check refused the documents:\n{check.stdout}{check.stderr}")
    say("tune_chaos", step="obs_check", documents=1 + len(list(docs.glob("tune_*.json"))),
        ok=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import codegen
    from repro_torch.codegen import eager_backend, kernel_backend, lower
    from repro_torch.codegen.builders import mlp_graph
    from repro_torch.codegen.ir import GraphBuilder, Schedule, Stage
    from repro_torch.configs import get_config
    from repro_torch.configs.paper_lstm import gru_config
    from repro_torch.kernels.int8_matmul import kernel as i8_kernel
    from repro_torch.kernels.int8_matmul import ops as i8_ops
    from repro_torch.kernels.ssm_scan import kernel as scan_kernel
    from repro_torch.kernels.ssm_scan import ops as scan_ops
    from repro_torch.configs.paper_mlp import CASE_STUDY, FIG10_A, FIG10_B
    from repro_torch.core import synthesis
    from repro_torch.core.cslow import fold_streams, unfold_streams
    from repro_torch.core.synthesis import NetworkSpec
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
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

    def chained_graph(d_in: int, width: int, n1: int):
        """Two step maccs in a chain: z2's row reads both ends of z1 (columns
        of several 32-column tiles) and a slice of the input; the update
        ends in tanh, so the chain stays bounded over T."""
        g = GraphBuilder()
        u = g.input("u", d_in)
        h = g.state("h", width)
        z1 = g.macc("z1", g.concat("cat", u, h), g.const("W1", (d_in + width, n1)),
                    g.const("b1", (1, n1)))
        mix = g.concat("mix", g.slice("s0", z1, n1 - 40, n1),
                       g.af("a", g.slice("s1", z1, 0, 33), "gelu"), g.slice("uu", u, 1, 3))
        z2 = g.macc("z2", mix, g.const("W2", (75, width)), g.sub("bias", h, g.af("t", h, "silu")))
        g.update("h", g.af("h_next", g.add("hz", g.af("r", z2, "relu"),
                                           g.mul("hh", h, g.af("sg", h, "sigmoid"))), "tanh"))
        return g.build(output=z1)

    lut6 = make_lut(6, device=dev)
    variants = [(stage_of(c, 1), None, None) for c in ("lstm", "gru", "ssm", "mlp")]
    variants += [(Stage("chained", chained_graph(24, 200, 256), Schedule(steps=1), {}), None, None)]
    variants += [(stage_of("lstm", 1), lut6, None), (stage_of("lstm", 1), None, 8),
                 (stage_of("lstm", 1), lut6, 8), (stage_of("mlp", 1), None, 8),
                 (stage_of("mlp", 1, width=32), None, None),
                 (stage_of("mlp", 1, width=CASE_STUDY.nodes_per_layer), None, None)]
    sources = [kernel_backend.compile_stage(st, lut=lut, quant_bits=q).source
               for st, lut, q in variants]
    t0 = time.perf_counter()
    paths = _build.build_many([("lstm_seq", lstm_kernel.SOURCE), ("tanh_lut", lut_kernel.SOURCE),
                               ("ssm_scan", scan_kernel.SOURCE),
                               ("int8_matmul", i8_kernel.SOURCE),
                               ("flash_attention", fa_kernel.SOURCE)]
                              + [(kernel_backend.LIBRARY, s) for s in sources])
    build_s = time.perf_counter() - t0
    for kernel_module in (lstm_kernel, lut_kernel, scan_kernel, i8_kernel, fa_kernel):
        kernel_module.load()
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
        lstm_calls = launches_per_call(lambda: lstm_ops.lstm_seq(*args))
        lstm_floor_ms = time_ms(lambda: lstm_kernel.serial_floor(B, T, H), l2)
        lstm_fixed_ms = time_ms(lambda: lstm_kernel.serial_floor(B, 1, H), l2)
        # the chunked path's shape: one 64-token chunk of a prefill
        args64 = [a[:, :CHUNK] if a.dim() == 3 else a for a in args]
        lstm_ms64 = time_ms(lambda: lstm_ops.lstm_seq(*args64), l2)
        lstm_lib_ms64 = time_ms(lambda: cudnn(args64[0], (h0[None], c0[None])), l2)
    require(lstm_calls == 2, f"lstm_seq: {lstm_calls} CUDA launches a call, not 2")
    lstm_cfg = lstm_kernel.config(B, H)
    lstm_bound, lstm_bound_by = lstm_bound_ms(B, T, D, H)
    say("kernel_time", kernel="lstm_seq", B=B, T=T, D=D, H=H, ms=f"{lstm_ms:.4f}",
        us_per_step=f"{1e3 * lstm_ms / T:.2f}", plain_ms=f"{lstm_plain_ms:.4f}",
        library_ms=f"{lstm_lib_ms:.4f}", library="torch.nn.LSTM(cuDNN)",
        library_max_abs_diff=f"{lib_err:.3e}", over_library=f"{lstm_ms / lstm_lib_ms:.3f}",
        launches_per_call=lstm_calls, weights_resident=lstm_cfg["weights_resident"],
        grid=lstm_cfg["grid"], serial_floor_ms=f"{lstm_floor_ms:.4f}",
        fixed_ms=f"{lstm_fixed_ms:.4f}", bound_ms=f"{lstm_bound:.4f}", bound_by=lstm_bound_by,
        reps=REPS, card=repr(card))
    say("kernel_time", kernel="lstm_seq", B=B, T=CHUNK, D=D, H=H, ms=f"{lstm_ms64:.4f}",
        us_per_step=f"{1e3 * lstm_ms64 / CHUNK:.2f}", library_ms=f"{lstm_lib_ms64:.4f}",
        over_library=f"{lstm_ms64 / lstm_lib_ms64:.3f}", reps=REPS, card=repr(card))
    del cudnn
    phase_done("lstm_seq")

    # -- 3. serve full-width paper-lstm (use_pallas) --------------------------
    rng = np.random.default_rng(1)
    lengths = rng.integers(16, 257, size=N_REQUESTS)
    lengths[0] = 256
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).tolist() for n in lengths]

    def serve(mcfg, params, label: str, block: bool, counter, chunks_launch: bool = True,
              launches_per_prefill=None, **kw):
        """Drive ``DecodeServer`` over the 16 requests; ``counter`` is the
        wrapper whose launches this run must show exactly once per layer of
        every prefill call (of every one-shot prefill only, and none in a
        chunked run, when ``chunks_launch`` is False).  A wrapper that also
        counts ``calls`` makes ``launches_per_prefill(n)`` CUDA launches a
        layer for a one-shot prefill of n tokens, and its calls are held to
        the rule above."""
        obs = Observability(trace=True)
        srv = DecodeServer(mcfg, params, num_slots=NUM_SLOTS, max_seq=MAX_SEQ,
                           block_k=BLOCK_K, obs=obs, **kw)
        for i, p in enumerate(prompts):
            srv.submit(Request(uid=i, prompt=p, max_new_tokens=MAX_NEW))
        torch.cuda.synchronize()
        counter.launches = 0
        if launches_per_prefill is not None:
            counter.calls = 0
        t0 = time.perf_counter()
        done = srv.run_until_drained(persistent=block)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = counter.launches
        calls = counter.calls if launches_per_prefill is not None else launches
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
        want = mcfg.n_layers * n_prefills if chunks_launch or not kw.get("prefill_chunk") else 0
        require(calls == want,
                f"{mcfg.name} {label}: {calls} kernel calls for {n_prefills} prefill "
                f"calls of {mcfg.n_layers} layers")
        if launches_per_prefill is not None:
            want_launches = (0 if kw.get("prefill_chunk") else
                             mcfg.n_layers * sum(launches_per_prefill(int(n)) for n in lengths))
            require(launches == want_launches,
                    f"{mcfg.name} {label}: {launches} CUDA launches, not {want_launches}")
        # a persistent kernel (lstm_seq, codegen_stage) waits for its barrier
        # word on the host once a call; the other kernels never do
        kernel_syncs = srv.prefill_kernel_syncs
        want_syncs = launches if counter in (lstm_ops.lstm_seq, kernel_backend.codegen_stage) else 0
        require(kernel_syncs == want_syncs,
                f"{mcfg.name} {label}: {kernel_syncs} host round-trips in prefill kernel "
                f"calls, not {want_syncs}")
        say("serve", arch=mcfg.name, driver=label, requests=len(done), wall_ms=f"{wall_ms:.1f}",
            decode_tok_s=f"{st['decoded_tokens'] / (decode_ms / 1e3):.1f}",
            prefill_ms_per_prompt=f"{(wall_ms - decode_ms) / N_REQUESTS:.2f}",
            decode_syncs=st["decode_syncs"], decoded_tokens=st["decoded_tokens"],
            syncs_per_token=f"{st['syncs_per_token']:.4f}", kernel_syncs=kernel_syncs,
            kernel_calls=calls, kernel_launches=launches, prefill_calls=n_prefills,
            card=repr(card))
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
    def rand_consts(graph, T: int, q: int | None, rng=gen):
        consts = {}
        for n in graph.consts():
            shape = ((T,) if n.attr("per_step") else ()) + tuple(n.attr("shape"))
            scale = 1.0 / math.sqrt(shape[-2]) if shape[-2] > 1 else 0.2
            consts[n.name] = torch.randn(shape, generator=rng, device=dev) * scale
        if "a" in consts:                      # a stable ssm decay in (0.5, 0.95)
            consts["a"] = 0.5 + 0.45 * torch.rand(consts["a"].shape, generator=rng, device=dev)
        return kernel_backend.prequantize_consts(graph, consts, q)

    def run_case(label: str, stage: Stage, B: int, T: int, *, lut=None, q=None,
                 zero_carry=False, consts=None, x0=None, rng=gen):
        graph = stage.graph
        consts = rand_consts(graph, T, q, rng) if consts is None else consts
        if x0 is None:
            x0 = {s: (torch.zeros if zero_carry else torch.randn)(
                      (B, w), **({} if zero_carry else {"generator": rng}), device=dev)
                  for s, w in graph.states.items()}
        inp = graph.input_node()
        us = None if inp is None else torch.randn((B, T, inp.width), generator=rng, device=dev)
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
        # z2's row reads z1 of the same step across 8 column tiles of other
        # blocks: the grid barrier between two step maccs.  Its own generator,
        # so that the later phases draw the same data with or without it.
        run_case("chained_z1_256_B11_T37", Stage("chained", chained_graph(24, 200, 256),
                                                 Schedule(steps=37), {}), 11, 37,
                 rng=torch.Generator(device=dev).manual_seed(15))
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
                call_state = ((x0["h"][None], x0["c"][None]),)
                call = lambda: lib(us, *call_state)
            else:
                # torch's GRU candidate: n = tanh(W_in u + b_in + r·(W_hn h + b_hn)),
                # the graph's form (builders.gru_graph) with b → bias_ih, bh_n → b_hn
                lib = torch.nn.GRU(D, H, batch_first=True).to(dev)
                lib.weight_ih_l0.copy_(consts["w_x"].T)
                lib.weight_hh_l0.copy_(consts["w_h"].T)
                lib.bias_ih_l0.copy_(consts["b"][0])
                lib.bias_hh_l0.copy_(torch.cat([torch.zeros(2 * H, device=dev),
                                                consts["bh_n"][0]]))
                call_state = (x0["h"][None],)
                call = lambda: lib(us, *call_state)
            y_lib, _ = call()
            lib_diff = float((y_lib - ys).abs().max())
            require(lib_diff <= LOGITS_ATOL,
                    f"codegen_stage {cell}: torch.nn.{type(lib).__name__} differs by {lib_diff:.3e}")
            l_ms = time_ms(call, l2)
            bnd, by = stage_bound_ms(stage.graph, consts, B, T)
            calls = launches_per_call(lambda: run(consts, x0, us))
            require(calls == 2, f"codegen_stage {cell}: {calls} CUDA launches a call, not 2")
            stage_cfg = kernel_backend.launch_config(run.source)
            floor_ms = time_ms(lambda: kernel_backend.serial_floor(run.source, T), l2)
            fixed_ms = time_ms(lambda: kernel_backend.serial_floor(run.source, 1), l2)
            codegen_time[cell] = (k_ms, p_ms, l_ms, bnd, by, calls,
                                  stage_cfg["weights_resident"], floor_ms, fixed_ms)
            extra = {}
            if cell == "lstm":
                extra = dict(lstm_seq_ms=f"{lstm_ms:.4f}",
                             generated_over_hand_written=f"{k_ms / lstm_ms:.3f}")
            say("kernel_time", kernel=f"codegen_stage[{cell}]", B=B, T=T, D=D, H=H,
                ms=f"{k_ms:.4f}", us_per_step=f"{1e3 * k_ms / T:.2f}", plain_ms=f"{p_ms:.4f}",
                library_ms=f"{l_ms:.4f}", library=f"torch.nn.{type(lib).__name__}(cuDNN)",
                library_max_abs_diff=f"{lib_diff:.3e}", over_library=f"{k_ms / l_ms:.3f}",
                launches_per_call=calls, weights_resident=stage_cfg["weights_resident"],
                grid=stage_cfg["grid"], barriers_per_step=stage_cfg["barriers_per_step"],
                serial_floor_ms=f"{floor_ms:.4f}", fixed_ms=f"{fixed_ms:.4f}",
                bound_ms=f"{bnd:.4f}", bound_by=by,
                **extra, reps=REPS, card=repr(card))
            # the chunked path's shape: one 64-token chunk of a prefill
            us64 = us[:, :CHUNK].contiguous()
            k_ms64 = time_ms(lambda: run(consts, x0, us64), l2)
            l_ms64 = time_ms(lambda: lib(us64, *call_state), l2)
            say("kernel_time", kernel=f"codegen_stage[{cell}]", B=B, T=CHUNK, D=D, H=H,
                ms=f"{k_ms64:.4f}", us_per_step=f"{1e3 * k_ms64 / CHUNK:.2f}",
                library_ms=f"{l_ms64:.4f}", over_library=f"{k_ms64 / l_ms64:.3f}",
                reps=REPS, card=repr(card))
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
    lut_calls = launches_per_call(lambda: lut_ops.tanh_lut(big, table))
    lut_plain_ms = time_ms(lambda: tanh_lut_ref(big, table), l2)
    # about 10 fp32 operations and 8 bytes (read x, write y) per element
    lut_bound, lut_bound_by = bound_ms(10.0 * big.numel() / PEAK_FP32_FLOPS,
                                       8.0 * big.numel())
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
            plain_spread = "n/a"
            if spec.quant_bits is None:
                fwd_e, p_e = synthesis.build_forward(spec, "eager", device=dev)
                want, against = fwd_e(p_e, u), "eager"
                # how far two plain evaluations of the same spec lie apart: the
                # eager backend on the host's CPU against itself on the card
                host = lambda v: v.cpu() if torch.is_tensor(v) else v
                p_cpu = {k: host(v) for k, v in p_e.items() if k != "stages"}
                p_cpu["stages"] = [{k: host(v) for k, v in sp.items()} for sp in p_e["stages"]]
                plain_spread = f"{float((fwd_e(p_cpu, u.cpu()).to(dev) - want).abs().max()):.3e}"
            else:   # int8 / LUT: the kernel backend's plain version, on CPU copies
                p_cpu = {"stages": [{k: v.cpu() for k, v in sp.items()} for sp in p_k["stages"]],
                         "C": p_k["C"].cpu()}
                want, against = fwd_k(p_cpu, u.cpu()).to(dev), "plain"
            torch.cuda.synchronize()
            require(tuple(y_k.shape) == report.output_shape,
                    f"synth {label}: y of shape {tuple(y_k.shape)}, report says {report.output_shape}")
            err = check_close(f"synth {label} vs {against}", [y_k], [want], SYNTH_TOL)
            say("synth", spec=label, against=against, max_abs_err=f"{err:.3e}",
                eager_cpu_vs_eager=plain_spread,
                max_abs_y=f"{float(want.abs().max()):.3e}", tol=SYNTH_TOL,
                summary=repr(report.summary()))
    phase_done("synth")

    # -- 16. bit_path: the fixed-point path and its tools ------------------------
    bit_launches = bit_path(dev, card)
    for cell in ("lstm", "gru"):
        codegen_launches[cell] += bit_launches.get(cell, 0)
    phase_done("bit_path")

    # -- 8. where the time goes: the use_pallas step() run under the profiler ---
    from torch.profiler import ProfilerActivity, profile

    def profiled_step_run(mcfg, mparams, counter, want_tokens, **serve_kw):
        """The ``step()`` serve run once more under torch.profiler: device
        busy time and idle share over the run's wall, and the top kernels.
        Only the device is traced: the host's operator events are not read,
        and sorting them took most of the phase on a full-width model."""
        with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
            tok_prof, _, prof_wall_ms = serve(mcfg, mparams, "step(profiled)", False,
                                              counter, **serve_kw)
        require(tok_prof == want_tokens, f"{mcfg.name}: the profiled step() run's tokens differ")
        kernels = sorted((e for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and e.self_device_time_total > 0),
                         key=lambda e: -e.self_device_time_total)
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        say("profile", arch=mcfg.name, driver="step", wall_ms=f"{prof_wall_ms:.1f}",
            device_busy_ms=f"{busy_ms:.1f}" if kernels else "not_measured",
            device_idle_share=f"{1 - busy_ms / prof_wall_ms:.3f}" if kernels else "not_measured",
            card=repr(card))
        for e in kernels[:8]:
            say("profile_top", arch=mcfg.name, kernel=repr(e.key[:70]), calls=e.count,
                device_ms=f"{e.self_device_time_total / 1e3:.2f}",
                share=f"{e.self_device_time_total / 1e3 / busy_ms:.3f}")

    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    profiled_step_run(cfg, params, lstm_ops.lstm_seq, tok_step)
    phase_done("profile")

    # -- 15a. serve_loadgen: full-width paper-lstm (use_pallas) ------------------
    lg_lstm_launches = serve_loadgen_lstm(cfg, params, prompts, dev, card)
    del params
    torch.cuda.empty_cache()
    phase_done("serve_loadgen_paper_lstm")

    # -- 9. ssm_scan vs plain -------------------------------------------------
    def scan_inputs(Bsz, T, Dm, N, carry=False, dtype=torch.float32):
        """Selective-scan inputs as a Mamba-1 layer makes them: Δ in
        (0.001, 0.8), A = -(1..N) per channel (the A_log init)."""
        x = torch.randn((Bsz, T, Dm), generator=gen, device=dev)
        dl = 0.001 + 0.799 * torch.rand((Bsz, T, Dm), generator=gen, device=dev)
        A = -torch.arange(1, N + 1, dtype=torch.float32, device=dev).expand(Dm, N).contiguous()
        Bm = torch.randn((Bsz, T, N), generator=gen, device=dev)
        Cm = torch.randn((Bsz, T, N), generator=gen, device=dev)
        h0 = torch.randn((Bsz, Dm, N), generator=gen, device=dev) if carry else None
        return x.to(dtype), dl.to(dtype), A, Bm.to(dtype), Cm.to(dtype), h0

    DI, NS = 8192, 16          # falcon-mamba-7b's d_inner and ssm_state
    scan_err = 0.0
    with torch.no_grad():
        for label, Bsz, T, Dm, N, carry, dtype in (
                ("B1_T256_D8192_N16", 1, 256, DI, NS, False, torch.float32),
                ("B4_T64_D8192_N16", 4, 64, DI, NS, False, torch.float32),
                ("B3_T97_D1000_N16", 3, 97, 1000, NS, False, torch.float32),
                ("B8_T1_D8192_N16_carry", 8, 1, DI, NS, True, torch.float32),
                ("B2_T64_D8192_N16_bf16", 2, 64, DI, NS, False, torch.bfloat16),
                ("B4_T64_D8192_N16_carry", 4, 64, DI, NS, True, torch.float32)):
            x, dl, A, Bm, Cm, h0 = scan_inputs(Bsz, T, Dm, N, carry, dtype)
            y, h = scan_ops.ssm_scan(x, dl, A, Bm, Cm, h0=h0)
            torch.cuda.synchronize()
            y_p, h_p = scan_ops.ssm_scan_ref(x, dl, A, Bm, Cm, h0)
            require(y.dtype == dtype and h.dtype == torch.float32,
                    f"ssm_scan {label}: y {y.dtype}, h {h.dtype}")
            e_y = check_close(f"ssm_scan {label} y", [y.float()], [y_p],
                              BF16_TOL if dtype == torch.bfloat16 else TOL)
            e_h = check_close(f"ssm_scan {label} h", [h], [h_p], TOL)
            if dtype == torch.float32:
                scan_err = max(scan_err, e_y, e_h)
            say("kernel_vs_plain", kernel="ssm_scan", case=label,
                max_abs_err_y_h=f"{e_y:.3e},{e_h:.3e}",
                tol=BF16_TOL if dtype == torch.bfloat16 else TOL, ok=True)
        # a scan resumed from h_final at any step gives the one-shot bits
        x, dl, A, Bm, Cm, _ = scan_inputs(1, 256, DI, NS)
        y_full, h_full = scan_ops.ssm_scan(x, dl, A, Bm, Cm)
        k = 100
        y1, h_mid = scan_ops.ssm_scan(x[:, :k], dl[:, :k], A, Bm[:, :k], Cm[:, :k])
        y2, h_end = scan_ops.ssm_scan(x[:, k:], dl[:, k:], A, Bm[:, k:], Cm[:, k:], h0=h_mid)
        require(torch.equal(torch.cat([y1, y2], 1), y_full) and torch.equal(h_end, h_full),
                "ssm_scan: a scan resumed at step 100 differs from the one-shot scan")
        say("kernel_vs_plain", kernel="ssm_scan", case="resume_at_100_bit_identical", ok=True)
        # timing at the main path's shapes: one layer of a 256-token prefill,
        # and of the chunked prefill's 64-token chunk
        scan_ms = time_ms(lambda: scan_ops.ssm_scan(x, dl, A, Bm, Cm), l2)
        scan_calls = launches_per_call(lambda: scan_ops.ssm_scan(x, dl, A, Bm, Cm))
        scan_plain_ms = time_ms(lambda: scan_ops.ssm_scan_ref(x, dl, A, Bm, Cm), l2, reps=5)
        x, dl, A, Bm, Cm, _ = scan_inputs(1, CHUNK, DI, NS)
        scan_ms_64 = time_ms(lambda: scan_ops.ssm_scan(x, dl, A, Bm, Cm), l2)
        scan_calls_64 = launches_per_call(lambda: scan_ops.ssm_scan(x, dl, A, Bm, Cm))
        scan_plain_ms_64 = time_ms(lambda: scan_ops.ssm_scan_ref(x, dl, A, Bm, Cm), l2, reps=5)
    require(scan_calls == scan_calls_64 == 1,
            f"ssm_scan: {scan_calls} and {scan_calls_64} launches a call, expected 1")
    scan_bound, scan_bound_by = scan_bound_ms(1, 256, DI, NS)
    scan_bound_64, scan_bound_by_64 = scan_bound_ms(1, CHUNK, DI, NS)
    say("kernel_time", kernel="ssm_scan", B=1, T=256, D=DI, N=NS, ms=f"{scan_ms:.4f}",
        plain_ms=f"{scan_plain_ms:.4f}", library_ms="none", bound_ms=f"{scan_bound:.4f}",
        bound_by=scan_bound_by, bound_share=f"{scan_bound / scan_ms:.3f}",
        launches_per_call=scan_calls, reps=REPS, card=repr(card))
    say("kernel_time", kernel="ssm_scan", B=1, T=CHUNK, D=DI, N=NS, ms=f"{scan_ms_64:.4f}",
        plain_ms=f"{scan_plain_ms_64:.4f}", library_ms="none", bound_ms=f"{scan_bound_64:.4f}",
        bound_by=scan_bound_by_64, bound_share=f"{scan_bound_64 / scan_ms_64:.3f}",
        launches_per_call=scan_calls_64, reps=REPS, card=repr(card))
    phase_done("ssm_scan")

    # -- 10. int8_matmul vs plain ---------------------------------------------
    def int8_inputs(M, K, N):
        a = torch.randint(-127, 128, (M, K), generator=gen, device=dev, dtype=torch.int8)
        b = torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
        a_s = 0.01 + 0.09 * torch.rand((M, 1), generator=gen, device=dev)
        b_s = 0.01 + 0.09 * torch.rand((1, N), generator=gen, device=dev)
        return a, b, a_s, b_s

    with torch.no_grad():
        for M, K, N in ((256, 4096, 8192), (1, 4096, 8192), (33, 100, 77), (3, 5, 7)):
            args = int8_inputs(M, K, N)
            got = i8_ops.int8_matmul(*args)
            torch.cuda.synchronize()
            want = i8_ops.int8_matmul_ref(*args)
            require(got.shape == (M, N) and bool(torch.isfinite(got).all()),
                    f"int8_matmul {M}x{K}x{N}: shape {tuple(got.shape)} or non-finite")
            require(torch.equal(got, want), f"int8_matmul {M}x{K}x{N}: not bit-exact, max "
                    f"difference {float((got - want).abs().max()):.3e}")
            say("kernel_vs_plain", kernel="int8_matmul", M=M, K=K, N=N, bit_exact=True, ok=True)
        # timing at a falcon-mamba prefill's x projection (u @ w_x, 256 tokens)
        M, K, N = 256, 4096, 8192
        args = int8_inputs(M, K, N)
        i8_ms = time_ms(lambda: i8_ops.int8_matmul(*args), l2)
        i8_calls = launches_per_call(lambda: i8_ops.int8_matmul(*args))
        i8_plain_ms = time_ms(lambda: i8_ops.int8_matmul_ref(*args), l2)
        a, b, a_s, b_s = args
        i8_lib = lambda: torch._int_mm(a, b).to(torch.float32) * a_s * b_s   # yardstick only
        lib_exact = torch.equal(i8_lib(), i8_ops.int8_matmul(*args))
        i8_lib_ms = time_ms(i8_lib, l2)
    i8_bound, i8_bound_by = int8_bound_ms(M, K, N)
    say("kernel_time", kernel="int8_matmul", M=M, K=K, N=N, ms=f"{i8_ms:.4f}",
        plain_ms=f"{i8_plain_ms:.4f}", library_ms=f"{i8_lib_ms:.4f}",
        library="torch._int_mm(cuBLASLt)+scales", library_bit_exact=lib_exact,
        bound_ms=f"{i8_bound:.4f}", bound_by=i8_bound_by, reps=REPS, card=repr(card))
    phase_done("int8_matmul")

    # -- 11. flash_attention vs plain ------------------------------------------
    attn_cases = [   # tests/test_kernels.py's five, then S != T, S = T = 1, rows
                     # that see no key, hd 128 with gemma3's 1024 window
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

    def attn_inputs(c, dtype=torch.float32):
        q = torch.randn((c["B"], c["S"], c["H"], c["hd"]), generator=gen, device=dev)
        k = torch.randn((c["B"], c["T"], c["KV"], c["hd"]), generator=gen, device=dev)
        v = torch.randn((c["B"], c["T"], c["KV"], c["hd"]), generator=gen, device=dev)
        return q.to(dtype), k.to(dtype), v.to(dtype)

    def fa_launches(mcfg, S: int) -> int:
        """CUDA launches of one layer's flash_attention in a one-shot prefill
        of S tokens: 2 where the host splits the key axis, else 1."""
        q = torch.empty((1, S, mcfg.n_heads, mcfg.head_dim), device=dev)
        k = torch.empty((1, S, mcfg.n_kv_heads, mcfg.head_dim), device=dev)
        return fa_kernel.launches_per_call(fa_kernel.splits(q, k, causal=mcfg.causal))

    attn_err = 0.0
    with torch.no_grad():
        for c in attn_cases:
            kw = {n: c[n] for n in ("causal", "window", "softcap")}
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = attn_inputs(c, dtype)
                got = fa_ops.flash_attention(q, k, v, **kw)
                torch.cuda.synchronize()
                want = fa_ops.flash_attention_ref(q, k, v, **kw)
                require(got.dtype == dtype, f"flash_attention: output {got.dtype}, input {dtype}")
                tol = ATTN_TOL if dtype == torch.float32 else ATTN_BF16_TOL
                label = "S{S}_T{T}_B{B}_H{H}_KV{KV}_hd{hd}_causal{causal}_w{window}_cap{softcap}"
                e = check_close(f"flash_attention {label.format(**c)} {dtype}",
                                [got.float()], [want.float()], tol)
                if dtype == torch.float32:
                    attn_err = max(attn_err, e)
                say("kernel_vs_plain", kernel="flash_attention", case=label.format(**c),
                    dtype=str(dtype).removeprefix("torch."), max_abs_err=f"{e:.3e}", tol=tol,
                    ok=True)
        # times at (a') and (a) one smollm-135m layer of a 64- and a 256-token
        # prompt, (b) one phi4-mini-3.8b layer of 2048 tokens, (c) gemma3's
        # local-layer shape
        attn_time = {}
        for name, c in (("a1_smollm_S64", dict(B=1, S=64, T=64, H=9, KV=3, hd=64, window=0)),
                        ("a_smollm_S256", dict(B=1, S=256, T=256, H=9, KV=3, hd=64, window=0)),
                        ("b_phi4_S2048", dict(B=1, S=2048, T=2048, H=24, KV=8, hd=128, window=0)),
                        ("c_gemma3_local_S2048_w1024",
                         dict(B=1, S=2048, T=2048, H=32, KV=16, hd=128, window=1024))):
            q, k, v = attn_inputs(c)
            w = c["window"]
            shape_err = check_close(f"flash_attention {name}",
                                    [fa_ops.flash_attention(q, k, v, window=w)],
                                    [fa_ops.flash_attention_ref(q, k, v, window=w)], ATTN_TOL)
            attn_err = max(attn_err, shape_err)
            k_ms = time_ms(lambda: fa_ops.flash_attention(q, k, v, window=w), l2)
            calls = launches_per_call(lambda: fa_ops.flash_attention(q, k, v, window=w))
            n_splits = fa_kernel.splits(q, k, window=w)
            counted = fa_ops.flash_attention.launches
            fa_ops.flash_attention(q, k, v, window=w)
            counted = fa_ops.flash_attention.launches - counted
            require(calls == fa_kernel.launches_per_call(n_splits) == counted,
                    f"flash_attention {name}: {calls} launches a call with {n_splits} key "
                    f"shares, {counted} counted by the wrapper")
            if name == "a_smollm_S256":
                fa_calls = calls
            p_ms = time_ms(lambda: fa_ops.flash_attention_ref(q, k, v, window=w), l2)
            # the library call, a yardstick only: SDPA on the same fp32 tensors
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            qpos = torch.arange(c["S"], device=dev)[:, None]
            kpos = torch.arange(c["T"], device=dev)[None, :]
            win_mask = (kpos <= qpos) & (kpos > qpos - w)
            sdpa = (lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True)) if w == 0 else \
                   (lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=win_mask, enable_gqa=True))
            lib_diff = float((sdpa().transpose(1, 2) - fa_ops.flash_attention(q, k, v, window=w))
                             .abs().max())
            l_ms = time_ms(sdpa, l2)
            bnd, by, fma_bnd = attn_bound_ms(c["B"], c["S"], c["T"], c["H"], c["KV"], c["hd"],
                                             True, w)
            attn_time[name] = (k_ms, p_ms, l_ms, bnd, by, fma_bnd, n_splits, shape_err)
            say("kernel_time", kernel="flash_attention", shape=name,
                **{n: c[n] for n in ("B", "S", "T", "H", "KV", "hd")}, causal=True, window=w,
                max_abs_err=f"{shape_err:.3e}", tol=ATTN_TOL,
                ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}", library_ms=f"{l_ms:.4f}",
                library="F.scaled_dot_product_attention(enable_gqa)",
                library_max_abs_diff=f"{lib_diff:.3e}", bound_ms=f"{bnd:.4f}", bound_by=by,
                bound_share=f"{bnd / k_ms:.3f}", fma_bound_ms=f"{fma_bnd:.4f}",
                fma_bound_share=f"{fma_bnd / k_ms:.3f}", q_tile=fa_kernel.Q_TILE,
                key_splits=n_splits, launches_per_call=calls,
                reps=REPS, card=repr(card))
            del q, k, v, qt, kt, vt, win_mask
        # the fp32 bar at long prompts: a block sums up to T keys, and the
        # error must not grow with them
        attn_err_by_keys = {}
        for S, H, KV in ((512, 8, 4), (1024, 8, 4), (2048, 8, 4), (4096, 8, 4), (8192, 4, 2)):
            c = dict(B=1, S=S, T=S, H=H, KV=KV, hd=128)
            q, k, v = attn_inputs(c)
            e = check_close(f"flash_attention S=T={S} hd 128", [fa_ops.flash_attention(q, k, v)],
                            [fa_ops.flash_attention_ref(q, k, v)], ATTN_TOL)
            attn_err = max(attn_err, e)
            attn_err_by_keys[S] = e
            say("kernel_vs_plain", kernel="flash_attention", case=f"S{S}_T{S}_H{H}_KV{KV}_hd128",
                key_splits=fa_kernel.splits(q, k), dtype="float32", max_abs_err=f"{e:.3e}",
                tol=ATTN_TOL, ok=True)
            del q, k, v
    phase_done("flash_attention")

    # -- 12. serve full-width falcon-mamba-7b (use_pallas) -----------------------
    mcfg = dataclasses.replace(get_config("falcon-mamba-7b"), use_pallas=True)
    torch.cuda.reset_peak_memory_stats()
    base_alloc = torch.cuda.memory_allocated()     # what earlier phases still hold
    t0 = time.perf_counter()
    mparams = lm.init_params(mcfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    m_params = lm.param_count(mparams)
    peak_init = torch.cuda.max_memory_allocated()
    require((mcfg.n_layers, mcfg.d_model, mcfg.d_inner) == (64, 4096, 8192),
            f"falcon-mamba-7b is not at its published widths: {mcfg}")
    say("serve_setup", arch=mcfg.name, n_layers=mcfg.n_layers, d_model=mcfg.d_model,
        d_inner=mcfg.d_inner, ssm_state=mcfg.ssm_state, dt_rank=mcfg.dt_rank_actual,
        vocab=mcfg.vocab, params=m_params, param_gb=f"{4 * m_params / 1e9:.2f}",
        init_s=f"{init_s:.1f}", alloc_gb_before_init=f"{base_alloc / 1e9:.2f}",
        peak_alloc_gb_after_init=f"{peak_init / 1e9:.2f}",
        requests=N_REQUESTS, max_new_tokens=MAX_NEW, num_slots=NUM_SLOTS, max_seq=MAX_SEQ)
    with torch.no_grad():
        lm.prefill(mparams, mcfg, toks)      # untimed: first use of each GEMM shape
        torch.cuda.synchronize()
        mtok_step, k1, _ = serve(mcfg, mparams, "step", False, scan_ops.ssm_scan)
        mtok_block, k2, _ = serve(mcfg, mparams, "step_block", True, scan_ops.ssm_scan)
        mtok_chunk, k3, _ = serve(mcfg, mparams, f"step+prefill_chunk={CHUNK}", False,
                                  scan_ops.ssm_scan, prefill_chunk=CHUNK)
        require(mtok_step == mtok_block, f"{mcfg.name}: step() and step_block() tokens differ")
        require(mtok_step == mtok_chunk, f"{mcfg.name}: one-shot and chunked prefill tokens differ")
        logits, prefill_ms = {}, {}
        for path, pcfg in (("use_pallas", mcfg),
                           ("plain", dataclasses.replace(mcfg, use_pallas=False))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits[path], mcaches = lm.prefill(mparams, pcfg, toks)
            torch.cuda.synchronize()
            prefill_ms[path] = (time.perf_counter() - t0) * 1e3
            require(logits[path].shape == (1, mcfg.vocab)
                    and bool(torch.isfinite(logits[path]).all()),
                    f"{mcfg.name} {path} prefill logits of shape "
                    f"{tuple(logits[path].shape)} or non-finite")
        blk = mcaches["groups"]["b0_mamba1"]
        require(tuple(blk["h"].shape) == (64, 1, mcfg.d_inner, mcfg.ssm_state)
                and tuple(blk["conv"].shape) == (64, 1, mcfg.d_conv - 1, mcfg.d_inner),
                f"{mcfg.name}: prefill cache has the wrong layout")
        scale = float(logits["plain"].abs().max())
        m_diff = float((logits["use_pallas"] - logits["plain"]).abs().max())
        require(m_diff <= MAMBA_LOGITS_RTOL * scale,
                f"{mcfg.name} use_pallas prefill logits differ from the plain path by "
                f"{m_diff:.3e} (max |logit| {scale:.3e})")
    say("serve_check", arch=mcfg.name, path="use_pallas", identical_tokens=True,
        prompt_len=toks.shape[1], prefill_logits_max_abs_diff=f"{m_diff:.3e}",
        max_abs_logit=f"{scale:.3e}", rtol_of_max=MAMBA_LOGITS_RTOL,
        **{f"prefill_ms_{k}": f"{v:.2f}" for k, v in prefill_ms.items()},
        peak_alloc_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    phase_done("serve_mamba")

    profiled_step_run(mcfg, mparams, scan_ops.ssm_scan, mtok_step)
    del mcaches
    torch.cuda.empty_cache()
    phase_done("profile_mamba")

    # -- 15b. serve_loadgen: full-width falcon-mamba-7b, on phase 12's weights --
    lg_mamba_launches = serve_loadgen_mamba(mcfg, mparams, dev, card)
    del mparams
    torch.cuda.empty_cache()
    phase_done("serve_loadgen_falcon_mamba")

    # -- 13. serve full-width smollm-135m (use_pallas) ---------------------------
    scfg = dataclasses.replace(get_config("smollm-135m"), use_pallas=True)
    require((scfg.n_layers, scfg.d_model, scfg.n_heads, scfg.n_kv_heads, scfg.head_dim,
             scfg.d_ff, scfg.vocab) == (30, 576, 9, 3, 64, 1536, 49_152),
            f"smollm-135m is not at its published widths: {scfg}")
    torch.cuda.reset_peak_memory_stats()
    sparams = lm.init_params(scfg, torch.Generator(device=dev).manual_seed(0))
    s_params = lm.param_count(sparams)
    kv_bytes = 4 * 2 * scfg.n_layers * NUM_SLOTS * MAX_SEQ * scfg.n_kv_heads * scfg.head_dim
    say("serve_setup", arch=scfg.name, n_layers=scfg.n_layers, d_model=scfg.d_model,
        heads=f"{scfg.n_heads}/{scfg.n_kv_heads}", head_dim=scfg.head_dim, d_ff=scfg.d_ff,
        vocab=scfg.vocab, params=s_params, param_gb=f"{4 * s_params / 1e9:.3f}",
        kv_cache_mb=f"{kv_bytes / 1e6:.1f}",
        requests=N_REQUESTS, max_new_tokens=MAX_NEW, num_slots=NUM_SLOTS, max_seq=MAX_SEQ)
    with torch.no_grad():
        lm.prefill(sparams, scfg, toks)      # untimed: first use of each GEMM shape
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        per_prefill = lambda n: fa_launches(scfg, n)
        stok_step, f1, _ = serve(scfg, sparams, "step", False, fa_ops.flash_attention,
                                 launches_per_prefill=per_prefill)
        c1 = fa_ops.flash_attention.calls
        stok_block, f2, _ = serve(scfg, sparams, "step_block", True, fa_ops.flash_attention,
                                  launches_per_prefill=per_prefill)
        c2 = fa_ops.flash_attention.calls
        stok_chunk, f3, _ = serve(scfg, sparams, f"step+prefill_chunk={CHUNK}", False,
                                  fa_ops.flash_attention, chunks_launch=False,
                                  launches_per_prefill=per_prefill, prefill_chunk=CHUNK)
        c3 = fa_ops.flash_attention.calls
        serve_peak = torch.cuda.max_memory_allocated()
        require(stok_step == stok_block, f"{scfg.name}: step() and step_block() tokens differ")
        require(stok_step == stok_chunk, f"{scfg.name}: one-shot and chunked prefill tokens differ")

        def dense_prefill_check(mcfg, mparams):
            """One 256-token prefill through the kernel and on the plain path:
            times, calls and launches, and the logits gap relative to max
            |logit|."""
            logits, ms = {}, {}
            for path, pcfg in (("use_pallas", mcfg),
                               ("plain", dataclasses.replace(mcfg, use_pallas=False))):
                lm.prefill(mparams, pcfg, toks)
                torch.cuda.synchronize()
                fa_ops.flash_attention.calls = fa_ops.flash_attention.launches = 0
                t0 = time.perf_counter()
                logits[path], caches = lm.prefill(mparams, pcfg, toks)
                torch.cuda.synchronize()
                ms[path] = (time.perf_counter() - t0) * 1e3
                if path == "use_pallas":
                    n_call = fa_ops.flash_attention.calls
                    n_launch = fa_ops.flash_attention.launches
                require(logits[path].shape == (1, mcfg.vocab)
                        and bool(torch.isfinite(logits[path]).all()),
                        f"{mcfg.name} {path} prefill logits of shape "
                        f"{tuple(logits[path].shape)} or non-finite")
            want_launch = mcfg.n_layers * fa_launches(mcfg, toks.shape[1])
            require(n_call == mcfg.n_layers and n_launch == want_launch,
                    f"{mcfg.name}: {n_call} flash_attention calls and {n_launch} CUDA "
                    f"launches in a {mcfg.n_layers}-layer prefill, not "
                    f"{mcfg.n_layers} and {want_launch}")
            kv = caches["groups"]["b0_attn"]["k"]
            require(tuple(kv.shape) == (mcfg.n_layers, 1, toks.shape[1], mcfg.n_kv_heads,
                                        mcfg.head_dim),
                    f"{mcfg.name}: prefill KV cache of shape {tuple(kv.shape)}")
            scale = float(logits["plain"].abs().max())
            diff = float((logits["use_pallas"] - logits["plain"]).abs().max())
            require(diff <= DENSE_LOGITS_RTOL * scale,
                    f"{mcfg.name} use_pallas prefill logits differ from the plain path by "
                    f"{diff:.3e} (max |logit| {scale:.3e})")
            return n_call, n_launch, diff, scale, ms

        _, _, s_diff, s_scale, s_ms = dense_prefill_check(scfg, sparams)
    say("serve_check", arch=scfg.name, path="use_pallas", identical_tokens=True,
        flash_attention_calls=f"{c1}+{c2}+{c3}", flash_attention_launches=f"{f1}+{f2}+{f3}",
        prompt_len=toks.shape[1],
        prefill_logits_max_abs_diff=f"{s_diff:.3e}", max_abs_logit=f"{s_scale:.3e}",
        rel_gap=f"{s_diff / s_scale:.3e}", rtol_of_max=DENSE_LOGITS_RTOL,
        **{f"prefill_ms_{k}": f"{v:.2f}" for k, v in s_ms.items()},
        peak_alloc_gb_serving=f"{serve_peak / 1e9:.3f}", card=repr(card))
    phase_done("serve_smollm")

    profiled_step_run(scfg, sparams, fa_ops.flash_attention, stok_step,
                      launches_per_prefill=per_prefill)
    phase_done("profile_smollm")

    # -- 15c. serve_loadgen: full-width smollm-135m, one-shot prefills ----------
    lg_smollm_calls, lg_smollm_launches = serve_loadgen_smollm(scfg, sparams, dev, card)
    del sparams
    torch.cuda.empty_cache()
    phase_done("serve_loadgen_smollm")

    # -- 14. one full-width phi4-mini-3.8b prefill (use_pallas) -------------------
    pcfg = dataclasses.replace(get_config("phi4-mini-3.8b"), use_pallas=True)
    require((pcfg.n_layers, pcfg.d_model, pcfg.n_heads, pcfg.n_kv_heads, pcfg.head_dim,
             pcfg.d_ff, pcfg.vocab, pcfg.partial_rotary)
            == (32, 3072, 24, 8, 128, 8192, 200_064, 0.75),
            f"phi4-mini-3.8b is not at its published widths: {pcfg}")
    torch.cuda.reset_peak_memory_stats()
    base_alloc = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    pparams = lm.init_params(pcfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    p_params = lm.param_count(pparams)
    peak_init = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        p_call, p_launch, p_diff, p_scale, p_ms = dense_prefill_check(pcfg, pparams)
    say("prefill_check", arch=pcfg.name, path="use_pallas", params=p_params,
        param_gb=f"{4 * p_params / 1e9:.2f}", init_s=f"{init_s:.1f}",
        alloc_gb_before_init=f"{base_alloc / 1e9:.2f}",
        peak_alloc_gb_after_init=f"{peak_init / 1e9:.2f}", prompt_len=toks.shape[1],
        flash_attention_calls=p_call, flash_attention_launches=p_launch,
        prefill_logits_max_abs_diff=f"{p_diff:.3e}",
        max_abs_logit=f"{p_scale:.3e}", rel_gap=f"{p_diff / p_scale:.3e}",
        rtol_of_max=DENSE_LOGITS_RTOL, **{f"prefill_ms_{k}": f"{v:.2f}" for k, v in p_ms.items()},
        peak_alloc_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", card=repr(card))
    del pparams
    torch.cuda.empty_cache()
    phase_done("prefill_phi4")

    # -- 15d. the entry points as subprocesses on the card ----------------------
    serve_loadgen_entry_points(card)
    phase_done("serve_loadgen_entry_points")

    # -- 17. the Fig. 10 loop, the chaos suite and the lints ----------------------
    tc = tune_chaos(dev, card)
    codegen_launches["lstm"] += sum(n for label, n in tc["tune"].items() if "lstm" in label)
    phase_done("tune_chaos")

    summary = {"kernels": [{
        "name": "lstm_seq",
        "route": "cuda",
        "source": "src/repro_torch/kernels/lstm_cell/csrc/lstm_seq.cu",
        "replaces": "src/repro/kernels/lstm_cell/kernel.py:87",
        "launches": n1 + n2 + n3 + lg_lstm_launches + tc["paper-lstm"],
        "max_abs_err": lstm_err,
        "ms": lstm_ms,
        "plain_ms": lstm_plain_ms,
        "bound_ms": lstm_bound,
        "bound_by": lstm_bound_by,
        "library_ms": lstm_lib_ms,
        "launches_per_call": lstm_calls,
        "weights_resident": lstm_cfg["weights_resident"],
        "us_per_step": 1e3 * lstm_ms / 256,
        "over_library": lstm_ms / lstm_lib_ms,
        "serial_floor_ms": lstm_floor_ms,
        "fixed_ms": lstm_fixed_ms,
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
        "launches_per_call": codegen_time[cell][5],
        "weights_resident": codegen_time[cell][6],
        "us_per_step": 1e3 * codegen_time[cell][0] / 256,
        "over_library": codegen_time[cell][0] / codegen_time[cell][2],
        "serial_floor_ms": codegen_time[cell][7],
        "fixed_ms": codegen_time[cell][8],
        # phase 16's launches by cell (its lstm and gru ones are in "launches")
        "bit_path_launches_by_cell": bit_launches,
        # phase 17's by tuned cell (its lstm ones are in the lstm row's "launches")
        "tune_launches_by_cell": tc["tune"],
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
        "launches_per_call": lut_calls,
        "weights_resident": None,
        "us_per_step": None,
        "over_library": None,
    }, {
        "name": "ssm_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:81",
        "launches": k1 + k2 + k3 + lg_mamba_launches,
        "max_abs_err": scan_err,
        "ms": scan_ms,
        "plain_ms": scan_plain_ms,
        "bound_ms": scan_bound,
        "bound_by": scan_bound_by,
        "library_ms": None,
        "launches_per_call": scan_calls,
        "weights_resident": None,
        "us_per_step": 1e3 * scan_ms / 256,
        "over_library": None,
        "ms_T64": scan_ms_64,
        "bound_ms_T64": scan_bound_64,
    }, {
        "name": "int8_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/int8_matmul/csrc/int8_matmul.cu",
        "replaces": "src/repro/kernels/int8_matmul/kernel.py:47",
        "launches": 0,     # no path of the port (or of the reference) calls it
        "note": "standalone op: no path of the port or the reference calls it",
        "max_abs_err": 0.0,
        "ms": i8_ms,
        "plain_ms": i8_plain_ms,
        "bound_ms": i8_bound,
        "bound_by": i8_bound_by,
        "library_ms": i8_lib_ms,
        "launches_per_call": i8_calls,
        "weights_resident": None,
        "us_per_step": None,
        "over_library": i8_ms / i8_lib_ms,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:83",
        # smollm-135m's three serve runs (30 per one-shot prefill, 0 for
        # chunks), its loadgen run (30 per miss), phi4-mini-3.8b's prefill
        # (32) and the chaos suite (30 per one-shot prefill); times at shape (a)
        "launches": f1 + f2 + f3 + lg_smollm_launches + p_launch + tc["smollm-135m"],
        "calls": c1 + c2 + c3 + lg_smollm_calls + p_call + tc["smollm-135m_calls"],
        "max_abs_err": attn_err,
        "ms": attn_time["a_smollm_S256"][0],
        "plain_ms": attn_time["a_smollm_S256"][1],
        "bound_ms": attn_time["a_smollm_S256"][3],
        "bound_by": attn_time["a_smollm_S256"][4],
        "library_ms": attn_time["a_smollm_S256"][2],
        "launches_per_call": fa_calls,
        "weights_resident": None,
        "us_per_step": None,
        "over_library": attn_time["a_smollm_S256"][0] / attn_time["a_smollm_S256"][2],
        "fma_bound_ms": attn_time["a_smollm_S256"][5],
        "q_tile": fa_kernel.Q_TILE,
        "key_splits": attn_time["a_smollm_S256"][6],
        "ms_by_shape": {n: t[0] for n, t in attn_time.items()},
        "max_abs_err_by_shape": {n: t[7] for n, t in attn_time.items()},
        "max_abs_err_by_keys": attn_err_by_keys,
        "bound_ms_by_shape": {n: t[3] for n, t in attn_time.items()},
    }]}
    print(json.dumps(summary), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
