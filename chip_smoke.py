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
8. profile — the ``use_pallas`` ``step()`` run once more, on the first four
   requests, under ``torch.profiler``;
9. ``ssm_scan`` against its plain version (a falcon-mamba prefill's shapes,
   ragged D with prime T, T = 1, bf16 inputs, a nonzero carry), a scan
   resumed at step 100 bit-identical to the one-shot scan, and its time at
   T = 256 and at the chunked prefill's T = 64 beside the plain version's
   and its bound, with its launches per call (which must be 1);
10. ``int8_matmul`` bit-exact against its plain version, and its time at a
   falcon-mamba prefill's x projection (M = 256) and at one row (M = 1)
   beside the plain version's, ``torch._int_mm``'s and its bound, with the
   path the library takes (TMA or byte-wise) and its launches per call (no
   path of the port calls it, so its ``launches`` in the summary are 0);
11. ``flash_attention`` against its plain version (the reference's five
   kernel cases in fp32 and bf16, S != T, S = T = 1, rows that see no key,
   hd 128 with a 1024 window), and its time at two ``smollm-135m`` layers
   (64 and 256 tokens), one ``phi4-mini-3.8b`` layer, gemma3's local and
   global layers, one ``internlm2-20b`` layer, one application of
   ``zamba2-1.2b``'s shared block, one ``olmoe-1b-7b`` layer, one
   ``hubert-xlarge`` layer (non-causal, hd 80) and one
   ``llama-3.2-vision-90b`` self-attention layer (GQA 64/8) (2048 tokens
   each), each held to the fp32 bar, beside the plain
   version's, ``F.scaled_dot_product_attention``'s, its bound on the
   tensor cores in 3xTF32 and the fp32-FMA bound (``fma_bound_ms``), with
   its q tile, the key shares the host chose and its launches per call
   (which must be 1, or 2 where the key axis is split, as the wrapper
   counts them); then the fp32 bar at 512 to 8192 keys (hd 128);
12. serve mamba — ``falcon-mamba-7b`` at its published widths, its 64
   layers cut to 16 (2.2 B fp32 parameters from a seed) with ``use_pallas=True`` through ``DecodeServer``
   under ``step()``, ``step_block()`` and chunked prefill: identical tokens,
   ``ssm_scan`` launched once per layer of every prefill call, prefill
   logits held against the plain path; then its ``step()`` run on the first
   four requests under ``torch.profiler``;
13. serve smollm — full-width ``smollm-135m`` (30 layers, 135 M fp32
   parameters from a seed) with ``use_pallas=True`` under the same three
   drivers: identical tokens, ``flash_attention`` called once per layer
   of every one-shot prefill and never by a chunk (chunks attend over the
   cache in plain PyTorch), with one CUDA launch a call or two where the
   prompt's length splits the key axis, a 256-token prefill's logits held
   against the plain path; then its ``step()`` run on the first four
   requests under ``torch.profiler``;
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
   ``falcon-mamba-7b`` at its widths cut to 16 of its 64 layers (in phase
   12, on its loaded weights) chunked without and with a
   256 MiB cache (1 GiB × 16/64) that evicts (``ssm_scan`` launched once a
   layer of every chunk run); ``smollm-135m`` (in phase 13) unchunked with a 256 MB
   cache (``flash_attention`` 30 calls a miss, none in the all-hit second
   pass); then (after phase 20) every entry point the smoke runs as a
   subprocess, all started together: ``python -m
   repro_torch.launch.serve`` and ``python -m repro_torch.obs.report`` on
   the card, and ``python -m repro_torch.obs.check`` on the four documents
   they write; the launchers and CLIs of phases 16, 17, 19, 20 and 21,
   each checked as there.  Each model's
   prefill logits are held against ``use_pallas=False`` at every distinct
   prompt length of the trace, one-shot and/or chunked as its servers
   prefill.

16. bit_path (run after phase 7) — the paper's fixed-point path at the
   published widths of the synthesis cells, ``NetworkSpec(1024, 8, 1024,
   1024, seq_len=256)``: ``rtlsim.simulate`` against
   ``golden.fixed_forward`` word for word (lstm at 18 and 32 bits; gru,
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
   the analysis seconds; ``python -m repro_torch.verify.difftest`` (also
   ``--regen-goldens`` into ``build/bit_path/``) and ``python -m
   repro_torch.analyze`` run as subprocesses with phase 15's entry
   points, each exiting 0.

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
   ``use_pallas``; ``python -m repro_torch.verify.chaos`` as a subprocess
   exiting 0, started before the full-width tune cell, beside its
   host-bound predict pass (``python -m repro_torch.analyze --lint-src``
   runs with phase 15's entry points), and
   ``python -m repro_torch.obs.check`` on every document.

18. serve gemma3 (after phase 14) — ``gemma3-27b`` at its published widths
   (d_model 5376, 32/16 heads at hd 128, d_ff 21 504, vocab 262 144, window
   1024, RoPE 10k/1M, qk-norm, GELU-tanh, tied) cut to 8 layers (one 5:1
   group and the 2-layer local tail), random
   weights from a seed, ``use_pallas``: ten requests (prompts of 17, 512,
   1023, 1024, 1025, 1537 and 2048 tokens, two sharing a 1024-token prefix,
   one of 1000 tokens whose 64 new tokens cross position 1024 on the ring;
   16 new tokens otherwise), 4 slots, ``max_seq`` 2112, under one-shot
   ``step()``, ``step_block()`` and chunked ``step()`` (chunk 256) with a
   12 GiB prefix cache, twice (the second pass all full hits): equal tokens
   across the four runs, the 1025-, 2048- and 1000+64-token requests equal
   to the plain greedy loop on the card, ``flash_attention`` 8 calls a
   one-shot prefill (7 windowed) with its launches, none in a chunk, and
   each distinct prompt's prefill logits held against the plain path; then
   ``internlm2-20b`` at its published widths cut to 4 layers (2.70 B, untied
   head): a 2048-token prefill against the plain path and a ``step()``
   serve of four prompts (17-2048 tokens), each held to the plain loop.

19. serve zamba2 (after phase 18) — ``zamba2-1.2b`` at its published widths,
   its 38 blocks cut to 14 (two groups of five Mamba-2 blocks and one
   application of the shared transformer block, then two Mamba-2
   blocks; d_model 2048, 64 SSD heads of 64, N 64; the shared block 32/32
   heads at hd 64, d_ff 8192 GELU-tanh, LoRA rank 128; vocab 32 000;
   508 374 784 fp32 parameters from a seed, with the LoRA B matrices,
   ``dt_bias``, ``D`` and the conv biases drawn nonzero), ``use_pallas``:
   nine requests (prompts of 17, 131, 512, 1024, 1031, 2048 and 4096
   tokens, two of 1088 sharing a 1024-token prefix; 131 and 1031 run the
   SSD in chunks of 1), 16 new tokens each, 4 slots, ``max_seq`` 4224,
   under one-shot ``step()``, ``step_block()`` and chunked ``step()``
   (chunk 256) with a prefix cache sized to hold every checkpoint, twice
   (the second pass all full hits): equal tokens across the four runs, the
   131-, 1031-, 2048-token and one shared-prefix request equal to the plain
   greedy loop, ``flash_attention`` 2 calls a one-shot prefill and none in
   a chunk, each distinct length's prefill logits within 1e-5 of max
   |logit| of the plain path with its ms, transient memory and SSD chunk;
   adaptive prefill under ``step_block()`` with the cache and chunked
   prefill under ``AsyncServer``, each with ``step()``'s tokens; then
   a device-only profile of ``step()`` on the first four requests
   (``python -m repro_torch.launch.serve --arch zamba2-1.2b`` runs with
   phase 15's entry points).

20. serve MoE (after phase 19) — ``olmoe-1b-7b`` uncut (16 layers of MHA
   16/16 at hd 128 with qk-norm and 64 experts of 1024, top-8; 6.92 B fp32
   parameters from a seed) and
   ``deepseek-v2-lite-16b`` at its published widths, 27 layers cut to 9
   (MLA, r 512 + dr 64, and 2 shared + 64 routed experts of 1408, top-6;
   5.68 B), ``use_pallas``, 16 new tokens a request, 4 slots, ``max_seq``
   2112: prompts of 17, 131, 512, 1024, 2048 (and on olmoe 2050, whose
   MoE groups are 2 tokens: the reference's group rule's cliff) tokens and
   two of 1088 sharing a 1024-token prefix, under one-shot ``step()`` and
   ``step_block()`` (equal tokens), chunked ``step()`` (chunk 256) without
   the prefix cache and twice with one sized by ``checkpoint_bytes``
   (equal tokens across the three, the second pass all full hits; their
   agreement with the one-shot tokens is printed: chunk-local groups drop
   other tokens); the 2048-token and one shared-prefix request against the
   plain greedy loop; every distinct length's prefill against the plain
   path with the routing decisions of both recorded: the flips counted,
   the logits within 1e-5 of max |logit| where none differ, else every
   flip of the first flipping layer a near-tie (margin below 1e-6);
   ``flash_attention`` 16 calls a one-shot olmoe prefill and none on
   deepseek (MLA has no kernel) (``launch.serve --arch olmoe-1b-7b`` runs
   with phase 15's entry points).  Then olmoe's weights in int8 (``quantize_lm_params`` on the
   card, three leaves bit-identical to the host CPU's, the router fp32):
   the fp32 tree freed, the dequantized model's 2048-token logits against
   fp32 with its own routing and with the fp32 routing pinned (SNR and
   greedy agreement printed beside the reference's bars, 20 dB and 0.8,
   which the reference's quantization misses on this model), its prefill
   through the kernel against the plain path, and the traffic under
   ``step()`` and ``step_block()`` with equal tokens; the bars are held on
   ``smollm-135m`` at full width quantized on the card (a dense model,
   where the reference's own test holds them).  Then deepseek: one MLA layer's absorbed decode against the
   naive prefill at full width (1e-5 of max |out|) and the same drivers
   and checks as olmoe.  Each run's seconds, the peak allocation and the
   card are printed.

21. train (after phase 17) — ``smollm-135m`` at its published widths and
   depth (134 515 008 fp32 parameters from a seed, ``remat``) through
   ``Trainer`` on ``DataConfig(vocab=49152, seq_len=4096, global_batch=8)``
   (train_4k's sequence length, two microbatches of 4), 3 steps: each
   step's loss, ms, tokens/s, ``grad_norm`` and learning rate, and the
   phase's peak allocation beside the prediction; the restart drill at
   ``seq_len`` 1024 (an uninterrupted 4-step run with async checkpoints
   every 2 steps against a run failing at step 3 and a new ``Trainer``
   resuming to step 4: the final parameters and optimizer state within
   1e-6, bit-identity printed, and if not, the gradient leaves whose
   backward is not deterministic); one ``train_loss`` and its gradients on
   the card against the host's CPU on the trained parameters at B = 1, S =
   256 (loss within 1e-5, each gradient leaf within 1e-4 of its max |g|);
   ``paper-lstm`` at full width (108 307 456 parameters): 2 steps at T =
   256, B = 8, and the same check at B = 1, T = 64; ``train_loss`` with
   ``use_pallas=True`` on the card refused by ``flash_attention``'s and
   ``lstm_seq``'s wrappers before a backward is reached (``python -m
   repro_torch.launch.train --arch smollm-135m --steps 2 --seq 256 --batch
   4`` runs with phase 15's entry points); and no kernel launched during
   the phase;
22. mesh — phase 3's full-width ``paper-lstm`` traffic (``use_pallas``)
   under ``ShardPlan(fold_data=True)`` at dp = 8 in this process, under
   both drivers, with phase 3's tokens, every decode call's logits bit for
   bit those of a ``plan=None`` run, and ``lstm_seq`` launched once a layer
   a prefill; then sharded over two ranks spawned on this card (gloo): the
   same tokens, each rank's logits against the ``plan=None`` rows (bit for
   bit, or, where the card's GEMM gives other bits at half the rows, the
   gap printed and held at ``MESH_DP_GAP`` of max |logit|), the same host
   state on both ranks, each rank launching ``lstm_seq`` for its own
   shard's prefills only, decode tok/s beside the ``plan=None`` run;
   ``synthesize(mesh=)``'s eager backend at tp = 2 on a 2 × 1024 lstm at
   T = 256 within 1e-4 of one device (one all-reduce a contraction a step,
   the ``|mesh1x2`` ledger key) and the kernel backend at dp = 2 with
   C-slow streams against its unsharded launch (the same rule, read on
   its readout GEMM, with ``MESH_KERNEL_DP_GAP``); beside them one rank under NCCL (NCCL
   refuses two ranks on one card): the sharded server at dp = 1, logits
   bit for bit, and ``ep_moe_apply`` at olmoe's widths (64 experts, top-8)
   against ``moe_apply(group_size=T_local)``, two all-to-alls a call;
23. mesh_train — ``smollm-135m`` at its published widths and depth through
   ``Trainer`` on the same initial weights three ways: ``mesh=None`` in
   this process, ``mesh=make_local_mesh(2, 1)`` over two gloo ranks sharing
   the card (parameters and AdamW moments stored as each rank's ZeRO/FSDP
   shards) and ``make_local_mesh(1, 1)`` under NCCL at world size 1 (this
   process joins a group of its own, while the gloo ranks run, which then
   run phase 24's dp = 2 work in the same processes); 3 steps of 8 ×
   1024 tokens (train_4k's sequence cut to 1024) in two microbatches: each
   step's ms, tokens/s and peak GB per rank, its loss and grad-norm gaps to
   ``mesh=None`` (held within 1e-5 relative), the largest parameter gap
   after the last step, NCCL dp = 1 bit-identical to ``mesh=None``; the
   dp = 2 checkpoint restored under dp = 1 and under (1, 1, 2), bit for
   bit; the int8 error-feedback all-reduce on the two ranks' full gradient
   trees (every leaf within one int8 step of the exact mean, 30 steps on
   the 49 152 × 576 embedding averaging within 0.2 of it, an int32
   payload); ``pipeline_apply`` over the two ranks at D = 2048, C = 8
   microbatches of 256 rows, within 1e-5 of ``sequential_reference`` with
   C + P − 1 ring transfers; and no kernel launched during the phase;
24. moe_mesh_train — ``olmoe-1b-7b`` at its widths cut to 1 layer through
   ``make_train_step`` on a data mesh (``mesh=None`` before phase 23's
   ranks start, dp = 2 over gloo in phase 23's ranks, dp = 1 under NCCL
   beside them) and the dry run of those cells beside the ranks;
25. encoder and vlm — ``hubert-xlarge`` uncut (945 143 040 parameters):
   a 2048-frame forward with ``use_pallas`` (48 non-causal
   ``flash_attention`` calls) against the plain path at every position
   within 1e-5 of max |logit|, position 0 moved by a change of the last
   frame, one full-width ``make_train_step`` step on 4 × 1024 frame
   embeddings (step ms, tokens/s, peak GB), ``train_loss`` and its
   gradients on the card against the CPU at 4 layers; then
   ``llama-3.2-vision-90b`` at its widths cut to 10 layers (two groups: 8
   self-attention and 2 cross blocks, 10 655 801 858 parameters) with every
   cross gate at 0.5 and a seeded [1, 1601, 7680] memory: a 2048-token
   prefill through ``flash_attention`` (8 calls) against the plain path at
   every position within 1e-5, ``prefill_chunk`` chained in 256-token
   chunks against it (the reference's chained-prefill bar, atol 1e-4), 16
   greedy tokens through ``decode_step`` equal to ``plain_greedy``'s, and
   a zero memory moving the logits by at least 1e-3 of max |logit|;
26. tp — tensor-parallel compute along ``model`` on two gloo ranks sharing
   the card, each drawing the weights from seed 0 and cutting its own
   model shard: ``internlm2-20b`` at its widths cut to 4 layers (phase
   18's traffic) and ``falcon-mamba-7b`` cut to 16 (4 of phase 12's
   requests, 16 new tokens) through ``DecodeServer(plan=ShardPlan(
   make_local_mesh(1, 2)))``: resident parameter bytes a rank against the
   share ``param_specs(fsdp=False)`` gives, tokens equal to the
   ``plan=None`` runs of phases 18 and 12 and every prefill and decode
   logit row within 1e-5 of max |logit| of theirs (recorded there),
   ``flash_attention`` (24 of 48 query heads, 4 of 8 KV heads) and
   ``ssm_scan`` (4096 of 8192 channels) launched on every prefill, decode
   tok/s and prefill ms beside theirs; ``smollm-135m`` uncut through
   ``Trainer(mesh=make_local_mesh(1, 2))`` on phase 23's cell, losses and
   grad norms against its ``mesh=None`` run (1e-5 at step 0, 1e-4 after),
   the leaves replicated along ``model`` bit-identical across the ranks,
   no gather over ``model`` in a step and no kernel launched; the dry run
   of that (1, 1, 2) cell beside the ranks, its argument bytes and
   collectives equal to theirs; ``flash_attention`` at the rank's shape
   (j) and ``ssm_scan`` at D = 4096 against their plain versions, timed.
   In the same ranks, the encoder and the VLM on their model shards:
   ``hubert-xlarge`` uncut at (1, 1, 2), phase 25's 2048 frames forward
   (each rank's 252 vocabulary columns at every position within 1e-5 of
   max |logit| of phase 25's kernel forward; 48 ``flash_attention`` calls
   on 8 of 16 heads, non-causal) and one ``make_train_step(mesh=)`` step
   on phase 25's 4 × 1024 batch (loss and grad norm within 1e-5 of its
   ``mesh=None`` step, ``embed/proj`` and the norms bit-identical across
   the ranks, no gather), the dry run of that cell equal to the ranks;
   ``llama-3.2-vision-90b`` at 10 layers, its leaves cut as they are drawn
   (``ShardPlan.draw_local``: the whole 42.62 GB tree is never held), cross
   gates at 0.5: phase 25's prompt and memory through
   ``make_prefill_step(mesh=)`` (each rank's vocabulary columns of the
   last logits within 1e-4 of max |logit| of phase 25's kernel prefill,
   ``TP_CROSS_VLM_LOGIT_GAP``, the 1e-5 reading and the one-device
   controls printed beside it; 8
   ``flash_attention`` calls on 32 of 64 query heads) and 16 greedy tokens
   through ``make_serve_step(mesh=)`` equal to phase 25's, resident bytes
   a rank against the reckoned share; ``flash_attention`` at those two
   ranks' shapes (l) and (m) against its plain version, timed beside SDPA.
28. tp16 — attention whose heads do not cut whole, on sixteen gloo ranks
   sharing the card (``make_local_mesh(1, 16)``): 8 KV heads of 128 over
   16 ranks are half a head each, joined whole exactly before RoPE, the
   norms and the cache.  ``internlm2-20b`` at phase 18's 4 layers through
   ``DecodeServer(plan=)`` on phase 18's 17- and 2048-token prompts, 8 new
   tokens (tokens equal to phase 18's, every logit row within 1e-5 of max
   |logit| of its ``plan=None`` run, the replicated caches bit-identical
   across the ranks); ``llama-3.2-vision-90b`` at phase 25's 10 layers, gates at 0.5,
   phase 25's prompt and memory through the prefill and serve steps
   (last logits within 1e-4, the 1e-5 reading printed; 4 tokens equal to
   phase 25's); resident bytes a rank against 1/16 of the whole;
   ``internlm2-20b`` at 1 layer through ``Trainer(mesh=)`` on 2 × 1024
   tokens, 2 steps against a ``mesh=None`` run on the card before the
   ranks (1e-5 at step 0, 1e-4 after), the replicated leaves
   bit-identical, the dry run of that (1, 1, 16) cell equal to the ranks;
   ``flash_attention`` at the ranks' shapes (n) and (o) against its plain
   version, timed beside SDPA.

Then the kernel summary (one JSON line), the card's name and power limit as
``nvidia-smi`` reports them, and the result line.  Each phase prints its
seconds, and on standard error its name and the seconds since the start
(so a run that is stopped shows how far it got).  The script imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import asyncio
import atexit
import contextlib
import dataclasses
import gc
import hashlib
import json
import math
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import threading
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
# largest |logit|: its layers compound the kernel's rounding (FMA contraction,
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
PROFILED = 4        # the profiled step() runs serve the first four requests
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
LOADGEN_MAMBA_LAYERS = 16        # falcon-mamba-7b's replay: 64 layers cut to 16
# falcon-mamba-7b in phase 12 as in its replay: 64 layers cut to 16 (each
# layer repeats the same block; phase 9 times ssm_scan at its shapes), and
# the replay's prefix budget 1 GiB x 16/64 of the published depth, so it
# still evicts
MAMBA_LAYERS = 16
MAMBA_PUBLISHED_LAYERS = 64

# the bit_path phase: sequence steps and batch of its full-width cells, the
# float legs' bar (ref and kernel against eager, relative to the largest |y|
# where that exceeds 1: the 8-layer ssm's linear state reaches ~1e6), and
# the seeds its difftest subprocess runs (each builds its own stage kernels;
# two show the CLI runs on the card, the CPU tests hold 20 against the
# reference, and more repeat the same check on other small random specs)
BIT_T = 256
BIT_BATCH = 2
BIT_FLOAT_TOL = 1e-4
BIT_DIFFTEST_SEEDS = 2

# the tune_chaos phase: the measure budget and batch of each tune run (the
# reference's tune suite: budget 6, batch 2)
TUNE_BUDGET = 6
TUNE_BATCH = 2

# the serve_gemma3 phase: gemma3-27b at its published widths, depth cut to
# one 5:1 group and the 2-layer local tail (every layer kind; 14 layers
# before PR 25); prompts either side of the 1024 window, two sharing a
# 1024-token prefix, one whose decode crosses position 1024 on the ring; a
# prefix cache that keeps every checkpoint (one past the window holds a
# whole ring for each local layer)
GEMMA_LAYERS = 8       # one 5:1 group and the 2-layer local tail
GEMMA_LENGTHS = (17, 512, 1023, 1024, 1025, 1537, 2048)
GEMMA_SHARED = (1024, 64)
GEMMA_CROSS = (1000, 64)
GEMMA_NEW = 16          # decode tokens past 16 repeat the step (the crossing request keeps 64)
SERVE_SLOTS = 4
GEMMA_MAX_SEQ = 2112
GEMMA_CHUNK = 256
GEMMA_PREFIX_BYTES = 12 << 30
# internlm2-20b at its published widths, depth cut to 4
INTERNLM_LAYERS = 4
INTERNLM_LENGTHS = (17, 256, 1024, 2048)
INTERNLM_NEW = 16

# the serve_zamba2 phase: zamba2-1.2b at its published widths, depth cut
# from six groups of five Mamba-2 blocks and the shared block (and the
# 2-block tail) to two groups and the tail: 14 blocks, 508 374 784
# parameters (the shared block applied twice, each with its own LoRA).  Prompts either side of the SSD chunk of 128 (131 and 1031
# are prime, so their one-shot scans run chunks of 1; 512-4096 run chunks
# of 128), two sharing a 1024-token prefix; the prefix cache's budget is
# computed from the checkpoints the chunked pass stores
# (``checkpoint_bytes``); prefill logits held to 1e-5 of max |logit|; the
# profile's step() run serves the first four prompts
ZAMBA_LENGTHS = (17, 131, 512, 1024, 1031, 2048, 4096)
ZAMBA_LAYERS = 14
ZAMBA_PARAMS = 508_374_784
ZAMBA_SHARED = (1024, 64)
ZAMBA_NEW = 16          # decode tokens past 16 repeat the step at the next position
ZAMBA_MAX_SEQ = 4224
ZAMBA_CHUNK = 256
ZAMBA_LOGITS_RTOL = 1e-5
ZAMBA_PROFILED = 4
# phase 20: olmoe-1b-7b uncut (cut to 8 layers, its 512-token prefill sat
# 1.136e-05 of max |logit| from the plain path with equal routing, past the
# 1e-5 bar, so it keeps its 16) and deepseek-v2-lite-16b at its published
# widths, depth cut 27 -> 9 layers (every layer is the same MoE block;
# 5 683 063 296 parameters).  2050 tokens is the
# group cliff's shortest cheap case: 2050 = 2 · 1025, so the reference's
# rule (halve 2048 until it divides) runs 1025 groups of 2 with C = top_k,
# 25.6x the expert rows of 2048 (2049 would run groups of 1: 51x, ~40 GB of
# transient).  2048 is deepseek's longest prompt (64.8 GB of weights).
OLMOE_LENGTHS = (17, 131, 512, 1024, 2048, 2050)
DEEPSEEK_LENGTHS = (17, 131, 512, 1024, 2048)
OLMOE_LAYERS, OLMOE_PARAMS = 16, 6_919_100_416
DEEPSEEK_LAYERS, DEEPSEEK_PARAMS = 9, 5_683_063_296
MOE_SHARED = (1024, 64)
MOE_NEW = 16            # decode tokens past 16 repeat the step at the next position
MOE_MAX_SEQ = 2112
MOE_CHUNK = 256
MOE_LOGITS_RTOL = 1e-5
ROUTE_MARGIN = 1e-6     # a routing flip between two paths is a near-tie below this
QUANT_SNR_DB = 20.0     # the reference's bars (tests/test_quantized_serving.py)
QUANT_AGREE = 0.8
# phase 21 (train): smollm-135m at train_4k's sequence length, two
# microbatches of 4; the restart drill at 1024; the card against the CPU at
# B = 1, S = 256 (paper-lstm: T = 64), at the full-width bars of the kernels (1e-4)
TRAIN_SEQ = 4096
TRAIN_BATCH = 8
TRAIN_MICRO = 2
TRAIN_STEPS = 3         # the first step and two steady ones
DRILL_SEQ = 1024
DRILL_STEPS = 4         # crosses the step-2 checkpoint; more steps repeat it
DRILL_FAIL = 3
DRILL_ATOL = 1e-6       # tests/test_trainer_server.py's restart bar
CHECK_SEQ = 256
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
LSTM_TRAIN_SEQ = 256
LSTM_TRAIN_STEPS = 2
LSTM_CHECK_SEQ = 64
# phase 22 (mesh): the folded layout's shards, the ranks that share the card
# over gloo, the TP width, and the EP tokens a rank at olmoe's widths
MESH_FOLDED_DP = 8
MESH_RANKS = 2
MESH_TP_TOL = 1e-4      # TP sums the gate contraction in another order (the full-width bar)
MESH_TP_LAYERS = 2
MESH_TP_BATCH = 2
MESH_DP_SPEC = dict(num_hidden_layers=2, seq_len=256, c_slow=4)
MESH_DP_BATCH = 2
# DP's bar is bit identity: a sharded rank's logits are the unsharded run's
# rows.  Only where the card's GEMM itself gives other bits at 1/dp of the
# rows (read in the phase) is a gap allowed, and then at most this much of
# max |logit|: a few ulps a GEMM, carried through 8 layers and 32 decode
# steps (measured 3.636e-06 at a max |logit| of 3.617, PR 24's review run)
MESH_DP_GAP = 5e-6
# the same for the kernel backend's DP against its unsharded launch, of
# max |y|, where its readout GEMM (finals @ C.T) changes bits at 1/dp of the
# rows (measured 1.788e-07 at a max |y| of 0.6973)
MESH_KERNEL_DP_GAP = 1e-6
MESH_EP_TOKENS = 512
MESH_EP_TOL = 2e-4      # run_ep_moe.py's bar
# phase 23 (mesh_train): smollm-135m uncut, train_4k's sequence cut 4096 ->
# 1024 to hold the phase's time, the global batch of 8 in two microbatches,
# 3 steps; losses and grad norms against mesh=None; the compression and
# pipeline cases of the reference's multi-device scripts at full size
MT_SEQ = 1024
MT_BATCH = 8
MT_MICRO = 2
MT_STEPS = 3
MT_RTOL = 1e-5
MT_COMP_STEPS = 30      # run_compression.py's error-feedback steps
PIPE_D, PIPE_C, PIPE_ROWS = 2048, 8, 256
PIPE_TOL = 1e-5         # run_pipeline.py's bar
# 24: olmoe-1b-7b's 16 layers cut to 1 (16 layers x 16 B a parameter of
# training state is ~110 GB, past the card however it is sharded, as every
# rank shares it); a 2048-token MoE group is one rank's rows at S = 1024 and
# spans both ranks at S = 512
MM_LAYERS = 1
# the dry run's CLI in the entry points: the MoE cell refused before MoE ran
# on a data mesh, and a multi-pod one
DRYRUN_CLI = (("olmoe-1b-7b", "pod"), ("smollm-135m", "multipod"))
MM_SEQS = (1024, 512)
MM_BATCH = 8
MM_MICRO = 2
MM_STEPS = 2
MM_RTOL = 1e-5

# 25. cross-attention and the encoder frontend: hubert-xlarge uncut (945 M
# parameters, 3.78 GB fp32), llama-3.2-vision-90b at its widths cut from 100
# layers to two whole 5-layer groups (8 self-attention and 2 cross blocks,
# 42.62 GB fp32; one group would leave the group loop and the [G, ...] cache
# stacking at G = 1, and 100 layers are 350.6 GB)
HUBERT_PARAMS = 945_143_040
HUBERT_SEQ = 2048
HUBERT_TRAIN = (4, 1024)        # (B, S) of the full-width train step
HUBERT_CHECK = (4, 2, 64)       # (layers, B, S) of the card-against-CPU check
LLAMA_LAYERS = 10
LLAMA_PARAMS = 10_655_801_858
LLAMA_PROMPT = 2048
LLAMA_CHUNK = 256
LLAMA_NEW = 16
LLAMA_GATE = 0.5                # the reference opens every cross gate at 0
VLM_LOGITS_RTOL = 1e-5
# the chunk chain against the one-shot prefill: the reference's own bar for
# that comparison (tests/test_serving_stack.py: atol 1e-4); at 10 layers of
# width 8192 the two orders of the fp32 sums part by ~1e-5 of max |logit|
CHUNK_ATOL = 1e-4
MEMORY_ABLATION_MIN = 1e-3      # of max |logit|: the cross blocks are on the path

# 26. tensor-parallel compute along model: two gloo ranks share the card;
# the serving oracles are phases 18's and 12's plan=None runs, the training
# one phase 23's mesh=None run
TP_RANKS = 2
TP_LOGIT_GAP = 1e-5             # of max |logit|, against the plan=None run
TP_MAMBA_REQUESTS = 4
TP_MAMBA_NEW = 16
TP_TRAIN_RTOL0 = 1e-5           # step 0 (ROADMAP.md, Queue 3, marginal checks)
TP_TRAIN_RTOL = 1e-4            # later steps
TP_RESIDENT_RTOL = 1e-3         # resident parameter bytes against the reckoned share
TP_ATTN_SHAPE = ("j_internlm2_tp2_S2048", dict(B=1, S=2048, T=2048, H=24, KV=4, hd=128,
                                               window=0))
TP_SCAN_SHAPE = (1, 256, 4096, 16)      # (B, T, D, N): falcon-mamba-7b's rank at tp = 2

# 27. MoE experts and MLA heads on the model shard: two gloo ranks share the
# card; the serving oracles are phase 20's plan=None step() runs, the
# training one phase 24's mesh=None run at MM_SEQS[0]
TP_MOE_PICK = {"olmoe-1b-7b": (0, 2, 4, 6), "deepseek-v2-lite-16b": (0, 2, 4, 5)}
# ^ phase 20's requests: 17, 512 and 2048 tokens and the first 1088-token
#   shared-prefix one (indices into its traffic, kept as the request ids)
# of max |logit| where no routing decision differs: at 16 layers two correct
# fp32 paths of plan=None already sit 2.0621e-05 apart (the SDPA control,
# ROADMAP.md Queue 3); a wrong expert block or a missing sum gives O(1)
# deepseek at 9 layers: its naive and absorbed MLA prefills on one device
# sit 1.419e-05-1.429e-05 apart at 512-2048 tokens (phase 20 prints it)
TP_MOE_LOGIT_GAP = {"olmoe-1b-7b": 1e-4, "deepseek-v2-lite-16b": 1e-4}
TP_MOE_PREFIX_BYTES = 1 << 30   # every checkpoint of the four prompts, per rank
TP_MOE_AGAIN = 1000             # the request ids of the step_block() pass: uid + this
TP_MOE_ATTN_SHAPE = ("k_olmoe_tp2_S2048", dict(B=1, S=2048, T=2048, H=8, KV=8, hd=128,
                                               window=0))

# 26's cross-attention and encoder cases, in its ranks: hubert-xlarge uncut
# and llama-3.2-vision-90b at LLAMA_LAYERS, held to phase 25's runs
TP_CROSS_LOGIT_GAP = 1e-5       # of max |logit|, against phase 25's kernel runs
# llama at 10 layers of width 8192 misses that bar by rounding alone: on an
# H100 its tp = 2 prefill read 1.054e-05 at the last row, where two other
# orders of the same fp32 sums on one device (phase 25's plain path and its
# chunk chain, 9.256e-06 and 1.006e-05) sit as far from the kernel prefill
# (phase 25 prints both).  It is held at the reference's bar for another
# order of the sums, the chunk chain's (CHUNK_ATOL), as deepseek at tp = 2
# is (ROADMAP.md, Queue 3); the 1e-5 reading is printed beside it.  A zero
# memory moves the logits by 2.7e-02 (phase 25's ablation), and a wrong
# cross head order misses 1e-5 on the CPU (tests/test_torch_tp_cross.py)
TP_CROSS_VLM_LOGIT_GAP = 1e-4
TP_CROSS_ATTN_SHAPES = (
    ("l_hubert_tp2_S2048", dict(B=1, S=2048, T=2048, H=8, KV=8, hd=80, window=0,
                                causal=False)),
    ("m_llama_vision_tp2_S2048", dict(B=1, S=2048, T=2048, H=32, KV=4, hd=128, window=0)))

# 28. attention whose heads do not cut whole: sixteen gloo ranks share the
# card; the oracles are phases 18's (internlm2-20b) and 25's (llama) runs,
# the training one a mesh=None run of the same cell before the ranks start
TP16_RANKS = 16
TP16_PICK = (0, 3)              # phase 18's 17- and 2048-token requests (its uids)
TP16_NEW = 8                    # decode tokens a request (phase 18 ran 16)
# llama's: phase 25 ran 16; a decode call joins its cross blocks' memory
# K/V again over sixteen ranks: 2.4-3.4 s a token on an H100 80GB HBM3 at 700 W
TP16_VLM_NEW = 4
# one layer: at two, the ranks' AdamW state and its update's transients beside
# sixteen contexts passed the card's 80 GB (81 GB in use at the failure)
TP16_TRAIN_LAYERS = 1
TP16_TRAIN = (2, 1024)          # (global batch, sequence) of the train steps
TP16_TRAIN_STEPS = 2
TP16_ATTN_SHAPES = (
    ("n_internlm2_tp16_S2048", dict(B=1, S=2048, T=2048, H=3, KV=1, hd=128, window=0)),
    ("o_llama_vision_tp16_S2048", dict(B=1, S=2048, T=2048, H=4, KV=1, hd=128, window=0)))

START_T0 = time.perf_counter()
PHASE_T0 = [START_T0]


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def phase_done(name: str) -> None:
    now = time.perf_counter()
    say("phase_time", name=name, seconds=f"{now - PHASE_T0[0]:.1f}")
    print(f"[phase_done] name={name} since_start_s={now - START_T0:.1f}", file=sys.stderr,
          flush=True)
    PHASE_T0[0] = now


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def flush_l2(buf: torch.Tensor) -> None:
    buf.add_(1.0)  # 128 MB write: evicts the 50 MB L2 between timed runs


def time_ms(fn, buf: torch.Tensor, reps: int = REPS, clean: bool = False) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after warm-up,
    with a cold L2 at the start of every run.  After the flush the card
    spins for HOST_COVER_CYCLES, so that the host has enqueued all of ``fn``
    (0.06-0.1 ms through the Python wrappers) before the start event fires:
    without it a kernel shorter than the host's enqueue was timed with the
    host's time in it.  The flush writes ``buf``, so ``fn``'s first reads
    also write back up to 50 MB of dirty lines; ``clean`` flushes by
    reading ``buf`` instead, which leaves the L2 cold and clean."""
    sink = torch.empty((), device=buf.device) if clean else None
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        if clean:
            torch.sum(buf, dim=0, out=sink)
        else:
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


def device_kernels(prof, kind, *, check: bool = False) -> list[tuple[str, int, float]]:
    """The device work a torch.profiler run recorded, as ``(name, calls,
    device_us)`` by name, most time first: kernels, copies and memsets.  On
    the card the profiler's raw records on the device are summed (a device
    record's time is all its own); building operator events from them, as
    ``key_averages()`` does, took 7 s for 40 000 kernels on the H100's host
    against 0.1 s for reading the raw records.  Elsewhere, or where the raw records cannot be read, it is
    ``key_averages()``' self device time.  ``check`` computes both, prints
    their busy times and requires them within 1% (the operator events may
    round each record to whole microseconds)."""
    def averaged():
        return sorted(((e.key, e.count, float(e.self_device_time_total))
                       for e in prof.key_averages()
                       if e.device_type == kind and e.self_device_time_total > 0),
                      key=lambda k: -k[2])

    try:
        if kind != torch.autograd.DeviceType.CUDA:
            raise TypeError("no device records")
        by_name: dict[str, list] = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == kind and e.duration_ns() > 0:
                row = by_name.setdefault(e.name(), [0, 0.0])
                row[0] += 1
                row[1] += e.duration_ns() / 1e3
        raw = sorted(((k, n, us) for k, (n, us) in by_name.items()), key=lambda k: -k[2])
    except (AttributeError, TypeError):
        return averaged()
    if check:
        avg = averaged()
        want = sum(us for _, _, us in avg)
        got = sum(us for _, _, us in raw)
        say("profile_records", raw_busy_us=f"{got:.1f}", key_averages_busy_us=f"{want:.1f}",
            raw_records=sum(n for _, n, _ in raw), averaged_records=sum(n for _, n, _ in avg))
        require(abs(got - want) <= 1e-2 * max(want, 1.0),
                f"profile: the raw device records sum to {got:.1f} us, key_averages() to "
                f"{want:.1f} us")
    return raw


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


def int8_time(i8_ops, i8_kernel, args, l2, card: str) -> dict:
    """``int8_matmul``'s time on ``args`` beside its plain version's, one
    ``torch._int_mm`` call's with the same rescale (a yardstick; cuBLASLt
    refuses some shapes, and then ``library_ms`` is None with its error
    printed), its bound, the path the library takes and its launches per
    call; prints the ``[kernel_time]`` line."""
    a, b, a_s, b_s = args
    M, K = a.shape
    N = b.shape[1]
    out = {"ms": time_ms(lambda: i8_ops.int8_matmul(*args), l2),
           "ms_clean_l2": time_ms(lambda: i8_ops.int8_matmul(*args), l2, clean=True),
           "launches_per_call": launches_per_call(lambda: i8_ops.int8_matmul(*args)),
           "plain_ms": time_ms(lambda: i8_ops.int8_matmul_ref(*args), l2),
           "path": i8_kernel.plan(a, b)}
    lib = lambda: torch._int_mm(a, b).to(torch.float32) * a_s * b_s   # noqa: E731
    try:
        lib_exact = torch.equal(lib(), i8_ops.int8_matmul(*args))
        out["library_ms"] = time_ms(lib, l2)
        lib_text = {"library_ms": f"{out['library_ms']:.4f}", "library_bit_exact": lib_exact}
    except RuntimeError as e:
        out["library_ms"] = None
        lib_text = {"library_ms": "none", "library_error": repr(str(e).splitlines()[0])}
    out["bound_ms"], out["bound_by"] = int8_bound_ms(M, K, N)
    require(out["launches_per_call"] == 1,
            f"int8_matmul {M}x{K}x{N}: {out['launches_per_call']} launches a call, expected 1")
    say("kernel_time", kernel="int8_matmul", M=M, K=K, N=N, ms=f"{out['ms']:.4f}",
        ms_clean_l2=f"{out['ms_clean_l2']:.4f}",
        plain_ms=f"{out['plain_ms']:.4f}", **lib_text, library="torch._int_mm(cuBLASLt)+scales",
        bound_ms=f"{out['bound_ms']:.4f}", bound_by=out["bound_by"],
        bound_share=f"{out['bound_ms'] / out['ms']:.3f}", path=out["path"]["path"],
        bm=out["path"]["bm"], cluster=out["path"]["cluster"],
        launches_per_call=out["launches_per_call"], reps=REPS, card=repr(card))
    return out


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


class Beside:
    """``fn(*args, **kwargs)`` run in a thread from construction;
    :meth:`result` joins it and returns its value or raises its exception,
    and :attr:`seconds` is the time from the start to its end."""

    def __init__(self, fn, *args, **kwargs):
        self._box: dict = {}
        t0 = time.perf_counter()

        def run():
            try:
                self._box["value"] = fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 - raised by result()
                self._box["error"] = e
            self.seconds = time.perf_counter() - t0

        self._thread = threading.Thread(target=run)
        self._thread.start()

    def result(self):
        self._thread.join()
        if "error" in self._box:
            raise self._box["error"]
        return self._box["value"]


@contextlib.contextmanager
def clis_started(commands: dict, logs: Path):
    """Start every ``commands`` entry at once, each a subprocess with its
    output in a file under ``logs`` and a thread that notes when it exits;
    yields them for :func:`clis_finished`, and kills any still running when
    the block is left."""
    import threading

    def note_exit(proc, ended):
        proc.wait()
        ended.append(time.perf_counter())

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    logs.mkdir(parents=True, exist_ok=True)
    started = {}
    try:
        for i, (name, cmd) in enumerate(commands.items()):
            log = logs / f"cli_{i}.log"
            with open(log, "w") as out:
                proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=out,
                                        stderr=subprocess.STDOUT)
            ended: list = []
            threading.Thread(target=note_exit, args=(proc, ended), daemon=True).start()
            started[name] = (proc, log, time.perf_counter(), ended)
        yield started
    finally:
        for proc, *_ in started.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def clis_finished(started: dict, timeout_s: float = 600) -> dict:
    """Wait for :func:`clis_started`'s commands: ``{name: (exit code or None
    if still running after timeout_s, output lines, seconds from its start
    to its exit)}``."""
    deadline = time.perf_counter() + timeout_s
    while (any(proc.poll() is None for proc, *_ in started.values())
           and time.perf_counter() < deadline):
        time.sleep(0.05)
    out = {}
    for name, (proc, log, t0, ended) in started.items():
        if proc.poll() is None:
            out[name] = (None, log.read_text().splitlines(), timeout_s)
            continue
        proc.wait()
        while not ended:            # the thread notes the exit just after wait() returns
            time.sleep(0.01)
        out[name] = (proc.returncode, log.read_text().splitlines(), ended[0] - t0)
    return out


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
    budget forces evictions: a checkpoint at full width is a layer's
    (8192·16 + 3·8192) fp32, about 0.6 MiB, per layer (38 MiB at 64 layers),
    so 1 GiB × layers / 64 holds about 26 and the trace's ~90 chunk
    boundaries and prompt ends evict.  Returns the ``ssm_scan`` launches."""
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


def launch_serve_cmd(arch: str, device: str) -> list[str]:
    """``python -m repro_torch.launch.serve --arch <arch>`` (its smoke
    config: 16 requests, chunked adaptive prefill with a prefix cache,
    device-side decode blocks) on ``device``."""
    return [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
            "--prefill-chunk", "16", "--prefill-adaptive", "--prefix-cache", "64",
            "--persistent", "--device", device]


def dryrun_clis(device: str = "cuda") -> dict:
    """The dry-run CLI's ``DRYRUN_CLI`` cells as :func:`clis_started`
    commands (records under an emptied ``build/dryrun``).  They trace on
    fake tensors, on the host only, so ``main`` starts them before phase 20
    and :func:`entry_points` collects them."""
    dry_docs = ROOT / "build" / "dryrun"
    shutil.rmtree(dry_docs, ignore_errors=True)
    return {f"launch.dryrun --arch {arch} --mesh {mesh}": [
        sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", "train_4k",
        "--mesh", mesh, "--out", str(dry_docs), "--device", device] for arch, mesh in DRYRUN_CLI}


def entry_points(card: str, device: str = "cuda", difftest_seeds: int = BIT_DIFFTEST_SEEDS,
                 train_args: tuple[str, ...] = ("--arch", "smollm-135m", "--steps", "2",
                                                "--seq", "256", "--batch", "4"),
                 started_dryruns: dict | None = None) -> None:
    """Every entry point the smoke runs as a subprocess, all started
    together while this process runs nothing else (each pays the start of a
    Python process that imports torch, tens of seconds on a slow host):
    ``python -m repro_torch.launch.serve`` (paper-lstm's loadgen replay,
    its trace and metrics) and ``python -m repro_torch.obs.report``, then
    ``python -m repro_torch.obs.check`` on the four documents they write
    (phase 15d); ``launch.serve --arch zamba2-1.2b`` and ``--arch
    olmoe-1b-7b`` (phases 19 and 20; each must report 16 requests served);
    ``python -m repro_torch.verify.difftest``, its ``--regen-goldens`` into
    ``build/bit_path/`` and ``python -m repro_torch.analyze --all-cells``
    (phase 16; the analysis document checked, four goldens written); and
    ``python -m repro_torch.launch.train`` at smollm-135m's published
    widths into an emptied checkpoint directory (phase 21; it must print
    ``final_loss=``); ``python -m repro_torch.analyze --lint-src`` (phase
    17); the dry-run CLI's cells (:func:`dryrun_clis`), unless
    ``started_dryruns`` holds them already running (:func:`clis_started`'s).
    Each must exit 0."""
    from repro_torch.obs.check import check_analyze_doc

    docs = ROOT / "build" / "serve_loadgen"
    bit_docs = ROOT / "build" / "bit_path"
    for d in (docs, bit_docs):
        d.mkdir(parents=True, exist_ok=True)
    files = {k: docs / f"{k}.json" for k in ("loadgen", "trace", "metrics", "ledger")}
    train_ckpt = ROOT / "build" / "train" / "launch"
    shutil.rmtree(train_ckpt, ignore_errors=True)      # a full one would be resumed
    dry_docs = ROOT / "build" / "dryrun"
    py = [sys.executable, "-m"]
    commands = {
        "launch.serve": [*py, "repro_torch.launch.serve", "--arch", "paper-lstm",
                         "--loadgen", "--prefill-chunk", "4", "--prefix-cache", "64",
                         "--loadgen-out", str(files["loadgen"]), "--trace-out", str(files["trace"]),
                         "--metrics-out", str(files["metrics"]), "--device", device],
        "obs.report": [*py, "repro_torch.obs.report", "--backends", "eager",
                       "kernel", "--out", str(files["ledger"]), "--device", device],
        "launch.serve --arch zamba2-1.2b": launch_serve_cmd("zamba2-1.2b", device),
        "launch.serve --arch olmoe-1b-7b": launch_serve_cmd("olmoe-1b-7b", device),
        "verify.difftest": [*py, "repro_torch.verify.difftest", "--seeds", str(difftest_seeds),
                            "--device", device],
        "verify.difftest --regen-goldens": [*py, "repro_torch.verify.difftest",
                                            "--regen-goldens", str(bit_docs / "goldens"),
                                            "--device", device],
        "analyze": [*py, "repro_torch.analyze", "--all-cells", "--bits", "8,16,32",
                    "--out", str(bit_docs / "analyze.json"), "--device", device],
        "launch.train " + " ".join(train_args): [
            *py, "repro_torch.launch.train", *train_args,
            "--ckpt-dir", str(train_ckpt), "--device", device],
        "analyze --lint-src": [*py, "repro_torch.analyze", "--lint-src", "--device", device],
        **({} if started_dryruns is not None else dryrun_clis(device)),
    }
    must_print = {**{f"launch.dryrun --arch {arch} --mesh {mesh}": "[ok]"
                     for arch, mesh in DRYRUN_CLI},
                  "launch.serve --arch zamba2-1.2b": "served 16 requests",
                  "launch.serve --arch olmoe-1b-7b": "served 16 requests",
                  "launch.train " + " ".join(train_args): "final_loss="}
    with clis_started(commands, ROOT / "build" / "entry_points") as clis:
        finished = clis_finished(clis)
        if started_dryruns is not None:
            finished |= clis_finished(started_dryruns)
        for name, (rc, lines, seconds) in finished.items():
            for ln in lines[-4:]:
                say("entry_point", command=name, line=repr(ln))
            say("entry_point_run", command=repr(name), exit=rc, seconds=f"{seconds:.1f}")
            require(rc == 0 and (name not in must_print
                                 or any(must_print[name] in ln for ln in lines)),
                    f"python -m repro_torch.{name} exited {rc}")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
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
    require(check_analyze_doc(json.loads((bit_docs / "analyze.json").read_text())) == []
            and len(list((bit_docs / "goldens").glob("*.v"))) == 4,
            "bit_path: the CLIs' documents are incomplete")
    for arch, mesh in DRYRUN_CLI:
        name = "16x16" if mesh == "pod" else "2x16x16"
        rec = json.loads((dry_docs / f"{arch}__train_4k__{name}.json").read_text())
        require(rec["collectives"] and rec["flops_corrected"] > 0,
                f"launch.dryrun {arch} {mesh}: an incomplete record {rec}")
        say("dryrun_cli", arch=arch, mesh=name, rows_per_rank=rec["rows_per_rank"],
            flops=f"{rec['flops_corrected']:.4e}",
            argument_gb=f"{rec['memory_analysis']['argument_size_in_bytes'] / 1e9:.3f}",
            peak_gb=f"{rec['memory_analysis']['peak_size_in_bytes'] / 1e9:.2f}",
            collectives=rec["collectives"], trace_s=rec["lower_s"], card=repr(card))
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


def bit_path(dev, card: str, T: int = BIT_T) -> dict[str, int]:
    """The paper's fixed-point path on the card: rtlsim against the golden
    model at full width, the ref/eager/kernel float legs on the same cells,
    the card against the CPU word for word, ``synthesize(backend="verilog")``
    against the emission from CPU copies of the weights and the static gate
    (``synthesize(backend="kernel", analyze=True)``); its CLIs run with the
    other entry points (:func:`entry_points`).  Returns the generated stage
    kernel's launches by cell (the float legs and the gated synthesis)."""
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
        for width in ((18, 32) if cell == "lstm" else (18,)):
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
    plain path; ``python -m repro_torch.verify.chaos`` as a subprocess,
    started before the full-width tune cell (beside its host-bound predict
    pass), and ``python -m repro_torch.obs.check`` on every document.  Returns the launches of
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
    chaos_doc = docs / "chaos.json"
    commands = {
        "verify.chaos": [sys.executable, "-m", "repro_torch.verify.chaos", "--seed", "0",
                         "--out", str(chaos_doc)],
    }
    if dev.type != "cuda":
        for cmd in commands.values():
            cmd += ["--device", "cpu"]
    cli_stack = contextlib.ExitStack()
    clis = None

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
        if label not in case_studies and clis is None:
            # the CLI (its own process, ~12 s) beside the full-width cell's
            # predict pass, which holds the host for a minute and leaves the
            # card idle; the case studies' winners, which compare measured
            # times across two runs, are picked before it starts
            clis = cli_stack.enter_context(clis_started(commands, docs / "logs"))
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

    # -- 17c. the CLIs as subprocesses (started before the full-width tune cell) -------
    with cli_stack:
        for name, (rc, lines, seconds) in clis_finished(clis).items():
            for ln in lines[-3:]:
                say("tune_chaos_cli", command=repr(name), line=repr(ln))
            require(rc == 0, f"python -m repro_torch.{name} exited {rc}")
            say("tune_chaos", step="cli", command=repr(name), exit=0, seconds=f"{seconds:.1f}")
    check = subprocess.run([sys.executable, "-m", "repro_torch.obs.check", str(chaos_doc),
                            *map(str, sorted(docs.glob("tune_*.json")))], env=env, cwd=ROOT,
                           capture_output=True, text=True, timeout=120)
    require(check.returncode == 0,
            f"repro_torch.obs.check refused the documents:\n{check.stdout}{check.stderr}")
    say("tune_chaos", step="obs_check", documents=1 + len(list(docs.glob("tune_*.json"))),
        ok=True)
    return launches


# ---------------------------------------------------------------------------
# phases 18 and 19: serve_gemma3 (and one internlm2-20b prefill and serve),
# serve_zamba2
# ---------------------------------------------------------------------------

def long_prompt_traffic(vocab: int, lengths=GEMMA_LENGTHS, shared=GEMMA_SHARED,
                        cross=GEMMA_CROSS, new=GEMMA_NEW, seed: int = 0):
    """The phase's requests as ``(prompt, max_new_tokens)``: one seeded
    prompt per length of ``lengths``, two sharing a ``shared[0]``-token
    prefix with ``shared[1]``-token suffixes, and (unless ``cross`` is
    None) one of ``cross[0]`` tokens whose ``cross[1]`` new tokens cross
    gemma3's window edge on the ring."""
    rng = np.random.default_rng(seed)
    draw = lambda n: [int(t) for t in rng.integers(1, vocab, n)]  # noqa: E731
    out = [(draw(n), new) for n in lengths]
    prefix = draw(shared[0])
    out += [(prefix + draw(shared[1]), new) for _ in range(2)]
    if cross is not None:
        out.append((draw(cross[0]), cross[1]))
    return out


def rank_attn_heads(mcfg, tp: int = 1, index: int = 0) -> tuple[int, int]:
    """(query heads, KV heads) that ``flash_attention`` sees on model rank
    ``index`` of ``tp``: ``H/tp`` and ``KV/tp`` where the heads cut whole,
    else the query heads that cover the rank's ``wo`` rows and the KV heads
    they read (``tensor_parallel.query_heads``, ``kv_heads``)."""
    from repro_torch.parallel import tensor_parallel as tp_lib

    H, KV, hd = mcfg.n_heads, mcfg.n_kv_heads, mcfg.head_dim
    if tp == 1 or KV % tp == 0:
        return H // tp, KV // tp
    h0, h1, _ = tp_lib.query_heads(index, H * hd // tp, hd)
    return h1 - h0, len(tp_lib.kv_heads(h0, h1, H, KV))


def fa_per_prefill(mcfg, n: int, dev, tp: int = 1, index: int = 0) -> tuple[int, int, int]:
    """``flash_attention`` calls, windowed calls and CUDA launches of one
    one-shot prefill of ``n`` tokens: one call per attention layer (``attn``,
    ``attn_local``, ``shared_attn``, and ``moe`` without MLA: MLA has no
    kernel), the local layers' with the window, each
    1 launch or 2 where the host splits the key axis (on model rank
    ``index``'s heads of ``tp``: ``rank_attn_heads``).  Launches are 0 off
    the card."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    attn_kinds = ("attn", "attn_local", "shared_attn") + (() if mcfg.use_mla else ("moe",))
    kinds = [k for k in list(mcfg.layer_pattern) * mcfg.n_groups + list(mcfg.tail_pattern)
             if k in attn_kinds]
    windows = [mcfg.sliding_window if k == "attn_local" else 0 for k in kinds]
    launches = 0
    if dev.type == "cuda":
        h, kv = rank_attn_heads(mcfg, tp, index)
        q = torch.empty((1, n, h, mcfg.head_dim), device=dev)
        k = torch.empty((1, n, kv, mcfg.head_dim), device=dev)
        launches = sum(fa_kernel.launches_per_call(
            fa_kernel.splits(q, k, causal=mcfg.causal, window=w)) for w in windows)
    return len(kinds), sum(w > 0 for w in windows), launches


def plain_greedy(mcfg, params, prompt, n: int, max_seq: int, dev, memory=None) -> list[int]:
    """The model's own greedy loop on the plain path (``use_pallas=False``):
    the prompt as one ``prefill_chunk`` from a fresh B=1 cache, then
    ``decode_step`` (a VLM's cross blocks reading ``memory`` in both); no
    server and no ``splice_cache`` on the way."""
    from repro_torch.models import lm

    pcfg = dataclasses.replace(mcfg, use_pallas=False)
    caches = lm.init_cache(pcfg, 1, max_seq, dev)
    lg, caches = lm.prefill_chunk(params, pcfg, torch.as_tensor([prompt], device=dev),
                                  caches, 0, memory=memory)
    out = [int(lg[0].argmax())]
    pos = len(prompt)
    while len(out) < n:
        lg, caches = lm.decode_step(params, pcfg, torch.as_tensor([[out[-1]]], device=dev),
                                    caches, pos, memory=memory)
        out.append(int(lg[0].argmax()))
        pos += 1
    return out


def prefill_against_plain(mcfg, params, prompts, dev, card: str,
                          rtol: float = DENSE_LOGITS_RTOL) -> tuple[float, int, int, int, int]:
    """Each prompt's one-shot prefill logits through the kernel against
    ``use_pallas=False``, within ``rtol`` of the largest |logit|; the
    kernel's calls, windowed calls and launches held to ``fa_per_prefill``
    per prompt; each prefill's ms, the memory the kernel path's prefill
    allocates above what was allocated before it (``transient_gb``) and,
    for a Mamba-2 model, the SSD chunk its length runs.  Returns the
    largest gap, the counts, and the peak allocation since the caller's
    last reset of the peak (each prefill resets it)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import lm
    from repro_torch.models.ssm import SSD_CHUNK, ssd_chunk_size

    worst, n_calls, n_win, n_launch, peak = 0.0, 0, 0, 0, 0
    for prompt in prompts:
        toks = torch.as_tensor([prompt], device=dev)
        sync(dev)
        extra = {}
        if "mamba2" in mcfg.layer_pattern:
            extra["ssd_chunk"] = ssd_chunk_size(len(prompt), mcfg.ssm_chunk or SSD_CHUNK)
        if dev.type == "cuda":
            peak = max(peak, torch.cuda.max_memory_allocated(dev))
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        fa = fa_ops.flash_attention
        fa.calls = fa.window_calls = fa.launches = 0
        t0 = time.perf_counter()
        lg_k, _ = lm.prefill(params, mcfg, toks)
        sync(dev)
        k_ms = (time.perf_counter() - t0) * 1e3
        if dev.type == "cuda":
            extra["transient_gb"] = f"{(torch.cuda.max_memory_allocated(dev) - base) / 1e9:.2f}"
        calls, win, launches = fa.calls, fa.window_calls, fa.launches
        t0 = time.perf_counter()
        lg_p, _ = lm.prefill(params, dataclasses.replace(mcfg, use_pallas=False), toks)
        sync(dev)
        p_ms = (time.perf_counter() - t0) * 1e3
        want = fa_per_prefill(mcfg, len(prompt), dev)
        require((calls, win, launches) == want,
                f"{mcfg.name} prefill of {len(prompt)} tokens: flash_attention calls, "
                f"windowed calls, launches {(calls, win, launches)}, not {want}")
        require(lg_k.shape == (1, mcfg.vocab) and bool(torch.isfinite(lg_k).all()),
                f"{mcfg.name} prefill logits of shape {tuple(lg_k.shape)} or non-finite")
        scale = float(lg_p.abs().max())
        gap = float((lg_k - lg_p).abs().max()) / scale
        require(gap <= rtol,
                f"{mcfg.name} use_pallas prefill logits of {len(prompt)} tokens differ from "
                f"the plain path by {gap:.3e} of max |logit| {scale:.3e}")
        say("prefill_check", arch=mcfg.name, prompt_len=len(prompt),
            flash_attention_calls=calls, window_calls=win, launches=launches,
            rel_gap=f"{gap:.3e}", rtol_of_max=rtol, prefill_ms_use_pallas=f"{k_ms:.2f}",
            prefill_ms_plain=f"{p_ms:.2f}", **extra, card=repr(card))
        worst = max(worst, gap)
        n_calls, n_win, n_launch = n_calls + calls, n_win + win, n_launch + launches
    if dev.type == "cuda":
        peak = max(peak, torch.cuda.max_memory_allocated(dev))
    return worst, n_calls, n_win, n_launch, peak


def prefill_ms_by_len(srv) -> dict:
    """``{prompt tokens: ms}`` of ``srv``'s one-shot prefill spans."""
    return {ev["args"]["tokens"]: ev["dur"] / 1e3 for ev in srv.obs.tracer.events()
            if ev.get("name") == "prefill_oneshot"}


def dense_serve(mcfg, params, traffic, label: str, dev, card: str, *, block: bool = False,
                 srv=None, uid0: int = 0, record: dict | None = None, **kw):
    """Drive ``DecodeServer`` over ``traffic``; returns the tokens by
    request index, the server, and the ``flash_attention`` calls, windowed
    calls and launches of the run (counts set to 0 just before it, read just
    after).  The kernel must run as ``fa_per_prefill`` says for every
    one-shot prefill the server ran: every prompt of a run without
    chunking, none of a chunked run, those that adaptive prefill admitted
    uncontended."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.obs import Observability
    from repro_torch.runtime.server import DecodeServer, Request

    if srv is None:
        srv = DecodeServer(mcfg, params, num_slots=SERVE_SLOTS, max_seq=kw.pop("max_seq"),
                           block_k=BLOCK_K, obs=Observability(trace=True), device=dev, **kw)
    srv.reset_stats()
    srv.obs.tracer.reset()
    for i, (prompt, n) in enumerate(traffic):
        srv.submit(Request(uid=uid0 + i, prompt=list(prompt), max_new_tokens=n))
    sync(dev)
    fa = fa_ops.flash_attention
    fa.calls = fa.window_calls = fa.launches = 0
    t0 = time.perf_counter()
    prompts = {} if record is None else {uid0 + i: p for i, (p, _) in enumerate(traffic)}
    with served_logits(srv, range(srv.B), prompts) as logits, \
            served_routes(srv, range(srv.B), prompts if mcfg.family == "moe" else {}) as routes:
        done = [r for r in srv.run_until_drained(persistent=block) if r.uid >= uid0]
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    counts = (fa.calls, fa.window_calls, fa.launches)
    st = srv.stats()
    require(len(done) == len(traffic), f"{mcfg.name} {label}: {len(done)} of "
            f"{len(traffic)} requests retired")
    toks = {}
    for r in done:
        n = traffic[r.uid - uid0][1]
        require(r.finish_reason == "max_tokens" and len(r.out_tokens) == n,
                f"{mcfg.name} {label}: request {r.uid} ended {r.finish_reason} after "
                f"{len(r.out_tokens)} tokens")
        toks[r.uid - uid0] = list(r.out_tokens)
    # the one-shot prefills the server ran (its prefill_oneshot spans): every
    # prompt without chunking, none with it, any of them under adaptive
    # prefill (an uncontended admission takes the one-shot path)
    oneshot = sorted(ev["args"]["tokens"] for ev in srv.obs.tracer.events()
                     if ev.get("name") == "prefill_oneshot")
    if srv.prefill_chunk == 0:
        require(oneshot == sorted(len(p) for p, _ in traffic),
                f"{mcfg.name} {label}: one-shot prefills of {oneshot} tokens")
    elif not srv.prefill_adaptive:
        require(not oneshot, f"{mcfg.name} {label}: one-shot prefills of {oneshot} tokens")
    per = [fa_per_prefill(mcfg, n, dev) for n in oneshot]
    want = tuple(sum(x[i] for x in per) for i in range(3))
    require(counts == want, f"{mcfg.name} {label}: flash_attention calls, windowed calls, "
            f"launches {counts}, not {want}")
    decode_ms = sum(ev["dur"] for ev in srv.obs.tracer.events()
                    if ev.get("name") in ("decode_step", "decode_block")) / 1e3
    pc = st.get("prefix_cache", {})
    if record is not None:
        record.update(logits=logits, routes=routes, prefill_ms_by_len=prefill_ms_by_len(srv),
                      decode_tok_s=st["decoded_tokens"] / max(decode_ms / 1e3, 1e-9),
                      prefill_ms=(wall_ms - decode_ms) / len(done))
    say("serve", arch=mcfg.name, driver=label, requests=len(done), wall_ms=f"{wall_ms:.1f}",
        decode_tok_s=f"{st['decoded_tokens'] / max(decode_ms / 1e3, 1e-9):.1f}",
        prefill_ms_per_prompt=f"{(wall_ms - decode_ms) / len(done):.2f}",
        decode_syncs=st["decode_syncs"], decoded_tokens=st["decoded_tokens"],
        syncs_per_token=f"{st['decode_syncs'] / max(st['decoded_tokens'], 1):.4f}",
        prompt_steps=st["prefill"]["prompt_steps_computed"],
        chunks=st["prefill"]["chunks_run"], flash_attention_calls=counts[0],
        window_calls=counts[1], launches=counts[2],
        hits=pc.get("hits", "n/a"), partial_hits=pc.get("partial_hits", "n/a"),
        evictions=pc.get("evictions", "n/a"), checkpoint_bytes=pc.get("bytes_in_use", "n/a"),
        entries=pc.get("entries", "n/a"), card=repr(card))
    return toks, srv, counts


def serve_long_prompts(mcfg, params, dev, card: str, traffic, checked, *,
                       max_seq: int = GEMMA_MAX_SEQ, chunk: int = GEMMA_CHUNK,
                       prefix_bytes: int = GEMMA_PREFIX_BYTES,
                       rtol: float = DENSE_LOGITS_RTOL) -> dict:
    """A long-prompt model's main path (gemma3, zamba2): ``traffic`` under
    one-shot ``step()``, ``step_block()``, and chunked ``step()`` with the
    prefix cache, twice (the second pass all full hits); equal tokens
    across every run, the requests at ``checked`` equal to
    ``plain_greedy``, and every distinct prompt's prefill logits held
    against the plain path within ``rtol`` of max |logit|.  Returns the
    kernel's counts summed over the runs and ``step()``'s tokens."""
    total = np.zeros(3, np.int64)
    runs = {}
    with torch.no_grad():
        for label, block in (("step", False), ("step_block", True)):
            runs[label], srv, counts = dense_serve(mcfg, params, traffic, label, dev, card,
                                                    block=block, max_seq=max_seq)
            total += counts
            del srv
        label = f"step+prefill_chunk={chunk}+cache"
        runs["chunked"], srv, counts = dense_serve(
            mcfg, params, traffic, label, dev, card, max_seq=max_seq, prefill_chunk=chunk,
            prefix_cache_bytes=prefix_bytes)
        total += counts
        first = srv.stats()["prefix_cache"]
        require(first["partial_hits"] >= 1 and first["evictions"] == 0,
                f"{mcfg.name}: the cold chunked pass found {first['partial_hits']} partial hits "
                f"(the shared prefix) and evicted {first['evictions']} checkpoints")
        runs["chunked_again"], srv, counts = dense_serve(
            mcfg, params, traffic, label + " (second pass)", dev, card, srv=srv, uid0=1000)
        total += counts
        st = srv.stats()
        require(st["prefix_cache"]["hits"] == len(traffic)
                and st["prefill"]["prompt_steps_computed"] == 0,
                f"{mcfg.name}: the second pass hit {st['prefix_cache']['hits']} of "
                f"{len(traffic)} prompts and ran {st['prefill']['prompt_steps_computed']} "
                "prompt steps")
        del srv
        for label, toks in runs.items():
            require(toks == runs["step"], f"{mcfg.name}: {label} tokens differ from step()'s")
        for i in checked:
            prompt, n = traffic[i]
            want = plain_greedy(mcfg, params, prompt, n, max_seq, dev)
            require(runs["step"][i] == want,
                    f"{mcfg.name}: the served tokens of the {len(prompt)}-token request differ "
                    f"from the plain greedy loop's:\n{runs['step'][i]}\n{want}")
        distinct = list({len(p): p for p, _ in traffic}.values())
        gap, calls, win, launches, peak = prefill_against_plain(mcfg, params, distinct, dev,
                                                                card, rtol=rtol)
        total += (calls, win, launches)
    say("serve_check", arch=mcfg.name, path="use_pallas", identical_tokens=True,
        drivers="step,step_block,chunked,chunked_all_hits",
        plain_greedy_equal=",".join(f"{len(traffic[i][0])}+{traffic[i][1]}" for i in checked),
        prefill_lengths=",".join(str(len(p)) for p in distinct), max_rel_gap=f"{gap:.3e}",
        rtol_of_max=rtol, flash_attention_calls=int(total[0]),
        window_calls=int(total[1]), launches=int(total[2]), card=repr(card))
    return {"calls": int(total[0]), "window_calls": int(total[1]), "launches": int(total[2]),
            "tokens": runs["step"], "peak_bytes": peak}


def serve_internlm2(mcfg, params, dev, card: str, lengths=INTERNLM_LENGTHS,
                    max_seq: int = GEMMA_MAX_SEQ, new: int = INTERNLM_NEW) -> dict:
    """internlm2-20b: the longest prompt's prefill through the kernel
    against the plain path, then a one-shot ``step()`` serve of one request
    per length, each held to ``plain_greedy``."""
    rng = np.random.default_rng(1)
    traffic = [([int(t) for t in rng.integers(1, mcfg.vocab, n)], new) for n in lengths]
    with torch.no_grad():
        gap, calls, win, launches, _ = prefill_against_plain(mcfg, params, [traffic[-1][0]],
                                                          dev, card)
        oracle = {}
        toks, srv, counts = dense_serve(mcfg, params, traffic, "step", dev, card,
                                         max_seq=max_seq, record=oracle)
        del srv
        oracle.update(traffic=traffic, tokens=toks)
        for i, (prompt, n) in enumerate(traffic):
            want = plain_greedy(mcfg, params, prompt, n, max_seq, dev)
            require(toks[i] == want, f"{mcfg.name}: the served tokens of the {len(prompt)}-"
                    f"token request differ from the plain greedy loop's")
    say("serve_check", arch=mcfg.name, path="use_pallas", plain_greedy_equal=len(traffic),
        prefill_rel_gap=f"{gap:.3e}", rtol_of_max=DENSE_LOGITS_RTOL,
        flash_attention_calls=calls + counts[0], launches=launches + counts[2], card=repr(card))
    return {"calls": calls + counts[0], "window_calls": win + counts[1],
            "launches": launches + counts[2], "oracle": oracle}


def perturb_hybrid(params, gen: torch.Generator) -> None:
    """Draw anew, in place, the leaves that the reference initialises to
    constants and that would hide half of a hybrid block: every
    ``shared_attn`` block's LoRA ``qB``/``kB``/``vB`` (zero: LoRA would be
    the identity), every ``mamba2`` block's ``dt_bias`` (Mamba's Δ
    initialisation, Δ in [1e-3, 1e-1] through the inverse softplus), ``D``
    (1 + N(0, 0.25)) and conv biases (N(0, 0.25))."""
    randn = lambda t: torch.randn(t.shape, generator=gen, device=t.device)  # noqa: E731
    for top in ("groups", "tail"):
        for name, blk in params.get(top, {}).items():
            if name.endswith("_shared_attn"):
                for leaf in ("qB", "kB", "vB"):
                    t = blk["lora"][leaf]
                    t.copy_(randn(t) / math.sqrt(t.shape[-2]))
            elif name.endswith("_mamba2"):
                m = blk["mamba"]
                u = torch.rand(m["dt_bias"].shape, generator=gen, device=m["dt_bias"].device)
                dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
                m["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))
                m["D"].copy_(1.0 + 0.5 * randn(m["D"]))
                for leaf in ("conv_b_x", "conv_b_bc"):
                    m[leaf].copy_(0.5 * randn(m[leaf]))


def checkpoint_bytes(mcfg, traffic, chunk: int) -> int:
    """What the chunked pass's prefix cache stores at most: for every
    prompt, a checkpoint at each multiple of ``chunk`` below its length and
    at its end, each the B=1 cache (states whole, full-attention K/V
    trimmed to the boundary) and its fp32 logits.  A prefix shared by two
    prompts is counted for each, so the sum bounds the cache's bytes from
    above.  Sizes come from ``init_cache`` on the meta device."""
    from repro_torch.models import lm
    from repro_torch.runtime.prefix_cache import tree_bytes

    one, two = (tree_bytes(lm.init_cache(mcfg, 1, n, "meta")) for n in (1, 2))
    per_pos, state = two - one, 2 * one - two
    total = 0
    for prompt, _ in traffic:
        for p in [*range(chunk, len(prompt), chunk), len(prompt)]:
            total += state + p * per_pos + 4 * mcfg.vocab
    return total


def serve_async(srv, traffic) -> dict:
    """Every request of ``traffic`` at once through ``AsyncServer`` (its
    ticks on the front-end's tick thread); the tokens by request index."""
    from repro_torch.runtime import AsyncServer, Request

    async def drive():
        front = AsyncServer(srv)
        try:
            return await asyncio.gather(*(front.generate(Request(
                uid=i, prompt=list(p), max_new_tokens=n)) for i, (p, n) in enumerate(traffic)))
        finally:
            front.close()

    return {r.uid: list(r.out_tokens) for r in asyncio.run(drive())}


def serve_zamba2(mcfg, params, dev, card: str, traffic, checked, *,
                 max_seq: int = ZAMBA_MAX_SEQ, chunk: int = ZAMBA_CHUNK,
                 profiled: int = ZAMBA_PROFILED) -> dict:
    """zamba2's main path: ``serve_long_prompts`` with a prefix cache sized
    by ``checkpoint_bytes`` and the logits bar ``ZAMBA_LOGITS_RTOL``; then
    adaptive prefill under ``step_block()`` with the cache, and chunked
    prefill under ``AsyncServer``, each with ``step()``'s tokens; and one
    ``step()`` serve of the first ``profiled``
    requests under torch.profiler (the device only): busy ms, idle share
    over the run's wall and the top five kernels.  Returns the kernel's
    counts and the phase's peak allocation."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime import DecodeServer

    budget = checkpoint_bytes(mcfg, traffic, chunk)
    say("serve_budget", arch=mcfg.name, prefix_cache_bytes=budget,
        why="every chunk-boundary and prompt-end checkpoint of the cold chunked pass")
    out = serve_long_prompts(mcfg, params, dev, card, traffic, checked, max_seq=max_seq,
                             chunk=chunk, prefix_bytes=budget, rtol=ZAMBA_LOGITS_RTOL)
    with torch.no_grad():
        toks, srv, _ = dense_serve(mcfg, params, traffic,
                                   f"step_block+adaptive+prefill_chunk={chunk}+cache", dev,
                                   card, block=True, max_seq=max_seq, prefill_chunk=chunk,
                                   prefill_adaptive=True, prefix_cache_bytes=budget)
        del srv
        require(toks == out["tokens"],
                f"{mcfg.name}: adaptive prefill's tokens differ from step()'s")
        srv = DecodeServer(mcfg, params, num_slots=SERVE_SLOTS, max_seq=max_seq,
                           block_k=BLOCK_K, prefill_chunk=chunk, device=dev)
        sync(dev)
        t0 = time.perf_counter()
        toks = serve_async(srv, traffic)
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
        st = srv.stats()
        del srv
    require(toks == out["tokens"], f"{mcfg.name}: AsyncServer's tokens differ from step()'s")
    say("serve", arch=mcfg.name, driver=f"AsyncServer+prefill_chunk={chunk}",
        requests=len(toks), wall_ms=f"{wall_ms:.1f}", decoded_tokens=st["decoded_tokens"],
        syncs_per_token=f"{st['decode_syncs'] / max(st['decoded_tokens'], 1):.4f}",
        identical_tokens=True, card=repr(card))
    sub = traffic[:profiled]
    act = ProfilerActivity.CUDA if dev.type == "cuda" else ProfilerActivity.CPU
    with torch.no_grad(), profile(activities=[act]) as prof:
        sync(dev)
        t0 = time.perf_counter()
        toks, srv, _ = dense_serve(mcfg, params, sub, "step(profiled)", dev, card,
                                   max_seq=max_seq)
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    del srv
    require(toks == {i: out["tokens"][i] for i in range(len(sub))},
            f"{mcfg.name}: the profiled step() run's tokens differ")
    kind = torch.autograd.DeviceType.CUDA if dev.type == "cuda" else torch.autograd.DeviceType.CPU
    kernels = device_kernels(prof, kind)
    busy_ms = sum(us for _, _, us in kernels) / 1e3
    say("profile", arch=mcfg.name, driver="step",
        prompts=",".join(str(len(p)) for p, _ in sub), wall_ms=f"{wall_ms:.1f}",
        device_busy_ms=f"{busy_ms:.1f}" if kernels else "not_measured",
        device_idle_share=f"{1 - busy_ms / wall_ms:.3f}" if kernels else "not_measured",
        card=repr(card))
    for key, calls, us in kernels[:5]:
        say("profile_top", arch=mcfg.name, kernel=repr(key[:70]), calls=calls,
            device_ms=f"{us / 1e3:.2f}", share=f"{us / 1e3 / busy_ms:.3f}")
    out["peak_bytes"] = max(out["peak_bytes"], torch.cuda.max_memory_allocated(dev)
                            if dev.type == "cuda" else 0)
    return {k: out[k] for k in ("calls", "window_calls", "launches", "peak_bytes")}


@contextlib.contextmanager
def pinned_routes(ids: list):
    """While open, the k-th ``moe.route`` call returns the expert ids
    ``ids[k]`` (another run's decisions, in depth order), with weights from
    this run's own router probabilities at those ids, renormalised: the
    output then moves continuously with the weights, with no top-k switch.
    ``moe_apply`` looks ``route`` up on its module at every call."""
    from repro_torch.models import moe

    orig, it = moe.route, iter(ids)

    def pinned(p, cfg, x, data=None):      # data: a data mesh's share (not used here)
        e = next(it).reshape(x.shape[:-1] + (cfg.top_k,))
        w = torch.softmax(x.float() @ p["router"], dim=-1).gather(-1, e)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        return e, w.to(x.dtype), torch.zeros((), device=x.device)

    moe.route = pinned
    try:
        yield
    finally:
        moe.route = orig


@contextlib.contextmanager
def record_routes():
    """While open, every MoE block's ``moe_apply`` first calls
    ``moe.route`` on its input (the block's normed input) and appends
    ``(top-k ids [T, k], top-(k+1) probabilities [T, k+1])`` to the yielded
    list, in depth order; the block's output is ``moe_apply``'s own.  The
    transformer looks ``moe_apply`` up on its module at every call, so the
    spy is installed there and ``moe_apply``'s signature is untouched."""
    from repro_torch.models import moe

    log: list = []
    orig = moe.moe_apply

    def spy(p, cfg, x, group_size=moe.DEFAULT_GROUP_SIZE):
        xf = x.reshape(-1, x.shape[-1])
        ids, _, _ = moe.route(p, cfg, xf)
        probs = torch.softmax(xf.float() @ p["router"], dim=-1)
        log.append((ids, torch.topk(probs, cfg.top_k + 1, dim=-1).values))
        return orig(p, cfg, x, group_size)

    moe.moe_apply = spy
    try:
        yield log
    finally:
        moe.moe_apply = orig


def route_flips(log_a, log_b) -> dict:
    """Two runs' routing decisions compared layer by layer: the number of
    (token, layer, choice) decisions that differ and, at the first layer
    with any, each differing token's first differing choice j and its
    margin ``p_j - p_(j+1)`` in run a's probabilities (the gap between the
    two experts that swapped; for j = k-1 the k-th minus the (k+1)-th).
    Later layers read a residual stream that the first flip has already
    moved by O(1e-2), so their flips are counted, not held."""
    require(len(log_a) == len(log_b), f"route logs of {len(log_a)} and {len(log_b)} blocks")
    n, first = 0, None
    for layer, ((ea, pa), (eb, _)) in enumerate(zip(log_a, log_b)):
        diff = ea != eb
        n += int(diff.sum())
        if first is None and bool(diff.any()):
            toks = diff.any(-1).nonzero()[:, 0]
            j = diff[toks].int().argmax(-1)[:, None]
            margins = (pa[toks].gather(1, j) - pa[toks].gather(1, j + 1))[:, 0]
            first = {"layer": layer, "token": int(toks[0]), "choice": int(j[0]),
                     "tokens": int(toks.numel()), "margin": float(margins[0]),
                     "max_margin": float(margins.max())}
    return {"flips": n, "first": first}


def moe_prefill_against_plain(mcfg, params, prompts, dev, card: str,
                              rtol: float = MOE_LOGITS_RTOL) -> dict:
    """Each prompt's one-shot prefill through the kernel path against
    ``use_pallas=False``, both under ``record_routes``: the routing
    decisions that differ between the two, then the logits within ``rtol``
    of max |logit| where none differ, or, where some do, every flip of the
    first flipping layer a near-tie (margin below ``ROUTE_MARGIN``); the
    kernel's calls and launches held to ``fa_per_prefill``; each
    prefill's ms (the route spy's router GEMM included) and transient
    memory.  Returns the largest gap held, the flips, the kernel's counts
    and the peak allocation."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import lm, moe

    out = {"gap": 0.0, "flips": 0, "calls": 0, "launches": 0, "peak": 0, "gaps": {},
           "absorbed_gaps": {}}
    pcfg = dataclasses.replace(mcfg, use_pallas=False)
    for prompt in prompts:
        toks = torch.as_tensor([prompt], device=dev)
        sync(dev)
        extra = {}
        if dev.type == "cuda":
            out["peak"] = max(out["peak"], torch.cuda.max_memory_allocated(dev))
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        fa = fa_ops.flash_attention
        fa.calls = fa.window_calls = fa.launches = 0
        with torch.no_grad(), record_routes() as log_k:
            t0 = time.perf_counter()
            lg_k, _ = lm.prefill(params, mcfg, toks)
            sync(dev)
            k_ms = (time.perf_counter() - t0) * 1e3
        if dev.type == "cuda":
            extra["transient_gb"] = f"{(torch.cuda.max_memory_allocated(dev) - base) / 1e9:.2f}"
        calls, win, launches = fa.calls, fa.window_calls, fa.launches
        with torch.no_grad(), record_routes() as log_p:
            t0 = time.perf_counter()
            lg_p, _ = lm.prefill(params, pcfg, toks)
            sync(dev)
            p_ms = (time.perf_counter() - t0) * 1e3
        want = fa_per_prefill(mcfg, len(prompt), dev)
        require((calls, win, launches) == want,
                f"{mcfg.name} prefill of {len(prompt)} tokens: flash_attention calls, "
                f"windowed calls, launches {(calls, win, launches)}, not {want}")
        require(lg_k.shape == (1, mcfg.vocab) and bool(torch.isfinite(lg_k).all()),
                f"{mcfg.name} prefill logits of shape {tuple(lg_k.shape)} or non-finite")
        fl = route_flips(log_k, log_p)
        scale = float(lg_p.abs().max())
        gap = float((lg_k - lg_p).abs().max()) / scale
        if fl["flips"] == 0:
            require(gap <= rtol, f"{mcfg.name} use_pallas prefill logits of {len(prompt)} "
                    f"tokens differ from the plain path by {gap:.3e} of max |logit| {scale:.3e}"
                    " with equal routing")
            out["gap"] = max(out["gap"], gap)
        else:
            first = fl["first"]
            require(first["max_margin"] < ROUTE_MARGIN,
                    f"{mcfg.name} prefill of {len(prompt)} tokens: the kernel and plain paths "
                    f"route differently at layer {first['layer']} with a margin of "
                    f"{first['max_margin']:.3e}, not a near-tie (< {ROUTE_MARGIN})")
            extra |= {f"first_flip_{k}": v for k, v in first.items()}
        out["gaps"][len(prompt)] = gap if fl["flips"] == 0 else f"flip:{gap:.3e}"
        if mcfg.use_mla:
            # MLA has no kernel: the spread of two correct plain paths is the
            # naive prefill's against the absorbed one (the prompt as one chunk)
            with torch.no_grad(), record_routes() as log_a:
                lg_a, _ = lm.prefill_chunk(params, pcfg, toks,
                                           lm.init_cache(pcfg, 1, len(prompt), dev), 0)
            fa_ = route_flips(log_p, log_a)
            gap_a = float((lg_a - lg_p).abs().max()) / scale
            out["absorbed_gaps"][len(prompt)] = gap_a if fa_["flips"] == 0 else \
                f"flip:{gap_a:.3e}"
            extra["naive_vs_absorbed"] = out["absorbed_gaps"][len(prompt)]
            del lg_a, log_a
        say("prefill_check", arch=mcfg.name, prompt_len=len(prompt),
            moe_group=moe.group_size_of(len(prompt), mcfg.moe_group_size or 2048),
            flash_attention_calls=calls, launches=launches, route_flips=fl["flips"],
            rel_gap=f"{gap:.3e}", rtol_of_max=rtol if fl["flips"] == 0 else "not_held:flip",
            prefill_ms_use_pallas=f"{k_ms:.2f}", prefill_ms_plain=f"{p_ms:.2f}", **extra,
            card=repr(card))
        out["flips"] += fl["flips"]
        out["calls"] += calls
        out["launches"] += launches
        del lg_k, lg_p, log_k, log_p
    if dev.type == "cuda":
        out["peak"] = max(out["peak"], torch.cuda.max_memory_allocated(dev))
    return out


def greedy_under_route_rule(mcfg, params, prompt, served, n: int, max_seq: int, dev) -> str:
    """The served tokens against ``plain_greedy``: equal, or, where they part,
    explained by a routing near-tie between the served one-shot prefill and
    the plain loop's prefill (``route_flips``' first flipping layer all
    below ``ROUTE_MARGIN``); anything else fails."""
    from repro_torch.models import lm

    want = plain_greedy(mcfg, params, prompt, n, max_seq, dev)
    if served == want:
        return "equal"
    toks = torch.as_tensor([prompt], device=dev)
    pcfg = dataclasses.replace(mcfg, use_pallas=False)
    with torch.no_grad(), record_routes() as log_a:
        lm.prefill(params, mcfg, toks)
    with torch.no_grad(), record_routes() as log_b:
        lm.prefill_chunk(params, pcfg, toks, lm.init_cache(pcfg, 1, max_seq, dev), 0)
    first = route_flips(log_a, log_b)["first"] or {"layer": None, "max_margin": math.inf}
    require(first["max_margin"] < ROUTE_MARGIN,
            f"{mcfg.name}: the served tokens of the {len(prompt)}-token request differ from the "
            f"plain greedy loop's without a routing near-tie ({first}):\n{served}\n{want}")
    return f"near_tie(layer={first['layer']},margin={first['max_margin']:.2e})"


def serve_moe(mcfg, params, dev, card: str, traffic, checked, *,
              max_seq: int = MOE_MAX_SEQ, chunk: int = MOE_CHUNK,
              record: dict | None = None) -> dict:
    """An MoE model's main path: ``traffic`` under one-shot ``step()`` and
    ``step_block()`` (equal tokens), chunked ``step()`` without the prefix
    cache and twice with one sized by ``checkpoint_bytes`` (equal tokens
    across the three, the second pass all full hits), the chunked tokens'
    agreement with the one-shot ones printed (chunk-local groups drop other
    tokens, so it is not held), the requests at ``checked`` under
    ``greedy_under_route_rule``, and every distinct prompt's prefill
    through ``moe_prefill_against_plain``.  Returns the kernel's counts
    over the runs, ``step()``'s tokens, the flips and the peak allocation;
    ``record`` gets the ``step()`` run's logits and routing decisions by
    request and position (``served_logits``, ``served_routes``), its
    tokens, traffic and speeds, and each prefill length's gap between two
    correct plain-path controls (the kernel against the plain attention;
    under MLA, which has no kernel, the naive prefill against the
    absorbed one): phase 27's oracle."""
    budget = checkpoint_bytes(mcfg, traffic, chunk)
    say("serve_budget", arch=mcfg.name, prefix_cache_bytes=budget,
        why="every chunk-boundary and prompt-end checkpoint of the cold chunked pass")
    total = np.zeros(3, np.int64)
    runs = {}
    with torch.no_grad():
        for label, block in (("step", False), ("step_block", True)):
            runs[label], srv, counts = dense_serve(mcfg, params, traffic, label, dev, card,
                                                    block=block, max_seq=max_seq,
                                                    record=record if label == "step" else None)
            total += counts
            del srv
        require(runs["step_block"] == runs["step"],
                f"{mcfg.name}: step_block's tokens differ from step()'s")
        label = f"step+prefill_chunk={chunk}"
        runs["chunked"], srv, counts = dense_serve(mcfg, params, traffic, label, dev, card,
                                                    max_seq=max_seq, prefill_chunk=chunk)
        total += counts
        del srv
        runs["chunked_cache"], srv, counts = dense_serve(
            mcfg, params, traffic, label + "+cache", dev, card, max_seq=max_seq,
            prefill_chunk=chunk, prefix_cache_bytes=budget)
        total += counts
        first = srv.stats()["prefix_cache"]
        require(first["partial_hits"] >= 1 and first["evictions"] == 0,
                f"{mcfg.name}: the cold chunked pass found {first['partial_hits']} partial hits "
                f"(the shared prefix) and evicted {first['evictions']} checkpoints")
        runs["chunked_again"], srv, counts = dense_serve(
            mcfg, params, traffic, label + "+cache (second pass)", dev, card, srv=srv, uid0=1000)
        total += counts
        st = srv.stats()
        require(st["prefix_cache"]["hits"] == len(traffic)
                and st["prefill"]["prompt_steps_computed"] == 0,
                f"{mcfg.name}: the second pass hit {st['prefix_cache']['hits']} of "
                f"{len(traffic)} prompts and ran {st['prefill']['prompt_steps_computed']} "
                "prompt steps")
        del srv
        for label in ("chunked_cache", "chunked_again"):
            require(runs[label] == runs["chunked"],
                    f"{mcfg.name}: {label} tokens differ from the uncached chunked run's")
        same = sum(runs["chunked"][i] == runs["step"][i] for i in runs["step"])
        tok_eq = sum(a == b for i in runs["step"] for a, b in zip(runs["chunked"][i],
                                                                   runs["step"][i]))
        say("chunked_vs_one_shot", arch=mcfg.name, requests_equal=f"{same}/{len(traffic)}",
            tokens_equal=f"{tok_eq}/{sum(n for _, n in traffic)}",
            why="chunk-local MoE groups drop other tokens than one-shot groups; not held")
        greedy = [greedy_under_route_rule(mcfg, params, traffic[i][0], runs["step"][i],
                                          traffic[i][1], max_seq, dev) for i in checked]
        distinct = list({len(p): p for p, _ in traffic}.values())
        pre = moe_prefill_against_plain(mcfg, params, distinct, dev, card)
        total += (pre["calls"], 0, pre["launches"])
        if record is not None:
            record.update(traffic=traffic, tokens=runs["step"],
                          control="naive_vs_absorbed" if mcfg.use_mla else "kernel_vs_plain",
                          control_gaps=pre["absorbed_gaps"] if mcfg.use_mla else pre["gaps"])
    say("serve_check", arch=mcfg.name, path="use_pallas", identical_tokens="step=step_block",
        chunked_runs_identical=True,
        plain_greedy=",".join(f"{len(traffic[i][0])}+{traffic[i][1]}:{g}"
                              for i, g in zip(checked, greedy)),
        prefill_lengths=",".join(str(len(p)) for p in distinct), route_flips=pre["flips"],
        max_rel_gap=f"{pre['gap']:.3e}", rtol_of_max=MOE_LOGITS_RTOL,
        flash_attention_calls=int(total[0]), launches=int(total[2]), card=repr(card))
    return {"calls": int(total[0]), "window_calls": int(total[1]), "launches": int(total[2]),
            "tokens": runs["step"], "flips": pre["flips"], "peak_bytes": pre["peak"],
            "oracle": record}


def quantize_olmoe(mcfg, params, dev, card: str, prompt) -> tuple:
    """Weight-only int8 on the card: the fp32 logits of ``prompt`` (every
    position) and its routing decisions, ``quantize_lm_params`` with its
    stats, and the codes and scales of an expert ``w_in``, ``attn/wq``
    (group 0 of each) and ``embed`` bit-identical to the same leaves
    quantized on the host's CPU; the router stays fp32.  Returns (quantized
    tree, fp32 logits, fp32 route log)."""
    from repro_torch.core.quantization import quantize_int8
    from repro_torch.models import lm
    from repro_torch.runtime.quantized import quantize_lm_params

    with torch.no_grad(), record_routes() as routes:
        lf, _ = lm.forward(params, mcfg, torch.as_tensor([prompt], device=dev))
    with torch.no_grad():
        sync(dev)
        t0 = time.perf_counter()
        qp, stats = quantize_lm_params(params)
        sync(dev)
    q_s = time.perf_counter() - t0
    say("quantize", arch=mcfg.name, seconds=f"{q_s:.2f}", **stats, card=repr(card))
    blk, qblk = params["groups"]["b0_moe"], qp["groups"]["b0_moe"]
    for name, w, q in (("groups/b0_moe/moe/w_in[0]", blk["moe"]["w_in"][0], qblk["moe"]["w_in"]),
                       ("groups/b0_moe/attn/wq[0]", blk["attn"]["wq"][0], qblk["attn"]["wq"]),
                       ("embed/table", params["embed"]["table"], qp["embed"]["table"])):
        codes, scale = quantize_int8(w.cpu(), axis=-2)
        got_codes, got_scale = q["__int8__"], q["scale"]
        if name.endswith("[0]"):
            got_codes, got_scale = got_codes[0], got_scale[0]
        same = torch.equal(got_codes.cpu(), codes) and torch.equal(got_scale.cpu(), scale)
        require(same, f"int8 codes or scales of {name} on the card differ from the CPU's")
        say("quantize_vs_cpu", leaf=name, shape="x".join(map(str, w.shape)), bit_identical=True)
    router = qblk["moe"]["router"]
    require(isinstance(router, torch.Tensor) and router.dtype == torch.float32,
            f"{mcfg.name}: the router was quantized or cast")
    return qp, lf, routes


def int8_logits_quality(lf, lq) -> tuple[float, float]:
    """The reference's quantized-serving metrics over every position:
    the mean per-vocabulary-column SNR of ``lq`` against ``lf`` in dB
    (``output_snr_db``, the paper's Fig. 11 metric) and the share of
    positions whose argmax agrees."""
    from repro_torch.core.quantization import output_snr_db

    a, b = lf[0].double().cpu().numpy(), lq[0].double().cpu().numpy()
    return float(np.mean(output_snr_db(a, b))), float(np.mean(a.argmax(-1) == b.argmax(-1)))


def serve_dequantized(mcfg, dq, lf, routes, prompt, dev, card: str, traffic,
                      fp32_tokens) -> dict:
    """The dequantized int8 tree ``dq``: print the logits of ``prompt``
    against its fp32 logits ``lf`` (SNR and greedy agreement, the reference's metrics)
    with the int8 model's own routing, whose decisions against the fp32
    ``routes`` are counted by layer, and with the routing pinned to
    ``routes`` (``pinned_routes``); hold the dequantized model's prefill
    through the kernel against the plain path (``moe_prefill_against_plain``)
    and ``traffic`` under ``step()`` and ``step_block()`` with equal tokens
    (their agreement with the fp32 model's printed).  The reference's bars
    (SNR above ``QUANT_SNR_DB``, agreement above ``QUANT_AGREE``) are printed
    beside the numbers but not held here: at olmoe's full width the
    reference's own quantization reroutes most tokens (PERF.md §6).
    Returns the kernel's counts."""
    from repro_torch.models import lm

    toks = torch.as_tensor([prompt], device=dev)
    with torch.no_grad(), record_routes() as free_routes:
        lq, _ = lm.forward(dq, mcfg, toks)
    with torch.no_grad(), pinned_routes([e for e, _ in routes]):
        lp, _ = lm.forward(dq, mcfg, toks)
    by_layer = [int((ea != eb).any(-1).sum()) for (ea, _), (eb, _) in zip(routes, free_routes)]
    sets = [int((ea.sort(-1).values != eb.sort(-1).values).any(-1).sum())
            for (ea, _), (eb, _) in zip(routes, free_routes)]
    free, pinned = int8_logits_quality(lf, lq), int8_logits_quality(lf, lp)
    del lq, lp
    say("quantized_logits", arch=mcfg.name, prompt_len=len(prompt),
        snr_db_free=f"{free[0]:.2f}", greedy_agreement_free=f"{free[1]:.4f}",
        snr_db_pinned=f"{pinned[0]:.2f}", greedy_agreement_pinned=f"{pinned[1]:.4f}",
        reference_bars=f"snr>{QUANT_SNR_DB},agree>{QUANT_AGREE} (printed, not held)",
        tokens_rerouted_by_layer=",".join(map(str, by_layer)),
        tokens_with_another_expert_set_by_layer=",".join(map(str, sets)), card=repr(card))
    pre = moe_prefill_against_plain(mcfg, dq, [prompt], dev, card)
    total = np.array([pre["calls"], 0, pre["launches"]], np.int64)
    runs = {}
    with torch.no_grad():
        for label, block in (("int8 step", False), ("int8 step_block", True)):
            # each serve starts from an unfragmented pool: its 2050-token
            # prefill runs groups of 2 tokens, ~12 GiB of expert activations
            # a layer, on top of the resident tree
            torch.cuda.empty_cache()
            runs[label], srv, counts = dense_serve(mcfg, dq, traffic, label, dev, card,
                                                    block=block, max_seq=MOE_MAX_SEQ)
            total += counts
            del srv
    require(runs["int8 step"] == runs["int8 step_block"],
            f"{mcfg.name} int8: step_block's tokens differ from step()'s")
    same = sum(runs["int8 step"][i] == fp32_tokens[i] for i in fp32_tokens)
    say("serve_check", arch=mcfg.name, path="int8 weights (dequantized)",
        identical_tokens="step=step_block", requests_equal_to_fp32=f"{same}/{len(traffic)}",
        prefill_route_flips=pre["flips"], flash_attention_calls=int(total[0]),
        launches=int(total[2]), card=repr(card))
    return {"calls": int(total[0]), "launches": int(total[2])}


def quantize_dense_check(mcfg, dev, card: str, n: int = 256) -> tuple[float, float]:
    """A dense model at full width (no router): its weights quantized on the
    card, the logits of an ``n``-token prompt against fp32 under the
    reference's metrics.  Returns (SNR dB, greedy agreement)."""
    from repro_torch.models import lm
    from repro_torch.runtime.quantized import dequantize_lm_params, quantize_lm_params

    params = lm.init_params(mcfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    toks = torch.as_tensor(np.random.default_rng(2).integers(1, mcfg.vocab, (1, n)), device=dev)
    with torch.no_grad():
        lf, _ = lm.forward(params, mcfg, toks)
        qp, stats = quantize_lm_params(params)
        del params
        lq, _ = lm.forward(dequantize_lm_params(qp), mcfg, toks)
    snr, agree = int8_logits_quality(lf, lq)
    say("quantized_logits", arch=mcfg.name, prompt_len=n, snr_db=f"{snr:.2f}",
        greedy_agreement=f"{agree:.4f}", weights_quantized=stats["weights_quantized"],
        compression=f"{stats['compression']:.3f}",
        reference_bars=f"snr>{QUANT_SNR_DB},agree>{QUANT_AGREE}", card=repr(card))
    return snr, agree


def mla_check(mcfg, params, dev, card: str, S: int = 64) -> float:
    """One MLA layer (group 0's) at full width: the absorbed decode, token by
    token and as one S-token chunk, against the naive prefill, within 1e-5
    of max |out| (the reference's
    ``test_mla_absorbed_decode_equals_naive_prefill`` on the card)."""
    from repro_torch.models import attention

    p = {k: v[0] for k, v in params["groups"]["b0_moe"]["attn"].items()
         if isinstance(v, torch.Tensor)}
    p["kv_norm"] = {"scale": params["groups"]["b0_moe"]["attn"]["kv_norm"]["scale"][0]}
    x = torch.randn((1, S, mcfg.d_model), generator=torch.Generator(device=dev).manual_seed(5),
                    device=dev)
    with torch.no_grad():
        naive, _ = attention.mla_prefill(p, mcfg, x)
        empty = {"c_kv": torch.zeros((1, S, mcfg.kv_lora_rank), device=dev),
                 "k_rope": torch.zeros((1, S, mcfg.qk_rope_head_dim), device=dev)}
        cache, outs = empty, []
        for t in range(S):
            o, cache = attention.mla_decode(p, mcfg, x[:, t:t + 1], cache, t)
            outs.append(o)
        chunk, _ = attention.mla_decode(p, mcfg, x, empty, 0)
    scale = float(naive.abs().max())
    gaps = [float((torch.cat(outs, 1) - naive).abs().max()) / scale,
            float((chunk - naive).abs().max()) / scale]
    require(max(gaps) <= 1e-5, f"{mcfg.name} MLA absorbed decode vs naive prefill: {gaps}")
    say("mla_check", arch=mcfg.name, tokens=S, r=mcfg.kv_lora_rank, dr=mcfg.qk_rope_head_dim,
        rel_gap_token_by_token=f"{gaps[0]:.3e}", rel_gap_chunk=f"{gaps[1]:.3e}",
        rtol_of_max=1e-5, card=repr(card))
    return max(gaps)


def serve_moe_phase(dev, card: str) -> dict:
    """Phase 20: olmoe-1b-7b uncut through ``serve_moe``,
    then its int8 weights (``quantize_olmoe``, the fp32 tree freed, the
    dequantized tree through ``serve_dequantized`` once the codes are freed) and smollm-135m's (``quantize_dense_check``, held
    to the reference's bars), then deepseek-v2-lite-16b (``DEEPSEEK_LAYERS``)
    (``mla_check``, ``serve_moe``).  Returns the ``flash_attention`` calls
    and launches by run."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.runtime.quantized import dequantize_lm_params

    ocfg = dataclasses.replace(get_config("olmoe-1b-7b"), n_layers=OLMOE_LAYERS, use_pallas=True)
    require((ocfg.n_layers, ocfg.d_model, ocfg.n_heads, ocfg.n_kv_heads, ocfg.head_dim,
             ocfg.qk_norm, ocfg.n_experts, ocfg.top_k, ocfg.n_shared_experts, ocfg.d_ff_expert,
             ocfg.capacity_factor, ocfg.vocab, ocfg.tie_embeddings, ocfg.layer_pattern)
            == (OLMOE_LAYERS, 2048, 16, 16, 128, True, 64, 8, 0, 1024, 1.25, 50_304, False,
                ("moe",)) and get_config("olmoe-1b-7b").n_layers == 16,
            f"olmoe-1b-7b is not at its published widths and depth: {ocfg}")
    torch.cuda.reset_peak_memory_stats()
    base_alloc = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    oparams = lm.init_params(ocfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    o_params = lm.param_count(oparams)
    require(o_params == OLMOE_PARAMS, f"olmoe-1b-7b has {o_params} parameters")
    traffic = long_prompt_traffic(ocfg.vocab, lengths=OLMOE_LENGTHS, shared=MOE_SHARED,
                                  cross=None, new=MOE_NEW)
    say("serve_setup", arch=ocfg.name, n_layers=ocfg.n_layers, d_model=ocfg.d_model,
        heads=f"{ocfg.n_heads}/{ocfg.n_kv_heads}", head_dim=ocfg.head_dim,
        experts=f"{ocfg.n_experts}x{ocfg.d_ff_expert} top{ocfg.top_k}", vocab=ocfg.vocab,
        params=o_params, param_gb=f"{4 * o_params / 1e9:.2f}", init_s=f"{init_s:.1f}",
        alloc_gb_before_init=f"{base_alloc / 1e9:.2f}",
        prompt_lens=",".join(f"{len(p)}+{n}" for p, n in traffic), num_slots=SERVE_SLOTS,
        max_seq=MOE_MAX_SEQ, block_k=BLOCK_K, chunk=MOE_CHUNK)
    long_prompt = traffic[OLMOE_LENGTHS.index(2048)][0]
    olmoe_fa = serve_moe(ocfg, oparams, dev, card, traffic,
                         [OLMOE_LENGTHS.index(2048), len(traffic) - 1], record={})
    say("serve_memory", arch=ocfg.name, peak_alloc_gb=f"{olmoe_fa['peak_bytes'] / 1e9:.2f}",
        card=repr(card))
    phase_done("serve_olmoe")
    qp, lf, routes = quantize_olmoe(ocfg, oparams, dev, card, long_prompt)
    del oparams
    # only the dequantized tree is served: the int8 codes (6.9 GB) go before
    # it runs (with them resident, a serve ran out of memory at 61.5 GiB
    # allocated and 14.7 GiB reserved but free)
    dq = dequantize_lm_params(qp)
    del qp
    torch.cuda.empty_cache()
    olmoe_q = serve_dequantized(ocfg, dq, lf, routes, long_prompt, dev, card, traffic,
                                olmoe_fa["tokens"])
    del dq, lf, routes
    torch.cuda.empty_cache()
    say("serve_memory", arch=f"{ocfg.name} int8",
        peak_alloc_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", card=repr(card))
    # the reference's bars where its own test holds them: a dense model
    # (no router), here at full width
    scfg = dataclasses.replace(get_config("smollm-135m"), use_pallas=True)
    snr, agree = quantize_dense_check(scfg, dev, card)
    require(snr > QUANT_SNR_DB and agree > QUANT_AGREE,
            f"{scfg.name} int8 at full width: logits SNR {snr:.2f} dB, greedy agreement "
            f"{agree:.4f} (bars {QUANT_SNR_DB}, {QUANT_AGREE})")
    torch.cuda.empty_cache()
    phase_done("serve_olmoe_int8")

    dcfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"), n_layers=DEEPSEEK_LAYERS,
                               use_pallas=True)
    require((dcfg.n_layers, dcfg.d_model, dcfg.n_heads, dcfg.use_mla, dcfg.kv_lora_rank,
             dcfg.qk_nope_head_dim, dcfg.qk_rope_head_dim, dcfg.v_head_dim, dcfg.n_experts,
             dcfg.top_k, dcfg.n_shared_experts, dcfg.d_ff_expert, dcfg.vocab, dcfg.layer_pattern)
            == (DEEPSEEK_LAYERS, 2048, 16, True, 512, 128, 64, 128, 64, 6, 2, 1408, 102_400,
                ("moe",)) and get_config("deepseek-v2-lite-16b").n_layers == 27,
            f"deepseek-v2-lite-16b is not at its published widths: {dcfg}")
    torch.cuda.reset_peak_memory_stats()
    base_alloc = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    dparams = lm.init_params(dcfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    d_params = lm.param_count(dparams)
    require(d_params == DEEPSEEK_PARAMS, f"deepseek-v2-lite-16b ({DEEPSEEK_LAYERS} layers) has "
                                         f"{d_params} parameters")
    traffic = long_prompt_traffic(dcfg.vocab, lengths=DEEPSEEK_LENGTHS, shared=MOE_SHARED,
                                  cross=None, new=MOE_NEW)
    say("serve_setup", arch=dcfg.name, n_layers=dcfg.n_layers, d_model=dcfg.d_model,
        heads=dcfg.n_heads, mla=f"r{dcfg.kv_lora_rank}+dr{dcfg.qk_rope_head_dim}",
        experts=f"{dcfg.n_shared_experts}+{dcfg.n_experts}x{dcfg.d_ff_expert} top{dcfg.top_k}",
        vocab=dcfg.vocab, params=d_params, param_gb=f"{4 * d_params / 1e9:.2f}",
        init_s=f"{init_s:.1f}", alloc_gb_before_init=f"{base_alloc / 1e9:.2f}",
        prompt_lens=",".join(f"{len(p)}+{n}" for p, n in traffic), num_slots=SERVE_SLOTS,
        max_seq=MOE_MAX_SEQ, block_k=BLOCK_K, chunk=MOE_CHUNK)
    mla_check(dcfg, dparams, dev, card)
    deepseek_fa = serve_moe(dcfg, dparams, dev, card, traffic,
                            [DEEPSEEK_LENGTHS.index(2048), len(traffic) - 1], record={})
    require(deepseek_fa["calls"] == deepseek_fa["launches"] == 0,
            f"deepseek-v2-lite-16b (MLA) called flash_attention {deepseek_fa['calls']} times")
    say("serve_memory", arch=dcfg.name, peak_alloc_gb=f"{deepseek_fa['peak_bytes'] / 1e9:.2f}",
        card=repr(card))
    del dparams
    torch.cuda.empty_cache()
    phase_done("serve_deepseek")
    return {"olmoe": olmoe_fa, "olmoe_int8": olmoe_q, "deepseek": deepseek_fa}


# ---------------------------------------------------------------------------
# phase 21: training on the card
# ---------------------------------------------------------------------------

def kernel_counts() -> dict:
    """Every kernel wrapper's launch counter (and ``flash_attention``'s calls)."""
    from repro_torch.codegen import kernel_backend
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.int8_matmul import ops as i8_ops
    from repro_torch.kernels.lstm_cell import ops as lstm_ops
    from repro_torch.kernels.ssm_scan import ops as scan_ops
    from repro_torch.kernels.tanh_lut import ops as lut_ops

    return {"lstm_seq": lstm_ops.lstm_seq.launches, "ssm_scan": scan_ops.ssm_scan.launches,
            "flash_attention": fa_ops.flash_attention.launches,
            "flash_attention.calls": fa_ops.flash_attention.calls,
            "tanh_lut": lut_ops.tanh_lut.launches, "int8_matmul": i8_ops.int8_matmul.launches,
            "codegen_stage": kernel_backend.codegen_stage.launches}


def train_batch(vocab: int, B: int, S: int, dev, seed: int = 0) -> dict:
    """A ``TokenPipeline`` batch (the trainer's data) as tensors on ``dev``."""
    from repro_torch.data import DataConfig, TokenPipeline

    b = TokenPipeline(DataConfig(vocab=vocab, seq_len=S, global_batch=B, seed=seed)).batch_at(0)
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def grads_on(mcfg, params, batch):
    from repro_torch.optim.adamw import value_and_grad
    from repro_torch.models import lm

    return value_and_grad(lambda p, b: lm.train_loss(p, mcfg, b), params, batch)


def card_against_cpu(mcfg, params, dev, card: str, B: int, S: int,
                     batch: dict | None = None) -> tuple[float, float]:
    """One ``train_loss`` and its gradients on the card and on the host's CPU
    (the same parameters and batch: ``train_batch``'s B x S tokens unless
    ``batch`` is given): the loss gap relative to the loss and the worst
    per-leaf gradient gap as a share of that leaf's max |g|."""
    from repro_torch._tree import tree_map
    from repro_torch.checkpoint.checkpoint import flatten_with_names

    if batch is None:
        batch = train_batch(mcfg.vocab, B, S, dev, seed=1)
    t0 = time.perf_counter()
    (l_g, _), g_g = grads_on(mcfg, params, batch)
    sync(dev)
    card_s = time.perf_counter() - t0
    host = torch.device("cpu")
    t0 = time.perf_counter()
    (l_c, _), g_c = grads_on(mcfg, tree_map(lambda t: t.to(host), params),
                             tree_map(lambda t: t.to(host), batch))
    cpu_s = time.perf_counter() - t0
    loss_gap = abs(float(l_g) - float(l_c)) / abs(float(l_c))
    got, want = flatten_with_names(g_g), flatten_with_names(g_c)
    gaps = {k: float(np.abs(got[k] - w).max()) / max(float(np.abs(w).max()), 1e-30)
            for k, w in want.items()}
    worst = max(gaps, key=gaps.get)
    say("train_vs_cpu", arch=mcfg.name, B=B, S=S, loss_card=float(l_g), loss_cpu=float(l_c),
        loss_rel_gap=f"{loss_gap:.3e}", worst_grad_leaf=worst,
        worst_grad_gap_of_max=f"{gaps[worst]:.3e}", leaves=len(gaps),
        card_s=f"{card_s:.2f}", cpu_s=f"{cpu_s:.2f}", card=card)
    require(loss_gap <= TRAIN_LOSS_RTOL,
            f"{mcfg.name} train_loss on the card {float(l_g)} against the CPU's {float(l_c)}")
    require(gaps[worst] <= TRAIN_GRAD_TOL,
            f"{mcfg.name} gradient leaf {worst}: the card and the CPU differ by "
            f"{gaps[worst]:.3e} of its max |g|")
    return loss_gap, gaps[worst]


def make_trainer(mcfg, dcfg, ckpt_dir: Path, dev, *, steps: int, micro: int,
                 fresh: bool = True, **tkw):
    """A ``Trainer`` on ``dev`` for ``steps`` steps, every step logged, its
    checkpoints under ``ckpt_dir`` (emptied first when ``fresh``)."""
    from repro_torch import optim
    from repro_torch.runtime import Trainer, TrainerConfig

    if fresh:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    tcfg = TrainerConfig(total_steps=steps, ckpt_dir=str(ckpt_dir), log_every=1,
                         microbatches=micro, **tkw)
    ocfg = optim.AdamWConfig(lr_peak=3e-4, warmup_steps=2, total_steps=max(steps, 3))
    return Trainer(mcfg, tcfg, ocfg, dcfg, device=dev)


def train_run(mcfg, dcfg, ckpt_dir: Path, dev, card: str, *, label: str, **kw):
    """``make_trainer(...).run()``, each step printed."""
    trainer = make_trainer(mcfg, dcfg, ckpt_dir, dev, **kw)
    t0 = time.perf_counter()
    res = trainer.run()
    sync(dev)
    tokens = dcfg.global_batch * dcfg.seq_len
    for m in res["metrics"]:
        say("train_step", arch=mcfg.name, run=label, step=m["step"], loss=f"{m['loss']:.4f}",
            ms=f"{1e3 * m['sec']:.1f}", tokens_per_s=f"{tokens / m['sec']:.0f}",
            grad_norm=f"{m['grad_norm']:.4f}", lr=f"{m['lr']:.3e}", card=card)
    say("train_run", arch=mcfg.name, run=label, steps=len(res["losses"]), tokens_per_step=tokens,
        microbatches=trainer.tcfg.microbatches, wall_s=f"{time.perf_counter() - t0:.2f}",
        entropy_floor=f"{res['entropy_floor']:.4f}")
    require(all(math.isfinite(x) for x in res["losses"]),
            f"{mcfg.name} {label}: non-finite losses {res['losses']}")
    return trainer, res


def nondeterministic_leaves(mcfg, params, dcfg, dev) -> list[str]:
    """The gradient leaves that differ between two backward passes on the
    same inputs: each names the op whose backward is not deterministic."""
    from repro_torch.checkpoint.checkpoint import flatten_with_names

    batch = train_batch(mcfg.vocab, dcfg.global_batch // 2, dcfg.seq_len, dev)
    a = flatten_with_names(grads_on(mcfg, params, batch)[1])
    b = flatten_with_names(grads_on(mcfg, params, batch)[1])
    return sorted(k for k in a if not np.array_equal(a[k], b[k]))


def refuses_under_grad(mcfg, params, dev, kernel: str) -> None:
    """``train_loss`` with ``use_pallas=True`` on the card: ``kernel``'s
    wrapper must raise in the forward pass, before a backward is reached
    (the kernels have no backward pass)."""
    refused = None
    try:
        grads_on(dataclasses.replace(mcfg, use_pallas=True), params,
                 train_batch(mcfg.vocab, 1, 64, dev))
    except NotImplementedError as e:
        refused = str(e)
    say("train_use_pallas", arch=mcfg.name, refused=refused is not None,
        message=repr((refused or "")[:100]))
    require(refused is not None and kernel in refused,
            f"{mcfg.name}: train_loss with use_pallas=True did not refuse in {kernel} "
            f"({refused})")


def restart_drill(mcfg, dev, card: str, root: Path) -> float:
    """Uninterrupted ``DRILL_STEPS`` steps (async checkpoints every 2)
    against a run that fails at ``DRILL_FAIL`` and a new ``Trainer`` that
    resumes from the newest checkpoint: the final parameters and optimizer
    state within ``DRILL_ATOL``; whether they are bit-identical is printed
    (and, if not, the gradient leaves whose backward is not)."""
    from repro_torch._tree import tree_leaves
    from repro_torch.data import DataConfig
    from repro_torch.runtime import SimulatedFailure

    dcfg = DataConfig(vocab=mcfg.vocab, seq_len=DRILL_SEQ, global_batch=TRAIN_BATCH)
    kw = dict(steps=DRILL_STEPS, micro=TRAIN_MICRO, ckpt_every=2, ckpt_async=True)
    ref, _ = train_run(mcfg, dcfg, root / "drill_ref", dev, card, label="uninterrupted", **kw)
    failing = make_trainer(mcfg, dcfg, root / "drill", dev, fail_at_step=DRILL_FAIL, **kw)
    failed = False
    try:
        failing.run()
    except SimulatedFailure:
        failed = True
    failing.ckpt.wait()      # the async write the failure left in flight
    require(failed, f"{mcfg.name}: fail_at_step={DRILL_FAIL} raised no SimulatedFailure")
    resumed = make_trainer(mcfg, dcfg, root / "drill", dev, fresh=False, **kw)
    res = resumed.run()
    want = tree_leaves((ref.params, ref.opt_state))
    got = tree_leaves((resumed.params, resumed.opt_state))
    gap = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want, strict=True))
    identical = all(torch.equal(a, b) for a, b in zip(got, want))
    culprits = [] if identical else nondeterministic_leaves(mcfg, ref.params, dcfg, dev)
    say("train_drill", arch=mcfg.name, seq_len=DRILL_SEQ, steps=DRILL_STEPS,
        failed_at=DRILL_FAIL, resumed_from=DRILL_STEPS - len(res["losses"]),
        max_abs_diff=f"{gap:.3e}", atol=DRILL_ATOL, bit_identical=identical,
        nondeterministic_grad_leaves=culprits, card=card)
    require(len(res["losses"]) == DRILL_STEPS - 2,
            f"{mcfg.name}: the resumed run took {len(res['losses'])} steps, not from step 2")
    require(gap <= DRILL_ATOL, f"{mcfg.name}: the resumed run's state differs from the "
            f"uninterrupted run's by {gap:.3e}")
    return gap


def train_phase(dev, card: str) -> dict:
    """Phase 21: smollm-135m at its published widths and depth through
    ``Trainer`` on train_4k-length steps, the restart drill, the card against
    the host's CPU, paper-lstm at full width and the ``use_pallas`` refusal
    (``launch.train`` runs in :func:`entry_points`); no kernel launched on
    the training path."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.models import lm

    root = ROOT / "build" / "train"
    before = kernel_counts()
    scfg = get_config("smollm-135m")
    require((scfg.n_layers, scfg.d_model, scfg.n_heads, scfg.n_kv_heads, scfg.d_ff, scfg.vocab,
             scfg.remat, scfg.use_pallas) == (30, 576, 9, 3, 1536, 49_152, True, False),
            f"smollm-135m is not at its published widths and depth: {scfg}")
    torch.cuda.reset_peak_memory_stats()
    dcfg = DataConfig(vocab=scfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    trainer, res = train_run(scfg, dcfg, root / "smollm", dev, card, steps=TRAIN_STEPS,
                             micro=TRAIN_MICRO, label="train_4k", ckpt_every=TRAIN_STEPS)
    n_params = lm.param_count(trainer.params)
    steady = sorted(m["sec"] for m in res["metrics"][1:])
    step_s = statistics.median(steady)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    say("train_smollm", params=n_params, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        microbatches=TRAIN_MICRO, first_step_ms=f"{1e3 * res['metrics'][0]['sec']:.1f}",
        steady_step_ms=f"{1e3 * step_s:.1f}",
        tokens_per_s=f"{TRAIN_SEQ * TRAIN_BATCH / step_s:.0f}",
        peak_alloc_gb=f"{peak_gb:.2f}", predicted_step_s="1.5-4", predicted_peak_gb="15-30",
        loss_first=f"{res['losses'][0]:.4f}", loss_last=f"{res['losses'][-1]:.4f}", card=card)
    require(n_params == 134_515_008, f"smollm-135m has {n_params} parameters")

    restart_drill(scfg, dev, card, root)
    card_against_cpu(scfg, trainer.params, dev, card, 1, CHECK_SEQ)

    refuses_under_grad(scfg, trainer.params, dev, "flash_attention")
    del trainer
    torch.cuda.empty_cache()

    # paper-lstm at full width: the recurrent plain path in train mode
    lcfg = get_config("paper-lstm")
    ltr, _ = train_run(lcfg, DataConfig(vocab=lcfg.vocab, seq_len=LSTM_TRAIN_SEQ,
                                         global_batch=TRAIN_BATCH),
                       root / "paper_lstm", dev, card, steps=LSTM_TRAIN_STEPS, micro=1,
                       label=f"T{LSTM_TRAIN_SEQ}", ckpt_every=LSTM_TRAIN_STEPS)
    require(lm.param_count(ltr.params) == 108_307_456,
            f"paper-lstm has {lm.param_count(ltr.params)} parameters")
    card_against_cpu(lcfg, ltr.params, dev, card, 1, LSTM_CHECK_SEQ)
    refuses_under_grad(lcfg, ltr.params, dev, "lstm_seq")
    del ltr
    torch.cuda.empty_cache()

    after = kernel_counts()
    say("train_kernels", launches_during_phase={k: after[k] - before[k] for k in after})
    require(after == before, f"a kernel launched on the training path: {before} -> {after}")
    return {"peak_gb": peak_gb, "step_s": step_s}



# ---------------------------------------------------------------------------
# 22. mesh: ShardPlan serving in both layouts, synthesize(mesh=), EP MoE
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def decode_logits_by_token(srv, rows):
    """``{(uid, position): logits}`` of every ``lm.decode_step`` call of
    ``srv`` for the requests in this process's slot ``rows``: a request's
    logits at each position, wherever the plan placed it (the first call at
    a position; a slot that retires inside a decode block idles there).
    The device tensors are kept and read after the run, so it is not
    synced."""
    from repro_torch.models import lm

    calls, inner = [], lm.decode_step

    def recorded(params, cfg, tokens, caches, pos):
        out = inner(params, cfg, tokens, caches, pos)
        calls.append(([None if srv.slot_req[b] is None else srv.slot_req[b].uid for b in rows],
                      pos.clone(), out[0]))
        return out

    got: dict = {}
    lm.decode_step = recorded
    try:
        yield got
    finally:
        lm.decode_step = inner
    for uids, pos, logits in calls:
        pos = pos.reshape(-1).cpu().numpy()
        logits = logits.float().reshape(len(uids), -1).cpu().numpy()
        for j, uid in enumerate(uids):
            if uid is not None:
                got.setdefault((uid, int(pos[j])), logits[j])


def gemm_bits_depend_on_rows(w: torch.Tensor, rows: int, part: int) -> bool:
    """Whether the card's GEMM gives the first ``part`` rows of a
    ``rows``-row product ``x @ w`` other bits than the ``part``-row
    product: a DP rank runs ``part`` of the unsharded ``rows``."""
    x = torch.randn(rows, w.shape[0], generator=torch.Generator(device=w.device).manual_seed(0),
                    device=w.device)
    return not torch.equal((x @ w)[:part], x[:part] @ w)


def logit_gap(got: dict, want: dict) -> tuple[float, float, bool]:
    """Over the (request, position) keys of ``got``, all of them in
    ``want``: max |got - want|, max |want|, and whether they are equal bit
    for bit."""
    missing = set(got) - set(want)
    require(got and not missing, f"logits of {len(missing)} of {len(got)} (request, position) "
                                 "keys missing from the plan=None run")
    g = np.stack([got[k] for k in sorted(got)])
    w = np.stack([want[k] for k in sorted(got)])
    return (float(np.abs(g - w).max()), float(np.abs(w).max()),
            bool(np.array_equal(g.view(np.int32), w.view(np.int32))))


def mesh_serve(cfg, params, prompts, dev, plan=None, block: bool = False) -> dict:
    """The 16 requests of phase 3 through ``DecodeServer(plan=)``: greedy
    tokens, the decode logits of the requests on this process's slots (by
    request and position), this process's ``lstm_seq`` launches, the
    requests placed on its shard, and decode tok/s from the decode spans
    (as ``serve``)."""
    from repro_torch.kernels.lstm_cell import ops as lstm_ops
    from repro_torch.obs import Observability
    from repro_torch.runtime.server import DecodeServer, Request

    obs = Observability(trace=True)
    srv = DecodeServer(cfg, params, num_slots=NUM_SLOTS, max_seq=MAX_SEQ, block_k=BLOCK_K,
                       obs=obs, plan=plan, device=dev)
    for i, p in enumerate(prompts):
        srv.submit(Request(uid=i, prompt=p, max_new_tokens=MAX_NEW))
    sync(dev)
    launches = lstm_ops.lstm_seq.launches
    mine = None if plan is None or plan.fold_data else plan.local_shard
    rows = range(NUM_SLOTS) if mine is None else plan.slots_of_shard(mine, NUM_SLOTS)
    t0 = time.perf_counter()
    with decode_logits_by_token(srv, rows) as logits:
        done = srv.run_until_drained(persistent=block)
        sync(dev)
        wall = time.perf_counter() - t0
    decode_s = sum(ev["dur"] for ev in obs.tracer.events()
                   if ev.get("name") in ("decode_step", "decode_block")) / 1e6
    st = srv.stats()
    return {"tokens": {r.uid: list(r.out_tokens) for r in done},
            "launches": lstm_ops.lstm_seq.launches - launches,
            "own_prefills": sum(1 for r in done if mine is None or r.shard == mine),
            "decode_tok_s": st["decoded_tokens"] / max(decode_s, 1e-9), "wall_s": wall,
            "by_shard": st.get("mesh", {}).get("decoded_tokens_by_shard"),
            "decoded": st["decoded_tokens"], "host_state": repr(srv.host_state()),
            "logits": logits}


def _rank_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def mesh_ranks_gloo(rank: int, world: int, dev_name: str, cfg, prompts, spec, tp_u,
                    spec_c, dp_u) -> dict:
    """One of ``world`` ranks sharing the card over gloo: sharded serving of
    phase 3's traffic under both drivers, the eager TP forward of ``spec``
    and ``synthesize(mesh=)`` on it, and the kernel backend's DP forward of
    ``spec_c``."""
    from repro_torch import codegen, obs
    from repro_torch.codegen import eager_backend, kernel_backend
    from repro_torch.core import synthesis
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.parallel import comm
    from repro_torch.runtime import ShardPlan

    dev = _rank_device(dev_name)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    dp_mesh = make_local_mesh(dp=world, tp=1)
    out = {}
    with torch.no_grad():
        for block in (False, True):
            out["block" if block else "step"] = mesh_serve(cfg, params, prompts, dev,
                                                           ShardPlan(dp_mesh), block)
        del params
        tp_mesh = make_local_mesh(dp=1, tp=world)
        prog = codegen.build_program(spec, dev)
        fwd = eager_backend.compile_program(prog, mesh=tp_mesh, device=dev)
        comm.reset_counts()
        t0 = time.perf_counter()
        out["tp_y"] = fwd(prog.params, torch.as_tensor(tp_u, device=dev)).cpu().numpy()
        out["tp_s"] = time.perf_counter() - t0
        out["tp_counts"] = dict(comm.COUNTS)
        del prog, fwd
        batch = tp_u.shape[0]
        # the forward was timed above: the report and the ledger key only
        report = synthesis.synthesize(spec, batch=batch, backend="eager", mesh=tp_mesh,
                                      fallback=False, measure=False, device=dev)
        key = synthesis._ledger_key(spec, batch, "eager", mesh=tp_mesh)
        [row] = obs.OBS.ledger.report(match=key)
        out["synth"] = (report.backend, report.output_shape, key, row["program"])
        prog_c = codegen.build_program(spec_c, dev)
        kfwd = kernel_backend.compile_program(prog_c, mesh=dp_mesh, device=dev)
        launches = kernel_backend.codegen_stage.launches
        comm.reset_counts()
        out["dp_y"] = kfwd(prog_c.params, torch.as_tensor(dp_u, device=dev)).cpu().numpy()
        out["dp_counts"] = dict(comm.COUNTS)
        out["dp_launches"] = kernel_backend.codegen_stage.launches - launches
    out["jax"] = "jax" in sys.modules
    return out


def mesh_ranks_nccl(rank: int, world: int, dev_name: str, cfg, prompts, mcfg) -> dict:
    """World size 1 under NCCL (NCCL refuses two ranks on one card): the
    sharded server (its control plane on a gloo group of its own) and
    ``ep_moe_apply`` at ``mcfg``'s expert widths, its two all-to-alls on
    NCCL."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm, moe
    from repro_torch.parallel import comm
    from repro_torch.parallel.ep_moe import ep_moe_apply
    from repro_torch.runtime import ShardPlan

    dev = _rank_device(dev_name)
    out = {"backend": torch.distributed.get_backend()}
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    with torch.no_grad():
        out["step"] = mesh_serve(cfg, params, prompts, dev,
                                 ShardPlan(make_local_mesh(dp=world, tp=1)), False)
        del params
        gen = torch.Generator(device=dev).manual_seed(0)
        p = moe.moe_params(gen, mcfg)
        x = torch.randn(MESH_EP_TOKENS, mcfg.d_model, generator=gen, device=dev) * 0.5
        mesh = make_local_mesh()                       # (1, 1, world): EP over "model"
        ep_moe_apply(p, mcfg, x, mesh)                 # warm-up: the process's first einsums
        comm.reset_counts()
        sync(dev)
        t0 = time.perf_counter()
        y = ep_moe_apply(p, mcfg, x, mesh)
        sync(dev)
        out["ep_s"] = time.perf_counter() - t0
        out["ep_counts"] = dict(comm.COUNTS)
        y_ref, _ = moe.moe_apply(p, mcfg, x[None], group_size=MESH_EP_TOKENS)
        out["ep_err"] = float((y - y_ref[0]).abs().max())
        out["ep_max_y"] = float(y_ref.abs().max())
        out["ep_shape"] = (mcfg.n_experts, mcfg.top_k, mcfg.d_model, mcfg.d_ff_expert)
    return out


def mesh_phase(dev, card: str, cfg, prompts, want_step, want_block, *, mcfg=None,
               width: int = WIDTH, rank_backend: str = "nccl") -> dict:
    """Phase 22: phase 3's full-width paper-lstm traffic under
    ``ShardPlan(fold_data=True)`` at dp = 8 in this process and sharded over
    two ranks on the card (gloo) and one under ``rank_backend`` (NCCL);
    ``synthesize(mesh=)`` with the eager backend's TP on a full-width lstm
    and the kernel backend's DP; EP MoE at ``mcfg``'s widths (olmoe's).
    Returns the kernel launches it made, by wrapper."""
    from repro_torch import codegen
    from repro_torch.codegen import eager_backend, kernel_backend
    from repro_torch.configs import get_config
    from repro_torch.core.synthesis import NetworkSpec
    from repro_torch.launch.mesh import AXES, AbstractMesh
    from repro_torch.launch.spawn import run_ranks
    from repro_torch.models import lm
    from repro_torch.runtime import ShardPlan

    mcfg = mcfg or get_config("olmoe-1b-7b")
    dev_name = "cuda:0" if dev.type == "cuda" else "cpu"
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    launches = {"lstm_seq": 0, "codegen_stage": 0}
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    n_req = len(prompts)
    with torch.no_grad():
        t0 = time.perf_counter()
        base = mesh_serve(cfg, params, prompts, dev)
        base_block = mesh_serve(cfg, params, prompts, dev, block=True)
        require(base["tokens"] == want_step and base_block["tokens"] == want_block,
                "mesh: the plan=None reruns differ from phase 3")
        want_logits = {"step": base.pop("logits"), "block": base_block.pop("logits")}
        # a sharded rank decodes B/dp of the B rows: does the card's GEMM (the
        # head's) give those rows other bits at B/dp rows?
        head = params["embed"]["table"].T if cfg.tie_embeddings else params["head"]["w"]
        row_dep = gemm_bits_depend_on_rows(head, NUM_SLOTS, NUM_SLOTS // MESH_RANKS)
        folded_plan = ShardPlan(AbstractMesh((1, MESH_FOLDED_DP, 1), AXES), fold_data=True)
        for block, want in ((False, want_step), (True, want_block)):
            r = mesh_serve(cfg, params, prompts, dev, folded_plan, block)
            driver = "step_block" if block else "step"
            require(r["tokens"] == want, f"mesh folded dp={MESH_FOLDED_DP} {driver}: tokens differ")
            want_l = want_logits["block" if block else "step"]
            gap, _, bit = logit_gap(r["logits"], want_l)
            require(bit and len(r["logits"]) == len(want_l),
                    f"mesh folded {driver}: logits of {len(r['logits'])} (request, position) "
                    f"keys, {gap:.3e} from plan=None's {len(want_l)}")
            require(r["launches"] == cfg.n_layers * n_req,
                    f"mesh folded {driver}: {r['launches']} lstm_seq launches, not "
                    f"{cfg.n_layers} x {n_req}")
            require(sum(r["by_shard"]) == r["decoded"] and sum(t > 0 for t in r["by_shard"]) > 1,
                    f"mesh folded {driver}: per-shard tokens {r['by_shard']} vs {r['decoded']}")
            launches["lstm_seq"] += r["launches"]
            say("mesh", case=f"folded_dp{MESH_FOLDED_DP}", driver=driver, identical_tokens=True,
                logits_bit_identical=True, lstm_seq_launches=r["launches"], decoded_by_shard=r["by_shard"],
                decode_tok_s=f"{r['decode_tok_s']:.1f}",
                plan_none_decode_tok_s=f"{base['decode_tok_s']:.1f}",
                seconds=f"{r['wall_s']:.2f}", card=repr(card))
        launches["lstm_seq"] += base["launches"] + base_block["launches"]
        del params

        # the unsharded references of the rank runs, built here first so that
        # the ranks load the generated library instead of racing to build it
        gen = np.random.default_rng(22)
        tp_u = gen.normal(size=(MESH_TP_BATCH, BIT_T, width)).astype(np.float32)
        spec = NetworkSpec(width, MESH_TP_LAYERS, width, width, cell="lstm", seq_len=BIT_T)
        prog = codegen.build_program(spec, dev)
        t1 = time.perf_counter()
        tp_want = eager_backend.compile_program(prog, device=dev)(
            prog.params, torch.as_tensor(tp_u, device=dev)).cpu().numpy()
        eager_s = time.perf_counter() - t1
        del prog
        dp_u = gen.normal(size=(MESH_DP_SPEC["c_slow"], MESH_DP_BATCH, MESH_DP_SPEC["seq_len"],
                                width)).astype(np.float32)
        spec_c = NetworkSpec(width, MESH_DP_SPEC["num_hidden_layers"], width, width,
                             cell="lstm", seq_len=MESH_DP_SPEC["seq_len"],
                             c_slow=MESH_DP_SPEC["c_slow"])
        prog_c = codegen.build_program(spec_c, dev)
        k0 = kernel_backend.codegen_stage.launches
        dp_want = kernel_backend.compile_program(prog_c, device=dev)(
            prog_c.params, torch.as_tensor(dp_u, device=dev)).cpu().numpy()
        launches["codegen_stage"] += kernel_backend.codegen_stage.launches - k0
        # the forward's readout (finals @ C.T over the C·B folded rows) on the
        # card's GEMM: a DP rank runs 1/dp of those rows
        dp_rows = MESH_DP_SPEC["c_slow"] * MESH_DP_BATCH
        dp_row_dep = gemm_bits_depend_on_rows(prog_c.params["C"].T.to(torch.float32), dp_rows,
                                              dp_rows // MESH_RANKS)
        del prog_c
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        say("mesh", case="unsharded_references", seconds=f"{time.perf_counter() - t0:.2f}")

    # the world-1 process starts beside the gloo ranks (each pays its own
    # start; neither waits for the other)
    t0 = time.perf_counter()
    world1 = Beside(run_ranks, mesh_ranks_nccl, 1, (dev_name, cfg, prompts, mcfg),
                    backend=rank_backend, timeout_s=200)
    try:
        ranks = run_ranks(mesh_ranks_gloo, MESH_RANKS,
                          (dev_name, cfg, prompts, spec, tp_u, spec_c, dp_u), backend="gloo",
                          timeout_s=200)
    finally:
        [nccl] = world1.result()
    gloo_s = time.perf_counter() - t0
    for driver in ("step", "block"):
        keys = [k for out in ranks for k in out[driver]["logits"]]
        require(sorted(keys) == sorted(want_logits[driver]),
                f"mesh sharded {driver}: the ranks' (request, position) logits are not "
                "plan=None's, each once")
    for rank, out in enumerate(ranks):
        require(not out["jax"], f"mesh rank {rank} imported jax")
        for driver, want in (("step", want_step), ("block", want_block)):
            r = out[driver]
            require(r["tokens"] == want, f"mesh sharded rank {rank} {driver}: tokens differ")
            gap, top, bit = logit_gap(r.pop("logits"), want_logits[driver])
            require(bit or (row_dep and gap <= MESH_DP_GAP * top),
                    f"mesh sharded rank {rank} {driver}: logits {gap:.3e} from plan=None's "
                    f"(max |logit| {top:.3e}, GEMM bits depend on rows: {row_dep})")
            require(r["launches"] == cfg.n_layers * r["own_prefills"] and r["own_prefills"] > 0,
                    f"mesh sharded rank {rank} {driver}: {r['launches']} lstm_seq launches "
                    f"for {r['own_prefills']} prefills of its shard")
            require(r["host_state"] == ranks[0][driver]["host_state"],
                    f"mesh sharded rank {rank} {driver}: host state differs from rank 0's")
            launches["lstm_seq"] += r["launches"]
            say("mesh", case=f"sharded_dp{MESH_RANKS}_gloo", rank=rank, driver=driver,
                identical_tokens=True, logits_gap=f"{gap:.3e}", logits_bit_identical=bit,
                max_abs_logit=f"{top:.3e}", gemm_rows_change_bits=row_dep,
                own_prefills=r["own_prefills"],
                lstm_seq_launches=r["launches"], decoded_by_shard=r["by_shard"],
                decode_tok_s=f"{r['decode_tok_s']:.1f}",
                plan_none_decode_tok_s=f"{base['decode_tok_s']:.1f}",
                seconds=f"{r['wall_s']:.2f}", card=repr(card))
        tp_err = float(np.abs(out["tp_y"] - tp_want).max())
        require(tp_err <= MESH_TP_TOL + MESH_TP_TOL * float(np.abs(tp_want).max()),
                f"mesh eager tp={MESH_RANKS} rank {rank}: {tp_err:.3e} from the unsharded run")
        n_reduce = MESH_TP_LAYERS * BIT_T
        require(out["tp_counts"] == {"all_reduce": n_reduce},
                f"mesh eager tp: collectives {out['tp_counts']}, not {n_reduce} all_reduce")
        backend, shape, key, row = out["synth"]
        require(backend == "eager" and key == row and key.endswith(f"|mesh1x{MESH_RANKS}"),
                f"mesh synthesize: backend {backend}, ledger key {key}")
        say("mesh", case=f"synth_eager_tp{MESH_RANKS}", rank=rank,
            spec=f"lstm_{MESH_TP_LAYERS}x{width}_T{BIT_T}", max_abs_err=f"{tp_err:.3e}",
            tol=MESH_TP_TOL,
            all_reduces=out["tp_counts"]["all_reduce"], tp_forward_s=f"{out['tp_s']:.2f}",
            unsharded_forward_s=f"{eager_s:.2f}", ledger_key=key, output_shape=shape,
            card=repr(card))
        dp_err = float(np.abs(out["dp_y"] - dp_want).max())
        dp_top = float(np.abs(dp_want).max())
        require(dp_err == 0.0 or (dp_row_dep and dp_err <= MESH_KERNEL_DP_GAP * dp_top),
                f"mesh kernel dp={MESH_RANKS} rank {rank}: {dp_err:.3e} from the unsharded "
                f"kernel (max |y| {dp_top:.3e}, readout GEMM bits depend on rows: {dp_row_dep})")
        require(out["dp_counts"] == {"gather_rows": 1} and out["dp_launches"] > 0,
                f"mesh kernel dp: collectives {out['dp_counts']}, launches {out['dp_launches']}")
        launches["codegen_stage"] += out["dp_launches"]
        say("mesh", case=f"synth_kernel_dp{MESH_RANKS}", rank=rank,
            spec=f"lstm_{MESH_DP_SPEC['num_hidden_layers']}x{width}_T{MESH_DP_SPEC['seq_len']}"
                 f"_c{MESH_DP_SPEC['c_slow']}",
            gap_to_unsharded_kernel=f"{dp_err:.3e}", bit_identical=dp_err == 0.0,
            max_abs_y=f"{dp_top:.3e}", readout_gemm_rows_change_bits=dp_row_dep,
            codegen_launches=out["dp_launches"], card=repr(card))
    say("mesh", case=f"gloo_ranks_{MESH_RANKS}", seconds=f"{gloo_s:.2f}")

    r = nccl["step"]
    require(nccl["backend"] == rank_backend, f"mesh: world-1 run on {nccl['backend']}")
    require(r["tokens"] == want_step, "mesh sharded dp=1 under NCCL: tokens differ")
    got = r.pop("logits")
    gap, _, bit = logit_gap(got, want_logits["step"])
    require(bit and len(got) == len(want_logits["step"]),
            f"mesh sharded dp=1 under NCCL: logits {gap:.3e} from plan=None's")
    require(r["launches"] == cfg.n_layers * n_req,
            f"mesh sharded dp=1 under NCCL: {r['launches']} lstm_seq launches")
    launches["lstm_seq"] += r["launches"]
    say("mesh", case=f"sharded_dp1_{rank_backend}", identical_tokens=True,
        logits_bit_identical=True, lstm_seq_launches=r["launches"],
        decode_tok_s=f"{r['decode_tok_s']:.1f}", seconds=f"{r['wall_s']:.2f}", card=repr(card))
    require(nccl["ep_counts"] == {"all_to_all_single": 2},
            f"mesh EP: collectives {nccl['ep_counts']}, not 2 all_to_all_single")
    require(nccl["ep_err"] < MESH_EP_TOL,
            f"mesh EP: {nccl['ep_err']:.3e} from moe_apply(group_size={MESH_EP_TOKENS})")
    E, k, D, F = nccl["ep_shape"]
    say("mesh", case=f"ep_moe_{rank_backend}", world=1, experts=E, top_k=k, d_model=D, d_ff_expert=F,
        tokens=MESH_EP_TOKENS, max_abs_err=f"{nccl['ep_err']:.3e}", tol=MESH_EP_TOL,
        max_abs_y=f"{nccl['ep_max_y']:.3e}", all_to_alls=2, ep_s=f"{nccl['ep_s']:.3f}",
        note="one card: NCCL allows one rank, so EP runs at world size 1",
        seconds=f"{world1.seconds:.2f}", beside_the_gloo_ranks=True, card=repr(card))
    return launches


# ---------------------------------------------------------------------------
# 23. mesh_train: Trainer(mesh=) with ZeRO shards, elastic restore, the
# compressed all-reduce and the pipeline schedule
# ---------------------------------------------------------------------------

def mesh_train_config(smoke: bool = False):
    """smollm-135m at its published widths and depth (the smoke config when
    rehearsing on the CPU)."""
    from repro_torch.configs import get_config, get_smoke_config

    mcfg = (get_smoke_config if smoke else get_config)("smollm-135m")
    require(smoke or (mcfg.n_layers, mcfg.d_model, mcfg.n_heads, mcfg.n_kv_heads, mcfg.d_ff,
                      mcfg.vocab) == (30, 576, 9, 3, 1536, 49_152),
            f"smollm-135m is not at its published widths and depth: {mcfg}")
    return mcfg


def mesh_trainer(mcfg, ckpt_dir: Path, dev, mesh):
    """The phase's ``Trainer``: ``MT_STEPS`` steps of ``MT_BATCH`` ×
    ``MT_SEQ`` tokens in ``MT_MICRO`` microbatches, a checkpoint after the
    last, every step logged."""
    from repro_torch import optim
    from repro_torch.data import DataConfig
    from repro_torch.runtime import Trainer, TrainerConfig

    tcfg = TrainerConfig(total_steps=MT_STEPS, ckpt_every=MT_STEPS, ckpt_dir=str(ckpt_dir),
                         log_every=1, microbatches=MT_MICRO, ckpt_async=False)
    ocfg = optim.AdamWConfig(lr_peak=3e-4, warmup_steps=2, total_steps=MT_STEPS)
    return Trainer(mcfg, tcfg, ocfg,
                   DataConfig(vocab=mcfg.vocab, seq_len=MT_SEQ, global_batch=MT_BATCH),
                   mesh, device=dev)


def mesh_train_run(mcfg, ckpt_dir: Path, dev, mesh):
    """A ``mesh_trainer`` run: the trainer, each step's (loss, grad_norm,
    lr, seconds) and this process's peak allocation."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    trainer = mesh_trainer(mcfg, ckpt_dir, dev, mesh)
    res = trainer.run()
    sync(dev)
    peak = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else 0.0
    steps = [(m["loss"], m["grad_norm"], m["lr"], m["sec"]) for m in res["metrics"]]
    require(len(steps) == MT_STEPS and all(math.isfinite(x[0]) for x in steps),
            f"mesh_train: {len(steps)} steps logged, losses {[x[0] for x in steps]}")
    return trainer, steps, peak


def saved_arrays(ckpt_dir: Path) -> dict:
    with np.load(ckpt_dir / f"step_{MT_STEPS}" / "arrays.npz") as data:
        return {k: data[k] for k in data.files}


def equals_saved(trainer, ckpt_dir: Path) -> bool:
    """Whether ``trainer``'s state is ``ckpt_dir``'s last checkpoint bit for
    bit: each of this rank's shards against its block of the saved full
    arrays, cut on the host (no collective)."""
    from repro_torch._tree import tree_map
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.checkpoint import flatten_with_names

    state = {"params": trainer.params, "opt": trainer.opt_state}
    host = tree_map(lambda t: torch.empty(0, dtype=t.dtype), state)
    want, _ = CheckpointManager(str(ckpt_dir)).restore(host, MT_STEPS, layout=trainer.layout)
    got, want = flatten_with_names(state), flatten_with_names(want)
    return sorted(got) == sorted(want) and all(np.array_equal(got[k], want[k]) for k in want)


def resumed_from(mcfg, ckpt_dir: Path, dev, mesh) -> tuple[int, bool]:
    """A ``mesh_trainer`` on ``mesh`` over ``ckpt_dir``, whose last
    checkpoint is the run's end: the steps it still took (0) and whether its
    restored state is the saved full arrays bit for bit."""
    trainer = mesh_trainer(mcfg, ckpt_dir, dev, mesh)
    steps = len(trainer.run()["losses"])
    return steps, equals_saved(trainer, ckpt_dir)


def pipe_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def compression_check(mcfg, params, mesh, dev) -> dict:
    """The compressed all-reduce over the data ranks on the full gradient
    tree of this rank's rows of the first microbatch: each leaf's gap to
    the exact mean over its int8 step size (the one-step bound is 1), the
    collectives, and ``MT_COMP_STEPS`` error-feedback steps on the largest
    leaf (its average's gap over the step size: run_compression.py's bar
    is 0.2)."""
    from repro_torch._tree import tree_leaves_sorted, tree_map
    from repro_torch.launch.mesh import local_shard
    from repro_torch.parallel import comm, compression, zero

    group = mesh.get_group("data")
    batch = train_batch(mcfg.vocab, MT_BATCH, MT_SEQ, dev)
    rows = zero.local_rows(batch, MT_MICRO, 2, local_shard(mesh))
    first = {k: v[:MT_BATCH // MT_MICRO // 2] for k, v in rows.items()}
    grads = tree_map(lambda g: g.to(torch.float32), grads_on(mcfg, params, first)[1])
    comm.reset_counts()
    t0 = time.perf_counter()
    mean, _ = compression.make_compressed_allreduce(mesh, "data")(
        grads, compression.init_error_feedback(grads))
    sync(dev)
    one_s = time.perf_counter() - t0
    counts = dict(comm.COUNTS)
    two = torch.tensor(2.0, device=dev)
    exact = tree_map(lambda g: comm.all_reduce(g.clone(), group) / two, grads)
    scales = tree_map(lambda g: comm.all_reduce_max(g.abs().max(), group) / 127.0, grads)
    ratios = [float((m - e).abs().max() / s.clamp(min=1e-30)) for m, e, s in
              zip(*(tree_leaves_sorted(t) for t in (mean, exact, scales)), strict=True)]
    g, ex = grads["embed"]["table"], exact["embed"]["table"]
    err, acc = torch.zeros_like(g), torch.zeros_like(g)
    t0 = time.perf_counter()
    for _ in range(MT_COMP_STEPS):
        m, err = compression.compress_leaf(g, err, group)
        acc += m
    sync(dev)
    avg_ratio = float((acc / MT_COMP_STEPS - ex).abs().max() / scales["embed"]["table"])
    return {"leaves": len(ratios), "worst_one_step": max(ratios), "counts": counts,
            "one_step_s": one_s, "avg30_over_scale": avg_ratio,
            "steps_s": time.perf_counter() - t0, "largest": tuple(g.shape)}


def pipeline_check(dev) -> dict:
    """``pipeline_apply`` over this process's stage mesh at ``PIPE_D``:
    the gap to ``sequential_reference``, the ring transfers, seconds."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.parallel import comm
    from repro_torch.parallel.pipeline import pipeline_apply, sequential_reference

    world = torch.distributed.get_world_size()
    mesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("stage",))
    gen = torch.Generator(device=dev).manual_seed(23)
    p = {"w": torch.randn(world, PIPE_D, PIPE_D, generator=gen, device=dev) / math.sqrt(PIPE_D),
         "b": 0.1 * torch.randn(world, PIPE_D, generator=gen, device=dev)}
    x = torch.randn(PIPE_C, PIPE_ROWS, PIPE_D, generator=gen, device=dev)
    comm.reset_counts()
    t0 = time.perf_counter()
    y = pipeline_apply(pipe_stage, p, x, mesh)
    sync(dev)
    pipe_s = time.perf_counter() - t0
    counts = dict(comm.COUNTS)
    return {"err": float((y - sequential_reference(pipe_stage, p, x)).abs().max()),
            "counts": counts, "s": pipe_s}


def _phase_sizes(sizes: dict) -> None:
    """A spawned rank re-imports this script: take the parent's sizes."""
    globals().update(sizes)


def mesh_train_gloo(rank: int, world: int, dev_name: str, root: str, smoke: bool,
                    sizes: dict, moe: bool = False) -> dict:
    """One of two ranks sharing the card over gloo: ``Trainer(mesh=
    make_local_mesh(2, 1))``, its checkpoint restored under (1, 1, 2) and,
    on rank 0, under (1, 1, 1), the compressed all-reduce and the
    pipeline; with ``moe``, phase 24's dp = 2 work after
    (``moe_mesh_rank``), in the same processes (one start of the ranks)."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm

    _phase_sizes(sizes)
    dev = _rank_device(dev_name)
    root = Path(root)
    mcfg = mesh_train_config(smoke)
    dp2, tp2, dp1 = make_local_mesh(2, 1), make_local_mesh(1, 2), make_local_mesh(1, 1)
    before = kernel_counts()
    trainer, steps, peak = mesh_train_run(mcfg, root / "dp2", dev, dp2)
    out = {"steps": steps, "peak_gb": peak}
    del trainer
    # the gradients at the initial weights (every trainer's, from seed 0)
    params = lm.init_params(mcfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    out["compression"] = compression_check(mcfg, params, dp2, dev)
    del params
    out["restore_1x1x2"] = resumed_from(mcfg, root / "dp2", dev, tp2)
    if rank == 0:
        out["restore_1x1x1"] = resumed_from(mcfg, root / "dp2", dev, dp1)
    out["pipeline"] = pipeline_check(dev)
    after = kernel_counts()
    out["kernels"] = {k: after[k] - before[k] for k in after}
    if moe:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out["moe"] = moe_mesh_rank(dev, smoke)
    out["jax"] = "jax" in sys.modules
    return out


@contextlib.contextmanager
def one_rank_group(backend: str, timeout_s: float):
    """A ``torch.distributed`` group of this process alone (world size 1, a
    ``file://`` rendezvous in a fresh directory), destroyed when the block
    is left."""
    import datetime
    import tempfile

    import torch.distributed as dist

    tmp = tempfile.mkdtemp(prefix="repro_torch_rank_")
    dist.init_process_group(backend, init_method="file://" + os.path.join(tmp, "rendezvous"),
                            world_size=1, rank=0, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def mesh_train_nccl(rank: int, world: int, dev_name: str, root: str, smoke: bool,
                    sizes: dict) -> dict:
    """World size 1 under NCCL: ``Trainer(mesh=make_local_mesh(1, 1))``
    against the ``mesh=None`` checkpoint (run in the phase's own process,
    inside :func:`one_rank_group`)."""
    from repro_torch.launch.mesh import make_local_mesh

    _phase_sizes(sizes)
    dev = _rank_device(dev_name)
    root = Path(root)
    mcfg = mesh_train_config(smoke)
    mesh = make_local_mesh(1, 1)
    before = kernel_counts()
    trainer, steps, peak = mesh_train_run(mcfg, root / "nccl", dev, mesh)
    out = {"steps": steps, "peak_gb": peak, "backend": torch.distributed.get_backend(),
           "identical_to_none": equals_saved(trainer, root / "none")}
    after = kernel_counts()
    out["kernels"] = {k: after[k] - before[k] for k in after}
    return out


def mesh_train_phase(dev, card: str, *, smoke: bool = False, rank_backend: str = "nccl",
                     moe_job: dict | None = None) -> list:
    """Phase 23: smollm-135m through ``Trainer(mesh=None)``, ``Trainer(mesh=
    make_local_mesh(2, 1))`` over two gloo ranks sharing the card and
    ``make_local_mesh(1, 1)`` under ``rank_backend`` (NCCL, in this process), on the same
    initial weights (every trainer draws them from seed 0): losses and grad
    norms within ``MT_RTOL`` of ``mesh=None``, dp = 1 bit-identical, the
    dp = 2 checkpoint restored under dp = 1 and (1, 1, 2) bit for bit; the
    compressed all-reduce and the pipeline on the two ranks; no kernel
    launched.  Returns ``mesh=None``'s steps (phase 26's oracle).

    The world-1 run goes in this process while the gloo ranks run.  With
    ``moe_job`` (``moe_mesh_started``'s), the ranks run phase 24's dp = 2
    work after theirs and this process phase 24's world-1 run after its
    own; their results go into ``moe_job`` for ``moe_mesh_train_phase``."""
    from repro_torch.launch.spawn import run_ranks
    from repro_torch.models import lm

    root = ROOT / "build" / "mesh_train"
    shutil.rmtree(root, ignore_errors=True)
    dev_name = "cuda:0" if dev.type == "cuda" else "cpu"
    before = kernel_counts()
    mcfg = mesh_train_config(smoke)
    tokens = MT_BATCH * MT_SEQ
    t0 = time.perf_counter()
    trainer, base, peak = mesh_train_run(mcfg, root / "none", dev, None)
    n_params = lm.param_count(trainer.params)
    require(smoke or n_params == 134_515_008, f"smollm-135m has {n_params} parameters")
    del trainer
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    none_s = time.perf_counter() - t0
    runs = {"mesh_none": [(base, peak)]}
    sizes = {k: globals()[k] for k in ("MT_SEQ", "PIPE_D", "PIPE_ROWS", "MM_SEQS")}
    # each rank's collectives and the wait for the ranks time out well inside
    # the script's limit (the ranks took ~51 s and ~29-37 s on the H100, and
    # phase 24's work ~50 s more)
    ranks = Beside(run_ranks, mesh_train_gloo, 2, (dev_name, str(root), smoke, sizes,
                                                   moe_job is not None),
                   backend="gloo", timeout_s=500)
    try:
        # world size 1 needs no other process: this one joins a group of its
        # own, while the gloo ranks run
        t2 = time.perf_counter()
        with one_rank_group(rank_backend, timeout_s=240):
            nccl = mesh_train_nccl(0, 1, dev_name, str(root), smoke, sizes)
        nccl_s = time.perf_counter() - t2
        if moe_job is not None:
            moe_mesh_world1(moe_job, dev, rank_backend)
    finally:
        gloo = ranks.result()
    gloo_s = ranks.seconds
    if moe_job is not None:
        moe_job["gloo"], moe_job["gloo_s"] = [g.pop("moe") for g in gloo], gloo_s
    runs["dp2_gloo"] = [(r["steps"], r["peak_gb"]) for r in gloo]
    runs[f"dp1_{rank_backend}"] = [(nccl["steps"], nccl["peak_gb"])]

    for label, ranks in runs.items():
        for rank, (steps, peak_gb) in enumerate(ranks):
            per_rank = tokens // len(ranks)
            for i, ((loss, gn, lr, sec), (b_loss, b_gn, b_lr, _)) in enumerate(zip(steps, base)):
                loss_gap, gn_gap = abs(loss - b_loss) / abs(b_loss), abs(gn - b_gn) / abs(b_gn)
                say("mesh_train_step", run=label, rank=rank, step=i, loss=f"{loss:.6f}",
                    grad_norm=f"{gn:.6f}", lr=f"{lr:.3e}", ms=f"{1e3 * sec:.1f}",
                    tokens_per_s_rank=f"{per_rank / sec:.0f}", loss_rel_gap=f"{loss_gap:.3e}",
                    grad_norm_rel_gap=f"{gn_gap:.3e}", card=repr(card))
                require(loss_gap <= MT_RTOL and gn_gap <= MT_RTOL and lr == b_lr,
                        f"mesh_train {label} rank {rank} step {i}: loss {loss} / {b_loss}, "
                        f"grad norm {gn} / {b_gn}, lr {lr} / {b_lr}")
            steady = statistics.median(x[3] for x in steps[1:])
            say("mesh_train", run=label, rank=rank, ranks=len(ranks), steady_step_ms=f"{1e3 * steady:.1f}",
                first_step_ms=f"{1e3 * steps[0][3]:.1f}",
                tokens_per_s_rank=f"{per_rank / steady:.0f}", peak_alloc_gb=f"{peak_gb:.2f}",
                seq_len=MT_SEQ, global_batch=MT_BATCH, microbatches=MT_MICRO, params=n_params,
                card=repr(card))

    # the parameter gap after the last step, from the checkpoints' full arrays
    none, dp2 = saved_arrays(root / "none"), saved_arrays(root / "dp2")
    gaps = {k: float(np.abs(dp2[k] - v).max()) for k, v in none.items()
            if k.startswith("params/")}
    worst = max(gaps, key=gaps.get)
    say("mesh_train", case="param_gap_dp2", worst_leaf=worst, max_abs_gap=f"{gaps[worst]:.3e}",
        max_abs_param=f"{float(np.abs(none[worst]).max()):.3e}",
        bit_identical=all(np.array_equal(dp2[k], none[k]) for k in gaps))
    del none, dp2
    require(nccl["backend"] == rank_backend, f"mesh_train: world-1 run on {nccl['backend']}")
    say("mesh_train", case=f"dp1_{rank_backend}", bit_identical_to_mesh_none=nccl["identical_to_none"])
    require(nccl["identical_to_none"],
            f"mesh_train: dp = 1 under {rank_backend} is not bit-identical to mesh=None")
    for case, (steps_taken, same) in (("dp2 -> (1, 1, 1)", gloo[0]["restore_1x1x1"]),
                                      *((f"dp2 -> (1, 1, 2) rank {r}", g["restore_1x1x2"])
                                        for r, g in enumerate(gloo))):
        say("mesh_train", case="elastic_restore", mesh=repr(case), steps_after_resume=steps_taken,
            bit_identical_to_saved=same)
        require(steps_taken == 0 and same, f"mesh_train: elastic restore {case} "
                                           f"({steps_taken} steps, identical {same})")
    for rank, g in enumerate(gloo):
        require(not g["jax"], f"mesh_train rank {rank} imported jax")
        c = g["compression"]
        payload = sorted(k for k in c["counts"] if k.startswith("all_reduce_") and k != "all_reduce_max")
        say("mesh_train", case="compression", rank=rank, leaves=c["leaves"],
            worst_one_step_gap_over_scale=f"{c['worst_one_step']:.3f}",
            largest_leaf=c["largest"], steps=MT_COMP_STEPS,
            avg_gap_over_scale=f"{c['avg30_over_scale']:.4f}", payload=payload,
            counts=c["counts"], one_step_s=f"{c['one_step_s']:.2f}",
            steps_s=f"{c['steps_s']:.2f}", card=repr(card))
        require(c["worst_one_step"] <= 1.0, f"compression: a leaf {c['worst_one_step']:.3f} "
                                            "steps from the exact mean")
        require(c["avg30_over_scale"] < 0.2,
                f"compression: the {MT_COMP_STEPS}-step average {c['avg30_over_scale']:.4f} of "
                "the step size from the exact mean")
        require(payload == ["all_reduce_int32"] and not c["counts"].get("all_reduce"),
                f"compression: the payload crossed as {c['counts']}")
        pp = g["pipeline"]
        say("mesh_train", case="pipeline", rank=rank, stages=2, microbatches=PIPE_C,
            rows=PIPE_ROWS, d=PIPE_D, max_abs_err=f"{pp['err']:.3e}", tol=PIPE_TOL,
            counts=pp["counts"], seconds=f"{pp['s']:.3f}", card=repr(card))
        require(pp["err"] <= PIPE_TOL and pp["counts"] == {"ppermute": PIPE_C + 1, "all_reduce": 1},
                f"pipeline: {pp['err']:.3e} from sequential, collectives {pp['counts']}")
    after = kernel_counts()
    launched = {k: after[k] - before[k] + sum(r["kernels"][k] for r in gloo) for k in after}
    say("mesh_train_kernels", launches_during_phase=launched)
    require(not any(launched.values()), f"a kernel launched on the mesh training path: {launched}")
    say("mesh_train", case="seconds", mesh_none=f"{none_s:.1f}",
        gloo_ranks=f"{gloo_s:.1f}", nccl_rank_beside_them=f"{nccl_s:.1f}",
        phase_24_in_the_ranks=moe_job is not None)
    shutil.rmtree(root, ignore_errors=True)
    return base


# ---------------------------------------------------------------------------
# 24. moe_mesh_train: MoE on a data mesh, and the dry run against the card
# ---------------------------------------------------------------------------

def moe_mesh_config(smoke: bool = False):
    """olmoe-1b-7b at its published widths, its 16 layers cut to
    ``MM_LAYERS`` (the smoke config when rehearsing on the CPU)."""
    from repro_torch.configs import get_config, get_smoke_config

    if smoke:
        return get_smoke_config("olmoe-1b-7b")
    full = get_config("olmoe-1b-7b")
    require((full.n_layers, full.d_model, full.n_experts, full.top_k, full.d_ff_expert,
             full.vocab) == (16, 2048, 64, 8, 1024, 50_304),
            f"olmoe-1b-7b is not at its published widths and depth: {full}")
    return dataclasses.replace(full, n_layers=MM_LAYERS)


def moe_mesh_shape(seq: int):
    from repro_torch.models.config import ShapeSpec

    return ShapeSpec(f"train_S{seq}", seq, MM_BATCH, "train")


def model_replicated(layout):
    """The predicate on a state path (``checkpoint._children``' names):
    whether ``layout``'s spec of that leaf cuts nothing over ``model``."""
    from repro_torch.checkpoint.checkpoint import _children

    specs = {}

    def walk(t, path):
        kids = _children(t)
        if kids is not None:
            for k, v in kids:
                walk(v, f"{path}/{k}" if path else k)
        else:
            specs[path] = t.entries

    walk(layout.specs, "")
    return lambda path: not any(  # noqa: E731
        e is not None and "model" in (e if isinstance(e, tuple) else (e,)) for e in specs[path])


def moe_mesh_steps(mcfg, seq: int, dev, mesh, *, keep_state: bool = False,
                   replicated: bool = False) -> dict:
    """``MM_STEPS`` train steps (``make_train_step(mesh=)``) of ``MM_BATCH``
    × ``seq`` tokens in ``MM_MICRO`` microbatches from seed-0 weights: each
    step's (loss, grad norm, seconds), each step's router calls (the expert
    ids and each token's least gap between two of its k + 1 most probable
    experts: how near a tie its routing was), the last step's collectives, the step's argument bytes (this rank's shards
    and the global batch) and the peak GB; with ``keep_state`` the final
    full state; with ``replicated`` each step's ``leaf_checksums`` of the
    state's leaves replicated along ``model``."""
    from repro_torch import optim
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.trace_analysis import tensor_bytes
    from repro_torch.models import lm, moe
    from repro_torch.parallel import comm, zero

    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(mcfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    state = {"params": params, "opt": optim.init(params)}
    del params
    layout = None if mesh is None else zero.state_layout(mcfg, mesh)
    if layout is not None:
        state = layout.shard(state)
    step = make_train_step(mcfg, optim.AdamWConfig(lr_peak=3e-4, warmup_steps=2,
                                                   total_steps=MM_STEPS), MM_MICRO, mesh)
    data = TokenPipeline(DataConfig(vocab=mcfg.vocab, seq_len=seq, global_batch=MM_BATCH))
    routes, inner = [], moe.route

    def spy(p, cfg, x, data=None):
        out = inner(p, cfg, x, data)
        with torch.no_grad():
            top = torch.softmax(x.float() @ p["router"], -1).topk(cfg.top_k + 1, -1).values
        routes[-1].append((out[0].reshape(-1, cfg.top_k),
                           (top[..., :-1] - top[..., 1:]).amin(-1).reshape(-1)))
        return out

    out = {"steps": []}
    moe.route = spy
    try:
        for i in range(MM_STEPS):
            routes.append([])
            batch = {k: torch.from_numpy(v).to(dev) for k, v in data.global_batch_at(i).items()}
            args = (state["params"], state["opt"], batch)
            out["arg_bytes"] = tensor_bytes(args)
            comm.reset_counts()
            sync(dev)
            t0 = time.perf_counter()
            new_params, new_opt, m = step(*args)
            loss = float(m["loss"])               # waits for the step
            out["steps"].append((loss, float(m["grad_norm"]), time.perf_counter() - t0))
            out["collectives"] = comm.counters()
            state = {"params": new_params, "opt": new_opt}
            if replicated:
                out.setdefault("replicated", []).append(
                    leaf_checksums(state, model_replicated(layout)))
            del args, batch, new_params, new_opt
    finally:
        moe.route = inner
    out["routes"] = [[(ids.cpu().numpy(), gap.cpu().numpy()) for ids, gap in calls]
                     for calls in routes]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else 0.0
    if keep_state:
        out["state"] = state if layout is None else layout.gather(state)
    return out


def moe_mesh_rank(dev, smoke: bool) -> dict:
    """Phase 24 on one of two ranks sharing the card over gloo
    (``mesh_train_gloo`` runs it after phase 23's work): ``moe_mesh_steps``
    on ``make_local_mesh(2, 1)`` at each of ``MM_SEQS``."""
    from repro_torch.launch.mesh import make_local_mesh

    mcfg = moe_mesh_config(smoke)
    mesh = make_local_mesh(2, 1)
    before = kernel_counts()
    out = {seq: moe_mesh_steps(mcfg, seq, dev, mesh) for seq in MM_SEQS}
    after = kernel_counts()
    return {"runs": out, "kernels": {k: after[k] - before[k] for k in after},
            "jax": "jax" in sys.modules}


def route_gap(got: list, want: list, dp: int, shard: int, spanning: bool) -> dict:
    """This rank's router calls against ``mesh=None``'s, step by step: the
    calls, the tokens whose expert ids (or their order, which sets the
    capacity slots) differ in each step, and the least gap between two of
    the k + 1 most probable experts among them (``mesh=None``'s)."""
    flips, margin, calls = [], math.inf, 0
    for step_got, step_want in zip(got, want, strict=True):
        n_bad = 0
        for (ids, _), (full, gap) in zip(step_got, step_want, strict=True):
            n = full.shape[0] // dp
            ref, ref_gap = (full, gap) if spanning else (full[shard * n:(shard + 1) * n],
                                                         gap[shard * n:(shard + 1) * n])
            bad = (ids != ref).any(-1)
            n_bad += int(bad.sum())
            if bad.any():
                margin = min(margin, float(ref_gap[bad].min()))
            calls += 1
        flips.append(n_bad)
    return {"calls": calls, "flips": flips, "margin": margin}


def moe_mesh_started(dev, *, smoke: bool = False) -> dict:
    """Phase 24's start, before phase 23 spawns the gloo ranks that run its
    dp = 2 work (``mesh_train_phase(moe_job=)``): olmoe-1b-7b (1 of its 16
    layers) through ``make_train_step`` with ``mesh=None`` in this process
    at each of ``MM_SEQS``, and the dry runs of the same cells on a
    (1, 2, 1) mesh and of phase 21's one-device smollm cell, each in a
    process of its own, started in threads.  Returns the job for
    ``moe_mesh_world1`` and ``moe_mesh_train_phase``."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AXES, AbstractMesh
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeSpec

    dev_name = "cuda:0" if dev.type == "cuda" else "cpu"
    before = kernel_counts()
    mcfg = moe_mesh_config(smoke)
    t0 = time.perf_counter()
    base = {seq: moe_mesh_steps(mcfg, seq, dev, None, keep_state=seq == MM_SEQS[0])
            for seq in MM_SEQS}
    none_s = time.perf_counter() - t0
    n_params = lm.param_count(base[MM_SEQS[0]]["state"]["params"])

    # the dry runs, each in a process of its own (a fake process group), beside the ranks
    records, threads = {}, []

    def dry(key, *args, **kwargs):
        try:
            records[key] = dryrun.spawn_cell(*args, timeout_s=300, **kwargs)
        except BaseException as e:  # noqa: BLE001 - read below
            records[key] = e

    scfg = mesh_train_config(smoke) if smoke else get_config("smollm-135m")
    s_seq = CHECK_SEQ if smoke else TRAIN_SEQ
    cells = {seq: ("olmoe-1b-7b", dict(mesh_shape=AbstractMesh((1, 2, 1), AXES),
                                       shape=moe_mesh_shape(seq), cfg=mcfg, microbatches=MM_MICRO))
             for seq in MM_SEQS}
    # phase 21's cell: one device, its batch and microbatches
    cells["smollm"] = ("smollm-135m", dict(one_device=True, cfg=scfg, microbatches=TRAIN_MICRO,
                                           shape=ShapeSpec(f"train_S{s_seq}", s_seq, TRAIN_BATCH,
                                                           "train")))
    for key, (arch, kw) in cells.items():
        threads.append(threading.Thread(target=dry, args=(key, arch, "", False),
                                        kwargs=dict(kw, device=dev_name)))
        threads[-1].start()
    return {"before": before, "mcfg": mcfg, "base": base, "none_s": none_s,
            "n_params": n_params, "scfg": scfg, "s_seq": s_seq, "records": records,
            "threads": threads}


def moe_mesh_world1(job: dict, dev, rank_backend: str = "nccl") -> None:
    """Phase 24's dp = 1 run under ``rank_backend`` in this process (a group
    of its own), into ``job``."""
    from repro_torch.launch.mesh import make_local_mesh

    t1 = time.perf_counter()
    with one_rank_group(rank_backend, timeout_s=240):
        job["nccl"] = moe_mesh_steps(job["mcfg"], MM_SEQS[0], dev, make_local_mesh(1, 1),
                                     keep_state=True)
    job["nccl_s"] = time.perf_counter() - t1


def moe_mesh_train_phase(dev, card: str, train: dict, job: dict, *,
                         rank_backend: str = "nccl") -> dict:
    """Phase 24's checks: olmoe-1b-7b (1 of its 16 layers) through
    ``make_train_step`` with ``mesh=None`` in this process, over two gloo
    ranks sharing the card (dp = 2) and under ``rank_backend`` at dp = 1, at
    S = 1024 (a 2048-token group is one rank's rows: aligned) and S = 512 (a
    group spans both ranks: gathered); the dry run of the same cells against
    the ranks, and of phase 21's one-device smollm cell against its measured
    peak and step time; no kernel launched.  ``job``: ``moe_mesh_started``'s,
    with the ranks' and the world-1 run's results that phase 23 put there.
    Returns the ``mesh=None`` run at ``MM_SEQS[0]`` (its steps and router
    calls: phase 27's oracle)."""
    from repro_torch.models import moe

    for t in job["threads"]:
        t.join()
    before, mcfg, base, none_s, n_params = (job[k] for k in ("before", "mcfg", "base", "none_s",
                                                              "n_params"))
    scfg, s_seq, records = job["scfg"], job["s_seq"], job["records"]
    gloo, gloo_s, nccl, nccl_s = job["gloo"], job["gloo_s"], job["nccl"], job["nccl_s"]
    want_state = base[MM_SEQS[0]].pop("state")
    from repro_torch._tree import tree_leaves

    identical = all(torch.equal(a, b) for a, b in zip(tree_leaves(nccl.pop("state")),
                                                      tree_leaves(want_state), strict=True))
    del want_state
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    tokens = MM_BATCH
    for seq in MM_SEQS:
        b = base[seq]
        local = MM_BATCH // MM_MICRO // 2 * seq          # a rank's tokens in a microbatch
        spanning = local % moe.group_size_of(2 * local, mcfg.moe_group_size
                                             or moe.DEFAULT_GROUP_SIZE) != 0
        runs = [("mesh_none", 0, b, None)] + [("dp2_gloo", r, g["runs"][seq], r)
                                              for r, g in enumerate(gloo)]
        if seq == MM_SEQS[0]:
            runs.append((f"dp1_{rank_backend}", 0, nccl, None))
        for label, rank, run, shard in runs:
            dp = 2 if label == "dp2_gloo" else 1
            rg = route_gap(run["routes"], b["routes"], dp, shard or 0, spanning or dp == 1)
            for i, ((loss, gn, sec), (b_loss, b_gn, _)) in enumerate(zip(run["steps"], b["steps"])):
                same_routes = not any(rg["flips"][:i + 1])   # a flip moves this step and later
                loss_gap, gn_gap = abs(loss - b_loss) / abs(b_loss), abs(gn - b_gn) / abs(b_gn)
                say("moe_mesh_step", run=label, rank=rank, seq_len=seq, step=i,
                    loss=f"{loss:.6f}", grad_norm=f"{gn:.6f}", ms=f"{1e3 * sec:.1f}",
                    tokens_per_s_rank=f"{tokens * seq / dp / sec:.0f}",
                    loss_rel_gap=f"{loss_gap:.3e}", grad_norm_rel_gap=f"{gn_gap:.3e}",
                    routing_flips=rg["flips"][i], held_to=MM_RTOL if same_routes else "none",
                    card=repr(card))
                require(math.isfinite(loss) and math.isfinite(gn),
                        f"moe_mesh {label} S={seq} step {i}: loss {loss}, grad norm {gn}")
                if same_routes:
                    require(loss_gap <= MM_RTOL and gn_gap <= MM_RTOL,
                            f"moe_mesh {label} rank {rank} S={seq} step {i}: loss {loss} / "
                            f"{b_loss}, grad norm {gn} / {b_gn}")
            steady = statistics.median(x[2] for x in run["steps"][1:])
            say("moe_mesh", run=label, rank=rank, seq_len=seq,
                groups="spanning" if spanning and dp > 1 else "aligned",
                router_calls=rg["calls"], routing_flips_by_step=rg["flips"],
                flip_margin=f"{rg['margin']:.3e}" if any(rg["flips"]) else "none",
                steady_step_ms=f"{1e3 * steady:.1f}", first_step_ms=f"{1e3 * run['steps'][0][2]:.1f}",
                tokens_per_s_rank=f"{tokens * seq / dp / steady:.0f}",
                peak_alloc_gb=f"{run['peak_gb']:.2f}", collectives=run["collectives"],
                global_batch=MM_BATCH, microbatches=MM_MICRO, layers=mcfg.n_layers,
                params=n_params, card=repr(card))
    say("moe_mesh", case=f"dp1_{rank_backend}", bit_identical_to_mesh_none=identical)
    require(identical, f"moe_mesh: dp = 1 under {rank_backend} is not bit-identical to mesh=None")

    for key, rec in records.items():
        if isinstance(rec, BaseException):
            raise rec
    for seq in MM_SEQS:
        rec = records[seq]
        for rank, g in enumerate(gloo):
            run = g["runs"][seq]
            same = (rec["memory_analysis"]["argument_size_in_bytes"] == run["arg_bytes"]
                    and rec["collectives"] == run["collectives"])
            say("moe_mesh_dryrun", seq_len=seq, rank=rank, mesh=rec["mesh"],
                argument_bytes=rec["memory_analysis"]["argument_size_in_bytes"],
                rank_argument_bytes=run["arg_bytes"], collectives=rec["collectives"],
                rank_collectives=run["collectives"], equal=same,
                predicted_peak_gb=f"{rec['memory_analysis']['peak_size_in_bytes'] / 1e9:.2f}",
                rank_peak_alloc_gb=f"{run['peak_gb']:.2f}",
                flops=f"{rec['flops_corrected']:.4e}", trace_s=rec["lower_s"])
            require(same, f"moe_mesh dry run S={seq}: arguments {rec['memory_analysis']} and "
                          f"collectives {rec['collectives']} against rank {rank}'s "
                          f"{run['arg_bytes']} and {run['collectives']}")
    rec = records["smollm"]
    say("train_dryrun", arch=scfg.name, seq_len=s_seq, global_batch=TRAIN_BATCH, mesh=rec["mesh"],
        microbatches=rec["microbatches"],
        predicted_peak_gb=f"{rec['memory_analysis']['peak_size_in_bytes'] / 1e9:.2f}",
        measured_peak_alloc_gb=f"{train['peak_gb']:.2f}", flops=f"{rec['flops_corrected']:.4e}",
        measured_step_s=f"{train['step_s']:.4f}",
        achieved_tflop_s=f"{rec['flops_corrected'] / train['step_s'] / 1e12:.2f}",
        trace_s=rec["lower_s"], card=repr(card))
    for rank, g in enumerate(gloo):
        require(not g["jax"], f"moe_mesh rank {rank} imported jax")
    after = kernel_counts()
    launched = {k: after[k] - before[k] + sum(g["kernels"][k] for g in gloo) for k in after}
    say("moe_mesh_kernels", launches_during_phase=launched)
    require(not any(launched.values()), f"a kernel launched on the MoE mesh path: {launched}")
    say("moe_mesh", case="seconds", mesh_none=f"{none_s:.1f}",
        gloo_ranks_with_phase_23=f"{gloo_s:.1f}", nccl_rank_beside_them=f"{nccl_s:.1f}")
    return base[MM_SEQS[0]]


# ---------------------------------------------------------------------------
# 25. cross-attention and the encoder frontend: hubert-xlarge, llama-vision
# ---------------------------------------------------------------------------

def logits_gap(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """max |got - want| as a share of max |want|, and max |want|."""
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / scale, scale


def timed(fn, dev):
    """``fn()``'s result and its wall ms, the card synchronised on both sides."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, (time.perf_counter() - t0) * 1e3


def fa_reset() -> None:
    from repro_torch.kernels.flash_attention import ops as fa_ops

    fa = fa_ops.flash_attention
    fa.calls = fa.window_calls = fa.launches = 0


def fa_read() -> tuple[int, int]:
    from repro_torch.kernels.flash_attention import ops as fa_ops

    return fa_ops.flash_attention.calls, fa_ops.flash_attention.launches


def encoder_phase(dev, card: str) -> dict:
    """hubert-xlarge uncut: a 2048-frame forward through ``flash_attention``
    (non-causal, 48 calls) against the plain path at every position, the
    first position moved by the last frame, one full-width train step on an
    ``embeds`` batch, and ``train_loss`` on the card against the CPU at 4
    layers.  Returns the kernel's calls and launches, and under
    ``"oracle"`` (on the host) the frames, the kernel forward's logits,
    the train batch and the first step's (loss, grad norm): phase 26's
    tp = 2 ranks are held to them."""
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config("hubert-xlarge"), use_pallas=True)
    require((cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
             cfg.d_ff, cfg.vocab, cfg.frontend_dim, cfg.causal, cfg.gated_mlp, cfg.mlp_act,
             cfg.partial_rotary)
            == ("encoder", 48, 1280, 16, 16, 80, 5120, 504, 512, False, False, "gelu", 0.0),
            f"hubert-xlarge is not at its published widths and depth: {cfg}")
    pcfg = dataclasses.replace(cfg, use_pallas=False)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    params, init_ms = timed(lambda: lm.init_params(cfg, gen, device=dev), dev)
    n_params = lm.param_count(params)
    require(n_params == HUBERT_PARAMS, f"hubert-xlarge has {n_params} parameters")
    x = torch.randn((1, HUBERT_SEQ, cfg.frontend_dim), generator=gen, device=dev)
    want_calls, _, want_launches = fa_per_prefill(cfg, HUBERT_SEQ, dev)
    with torch.no_grad():
        lm.forward(params, cfg, x[:, :64], mode="prefill")          # warm the kernel's path
        fa_reset()
        (lg_k, _, _), k_ms = timed(lambda: lm.forward(params, cfg, x, mode="prefill"), dev)
        calls, launches = fa_read()
        require((calls, launches) == (want_calls, want_launches) and calls == cfg.n_layers,
                f"hubert-xlarge forward: flash_attention calls, launches {(calls, launches)}, "
                f"not {(want_calls, want_launches)}")
        (lg_p, _, _), p_ms = timed(lambda: lm.forward(params, pcfg, x, mode="prefill"), dev)
        require(lg_k.shape == (1, HUBERT_SEQ, cfg.vocab) and bool(torch.isfinite(lg_k).all()),
                f"hubert-xlarge logits of shape {tuple(lg_k.shape)} or non-finite")
        gap, scale = logits_gap(lg_k, lg_p)
        require(gap <= VLM_LOGITS_RTOL,
                f"hubert-xlarge use_pallas forward differs from the plain path by {gap:.3e} "
                f"of max |logit| {scale:.3e}")
        # non-causal: the last frame reaches position 0, beyond the kernel's
        # run-to-run noise on the same input
        again, _, _ = lm.forward(params, cfg, x, mode="prefill")
        noise = float((again[:, 0] - lg_k[:, 0]).abs().max())
        x2 = x.clone()
        x2[:, -1] = torch.randn((1, cfg.frontend_dim), generator=gen, device=dev)
        moved_lg, _, _ = lm.forward(params, cfg, x2, mode="prefill")
        moved = float((moved_lg[:, 0] - lg_k[:, 0]).abs().max())
        phase_calls, phase_launches = fa_read()
        require(moved > 0 and moved > 10 * noise,
                f"hubert-xlarge: changing the last frame moved position 0 by {moved:.3e} "
                f"(run-to-run {noise:.3e}); the attention is causal")
        lg_k_host = lg_k.cpu()
        del lg_k, lg_p, again, moved_lg
    say("encoder_forward", arch=cfg.name, params=n_params, param_gb=f"{4 * n_params / 1e9:.2f}",
        init_ms=f"{init_ms:.1f}", frames=HUBERT_SEQ, flash_attention_calls=calls,
        flash_attention_launches=launches, phase_calls=phase_calls,
        phase_launches=phase_launches, rel_gap=f"{gap:.3e}", max_abs_logit=f"{scale:.3e}",
        rtol_of_max=VLM_LOGITS_RTOL, forward_ms_use_pallas=f"{k_ms:.2f}",
        forward_ms_plain=f"{p_ms:.2f}", position0_moved_by=f"{moved:.3e}",
        position0_run_to_run=f"{noise:.3e}", predicted_forward_ms="150-250",
        peak_alloc_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", card=repr(card))

    # one full-width train step on frame embeddings (the plain path: training
    # reaches no kernel in either package)
    before = kernel_counts()
    B, S = HUBERT_TRAIN
    torch.cuda.reset_peak_memory_stats()
    batch = {"embeds": torch.randn((B, S, cfg.frontend_dim), generator=gen, device=dev),
             "labels": torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev,
                                     dtype=torch.int32)}
    step = make_train_step(pcfg, optim.AdamWConfig())
    opt = optim.init(params)
    step_ms, first = [], None
    for _ in range(2):
        (params, opt, m), ms = timed(lambda: step(params, opt, batch), dev)
        step_ms.append(ms)
        first = first or (float(m["loss"]), float(m["grad_norm"]))
        require(math.isfinite(float(m["loss"])) and math.isfinite(float(m["grad_norm"])),
                f"hubert-xlarge train step: loss {float(m['loss'])}, "
                f"grad norm {float(m['grad_norm'])}")
    after = kernel_counts()
    require(after == before, f"a kernel launched on hubert's training path: {before} -> {after}")
    train_peak = torch.cuda.max_memory_allocated()
    say("encoder_train", arch=cfg.name, batch=B, seq_len=S, first_step_ms=f"{step_ms[0]:.1f}",
        step_ms=f"{step_ms[1]:.1f}", tokens_per_s=f"{B * S / step_ms[1] * 1e3:.0f}",
        loss=f"{float(m['loss']):.4f}", grad_norm=f"{float(m['grad_norm']):.4f}",
        peak_alloc_gb=f"{train_peak / 1e9:.2f}", card=repr(card))
    # phase 26's oracle: the kernel forward's logits and the first step, on
    # the host with their inputs
    oracle = {"n_layers": cfg.n_layers, "x": x.cpu(), "logits": lg_k_host, "forward_ms": k_ms,
              "batch": {k: v.cpu() for k, v in batch.items()}, "step0": first,
              "step_ms": step_ms[1], "peak_gb": train_peak / 1e9}
    del params, opt, batch, step, m
    torch.cuda.empty_cache()

    n, B, S = HUBERT_CHECK
    ccfg = dataclasses.replace(pcfg, n_layers=n)
    cparams = lm.init_params(ccfg, torch.Generator(device=dev).manual_seed(1), device=dev)
    cgen = torch.Generator(device=dev).manual_seed(2)
    cbatch = {"embeds": torch.randn((B, S, ccfg.frontend_dim), generator=cgen, device=dev),
              "labels": torch.randint(0, ccfg.vocab, (B, S), generator=cgen, device=dev,
                                      dtype=torch.int32)}
    card_against_cpu(ccfg, cparams, dev, card, B, S, batch=cbatch)
    del cparams, cbatch
    torch.cuda.empty_cache()
    return {"calls": phase_calls, "launches": phase_launches, "oracle": oracle}


def vlm_decode_cache(mcfg, prefill_caches, max_seq: int, dev):
    """A B=1 decode cache of ``max_seq`` positions holding a one-shot
    prefill's keys and values; the cross blocks' dummy leaves stay
    ``init_cache``'s."""
    from repro_torch.models import lm

    caches = lm.init_cache(mcfg, 1, max_seq, dev)
    for name, leaf in caches["groups"].items():
        if isinstance(leaf, dict):
            for k in ("k", "v"):
                src = prefill_caches["groups"][name][k]
                leaf[k][:, :, :src.shape[2]] = src
    return caches


def vlm_phase(dev, card: str) -> dict:
    """llama-3.2-vision-90b at its widths, 10 layers, every cross gate open:
    a 2048-token prompt against a seeded [1, 1601, 7680] memory through
    ``flash_attention`` (8 calls) against the plain path at every position,
    ``prefill_chunk`` chained in 256-token chunks against it, 16 greedy
    tokens through ``decode_step`` against ``plain_greedy``, and the memory
    ablation.  Returns the kernel's calls and launches, and under
    ``"oracle"`` (on the host) the memory, the prompt, the kernel
    prefill's last logits and the greedy tokens: phase 26's tp = 2 ranks
    are held to them; beside them the plain prefill's last logits and the
    one-device controls at that row (the plain path and the chunk chain
    against the kernel prefill)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config("llama-3.2-vision-90b"), n_layers=LLAMA_LAYERS,
                              use_pallas=True)
    require((cfg.family, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
             cfg.vocab, cfg.rope_theta, cfg.frontend_dim, cfg.frontend_tokens, cfg.n_groups,
             cfg.layer_pattern)
            == ("vlm", 8192, 64, 8, 128, 28_672, 128_256, 500_000.0, 7680, 1601, 2,
                ("attn",) * 4 + ("cross",))
            and get_config("llama-3.2-vision-90b").n_layers == 100,
            f"llama-3.2-vision-90b is not at its published widths: {cfg}")
    pcfg = dataclasses.replace(cfg, use_pallas=False)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    params, init_ms = timed(lambda: lm.init_params(cfg, gen, device=dev), dev)
    n_params = lm.param_count(params)
    require(n_params == LLAMA_PARAMS, f"llama-3.2-vision-90b ({LLAMA_LAYERS} layers) has "
                                      f"{n_params} parameters")
    params["groups"]["b4_cross"]["cross"]["gate"].fill_(LLAMA_GATE)
    init_peak = torch.cuda.max_memory_allocated()
    memory = torch.randn((1, cfg.frontend_tokens, cfg.frontend_dim), generator=gen, device=dev)
    toks = torch.randint(0, cfg.vocab, (1, LLAMA_PROMPT), generator=gen, device=dev)
    max_seq = LLAMA_PROMPT + LLAMA_NEW
    want_calls, _, want_launches = fa_per_prefill(cfg, LLAMA_PROMPT, dev)
    with torch.no_grad():
        lm.forward(params, cfg, toks[:, :64], memory=memory, mode="prefill")   # warm the path
        torch.cuda.reset_peak_memory_stats()
        fa_reset()
        (lg_k, c_k, _), k_ms = timed(
            lambda: lm.forward(params, cfg, toks, memory=memory, mode="prefill"), dev)
        calls, launches = fa_read()
        require((calls, launches) == (want_calls, want_launches) and calls == 8,
                f"llama-3.2-vision-90b prefill: flash_attention calls, launches "
                f"{(calls, launches)}, not {(want_calls, want_launches)}")
        require(tuple(c_k["groups"]["b4_cross"].shape) == (cfg.n_groups,),
                f"the cross leaf after a one-shot prefill is "
                f"{tuple(c_k['groups']['b4_cross'].shape)}, the reference's is (G,)")
        prefill_peak = torch.cuda.max_memory_allocated()
        (lg_p, _, _), p_ms = timed(
            lambda: lm.forward(params, pcfg, toks, memory=memory, mode="prefill"), dev)
        require(lg_k.shape == (1, LLAMA_PROMPT, cfg.vocab) and bool(torch.isfinite(lg_k).all()),
                f"llama-3.2-vision-90b logits of shape {tuple(lg_k.shape)} or non-finite")
        gap, scale = logits_gap(lg_k, lg_p)
        require(gap <= VLM_LOGITS_RTOL,
                f"llama-3.2-vision-90b use_pallas prefill differs from the plain path by "
                f"{gap:.3e} of max |logit| {scale:.3e}")

        # chunked prefill from init_cache: each chunk's last logits against
        # the one-shot prefill's at that position
        caches = lm.init_cache(cfg, 1, max_seq, dev)
        chunk_lg = []
        sync(dev)
        t0 = time.perf_counter()
        for s0 in range(0, LLAMA_PROMPT, LLAMA_CHUNK):
            lg_c, caches = lm.prefill_chunk(params, cfg, toks[:, s0:s0 + LLAMA_CHUNK], caches,
                                            s0, memory=memory)
            chunk_lg.append(lg_c)
        sync(dev)
        chunk_ms = (time.perf_counter() - t0) * 1e3
        ends = [s0 + LLAMA_CHUNK - 1 for s0 in range(0, LLAMA_PROMPT, LLAMA_CHUNK)]
        chunk_abs = max(float((c - lg_k[:, e]).abs().max()) for e, c in zip(ends, chunk_lg))
        chunk_gap = max(logits_gap(c, lg_k[:, e])[0] for e, c in zip(ends, chunk_lg))
        chunk_gap_plain = max(logits_gap(c, lg_p[:, e])[0] for e, c in zip(ends, chunk_lg))
        require(fa_read()[0] == calls, "a chunk of prefill_chunk reached flash_attention")
        require(tuple(caches["groups"]["b4_cross"].shape) == (cfg.n_groups, 1),
                "the cross leaf after the chunk chain is not (G, 1)")
        require(chunk_abs <= CHUNK_ATOL,
                f"llama-3.2-vision-90b chunked prefill ({LLAMA_CHUNK}-token chunks) differs "
                f"from the one-shot prefill by {chunk_abs:.3e} ({chunk_gap:.3e} of max |logit|)")
        # one-device controls at the last row (phase 26's tp = 2 prefill is
        # read there): two other orders of the same fp32 sums against the
        # kernel prefill, the plain path and the chunk chain
        last_plain = lg_p[:, -1].cpu()
        controls = {"plain": logits_gap(lg_p[:, -1], lg_k[:, -1])[0],
                    "chunk_chain": logits_gap(chunk_lg[-1], lg_k[:, -1])[0]}
        del caches, lg_c, chunk_lg, lg_p

        # greedy decode from the kernel prefill's cache, against the plain loop
        dcache = vlm_decode_cache(cfg, c_k, max_seq, dev)
        del c_k
        out = [int(lg_k[0, -1].argmax())]
        sync(dev)
        t0 = time.perf_counter()
        for pos in range(LLAMA_PROMPT, LLAMA_PROMPT + LLAMA_NEW - 1):
            lg_d, dcache = lm.decode_step(params, cfg, torch.as_tensor([[out[-1]]], device=dev),
                                          dcache, pos, memory=memory)
            out.append(int(lg_d[0].argmax()))
        decode_ms = (time.perf_counter() - t0) * 1e3 / (LLAMA_NEW - 1)
        del dcache
        want = plain_greedy(cfg, params, toks[0].tolist(), LLAMA_NEW, max_seq, dev,
                            memory=memory)
        require(out == want, f"llama-3.2-vision-90b greedy tokens {out} differ from the plain "
                             f"loop's {want}")

        # the memory ablation: the cross blocks are on the path
        lg_0, _ = lm.prefill(params, cfg, toks, memory=memory * 0)
        ablation, _ = logits_gap(lg_0, lg_k[:, -1])
        last_host = lg_k[:, -1].cpu()
        require(ablation >= MEMORY_ABLATION_MIN,
                f"llama-3.2-vision-90b: a zero memory moved the logits by only {ablation:.3e} "
                "of max |logit|")
        calls, launches = fa_read()
    say("vlm_prefill", arch=cfg.name, n_layers=cfg.n_layers, params=n_params,
        param_gb=f"{4 * n_params / 1e9:.2f}", init_ms=f"{init_ms:.1f}",
        init_peak_gb=f"{init_peak / 1e9:.2f}", memory="x".join(map(str, memory.shape)),
        gate=LLAMA_GATE, prompt_len=LLAMA_PROMPT, flash_attention_calls=want_calls,
        flash_attention_launches=want_launches, rel_gap=f"{gap:.3e}",
        max_abs_logit=f"{scale:.3e}", rtol_of_max=VLM_LOGITS_RTOL,
        prefill_ms_use_pallas=f"{k_ms:.2f}", prefill_ms_plain=f"{p_ms:.2f}",
        predicted_prefill_ms="800-1000", prefill_peak_gb=f"{prefill_peak / 1e9:.2f}",
        chunk=LLAMA_CHUNK, chunk_max_abs_diff=f"{chunk_abs:.3e}", chunk_atol=CHUNK_ATOL,
        chunk_rel_gap=f"{chunk_gap:.3e}", chunk_rel_gap_to_plain=f"{chunk_gap_plain:.3e}",
        chunked_prefill_ms=f"{chunk_ms:.2f}",
        last_row_rel_gap_plain=f"{controls['plain']:.3e}",
        last_row_rel_gap_chunk_chain=f"{controls['chunk_chain']:.3e}", card=repr(card))
    say("vlm_decode", arch=cfg.name, new_tokens=LLAMA_NEW, tokens_equal_plain=out == want,
        decode_ms_per_token=f"{decode_ms:.2f}", predicted_decode_ms=">=12.7",
        memory_ablation_rel=f"{ablation:.3e}", ablation_min=MEMORY_ABLATION_MIN,
        phase_calls=calls, phase_launches=launches,
        peak_alloc_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", card=repr(card))
    oracle = {"n_layers": cfg.n_layers, "calls_per_prefill": want_calls, "memory": memory.cpu(),
              "tokens": toks.cpu(), "last_logits": last_host, "last_logits_plain": last_plain,
              "controls": controls, "out": out, "prefill_ms": k_ms, "decode_ms": decode_ms}
    del params, memory, lg_k, lg_0
    torch.cuda.empty_cache()
    return {"calls": calls, "launches": launches, "oracle": oracle}


# ---------------------------------------------------------------------------
# 26. tp: tensor-parallel compute along model (serving, training, dry run)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def served_logits(srv, rows, prompts: dict):
    """``{("prefill", uid): row, (uid, position): row}`` of ``srv``'s
    one-shot prefills and decode calls for the requests ``prompts`` names
    (uid -> prompt) on this process's slot ``rows`` (the first call at a
    position), each row joined over ``model`` (``tensor_parallel.
    join_vocab``: a whole row as it is).  The device rows are kept and read
    after the run.  With no ``prompts`` nothing is wrapped."""
    from repro_torch.models import lm
    from repro_torch.parallel import tensor_parallel as tp

    got: dict = {}
    if not prompts:
        yield got
        return
    by_prompt = {tuple(p): uid for uid, p in prompts.items()}
    pre, calls, inner_pre, inner_dec = [], [], lm.prefill, lm.decode_step

    def prefill(params, cfg, tokens, **kw):
        out = inner_pre(params, cfg, tokens, **kw)
        uid = by_prompt.get(tuple(tokens[0].tolist()))
        if uid is not None:
            pre.append((uid, tp.join_vocab(out[0], cfg.vocab)[0]))
        return out

    def decode(params, cfg, tokens, caches, pos, **kw):
        out = inner_dec(params, cfg, tokens, caches, pos, **kw)
        uids = [srv.slot_req[b].uid if srv.slot_req[b] is not None
                and srv.slot_req[b].uid in prompts else None for b in rows]
        if any(u is not None for u in uids):
            calls.append((uids, pos.clone(), tp.join_vocab(out[0], cfg.vocab)))
        return out

    lm.prefill, lm.decode_step = prefill, decode
    try:
        yield got
    finally:
        lm.prefill, lm.decode_step = inner_pre, inner_dec
    for uid, row in pre:
        got.setdefault(("prefill", uid), row.float().cpu().numpy())
    for uids, pos, logits in calls:
        pos = pos.reshape(-1).cpu().numpy()
        logits = logits.float().reshape(len(uids), -1).cpu().numpy()
        for j, uid in enumerate(uids):
            if uid is not None:
                got.setdefault((uid, int(pos[j])), logits[j])


@contextlib.contextmanager
def served_routes(srv, rows, prompts: dict):
    """``{("prefill", uid): [(ids [S, k], top-(k+1) probabilities [S, k+1])
    a layer], (uid, position): [(ids [k], probabilities [k+1]) a layer]}``
    of every router call that ``srv``'s one-shot prefills and decode calls
    make for the requests ``prompts`` names, on this process's slot
    ``rows`` (the first call at a position): each request's routing in
    depth order, comparable between servers whose decode batches hold other
    requests (a decode group of ``SERVE_SLOTS`` tokens drops none).  With
    no ``prompts`` nothing is wrapped."""
    from repro_torch.models import lm, moe

    got: dict = {}
    if not prompts:
        yield got
        return
    by_prompt = {tuple(p): uid for uid, p in prompts.items()}
    calls, now = [], []         # (prefill key | decode uids, positions, layers)
    inner_pre, inner_dec, inner_route = lm.prefill, lm.decode_step, moe.route

    def prefill(params, cfg, tokens, **kw):
        uid = by_prompt.get(tuple(tokens[0].tolist()))
        now[:] = [(None if uid is None else ("prefill", uid), None, [])]
        out = inner_pre(params, cfg, tokens, **kw)
        calls.append(now.pop())
        return out

    def decode(params, cfg, tokens, caches, pos, **kw):
        uids = [srv.slot_req[b].uid if srv.slot_req[b] is not None
                and srv.slot_req[b].uid in prompts else None for b in rows]
        keyed = any(u is not None for u in uids)
        now[:] = [(uids if keyed else None, torch.as_tensor(pos).clone(), [])]
        out = inner_dec(params, cfg, tokens, caches, pos, **kw)
        calls.append(now.pop())
        return out

    def route(p, cfg, x, data=None):
        out = inner_route(p, cfg, x, data)
        if now and now[0][0] is not None:
            with torch.no_grad():
                probs = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ p["router"], -1)
                now[0][2].append((out[0].reshape(-1, cfg.top_k),
                                  torch.topk(probs, cfg.top_k + 1, dim=-1).values))
        return out

    lm.prefill, lm.decode_step, moe.route = prefill, decode, route
    try:
        yield got
    finally:
        lm.prefill, lm.decode_step, moe.route = inner_pre, inner_dec, inner_route
    for key, pos, layers in calls:
        if key is None:
            continue
        layers = [(i.cpu().numpy(), pr.float().cpu().numpy()) for i, pr in layers]
        if pos is None:
            got.setdefault(key, layers)
            continue
        pos = pos.reshape(-1).cpu().numpy()
        pos = np.broadcast_to(pos, (len(key),))
        for j, uid in enumerate(key):
            if uid is not None:
                got.setdefault((uid, int(pos[j])), [(i[j], pr[j]) for i, pr in layers])


def route_flip_rule(got: dict, want: dict, uid) -> tuple[list, dict | None]:
    """One request's routing against another run's, key by key in order
    (its prefill, then its decode positions): the keys before the first
    differing decision (whose logits are comparable), and that first flip
    (its key, layer, tokens, and the margins ``p_j - p_(j+1)`` of the two
    experts that swapped, in ``want``'s probabilities), or None."""
    keys = [("prefill", uid)] + sorted(k for k in want if k[0] == uid)
    clean = []
    for key in keys:
        if key not in got:
            continue
        for layer, ((ga, _), (wa, wp)) in enumerate(zip(got[key], want[key], strict=True)):
            diff = np.atleast_2d(ga != wa)
            if diff.any():
                wp = np.atleast_2d(wp)
                toks = np.nonzero(diff.any(-1))[0]
                j = diff[toks].argmax(-1)
                margins = wp[toks, j] - wp[toks, j + 1]
                return clean, {"key": key, "layer": layer, "tokens": int(toks.size),
                               "max_margin": float(margins.max())}
        clean.append(key)
    return clean, None


def leaf_checksums(tree, keep) -> dict:
    """``{path: (Σ bits, Σ bits·w)}`` of the leaves whose path ``keep``
    accepts, their bit patterns as int32 summed in int64 on the device, the
    second sum weighted by the position (a bit-for-bit comparison across
    ranks without moving the leaves to the host)."""
    from repro_torch.checkpoint.checkpoint import _children

    out = {}

    def walk(t, path):
        kids = _children(t)
        if kids is not None:
            for k, v in kids:
                walk(v, f"{path}/{k}" if path else k)
        elif keep(path):
            bits = t.detach().reshape(-1).view(torch.int32 if t.element_size() == 4 else
                                                torch.int16).long()
            w = torch.arange(1, bits.numel() + 1, device=bits.device) % 65_521
            out[path] = (int(bits.sum()), int((bits * w).sum()))

    walk(tree, "")
    return out


def dry_run_started(arch: str, cfg, shape, microbatches: int, dev_name: str,
                    tp: int = TP_RANKS) -> tuple:
    """``(thread, record)``: the dry run of ``arch``'s ``shape`` cell on a
    (1, 1, ``tp``) mesh (``dryrun.spawn_cell``, a process of its
    own), running in a thread; after ``thread.join()`` ``record["cell"]``
    holds the record or the exception."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AXES, AbstractMesh

    record = {}

    def dry():
        try:
            record["cell"] = dryrun.spawn_cell(
                arch, "", False, mesh_shape=AbstractMesh((1, 1, tp), AXES), shape=shape,
                cfg=cfg, microbatches=microbatches, device=dev_name, timeout_s=300)
        except BaseException as e:  # noqa: BLE001 - read by the caller
            record["cell"] = e

    thread = threading.Thread(target=dry)
    thread.start()
    return thread, record


def tp_weights(arch: str, n_layers: int, dev, plan, smoke: bool = False,
               at_once: int = 1) -> tuple:
    """``(config, this rank's block of the weights, full bytes, resident
    bytes)``: the weights drawn from seed 0 on the card (as the ``plan=None``
    run drew them), each leaf cut to this rank's model block as soon as it
    is drawn (``ShardPlan.draw_local``: the values of ``local_params`` of
    the whole draw, which is never held: llama-3.2-vision-90b's 42.62 GB
    and its blocks beside the other rank's would exceed the card); the
    full bytes are those of the tree's shapes.  The ranks draw one after
    another (a drawing rank holds one group of the whole)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.trace_analysis import tensor_bytes
    from repro_torch.parallel.zero import param_shapes

    mcfg = dataclasses.replace((get_smoke_config if smoke else get_config)(arch),
                               n_layers=n_layers, use_pallas=True)
    param_shapes(mcfg)      # the cut's shapes, traced once a process (~10 s the first time)
    params = in_turns(lambda: plan.draw_local(mcfg, torch.Generator(device=dev).manual_seed(0),
                                              device=dev), dev, plan, at_once)
    return mcfg, params, tensor_bytes(param_shapes(mcfg)), tensor_bytes(params)


def in_turns(fn, dev, plan, at_once: int = 1):
    """``fn()`` on the ranks of ``plan``'s mesh, ``at_once`` at a time in
    their order (each turn ends at a barrier over the control group): a
    rank drawing weights holds a whole leaf, or a stacked leaf's whole
    group, beside the other ranks' blocks.  Its card's cache is emptied
    before and after."""
    from repro_torch.launch.mesh import mesh_ranks

    out = None
    ranks = mesh_ranks(plan.mesh)
    for turn in range(0, len(ranks), at_once):
        if torch.distributed.get_rank() in ranks[turn:turn + at_once]:
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            out = fn()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        sync(dev)
        torch.distributed.barrier(group=plan.control_group())
    return out


def tp_drive(mcfg, params, traffic, slots: int, max_seq: int, dev, plan, *,
             uids=None, block: bool = False, routes: bool = False, srv=None, uid0: int = 0,
             prefix_cache_bytes: int = 0) -> dict:
    """``traffic`` (request ids ``uid0 + uids``, ``uids`` default its
    indices) through ``DecodeServer(plan=)`` on this rank's ``params`` (or
    through ``srv`` again) under ``step()`` or ``step_block()``, every
    request's prefill and decode logits recorded (``served_logits``) and,
    with ``routes``, its routing decisions (``served_routes``), keyed by
    ``uids``; the kernels' counts set to 0 just before the run and read
    just after, the launches its one-shot prefills must make beside."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssm_scan import ops as scan_ops
    from repro_torch.obs import Observability
    from repro_torch.runtime.server import DecodeServer, Request

    cuda = dev.type == "cuda"
    uids = list(range(len(traffic))) if uids is None else list(uids)
    if srv is None:
        srv = DecodeServer(mcfg, params, num_slots=slots, max_seq=max_seq, block_k=BLOCK_K,
                           obs=Observability(trace=True), plan=plan, device=dev,
                           prefix_cache_bytes=prefix_cache_bytes)
    srv.reset_stats()
    srv.obs.tracer.reset()
    for uid, (p, n) in zip(uids, traffic, strict=True):
        srv.submit(Request(uid=uid0 + uid, prompt=list(p), max_new_tokens=n))
    sync(dev)
    fa, scan = fa_ops.flash_attention, scan_ops.ssm_scan
    fa.calls = fa.window_calls = fa.launches = scan.launches = 0
    rows = plan.slots_of_shard(plan.local_shard, slots)
    prompts = {uid0 + uid: p for uid, (p, _) in zip(uids, traffic)}
    t0 = time.perf_counter()
    with torch.no_grad(), served_logits(srv, rows, prompts) as logits, \
            served_routes(srv, rows, prompts if routes else {}) as route_log:
        done = [r for r in srv.run_until_drained(persistent=block) if r.uid >= uid0]
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    counts = {"flash_attention": (fa.calls, fa.launches), "ssm_scan": scan.launches}
    by_len = prefill_ms_by_len(srv)
    oneshot = [ev["args"]["tokens"] for ev in srv.obs.tracer.events()
               if ev.get("name") == "prefill_oneshot"]
    # the launches those one-shot prefills make at this rank's heads (fa_per_prefill's rule)
    want_fa = 0
    if mcfg.family in ("dense", "moe") and not mcfg.use_mla and cuda:
        from repro_torch.launch.mesh import model_index

        want_fa = sum(fa_per_prefill(mcfg, n, dev, plan.tp, model_index(plan.mesh))[2]
                      for n in oneshot)
    decode_ms = sum(ev["dur"] for ev in srv.obs.tracer.events()
                    if ev.get("name") in ("decode_step", "decode_block")) / 1e3
    st = srv.stats()
    kv = next(iter(srv.caches["groups"].values()))
    back = lambda key: (key[0], key[1] - uid0) if key[0] == "prefill" \
        else (key[0] - uid0, key[1])  # noqa: E731
    return {"tokens": {r.uid - uid0: list(r.out_tokens) for r in done},
            "logits": {back(k): v for k, v in logits.items()},
            "routes": {back(k): v for k, v in route_log.items()}, "counts": counts,
            "oneshot_prefills": len(oneshot), "want_fa_launches": want_fa,
            "prefix_hits": st.get("prefix_cache", {}).get("hits", 0),
            "prompt_steps": st["prefill"]["prompt_steps_computed"],
            "cache_shapes": {k: tuple(v.shape) for k, v in kv.items()},
            "decode_tok_s": st["decoded_tokens"] / max(decode_ms / 1e3, 1e-9),
            "prefill_ms": (wall_ms - decode_ms) / len(done), "prefill_ms_by_len": by_len,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0,
            "host_state": hashlib.sha256(repr(srv.host_state()).encode()).hexdigest(),
            "srv": srv}


def tp_train(dev, mesh, smoke: bool, root: Path, make=None) -> dict:
    """smollm-135m through ``Trainer(mesh=(1, 1, 2))`` on phase 23's cell
    (or the trainer ``make()`` returns): each step's (loss, grad norm,
    seconds), argument bytes and collectives, and the checksums of the
    leaves replicated along ``model``."""
    from repro_torch.launch.trace_analysis import tensor_bytes
    from repro_torch.parallel import comm

    if make is None:
        mcfg = mesh_train_config(smoke)
        make = lambda: mesh_trainer(mcfg, root, dev, mesh)  # noqa: E731
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    trainer = make()
    if dev.type == "cuda":
        torch.cuda.empty_cache()        # the draw's whole leaves, cut to this rank's blocks
    replicated = model_replicated(trainer.layout)
    inner, steps = trainer._step_fn, []

    def step(params, opt, batch):
        args = (params, opt, batch)
        comm.reset_counts()
        sync(dev)
        t0 = time.perf_counter()
        new_params, new_opt, m = inner(*args)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        sec = time.perf_counter() - t0
        steps.append({"loss": loss, "grad_norm": gn, "s": sec, "arg_bytes": tensor_bytes(args),
                      "collectives": comm.counters(),
                      "replicated": leaf_checksums({"params": new_params, "opt": new_opt},
                                                   replicated)})
        return new_params, new_opt, m

    trainer._step_fn = step
    before = kernel_counts()
    trainer.run()
    sync(dev)
    after = kernel_counts()
    return {"steps": steps, "model_shard": inner.model_shard,
            "param_bytes": tensor_bytes(trainer.params),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else 0.0,
            "kernels": {k: after[k] - before[k] for k in after}}


def tp_ranks(rank: int, world: int, dev_name: str, serves: dict, smoke: bool, root: str,
             sizes: dict, moe_serves: dict | None = None, cross: dict | None = None) -> dict:
    """One of two ranks sharing the card over gloo: the two models served at
    tp = 2, then smollm-135m trained at (1, 1, 2); with ``cross``, the
    encoder's and the VLM's cases (``tp_cross_rank``), then with
    ``moe_serves`` phase 27's work (``tp_moe_rank``), in the same processes
    (a rank pays ~20 s on a slow host to start and to trace the parameters'
    shapes once)."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.runtime import ShardPlan

    _phase_sizes(sizes)
    dev = _rank_device(dev_name)
    mesh = make_local_mesh(1, world)
    plan = ShardPlan(mesh)
    out = {}
    for name, (arch, n_layers, traffic, slots, max_seq) in serves.items():
        mcfg, params, full_bytes, resident = tp_weights(arch, n_layers, dev, plan, smoke)
        out[name] = tp_drive(mcfg, params, traffic, slots, max_seq, dev, plan) | {
            "full_bytes": full_bytes, "resident_bytes": resident}
        del out[name]["srv"], params
    out["train"] = tp_train(dev, mesh, smoke, Path(root) / "tp2")
    if cross is not None:
        t0 = time.perf_counter()
        out["tp_cross"] = tp_cross_rank(dev, mesh, plan, cross, smoke)
        out["tp_cross"]["seconds"] = time.perf_counter() - t0
    if moe_serves is not None:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out["tp_moe"] = tp_moe_rank(dev, mesh, plan, moe_serves, smoke)
    out["jax"] = "jax" in sys.modules
    return out


def tp_cross_rank(dev, mesh, plan, job: dict, smoke: bool) -> dict:
    """Phase 26's encoder and VLM cases on one of two ranks sharing the card
    (``tp_ranks`` runs them after its own work): hubert-xlarge uncut at
    (1, 1, 2), a forward of phase 25's frames on its model shard (this
    rank's vocabulary columns of every position) and one train step
    (``make_train_step(mesh=)``) of phase 25's batch; then
    llama-3.2-vision-90b at ``job["llama_layers"]``, every cross gate at
    ``LLAMA_GATE``: a one-shot prefill of phase 25's prompt against its
    memory and greedy tokens (``vlm_rank_drive``).  Each model's weights drawn leaf by leaf in
    turns (``tp_weights``); the kernels' counts set to 0 just
    before each drive and read just after."""
    from repro_torch import optim
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.trace_analysis import tensor_bytes
    from repro_torch.models import lm
    from repro_torch.parallel import comm, zero
    from repro_torch.parallel.sharding import model_shard

    cuda = dev.type == "cuda"
    out = {}

    def fresh():
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    # hubert-xlarge: the forward, then one train step
    fresh()
    hj = job["hubert"]
    cfg, params, full_bytes, resident = tp_weights("hubert-xlarge", hj["n_layers"], dev, plan,
                                                   smoke)
    x = torch.from_numpy(hj["x"]).to(dev)
    want_calls, _, want_launches = fa_per_prefill(cfg, x.shape[1], dev, tp=plan.tp)
    with torch.no_grad(), model_shard(mesh):
        lm.forward(params, cfg, x[:, :64], mode="prefill")          # warm the kernel's path
        fa_reset()
        (lg, _, _), fwd_ms = timed(lambda: lm.forward(params, cfg, x, mode="prefill"), dev)
        calls, launches = fa_read()
    # results cross to the parent as numpy arrays: a torch tensor would be
    # sent as a handle to this process's memory, gone once the rank exits
    out["hubert"] = {"logits": lg.cpu().numpy(), "calls": calls, "launches": launches,
                     "want": (want_calls, want_launches), "forward_ms": fwd_ms,
                     "full_bytes": full_bytes, "resident_bytes": resident}
    del lg
    pcfg = dataclasses.replace(cfg, use_pallas=False)
    layout = zero.state_layout(pcfg, mesh)
    # at dp = 1 the train layout's blocks are the serving ones drawn above
    state = {"params": params, "opt": optim.init(params)}
    del params
    batch = {k: torch.from_numpy(v).to(dev) for k, v in hj["batch"].items()}
    step = make_train_step(pcfg, optim.AdamWConfig(), mesh=mesh)
    args = (state["params"], state["opt"], batch)
    arg_bytes = tensor_bytes(args)
    before = kernel_counts()
    comm.reset_counts()
    (new_params, new_opt, m), step_ms = timed(lambda: step(*args), dev)
    after = kernel_counts()
    out["hubert"]["train"] = {
        "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "ms": step_ms,
        "model_shard": step.model_shard, "arg_bytes": arg_bytes,
        "collectives": comm.counters(),
        "replicated": leaf_checksums({"params": new_params, "opt": new_opt},
                                     model_replicated(layout)),
        "kernels": {k: after[k] - before[k] for k in after},
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0}
    del state, args, batch, new_params, new_opt, m, step

    # llama-3.2-vision-90b: the prefill, then greedy decode from its cache
    fresh()
    out["llama"] = vlm_rank_drive(dev, mesh, plan, job["llama"], smoke)
    fresh()
    return out


def vlm_rank_drive(dev, mesh, plan, vj: dict, smoke: bool, warm: bool = True) -> dict:
    """llama-3.2-vision-90b at ``vj["n_layers"]`` on this rank's model
    shard, every cross gate at ``LLAMA_GATE``: its weights drawn leaf by
    leaf in turns (``tp_weights``), a one-shot prefill of ``vj["tokens"]``
    against ``vj["memory"]`` through ``make_prefill_step(mesh=)``, then
    ``len(vj["out"])`` greedy tokens through ``make_serve_step(mesh=)``;
    the kernel's counts set to 0 just before the prefill and read just
    after.  ``warm``: a 64-token prefill first (the first call of a
    process's kernels)."""
    from repro_torch.launch.mesh import model_index
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.parallel import tensor_parallel as tp_lib
    from repro_torch.parallel.sharding import model_shard

    cuda = dev.type == "cuda"
    cfg, params, full_bytes, resident = tp_weights("llama-3.2-vision-90b", vj["n_layers"], dev,
                                                   plan, smoke)
    params["groups"]["b4_cross"]["cross"]["gate"].fill_(LLAMA_GATE)
    memory, toks = torch.from_numpy(vj["memory"]).to(dev), torch.from_numpy(vj["tokens"]).to(dev)
    new = len(vj["out"])
    max_seq = toks.shape[1] + new
    want_calls, _, want_launches = fa_per_prefill(cfg, toks.shape[1], dev, tp=plan.tp,
                                                  index=model_index(mesh))
    prefill, serve = make_prefill_step(cfg, mesh), make_serve_step(cfg, mesh)
    with torch.no_grad(), model_shard(mesh):
        if warm:
            prefill(params, {"tokens": toks[:, :64], "memory": memory})   # warm the path
        fa_reset()
        (lg, caches), pre_ms = timed(lambda: prefill(params, {"tokens": toks, "memory": memory}),
                                     dev)
        calls, launches = fa_read()
        tokens = [int(tp_lib.join_vocab(lg, cfg.vocab)[0].argmax())]
        dcache = vlm_decode_cache(cfg, caches, max_seq, dev)
        cache_shapes = {k: tuple(v.shape) for k, v in dcache["groups"]["b0_attn"].items()}
        del caches
        sync(dev)
        t0 = time.perf_counter()
        for pos in range(toks.shape[1], toks.shape[1] + new - 1):
            lg_d, dcache = serve(params, {"tokens": torch.as_tensor([[tokens[-1]]], device=dev),
                                          "memory": memory}, dcache, pos)
            tokens.append(int(tp_lib.join_vocab(lg_d, cfg.vocab)[0].argmax()))
        sync(dev)
        decode_ms = (time.perf_counter() - t0) * 1e3 / (new - 1)
    out = {"last_logits": lg.cpu().numpy(), "tokens": tokens, "calls": calls,
           "launches": launches, "want": (want_calls, want_launches),
           "model_shard": prefill.model_shard and serve.model_shard,
           "prefill_ms": pre_ms, "decode_ms": decode_ms, "cache": cache_shapes,
           "cache_sums": leaf_checksums(dcache, lambda path: True),
           "full_bytes": full_bytes, "resident_bytes": resident,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0}
    del params, dcache, lg, memory, toks
    return out


def tp_cross_phase(dev, card: str, oracles: dict, ranks: list, record: dict, *,
                   smoke: bool = False) -> dict:
    """The checks of phase 26's encoder and VLM cases (each rank's
    ``tp_cross_rank`` result in ``ranks``) against phase 25's runs (``oracles``: the
    ``"oracle"`` of ``encoder_phase`` and ``vlm_phase``), the dry run of
    hubert's train cell at (1, 1, 2) (``record``) against the ranks, then
    ``flash_attention`` at (l) and (m), the two models' per-rank shapes.
    Returns the ranks' calls and launches by model and (l)'s and (m)'s
    timings."""
    h_or, v_or = oracles["hubert-xlarge"], oracles["llama-3.2-vision-90b"]
    require(len(ranks) == TP_RANKS and all(r is not None for r in ranks),
            "tp_cross: the ranks returned no encoder and VLM results")
    launches = {}

    def resident(arch, n_layers, run, rank):
        full_want, share_want = tp_share_bytes(arch, n_layers, TP_RANKS, smoke)
        require(run["full_bytes"] == full_want
                and abs(run["resident_bytes"] - share_want) <= TP_RESIDENT_RTOL * share_want,
                f"tp_cross {arch} rank {rank}: {run['resident_bytes']} of {run['full_bytes']} "
                f"bytes resident, reckoned {share_want} of {full_want}")
        return dict(resident_gb=f"{run['resident_bytes'] / 1e9:.4f}",
                    full_gb=f"{run['full_bytes'] / 1e9:.4f}",
                    share=f"{run['resident_bytes'] / run['full_bytes']:.4f}",
                    reckoned_gb=f"{share_want / 1e9:.4f}")

    def columns(want, got, rank):
        """This rank's vocabulary columns of ``want`` against ``got``, as a
        share of the whole rows' max |logit|."""
        n = got.shape[-1]
        mine = want[..., rank * n:(rank + 1) * n]
        gap = float((torch.from_numpy(got) - mine).abs().max())
        return gap / float(want.abs().max()), float(want.abs().max())

    # [tp_cross_forward], [tp_cross_train]: hubert-xlarge
    h_layers = h_or["n_layers"]
    calls_sum = launches_sum = 0
    for rank, r in enumerate(ranks):
        run = r["hubert"]
        gap, scale = columns(h_or["logits"], run["logits"], rank)
        require(gap <= TP_CROSS_LOGIT_GAP,
                f"tp_cross hubert-xlarge rank {rank}: forward logits {gap:.3e} of max |logit| "
                f"{scale:.3e} from phase 25's kernel forward")
        require((run["calls"], run["launches"]) == run["want"] and run["calls"] == h_layers,
                f"tp_cross hubert-xlarge rank {rank}: flash_attention calls, launches "
                f"{(run['calls'], run['launches'])}, not {run['want']}")
        calls_sum += run["calls"]
        launches_sum += run["launches"]
        say("tp_cross_forward", arch="hubert-xlarge", rank=rank, tp=TP_RANKS, layers=h_layers,
            frames=h_or["x"].shape[1], vocab_columns=run["logits"].shape[-1],
            rel_gap=f"{gap:.3e}", max_abs_logit=f"{scale:.3e}", bar=TP_CROSS_LOGIT_GAP,
            flash_attention_calls=run["calls"], launches=run["launches"],
            forward_ms=f"{run['forward_ms']:.2f}",
            forward_ms_plan_none=f"{h_or['forward_ms']:.2f}",
            **resident("hubert-xlarge", h_layers, run, rank), card=repr(card))
        tr = run["train"]
        b_loss, b_gn = h_or["step0"]
        lg, gg = abs(tr["loss"] - b_loss) / abs(b_loss), abs(tr["grad_norm"] - b_gn) / abs(b_gn)
        gathers = sorted(k for k in tr["collectives"] if k.startswith("gather"))
        say("tp_cross_train", arch="hubert-xlarge", rank=rank, mesh="1x1x2",
            batch="x".join(map(str, h_or["batch"]["labels"].shape)), loss=f"{tr['loss']:.6f}",
            grad_norm=f"{tr['grad_norm']:.6f}", loss_rel_gap=f"{lg:.3e}",
            grad_norm_rel_gap=f"{gg:.3e}", bar=TP_TRAIN_RTOL0, ms=f"{tr['ms']:.1f}",
            mesh_none_ms=f"{h_or['step_ms']:.1f}", gathers=gathers,
            collectives=tr["collectives"], peak_alloc_gb=f"{tr['peak_gb']:.2f}",
            mesh_none_peak_gb=f"{h_or['peak_gb']:.2f}", card=repr(card))
        require(tr["model_shard"], "tp_cross hubert-xlarge: the step did not compute on its "
                                   "model shard")
        require(lg <= TP_TRAIN_RTOL0 and gg <= TP_TRAIN_RTOL0,
                f"tp_cross hubert-xlarge rank {rank}: loss {tr['loss']} / {b_loss}, grad norm "
                f"{tr['grad_norm']} / {b_gn}")
        require(not gathers, f"tp_cross hubert-xlarge rank {rank}: gathers {gathers} in a step")
        require(not any(tr["kernels"].values()),
                f"tp_cross hubert-xlarge rank {rank}: a kernel launched on the training path: "
                f"{tr['kernels']}")
    reps = [r["hubert"]["train"]["replicated"] for r in ranks]
    require(len(reps[0]) > 0 and reps[0] == reps[1]
            and any(k.endswith("embed/proj") for k in reps[0]),
            f"tp_cross hubert-xlarge: the {len(reps[0])} leaves replicated along model differ "
            "across the ranks")
    launches["hubert-xlarge"] = (calls_sum, launches_sum)

    # [tp_cross_dryrun]: the (1, 1, 2) train cell's record against the ranks
    rec = record.get("cell")
    require(isinstance(rec, dict), f"tp_cross dry run of the (1, 1, 2) hubert cell failed: {rec}")
    for rank, r in enumerate(ranks):
        tr = r["hubert"]["train"]
        same = (rec["memory_analysis"]["argument_size_in_bytes"] == tr["arg_bytes"]
                and rec["collectives"] == tr["collectives"] and rec["model_shard"])
        say("tp_cross_dryrun", arch="hubert-xlarge", rank=rank, mesh=rec["mesh"],
            model_shard=rec["model_shard"],
            argument_bytes=rec["memory_analysis"]["argument_size_in_bytes"],
            rank_argument_bytes=tr["arg_bytes"], collectives=rec["collectives"],
            rank_collectives=tr["collectives"], equal=same, flops=rec["flops_corrected"],
            lower_s=rec["lower_s"], card=repr(card))
        require(same, f"tp_cross dry run: arguments and collectives differ from rank {rank}'s")

    # [tp_cross_prefill], [tp_cross_decode]: llama-3.2-vision-90b
    v_layers = v_or["n_layers"]
    calls_sum = launches_sum = 0
    for rank, r in enumerate(ranks):
        run = r["llama"]
        gap, scale = columns(v_or["last_logits"], run["last_logits"], rank)
        gap_plain, _ = columns(v_or["last_logits_plain"], run["last_logits"], rank)
        require(run["model_shard"], "tp_cross llama-3.2-vision-90b: a step did not compute on "
                                    "its model shard")
        require(gap <= TP_CROSS_VLM_LOGIT_GAP,
                f"tp_cross llama-3.2-vision-90b rank {rank}: prefill logits {gap:.3e} of max "
                f"|logit| {scale:.3e} from phase 25's kernel prefill")
        require(run["tokens"] == v_or["out"],
                f"tp_cross llama-3.2-vision-90b rank {rank}: greedy tokens {run['tokens']} "
                f"differ from phase 25's {v_or['out']}")
        require((run["calls"], run["launches"]) == run["want"]
                and run["calls"] == v_or["calls_per_prefill"],
                f"tp_cross llama-3.2-vision-90b rank {rank}: flash_attention calls, launches "
                f"{(run['calls'], run['launches'])}, not {run['want']}")
        calls_sum += run["calls"]
        launches_sum += run["launches"]
        say("tp_cross_prefill", arch="llama-3.2-vision-90b", rank=rank, tp=TP_RANKS,
            layers=v_layers, gate=LLAMA_GATE, prompt_len=v_or["tokens"].shape[1],
            memory="x".join(map(str, v_or["memory"].shape)),
            vocab_columns=run["last_logits"].shape[-1], rel_gap=f"{gap:.3e}",
            max_abs_logit=f"{scale:.3e}", bar=TP_CROSS_VLM_LOGIT_GAP,
            planned_bar=TP_CROSS_LOGIT_GAP, planned_bar_met=gap <= TP_CROSS_LOGIT_GAP,
            rel_gap_to_plain=f"{gap_plain:.3e}",
            one_device_plain_rel_gap=f"{v_or['controls']['plain']:.3e}",
            one_device_chunk_chain_rel_gap=f"{v_or['controls']['chunk_chain']:.3e}",
            flash_attention_calls=run["calls"], launches=run["launches"],
            prefill_ms=f"{run['prefill_ms']:.2f}",
            prefill_ms_plan_none=f"{v_or['prefill_ms']:.2f}", cache=run["cache"],
            **resident("llama-3.2-vision-90b", v_layers, run, rank),
            peak_alloc_gb=f"{run['peak_gb']:.2f}", card=repr(card))
        say("tp_cross_decode", arch="llama-3.2-vision-90b", rank=rank, tp=TP_RANKS,
            new_tokens=len(run["tokens"]), tokens_equal_phase_25=True,
            decode_ms_per_token=f"{run['decode_ms']:.2f}",
            decode_ms_per_token_plan_none=f"{v_or['decode_ms']:.2f}", card=repr(card))
    launches["llama-3.2-vision-90b"] = (calls_sum, launches_sum)

    # [kernel_time]: flash_attention at the two models' per-rank shapes
    gen = torch.Generator(device=dev).manual_seed(28)
    l2 = torch.zeros(32 * 1024 * 1024, device=dev)
    times = {name: fa_time_at(name, c, dev, card, gen, l2) for name, c in TP_CROSS_ATTN_SHAPES}
    say("tp_cross", case="seconds", rank0=f"{ranks[0]['seconds']:.1f}",
        dry_run_lower_s=rec["lower_s"])
    return {"launches": launches, "attn": times}


def tp_share_bytes(arch: str, n_layers: int, tp: int, smoke: bool = False) -> tuple[int, int]:
    """(full bytes, one rank's bytes) of ``arch`` cut to ``n_layers`` under
    ``param_specs(fsdp=False)`` on a (1, 1, tp) mesh, reckoned from the
    shapes (no storage)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.mesh import AXES, AbstractMesh
    from repro_torch.launch.steps import local_shape
    from repro_torch.parallel.sharding import map_with_path, param_specs
    from repro_torch.parallel.zero import param_shapes

    mcfg = dataclasses.replace((get_smoke_config if smoke else get_config)(arch),
                               n_layers=n_layers, use_pallas=True)
    mesh = AbstractMesh((1, 1, tp), AXES)
    shapes = param_shapes(mcfg)
    specs = param_specs(mcfg, shapes, mesh, fsdp=False)
    full, mine = [0], [0]

    def one(path, t):
        spec = specs
        for k in path.split("/"):
            spec = spec[k]
        full[0] += t.numel() * t.element_size()
        mine[0] += math.prod(local_shape(spec, t.shape, mesh)) * t.element_size()

    map_with_path(one, shapes)
    return full[0], mine[0]


def fa_time_at(name: str, c: dict, dev, card: str, gen, l2, **beside) -> tuple:
    """``flash_attention`` at one shape ``c`` (B, S, T, H, KV, hd; causal
    unless ``c["causal"]`` is False) against its plain version, then timed
    beside the plain version and SDPA, with its bound; one ``kernel_time``
    line (``beside``'s fields added).  Returns (ms, plain ms, SDPA ms,
    bound ms, bound by, FMA bound ms, key shares, max abs err),
    ``attn_time``'s tuple."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops

    q = torch.randn((c["B"], c["S"], c["H"], c["hd"]), generator=gen, device=dev)
    k, v = (torch.randn((c["B"], c["T"], c["KV"], c["hd"]), generator=gen, device=dev)
            for _ in range(2))
    causal = c.get("causal", True)
    with torch.no_grad():
        err = check_close(f"flash_attention {name}",
                          [fa_ops.flash_attention(q, k, v, causal=causal)],
                          [fa_ops.flash_attention_ref(q, k, v, causal=causal)], ATTN_TOL)
        ms = time_ms(lambda: fa_ops.flash_attention(q, k, v, causal=causal), l2)
        calls = launches_per_call(lambda: fa_ops.flash_attention(q, k, v, causal=causal))
        plain = time_ms(lambda: fa_ops.flash_attention_ref(q, k, v, causal=causal), l2)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), l2)
    bnd, by, fma = attn_bound_ms(c["B"], c["S"], c["T"], c["H"], c["KV"], c["hd"], causal, 0)
    n_splits = fa_kernel.splits(q, k, causal=causal)
    say("kernel_time", kernel="flash_attention", shape=name,
        **{n: c[n] for n in ("B", "S", "T", "H", "KV", "hd")}, causal=causal, window=0,
        max_abs_err=f"{err:.3e}", tol=ATTN_TOL, ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
        library_ms=f"{lib:.4f}", over_library=f"{ms / lib:.3f}",
        library="F.scaled_dot_product_attention(enable_gqa)", bound_ms=f"{bnd:.4f}",
        bound_by=by, bound_share=f"{bnd / ms:.3f}", fma_bound_ms=f"{fma:.4f}",
        key_splits=n_splits, launches_per_call=calls, reps=REPS, **beside, card=repr(card))
    require(calls == fa_kernel.launches_per_call(n_splits),
            f"flash_attention {name}: {calls} launches a call with {n_splits} key shares")
    return ms, plain, lib, bnd, by, fma, n_splits, err


def tp_phase(dev, card: str, oracles: dict, train_base, *, smoke: bool = False,
             layers: dict | None = None, moe_serves: dict | None = None,
             cross: dict | None = None) -> dict:
    """Phase 26.  ``oracles``: ``{"internlm2-20b": phase 18's record,
    "falcon-mamba-7b": phase 12's}``, each with its traffic, tokens and
    logits; ``train_base``: phase 23's ``mesh=None`` steps; ``cross``:
    phase 25's oracles (``{"hubert-xlarge": ..., "llama-3.2-vision-90b":
    ...}``), whose cases its ranks run after theirs (``tp_cross_rank``),
    with the dry run of hubert's train cell beside them; ``moe_serves``:
    phase 27's (``tp_moe_started``), which its ranks run last.
    Returns the kernels' launches and the (j) and D = 4096 timings for the
    summary, under ``"cross_ranks"`` and ``"cross_record"`` the ranks'
    encoder and VLM results and that dry run's record, and under
    ``"moe_ranks"`` the ranks' phase-27 results."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels.ssm_scan import ops as scan_ops
    from repro_torch.launch.spawn import run_ranks
    from repro_torch.models.config import ShapeSpec

    layers = layers or {"internlm2-20b": INTERNLM_LAYERS, "falcon-mamba-7b": MAMBA_LAYERS}
    root = ROOT / "build" / "tp"
    shutil.rmtree(root, ignore_errors=True)
    dev_name = "cuda:0" if dev.type == "cuda" else "cpu"
    i_or, m_or = oracles["internlm2-20b"], oracles["falcon-mamba-7b"]
    m_traffic = [(m_or["prompts"][i], TP_MAMBA_NEW) for i in range(TP_MAMBA_REQUESTS)]
    serves = {"internlm2-20b": ("internlm2-20b", layers["internlm2-20b"], i_or["traffic"],
                                SERVE_SLOTS, GEMMA_MAX_SEQ),
              "falcon-mamba-7b": ("falcon-mamba-7b", layers["falcon-mamba-7b"], m_traffic,
                                  NUM_SLOTS, MAX_SEQ)}
    t0 = time.perf_counter()
    thread, record = dry_run_started("smollm-135m", mesh_train_config(smoke),
                                     ShapeSpec(f"train_S{MT_SEQ}", MT_SEQ, MT_BATCH, "train"),
                                     MT_MICRO, dev_name)
    sizes = {k: globals()[k] for k in ("MT_SEQ", "MM_SEQS", "SERVE_SLOTS")}
    job = threads = None
    cross_record = {}
    if cross is not None:
        h_or, v_or = cross["hubert-xlarge"], cross["llama-3.2-vision-90b"]
        job = {"hubert": {"n_layers": h_or["n_layers"], "x": h_or["x"].numpy(),
                          "batch": {k: v.numpy() for k, v in h_or["batch"].items()}},
               "llama": {"n_layers": v_or["n_layers"], "memory": v_or["memory"].numpy(),
                         "tokens": v_or["tokens"].numpy(), "out": v_or["out"]}}
        B, S = h_or["batch"]["labels"].shape
        hcfg = dataclasses.replace(
            (get_smoke_config if smoke else get_config)("hubert-xlarge"),
            n_layers=h_or["n_layers"])
        threads = dry_run_started("hubert-xlarge", hcfg, ShapeSpec(f"train_S{S}", S, B, "train"),
                                  1, dev_name)
        cross_record = threads[1]
    try:
        ranks = run_ranks(tp_ranks, TP_RANKS, (dev_name, serves, smoke, str(root), sizes,
                                               moe_serves, job),
                          backend="gloo", timeout_s=1200 if moe_serves else 600)
    finally:
        thread.join()
        if threads is not None:
            threads[0].join()
    ranks_s = time.perf_counter() - t0
    for rank, r in enumerate(ranks):
        require(not r["jax"], f"tp rank {rank} imported jax")

    # [tp_serve]: tokens, logits, resident bytes and launches against the oracles
    launches = {"flash_attention": 0, "flash_attention_calls": 0, "ssm_scan": 0}
    for arch, oracle in (("internlm2-20b", i_or), ("falcon-mamba-7b", m_or)):
        full_want, share_want = tp_share_bytes(arch, layers[arch], TP_RANKS, smoke)
        n_prefills = len(serves[arch][2])
        for rank, r in enumerate(ranks):
            run = r[arch]
            for uid, toks in run["tokens"].items():
                want = list(oracle["tokens"][uid])[:len(toks)]
                require(toks == want, f"tp {arch} rank {rank}: request {uid}'s tokens "
                                      f"{toks} differ from the plan=None run's {want}")
            keys = sorted(run["logits"], key=str)
            missing = [k for k in keys if k not in oracle["logits"]]
            require(keys and not missing, f"tp {arch} rank {rank}: {len(missing)} of "
                                          f"{len(keys)} logit rows missing from the oracle")
            gap = max(float(np.abs(run["logits"][k] - oracle["logits"][k]).max()) for k in keys)
            scale = max(float(np.abs(oracle["logits"][k]).max()) for k in keys)
            require(gap <= TP_LOGIT_GAP * scale,
                    f"tp {arch} rank {rank}: logits {gap:.3e} from the plan=None run's "
                    f"(max |logit| {scale:.3e})")
            share = run["resident_bytes"] / run["full_bytes"]
            require(run["full_bytes"] == full_want
                    and abs(run["resident_bytes"] - share_want) <= TP_RESIDENT_RTOL * share_want,
                    f"tp {arch} rank {rank}: {run['resident_bytes']} of {run['full_bytes']} "
                    f"bytes resident, reckoned {share_want} of {full_want}")
            if arch == "internlm2-20b":
                calls, fa_launches = run["counts"]["flash_attention"]
                require(calls == layers[arch] * n_prefills
                        and fa_launches == run["want_fa_launches"],
                        f"tp {arch} rank {rank}: flash_attention {calls} calls, {fa_launches} "
                        f"launches for {n_prefills} one-shot prefills of {layers[arch]} layers")
                launches["flash_attention"] += fa_launches
                launches["flash_attention_calls"] += calls
            else:
                require(run["counts"]["ssm_scan"] == layers[arch] * n_prefills,
                        f"tp {arch} rank {rank}: ssm_scan launched {run['counts']['ssm_scan']} "
                        f"times for {n_prefills} prefills of {layers[arch]} layers")
                launches["ssm_scan"] += run["counts"]["ssm_scan"]
            say("tp_serve", arch=arch, rank=rank, tp=TP_RANKS, layers=layers[arch],
                requests=n_prefills, identical_tokens=True, logit_rows=len(keys),
                max_abs_gap=f"{gap:.3e}", max_abs_logit=f"{scale:.3e}",
                rel_gap=f"{gap / scale:.3e}", bar=TP_LOGIT_GAP,
                resident_gb=f"{run['resident_bytes'] / 1e9:.4f}",
                full_gb=f"{run['full_bytes'] / 1e9:.4f}", share=f"{share:.4f}",
                reckoned_gb=f"{share_want / 1e9:.4f}", cache=run["cache_shapes"],
                kernel_counts=run["counts"], decode_tok_s=f"{run['decode_tok_s']:.1f}",
                decode_tok_s_plan_none=f"{oracle['decode_tok_s']:.1f}",
                prefill_ms=f"{run['prefill_ms']:.2f}",
                prefill_ms_plan_none=f"{oracle['prefill_ms']:.2f}",
                peak_alloc_gb=f"{run['peak_gb']:.2f}", card=repr(card))
        require(ranks[0][arch]["host_state"] == ranks[1][arch]["host_state"],
                f"tp {arch}: the ranks' host states differ")

    # [tp_train]: against phase 23's mesh=None run
    tokens = MT_BATCH * MT_SEQ
    for rank, r in enumerate(ranks):
        tr = r["train"]
        require(tr["model_shard"], "tp_train: the step did not compute on its model shard")
        require(not any(tr["kernels"].values()),
                f"tp_train rank {rank}: a kernel launched on the training path: {tr['kernels']}")
        for i, (st, (b_loss, b_gn, _, _)) in enumerate(zip(tr["steps"], train_base)):
            tol = TP_TRAIN_RTOL0 if i == 0 else TP_TRAIN_RTOL
            lg, gg = abs(st["loss"] - b_loss) / abs(b_loss), abs(st["grad_norm"] - b_gn) / abs(b_gn)
            gathers = sorted(k for k in st["collectives"] if k.startswith("gather"))
            say("tp_train_step", rank=rank, step=i, loss=f"{st['loss']:.6f}",
                grad_norm=f"{st['grad_norm']:.6f}", loss_rel_gap=f"{lg:.3e}",
                grad_norm_rel_gap=f"{gg:.3e}", bar=tol, ms=f"{1e3 * st['s']:.1f}",
                tokens_per_s=f"{tokens / st['s']:.0f}", gathers=gathers,
                collectives=st["collectives"], card=repr(card))
            require(lg <= tol and gg <= tol, f"tp_train rank {rank} step {i}: loss "
                    f"{st['loss']} / {b_loss}, grad norm {st['grad_norm']} / {b_gn}")
            require(not gathers, f"tp_train rank {rank} step {i}: gathers {gathers} in a step")
        require(len(tr["steps"]) == len(train_base) == MT_STEPS,
                f"tp_train rank {rank}: {len(tr['steps'])} steps")
    same = all(a["replicated"] == b["replicated"] for a, b in
               zip(ranks[0]["train"]["steps"], ranks[1]["train"]["steps"]))
    n_rep = len(ranks[0]["train"]["steps"][0]["replicated"])
    require(same and n_rep > 0, f"tp_train: the {n_rep} leaves replicated along model differ "
                                "across the ranks")
    steady = statistics.median(st["s"] for st in ranks[0]["train"]["steps"][1:])
    say("tp_train", mesh="1x1x2", ranks=TP_RANKS, steps=MT_STEPS, seq_len=MT_SEQ,
        global_batch=MT_BATCH, microbatches=MT_MICRO, steady_step_ms=f"{1e3 * steady:.1f}",
        tokens_per_s=f"{tokens / steady:.0f}", replicated_leaves_bit_identical=n_rep,
        param_gb_rank=f"{ranks[0]['train']['param_bytes'] / 1e9:.4f}",
        peak_alloc_gb_rank=",".join(f"{r['train']['peak_gb']:.2f}" for r in ranks),
        card=repr(card))

    # [tp_dryrun]: the (1, 1, 2) cell's record against the ranks' last step
    rec = record.get("cell")
    require(isinstance(rec, dict), f"tp dry run of the (1, 1, 2) smollm cell failed: {rec}")
    for rank, r in enumerate(ranks):
        last = r["train"]["steps"][-1]
        same = (rec["memory_analysis"]["argument_size_in_bytes"] == last["arg_bytes"]
                and rec["collectives"] == last["collectives"] and rec["model_shard"])
        say("tp_dryrun", rank=rank, mesh=rec["mesh"], model_shard=rec["model_shard"],
            argument_bytes=rec["memory_analysis"]["argument_size_in_bytes"],
            rank_argument_bytes=last["arg_bytes"], collectives=rec["collectives"],
            rank_collectives=last["collectives"], equal=same,
            flops=rec["flops_corrected"], lower_s=rec["lower_s"], card=repr(card))
        require(same, f"tp dry run: arguments and collectives differ from rank {rank}'s")

    # [kernel_time]: the two kernels at their per-rank shapes
    gen = torch.Generator(device=dev).manual_seed(26)
    l2 = torch.zeros(32 * 1024 * 1024, device=dev)
    name, c = TP_ATTN_SHAPE
    a_time = fa_time_at(name, c, dev, card, gen, l2)
    a_err = a_time[7]
    Bsz, T, Dm, N = TP_SCAN_SHAPE
    x = torch.randn((Bsz, T, Dm), generator=gen, device=dev)
    dl = 0.001 + 0.799 * torch.rand((Bsz, T, Dm), generator=gen, device=dev)
    A = -torch.arange(1, N + 1, dtype=torch.float32, device=dev).expand(Dm, N).contiguous()
    Bm, Cm = (torch.randn((Bsz, T, N), generator=gen, device=dev) for _ in range(2))
    with torch.no_grad():
        got = scan_ops.ssm_scan(x, dl, A, Bm, Cm)
        sync(dev)
        s_err = check_close(f"ssm_scan B{Bsz}_T{T}_D{Dm}_N{N}", list(got),
                            list(scan_ops.ssm_scan_ref(x, dl, A, Bm, Cm, None)), TOL)
        s_ms = time_ms(lambda: scan_ops.ssm_scan(x, dl, A, Bm, Cm), l2)
        s_calls = launches_per_call(lambda: scan_ops.ssm_scan(x, dl, A, Bm, Cm))
        s_plain = time_ms(lambda: scan_ops.ssm_scan_ref(x, dl, A, Bm, Cm), l2, reps=5)
    s_bnd, s_by = scan_bound_ms(Bsz, T, Dm, N)
    say("kernel_time", kernel="ssm_scan", B=Bsz, T=T, D=Dm, N=N, max_abs_err=f"{s_err:.3e}",
        tol=TOL, ms=f"{s_ms:.4f}", plain_ms=f"{s_plain:.4f}", library_ms="none",
        bound_ms=f"{s_bnd:.4f}", bound_by=s_by, bound_share=f"{s_bnd / s_ms:.3f}",
        launches_per_call=s_calls, reps=REPS, card=repr(card))
    require(s_calls == 1, f"ssm_scan at D = {Dm}: {s_calls} launches a call")
    say("tp", case="seconds", ranks_and_dry_run=f"{ranks_s:.1f}",
        phase_27_in_the_ranks=moe_serves is not None)
    shutil.rmtree(root, ignore_errors=True)
    return {"launches": launches, "max_abs_err": max(a_err, s_err), "attn": (name, a_time),
            "moe_ranks": [r.get("tp_moe") for r in ranks],
            "cross_ranks": [r.get("tp_cross") for r in ranks], "cross_record": cross_record,
            "scan": {"ms_D4096": s_ms, "plain_ms_D4096": s_plain, "bound_ms_D4096": s_bnd,
                     "bound_by_D4096": s_by, "max_abs_err_D4096": s_err}}


# ---------------------------------------------------------------------------
# 27. tp_moe: MoE experts and MLA heads on the model shard
# ---------------------------------------------------------------------------

def tp_moe_rank(dev, mesh, plan, serves: dict, smoke: bool) -> dict:
    """Phase 27 on one of two ranks sharing the card over gloo (``tp_ranks``
    runs it after phase 26's work): olmoe-1b-7b and deepseek-v2-lite-16b
    served at tp = 2 (their weights drawn in turn), each by one server with
    a prefix cache: the requests under ``step()`` (one-shot prefills, each
    checkpointed), then again under ``step_block()`` (every prompt a full
    hit: the prefills are not repeated), routing recorded; then
    olmoe-1b-7b (``MM_LAYERS``) trained at (1, 1, 2) on phase 24's
    ``MM_SEQS[0]`` cell."""
    out, seconds = {}, {}
    for arch, (n_layers, traffic, uids) in serves.items():
        t0 = time.perf_counter()
        mcfg, params, full_bytes, resident = tp_weights(arch, n_layers, dev, plan, smoke)
        seconds[f"{arch}:weights"] = time.perf_counter() - t0
        out[arch] = {"full_bytes": full_bytes, "resident_bytes": resident}
        srv = None
        for label, block in (("step", False), ("step_block", True)):
            t0 = time.perf_counter()
            run = tp_drive(mcfg, params, traffic, SERVE_SLOTS, MOE_MAX_SEQ, dev, plan,
                           uids=uids, block=block, routes=True, srv=srv,
                           uid0=TP_MOE_AGAIN if block else 0,
                           prefix_cache_bytes=TP_MOE_PREFIX_BYTES)
            srv = run.pop("srv")
            out[arch][label] = run
            seconds[f"{arch}:{label}"] = time.perf_counter() - t0
        del params, srv
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    before = kernel_counts()
    t0 = time.perf_counter()
    out["train"] = moe_mesh_steps(moe_mesh_config(smoke), MM_SEQS[0], dev, mesh,
                                  replicated=True)
    seconds["train"] = time.perf_counter() - t0
    after = kernel_counts()
    out["train"]["kernels"] = {k: after[k] - before[k] for k in after}
    out["seconds"] = {k: round(v, 1) for k, v in seconds.items()}
    return out


def tp_moe_started(dev, oracles: dict, *, smoke: bool = False,
                   layers: dict | None = None) -> dict:
    """Phase 27's start, before phase 26 spawns the ranks that run it:
    ``{"serves"}`` for ``tp_ranks`` (olmoe-1b-7b and deepseek-v2-lite-16b
    on ``TP_MOE_PICK``'s requests of ``oracles``, phase 20's records) and
    the dry run of 1-layer olmoe's (1, 1, 2) cell, already running in a
    thread."""
    layers = layers or {"olmoe-1b-7b": OLMOE_LAYERS, "deepseek-v2-lite-16b": DEEPSEEK_LAYERS}
    dev_name = "cuda:0" if dev.type == "cuda" else "cpu"
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        say("tp_moe", case="parent_memory", alloc_gb=f"{torch.cuda.memory_allocated() / 1e9:.2f}",
            reserved_gb=f"{torch.cuda.memory_reserved() / 1e9:.2f}")
    thread, record = dry_run_started("olmoe-1b-7b", moe_mesh_config(smoke),
                                     moe_mesh_shape(MM_SEQS[0]), MM_MICRO, dev_name)
    return {"serves": {arch: (layers[arch], [oracles[arch]["traffic"][i] for i in pick], pick)
                       for arch, pick in TP_MOE_PICK.items()},
            "thread": thread, "record": record, "t0": time.perf_counter()}


def tp_moe_phase(dev, card: str, job: dict, ranks: list, oracles: dict, train_base: dict,
                 beside: tuple, *, smoke: bool = False) -> dict:
    """Phase 27's checks.  ``job``: ``tp_moe_started``'s; ``ranks``: each
    rank's ``tp_moe_rank`` result (phase 26's ``"moe_ranks"``);
    ``oracles``: phase 20's ``serve_moe`` records of olmoe-1b-7b and
    deepseek-v2-lite-16b (``plan=None``, ``step()``); ``train_base``: phase
    24's ``mesh=None`` run at ``MM_SEQS[0]``; ``beside``: (g)'s
    ``attn_time`` entry, printed beside (k).  Returns the ranks'
    ``flash_attention`` calls and launches and (k)'s timing."""
    serves, record = job["serves"], job["record"]
    job["thread"].join()
    ranks_s = time.perf_counter() - job["t0"]
    mcfg = moe_mesh_config(smoke)
    require(len(ranks) == TP_RANKS and all(r is not None for r in ranks),
            "tp_moe: the ranks returned no phase-27 results")

    # [tp_moe_serve]: tokens, logits under the routing rule, bytes and launches
    launches = {"flash_attention": 0, "flash_attention_calls": 0}
    for arch, (n_layers, traffic, uids) in serves.items():
        oracle, bar = oracles[arch], TP_MOE_LOGIT_GAP[arch]
        full_want, share_want = tp_share_bytes(arch, n_layers, TP_RANKS, smoke)
        for rank, r in enumerate(ranks):
            res = r[arch]
            share = res["resident_bytes"] / res["full_bytes"]
            require(res["full_bytes"] == full_want
                    and abs(res["resident_bytes"] - share_want) <= TP_RESIDENT_RTOL * share_want,
                    f"tp_moe {arch} rank {rank}: {res['resident_bytes']} of {res['full_bytes']} "
                    f"bytes resident, reckoned {share_want} of {full_want}")
            for label in ("step", "step_block"):
                run = res[label]
                # step_block()'s requests resume step()'s prefills from the cache
                routes = {k: v for k, v in res["step"]["routes"].items()
                          if k[0] == "prefill"} | run["routes"]
                held, gaps, scale, flips = 0, {"prefill": 0.0, "decode": 0.0}, 0.0, []
                for uid in uids:
                    clean, flip = route_flip_rule(routes, oracle["routes"], uid)
                    toks, want = run["tokens"][uid], list(oracle["tokens"][uid])
                    if flip is not None:
                        require(flip["max_margin"] < ROUTE_MARGIN,
                                f"tp_moe {arch} rank {rank} {label}: request {uid} routes "
                                f"differently from plan=None at {flip['key']} layer "
                                f"{flip['layer']}, margin {flip['max_margin']:.3e}: not a "
                                f"near-tie (< {ROUTE_MARGIN})")
                        flips.append(f"{uid}@{flip['key'][1]}:L{flip['layer']}:"
                                     f"{flip['max_margin']:.2e}")
                    else:
                        require(toks == want, f"tp_moe {arch} rank {rank} {label}: request "
                                f"{uid}'s tokens {toks} differ from phase 20's {want} with "
                                "equal routing")
                    for key in clean:
                        if key not in run["logits"]:
                            continue
                        ref = oracle["logits"][key]
                        kind = "prefill" if key[0] == "prefill" else "decode"
                        gaps[kind] = max(gaps[kind], float(np.abs(run["logits"][key] - ref).max())
                                         / float(np.abs(ref).max()))
                        scale = max(scale, float(np.abs(ref).max()))
                        held += 1
                gap = max(gaps.values())
                require(gap <= bar, f"tp_moe {arch} rank {rank} {label}: logits {gaps} of "
                                    f"max |logit| from phase 20's where the routing agrees")
                require(held >= MOE_NEW - 1,
                        f"tp_moe {arch} rank {rank} {label}: only {held} logit rows held")
                same_tokens = all(run["tokens"][u] == list(oracle["tokens"][u]) for u in uids)
                calls, fa_launches = run["counts"]["flash_attention"]
                fresh = label == "step"       # step_block()'s prompts are all full hits
                require(run["oneshot_prefills"] == (len(uids) if fresh else 0)
                        and run["prefix_hits"] == (0 if fresh else len(uids))
                        and (fresh or run["prompt_steps"] == 0),
                        f"tp_moe {arch} rank {rank} {label}: {run['oneshot_prefills']} one-shot "
                        f"prefills, {run['prefix_hits']} prefix hits, {run['prompt_steps']} "
                        "prompt steps")
                want_calls = 0 if arch == "deepseek-v2-lite-16b" else \
                    n_layers * run["oneshot_prefills"]
                require(calls == want_calls and fa_launches == run["want_fa_launches"],
                        f"tp_moe {arch} rank {rank} {label}: flash_attention {calls} calls, "
                        f"{fa_launches} launches for {run['oneshot_prefills']} one-shot "
                        "prefills")
                launches["flash_attention"] += fa_launches
                launches["flash_attention_calls"] += calls
                say("tp_moe_serve", arch=arch, rank=rank, driver=label, tp=TP_RANKS,
                    layers=n_layers, requests=",".join(f"{u}:{len(p)}+{n}" for u, (p, n)
                                                       in zip(uids, traffic)),
                    prefix_hits=run["prefix_hits"], identical_tokens=same_tokens,
                    route_flips=flips or "none",
                    logit_rows_held=held, rel_gap=f"{gap:.3e}",
                    rel_gap_prefill=f"{gaps['prefill']:.3e}",
                    rel_gap_decode=f"{gaps['decode']:.3e}", bar=bar,
                    max_abs_logit=f"{scale:.3e}",
                    plan_none_control=oracle["control"],
                    plan_none_control_gap={len(p): oracle["control_gaps"].get(len(p))
                                           for p, _ in traffic},
                    resident_gb=f"{res['resident_bytes'] / 1e9:.4f}",
                    full_gb=f"{res['full_bytes'] / 1e9:.4f}", share=f"{share:.4f}",
                    reckoned_gb=f"{share_want / 1e9:.4f}", cache=run["cache_shapes"],
                    flash_attention_calls=calls, launches=fa_launches,
                    decode_tok_s=f"{run['decode_tok_s']:.1f}",
                    decode_tok_s_plan_none=f"{oracle['decode_tok_s']:.1f}",
                    prefill_ms_by_len={n: f"{ms:.1f}" for n, ms in
                                       sorted(run["prefill_ms_by_len"].items())},
                    prefill_ms_by_len_plan_none={len(p): f"{oracle['prefill_ms_by_len'][len(p)]:.1f}"
                                                 for p, _ in traffic},
                    peak_alloc_gb=f"{run['peak_gb']:.2f}", card=repr(card))
            require(res["step"]["tokens"] == res["step_block"]["tokens"],
                    f"tp_moe {arch} rank {rank}: step_block's tokens differ from step()'s")
        for label in ("step", "step_block"):
            require(ranks[0][arch][label]["host_state"] == ranks[1][arch][label]["host_state"]
                    and ranks[0][arch][label]["routes"].keys()
                    == ranks[1][arch][label]["routes"].keys()
                    and all(all(np.array_equal(a[0], b[0]) for a, b in
                                zip(ranks[0][arch][label]["routes"][k],
                                    ranks[1][arch][label]["routes"][k], strict=True))
                            for k in ranks[0][arch][label]["routes"]),
                    f"tp_moe {arch} {label}: the ranks' host states or routing differ")

    # [tp_moe_train]: against phase 24's mesh=None run
    tokens = MM_BATCH * MM_SEQS[0]
    for rank, r in enumerate(ranks):
        tr = r["train"]
        require(not any(tr["kernels"].values()),
                f"tp_moe_train rank {rank}: a kernel launched on the training path: "
                f"{tr['kernels']}")
        rg = route_gap(tr["routes"], train_base["routes"], 1, 0, True)
        for i, ((loss, gn, sec), (b_loss, b_gn, _)) in enumerate(zip(tr["steps"],
                                                                  train_base["steps"])):
            same_routes = not any(rg["flips"][:i + 1])
            lg, gg = abs(loss - b_loss) / abs(b_loss), abs(gn - b_gn) / abs(b_gn)
            tol = TP_TRAIN_RTOL0 if i == 0 else TP_TRAIN_RTOL
            say("tp_moe_train_step", rank=rank, step=i, loss=f"{loss:.6f}",
                grad_norm=f"{gn:.6f}", loss_rel_gap=f"{lg:.3e}", grad_norm_rel_gap=f"{gg:.3e}",
                routing_flips=rg["flips"][i], held_to=tol if same_routes else "none",
                flip_margin=f"{rg['margin']:.3e}" if rg["flips"][i] else "none",
                ms=f"{1e3 * sec:.1f}", tokens_per_s=f"{tokens / sec:.0f}",
                mesh_none_ms=f"{1e3 * train_base['steps'][i][2]:.1f}", card=repr(card))
            require(math.isfinite(loss) and math.isfinite(gn),
                    f"tp_moe_train rank {rank} step {i}: loss {loss}, grad norm {gn}")
            if same_routes:
                require(lg <= tol and gg <= tol, f"tp_moe_train rank {rank} step {i}: loss "
                        f"{loss} / {b_loss}, grad norm {gn} / {b_gn}")
            elif not any(rg["flips"][:i]):
                require(rg["margin"] < ROUTE_MARGIN,
                        f"tp_moe_train rank {rank} step {i}: routing flips with margin "
                        f"{rg['margin']:.3e}, not a near-tie")
        gathers = sorted(k for k in tr["collectives"] if k.startswith("gather"))
        require(not gathers, f"tp_moe_train rank {rank}: gathers {gathers} in a step")
    reps = [r["train"]["replicated"] for r in ranks]
    n_rep = len(reps[0][0])
    require(n_rep > 0 and all(a == b for a, b in zip(*reps, strict=True))
            and any("router" in k for k in reps[0][0]),
            f"tp_moe_train: the {n_rep} leaves replicated along model differ across the ranks")
    steady = statistics.median(x[2] for x in ranks[0]["train"]["steps"][1:]) \
        if len(ranks[0]["train"]["steps"]) > 1 else ranks[0]["train"]["steps"][0][2]
    say("tp_moe_train", mesh="1x1x2", ranks=TP_RANKS, layers=mcfg.n_layers, steps=MM_STEPS,
        seq_len=MM_SEQS[0], global_batch=MM_BATCH, microbatches=MM_MICRO,
        step_ms=f"{1e3 * steady:.1f}", tokens_per_s=f"{tokens / steady:.0f}",
        mesh_none_step_ms=f"{1e3 * statistics.median(x[2] for x in train_base['steps'][1:]):.1f}",
        replicated_leaves_bit_identical=n_rep, collectives=ranks[0]["train"]["collectives"],
        peak_alloc_gb_rank=",".join(f"{r['train']['peak_gb']:.2f}" for r in ranks),
        card=repr(card))

    # [tp_moe_dryrun]: the (1, 1, 2) cell's record against the ranks' last step
    rec = record.get("cell")
    require(isinstance(rec, dict), f"tp_moe dry run of the (1, 1, 2) olmoe cell failed: {rec}")
    for rank, r in enumerate(ranks):
        tr = r["train"]
        same = (rec["memory_analysis"]["argument_size_in_bytes"] == tr["arg_bytes"]
                and rec["collectives"] == tr["collectives"] and rec["model_shard"])
        say("tp_moe_dryrun", rank=rank, mesh=rec["mesh"], model_shard=rec["model_shard"],
            argument_bytes=rec["memory_analysis"]["argument_size_in_bytes"],
            rank_argument_bytes=tr["arg_bytes"], collectives=rec["collectives"],
            rank_collectives=tr["collectives"], equal=same,
            flops=rec["flops_corrected"], lower_s=rec["lower_s"], card=repr(card))
        require(same, f"tp_moe dry run: arguments and collectives differ from rank {rank}'s")

    # [kernel_time]: flash_attention at a rank's olmoe heads, beside (g)
    gen = torch.Generator(device=dev).manual_seed(27)
    l2 = torch.zeros(32 * 1024 * 1024, device=dev)
    name, c = TP_MOE_ATTN_SHAPE
    g_name, g = beside
    a_time = fa_time_at(name, c, dev, card, gen, l2, beside_shape=g_name,
                        beside_ms=f"{g[0]:.4f}", beside_library_ms=f"{g[2]:.4f}",
                        beside_over_library=f"{g[0] / g[2]:.3f}")
    say("tp_moe", case="seconds", since_start_with_phase_26=f"{ranks_s:.1f}",
        rank0=ranks[0]["seconds"], dry_run_lower_s=rec["lower_s"])
    return {"launches": launches, "attn": (name, a_time)}

# ---------------------------------------------------------------------------
# 28. tp16: attention whose heads do not cut whole, at tp = 16
# ---------------------------------------------------------------------------

def tp16_train_config(smoke: bool = False):
    """internlm2-20b at its widths, ``TP16_TRAIN_LAYERS`` layers (the smoke
    config's widths when rehearsing on the CPU)."""
    from repro_torch.configs import get_config, get_smoke_config

    return dataclasses.replace((get_smoke_config if smoke else get_config)("internlm2-20b"),
                               n_layers=TP16_TRAIN_LAYERS)


def tp16_trainer(mcfg, ckpt_dir: Path, dev, mesh):
    """``TP16_TRAIN_STEPS`` steps of ``TP16_TRAIN``, one microbatch, every
    step logged, no checkpoint (a rank's shards are drawn from the seed as
    they are cut: ``ShardLayout.draw``)."""
    from repro_torch import optim
    from repro_torch.data import DataConfig
    from repro_torch.runtime import Trainer, TrainerConfig

    B, S = TP16_TRAIN
    tcfg = TrainerConfig(total_steps=TP16_TRAIN_STEPS, ckpt_every=0, ckpt_dir=str(ckpt_dir),
                         log_every=1, microbatches=1, ckpt_async=False)
    ocfg = optim.AdamWConfig(lr_peak=3e-4, warmup_steps=2, total_steps=TP16_TRAIN_STEPS)
    return Trainer(mcfg, tcfg, ocfg, DataConfig(vocab=mcfg.vocab, seq_len=S, global_batch=B),
                   mesh, device=dev)


def tp16_control(dev, root: Path, smoke: bool = False) -> tuple[list, float]:
    """The training cell with ``mesh=None`` on this process's card: each
    step's (loss, grad norm, seconds) and the peak GB; its state (~24.5 GB
    at full width) is freed before the ranks start."""
    cuda = dev.type == "cuda"
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    trainer = tp16_trainer(tp16_train_config(smoke), root / "none", dev, None)
    res = trainer.run()
    sync(dev)
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    steps = [(m["loss"], m["grad_norm"], m["sec"]) for m in res["metrics"]]
    require(len(steps) == TP16_TRAIN_STEPS and all(math.isfinite(x[0]) for x in steps),
            f"tp16: the mesh=None control logged {len(steps)} steps: {steps}")
    del trainer, res
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return steps, peak


def tp16_rank(rank: int, world: int, dev_name: str, job_path: str, smoke: bool, root: str,
              sizes: dict) -> dict:
    """One of ``TP16_RANKS`` ranks sharing the card over gloo at (1, 1,
    world), on the job ``tp16_phase`` wrote to ``job_path``: first the
    training cell through ``Trainer(mesh=)`` (``tp_train``: its state
    fits beside sixteen fresh contexts, not after the serving's kernels
    grew them), then internlm2-20b served through ``DecodeServer(plan=)``
    (the collectives of the run and the checksums of its caches beside
    ``tp_drive``'s record), then llama-3.2-vision-90b's prefill and greedy
    decode (``vlm_rank_drive``); each model freed before the next, the
    card's free GB read after each."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import comm
    from repro_torch.parallel.zero import param_shapes
    from repro_torch.runtime import ShardPlan

    with open(job_path, "rb") as f:
        job = pickle.load(f)
    stamps = {"entered": time.time() - job["spawned"]}
    _phase_sizes(sizes)
    # sixteen ranks' draws leave their blocks inside segments that held
    # whole leaves: expandable segments give those pages back
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    dev = _rank_device(dev_name)
    mesh = make_local_mesh(1, world)
    plan = ShardPlan(mesh)
    tcfg = tp16_train_config(smoke)
    param_shapes(tcfg)      # traced once a process, here and not in a rank's turn
    # the draw's kernels loaded by every rank at once, not each in its turn
    torch.randn((1024,), generator=torch.Generator(device=dev).manual_seed(0),
                device=dev).div(3.0).mul(0.5).clone()
    stamps["ready"] = time.time() - job["spawned"]
    # the parent's mesh=None control holds the card until it writes this file
    while not os.path.exists(job["go"]):
        time.sleep(0.1)
    stamps["go"] = time.time() - job["spawned"]
    cuda = dev.type == "cuda"
    free = {}

    def fresh(at: str):
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            free[at] = torch.cuda.mem_get_info()[0] / 1e9

    out = {"free_gb": free, "stamps": stamps}
    fresh("start")
    t0 = time.perf_counter()
    out["train"] = tp_train(dev, mesh, smoke, Path(root), make=lambda: in_turns(
        lambda: tp16_trainer(tcfg, Path(root) / "tp16", dev, mesh), dev, plan, at_once=4))
    out["train"]["seconds"] = time.perf_counter() - t0
    fresh("trained")
    t0 = time.perf_counter()
    mcfg, params, full_bytes, resident = tp_weights("internlm2-20b", job["internlm_layers"],
                                                    dev, plan, smoke, at_once=4)
    comm.reset_counts()
    run = tp_drive(mcfg, params, job["traffic"], SERVE_SLOTS, GEMMA_MAX_SEQ, dev, plan,
                   uids=job["uids"])
    srv = run.pop("srv")
    out["internlm2-20b"] = run | {
        "collectives": comm.counters(), "full_bytes": full_bytes, "resident_bytes": resident,
        "cache_sums": leaf_checksums(srv.caches, lambda path: True),
        "seconds": time.perf_counter() - t0}
    del srv, params
    fresh("served")
    t0 = time.perf_counter()
    comm.reset_counts()
    # the serving above ran every kernel the prefill calls: no warm-up
    out["llama"] = vlm_rank_drive(dev, mesh, plan, job["llama"], smoke, warm=False)
    out["llama"] |= {"collectives": comm.counters(), "seconds": time.perf_counter() - t0}
    fresh("vlm_done")
    out["jax"] = "jax" in sys.modules
    return out


def tp16_phase(dev, card: str, oracles: dict, *, smoke: bool = False,
               ranks: int = TP16_RANKS) -> dict:
    """Phase 28.  ``oracles``: ``{"internlm2-20b": phase 18's record,
    "llama-3.2-vision-90b": phase 25's}``.  The dry run of the training
    cell at (1, 1, ``ranks``) and ``ranks`` gloo ranks (``tp16_rank``)
    start first, beside the ``mesh=None`` control (``tp16_control``), which
    the ranks wait for before they allocate; their results are held to the
    oracles and the control; then ``flash_attention`` at (n) and (o).
    Returns the kernel's calls and launches by model and the two shapes'
    timings."""
    from repro_torch.launch.spawn import run_ranks
    from repro_torch.models.config import ShapeSpec

    root = ROOT / "build" / "tp16"
    shutil.rmtree(root, ignore_errors=True)
    dev_name = "cuda:0" if dev.type == "cuda" else "cpu"
    i_or, v_or = oracles["internlm2-20b"], oracles["llama-3.2-vision-90b"]
    t0 = time.perf_counter()
    B, S = TP16_TRAIN
    thread, record = dry_run_started("internlm2-20b", tp16_train_config(smoke),
                                     ShapeSpec(f"train_S{S}", S, B, "train"), 1, dev_name,
                                     tp=ranks)
    i_layers = INTERNLM_LAYERS if not smoke else 2
    job = {"internlm_layers": i_layers,
           "traffic": [(i_or["traffic"][i][0], TP16_NEW) for i in TP16_PICK],
           "uids": TP16_PICK,
           "llama": {"n_layers": v_or["n_layers"], "memory": v_or["memory"].numpy(),
                     "tokens": v_or["tokens"].numpy(), "out": v_or["out"][:TP16_VLM_NEW]},
           "go": str(root / "go"), "spawned": time.time()}
    sizes = {k: globals()[k] for k in ("SERVE_SLOTS", "GEMMA_MAX_SEQ", "TP16_TRAIN",
                                       "TP16_TRAIN_STEPS", "TP16_TRAIN_LAYERS", "TP16_NEW")}
    # the job goes by file: a spawned rank reads its arguments only after
    # importing this script, so arguments past a pipe's buffer would start
    # the ranks one after another
    job_path = root / "job.pkl"
    job_path.parent.mkdir(parents=True, exist_ok=True)
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    spawned = {}

    def spawn():
        try:
            spawned["runs"] = run_ranks(tp16_rank, ranks, (dev_name, str(job_path), smoke,
                                                           str(root), sizes),
                                        backend="gloo", timeout_s=900)
        except BaseException as e:  # noqa: BLE001 - raised below
            spawned["runs"] = e

    # the ranks start (~20 s of imports) while the control runs; they touch
    # the card's memory only once it is done (job["go"])
    ranks_thread = threading.Thread(target=spawn)
    ranks_thread.start()
    try:
        free0 = torch.cuda.mem_get_info()[0] / 1e9 if dev.type == "cuda" else 0.0
        base, base_peak = tp16_control(dev, root, smoke)
        control_s = time.perf_counter() - t0
    finally:
        Path(job["go"]).touch()
        ranks_thread.join()
        thread.join()
    runs = spawned["runs"]
    if isinstance(runs, BaseException):
        raise runs
    ranks_s = time.perf_counter() - t0
    require(len(runs) == ranks and not any(r["jax"] for r in runs),
            f"tp16: {len(runs)} ranks returned, or a rank imported jax")
    launches = {}
    # the card's free memory as each rank saw it (the least over the ranks)
    say("tp16", case="card_free_gb", before_ranks=f"{free0:.2f}",
        **{at: f"{min(r['free_gb'][at] for r in runs):.2f}" for at in runs[0]["free_gb"]})
    # seconds from the spawn to each rank's start, its readiness (card, mesh,
    # shapes) and the control's end (the latest rank)
    say("tp16", case="rank_start_s",
        **{at: f"{max(r['stamps'][at] for r in runs):.1f}" for at in runs[0]["stamps"]})

    def share(arch, n_layers, run, rank):
        full_want, share_want = tp_share_bytes(arch, n_layers, ranks, smoke)
        require(run["full_bytes"] == full_want
                and abs(run["resident_bytes"] - share_want) <= TP_RESIDENT_RTOL * share_want,
                f"tp16 {arch} rank {rank}: {run['resident_bytes']} of {run['full_bytes']} "
                f"bytes resident, reckoned {share_want} of {full_want}")

    def same_on_every_rank(what, values):
        require(len(values[0]) > 0 and all(v == values[0] for v in values),
                f"tp16: {what} differ across the ranks")

    def peaks(part):
        return max(r[part]["peak_gb"] for r in runs), sum(r[part]["peak_gb"] for r in runs)

    # [tp16_serve]: internlm2-20b against phase 18's plan=None run
    arch, gap, scale = "internlm2-20b", 0.0, 0.0
    calls = fa_launches = 0
    for rank, r in enumerate(runs):
        run = r[arch]
        for uid, toks in run["tokens"].items():
            want = list(i_or["tokens"][uid])[:len(toks)]
            require(len(toks) == TP16_NEW and toks == want,
                    f"tp16 {arch} rank {rank}: request {uid}'s tokens {toks} differ from the "
                    f"plan=None run's {want}")
        keys = sorted(run["logits"], key=str)
        missing = [k for k in keys if k not in i_or["logits"]]
        require(keys and not missing, f"tp16 {arch} rank {rank}: {len(missing)} of "
                                      f"{len(keys)} logit rows missing from the oracle")
        gap = max(gap, max(float(np.abs(run["logits"][k] - i_or["logits"][k]).max())
                           for k in keys))
        scale = max(scale, max(float(np.abs(i_or["logits"][k]).max()) for k in keys))
        share(arch, job["internlm_layers"], run, rank)
        n_pre = len(job["traffic"])
        c, n = run["counts"]["flash_attention"]
        require(c == job["internlm_layers"] * n_pre and n == run["want_fa_launches"],
                f"tp16 {arch} rank {rank}: flash_attention {c} calls, {n} launches for "
                f"{n_pre} one-shot prefills of {job['internlm_layers']} layers")
        calls, fa_launches = calls + c, fa_launches + n
    require(gap <= TP_LOGIT_GAP * scale, f"tp16 {arch}: logits {gap:.3e} from the plan=None "
                                         f"run's (max |logit| {scale:.3e})")
    same_on_every_rank(f"{arch}'s host states", [r[arch]["host_state"] for r in runs])
    same_on_every_rank(f"{arch}'s replicated caches", [r[arch]["cache_sums"] for r in runs])
    launches[arch] = (calls, fa_launches)
    r0 = runs[0][arch]
    say("tp16_serve", arch=arch, ranks=ranks, layers=job["internlm_layers"],
        requests=len(job["traffic"]), new_tokens=TP16_NEW, identical_tokens=True,
        logit_rows=len(r0["logits"]), max_abs_gap=f"{gap:.3e}", max_abs_logit=f"{scale:.3e}",
        rel_gap=f"{gap / scale:.3e}", bar=TP_LOGIT_GAP, cache=r0["cache_shapes"],
        caches_bit_identical=True, resident_gb_rank=f"{r0['resident_bytes'] / 1e9:.4f}",
        full_gb=f"{r0['full_bytes'] / 1e9:.4f}",
        sixteenth_gb=f"{r0['full_bytes'] / ranks / 1e9:.4f}",
        share=f"{r0['resident_bytes'] / r0['full_bytes']:.5f}",
        flash_attention_calls=calls, launches=fa_launches,
        decode_tok_s=f"{r0['decode_tok_s']:.1f}",
        decode_tok_s_plan_none=f"{i_or['decode_tok_s']:.1f}",
        prefill_ms=f"{r0['prefill_ms']:.2f}", prefill_ms_plan_none=f"{i_or['prefill_ms']:.2f}",
        prefill_ms_by_len=r0["prefill_ms_by_len"], collectives=r0["collectives"],
        peak_alloc_gb_max_rank="{:.2f}".format(peaks(arch)[0]),
        peak_alloc_gb_sum_ranks="{:.2f}".format(peaks(arch)[1]),
        seconds_rank0=f"{r0['seconds']:.1f}", card=repr(card))

    # [tp16_vlm]: llama-3.2-vision-90b against phase 25's runs
    arch, worst, worst_plain = "llama-3.2-vision-90b", 0.0, 0.0
    calls = fa_launches = 0
    want_out = v_or["out"][:TP16_VLM_NEW]
    for rank, r in enumerate(runs):
        run = r["llama"]
        n = run["last_logits"].shape[-1]
        scale = float(v_or["last_logits"].abs().max())
        mine = v_or["last_logits"][..., rank * n:(rank + 1) * n]
        g = float((torch.from_numpy(run["last_logits"]) - mine).abs().max()) / scale
        mine_p = v_or["last_logits_plain"][..., rank * n:(rank + 1) * n]
        gp = float((torch.from_numpy(run["last_logits"]) - mine_p).abs().max()) / scale
        worst, worst_plain = max(worst, g), max(worst_plain, gp)
        require(run["model_shard"], f"tp16 {arch}: a step did not compute on its model shard")
        require(run["tokens"] == want_out, f"tp16 {arch} rank {rank}: greedy tokens "
                f"{run['tokens']} differ from phase 25's {want_out}")
        require((run["calls"], run["launches"]) == run["want"]
                and run["calls"] == v_or["calls_per_prefill"],
                f"tp16 {arch} rank {rank}: flash_attention calls, launches "
                f"{(run['calls'], run['launches'])}, not {run['want']}")
        share(arch, v_or["n_layers"], run, rank)
        calls, fa_launches = calls + run["calls"], fa_launches + run["launches"]
    require(worst <= TP_CROSS_VLM_LOGIT_GAP,
            f"tp16 {arch}: last logits {worst:.3e} of max |logit| from phase 25's kernel prefill")
    same_on_every_rank(f"{arch}'s replicated caches", [r["llama"]["cache_sums"] for r in runs])
    launches[arch] = (calls, fa_launches)
    r0 = runs[0]["llama"]
    say("tp16_vlm", arch=arch, ranks=ranks, layers=v_or["n_layers"], gate=LLAMA_GATE,
        prompt_len=v_or["tokens"].shape[1], memory="x".join(map(str, v_or["memory"].shape)),
        rel_gap=f"{worst:.3e}", bar=TP_CROSS_VLM_LOGIT_GAP, planned_bar=TP_CROSS_LOGIT_GAP,
        planned_bar_met=worst <= TP_CROSS_LOGIT_GAP, rel_gap_to_plain=f"{worst_plain:.3e}",
        one_device_plain_rel_gap=f"{v_or['controls']['plain']:.3e}",
        one_device_chunk_chain_rel_gap=f"{v_or['controls']['chunk_chain']:.3e}",
        new_tokens=len(want_out), tokens_equal_phase_25=True, cache=r0["cache"],
        caches_bit_identical=True, flash_attention_calls=calls, launches=fa_launches,
        prefill_ms=f"{r0['prefill_ms']:.2f}", prefill_ms_plan_none=f"{v_or['prefill_ms']:.2f}",
        decode_ms_per_token=f"{r0['decode_ms']:.2f}",
        decode_ms_per_token_plan_none=f"{v_or['decode_ms']:.2f}",
        resident_gb_rank=f"{r0['resident_bytes'] / 1e9:.4f}",
        full_gb=f"{r0['full_bytes'] / 1e9:.4f}",
        sixteenth_gb=f"{r0['full_bytes'] / ranks / 1e9:.4f}",
        collectives=r0["collectives"], peak_alloc_gb_max_rank="{:.2f}".format(peaks("llama")[0]),
        peak_alloc_gb_sum_ranks="{:.2f}".format(peaks("llama")[1]),
        seconds_rank0=f"{r0['seconds']:.1f}", card=repr(card))

    # [tp16_train_step], [tp16_train]: against the mesh=None control
    tokens = B * S
    for rank, r in enumerate(runs):
        tr = r["train"]
        require(tr["model_shard"], "tp16_train: the step did not compute on its model shard")
        require(not any(tr["kernels"].values()),
                f"tp16_train rank {rank}: a kernel launched on the training path: {tr['kernels']}")
        require(len(tr["steps"]) == len(base) == TP16_TRAIN_STEPS,
                f"tp16_train rank {rank}: {len(tr['steps'])} steps")
        for i, (st, (b_loss, b_gn, b_s)) in enumerate(zip(tr["steps"], base)):
            tol = TP_TRAIN_RTOL0 if i == 0 else TP_TRAIN_RTOL
            lg, gg = abs(st["loss"] - b_loss) / abs(b_loss), abs(st["grad_norm"] - b_gn) / abs(b_gn)
            gathers = sorted(k for k in st["collectives"] if k.startswith("gather"))
            if rank == 0:
                say("tp16_train_step", rank=rank, step=i, loss=f"{st['loss']:.6f}",
                    grad_norm=f"{st['grad_norm']:.6f}", loss_rel_gap=f"{lg:.3e}",
                    grad_norm_rel_gap=f"{gg:.3e}", bar=tol, ms=f"{1e3 * st['s']:.1f}",
                    mesh_none_ms=f"{1e3 * b_s:.1f}", tokens_per_s=f"{tokens / st['s']:.0f}",
                    gathers=gathers, collectives=st["collectives"], card=repr(card))
            require(lg <= tol and gg <= tol, f"tp16_train rank {rank} step {i}: loss "
                    f"{st['loss']} / {b_loss}, grad norm {st['grad_norm']} / {b_gn}")
            # the K/V joins over model only: no parameter gathered whole
            require(gathers == ["gather_heads"],
                    f"tp16_train rank {rank} step {i}: gathers {gathers} in a step")
    for i in range(TP16_TRAIN_STEPS):
        same_on_every_rank(f"step {i}'s replicated leaves",
                           [r["train"]["steps"][i]["replicated"] for r in runs])
    say("tp16_train", mesh=f"1x1x{ranks}", layers=TP16_TRAIN_LAYERS, steps=TP16_TRAIN_STEPS,
        seq_len=S, global_batch=B, replicated_leaves_bit_identical=len(
            runs[0]["train"]["steps"][0]["replicated"]),
        param_gb_rank=f"{runs[0]['train']['param_bytes'] / 1e9:.4f}",
        peak_alloc_gb_max_rank=f"{max(r['train']['peak_gb'] for r in runs):.2f}",
        mesh_none_peak_gb=f"{base_peak:.2f}", control_s=f"{control_s:.1f}",
        seconds_rank0=f"{runs[0]['train']['seconds']:.1f}", card=repr(card))

    # [tp16_dryrun]: the (1, 1, ranks) cell's record against every rank's last step
    rec = record.get("cell")
    require(isinstance(rec, dict), f"tp16 dry run of the (1, 1, {ranks}) cell failed: {rec}")
    last = [r["train"]["steps"][-1] for r in runs]
    same = all(rec["memory_analysis"]["argument_size_in_bytes"] == st["arg_bytes"]
               and rec["collectives"] == st["collectives"] for st in last) and rec["model_shard"]
    say("tp16_dryrun", mesh=rec["mesh"], model_shard=rec["model_shard"],
        argument_bytes=rec["memory_analysis"]["argument_size_in_bytes"],
        rank0_argument_bytes=last[0]["arg_bytes"], collectives=rec["collectives"],
        rank0_collectives=last[0]["collectives"], equal_on_every_rank=same,
        flops=rec["flops_corrected"], lower_s=rec["lower_s"], card=repr(card))
    require(same, "tp16 dry run: arguments or collectives differ from a rank's")

    # [kernel_time]: flash_attention at the two models' per-rank shapes
    gen = torch.Generator(device=dev).manual_seed(32)
    l2 = torch.zeros(32 * 1024 * 1024, device=dev)
    times = {name: fa_time_at(name, c, dev, card, gen, l2) for name, c in TP16_ATTN_SHAPES}
    say("tp16", case="seconds", control=f"{control_s:.1f}",
        control_and_ranks=f"{ranks_s:.1f}", dry_run_lower_s=rec["lower_s"])
    shutil.rmtree(root, ignore_errors=True)
    return {"launches": launches, "attn": times}


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
    from repro_torch._tree import tree_map
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
              launches_per_prefill=None, n: int = N_REQUESTS, record: dict | None = None,
              **kw):
        """Drive ``DecodeServer`` over the first ``n`` of the 16 requests;
        ``counter`` is the
        wrapper whose launches this run must show exactly once per layer of
        every prefill call (of every one-shot prefill only, and none in a
        chunked run, when ``chunks_launch`` is False).  A wrapper that also
        counts ``calls`` makes ``launches_per_prefill(m)`` CUDA launches a
        layer for a one-shot prefill of m tokens, and its calls are held to
        the rule above."""
        obs = Observability(trace=True)
        srv = DecodeServer(mcfg, params, num_slots=NUM_SLOTS, max_seq=MAX_SEQ,
                           block_k=BLOCK_K, obs=obs, **kw)
        for i, p in enumerate(prompts[:n]):
            srv.submit(Request(uid=i, prompt=p, max_new_tokens=MAX_NEW))
        torch.cuda.synchronize()
        counter.launches = 0
        if launches_per_prefill is not None:
            counter.calls = 0
        t0 = time.perf_counter()
        with served_logits(srv, range(NUM_SLOTS), {} if record is None else record["prompts"]) \
                as logits:
            done = srv.run_until_drained(persistent=block)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        launches = counter.launches
        calls = counter.calls if launches_per_prefill is not None else launches
        decode_ms = sum(ev["dur"] for ev in obs.tracer.events()
                        if ev.get("name") in ("decode_step", "decode_block")) / 1e3
        st = srv.stats()
        require(len(done) == n, f"{mcfg.name} {label}: {len(done)} of {n} requests retired")
        for r in done:
            require(r.finish_reason == "max_tokens" and len(r.out_tokens) == MAX_NEW,
                    f"{mcfg.name} {label}: request {r.uid} ended {r.finish_reason} "
                    f"after {len(r.out_tokens)} tokens")
        n_prefills = (sum(math.ceil(m / kw["prefill_chunk"]) for m in lengths[:n])
                      if kw.get("prefill_chunk") else n)
        want = mcfg.n_layers * n_prefills if chunks_launch or not kw.get("prefill_chunk") else 0
        require(calls == want,
                f"{mcfg.name} {label}: {calls} kernel calls for {n_prefills} prefill "
                f"calls of {mcfg.n_layers} layers")
        if launches_per_prefill is not None:
            want_launches = (0 if kw.get("prefill_chunk") else
                             mcfg.n_layers * sum(launches_per_prefill(int(m))
                                                 for m in lengths[:n]))
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
            prefill_ms_per_prompt=f"{(wall_ms - decode_ms) / n:.2f}",
            decode_syncs=st["decode_syncs"], decoded_tokens=st["decoded_tokens"],
            syncs_per_token=f"{st['syncs_per_token']:.4f}", kernel_syncs=kernel_syncs,
            kernel_calls=calls, kernel_launches=launches, prefill_calls=n_prefills,
            card=repr(card))
        if record is not None:
            record.update(logits=logits, decode_tok_s=st["decoded_tokens"] / (decode_ms / 1e3),
                          prefill_ms=(wall_ms - decode_ms) / n)
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
    for bits in (8,):       # 12 bits lies between the int8 and fp32 cells
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

    def profiled_step_run(mcfg, mparams, counter, want_tokens, *, check: bool = False,
                          **serve_kw):
        """The ``step()`` serve run once more, on the first ``PROFILED``
        requests, under torch.profiler: device busy time and idle share over
        the run's wall, and the top kernels.  Only the device is traced: the
        host's operator events are not read, and sorting them took most of
        the phase on a full-width model; the profiler's processing grows
        with the run, so a short run keeps the phase short."""
        with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
            tok_prof, _, prof_wall_ms = serve(mcfg, mparams, "step(profiled)", False,
                                              counter, n=PROFILED, **serve_kw)
        require(tok_prof == {u: want_tokens[u] for u in range(PROFILED)},
                f"{mcfg.name}: the profiled step() run's tokens differ")
        kernels = device_kernels(prof, torch.autograd.DeviceType.CUDA, check=check)
        busy_ms = sum(us for _, _, us in kernels) / 1e3
        say("profile", arch=mcfg.name, driver="step", wall_ms=f"{prof_wall_ms:.1f}",
            device_busy_ms=f"{busy_ms:.1f}" if kernels else "not_measured",
            device_idle_share=f"{1 - busy_ms / prof_wall_ms:.3f}" if kernels else "not_measured",
            card=repr(card))
        for key, calls, us in kernels[:8]:
            say("profile_top", arch=mcfg.name, kernel=repr(key[:70]), calls=calls,
                device_ms=f"{us / 1e3:.2f}", share=f"{us / 1e3 / busy_ms:.3f}")

    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    profiled_step_run(cfg, params, lstm_ops.lstm_seq, tok_step, check=True)
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
        # the TMA path at both timed shapes, a block of 64 rows of a, a last m
        # tile of 44 rows with a K tail; the byte-wise path at ragged shapes
        for M, K, N in ((256, 4096, 8192), (1, 4096, 8192), (33, 4096, 8192),
                        (300, 4112, 1024), (33, 100, 77), (3, 5, 7)):
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
        # and at one decode-sized row through the same weight
        i8_time = {M: int8_time(i8_ops, i8_kernel, int8_inputs(M, 4096, 8192), l2, card)
                   for M in (256, 1)}
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
        # local-layer shape, (d) its global layer, (e) one internlm2-20b layer,
        # (f) one application of zamba2-1.2b's shared block (MHA, hd 64),
        # (g) one olmoe-1b-7b layer (MHA 16/16, hd 128, after qk-norm),
        # (h) one hubert-xlarge layer (non-causal MHA 16/16, hd 80), (i) one
        # llama-3.2-vision-90b self-attention layer (GQA 64/8, hd 128)
        attn_time = {}
        for name, c in (("a1_smollm_S64", dict(B=1, S=64, T=64, H=9, KV=3, hd=64, window=0)),
                        ("a_smollm_S256", dict(B=1, S=256, T=256, H=9, KV=3, hd=64, window=0)),
                        ("b_phi4_S2048", dict(B=1, S=2048, T=2048, H=24, KV=8, hd=128, window=0)),
                        ("c_gemma3_local_S2048_w1024",
                         dict(B=1, S=2048, T=2048, H=32, KV=16, hd=128, window=1024)),
                        ("d_gemma3_global_S2048",
                         dict(B=1, S=2048, T=2048, H=32, KV=16, hd=128, window=0)),
                        ("e_internlm2_S2048",
                         dict(B=1, S=2048, T=2048, H=48, KV=8, hd=128, window=0)),
                        ("f_zamba2_shared_S2048",
                         dict(B=1, S=2048, T=2048, H=32, KV=32, hd=64, window=0)),
                        ("g_olmoe_S2048",
                         dict(B=1, S=2048, T=2048, H=16, KV=16, hd=128, window=0)),
                        ("h_hubert_S2048_nc",
                         dict(B=1, S=2048, T=2048, H=16, KV=16, hd=80, window=0, causal=False)),
                        ("i_llama_S2048",
                         dict(B=1, S=2048, T=2048, H=64, KV=8, hd=128, window=0))):
            q, k, v = attn_inputs(c)
            w, causal = c["window"], c.get("causal", True)
            kw = dict(causal=causal, window=w)
            shape_err = check_close(f"flash_attention {name}",
                                    [fa_ops.flash_attention(q, k, v, **kw)],
                                    [fa_ops.flash_attention_ref(q, k, v, **kw)], ATTN_TOL)
            attn_err = max(attn_err, shape_err)
            k_ms = time_ms(lambda: fa_ops.flash_attention(q, k, v, **kw), l2)
            calls = launches_per_call(lambda: fa_ops.flash_attention(q, k, v, **kw))
            n_splits = fa_kernel.splits(q, k, **kw)
            counted = fa_ops.flash_attention.launches
            fa_ops.flash_attention(q, k, v, **kw)
            counted = fa_ops.flash_attention.launches - counted
            require(calls == fa_kernel.launches_per_call(n_splits) == counted,
                    f"flash_attention {name}: {calls} launches a call with {n_splits} key "
                    f"shares, {counted} counted by the wrapper")
            if name == "a_smollm_S256":
                fa_calls = calls
            p_ms = time_ms(lambda: fa_ops.flash_attention_ref(q, k, v, **kw), l2)
            # the library call, a yardstick only: SDPA on the same fp32 tensors
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            qpos = torch.arange(c["S"], device=dev)[:, None]
            kpos = torch.arange(c["T"], device=dev)[None, :]
            win_mask = (kpos <= qpos) & (kpos > qpos - w)
            sdpa = (lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, enable_gqa=True)) if w == 0 else \
                   (lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=win_mask, enable_gqa=True))
            lib_diff = float((sdpa().transpose(1, 2) - fa_ops.flash_attention(q, k, v, **kw))
                             .abs().max())
            l_ms = time_ms(sdpa, l2)
            bnd, by, fma_bnd = attn_bound_ms(c["B"], c["S"], c["T"], c["H"], c["KV"], c["hd"],
                                             causal, w)
            attn_time[name] = (k_ms, p_ms, l_ms, bnd, by, fma_bnd, n_splits, shape_err)
            say("kernel_time", kernel="flash_attention", shape=name,
                **{n: c[n] for n in ("B", "S", "T", "H", "KV", "hd")}, causal=causal, window=w,
                max_abs_err=f"{shape_err:.3e}", tol=ATTN_TOL,
                ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}", library_ms=f"{l_ms:.4f}",
                over_library=f"{k_ms / l_ms:.3f}",
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
    mcfg = dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=MAMBA_LAYERS,
                               use_pallas=True)
    torch.cuda.reset_peak_memory_stats()
    base_alloc = torch.cuda.memory_allocated()     # what earlier phases still hold
    t0 = time.perf_counter()
    mparams = lm.init_params(mcfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    m_params = lm.param_count(mparams)
    peak_init = torch.cuda.max_memory_allocated()
    require((get_config("falcon-mamba-7b").n_layers, mcfg.d_model, mcfg.d_inner)
            == (MAMBA_PUBLISHED_LAYERS, 4096, 8192),
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
        # the oracle of phase 26: the first requests' prefill and decode logits
        mamba_oracle = {"prompts": {i: prompts[i] for i in range(TP_MAMBA_REQUESTS)}}
        mtok_step, k1, _ = serve(mcfg, mparams, "step", False, scan_ops.ssm_scan,
                                 record=mamba_oracle)
        mamba_oracle["tokens"] = {i: list(mtok_step[i]) for i in range(TP_MAMBA_REQUESTS)}
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
        require(tuple(blk["h"].shape) == (mcfg.n_layers, 1, mcfg.d_inner, mcfg.ssm_state)
                and tuple(blk["conv"].shape) == (mcfg.n_layers, 1, mcfg.d_conv - 1, mcfg.d_inner),
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

    # -- 15b. serve_loadgen: falcon-mamba-7b at its widths cut to 16 layers, on
    # the first 16 of phase 12's loaded groups (no new weights drawn) ------------
    lg_cfg = dataclasses.replace(mcfg, n_layers=LOADGEN_MAMBA_LAYERS)
    lg_params = {**mparams, "groups": tree_map(lambda t: t[:LOADGEN_MAMBA_LAYERS],
                                               mparams["groups"])}
    lg_mamba_launches = serve_loadgen_mamba(
        lg_cfg, lg_params, dev, card,
        cache_bytes=(1 << 30) * LOADGEN_MAMBA_LAYERS // MAMBA_PUBLISHED_LAYERS)
    del mparams, lg_params
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

    # -- 18. serve gemma3-27b (8 layers) and internlm2-20b (4 layers) ------------
    gcfg = dataclasses.replace(get_config("gemma3-27b"), n_layers=GEMMA_LAYERS, use_pallas=True)
    require((gcfg.d_model, gcfg.n_heads, gcfg.n_kv_heads, gcfg.head_dim, gcfg.d_ff, gcfg.vocab,
             gcfg.sliding_window, gcfg.rope_theta, gcfg.rope_theta_global, gcfg.qk_norm,
             gcfg.mlp_act, gcfg.tie_embeddings, gcfg.n_groups, gcfg.tail_pattern)
            == (5376, 32, 16, 128, 21_504, 262_144, 1024, 10_000.0, 1_000_000.0, True, "gelu",
                True, 1, ("attn_local", "attn_local")),
            f"gemma3-27b is not at its published widths: {gcfg}")
    torch.cuda.reset_peak_memory_stats()
    base_alloc = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    gparams = lm.init_params(gcfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    g_params = lm.param_count(gparams)
    traffic = long_prompt_traffic(gcfg.vocab)
    say("serve_setup", arch=gcfg.name, n_layers=gcfg.n_layers, d_model=gcfg.d_model,
        heads=f"{gcfg.n_heads}/{gcfg.n_kv_heads}", head_dim=gcfg.head_dim, d_ff=gcfg.d_ff,
        vocab=gcfg.vocab, window=gcfg.sliding_window, params=g_params,
        param_gb=f"{4 * g_params / 1e9:.2f}", init_s=f"{init_s:.1f}",
        alloc_gb_before_init=f"{base_alloc / 1e9:.2f}",
        prompt_lens=",".join(f"{len(p)}+{n}" for p, n in traffic), num_slots=SERVE_SLOTS,
        max_seq=GEMMA_MAX_SEQ, block_k=BLOCK_K, chunk=GEMMA_CHUNK,
        prefix_cache_gib=GEMMA_PREFIX_BYTES / 2 ** 30)
    checked = [GEMMA_LENGTHS.index(1025), GEMMA_LENGTHS.index(2048), len(traffic) - 1]
    gemma_fa = serve_long_prompts(gcfg, gparams, dev, card, traffic, checked)
    say("serve_memory", arch=gcfg.name, peak_alloc_gb=f"{gemma_fa['peak_bytes'] / 1e9:.2f}",
        card=repr(card))
    del gparams
    torch.cuda.empty_cache()
    phase_done("serve_gemma3")

    icfg = dataclasses.replace(get_config("internlm2-20b"), n_layers=INTERNLM_LAYERS,
                               use_pallas=True)
    require((icfg.d_model, icfg.n_heads, icfg.n_kv_heads, icfg.head_dim, icfg.d_ff, icfg.vocab,
             icfg.mlp_act, icfg.tie_embeddings, icfg.rope_theta)
            == (6144, 48, 8, 128, 16_384, 92_544, "silu", False, 1_000_000.0),
            f"internlm2-20b is not at its published widths: {icfg}")
    torch.cuda.reset_peak_memory_stats()
    iparams = lm.init_params(icfg, torch.Generator(device=dev).manual_seed(0))
    i_params = lm.param_count(iparams)
    say("serve_setup", arch=icfg.name, n_layers=icfg.n_layers, d_model=icfg.d_model,
        heads=f"{icfg.n_heads}/{icfg.n_kv_heads}", head_dim=icfg.head_dim, d_ff=icfg.d_ff,
        vocab=icfg.vocab, params=i_params, param_gb=f"{4 * i_params / 1e9:.2f}",
        prompt_lens=",".join(map(str, INTERNLM_LENGTHS)), max_new_tokens=INTERNLM_NEW,
        num_slots=SERVE_SLOTS, max_seq=GEMMA_MAX_SEQ)
    internlm_fa = serve_internlm2(icfg, iparams, dev, card)
    say("serve_memory", arch=icfg.name,
        peak_alloc_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", card=repr(card))
    del iparams
    torch.cuda.empty_cache()
    phase_done("serve_internlm2")

    # -- 19. serve zamba2-1.2b at its published widths, depth cut ----------------
    zcfg = dataclasses.replace(get_config("zamba2-1.2b"), n_layers=ZAMBA_LAYERS,
                               use_pallas=True)
    require((zcfg.n_layers, zcfg.d_model, zcfg.d_inner, zcfg.n_mamba_heads, zcfg.mamba_headdim,
             zcfg.ssm_state, zcfg.d_conv, zcfg.n_groups, zcfg.layer_pattern, zcfg.tail_pattern,
             zcfg.n_heads, zcfg.n_kv_heads, zcfg.head_dim, zcfg.d_ff, zcfg.mlp_act,
             zcfg.gated_mlp, zcfg.shared_attn_lora_rank, zcfg.vocab, zcfg.tie_embeddings)
            == (ZAMBA_LAYERS, 2048, 4096, 64, 64, 64, 4, 2, ("mamba2",) * 5 + ("shared_attn",),
                ("mamba2", "mamba2"), 32, 32, 64, 8192, "gelu", True, 128, 32_000, False)
            and get_config("zamba2-1.2b").n_layers == 38,
            f"zamba2-1.2b is not at its published widths: {zcfg}")
    torch.cuda.reset_peak_memory_stats()
    base_alloc = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    zgen = torch.Generator(device=dev).manual_seed(0)
    zparams = lm.init_params(zcfg, zgen)
    perturb_hybrid(zparams, zgen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    z_params = lm.param_count(zparams)
    require(z_params == ZAMBA_PARAMS, f"zamba2-1.2b ({ZAMBA_LAYERS} blocks) has {z_params} "
                                      "parameters")
    traffic = long_prompt_traffic(zcfg.vocab, lengths=ZAMBA_LENGTHS, shared=ZAMBA_SHARED,
                                  cross=None, new=ZAMBA_NEW)
    say("serve_setup", arch=zcfg.name, n_layers=zcfg.n_layers, d_model=zcfg.d_model,
        d_inner=zcfg.d_inner, mamba_heads=f"{zcfg.n_mamba_heads}x{zcfg.mamba_headdim}",
        ssm_state=zcfg.ssm_state, shared_heads=f"{zcfg.n_heads}/{zcfg.n_kv_heads}",
        head_dim=zcfg.head_dim, d_ff=zcfg.d_ff, lora_rank=zcfg.shared_attn_lora_rank,
        vocab=zcfg.vocab, params=z_params, param_gb=f"{4 * z_params / 1e9:.2f}",
        init_s=f"{init_s:.1f}", alloc_gb_before_init=f"{base_alloc / 1e9:.2f}",
        prompt_lens=",".join(f"{len(p)}+{n}" for p, n in traffic), num_slots=SERVE_SLOTS,
        max_seq=ZAMBA_MAX_SEQ, block_k=BLOCK_K, chunk=ZAMBA_CHUNK)
    checked = [ZAMBA_LENGTHS.index(n) for n in (131, 1031, 2048)] + [len(traffic) - 1]
    zamba_fa = serve_zamba2(zcfg, zparams, dev, card, traffic, checked)
    say("serve_memory", arch=zcfg.name, peak_alloc_gb=f"{zamba_fa['peak_bytes'] / 1e9:.2f}",
        card=repr(card))
    del zparams
    torch.cuda.empty_cache()
    phase_done("serve_zamba2")

    # -- 20. serve olmoe-1b-7b (fp32, then int8 weights) and deepseek-v2-lite-16b
    # at their published widths, depth cut ------------------------------------------
    # the dry-run CLI's cells trace on the host only: started here, they run
    # beside phase 20 and are collected with the other entry points
    early = contextlib.ExitStack()
    atexit.register(early.close)        # a failed check still stops them
    dry_clis = early.enter_context(clis_started(dryrun_clis(), ROOT / "build" / "dryrun_clis"))
    moe_fa = serve_moe_phase(dev, card)

    # -- 15d. every entry point that runs as a subprocess, started together -----
    entry_points(card, started_dryruns=dry_clis)
    early.close()
    phase_done("entry_points")

    # -- 17. the Fig. 10 loop, the chaos suite and the lints ----------------------
    tc = tune_chaos(dev, card)
    codegen_launches["lstm"] += sum(n for label, n in tc["tune"].items() if "lstm" in label)
    phase_done("tune_chaos")

    # -- 21. training: smollm-135m at train_4k length, paper-lstm -----------------
    train = train_phase(dev, card)
    phase_done("train")

    # -- 22. the mesh: ShardPlan serving, synthesize(mesh=), EP MoE --------------
    mesh_launches = mesh_phase(dev, card, cfg, prompts, tok_step, tok_block)
    codegen_launches["lstm"] += mesh_launches["codegen_stage"]
    phase_done("mesh")

    # -- 23. mesh training: ZeRO shards, elastic restore, compression, pipeline --
    # (its ranks run phase 24's dp = 2 work too: one start of the rank processes;
    # phase 24's mesh=None runs and dry runs start first)
    mm_job = moe_mesh_started(dev)
    mt_base = mesh_train_phase(dev, card, moe_job=mm_job)
    phase_done("mesh_train")

    # -- 24. MoE training on a data mesh; the dry run against the card ------------
    mm_base = moe_mesh_train_phase(dev, card, train, mm_job)
    del mm_job
    phase_done("moe_mesh_train")

    # -- 25. cross-attention and the encoder frontend ------------------------------
    hubert_fa = encoder_phase(dev, card)
    phase_done("encoder")
    llama_fa = vlm_phase(dev, card)
    phase_done("vlm")

    # -- 26. tensor-parallel compute along model: serving, training, dry run ---------
    # (its ranks run phase 27's work too: one start of the rank processes)
    moe_oracles = {"olmoe-1b-7b": moe_fa["olmoe"]["oracle"],
                   "deepseek-v2-lite-16b": moe_fa["deepseek"]["oracle"]}
    cross_oracles = {"hubert-xlarge": hubert_fa.pop("oracle"),
                     "llama-3.2-vision-90b": llama_fa.pop("oracle")}
    moe_job = tp_moe_started(dev, moe_oracles)
    tp = tp_phase(dev, card, {"internlm2-20b": internlm_fa["oracle"],
                              "falcon-mamba-7b": mamba_oracle}, mt_base,
                  moe_serves=moe_job["serves"], cross=cross_oracles)
    attn_time[tp["attn"][0]] = tp["attn"][1]
    attn_err = max(attn_err, tp["attn"][1][7])
    scan_err = max(scan_err, tp["scan"]["max_abs_err_D4096"])
    phase_done("tp")

    # -- 26, cross and the encoder: the ranks' cases against phase 25's runs ----------
    tp_cross = tp_cross_phase(dev, card, cross_oracles, tp["cross_ranks"], tp["cross_record"])
    for name, t in tp_cross["attn"].items():
        attn_time[name] = t
        attn_err = max(attn_err, t[7])
    tp16_oracles = {"internlm2-20b": internlm_fa["oracle"],
                    "llama-3.2-vision-90b": cross_oracles["llama-3.2-vision-90b"]}
    del cross_oracles
    phase_done("tp_cross")

    # -- 27. MoE experts and MLA heads on the model shard -----------------------------
    tp_moe = tp_moe_phase(dev, card, moe_job, tp["moe_ranks"], moe_oracles, mm_base,
                          ("g_olmoe_S2048", attn_time["g_olmoe_S2048"]))
    attn_time[tp_moe["attn"][0]] = tp_moe["attn"][1]
    attn_err = max(attn_err, tp_moe["attn"][1][7])
    phase_done("tp_moe")

    # -- 28. attention whose heads do not cut whole, at tp = 16 ---------------------
    tp16 = tp16_phase(dev, card, tp16_oracles)
    for name, t in tp16["attn"].items():
        attn_time[name] = t
        attn_err = max(attn_err, t[7])
    del tp16_oracles
    phase_done("tp16")

    summary = {"kernels": [{
        "name": "lstm_seq",
        "route": "cuda",
        "source": "src/repro_torch/kernels/lstm_cell/csrc/lstm_seq.cu",
        "replaces": "src/repro/kernels/lstm_cell/kernel.py:87",
        "launches": (n1 + n2 + n3 + lg_lstm_launches + tc["paper-lstm"]
                     + mesh_launches["lstm_seq"]),
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
        # phase 12's three serve runs and its loadgen run, and phase 26's two
        # tp = 2 ranks (each on its 4096 channels)
        "launches": k1 + k2 + k3 + lg_mamba_launches + tp["launches"]["ssm_scan"],
        "launches_by_model": {"falcon-mamba-7b": (k1 + k2 + k3 + lg_mamba_launches
                                                  + tp["launches"]["ssm_scan"])},
        "launches_tp2": {"falcon-mamba-7b": tp["launches"]["ssm_scan"]},
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
        **{k: v for k, v in tp["scan"].items() if k != "max_abs_err_D4096"},
    }, {
        "name": "int8_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/int8_matmul/csrc/int8_matmul.cu",
        "replaces": "src/repro/kernels/int8_matmul/kernel.py:47",
        "launches": 0,     # no path of the port (or of the reference) calls it
        "note": "standalone op: no path of the port or the reference calls it",
        "max_abs_err": 0.0,
        "ms": i8_time[256]["ms"],
        "plain_ms": i8_time[256]["plain_ms"],
        "bound_ms": i8_time[256]["bound_ms"],
        "bound_by": i8_time[256]["bound_by"],
        "library_ms": i8_time[256]["library_ms"],
        "launches_per_call": i8_time[256]["launches_per_call"],
        "weights_resident": None,
        "us_per_step": None,
        "over_library": i8_time[256]["ms"] / i8_time[256]["library_ms"],
        "path": i8_time[256]["path"],
        "ms_clean_l2": i8_time[256]["ms_clean_l2"],
        "ms_M1": i8_time[1]["ms"],
        "ms_clean_l2_M1": i8_time[1]["ms_clean_l2"],
        "plain_ms_M1": i8_time[1]["plain_ms"],
        "bound_ms_M1": i8_time[1]["bound_ms"],
        "library_ms_M1": i8_time[1]["library_ms"],
        "path_M1": i8_time[1]["path"],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:83",
        # smollm-135m's three serve runs (30 per one-shot prefill, 0 for
        # chunks), its loadgen run (30 per miss), phi4-mini-3.8b's prefill
        # (32), gemma3-27b's serve runs and prefills (14 per one-shot prefill,
        # 12 of them windowed), internlm2-20b's (4), zamba2-1.2b's (6, its
        # shared block), olmoe-1b-7b's in fp32 and int8 (16; none from
        # deepseek's MLA), the chaos suite (30 per one-shot prefill),
        # hubert-xlarge's forwards (48, non-causal), llama-3.2-vision-90b's
        # prefills (8: its cross blocks are plain) and internlm2-20b's at
        # tp = 2 (4 a rank, on 24 of 48 heads), olmoe-1b-7b's at tp = 2 (16
        # a rank and serving loop, on 8 of 16 heads), hubert-xlarge's at tp = 2 (48
        # a rank, on 8 of 16 heads) and llama-3.2-vision-90b's (8 a rank, on
        # 32 of 64 query heads), internlm2-20b's and llama-3.2-vision-90b's at
        # tp = 16 (4 a prefill and 8 a rank, on 3 and 4 query heads and 1 KV
        # head); times at shape (a)
        "launches": (f1 + f2 + f3 + lg_smollm_launches + p_launch + gemma_fa["launches"]
                     + internlm_fa["launches"] + zamba_fa["launches"]
                     + moe_fa["olmoe"]["launches"] + moe_fa["olmoe_int8"]["launches"]
                     + tc["smollm-135m"] + hubert_fa["launches"] + llama_fa["launches"]
                     + tp["launches"]["flash_attention"] + tp_moe["launches"]["flash_attention"]
                     + sum(n for _, n in tp_cross["launches"].values())
                     + sum(n for _, n in tp16["launches"].values())),
        "calls": (c1 + c2 + c3 + lg_smollm_calls + p_call + gemma_fa["calls"]
                  + internlm_fa["calls"] + zamba_fa["calls"] + moe_fa["olmoe"]["calls"]
                  + moe_fa["olmoe_int8"]["calls"] + tc["smollm-135m_calls"]
                  + hubert_fa["calls"] + llama_fa["calls"]
                  + tp["launches"]["flash_attention_calls"]
                  + tp_moe["launches"]["flash_attention_calls"]
                  + sum(c for c, _ in tp_cross["launches"].values())
                  + sum(c for c, _ in tp16["launches"].values())),
        "window_calls": gemma_fa["window_calls"],
        "launches_tp2": {"internlm2-20b": tp["launches"]["flash_attention"],
                         "olmoe-1b-7b": tp_moe["launches"]["flash_attention"],
                         **{m: n for m, (_, n) in tp_cross["launches"].items()}},
        "launches_tp16": {m: n for m, (_, n) in tp16["launches"].items()},
        "launches_by_model": {"gemma3-27b": gemma_fa["launches"],
                              "internlm2-20b": (internlm_fa["launches"]
                                                + tp["launches"]["flash_attention"]
                                                + tp16["launches"]["internlm2-20b"][1]),
                              "zamba2-1.2b": zamba_fa["launches"],
                              "olmoe-1b-7b": (moe_fa["olmoe"]["launches"]
                                              + moe_fa["olmoe_int8"]["launches"]
                                              + tp_moe["launches"]["flash_attention"]),
                              "deepseek-v2-lite-16b": moe_fa["deepseek"]["launches"],
                              "hubert-xlarge": (hubert_fa["launches"]
                                                + tp_cross["launches"]["hubert-xlarge"][1]),
                              "llama-3.2-vision-90b": (
                                  llama_fa["launches"]
                                  + tp_cross["launches"]["llama-3.2-vision-90b"][1]
                                  + tp16["launches"]["llama-3.2-vision-90b"][1])},
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
        "plain_ms_by_shape": {n: t[1] for n, t in attn_time.items()},
        "library_ms_by_shape": {n: t[2] for n, t in attn_time.items()},
        "over_library_by_shape": {n: t[0] / t[2] for n, t in attn_time.items()},
        "key_splits_by_shape": {n: t[6] for n, t in attn_time.items()},
    }]}
    print(json.dumps(summary), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
