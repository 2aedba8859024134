"""Serving launcher: the continuous-batching decode server on a smoke
config with random weights from seed 0, fed a synthetic request stream or a
seeded load-generator trace; the port's counterpart of
``repro/launch/serve.py``, with the reference's flags and log lines.

    python -m repro_torch.launch.serve --arch paper-lstm --requests 16
    python -m repro_torch.launch.serve --arch paper-lstm --loadgen \\
        --prefill-chunk 4 --prefix-cache 64 --loadgen-out loadgen.json \\
        --trace-out trace.json --metrics-out metrics.json

It runs on the card (``--device cuda``, the default) unless asked for the
CPU (``--device cpu``).  ``--trace-out`` enables span tracing and writes a
Chrome-trace-event JSON loadable in Perfetto; ``--metrics-out`` writes the
metrics-registry snapshot and the predicted-vs-measured ledger;
``--loadgen`` replays the seeded trace of ``repro_torch.runtime.loadgen``
and ``--loadgen-out`` writes its ``repro.loadgen/v1`` report.  All three
documents pass ``python -m repro_torch.obs.check``.  ``--mesh`` and
``--mesh-layout`` (sharded serving) are not ported yet.
"""

from __future__ import annotations

import argparse

MESH_NOT_PORTED = ("--mesh/--mesh-layout: sharded serving is not ported to repro_torch yet "
                   "(ROADMAP.md, Queue 1: Multi-device and launchers)")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--persistent", action="store_true",
                    help="device-side K-step decode blocks (1 sync / K tokens)")
    ap.add_argument("--block-k", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: N prompt tokens per tick (0 = off)")
    ap.add_argument("--prefill-adaptive", action="store_true",
                    help="drain whole prefill jobs on ticks with no live "
                         "decode slot (chunk bound applies only under "
                         "contention)")
    ap.add_argument("--prefix-cache", type=int, default=0, metavar="MB",
                    help="radix prefix-cache byte budget in MB (0 = off)")
    ap.add_argument("--scheduler", choices=["priority", "fifo"], default="priority")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request TTL (expired:queue / expired:decode)")
    ap.add_argument("--watchdog-s", type=float, default=None,
                    help="stall watchdog bound in seconds: no serving "
                         "progress past the bound aborts in-flight work "
                         "with finish_reason='error:stalled'")
    ap.add_argument("--shed", action="store_true",
                    help="reject the lowest-priority class when queue "
                         "waits become unserviceable")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable tracing; write Perfetto-loadable trace JSON")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write metrics snapshot + ledger JSON")
    ap.add_argument("--mesh", default=None, metavar="DPxTP",
                    help="not ported yet: raises NotImplementedError")
    ap.add_argument("--mesh-layout", choices=["sharded", "folded"], default=None,
                    help="not ported yet: raises NotImplementedError")
    ap.add_argument("--loadgen", action="store_true",
                    help="replay a seeded load-generator trace (Poisson "
                         "arrivals, mixed prompt lengths, shared-prefix "
                         "fleets) instead of the fixed synthetic stream")
    ap.add_argument("--loadgen-seed", type=int, default=0)
    ap.add_argument("--loadgen-out", default=None, metavar="PATH",
                    help="write the repro.loadgen/v1 replay report JSON")
    ap.add_argument("--device", default="cuda",
                    help="where the server runs (default: the card)")
    args = ap.parse_args(argv)
    if args.mesh or args.mesh_layout:
        raise NotImplementedError(MESH_NOT_PORTED)

    import json
    import time

    import numpy as np
    import torch

    from repro_torch import obs as obs_lib
    from repro_torch.configs import get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models import lm
    from repro_torch.obs import log
    from repro_torch.runtime import DecodeServer, Request, SchedulerConfig, loadgen

    dev = resolve_device(args.device)
    obs = obs_lib.Observability(trace=bool(args.trace_out))
    cfg = get_smoke_config(args.arch)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    server = DecodeServer(cfg, params, num_slots=args.slots, max_seq=args.max_seq,
                          block_k=args.block_k, persistent=args.persistent,
                          prefill_chunk=args.prefill_chunk,
                          prefill_adaptive=args.prefill_adaptive,
                          prefix_cache_bytes=args.prefix_cache << 20,
                          scheduler=SchedulerConfig(policy=args.scheduler, shed=args.shed),
                          obs=obs, watchdog_s=args.watchdog_s, device=dev)
    t0 = time.perf_counter()
    report = None
    if args.loadgen:
        spec = loadgen.TraceSpec(num_requests=args.requests, max_new_tokens=args.max_new,
                                 vocab=cfg.vocab, seed=args.loadgen_seed)
        report = loadgen.replay(server, loadgen.make_trace(spec))
        done = server.completed
        wall, toks = report["wall_s"], report["decoded_tokens"]
    else:
        rng = np.random.default_rng(0)
        for i in range(args.requests):
            server.submit(Request(
                uid=i, prompt=list(rng.integers(1, cfg.vocab, size=int(rng.integers(2, 10)))),
                max_new_tokens=args.max_new, deadline_s=args.deadline_s))
        done = server.run_until_drained()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        toks = sum(len(r.out_tokens) for r in done)
    stats = server.stats()
    health = stats["health"]
    log.info(f"served {len(done)} requests, {toks} tokens, {wall:.2f}s "
             f"({toks / wall:.1f} tok/s, "
             f"{stats['syncs_per_token']:.3f} syncs/token)")
    log.info(f"health: {health['status']} "
             f"(quarantined={health['quarantined_slots']}, "
             f"stalled_events={health['stalled_events']}, "
             f"queued={health['queued']})")
    if report is not None:
        log.info(f"loadgen: {report['completed']}/{report['requests']} done "
                 f"in {report['ticks']} ticks, "
                 f"{report['throughput_tok_s']:.1f} tok/s, "
                 f"digest={report['tokens_digest']}")
        if args.loadgen_out:
            with open(args.loadgen_out, "w") as fh:
                json.dump(report, fh, indent=1)
            log.info(f"wrote loadgen report -> {args.loadgen_out}")
    if args.trace_out:
        obs.export_trace(args.trace_out)
        log.info(f"wrote trace ({len(obs.tracer.events())} events) -> {args.trace_out}")
    if args.metrics_out:
        # the serve scope's registry snapshot, plus a ledger: the serve
        # scope's own when it recorded anything, else the process-global one
        obs.export_metrics(args.metrics_out, stats=stats,
                           ledger=obs.ledger if len(obs.ledger) else obs_lib.OBS.ledger)
        log.info(f"wrote metrics snapshot -> {args.metrics_out}")


if __name__ == "__main__":
    main()
