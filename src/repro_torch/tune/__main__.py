"""Auto-tuner CLI — one Fig. 10 loop from the command line; the port's
counterpart of ``python -m repro.tune``.

    python -m repro_torch.tune --cell lstm --optimize latency --budget 8 \\
        --out build/tune_lstm.json
    python -m repro_torch.tune --cell lstm --smoke --device cpu

Candidates are built, timed and difftest-gated on ``--device`` (default:
the card; ``cpu`` runs the plain versions of the kernels).  ``--smoke``
shrinks the search grid and budget so the whole enumerate → predict →
measure → validate → report pipeline runs in seconds.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cell", default="lstm",
                    choices=["mlp", "lstm", "gru", "ssm"])
    ap.add_argument("--inputs", type=int, default=3)
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--outputs", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=8,
                    help="sequence steps (recurrent cells)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--optimize", default="latency",
                    choices=["latency", "throughput", "resources"])
    ap.add_argument("--budget", type=int, default=None,
                    help="max candidates built+timed (default 8)")
    ap.add_argument("--backends", nargs="*", default=["eager", "kernel"])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny grid + budget 3 (seconds)")
    ap.add_argument("--analyze-prune", action="store_true",
                    help="drop candidates whose static range analysis proves "
                    "an overflow before spending measure budget")
    ap.add_argument("--device", default=None,
                    help="where candidates are built and timed (default: the "
                    "card; 'cpu' on a machine without one)")
    ap.add_argument("--out", default="",
                    help="write the repro.tune/v1 Pareto report JSON here")
    args = ap.parse_args(argv)

    from repro_torch.core.synthesis import NetworkSpec
    from repro_torch.obs import log

    from . import tune, write_doc

    spec = NetworkSpec(args.inputs, args.layers, args.nodes, args.outputs,
                       cell=args.cell,
                       seq_len=0 if args.cell == "mlp" else args.seq_len)
    space_kwargs = None
    budget = args.budget
    if args.smoke:
        space_kwargs = {"unroll": (1, 2), "c_slow": (1, 2),
                        "quant_bits": (None, 8)}
        budget = budget or 3
    result = tune(spec, optimize=args.optimize, budget=budget,
                  batch=args.batch, backends=tuple(args.backends),
                  space_kwargs=space_kwargs,
                  analyze_prune=args.analyze_prune, device=args.device)
    log.info(result.table())
    if args.out:
        write_doc(result, args.out)
        log.info(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
