"""CLI: ``python -m repro_torch.analyze`` — static analysis without
synthesis; the port's counterpart of ``python -m repro.analyze`` (without
``--lint-src``: the source lints are not ported yet).

Examples::

    # one cell at one width, human table
    python -m repro_torch.analyze --cell lstm --bits 16 -v

    # every registered cell × {8,16,32} bits, one repro.analyze/v1 artifact
    python -m repro_torch.analyze --all-cells --bits 8,16,32 --out analyze.json

The program's weights are drawn on ``--device`` (default: the card); the
analysis itself runs on the host.  Exit status 1 iff any unwaived
error-grade finding was produced — waive with
``--waive kind:stage.node="reason"``.
"""

from __future__ import annotations

import argparse
import sys


def _specs(args):
    from repro_torch.codegen.builders import registered_cells
    from repro_torch.core.synthesis import NetworkSpec

    cells = registered_cells() if args.all_cells else [args.cell]
    for cell in cells:
        yield NetworkSpec(
            num_inputs=args.inputs,
            num_hidden_layers=args.layers,
            nodes_per_layer=args.nodes,
            num_outputs=args.outputs,
            cell=cell,
            seq_len=0 if cell == "mlp" else args.seq_len,
            seed=args.seed,
        )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="repro_torch.analyze",
        description="static range/overflow + hazard analysis of the "
        "codegen IR (no compilation, no data)")
    p.add_argument("--cell", default="lstm",
                   help="cell family to analyze (default lstm)")
    p.add_argument("--all-cells", action="store_true",
                   help="analyze every registered cell family")
    p.add_argument("--bits", default="16",
                   help="comma-separated word widths (default 16)")
    p.add_argument("--inputs", type=int, default=2)
    p.add_argument("--layers", type=int, default=1)
    p.add_argument("--nodes", type=int, default=4)
    p.add_argument("--outputs", type=int, default=2)
    p.add_argument("--seq-len", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--input-range", type=float, default=1.0,
                   help="assumed |u| bound in real units (default 1.0)")
    p.add_argument("--snr-target-db", type=float, default=20.0)
    p.add_argument("--max-iters", type=int, default=512)
    p.add_argument("--waive", action="append", default=[],
                   metavar="ID=REASON", help="waive a finding id")
    p.add_argument("--device", default=None,
                   help="where the program's weights are drawn (default: "
                   "the card; 'cpu' on a machine without one)")
    p.add_argument("--out", default=None,
                   help="write the repro.analyze/v1 JSON artifact here")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)

    from . import (
        WaiverRegistry,
        analyze_spec,
        format_findings,
        format_table,
        sweep_doc,
        write_doc,
    )

    waivers = WaiverRegistry.parse(args.waive)
    widths = [int(b) for b in args.bits.split(",") if b.strip()]

    runs = []
    failed = False
    for spec in _specs(args):
        for bits in widths:
            res = analyze_spec(spec, device=args.device, width=bits,
                               input_range=args.input_range,
                               max_iters=args.max_iters,
                               snr_target_db=args.snr_target_db,
                               waivers=waivers)
            doc = res.to_doc()
            runs.append(doc)
            failed = failed or not res.ok
            print(f"[analyze] {spec.name} W={bits}: "
                  f"{doc['summary']['errors']} error(s), "
                  f"{doc['summary']['warnings']} warning(s), "
                  f"snr={doc['static_snr_db']} dB, "
                  f"min_safe_width={doc['min_safe_width']}")
            if args.verbose:
                print(format_table(doc))
                print(format_findings(res.findings))

    if args.out:
        write_doc(sweep_doc(runs), args.out)
        print(f"[analyze] wrote {args.out} ({len(runs)} run(s))")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
