"""Predicted-vs-measured report CLI, one turn of the Fig. 10 loop; the port's
counterpart of ``repro/obs/report.py``.

Synthesizes a small spec sweep through the requested backends on the card
(``--device``, default ``cuda``), which fills the process ledger (the FSM
cycle estimate and MACC flops predicted, wall clock measured), then prints
the joined table and optionally writes it:

    python -m repro_torch.obs.report [--backends eager kernel] [--out ledger.json]
    python -m repro_torch.obs.report --format json --program "gru_" --device cpu

The backends are the port's names for the reference's: ``eager`` (``xla``)
and ``kernel`` (``pallas``, the generated CUDA stage kernel).  ``--out``
writes a metrics document (``repro.metrics/v1``: the process registry's
snapshot and the joined ledger rows), which ``python -m
repro_torch.obs.check`` accepts; the reference writes the bare row list.
"""

from __future__ import annotations

import argparse
import dataclasses
import json


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs.report")
    ap.add_argument("--backends", nargs="*", default=["eager", "kernel"])
    ap.add_argument("--cells", nargs="*", default=["mlp", "gru"])
    ap.add_argument("--seq-len", type=int, default=8)
    ap.add_argument("--quant-bits", type=int, default=0,
                    help="also sweep this fixed-point width (0 = fp only)")
    ap.add_argument("--format", default="table", choices=["table", "json"],
                    help="stdout format (json prints the joined rows)")
    ap.add_argument("--program", default=None, metavar="SUBSTR",
                    help="only report ledger keys containing this substring "
                         "(e.g. a spec name or '|kernel|')")
    ap.add_argument("--out", default="",
                    help="write the registry snapshot and joined ledger rows "
                         "to this JSON file")
    ap.add_argument("--device", default="cuda",
                    help="where to build and time the programs (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch import obs
    from repro_torch.core.synthesis import NetworkSpec, synthesize
    from repro_torch.obs import log

    for cell in args.cells:
        specs = [NetworkSpec(4, 2, 8, 2, cell=cell,
                             seq_len=0 if cell == "mlp" else args.seq_len)]
        if args.quant_bits:
            specs.append(dataclasses.replace(specs[0], quant_bits=args.quant_bits))
        for spec in specs:
            for backend in args.backends:
                try:
                    synthesize(spec, batch=2, backend=backend, device=args.device)
                except ValueError as e:  # e.g. unsupported quant × backend
                    log.debug(f"skip {spec.name}|{backend}: {e}")
    rows = obs.OBS.ledger.report(match=args.program)
    if args.format == "json":
        print(json.dumps(rows, indent=1))
    else:
        log.info(obs.OBS.ledger.format_table(match=args.program))
    if args.out:
        doc = {"schema": obs.METRICS_SCHEMA, "metrics": obs.OBS.metrics.snapshot(),
               "ledger": rows}
        with open(args.out, "w") as fh:
            json.dump(doc, fh, indent=1, default=str)
        log.info(f"wrote {args.out}")
    return 0 if rows else 1


if __name__ == "__main__":
    raise SystemExit(main())
