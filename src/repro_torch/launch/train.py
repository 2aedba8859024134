"""Training launcher; the port's counterpart of ``repro/launch/train.py``,
with the reference's flags and log line.

    python -m repro_torch.launch.train --arch smollm-135m --steps 100 [--smoke]

``--smoke`` trains the reduced config; without it the published widths.
It runs on the card (``--device cuda``, the default) unless asked for the
CPU (``--device cpu``).  Supports resume, failure injection (for drills)
and metrics dumping.  Checkpoints go to ``--ckpt-dir`` (default
``$TMPDIR/repro_ckpt``); a run resumes from the newest one there unless
``--no-resume`` is given.
"""

from __future__ import annotations

import argparse
import os
import tempfile


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="failure-injection drill: raise at this step")
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the trainer runs (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch import optim
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.obs import log
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainerConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, microbatches=args.microbatches,
        fail_at_step=args.fail_at,
    )
    ocfg = optim.AdamWConfig(lr_peak=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
                             total_steps=args.steps)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)

    trainer = Trainer(cfg, tcfg, ocfg, dcfg, device=args.device)
    res = trainer.run(resume=not args.no_resume)
    log.info(f"final_loss={res['final_loss']:.4f} "
             f"entropy_floor={res['entropy_floor']:.4f}")
    if args.metrics_out:
        trainer.dump_metrics(args.metrics_out)


if __name__ == "__main__":
    main()
