"""Training launcher; the port's counterpart of ``repro/launch/train.py``,
with the reference's flags and log line.

    python -m repro_torch.launch.train --arch smollm-135m --steps 100 [--smoke]

``--smoke`` trains the reduced config; without it the published widths.
It runs on the card (``--device cuda``, the default) unless asked for the
CPU (``--device cpu``).  Supports resume, failure injection (for drills)
and metrics dumping.  Checkpoints go to ``--ckpt-dir`` (default
``$TMPDIR/repro_ckpt``); a run resumes from the newest one there unless
``--no-resume`` is given.

Under torchrun (its environment: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) every rank joins a gloo process group and
trains on ``make_local_mesh()``: every rank on ``"model"``, the reference's
default mesh (``--mesh DPxTP`` for another), the parameters and AdamW
moments stored as each rank's shards.  The dense transformer, Mamba-1,
MoE (GQA or MLA), the VLM (its ``cross`` blocks on a rank's heads; a
batch carries ``memory``) and the encoder (an ``embeds`` batch) compute on
their model shards there, attention on a rank's heads or, where the
heads do not cut whole, on the query heads that cover its rows of ``wo``
(``launch.steps.make_train_step``).
On the card each rank takes card ``LOCAL_RANK`` modulo the cards there
are; rank 0 logs and writes the metrics and the checkpoints.

    torchrun --nproc-per-node=2 -m repro_torch.launch.train --arch smollm-135m --smoke
    torchrun --nproc-per-node=2 -m repro_torch.launch.train --arch smollm-135m \
        --mesh 1x2 --mesh-layout sharded
"""

from __future__ import annotations

import argparse
import datetime
import os
import tempfile

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


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
    ap.add_argument("--mesh", default=None, metavar="DPxTP",
                    help="under torchrun: the (data, model) mesh, e.g. 1x2 "
                         "(default: every rank on model)")
    ap.add_argument("--mesh-layout", choices=["sharded"], default="sharded",
                    help="one torchrun rank per mesh position (the only layout "
                         "training has)")
    args = ap.parse_args(argv)
    mesh_shape = None
    if args.mesh:
        try:
            mesh_shape = tuple(int(x) for x in args.mesh.lower().split("x"))
            dp, tp = mesh_shape
        except ValueError:
            ap.error(f"--mesh must look like 1x2, got {args.mesh!r}")

    import torch
    import torch.distributed as dist

    from repro_torch import optim
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_local_mesh
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

    device, mesh, lead = resolve_device(args.device), None, True
    if all(k in os.environ for k in TORCHRUN_ENV):
        dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=600))
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                                  % torch.cuda.device_count())
            torch.cuda.set_device(device)
        if mesh_shape and dp * tp != dist.get_world_size():
            raise RuntimeError(f"--mesh {args.mesh} needs {dp * tp} ranks, torchrun "
                               f"started {dist.get_world_size()}")
        mesh, lead = make_local_mesh(*(mesh_shape or ())), dist.get_rank() == 0
    elif mesh_shape:
        raise RuntimeError(f"--mesh {args.mesh} needs ranks started by torchrun; run\n  "
                           f"torchrun --nproc-per-node={dp * tp} -m repro_torch.launch.train "
                           "...")
    try:
        trainer = Trainer(cfg, tcfg, ocfg, dcfg, mesh, device=device)
        res = trainer.run(resume=not args.no_resume)
        if lead:
            log.info(f"final_loss={res['final_loss']:.4f} "
                     f"entropy_floor={res['entropy_floor']:.4f}")
            if args.metrics_out:
                trainer.dump_metrics(args.metrics_out)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
