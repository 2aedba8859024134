"""Multi-pod dry run: trace every (arch × shape × mesh) cell on fake tensors;
the port's counterpart of ``repro/launch/dryrun.py``.

For each cell this produces, for rank 0 of the production mesh (16×16 single
pod, 2×16×16 multi-pod) over torch's ``"fake"`` process group
(``launch.mesh.make_fake_mesh``):

  * proof that the port's step runs at that mesh's shard shapes
    (``launch.steps.lower_cell`` through the real step functions);
  * the bytes of its arguments, its outputs and the peak beyond them;
  * its FLOPs and memory traffic, and its collectives by kind with count
    and bytes (``launch.trace_analysis``, ``parallel.comm``'s counters);
  * a JSON record under ``experiments/dryrun_torch/``.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all [--mesh both] [--skip-existing]

The fake tensors carry ``--device`` (default ``cuda``: the port's entry
points run on the card unless asked; ``--device cpu`` traces on a machine
without one).  Nothing is allocated on it and nothing runs there.

A record keeps the reference's key names where the meaning is the same.
It has no ``compile_s`` (nothing compiles), no ``while_trips`` (an eager
trace is unrolled), no ``hlo_bytes`` and no generated-code or alias sizes
(there is no HLO).  ``lower_s`` is the trace's seconds.  ``model_shard``
says whether the cell computed on its model shard
(``sharding.computes_on_model_shard``): the dense transformer, Mamba-1,
MoE (GQA or MLA), the VLM (its ``cross`` blocks too) and the encoder
compute on this rank's heads (or, where heads do not cut whole, as
llama-vision's and internlm2's 8 KV heads over 16, on the query heads
that cover its ``wo`` rows, K and V joined whole), FFN columns, inner
channels, experts and vocabulary rows, as a reference device does.  The
recurrent and hybrid families gather their parameters whole and every
rank along ``model`` computes the same rows (ROADMAP.md, Queue 1 item
12c(c)), so their rank's FLOPs are the model axis's size times a
reference device's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

# The families whose plain path steps through time in Python (the Mamba-1
# scan, the LSTM/GRU cell loop): an eager trace of a 4096- or 32768-token
# cell would dispatch tens of millions of ops.  Their train and prefill cells
# are traced at three short lengths and extrapolated to the cell's
# (``trace_analysis.extrapolate``), the counterpart of the reference's trip
# counts: each figure but the peak is a polynomial of degree <= 2 in the
# length (tests/test_torch_dryrun.py holds the extrapolation to a direct
# trace), and the peak is extended along a line, low where the per-token
# bytes lead only past 192 tokens.
STEPWISE = ("ssm", "recurrent")
TRACE_LENGTHS = (64, 128, 192)

CELL_TIMEOUT_S = 3600.0

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                       "dryrun_torch")


def run_cell(arch: str, shape_name: str, multi_pod: bool, microbatches: int = 1,
             overrides: dict | None = None, constrain_acts: bool = False,
             seq_axis: str | None = None, *, device: str = "cuda", mesh_shape=None,
             shape=None, cfg=None, one_device: bool = False) -> dict:
    """One cell's record.  ``mesh_shape`` (an ``AbstractMesh``), ``shape``
    (a ``ShapeSpec``) and ``cfg`` (a ``ModelConfig``, taken as it is)
    replace the production mesh, the named shape cell and ``arch``'s
    ``dryrun_config`` where given; ``one_device`` traces the step without a
    mesh (``make_train_step(mesh=None)``)."""
    from repro_torch import optim
    from repro_torch.configs import ALL_SHAPES, get_config
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import trace_analysis
    from repro_torch.launch.mesh import make_fake_mesh, make_production_mesh

    cfg = cfg or steps_lib.dryrun_config(get_config(arch), **(overrides or {}))
    shape = shape or {s.name: s for s in ALL_SHAPES}[shape_name]
    mesh_shape = mesh_shape or make_production_mesh(multi_pod=multi_pod)
    mesh = None if one_device else make_fake_mesh(mesh_shape)

    lower = lambda s: steps_lib.lower_cell(  # noqa: E731
        cfg, s, mesh, optim.AdamWConfig(), microbatches=microbatches,
        constrain_acts=constrain_acts, seq_axis=seq_axis, device=device)
    t0 = time.perf_counter()
    traced = None
    if cfg.family in STEPWISE and shape.kind != "decode" and shape.seq_len > TRACE_LENGTHS[-1]:
        traced = list(TRACE_LENGTHS)
        cells = [lower(dataclasses.replace(shape, seq_len=n)) for n in traced]
        cell = cells[-1]
        st = trace_analysis.extrapolate([c.stats for c in cells], traced, shape.seq_len)
    else:
        cell = lower(shape)
        st = cell.stats
    collectives = {k: dict(v) for k, v in st.collectives.items()}
    return {
        "arch": arch,
        "shape": shape.name,
        "mesh": "1" if one_device else "x".join(str(s) for s in mesh_shape.axis_sizes),
        "n_devices": 1 if one_device else mesh_shape.size,
        "lower_s": round(time.perf_counter() - t0, 2),
        "microbatches": microbatches,
        "device": str(device),
        "rows_per_rank": cell.rows,
        "model_shard": cell.model_shard,
        "cost_analysis": {"flops": st.flops, "bytes accessed": st.bytes_accessed},
        "memory_analysis": {"argument_size_in_bytes": st.argument_bytes,
                            "output_size_in_bytes": st.output_bytes,
                            "temp_size_in_bytes": st.temp_bytes,
                            "peak_size_in_bytes": st.peak_bytes},
        "collectives": collectives,
        # an eager trace is unrolled: the counts are already per step
        "flops_corrected": st.flops,
        "memory_traffic": st.memory_traffic,
        "collectives_corrected": {k: dict(v) for k, v in collectives.items()},
        **({"traced_seq_lens": traced} if traced else {}),
    }


def save_record(rec: dict, out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
    if rec.get("tag"):
        name += f"__{rec['tag']}"
    path = os.path.join(out_dir, name + ".json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def _cell_main(out, args, kwargs) -> None:
    try:
        out.put((True, run_cell(*args, **kwargs)))
    except BaseException:  # noqa: BLE001 - the parent re-raises it
        out.put((False, traceback.format_exc()))


def spawn_cell(*args, timeout_s: float = 600.0, **kwargs) -> dict:
    """:func:`run_cell` in a process of its own (``spawn``), which the fake
    process group needs: a caller that has a process group of its own, or
    a test, gets the record without starting one."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    proc = ctx.Process(target=_cell_main, args=(out, args, kwargs), daemon=True)
    proc.start()
    try:
        ok, val = out.get(timeout=timeout_s)
    except queue.Empty:
        raise TimeoutError(f"the dry-run cell gave no record within {timeout_s} s") from None
    finally:
        proc.join(timeout=30)
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=5)
    if not ok:
        raise RuntimeError(f"the dry-run cell failed:\n{val}")
    return val


def main(argv: list[str] | None = None) -> int:
    from repro_torch.configs import ALL_SHAPES, ARCH_IDS, applicable_shapes, get_config
    from repro_torch.device import resolve_device
    from repro_torch.obs import log

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=[s.name for s in ALL_SHAPES])
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"], default="pod")
    ap.add_argument("--all", action="store_true", help="every applicable cell")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--out", default=os.path.abspath(OUT_DIR))
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--constrain-acts", action="store_true",
                    help="pin activations to batch-over-DP (a check in the port)")
    ap.add_argument("--seq-axis", default=None,
                    help="additionally shard activation seq dim over this axis (SP)")
    ap.add_argument("--pure-dp", action="store_true",
                    help="no TP: weights replicated over model, batch over all axes")
    ap.add_argument("--no-remat", action="store_true",
                    help="disable activation checkpointing in the group stack")
    ap.add_argument("--ssm-chunk", type=int, default=0,
                    help="mamba chunk length (the j knob; 0 = default)")
    ap.add_argument("--moe-group", type=int, default=0,
                    help="MoE dispatch group size (0 = 2048 default)")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (default: the card)")
    args = ap.parse_args(argv)

    resolve_device(args.device)         # the card unless asked: raises without one
    cells: list[tuple[str, str]] = []
    if args.all:
        for arch in ARCH_IDS:
            for s in applicable_shapes(get_config(arch)):
                cells.append((arch, s.name))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        cells = [(args.arch, args.shape)]

    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[args.mesh]
    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            mesh_name = "2x16x16" if mp else "16x16"
            fname = os.path.join(args.out, f"{arch}__{shape}__{mesh_name}"
                                 + (f"__{args.tag}" if args.tag else "") + ".json")
            if args.skip_existing and os.path.exists(fname):
                log.info(f"[skip] {arch} {shape} {mesh_name}")
                continue
            try:
                overrides = {}
                if args.pure_dp:
                    overrides["pure_dp"] = True
                if args.no_remat:
                    overrides["remat"] = False
                if args.ssm_chunk:
                    overrides["ssm_chunk"] = args.ssm_chunk
                if args.moe_group:
                    overrides["moe_group_size"] = args.moe_group
                # each cell's fake group in a process of its own
                rec = spawn_cell(arch, shape, mp, microbatches=args.microbatches,
                                 overrides=overrides, constrain_acts=args.constrain_acts,
                                 seq_axis=args.seq_axis, device=args.device,
                                 timeout_s=CELL_TIMEOUT_S)
                rec["tag"] = args.tag
                p = save_record(rec, args.out)
                log.info(f"[ok]   {arch} {shape} {mesh_name} lower={rec['lower_s']}s "
                         f"flops={rec['flops_corrected']:.4g} "
                         f"peak={rec['memory_analysis']['peak_size_in_bytes'] / 1e9:.2f}GB "
                         f"-> {p}")
            except Exception:  # noqa: BLE001 — count the cell, keep sweeping
                failures += 1
                log.info(f"[FAIL] {arch} {shape} {mesh_name}")
                traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
