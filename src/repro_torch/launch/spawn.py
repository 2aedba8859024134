"""Run one function on N local ranks of a ``torch.distributed`` group.

    results = run_ranks(fn, world=8, args=(...,))

starts ``world`` processes (``spawn``: nothing of the parent's state is
inherited), initialises each one's process group with an address, a world
size and a rank of its own (a ``file://`` rendezvous in a fresh directory,
so no port is shared with anything else on the machine), calls
``fn(rank, world, *args)`` on one torch thread and returns the ranks'
results in rank order.  ``fn`` must be a module-level function whose
module imports cleanly in a fresh process, and its result a picklable
host value (numbers, lists, numpy arrays).

Nothing can hang: every collective has the group's ``timeout_s``, the
parent waits at most ``timeout_s`` for the results, and a rank that is
still alive after that is killed.  A rank that raised makes the call raise
with that rank's traceback.  This is how the port's multi-rank tests run on
the CPU (gloo) and how ``chip_smoke.py`` puts several ranks on one card; a
deployment starts its ranks with ``torchrun`` instead.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import traceback
from typing import Any, Callable, Sequence


def _rank_main(fn, rank: int, world: int, args, init: str, backend: str,
               timeout_s: float, out) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - the parent re-raises it
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, args: Sequence[Any] = (), *,
              backend: str = "gloo", timeout_s: float = 120.0) -> list:
    """``[fn(rank, world, *args) for each rank]``, each in its own process."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, tuple(args), init, backend, timeout_s, out),
                         daemon=True)
             for r in range(world)]
    results: dict[int, Any] = {}
    failures: dict[int, str] = {}
    try:
        for p in procs:
            p.start()
        deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout_s)
        while len(results) + len(failures) < world:
            left = (deadline - datetime.datetime.now()).total_seconds()
            if left <= 0:
                break
            try:
                rank, ok, val = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs) and not failures:
                    # a rank died without reporting: its peers would wait out
                    # the collective timeout, so stop now
                    dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                    failures.update({r: f"rank {r} exited with {procs[r].exitcode}"
                                     for r in dead})
                    break
                continue
            (results if ok else failures)[rank] = val
            if failures:        # its peers would wait out the timeout: stop
                break
        for p in procs:
            p.join(timeout=5 if failures or len(results) < world else 30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        first = min(failures)
        raise RuntimeError(f"rank {first} of {world} failed:\n{failures[first]}")
    if len(results) < world:
        missing = sorted(set(range(world)) - set(results))
        raise TimeoutError(f"ranks {missing} of {world} gave no result within {timeout_s} s")
    return [results[r] for r in range(world)]


__all__ = ["run_ranks"]
