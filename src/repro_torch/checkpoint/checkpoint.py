"""Fault-tolerant checkpointing; the port's counterpart of
``repro/checkpoint/checkpoint.py``, with the same on-disk format, so either
package restores the other's checkpoints.

Properties (each covered by tests):
  * **atomic**: writes go to ``<dir>/tmp.<step>``, are fsynced, then renamed
    to ``<dir>/step_<N>`` and committed to ``MANIFEST.json`` — a crash
    mid-save can never corrupt the latest valid checkpoint;
  * **async**: ``save_async`` snapshots to host memory synchronously (a copy
    off the card) and writes on a background thread — training continues
    during I/O;
  * **device-agnostic**: leaves are stored as full arrays in one
    ``arrays.npz``, keyed by their path in the tree as the reference names
    it (dict keys and NamedTuple fields by name, sequence items by index,
    joined with ``/``: ``opt/m/embed/table``); ``restore`` puts each leaf on
    the template leaf's device and dtype;
  * **self-pruning**: keeps the newest ``keep`` checkpoints;
  * **mesh-agnostic**: a tree of shards (given its
    ``parallel.zero.ShardLayout``) is gathered and written whole, once, by
    the mesh's first rank; restoring with a layout of any mesh cuts each
    rank's shards from the full arrays, as restoring onto a template with
    ``NamedSharding`` re-shards in the reference.

numpy has no bfloat16, so a bf16 leaf is stored as its exact fp32 value;
``restore`` casts it back to the template's dtype.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

PyTree = Any

_MANIFEST = "MANIFEST.json"


def _children(tree: PyTree):
    """(name, subtree) pairs in the reference's flattening order: dict keys
    sorted, NamedTuple fields by name, sequence items by index."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _to_host(leaf) -> np.ndarray:
    """A copy of ``leaf`` in host memory that later updates of the leaf
    cannot reach."""
    if isinstance(leaf, torch.Tensor):
        dt = torch.float32 if leaf.dtype == torch.bfloat16 else leaf.dtype
        return leaf.detach().to(device="cpu", dtype=dt, copy=True).numpy()
    return np.array(leaf)


def flatten_with_names(tree: PyTree, prefix: str = "") -> dict[str, np.ndarray]:
    """Every leaf of ``tree`` as a host array, keyed by its path name."""
    kids = _children(tree)
    if kids is None:
        return {prefix: _to_host(tree)}
    out: dict[str, np.ndarray] = {}
    for name, sub in kids:
        out.update(flatten_with_names(sub, f"{prefix}/{name}" if prefix else name))
    return out


def _from_host(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:   # a bfloat16 array's bits
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, order="C"))


def _restore(template: PyTree, data, prefix: str) -> PyTree:
    kids = _children(template)
    if kids is None:
        if prefix not in data:
            raise KeyError(f"checkpoint missing leaf {prefix}")
        arr = data[prefix]
        if isinstance(template, torch.Tensor):
            return _from_host(arr).to(device=template.device, dtype=template.dtype)
        return arr
    restored = {name: _restore(sub, data, f"{prefix}/{name}" if prefix else name)
                for name, sub in kids}
    if isinstance(template, dict):
        return {k: restored[str(k)] for k in template}
    if hasattr(template, "_fields"):
        return type(template)(**restored)
    return type(template)(restored[str(i)] for i in range(len(template)))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
        self._lock = threading.Lock()
        self._pending: list[Future] = []

    # -- manifest ------------------------------------------------------------
    def _read_manifest(self) -> list[int]:
        p = os.path.join(self.dir, _MANIFEST)
        if not os.path.exists(p):
            return []
        with open(p) as f:
            return sorted(json.load(f)["steps"])

    def _write_manifest(self, steps: list[int]) -> None:
        p = os.path.join(self.dir, _MANIFEST)
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"steps": sorted(steps)}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)

    def latest_step(self) -> int | None:
        steps = self._read_manifest()
        return steps[-1] if steps else None

    # -- save ----------------------------------------------------------------
    def _snapshot(self, tree: PyTree, layout) -> dict[str, np.ndarray] | None:
        """The host arrays to write, or None on a rank that does not write
        (a layout's gather is a collective: every rank of its mesh calls)."""
        if layout is None:
            return flatten_with_names(tree)
        full = layout.gather(tree)
        return flatten_with_names(full) if layout.writer else None

    def save(self, step: int, tree: PyTree, metadata: dict | None = None, *,
             layout=None) -> None:
        arrays = self._snapshot(tree, layout)  # host snapshot (synchronous)
        if arrays is not None:
            self._write(step, arrays, metadata or {})

    def save_async(self, step: int, tree: PyTree, metadata: dict | None = None, *,
                   layout=None) -> Future | None:
        arrays = self._snapshot(tree, layout)  # snapshot NOW; write later
        if arrays is None:
            return None
        fut = self._pool.submit(self._write, step, arrays, metadata or {})
        self._pending.append(fut)
        return fut

    def _write(self, step: int, arrays: dict[str, np.ndarray], metadata: dict) -> None:
        with self._lock:
            tmp = os.path.join(self.dir, f"tmp.{step}")
            final = os.path.join(self.dir, f"step_{step}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
                np.savez(f, **arrays)
                f.flush()
                os.fsync(f.fileno())
            with open(os.path.join(tmp, "metadata.json"), "w") as f:
                json.dump({"step": step, **metadata}, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            steps = [s for s in self._read_manifest() if s != step] + [step]
            steps = sorted(steps)[-self.keep :]
            self._write_manifest(steps)
            # prune
            for entry in os.listdir(self.dir):
                if entry.startswith("step_") and int(entry[5:]) not in steps:
                    shutil.rmtree(os.path.join(self.dir, entry), ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def restore(self, template: PyTree, step: int | None = None, *,
                layout=None) -> tuple[PyTree, dict]:
        """Restore onto the template's structure, each leaf on the template
        leaf's device and dtype; a leaf the checkpoint lacks raises
        ``KeyError``.  With a ``layout`` the template holds this rank's
        shards, and each is cut from the full array."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "metadata.json")) as f:
            metadata = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as data:
            tree = _restore(template, data, "")
        return (tree if layout is None else layout.shard(tree)), metadata

    def wait(self) -> None:
        """Barrier for outstanding async saves (used at shutdown); re-raises
        the first failed write."""
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()
