"""Radix-tree prefix cache over state-space checkpoints; the port's
counterpart of ``repro/runtime/prefix_cache.py``.

An iterative state-space form is resumable at any step boundary, so two
requests with a common token prefix traverse the same state trajectory and
the state at a shared boundary is reusable verbatim.  This module stores
those boundary states (the decode-layout cache tree of one B=1 prefill job:
KV rows, Mamba-1 ``h``/``conv``, recurrent ``(h, c)``) in a radix tree keyed
on token prefixes.  A recurrent state cannot be sliced out of a longer
trajectory after the fact, so entries are inserted at chunk boundaries and
at prompt ends:

* a **full hit** (stored prefix == whole prompt) serves admission with zero
  recomputed prompt steps: the stored last-token logits give the first
  token;
* a **partial hit** resumes chunked prefill from the deepest stored
  *resumable* boundary (aligned to the chunk grid, so the resumed scan runs
  the same chunk shapes as a cold run).

Eviction is LRU under a byte budget.  Checkpoints stay on the device the
server runs on.  Torch tensors are mutable where JAX arrays are not, and the
server writes cache trees in place (``splice_cache``; a KV slice is a view),
so :meth:`PrefixCache.insert` stores clones that no later in-place write can
reach.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.obs import MetricsRegistry

PyTree = Any


def tree_bytes(tree: PyTree) -> int:
    """Total bytes of all tensor leaves."""
    return sum(int(t.numel()) * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _detach_copy(tree: PyTree) -> PyTree:
    return tree_map(lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t, tree)


@dataclasses.dataclass
class CacheEntry:
    """One checkpointed prefix state."""

    length: int                      # prefix length in tokens (= cache pos)
    caches: PyTree                   # B=1 decode-layout state tree
    logits: Any                      # last-token logits [V] (on the device)
    resumable: bool                  # safe restart point for chunked prefill
    nbytes: int = 0
    last_used: int = 0

    def __post_init__(self):
        if not self.nbytes:
            self.nbytes = tree_bytes(self.caches)
            if self.logits is not None:
                self.nbytes += int(self.logits.numel()) * self.logits.element_size()


class _Node:
    __slots__ = ("edge", "children", "entry", "parent")

    def __init__(self, edge: tuple[int, ...] = (),
                 parent: "_Node | None" = None):
        self.edge = edge                       # tokens on the edge from parent
        self.children: dict[int, _Node] = {}   # first-token -> child
        self.entry: CacheEntry | None = None
        self.parent = parent                   # None only for the root


def _common_len(a: tuple[int, ...], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


class PrefixCache:
    """Radix tree of prompt prefixes with LRU byte-budget eviction."""

    def __init__(self, budget_bytes: int = 256 << 20,
                 metrics: MetricsRegistry | None = None):
        self.budget_bytes = int(budget_bytes)
        self.root = _Node()
        self.bytes_in_use = 0
        self._clock = 0
        self._entry_nodes: set[_Node] = set()   # incremental registry — no
        # tree walks on the admission hot path (insert/evict/telemetry)
        # Hit/miss/eviction accounting lives in a MetricsRegistry (pass the
        # owning server's to share a scope); telemetry() is a view over it.
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        self._c_hits = m.counter(
            "prefix_hits", "full-prompt hits (0 prompt steps recomputed)")
        self._c_partial = m.counter("prefix_partial_hits",
                                    "resumed mid-prompt")
        self._c_misses = m.counter("prefix_misses", "no usable checkpoint")
        self._c_insertions = m.counter("prefix_insertions",
                                       "checkpoints stored")
        self._c_evictions = m.counter("prefix_evictions",
                                      "checkpoints dropped (LRU budget)")
        self._c_saved = m.counter("prefix_prompt_steps_saved",
                                  "prompt steps served from checkpoints")
        self._g_bytes = m.gauge("prefix_bytes_in_use", "stored state bytes")
        self._g_entries = m.gauge("prefix_entries", "stored checkpoints")

    # -- internal ----------------------------------------------------------

    def _track(self) -> None:
        self._g_bytes.set(self.bytes_in_use)
        self._g_entries.set(len(self._entry_nodes))

    def _evict_to_budget(self) -> None:
        while self.bytes_in_use > self.budget_bytes and self._entry_nodes:
            node = min(self._entry_nodes, key=lambda n: n.entry.last_used)
            self.bytes_in_use -= node.entry.nbytes
            node.entry = None
            self._entry_nodes.discard(node)
            self._c_evictions.inc()
            self._prune(node)
        self._track()

    def _prune(self, node: _Node) -> None:
        """Unlink entry-less dead wood after an eviction, so the tree's
        node/edge structure (which budget_bytes does not account) cannot
        grow without bound: drop childless entry-less nodes bottom-up, then
        merge a remaining single-child entry-less pass-through node into its
        child (undoing stale edge splits)."""
        while (node.parent is not None and node.entry is None
               and not node.children):
            parent = node.parent
            del parent.children[node.edge[0]]
            node.parent = None
            node = parent
        if (node.parent is not None and node.entry is None
                and len(node.children) == 1):
            (child,) = node.children.values()
            child.edge = node.edge + child.edge
            child.parent = node.parent
            node.parent.children[child.edge[0]] = child
            node.parent = None

    # -- public ------------------------------------------------------------

    def insert(self, tokens: Sequence[int], caches: PyTree,
               logits: Any = None, *, resumable: bool = True) -> None:
        """Store a copy of the state checkpoint for prefix ``tokens``
        (replaces any existing entry for the same prefix).  ``caches`` and
        ``logits`` are cloned: the caller may go on writing its tensors in
        place."""
        tokens = list(int(t) for t in tokens)
        if not tokens:
            return
        node, i = self.root, 0
        while i < len(tokens):
            child = node.children.get(tokens[i])
            if child is None:
                child = _Node(tuple(tokens[i:]), parent=node)
                node.children[tokens[i]] = child
                node = child
                i = len(tokens)
                break
            m = _common_len(child.edge, tokens[i:])
            if m < len(child.edge):
                # split the edge at the divergence/end-of-prefix point
                mid = _Node(child.edge[:m], parent=node)
                child.edge = child.edge[m:]
                child.parent = mid
                mid.children[child.edge[0]] = child
                node.children[tokens[i]] = mid
                child = mid
            node, i = child, i + m
        self._clock += 1
        entry = CacheEntry(length=len(tokens), caches=_detach_copy(caches),
                           logits=None if logits is None else logits.detach().clone(),
                           resumable=resumable, last_used=self._clock)
        if node.entry is not None:
            self.bytes_in_use -= node.entry.nbytes
        node.entry = entry
        self._entry_nodes.add(node)
        self.bytes_in_use += entry.nbytes
        self._c_insertions.inc()
        self._evict_to_budget()

    def lookup(self, tokens: Sequence[int]) -> list[CacheEntry]:
        """All stored checkpoints lying on the prompt's path, deepest first.

        Each returned entry satisfies ``tokens[:entry.length] == stored
        prefix``; entry.length == len(tokens) is a full hit.  Touches the
        returned entries' LRU clocks.  Callers record hit/miss telemetry via
        :meth:`record_hit` / :meth:`record_miss` once they decide what to use.
        """
        tokens = list(int(t) for t in tokens)
        found: list[CacheEntry] = []
        node, i = self.root, 0
        while i < len(tokens):
            child = node.children.get(tokens[i])
            if child is None:
                break
            m = _common_len(child.edge, tokens[i:])
            i += m
            if m < len(child.edge):
                break
            if child.entry is not None:
                self._clock += 1
                child.entry.last_used = self._clock
                found.append(child.entry)
            node = child
        return sorted(found, key=lambda e: -e.length)

    def peek_depth(self, tokens: Sequence[int]) -> int:
        """Deepest stored prefix length along the prompt's path WITHOUT
        touching LRU clocks."""
        tokens = list(int(t) for t in tokens)
        best = 0
        node, i = self.root, 0
        while i < len(tokens):
            child = node.children.get(tokens[i])
            if child is None:
                break
            m = _common_len(child.edge, tokens[i:])
            i += m
            if m < len(child.edge):
                break
            if child.entry is not None:
                best = child.entry.length
            node = child
        return best

    def record_hit(self, steps_saved: int, *, full: bool) -> None:
        """One admission decision: a full hit (whole prompt spliced) or a
        partial hit (resumed mid-prompt).  Callers record exactly ONE of
        hit/partial/miss per admission — a partial-then-full sequence across
        two admissions of the same prompt is two decisions, saving
        ``start + plen`` steps in total, not a double count (see
        the reference's ``test_partial_then_full_hit_accounting``)."""
        (self._c_hits if full else self._c_partial).inc()
        self._c_saved.inc(int(steps_saved))

    def record_miss(self) -> None:
        self._c_misses.inc()

    @property
    def stats(self) -> dict:
        """Back-compat view of the registry (the pre-obs dict shape)."""
        return {
            "hits": self._c_hits.value,
            "partial_hits": self._c_partial.value,
            "misses": self._c_misses.value,
            "insertions": self._c_insertions.value,
            "evictions": self._c_evictions.value,
            "prompt_steps_saved": self._c_saved.value,
        }

    def telemetry(self) -> dict:
        self._track()
        out = dict(self.stats, bytes_in_use=self.bytes_in_use,
                   budget_bytes=self.budget_bytes,
                   entries=len(self._entry_nodes))
        return out

    def reset_stats(self) -> None:
        """Zero the counters; stored checkpoints are untouched."""
        self.metrics.reset()
        self._track()


__all__ = ["CacheEntry", "PrefixCache", "tree_bytes"]
