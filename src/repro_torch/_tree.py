"""Nested-container helpers: the port's parameters, caches and scan carries
are plain dicts, tuples and lists of tensors laid out exactly like the JAX
package's pytrees; ``None`` marks an absent subtree and maps to ``None``."""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over one or more trees of the same structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        mapped = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        # a NamedTuple (the optimizer state) takes its fields positionally
        return type(tree)(*mapped) if hasattr(tree, "_fields") else type(tree)(mapped)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_leaves_sorted(tree: Any) -> list:
    """Leaves in the order ``jax.tree.leaves`` gives the same tree: dict keys
    sorted, sequences (tuples, lists, NamedTuples) in order.  A sum over
    leaves in this order rounds as the reference's does."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves_sorted(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_leaves_sorted(v)]
    return [tree]


def tree_stack(trees: Sequence[Any], dim: int = 0) -> Any:
    """Stack same-structured trees leafwise along a new axis ``dim``."""
    return tree_map(lambda *leaves: torch.stack(leaves, dim=dim), *trees)


__all__ = ["tree_leaves", "tree_leaves_sorted", "tree_map", "tree_stack"]
