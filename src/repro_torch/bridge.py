"""Bring the reference package's parameters and caches into the port.

Weights cross over as arrays, never redrawn: the reference's tree, turned
into numpy by its owner (``jax.tree.map(np.asarray, params)``), becomes the
port's dict of tensors with the same layout.  This module itself imports
neither ``jax`` nor ``repro``; only the tests hand it reference objects.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch._tree import tree_map
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig

PyTree = Any


def params_from_jax(np_tree: PyTree, cfg: ModelConfig, device=None) -> PyTree:
    """The reference's ``lm.init_params`` tree (numpy leaves) → port params
    in ``cfg.p_dtype`` on ``device`` (default: the card)."""
    dev = resolve_device(device)
    want = {f"b{i}_{kind}" for i, kind in enumerate(cfg.layer_pattern)}
    if set(np_tree["groups"]) != want:
        raise ValueError(f"group blocks {sorted(np_tree['groups'])} do not match "
                         f"{cfg.name}'s pattern {sorted(want)}")
    return tree_map(
        lambda a: torch.as_tensor(np.array(a)).to(device=dev, dtype=cfg.p_dtype),
        np_tree)


def cache_from_jax(np_tree: PyTree, device=None) -> PyTree:
    """The reference's decode caches (numpy leaves) → port caches, fp32."""
    dev = resolve_device(device)
    return tree_map(
        lambda a: torch.as_tensor(np.array(a)).to(device=dev, dtype=torch.float32),
        np_tree)


__all__ = ["cache_from_jax", "params_from_jax"]
