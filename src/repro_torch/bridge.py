"""Bring the reference package's parameters, caches and programs into the port.

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


def program_from_jax(np_params: PyTree, spec, device=None):
    """A reference ``Program.params`` tree (numpy leaves:
    ``{"stages": [{const: array}, ...], "C": array, "beta"?: array}``) →
    the port's :class:`~repro_torch.codegen.ir.Program` for ``spec`` (the
    port's ``NetworkSpec`` with the reference spec's fields), carrying those
    weights as fp32 tensors on ``device`` (default: the card).  The graph
    and schedule come from the port's own builder; every const must match
    its node's shape, or this raises."""
    from repro_torch.codegen import build_program

    dev = resolve_device(device)
    prog = build_program(spec, device="cpu")
    as_t = lambda a: torch.as_tensor(np.array(a, dtype=np.float32)).to(dev)
    if len(np_params["stages"]) != len(prog.stages):
        raise ValueError(f"{len(np_params['stages'])} stages given, "
                         f"{spec.name} has {len(prog.stages)}")
    for st, sp in zip(prog.stages, np_params["stages"]):
        if set(sp) != set(st.params):
            raise ValueError(f"stage '{st.name}': consts {sorted(sp)} given, "
                             f"graph has {sorted(st.params)}")
        st.params = {k: as_t(v) for k, v in sp.items()}
    prog.C = as_t(np_params["C"])
    if ("beta" in np_params) != (prog.beta is not None):
        raise ValueError("beta given for a program without input injection, or missing")
    if prog.beta is not None:
        prog.beta = as_t(np_params["beta"])
    prog.validate()
    return prog


def cache_from_jax(np_tree: PyTree, device=None) -> PyTree:
    """The reference's decode caches (numpy leaves) → port caches, fp32."""
    dev = resolve_device(device)
    return tree_map(
        lambda a: torch.as_tensor(np.array(a)).to(device=dev, dtype=torch.float32),
        np_tree)


__all__ = ["cache_from_jax", "params_from_jax", "program_from_jax"]
