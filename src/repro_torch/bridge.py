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
    in ``cfg.p_dtype`` on ``device`` (default: the card).  Any ported block
    kind crosses over leaf for leaf (``b0_recurrent``, ``b0_mamba1``,
    ``b0_mamba2``, ``b0_attn`` and ``b0_attn_local`` with their ``attn``
    and ``mlp`` subtrees, ``b*_shared_attn`` with its ``lora``, ``b0_moe``
    with its ``attn`` and its ``moe`` subtree: ``router``, ``w_in``,
    ``w_gate``, ``w_out`` and the ``shared`` experts' MLP; MLA's ``wq``,
    ``w_dkv``, ``w_krope``, ``w_uk``, ``w_uv``, ``wo`` and ``kv_norm`` under
    ``attn``; ``b4_cross`` with its ``cross`` subtree, the ``gate`` among
    its leaves, and its ``mlp``; an encoder's ``embed.proj``), and so do the
    unstacked ``"tail"`` blocks (``t0_attn_local``,
    ``t0_mamba2``) of a config with a ``tail_pattern`` and the ``"shared"``
    block of a config whose pattern has ``shared_attn``.  A ``router``
    stays fp32 whatever ``cfg.p_dtype`` is, as the reference keeps it.
    The tree must hold exactly the blocks, tail and shared block that
    ``cfg`` names, or this raises."""
    return _cross_params(np_tree, cfg, device, None)


def _cross_params(np_tree: PyTree, cfg: ModelConfig, device, dtype) -> PyTree:
    """``params_from_jax``'s checks and mapping; every leaf in ``dtype``, or
    (None) in ``cfg.p_dtype`` with a ``router`` in fp32."""
    dev = resolve_device(device)
    want = {f"b{i}_{kind}" for i, kind in enumerate(cfg.layer_pattern)}
    if set(np_tree["groups"]) != want:
        raise ValueError(f"group blocks {sorted(np_tree['groups'])} do not match "
                         f"{cfg.name}'s pattern {sorted(want)}")
    want_tail = {f"t{i}_{kind}" for i, kind in enumerate(cfg.tail_pattern)}
    got_tail = set(np_tree.get("tail", {}))
    if got_tail != want_tail:
        raise ValueError(f"tail blocks {sorted(got_tail)} do not match "
                         f"{cfg.name}'s tail pattern {sorted(want_tail)}")
    want_shared = "shared_attn" in cfg.layer_pattern
    if ("shared" in np_tree) != want_shared:
        raise ValueError(f"a 'shared' subtree is {'missing' if want_shared else 'given'}: "
                         f"{cfg.name}'s pattern {cfg.layer_pattern} "
                         f"{'has' if want_shared else 'has no'} shared_attn block")
    def cross(tree, name):
        if isinstance(tree, dict):
            return {k: cross(v, k) for k, v in tree.items()}
        dt = dtype or (torch.float32 if name == "router" else cfg.p_dtype)
        arr = np.array(tree)
        if arr.dtype.name == "bfloat16":    # ml_dtypes' type: torch cannot read it
            arr = arr.astype(np.float32)    # exact; cast back below
        return torch.as_tensor(arr).to(device=dev, dtype=dt)

    return cross(np_tree, "")


def adamw_state_from_jax(np_state, cfg: ModelConfig, device=None):
    """The reference's ``optim.AdamWState`` (numpy leaves: an int32 ``step``
    and the fp32 moment trees ``m`` and ``v``, laid out like the params) →
    the port's :class:`~repro_torch.optim.AdamWState` on ``device``
    (default: the card), the moments through ``params_from_jax``'s checks
    and mapping, kept in fp32 whatever ``cfg.p_dtype`` is.  A reference
    gradient tree crosses over as ``params_from_jax(grads, cfg, device)``
    (the gradients of bf16 params are bf16)."""
    from repro_torch.optim import AdamWState

    dev = resolve_device(device)
    step, m, v = np_state
    return AdamWState(
        step=torch.as_tensor(np.array(step, dtype=np.int32)).to(dev),
        m=_cross_params(m, cfg, dev, torch.float32),
        v=_cross_params(v, cfg, dev, torch.float32),
    )


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
    """The reference's decode caches (numpy leaves: recurrent ``h``/``c``,
    Mamba-1 ``h``/``conv``, Mamba-2 ``h`` and the nested ``conv: {x, bc}``,
    attention ``k``/``v``, MLA ``c_kv``/``k_rope``, sliding-window rings, a
    cross block's dummy leaf; the ``"groups"`` subtree
    and, with a ``tail_pattern``, the unstacked ``"tail"`` one) → port
    caches of the same layout, fp32."""
    dev = resolve_device(device)
    return tree_map(
        lambda a: torch.as_tensor(np.array(a)).to(device=dev, dtype=torch.float32),
        np_tree)


__all__ = ["adamw_state_from_jax", "cache_from_jax", "params_from_jax",
           "program_from_jax"]
