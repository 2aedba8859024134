"""Explicit expert-parallel MoE dispatch over ``torch.distributed``; the
port's counterpart of ``repro/parallel/ep_moe.py``.

Tokens and experts shard over the same axis of the mesh.  Each rank routes
its own tokens, packs one slot buffer per expert, and exactly **two
``all_to_all_single`` calls per MoE layer** (dispatch and return) move the
token slots to the ranks that own their experts and back: a fixed,
auditable collective schedule (:data:`repro_torch.parallel.comm.COUNTS`
counts them).

Capacity per (rank, expert) is ``max(int(T_local·k·cf/E), k)``; choices past
it drop, which is :func:`repro_torch.models.moe.moe_apply` with
``group_size == T_local``, the oracle the tests hold it to.

The function is SPMD: every rank of the axis calls it with its own tokens
``x [T_local, D]`` and gets its own rows of the output.  The expert weights
may be the whole ``[E, ...]`` stacks (each rank reads its own ``E/ep``
block) or that rank's block alone.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models.layers import mlp_apply
from repro_torch.models.moe import route

from . import comm

PyTree = Any


def _local_experts(w: torch.Tensor, E: int, E_local: int, r: int) -> torch.Tensor:
    if w.shape[0] == E_local:
        return w
    if w.shape[0] != E:
        raise ValueError(f"ep_moe_apply: expert stack of {w.shape[0]} for E={E}, "
                         f"E_local={E_local}")
    return w[r * E_local:(r + 1) * E_local]


def ep_moe_apply(p: PyTree, cfg, x: torch.Tensor, mesh, *, axis: str = "model") -> torch.Tensor:
    """x: this rank's tokens ``[T_local, D]``; returns its output rows
    ``[T_local, D]``.  ``mesh`` is a ``DeviceMesh`` with an ``axis`` dim
    whose size divides ``cfg.n_experts``."""
    T, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    group = mesh.get_group(axis)
    ep = dist.get_world_size(group)
    if E % ep:
        raise ValueError(f"ep_moe_apply: {E} experts do not split over {ep} ranks")
    E_local, r = E // ep, dist.get_rank(group)
    C = max(int(T * k * cfg.capacity_factor / E), k)

    top_e, top_w, _ = route(p, cfg, x)                       # [T, k]
    flat = F.one_hot(top_e, E).reshape(T * k, E)
    pos = torch.cumsum(flat, dim=0) - flat
    slot = (pos * flat).sum(-1).reshape(T, k)
    keep = slot < C

    # pack the send buffer [E, C, D]: slot (e, c) holds one token's row; a
    # choice is in its own slot, so the kept rows are written, not summed
    dest = (top_e * C + slot).reshape(-1)
    kept = keep.reshape(-1)
    rows = torch.arange(T, device=x.device).repeat_interleave(k)
    send = torch.zeros(E * C, D, dtype=x.dtype, device=x.device)
    send[dest[kept]] = x[rows[kept]]

    # dispatch: rank r receives, for ITS experts, every rank's slots
    recv = torch.empty_like(send)
    comm.all_to_all_single(recv, send, group)                 # [ep, E_local, C, D]
    recv = recv.reshape(ep, E_local, C, D).transpose(0, 1).reshape(E_local, ep * C, D)

    w_in = _local_experts(p["w_in"], E, E_local, r)
    w_gate = _local_experts(p["w_gate"], E, E_local, r)
    w_out = _local_experts(p["w_out"], E, E_local, r)
    h = torch.einsum("ecd,edf->ecf", recv, w_in)
    hg = torch.einsum("ecd,edf->ecf", recv, w_gate)
    y_e = torch.einsum("ecf,efd->ecd", F.silu(hg) * h, w_out)   # [E_local, ep*C, D]

    # return trip: each source rank gets its slots back, [ep, E_local, C, D]
    back = y_e.reshape(E_local, ep, C, D).transpose(0, 1).contiguous()
    ret = torch.empty_like(back)
    comm.all_to_all_single(ret, back, group)
    ret = ret.reshape(E * C, D)

    # combine on the owning rank
    g = torch.where(keep.reshape(-1, 1), ret[torch.where(kept, dest, 0)],
                    torch.zeros((), dtype=ret.dtype, device=ret.device)).reshape(T, k, D)
    y = (g * top_w[..., None]).sum(dim=1)

    if cfg.n_shared_experts:
        y = y + mlp_apply(p["shared"], x, act=cfg.mlp_act)
    return y


__all__ = ["ep_moe_apply"]
