"""A batched forward split over a mesh's data ranks, with its output joined
on every rank bit for bit (``synthesize(mesh=)``'s DP on both backends)."""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.launch.mesh import data_group, local_shard, mesh_dp

from . import comm

PyTree = Any


def data_parallel(forward: Callable, mesh) -> Callable:
    """``forward(params, u)`` over the data ranks of ``mesh``: each rank runs
    its block of the leading axis, and the output's blocks are joined on
    every rank; a leading axis that ``dp`` does not divide runs whole on
    every rank."""
    dp = mesh_dp(mesh)
    if dp <= 1:
        return forward
    r, group = local_shard(mesh), data_group(mesh)

    def sharded_forward(params: PyTree, u: torch.Tensor) -> torch.Tensor:
        if u.shape[0] % dp:
            return forward(params, u)
        n = u.shape[0] // dp
        return comm.gather_rows_exact(forward(params, u[r * n:(r + 1) * n]), r, dp, group)

    return sharded_forward


__all__ = ["data_parallel"]
