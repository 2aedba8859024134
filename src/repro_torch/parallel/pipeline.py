"""Pipeline parallelism = C-slow retiming across devices (paper §III-F); the
port's counterpart of ``repro/parallel/pipeline.py``.

The FPGA view: C-slowing a datapath lets C independent streams share it;
retiming then spreads the logic across pipeline registers.  Across ranks,
the datapath is the layer stack split into P stages (one per rank along the
``stage`` mesh axis), the streams are C microbatches, and the pipeline
registers are the ring transfers between neighbours.  Utilization is the
classic C·P / (P·(P+C−1)) — exactly ``core.cslow.pipeline_utilization``.

The schedule is the reference's GPipe/C-slow loop: C + P − 1 ticks, one
ring transfer a tick (``comm.ppermute``, counted, as the reference's
``collective-permute`` shows in its HLO); stage 0 ingests microbatch ``t``
and the last stage retires microbatch ``t − (P − 1)``; one final sum brings
the outputs to every rank, as the reference's ``psum`` does.  A standalone
module, as in the reference: the ``Trainer`` does not call it.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.parallel import comm

PyTree = Any


def pipeline_apply(
    stage_fn: Callable[[PyTree, torch.Tensor], torch.Tensor],
    stage_params: PyTree,          # leaves [P, ...]: one slice per stage
    microbatches: torch.Tensor,    # [C, mb, ...]
    mesh,
    axis_name: str = "stage",
) -> torch.Tensor:
    """Run ``microbatches`` through P chained stages, one stage per rank of
    ``mesh``'s ``axis_name``, on the GPipe/C-slow schedule.  Every rank
    passes the same arguments and gets the ``[C, mb, ...]`` outputs, equal
    to applying the stages in order to each microbatch."""
    C = microbatches.shape[0]
    group = mesh.get_group(axis_name)
    num_stages = mesh.size(mesh.mesh_dim_names.index(axis_name))
    idx = mesh.get_local_rank(axis_name)
    params_here = tree_map(lambda p: p[idx], stage_params)
    last = idx == num_stages - 1

    buf = torch.zeros_like(microbatches[0])
    outs = torch.zeros_like(microbatches)
    for t in range(C + num_stages - 1):
        # stage 0 ingests microbatch t (if any); the others use the buffer
        x_in = microbatches[t if t < C else 0] if idx == 0 else buf
        y = stage_fn(params_here, x_in)
        # the last stage retires microbatch t - (P - 1)
        ret = t - (num_stages - 1)
        if last and 0 <= ret < C:
            outs[ret] = y.to(outs.dtype)
        buf = comm.ppermute(y, 1, group)
    # outputs live on the last stage only; the sum broadcasts them
    return comm.all_reduce(outs, group)


def sequential_reference(stage_fn, stage_params, microbatches: torch.Tensor) -> torch.Tensor:
    """Oracle: apply the P stages in order to every microbatch."""
    num_stages = tree_leaves(stage_params)[0].shape[0]

    def one(x):
        for s in range(num_stages):
            x = stage_fn(tree_map(lambda p: p[s], stage_params), x)
        return x

    return torch.stack([one(x) for x in microbatches])


__all__ = ["pipeline_apply", "sequential_reference"]
