"""Gradient compression: int8 all-reduce with error feedback (1-bit-Adam
family); the port's counterpart of ``repro/parallel/compression.py``.  The
paper's fixed-point analysis (§III-C) applied to the *collective* datapath:
gradients are quantized to 8-bit fixed point before crossing the
interconnect, and the quantization residual is fed back into the next step
so the bias stays bounded (the state-space view: the residual is a state
variable of the compression loop).

Wire format: the int8 codes, summed as int32 (the reference's ``psum`` of
``q.astype(int32)``), and one fp32 scale per tensor from the mesh-wide
``amax``, reduced first.  The operations keep the reference's order
(``g32 / scale``, round half to even, the clip, ``total · scale / n``),
every divisor a float32 tensor, and the residual is rounded once, so the
mean and the residual are the reference's bit for bit.  A standalone module, as in the reference: the
``Trainer`` does not call it.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch._tree import tree_map
from repro_torch.parallel import comm

PyTree = Any


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


class _Pair:
    """A leaf's ``(mean, new_err)`` held as one tree leaf."""

    __slots__ = ("mean", "err")

    def __init__(self, mean, err):
        self.mean, self.err = mean, err


def compress_leaf(g: torch.Tensor, err: torch.Tensor, group=None):
    """Error-feedback int8 all-reduce of one tensor over ``group``: the
    counterpart of the reference's ``_compress_psum_leaf``.  Returns
    ``(mean, new_err)``; the mean is the same on every rank, the residual
    this rank's own."""
    g32 = g.to(torch.float32) + err
    amax = comm.all_reduce_max(torch.max(torch.abs(g32)), group)
    scale = torch.clamp(amax, min=1e-30) / _f32(127.0, g32)
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    total = comm.all_reduce_typed(q.to(torch.int32), group)
    n = _f32(dist.get_world_size(group), g32)
    mean = total.to(torch.float32) * scale / n
    # the local residual g32 - q·scale, rounded once: the product is exact in
    # float64 and so is the difference (|g32| < 128·scale), as the
    # reference's fused multiply-subtract gives it on XLA's CPU backend
    new_err = (g32.double() - q.double() * scale.double()).to(torch.float32)
    return mean, new_err


def compressed_all_reduce(grads: PyTree, err: PyTree, group=None):
    """All leaves, in order; returns ``(mean_grads, new_err)`` (the
    reference's ``compressed_psum``)."""
    out = tree_map(lambda g, e: _Pair(*compress_leaf(g, e, group)), grads, err)
    return tree_map(lambda p: p.mean, out), tree_map(lambda p: p.err, out)


def init_error_feedback(params: PyTree) -> PyTree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def make_compressed_allreduce(mesh, axis_name: str = "data"):
    """``allreduce(local_grads, err) -> (mean, err)`` over ``mesh``'s
    ``axis_name`` group: each rank passes its own gradient tree and
    residual (the reference stacks them on a leading device axis under
    ``shard_map``); the mean comes back on every rank, the residual stays
    local."""
    group = mesh.get_group(axis_name)

    def allreduce(local_g: PyTree, err: PyTree):
        return compressed_all_reduce(local_g, err, group)

    return allreduce


def reference_mean(local_grads: PyTree):
    """Oracle: the exact fp32 mean over a stacked leading device axis (the
    reference's ``reference_psum_mean``)."""
    return tree_map(lambda g: torch.mean(g.to(torch.float32), dim=0), local_grads)


__all__ = ["compress_leaf", "compressed_all_reduce", "init_error_feedback",
           "make_compressed_allreduce", "reference_mean"]
