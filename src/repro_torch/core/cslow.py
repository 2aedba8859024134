"""C-slow retiming (paper §III-F, Fig. 5); the port's counterpart of
``repro/core/cslow.py``.

On an FPGA, C-slowing replaces every register of a sequential circuit with C
registers, so C *independent* streams march through one shared datapath,
round-robin.  On the card the same interleave is a batch axis:

* :func:`cslow_scan` — the literal transform: one loop whose carry holds C
  state registers and whose body touches stream ``t mod C`` at step t.
* :func:`cslow_vectorized` — the C streams ride a leading batch axis, so the
  one datapath processes all C per step (the reference vmaps; eager PyTorch
  broadcasts the same ops over the extra axis).
* :func:`fold_streams` / :func:`unfold_streams` — C-slow as batching for the
  generated kernel, whose batch dimension carries all C·B streams.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch._tree import tree_leaves, tree_map, tree_stack

from .state_space import StateSpaceModel, run_scan

PyTree = Any


def cslow_scan(
    model: StateSpaceModel,
    stacked_params: PyTree,
    x0_streams: PyTree,  # leading axis C on every leaf
    inputs_streams: PyTree | None,  # [C, N, ...] or None
    num_streams: int,
    length: int | None = None,
):
    """Run C independent streams through ONE shared datapath, round-robin.

    At global cycle t, stream ``c = t mod C`` advances by one step using the
    step-``t // C`` parameters.  Total cycles: C·N.

    Returns (final_states [C, ...], outputs [C, N, ...]).
    """
    C = num_streams
    if length is None:
        leaves = tree_leaves(stacked_params)
        if not leaves:
            raise ValueError(
                "cslow_scan: cannot infer the step count — stacked_params is "
                "None/empty, so pass length= explicitly (the number of steps "
                "each stream advances)."
            )
        length = leaves[0].shape[0]
    N = length
    states = [tree_map(lambda s, c=c: s[c], x0_streams) for c in range(C)]
    ys: list[list] = [[] for _ in range(C)]
    for t in range(C * N):
        c, k = t % C, t // C
        params_k = tree_map(lambda p: p[k], stacked_params)
        u_c = tree_map(lambda u: u[c][k], inputs_streams)
        x_c = states[c]
        states[c] = model.f(params_k, x_c, u_c, k)
        ys[c].append(model.output(params_k, x_c, u_c, k))
    return tree_stack(states), tree_stack([tree_stack(y) for y in ys])


def cslow_vectorized(
    model: StateSpaceModel,
    stacked_params: PyTree,
    x0_streams: PyTree,
    inputs_streams: PyTree | None,
    unroll: int = 1,
):
    """C-slow as a batch axis: identical results to :func:`cslow_scan`, C×
    fewer serial steps.  ``x0_streams`` leaves are ``[C, ...]``,
    ``inputs_streams`` leaves ``[C, N, ...]``; returns
    ``(finals [C, ...], ys [C, N, ...])``."""
    us = tree_map(lambda u: u.movedim(1, 0), inputs_streams)   # [N, C, ...]
    length = None
    if us is None:
        leaves = tree_leaves(stacked_params)
        length = leaves[0].shape[0] if leaves else None
    finals, ys = run_scan(model, stacked_params, x0_streams, us, length=length,
                          unroll=unroll)
    return finals, tree_map(lambda y: y.movedim(0, 1), ys)


def fold_streams(u: torch.Tensor) -> torch.Tensor:
    """C-slow as batching: ``[C, B, ...] -> [(C·B), ...]``."""
    return u.reshape((u.shape[0] * u.shape[1],) + tuple(u.shape[2:]))


def unfold_streams(y: torch.Tensor, num_streams: int) -> torch.Tensor:
    """Undo :func:`fold_streams`: ``[(C·B), ...] -> [C, B, ...]``."""
    C = num_streams
    return y.reshape((C, y.shape[0] // C) + tuple(y.shape[1:]))


def pipeline_schedule(num_stages: int, num_microbatches: int) -> list[list[tuple[int, int]]]:
    """The C-slow/GPipe schedule table: at clock t, stage s processes
    microbatch t - s (if in range); per clock tick, a list of
    (stage, microbatch) pairs."""
    P, C = num_stages, num_microbatches
    table = []
    for t in range(P + C - 1):
        tick = [(s, t - s) for s in range(P) if 0 <= t - s < C]
        table.append(tick)
    return table


def pipeline_utilization(num_stages: int, num_microbatches: int) -> float:
    """Fraction of stage-cycles doing useful work (1 - bubble fraction)."""
    P, C = num_stages, num_microbatches
    return (C * P) / (P * (P + C - 1))


__all__ = [
    "cslow_scan",
    "cslow_vectorized",
    "fold_streams",
    "pipeline_schedule",
    "pipeline_utilization",
    "unfold_streams",
]
