"""State-space execution — the paper's central abstraction; the port's
counterpart of ``repro/core/state_space.py``.

A discrete-time dynamic system (paper eq. 1):

    x[k+1] = f(x[k], u[k], k)
    y[k]   = g(x[k], u[k], k)

is the single execution form used by every network here.  On the FPGA one
combinational datapath (f, g) is time-multiplexed across iterations by a
state register; in eager PyTorch that is a Python loop over k whose carry is
the state register (:func:`run_scan`), and the fully unrolled form is
:func:`run_direct`.  The two are the same loop here, kept as two functions so
that the reference's equivalence properties read the same.

States, inputs, parameters and outputs may be tensors or (nested) dicts,
tuples and lists of tensors; ``None`` marks an absent input or parameter.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Literal, Sequence

import torch
import torch.nn.functional as F

from repro_torch._tree import tree_leaves, tree_map, tree_stack

PyTree = Any

StateFn = Callable[..., PyTree]   # f(params_k, x, u, k) -> x_next
OutputFn = Callable[..., PyTree]  # g(params_k, x, u, k) -> y

# The one activation table (the paper's Create_AF unit).  ``gelu`` is the
# tanh approximation, as ``jax.nn.gelu`` is by default in the reference.
ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "identity": lambda x: x,
}


def resolve_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown activation '{name}'; available: {sorted(ACTIVATIONS)}"
        ) from None


@dataclasses.dataclass
class StateSpaceModel:
    """A discrete-time dynamic system ``(f, g)``.

    ``f`` and ``g`` receive ``(params_k, x, u, k)``; any of ``u``/``k`` may be
    ignored by the callee.  ``params_k`` is the per-step parameter tree (e.g.
    one layer's weights); for scan execution the caller supplies parameters
    stacked along a leading "time" axis.
    """

    f: StateFn
    g: OutputFn
    output_mode: Literal["mealy", "moore"] = "mealy"

    def output(self, params_k, x, u, k):
        if self.output_mode == "moore":
            return self.g(params_k, x, None, k)
        return self.g(params_k, x, u, k)


def _step(model: StateSpaceModel, params_k, x, u, k):
    x_next = model.f(params_k, x, u, k)
    y = model.output(params_k, x, u, k)
    return x_next, y


def run_scan(
    model: StateSpaceModel,
    stacked_params: PyTree,
    x0: PyTree,
    inputs: PyTree | None,
    length: int | None = None,
    unroll: int = 1,
):
    """Iterative (resource-shared) execution: a loop over the steps.

    Args:
      stacked_params: parameter tree with a leading axis of size N (one
        slice per step), or ``None`` for parameterless systems.
      inputs: input tree with leading axis N, or ``None`` (autonomous).
      length: required when both ``stacked_params`` and ``inputs`` are None.
      unroll: the paper's resource/speed knob (j datapath copies per
        pipeline stage).  Eager execution has no compiled loop body to
        unroll, so it changes nothing numerically; it is kept so that one
        schedule means the same call in both packages.

    Returns:
      (x_final, ys) — final state and stacked per-step outputs.
    """
    del unroll
    leaves = tree_leaves(inputs) + tree_leaves(stacked_params)
    if length is None:
        if not leaves:
            raise ValueError("run_scan: pass length= when there are neither "
                             "inputs nor stacked parameters")
        length = leaves[0].shape[0]
    if any(leaf.shape[0] != length for leaf in leaves):
        raise ValueError(f"run_scan: leading axes {[x.shape[0] for x in leaves]} "
                         f"do not all match length {length}")
    x = x0
    ys = []
    for k in range(length):
        params_k = tree_map(lambda p: p[k], stacked_params)
        u = tree_map(lambda a: a[k], inputs)
        x, y = _step(model, params_k, x, u, k)
        ys.append(y)
    return x, (tree_stack(ys) if ys else None)


def run_direct(
    model: StateSpaceModel,
    params_list: Sequence[PyTree],
    x0: PyTree,
    inputs: Sequence[PyTree] | None,
):
    """Fully-unrolled (fully-parallel) execution — the paper's max-area
    extreme; a drop-in equivalent of :func:`run_scan` (outputs stacked along
    a leading time axis)."""
    x = x0
    ys = []
    for k in range(len(params_list)):
        u = None if inputs is None else inputs[k]
        x, y = _step(model, params_list[k], x, u, k)
        ys.append(y)
    return x, tree_stack(ys)


def linear_system(A_provider: Callable[[Any, Any], torch.Tensor]) -> StateSpaceModel:
    """The paper's linear special case (eq. 4): ``x[k+1] = A[k] x[k]``."""

    def f(params_k, x, u, k):
        del u, k
        return A_provider(params_k, None) @ x

    def g(params_k, x, u, k):
        del params_k, u, k
        return x

    return StateSpaceModel(f=f, g=g, output_mode="moore")


# ---------------------------------------------------------------------------
# Paper eq. (8): the NN-as-state-space form.
# ---------------------------------------------------------------------------

def nn_state_space(
    activation: Callable[[torch.Tensor], torch.Tensor],
) -> StateSpaceModel:
    """The case-study NN written as a state-space system (paper eq. 8).

        x[k+1] = f(W[k] x[k] + b[k])        (hidden propagation)
        y      = C x[N]                     (readout, applied by caller)

    ``params_k = {"W": (M, M), "b": (M,)}``.  ``x`` may carry leading batch
    axes (``[..., M]``), where the reference vmaps a single ``[M]`` vector;
    ``W x`` is written ``x Wᵀ`` for that.
    """

    def f(params_k, x, u, k):
        del u, k
        return activation(x @ params_k["W"].transpose(-1, -2) + params_k["b"])

    def g(params_k, x, u, k):
        del params_k, u, k
        return x

    return StateSpaceModel(f=f, g=g, output_mode="moore")


def mlp_forward(
    W_stack: torch.Tensor,   # [N_layers, M, M]
    b_stack: torch.Tensor,   # [N_layers, M]
    beta: torch.Tensor,      # [M, L_in]
    C: torch.Tensor,         # [P, M]
    u: torch.Tensor,         # [..., L_in]
    activation_name: str = "tanh",
    unroll: int = 1,
) -> torch.Tensor:
    """End-to-end paper case-study MLP: y = C · scan(f, β·u), over any
    leading batch axes of ``u``."""
    model = nn_state_space(resolve_activation(activation_name))
    x0 = u @ beta.transpose(-1, -2)
    xN, _ = run_scan(model, {"W": W_stack, "b": b_stack}, x0, None, unroll=unroll)
    return xN @ C.transpose(-1, -2)


__all__ = [
    "ACTIVATIONS",
    "StateSpaceModel",
    "linear_system",
    "mlp_forward",
    "nn_state_space",
    "resolve_activation",
    "run_direct",
    "run_scan",
]
