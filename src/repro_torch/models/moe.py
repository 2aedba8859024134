"""Mixture-of-Experts FFN (deepseek-v2-lite, olmoe); the port's counterpart
of ``repro/models/moe.py``.

GShard-style capacity dispatch in the reference's one-hot formulation:
tokens are split into groups of ``group_size`` (halved until it divides the
token count); within a group every token picks its top-k experts, claims a
capacity slot in the order of a running count over the flattened (token,
choice) sequence, and choices beyond the capacity C are dropped.  Two
one-hot tensors ``[G, g, E, C]`` dispatch the tokens to the experts' slots
and combine the experts' outputs, each by an einsum.

The one-hot form is kept on purpose: which tokens drop, and that a
non-finite token spreads to every token of its group (0 · NaN in the
dispatch einsum), are the reference's behaviour, and the port's server is
held to the reference's tokens.  The expert einsums are batched GEMMs that
the reference computes outside any Pallas kernel, so they are plain
PyTorch here.

In a data-parallel train step (``launch/steps.py``'s ``make_train_step(
mesh=)``) each rank holds its rows of the global microbatch, and the layer
still forms the reference's groups over the global token count
(:func:`moe_apply`): a rank whose rows hold whole groups routes them
itself, and a group that spans ranks is gathered whole.  The Switch aux
loss is a product of two means over every token, so each rank adds its
tokens' share of the global aux: the shares sum to the reference's aux
over the data ranks, in value and in gradient.

On a model shard (``parallel.sharding.model_shard``) a rank holds its
block of the experts (``w_in``/``w_gate``/``w_out`` ``[E/tp, ...]``, the
rules' expert axis over ``model``) and its columns of the shared experts'
MLP, while the router stays whole and every model rank holds every token:
the routing and the slot assignment run whole and identically on every
model rank (each expert's slots are a running count over its own
column), the rank keeps its experts' columns of the dispatch and combine
one-hots, and the partial outputs (its experts' and its shared columns')
are summed by one ``all_reduce`` over ``model``.  The combine weights and
the experts' input pass through ``copy_to_model``, so their gradients are
summed over the ranks; the Switch aux is whole on every rank and its
router gradient is not summed (the loss is not summed over ``model``).
Where the axis does not divide ``n_experts`` the rules keep the experts
whole, and so does the layer, read from the leaves' shapes.

The router state (expert assignments) is part of the layer's
*combinational logic* in the paper's language; no sequential state is
carried, so MoE layers drop into the layer stack unchanged.
"""

from __future__ import annotations

from typing import Any, TYPE_CHECKING

import torch
import torch.nn.functional as F

from repro_torch.parallel import tensor_parallel as tp_lib

from .layers import dense_init, mlp_apply, mlp_params

if TYPE_CHECKING:
    from .config import ModelConfig

PyTree = Any

DEFAULT_GROUP_SIZE = 2048


def moe_params(gen: torch.Generator, cfg: ModelConfig) -> PyTree:
    """``router [D, E]`` (always fp32), ``w_in``/``w_gate [E, D, F]``,
    ``w_out [E, F, D]`` and, with shared experts, ``shared``: the gated MLP
    of width ``n_shared_experts · F``.  The reference scales the expert
    tensors by their leading (expert) axis, and so does the port."""
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    dt = cfg.p_dtype
    p = {
        "router": dense_init(gen, (D, E), torch.float32),
        "w_in": dense_init(gen, (E, D, Fe), dt),
        "w_gate": dense_init(gen, (E, D, Fe), dt),
        "w_out": dense_init(gen, (E, Fe, D), dt),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_params(gen, D, cfg.n_shared_experts * Fe, True, dt)
    return p


def _capacity(group_size: int, cfg: ModelConfig) -> int:
    cap = int(group_size * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(cap, cfg.top_k)


def group_size_of(tokens: int, group_size: int = DEFAULT_GROUP_SIZE) -> int:
    """The reference's group rule: ``min(group_size, tokens)``, halved until
    it divides ``tokens`` (an odd count above ``group_size`` runs groups of
    one token)."""
    g = min(group_size, tokens)
    while tokens % g:
        g //= 2
    return g


def route(p, cfg: ModelConfig, x: torch.Tensor, data=None):
    """x: [..., D] → (top-k expert ids, normalised weights in x's dtype,
    Switch aux loss).  The ids are in descending order of probability, as
    ``jax.lax.top_k`` gives them: the slot order depends on it.

    ``data`` is ``(group, dp)`` when ``x`` is this rank's tokens of a
    global batch over ``dp`` data ranks: the expert fractions are then
    counted over every rank's tokens (one ``all_reduce``, no gradient), and
    the aux is this rank's share, ``E · Σ_e f_e · Σ_{t here} p_te / T``
    with T the global token count; the ranks' shares sum to the global
    aux."""
    logits = x.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, cfg.top_k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    # Switch-style load-balance loss: E · Σ_e fraction_e · mean_prob_e
    E = cfg.n_experts
    lead = tuple(range(top_e.dim() - 1))
    chosen = F.one_hot(top_e, E).float().sum(dim=-2)
    if data is None:
        f = chosen.mean(dim=lead) / cfg.top_k
        pbar = probs.mean(dim=lead)
    else:
        from repro_torch.parallel import comm

        group, dp = data
        tokens = chosen[..., 0].numel() * dp
        f = comm.all_reduce(chosen.sum(dim=lead), group) / tokens / cfg.top_k
        pbar = probs.sum(dim=lead) / tokens
    aux = E * torch.sum(f * pbar)
    return top_e, top_w.to(x.dtype), aux


def moe_apply(p, cfg: ModelConfig, x: torch.Tensor, group_size: int = DEFAULT_GROUP_SIZE):
    """x: [B, S, D] → (y, aux_loss).  Capacity-based top-k dispatch.

    Inside a data-parallel train step (``parallel.sharding.data_share``)
    ``x`` is this rank's ``B`` rows of a global microbatch of ``dp · B``,
    and the groups are the reference's over its ``dp · B · S`` tokens:

    * **aligned**: when a group lies inside this rank's rows, the rank
      routes its own groups, and only the expert fractions are summed over
      the data ranks (:func:`route`);
    * **spanning**: when a group spans ranks, the tokens are gathered
      exactly over the data ranks (``comm.gather_rows_grad``, whose
      backward sums the gradient over the ranks and keeps this rank's
      rows), the whole microbatch is routed as one device routes it, and
      this rank keeps its rows and ``aux / dp``.

    Either way each rank's aux is its share: summed over the data ranks,
    as the train step sums the ranks' losses, it is the reference's aux
    once in value and once per token in gradient."""
    from repro_torch.parallel.sharding import data_share

    B, S, D = x.shape
    share = data_share(B)
    if share is None:
        return _moe_groups(p, cfg, x, group_size_of(B * S, group_size))
    group, index, dp = share
    T = B * S
    g = group_size_of(dp * T, group_size)
    if T % g == 0:
        return _moe_groups(p, cfg, x, g, data=(group, dp))
    from repro_torch.parallel import comm

    xg = comm.gather_rows_grad(x.reshape(T, D), index, dp, group)
    y, aux = _moe_groups(p, cfg, xg.reshape(dp * B, S, D), g)
    return y[index * B:(index + 1) * B], aux / dp


def _moe_groups(p, cfg: ModelConfig, x: torch.Tensor, g: int, data=None):
    """The dispatch over groups of ``g`` consecutive tokens of ``x``, on
    this rank's experts (all of them off a model shard)."""
    B, S, D = x.shape
    G = B * S // g
    xt = x.reshape(G, g, D)

    top_e, top_w, aux = route(p, cfg, xt, data)  # [G,g,k] ids / weights
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(g, cfg)
    e0, e1 = tp_lib.own_range(p["w_in"].shape[0], E)
    split = e1 - e0 < E
    shared = p.get("shared")
    shared_split = shared is not None and \
        shared["w_out"].shape[0] < cfg.n_shared_experts * cfg.d_ff_expert
    # the input of the parts cut over model, its gradient summed over the ranks
    xs = tp_lib.copy_to_model(xt) if split or shared_split else xt

    # Slot assignment: position of each (token, choice) within its expert's
    # queue, a running count over the flattened (token-major) choice order;
    # choices at slot C or beyond are dropped.
    e_onehot = F.one_hot(top_e, E)                                 # [G,g,k,E] int64
    flat = e_onehot.reshape(G, g * k, E)
    pos = torch.cumsum(flat, dim=1) - flat                         # slots before me
    slot = (pos * flat).sum(-1).reshape(G, g, k)                   # [G,g,k]
    keep = slot < C
    if split:
        # this rank's experts' columns; their combine weights' gradient is
        # a part of the router's, summed over model (the aux's is not)
        e_onehot = e_onehot[..., e0:e1]
        top_w = tp_lib.copy_to_model(top_w)

    # dispatch/combine tensors [G, g, E, C]: a dropped choice goes to the
    # extra class C, whose column is cut off (the reference's one_hot of an
    # out-of-range index is a zero row)
    slot_oh = F.one_hot(torch.where(keep, slot, C), C + 1)[..., :C].to(x.dtype)
    e_oh = e_onehot.to(x.dtype)
    dispatch = torch.einsum("Gtke,Gtkc->Gtec", e_oh, slot_oh)
    combine = torch.einsum("Gtke,Gtkc->Gtec", e_oh * top_w[..., None], slot_oh)

    xe = torch.einsum("Gtec,Gtd->Gecd", dispatch, xs if split else xt)  # [G,E,C,D]
    h = torch.einsum("Gecd,edf->Gecf", xe, p["w_in"])
    hg = torch.einsum("Gecd,edf->Gecf", xe, p["w_gate"])
    h = F.silu(hg) * h
    ye = torch.einsum("Gecf,efd->Gecd", h, p["w_out"])             # [G,E,C,D]
    y = torch.einsum("Gtec,Gecd->Gtd", combine, ye)

    y_sh = None if shared is None else \
        mlp_apply(shared, xs if shared_split else xt, act=cfg.mlp_act)
    if y_sh is not None and shared_split == split:
        y, y_sh = y + y_sh, None                     # both partial: one sum over model
    if split:
        y = tp_lib.reduce_from_model(y)
    if y_sh is not None:
        y = y + (tp_lib.reduce_from_model(y_sh) if shared_split else y_sh)

    return y.reshape(B, S, D), aux


__all__ = ["DEFAULT_GROUP_SIZE", "group_size_of", "moe_apply", "moe_params", "route"]
