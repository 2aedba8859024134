"""Top-level language model: embed → groups → head; the port's counterpart
of ``repro/models/lm.py`` for the families ported so far (recurrent, ssm
and dense; no cross-attention ``memory`` argument and no ``tail_pattern``
yet).

The whole network is one state-space system (paper eq. 8): in prefill the
state is the activations flowing across layer groups; in decode the state
is the caches (the ``(h, c)`` carries of a recurrent stack, the scan state
of a Mamba stack, the KV cache of a transformer) and one ``decode_step`` is
one application of the state-update map f with the new token as input u[k].

The parameter layout mirrors the reference's: ``{"embed": {"table"},
"groups": {"b0_recurrent" | "b0_mamba1" | "b0_attn": ...}, "final_norm":
{"scale"}}`` (+ ``"head"`` when embeddings are untied), with every
per-group leaf stacked on a leading ``G`` axis.  The reference scans over
groups; the port loops over them.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.device import resolve_device

from .config import ModelConfig
from .layers import dense_init, embed, embedding_params, rmsnorm, rmsnorm_params
from .transformer import apply_block, group_params, init_cache

PyTree = Any

__all__ = [
    "init_params",
    "forward",
    "prefill",
    "prefill_chunk",
    "decode_step",
    "init_cache",
    "param_count",
]


def init_params(cfg: ModelConfig, gen: torch.Generator, *, device=None) -> PyTree:
    """Random parameters drawn from ``gen`` on ``device`` (default: the
    card).  The generator must live on that device."""
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"generator is on {gen.device}, parameters go to {dev}")
    if cfg.family == "encoder":
        raise NotImplementedError("encoder frontends are not ported to repro_torch yet")
    params: dict[str, Any] = {
        "embed": embedding_params(gen, cfg.vocab, cfg.d_model, cfg.p_dtype)}
    # each stacked [G, ...] leaf is allocated once and filled group by group,
    # so the peak is the tree plus one group (stacking G per-group trees
    # would hold the tree twice: 58 GB for falcon-mamba-7b in fp32)
    grp = group_params(gen, cfg)
    stacked = tree_map(lambda t: t.new_empty((cfg.n_groups,) + tuple(t.shape)), grp)
    for g in range(cfg.n_groups):
        if g:
            grp = group_params(gen, cfg)
        tree_map(lambda dst, src: dst[g].copy_(src), stacked, grp)
        del grp
    params["groups"] = stacked
    params["final_norm"] = rmsnorm_params(cfg.d_model, cfg.p_dtype, gen.device)
    if not cfg.tie_embeddings:
        params["head"] = {"w": dense_init(gen, (cfg.d_model, cfg.vocab), cfg.p_dtype)}
    return params


def param_count(params: PyTree) -> int:
    return sum(int(p.numel()) for p in tree_leaves(params))


# ---------------------------------------------------------------------------
# group stack
# ---------------------------------------------------------------------------

def _apply_groups(params, cfg: ModelConfig, x, *, caches, pos, mode):
    pattern = cfg.layer_pattern
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    per_group = []
    for g in range(cfg.n_groups):
        p_grp = tree_map(lambda t: t[g], params["groups"])
        c_grp = None if caches is None else tree_map(lambda t: t[g], caches["groups"])
        new_caches = {}
        for i, kind in enumerate(pattern):
            name = f"b{i}_{kind}"
            c_in = None if c_grp is None else c_grp.get(name)
            x, c_out, aux_i = apply_block(p_grp[name], cfg, kind, x,
                                          cache=c_in, pos=pos, mode=mode)
            aux = aux + aux_i
            new_caches[name] = c_out
        per_group.append(new_caches)
    if mode == "train":
        return x, aux, None
    return x, aux, {"groups": tree_map(lambda *ls: torch.stack(ls), *per_group)}


def _embed_in(params, cfg: ModelConfig, tokens):
    return embed(params["embed"], tokens.long()).to(cfg.act_dtype)


def _head(params, cfg: ModelConfig, h):
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    if cfg.tie_embeddings:
        return h @ params["embed"]["table"].T
    return h @ params["head"]["w"]


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, tokens, *, mode="train"):
    """Full-sequence forward.  mode: "train" (no caches) | "prefill"."""
    x = _embed_in(params, cfg, tokens)
    h, aux, out_caches = _apply_groups(params, cfg, x, caches=None, pos=None, mode=mode)
    logits = _head(params, cfg, h)
    if mode == "prefill":
        return logits, out_caches, aux
    return logits, aux


def prefill(params, cfg: ModelConfig, tokens):
    """Returns (last-token logits, caches) — cache seeding for serving."""
    logits, caches, _ = forward(params, cfg, tokens, mode="prefill")
    return logits[:, -1], caches


def prefill_chunk(params, cfg: ModelConfig, tokens, caches, pos):
    """Resumable prefill: one chunk of the prompt scan, applied against
    existing decode-layout ``caches`` from absolute position ``pos``.
    Chaining chunks from a fresh ``init_cache`` reproduces one-shot
    :func:`prefill`.  Returns (last-token logits [B, V], updated caches)."""
    x = _embed_in(params, cfg, tokens)
    h, _, out_caches = _apply_groups(params, cfg, x, caches=caches, pos=pos, mode="chunk")
    logits = _head(params, cfg, h)
    return logits[:, -1], out_caches


def decode_step(params, cfg: ModelConfig, tokens, caches, pos):
    """One serving step: tokens [B,1] at position(s) ``pos``: f(x[k], u[k])
    of the serving state-space system."""
    x = _embed_in(params, cfg, tokens)
    h, _, out_caches = _apply_groups(params, cfg, x, caches=caches, pos=pos, mode="decode")
    logits = _head(params, cfg, h)
    return logits[:, -1], out_caches
