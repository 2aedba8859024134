"""Top-level language / encoder / VLM model: embed → groups → tail → head;
the port's counterpart of ``repro/models/lm.py`` for every family of the
reference (recurrent, ssm, dense with gemma3's ``tail_pattern``, hybrid,
moe, the ``encoder`` and the ``vlm``).

An encoder (hubert) takes precomputed frame embeddings ``[B, S,
frontend_dim]`` in place of tokens and projects them with
``embed.proj``; a VLM (llama-vision) takes token ids and a ``memory=``
``[B, M, frontend_dim]`` that its ``cross`` blocks attend to in every entry
point, decode included.

The whole network is one state-space system (paper eq. 8): in prefill the
state is the activations flowing across layer groups; in decode the state
is the caches (the ``(h, c)`` carries of a recurrent stack, the scan states
of a Mamba stack, the KV cache of a transformer, both in a hybrid) and one
``decode_step`` is one application of the state-update map f with the new
token as input u[k].

The parameter layout mirrors the reference's: ``{"embed": {"table"} (an
encoder's: {"proj"}),
"groups": {"b0_recurrent" | "b0_mamba1" | "b0_attn" | "b0_attn_local" |
"b0_mamba2" … "b5_shared_attn": ...}, "final_norm": {"scale"}}`` (+
``"shared": {"attn", "mlp"}``, the one shared transformer block, when the
pattern has ``shared_attn``; + ``"tail": {"t0_attn_local" | "t0_mamba2":
...}`` with a ``tail_pattern``; + ``"head"`` when embeddings are untied),
with every per-group leaf stacked on a leading ``G`` axis and the shared
and tail leaves unstacked.  The reference scans over groups; the port
loops over them.  ``train_loss`` is the training objective; under
``cfg.remat`` each group is recomputed in the backward pass
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.device import resolve_device
from repro_torch.parallel import tensor_parallel as tp_lib
from repro_torch.parallel.sharding import (
    constrain_activation,
    map_with_path,
    recompute_contexts,
)

from .config import ModelConfig
from .layers import dense_init, embed, embedding_params, rmsnorm, rmsnorm_params
from .transformer import (
    apply_block,
    group_params,
    init_cache,
    shared_block_params,
    tail_params,
)

PyTree = Any

__all__ = [
    "init_params",
    "forward",
    "prefill",
    "prefill_chunk",
    "decode_step",
    "init_cache",
    "param_count",
    "train_loss",
]


def init_params(cfg: ModelConfig, gen: torch.Generator, *, device=None, cut=None) -> PyTree:
    """Random parameters drawn from ``gen`` on ``device`` (default: the
    card).  The generator must live on that device.

    ``cut(path, leaf)``, where given, returns the part of each leaf to keep
    (a view), as soon as the leaf is drawn; a stacked leaf's path names the
    stacked leaf and ``leaf`` is one group's slice of it.  The whole stream
    is drawn in the same order, so the kept parts hold the values of the
    whole tree's, and the peak is the kept parts and one group
    (``ShardPlan.draw_local``)."""
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"generator is on {gen.device}, parameters go to {dev}")

    def keep(prefix, tree, stacked=False):
        if cut is None:
            return tree
        return map_with_path(lambda path, t: cut(path, t) if stacked else cut(path, t).clone(),
                             tree, prefix)

    params: dict[str, Any] = {}
    if cfg.family == "encoder":
        # audio frontend stub: precomputed frame embeddings -> linear proj
        params["embed"] = keep("embed", {"proj": dense_init(gen, (cfg.frontend_dim, cfg.d_model),
                                                            cfg.p_dtype)})
    else:
        params["embed"] = keep("embed",
                               embedding_params(gen, cfg.vocab, cfg.d_model, cfg.p_dtype))
    # each stacked [G, ...] leaf is allocated once and filled group by group,
    # so the peak is the tree plus one group (stacking G per-group trees
    # would hold the tree twice: 58 GB for falcon-mamba-7b in fp32)
    grp = keep("groups", group_params(gen, cfg), stacked=True)
    stacked = tree_map(lambda t: t.new_empty((cfg.n_groups,) + tuple(t.shape)), grp)
    for g in range(cfg.n_groups):
        if g:
            grp = keep("groups", group_params(gen, cfg), stacked=True)
        tree_map(lambda dst, src: dst[g].copy_(src), stacked, grp)
        del grp
    params["groups"] = stacked
    shared = shared_block_params(gen, cfg)
    if shared is not None:
        params["shared"] = keep("shared", shared)
    tail = tail_params(gen, cfg)
    if tail is not None:
        params["tail"] = keep("tail", tail)
    params["final_norm"] = keep("final_norm",
                                rmsnorm_params(cfg.d_model, cfg.p_dtype, gen.device))
    if not cfg.tie_embeddings:
        params["head"] = keep("head", {"w": dense_init(gen, (cfg.d_model, cfg.vocab),
                                                       cfg.p_dtype)})
    return params


def param_count(params: PyTree) -> int:
    return sum(int(p.numel()) for p in tree_leaves(params))


# ---------------------------------------------------------------------------
# group stack
# ---------------------------------------------------------------------------

def _apply_groups(params, cfg: ModelConfig, x, *, memory, caches, pos, mode):
    pattern = cfg.layer_pattern
    shared = params.get("shared")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    per_group = []

    def group_body(g, x, aux, c_grp):
        p_grp = tree_map(lambda t: t[g], params["groups"])
        new_caches = {}
        for i, kind in enumerate(pattern):
            name = f"b{i}_{kind}"
            c_in = None if c_grp is None else c_grp.get(name)
            x, c_out, aux_i = apply_block(p_grp[name], shared, cfg, kind, x, memory=memory,
                                          cache=c_in, pos=pos, mode=mode)
            aux = aux + aux_i
            # the reference's scan stores a scalar for a block without a
            # cache (a cross block in prefill): its leaf stacks to [G]
            new_caches[name] = c_out if c_out is not None else \
                torch.zeros((), dtype=torch.float32, device=x.device)
        return x, aux, new_caches

    # the reference's jax.checkpoint of the group body: a group keeps only
    # its input for backward and recomputes its activations there
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    for g in range(cfg.n_groups):
        x = constrain_activation(x)   # each group's input: this rank's rows (a check)
        c_grp = None if caches is None else tree_map(lambda t: t[g], caches["groups"])
        if remat:
            x, aux, new_caches = checkpoint(group_body, g, x, aux, c_grp,
                                            use_reentrant=False,
                                            context_fn=recompute_contexts)
        else:
            x, aux, new_caches = group_body(g, x, aux, c_grp)
        per_group.append(new_caches)
    tail_in = None if caches is None else caches.get("tail")
    tail_out = {}
    for i, kind in enumerate(cfg.tail_pattern):
        name = f"t{i}_{kind}"
        c_in = None if tail_in is None else tail_in.get(name)
        x, c_out, aux_i = apply_block(params["tail"][name], shared, cfg, kind, x,
                                      memory=memory, cache=c_in, pos=pos, mode=mode)
        aux = aux + aux_i
        tail_out[name] = c_out
    if mode == "train":
        return x, aux, None
    out_caches = {"groups": tree_map(lambda *ls: torch.stack(ls), *per_group)}
    if tail_out:
        out_caches["tail"] = tail_out
    return x, aux, out_caches


def _embed_in(params, cfg: ModelConfig, tokens_or_embeds):
    if cfg.family == "encoder":
        return tokens_or_embeds.to(cfg.act_dtype) @ params["embed"]["proj"]
    return embed(params["embed"], tokens_or_embeds.long(), cfg.vocab).to(cfg.act_dtype)


def _head(params, cfg: ModelConfig, h):
    """The logits: this rank's vocabulary slice on a model shard whose
    table (or head) holds its rows (columns) of the vocabulary."""
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    if cfg.tie_embeddings:
        return tp_lib.vocab_logits(h, params["embed"]["table"], cfg.vocab, tied=True)
    return tp_lib.vocab_logits(h, params["head"]["w"], cfg.vocab, tied=False)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, tokens, *, memory=None, mode="train"):
    """Full-sequence forward of token ids [B,S] (an encoder's frame
    embeddings [B,S,frontend_dim]).  mode: "train" (no caches) | "prefill"."""
    x = _embed_in(params, cfg, tokens)
    h, aux, out_caches = _apply_groups(params, cfg, x, memory=memory, caches=None, pos=None,
                                       mode=mode)
    logits = _head(params, cfg, h)
    if mode == "prefill":
        return logits, out_caches, aux
    return logits, aux


def train_loss(params, cfg: ModelConfig, batch, z_loss_coef: float = 1e-4, *,
               count: torch.Tensor | None = None):
    """batch: {"tokens": [B,S] or "embeds": [B,S,F], "labels": [B,S],
    optional "memory": [B,M,F]} → (loss, metrics).  Labels
    below 0 are masked out; the loss is the masked mean cross-entropy plus
    ``z_loss_coef`` times the mean squared log-partition plus
    ``cfg.router_aux_coef`` times the MoE blocks' load-balancing loss.

    ``count`` is the number of unmasked labels the means divide by (default:
    this batch's own).  A data-parallel rank passes its global microbatch's,
    so that the ranks' losses and gradients sum to the whole microbatch's."""
    inputs = batch.get("embeds", batch.get("tokens"))
    logits, aux = forward(params, cfg, inputs, memory=batch.get("memory"), mode="train")
    labels = batch["labels"].long()
    logits = logits.to(torch.float32)
    # over vocab-sharded logits on a model shard: never gathered whole
    lse, gold = tp_lib.lse_and_gold(logits, labels, cfg.vocab)
    mask = (labels >= 0).to(torch.float32)
    denom = torch.clamp(mask.sum() if count is None else count, min=1.0)
    ce = ((lse - gold) * mask).sum() / denom
    zl = (torch.square(lse) * mask).sum() / denom
    loss = ce + z_loss_coef * zl + cfg.router_aux_coef * aux
    return loss, {"ce": ce, "z_loss": zl, "router_aux": aux}


def prefill(params, cfg: ModelConfig, tokens, *, memory=None):
    """Returns (last-token logits, caches) — cache seeding for serving.
    On a model shard (as every entry point here) the logits are this
    rank's vocabulary slice and the caches its heads or channels;
    ``tensor_parallel.join_vocab`` joins the rows a caller samples from."""
    logits, caches, _ = forward(params, cfg, tokens, memory=memory, mode="prefill")
    return logits[:, -1], caches


def prefill_chunk(params, cfg: ModelConfig, tokens, caches, pos, *, memory=None):
    """Resumable prefill: one chunk of the prompt scan, applied against
    existing decode-layout ``caches`` from absolute position ``pos``.
    Chaining chunks from a fresh ``init_cache`` reproduces one-shot
    :func:`prefill`.  Returns (last-token logits [B, V], updated caches)."""
    x = _embed_in(params, cfg, tokens)
    h, _, out_caches = _apply_groups(params, cfg, x, memory=memory, caches=caches, pos=pos,
                                     mode="chunk")
    logits = _head(params, cfg, h)
    return logits[:, -1], out_caches


def decode_step(params, cfg: ModelConfig, tokens, caches, pos, *, memory=None):
    """One serving step: tokens [B,1] at position(s) ``pos``: f(x[k], u[k])
    of the serving state-space system."""
    x = _embed_in(params, cfg, tokens)
    h, _, out_caches = _apply_groups(params, cfg, x, memory=memory, caches=caches, pos=pos,
                                     mode="decode")
    logits = _head(params, cfg, h)
    return logits[:, -1], out_caches
