"""Block assembly: layer stacks as groups of blocks; the port's counterpart of
``repro/models/transformer.py``.

Every kind of the reference runs: recurrent, ``mamba1``, ``mamba2``,
``attn`` (dense transformer: GQA + MLP), ``attn_local`` (gemma3's
sliding-window attention), ``shared_attn`` (zamba2's shared transformer
block), ``moe`` (attention + the MoE FFN of olmoe and deepseek), with GQA or
MLA attention (``cfg.use_mla``), and ``cross`` (llama-vision's gated
cross-attention to a ``memory`` + MLP).  A group is one period
of ``ModelConfig.layer_pattern``; per-group parameters and decode caches
are stacked on a leading ``G`` axis, exactly as the reference lays them out
for its scan over groups.  Blocks of ``ModelConfig.tail_pattern`` (gemma3's
two trailing local layers, zamba2's two trailing Mamba-2 blocks) follow the
groups, each with its own parameters and cache and **no** ``G`` axis.

Zamba2's shared transformer block is the paper's layer-wise resource
sharing taken literally: ONE set of attention and MLP weights
(:func:`shared_block_params`, the model's ``"shared"`` subtree) is applied
at every ``shared_attn`` position, and each application adds its own LoRA
deltas on q/k/v and its own norms (the ``shared_attn`` block's
parameters).  Every block is handed the ``shared`` subtree.

A local layer's decode cache is a ring buffer of ``min(max_seq,
sliding_window)`` positions: position ``p`` lives at slot ``p mod W``.  A
``shared_attn`` block's is a full-length K/V cache, never a ring.  Under
MLA an ``attn`` or ``moe`` block caches the latent ``c_kv [B, S, r]`` and
the shared rope key ``k_rope [B, S, dr]`` instead of K/V.  A ``cross`` block's cache is a
dummy ``(1,)`` fp32 leaf: the memory is an input of every call, not state.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch._tree import tree_map
from repro_torch.parallel import tensor_parallel as tp_lib
from repro_torch.parallel.sharding import current_model_shard
from repro_torch.recurrent import block as rnn_lib

from . import attention as attn_lib
from . import moe as moe_lib
from . import ssm as ssm_lib
from .config import ModelConfig
from .layers import apply_rope, mlp_apply, mlp_params, rmsnorm, rmsnorm_params

PyTree = Any


# ---------------------------------------------------------------------------
# per-block parameter construction
# ---------------------------------------------------------------------------

def _block_params(gen: torch.Generator, cfg: ModelConfig, kind: str) -> PyTree:
    if kind in ("attn", "attn_local"):
        ap = attn_lib.mla_params(gen, cfg) if cfg.use_mla else attn_lib.gqa_params(gen, cfg)
        return {
            "ln_attn": rmsnorm_params(cfg.d_model, cfg.p_dtype, gen.device),
            "attn": ap,
            "ln_mlp": rmsnorm_params(cfg.d_model, cfg.p_dtype, gen.device),
            "mlp": mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, cfg.p_dtype),
        }
    if kind == "moe":
        ap = attn_lib.mla_params(gen, cfg) if cfg.use_mla else attn_lib.gqa_params(gen, cfg)
        return {
            "ln_attn": rmsnorm_params(cfg.d_model, cfg.p_dtype, gen.device),
            "attn": ap,
            "ln_mlp": rmsnorm_params(cfg.d_model, cfg.p_dtype, gen.device),
            "moe": moe_lib.moe_params(gen, cfg),
        }
    if kind == "cross":
        return {
            "ln_attn": rmsnorm_params(cfg.d_model, cfg.p_dtype, gen.device),
            "cross": attn_lib.cross_attn_params(gen, cfg),
            "ln_mlp": rmsnorm_params(cfg.d_model, cfg.p_dtype, gen.device),
            "mlp": mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, cfg.p_dtype),
        }
    if kind == "recurrent":
        return {"ln": rmsnorm_params(cfg.d_model, cfg.p_dtype, gen.device),
                "rnn": rnn_lib.recurrent_params(gen, cfg)}
    if kind == "mamba1":
        return {"ln": rmsnorm_params(cfg.d_model, cfg.p_dtype, gen.device),
                "mamba": ssm_lib.mamba1_params(gen, cfg)}
    if kind == "mamba2":
        return {"ln": rmsnorm_params(cfg.d_model, cfg.p_dtype, gen.device),
                "mamba": ssm_lib.mamba2_params(gen, cfg)}
    if kind == "shared_attn":
        # only the per-application pieces live here; the weights are shared
        return {
            "ln_attn": rmsnorm_params(cfg.d_model, cfg.p_dtype, gen.device),
            "lora": attn_lib.gqa_params(gen, cfg, lora_rank=cfg.shared_attn_lora_rank)["lora"],
            "ln_mlp": rmsnorm_params(cfg.d_model, cfg.p_dtype, gen.device),
        }
    raise ValueError(kind)


def group_params(gen: torch.Generator, cfg: ModelConfig) -> PyTree:
    return {f"b{i}_{kind}": _block_params(gen, cfg, kind)
            for i, kind in enumerate(cfg.layer_pattern)}


def shared_block_params(gen: torch.Generator, cfg: ModelConfig) -> PyTree | None:
    """Zamba2's single shared transformer block (attention + MLP); None
    without a ``shared_attn`` block in the pattern."""
    if "shared_attn" not in cfg.layer_pattern:
        return None
    return {"attn": attn_lib.gqa_params(gen, cfg),
            "mlp": mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, cfg.p_dtype)}


def tail_params(gen: torch.Generator, cfg: ModelConfig) -> PyTree | None:
    """The blocks of ``cfg.tail_pattern`` (``t{i}_{kind}``), unstacked; None
    without a tail."""
    if not cfg.tail_pattern:
        return None
    return {f"t{i}_{kind}": _block_params(gen, cfg, kind)
            for i, kind in enumerate(cfg.tail_pattern)}


# ---------------------------------------------------------------------------
# cache construction (decode state)
# ---------------------------------------------------------------------------

def _kv_heads(cfg: ModelConfig) -> int:
    """The KV heads a cache holds: this rank's ``KV/tp`` where attention
    computes on a model shard and ``model`` divides them (``cache_specs``
    cuts them so), else all (its guard keeps 8 KV heads whole over 16
    ranks: every rank's cache holds them, written from the joined K/V)."""
    return tp_lib.local(cfg.n_kv_heads) if tp_lib.attn_splits(cfg) else cfg.n_kv_heads


def _block_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int, device) -> PyTree:
    if kind in ("attn", "moe", "shared_attn"):
        if cfg.use_mla and kind != "shared_attn":
            # the latent: whole on a model shard too (cache_specs cuts no head of it)
            return {"c_kv": torch.zeros((batch, max_seq, cfg.kv_lora_rank),
                                        dtype=cfg.act_dtype, device=device),
                    "k_rope": torch.zeros((batch, max_seq, cfg.qk_rope_head_dim),
                                          dtype=cfg.act_dtype, device=device)}
        shape = (batch, max_seq, _kv_heads(cfg), cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=cfg.act_dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.act_dtype, device=device)}
    if kind == "attn_local":
        shape = (batch, min(max_seq, cfg.sliding_window), _kv_heads(cfg), cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=cfg.act_dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.act_dtype, device=device)}
    if kind == "recurrent":
        return rnn_lib.recurrent_init_state(cfg, batch, device)
    if kind == "mamba1":
        return ssm_lib.mamba1_init_state(cfg, batch, device)
    if kind == "mamba2":
        return ssm_lib.mamba2_init_state(cfg, batch, device)
    if kind == "cross":
        # the memory is static: a dummy state
        return torch.zeros((1,), dtype=torch.float32, device=device)
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device) -> PyTree:
    """Decode cache ``{"groups": {name: leaves stacked over G}, "tail":
    {name: leaves}}`` — the serving state vector (``"tail"`` only with a
    ``tail_pattern``).  A recurrent block's leaves are ``h``/``c``
    ``[G, batch, H]``, a ``mamba1`` block's ``h [G, batch, DI, N]`` and
    ``conv [G, batch, k-1, DI]``, a ``mamba2`` block's ``h [G, batch, H,
    P, N]`` and ``conv: {x [G, batch, k-1, DI], bc [G, batch, k-1, 2N]}``,
    all in fp32; an ``attn``, ``moe`` or ``shared_attn`` block's are the full-length
    ``k``/``v`` ``[G, batch, max_seq, KV, hd]`` (under MLA an ``attn`` or
    ``moe`` block's are the latent ``c_kv [G, batch, max_seq, r]`` and
    ``k_rope [G, batch, max_seq, dr]``) and an ``attn_local`` block's the
    ring ``[G, batch, min(max_seq, window), KV, hd]``, in the activation
    dtype; a ``cross`` block's is the dummy ``[G, 1]`` fp32.  Tail leaves are the same without the
    ``G`` axis: the slot is their axis 0, the sequence their axis 1."""
    G = cfg.n_groups
    groups = {}
    for i, kind in enumerate(cfg.layer_pattern):
        one = _block_cache(cfg, kind, batch, max_seq, device)
        groups[f"b{i}_{kind}"] = tree_map(lambda v: v.expand((G,) + v.shape).clone(), one)
    cache = {"groups": groups}
    if cfg.tail_pattern:
        cache["tail"] = {f"t{i}_{kind}": _block_cache(cfg, kind, batch, max_seq, device)
                         for i, kind in enumerate(cfg.tail_pattern)}
    return cache


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

# the block kinds that compute on a model shard (sharding.computes_on_model_shard)
TP_KINDS = ("attn", "attn_local", "moe", "mamba1", "cross")


def apply_block(
    p_blk: PyTree,
    shared: PyTree | None,
    cfg: ModelConfig,
    kind: str,
    x: torch.Tensor,
    *,
    memory=None,
    cache=None,
    pos=None,
    mode: str = "train",
):
    """One block, all modes.  Returns (x, new_cache, aux_loss).  ``shared``
    is the model's ``"shared"`` subtree (None without one), which only a
    ``shared_attn`` block reads; ``memory`` [B, M, frontend_dim] is what a
    ``cross`` block attends to, in every mode (it returns the cache it was
    given, None in prefill and train).

    mode="chunk" is the resumable prefill step: S ≥ 1 tokens applied against
    an existing cache at offset ``pos`` — the same state-update map as
    decode, batched over a chunk of inputs (attention writes the chunk into
    the cache and masks causally; SSM and recurrent blocks resume their
    scan from the carried state).  Chaining chunks reproduces the one-shot
    prefill trajectory.
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if current_model_shard() is not None and kind not in TP_KINDS:
        raise NotImplementedError(
            f"apply_block: a {kind} block does not compute on a model shard yet "
            "(ROADMAP.md, Queue 1 item 12c(c))")
    if kind in ("attn", "attn_local", "moe"):
        window = cfg.sliding_window if kind == "attn_local" else 0
        acfg = cfg
        if kind == "attn" and cfg.global_every and cfg.rope_theta_global:
            acfg = dataclasses.replace(cfg, rope_theta=cfg.rope_theta_global)
        h = rmsnorm(p_blk["ln_attn"], x, cfg.norm_eps)
        # attention on this rank's part (GQA or MLA): its heads, or the
        # query heads covering its wo rows where heads do not cut whole;
        # the block's input whole on every model rank, wo row-parallel, the
        # output summed before the residual (a tail block's wo keeps its
        # rows: attn_out joins its output)
        head_out = cfg.v_head_dim if cfg.use_mla else cfg.head_dim
        split = tp_lib.attn_splits(cfg) and p_blk["attn"]["wo"].shape[0] < cfg.n_heads * head_out
        if split:
            h = tp_lib.copy_to_model(h)
        decode = mode in ("decode", "chunk")
        if cfg.use_mla and decode:
            a, cache = attn_lib.mla_decode(p_blk["attn"], acfg, h, cache, pos)
        elif cfg.use_mla:
            a, kv = attn_lib.mla_prefill(p_blk["attn"], acfg, h)
            cache = {"c_kv": kv[0], "k_rope": kv[1]} if mode == "prefill" else None
        elif decode and kind == "attn_local":
            local = _gqa_local_chunk if mode == "chunk" else _gqa_decode_local
            a, cache = local(p_blk["attn"], acfg, h, cache, pos)
        elif decode:
            a, cache = attn_lib.gqa_decode(p_blk["attn"], acfg, h, cache, pos)
        else:
            # a one-shot prefill returns the full-length k/v of every layer;
            # splice_cache folds a local layer's into its ring
            a, kv = attn_lib.gqa_prefill(p_blk["attn"], acfg, h, window=window)
            cache = {"k": kv[0], "v": kv[1]} if mode == "prefill" else None
        if split:
            a = tp_lib.reduce_from_model(a)
        x = x + a
        h = rmsnorm(p_blk["ln_mlp"], x, cfg.norm_eps)
        if kind == "moe":
            # the experts on this rank's block, summed over model inside
            y, aux = moe_lib.moe_apply(p_blk["moe"], cfg, h,
                                       group_size=cfg.moe_group_size or moe_lib.DEFAULT_GROUP_SIZE)
        else:
            y = mlp_apply(p_blk["mlp"], h, cfg.mlp_act,
                          split=p_blk["mlp"]["w_out"].shape[0] < cfg.d_ff)
        return x + y, cache, aux
    if kind == "cross":
        # on a model shard: a rank's heads (cross_attn sums its output over
        # model before the gate) and its FFN columns
        h = rmsnorm(p_blk["ln_attn"], x, cfg.norm_eps)
        x = x + attn_lib.cross_attn(p_blk["cross"], cfg, h, memory)
        h = rmsnorm(p_blk["ln_mlp"], x, cfg.norm_eps)
        return x + mlp_apply(p_blk["mlp"], h, cfg.mlp_act,
                             split=p_blk["mlp"]["w_out"].shape[0] < cfg.d_ff), cache, aux
    if kind == "shared_attn":
        # the shared weights with this application's LoRA deltas; a chunk
        # attends over the cache as decode does, only a one-shot prefill
        # reaches gqa_prefill (and flash_attention under use_pallas)
        ap = dict(shared["attn"]) | {"lora": p_blk["lora"]}
        h = rmsnorm(p_blk["ln_attn"], x, cfg.norm_eps)
        if mode in ("decode", "chunk"):
            a, cache = attn_lib.gqa_decode(ap, cfg, h, cache, pos)
        else:
            a, kv = attn_lib.gqa_prefill(ap, cfg, h)
            cache = {"k": kv[0], "v": kv[1]} if mode == "prefill" else None
        x = x + a
        h = rmsnorm(p_blk["ln_mlp"], x, cfg.norm_eps)
        return x + mlp_apply(shared["mlp"], h, cfg.mlp_act), cache, aux
    if kind in ("mamba1", "mamba2"):
        # the serving state is the scan's {"h", "conv"}
        prefill_fn = ssm_lib.mamba1_prefill if kind == "mamba1" else ssm_lib.mamba2_prefill
        decode_fn = ssm_lib.mamba1_decode if kind == "mamba1" else ssm_lib.mamba2_decode
        h = rmsnorm(p_blk["ln"], x, cfg.norm_eps)
        if mode == "chunk":
            y, cache = prefill_fn(p_blk["mamba"], cfg, h, state=cache)
        elif mode == "decode":
            y, cache = decode_fn(p_blk["mamba"], cfg, h, cache)
        else:
            y, st = prefill_fn(p_blk["mamba"], cfg, h)
            cache = st if mode == "prefill" else None
        return x + y, cache, aux
    if kind != "recurrent":
        raise ValueError(kind)
    # LSTM/GRU cell: the serving state IS the (h, c) carry (paper eq. 1)
    h = rmsnorm(p_blk["ln"], x, cfg.norm_eps)
    if mode == "chunk":
        y, cache = rnn_lib.recurrent_prefill(p_blk["rnn"], cfg, h, state=cache)
    elif mode == "decode":
        y, cache = rnn_lib.recurrent_decode(p_blk["rnn"], cfg, h, cache)
    else:
        y, st = rnn_lib.recurrent_prefill(p_blk["rnn"], cfg, h)
        cache = st if mode == "prefill" else None
    return x + y, cache, aux


# ---------------------------------------------------------------------------
# sliding-window attention against a ring-buffer cache
# ---------------------------------------------------------------------------

def _local_window_cache_update(cache, k, v, pos):
    """Ring-buffer write for sliding-window caches: the one new token of
    each row goes to slot ``pos mod W``.  Returns new tensors; the caller's
    cache is not written."""
    W = cache["k"].shape[1]
    B = k.shape[0]
    slot = torch.remainder(pos, W)
    bidx = torch.arange(B, device=k.device)
    ck = cache["k"].index_put((bidx, slot), k[:, 0].to(cache["k"].dtype))
    cv = cache["v"].index_put((bidx, slot), v[:, 0].to(cache["v"].dtype))
    return {"k": ck, "v": cv}


def _gqa_decode_local(p, cfg: ModelConfig, x, cache, pos):
    """Decode (S = 1) against a ring-buffer sliding-window cache.

    Slot s holds the position p with p ≡ s (mod W) and pos-W < p <= pos,
    so its absolute position is kpos = pos - ((pos - s) mod W); RoPE phases
    and the window mask use those absolute positions.
    """
    B, S, _ = x.shape
    dev = x.device
    q, k, v = attn_lib._project_qkv(p, cfg, x)
    posv = attn_lib._posv(pos, B, dev)
    q = apply_rope(q, posv[:, None], cfg.rope_theta, cfg.partial_rotary)
    k = apply_rope(k, posv[:, None], cfg.rope_theta, cfg.partial_rotary)
    cache = _local_window_cache_update(cache, k, v, posv)
    W = cache["k"].shape[1]
    slots = torch.arange(W, device=dev)[None, :]
    kpos = posv[:, None] - torch.remainder(posv[:, None] - slots, W)   # [B, W] absolute
    mask = (kpos >= 0) & (kpos >= posv[:, None] - W + 1) & (kpos <= posv[:, None])
    out = attn_lib._sdpa(q, *attn_lib._read_kv(p, cfg, cache["k"], cache["v"]),
                         mask[:, None, None, :], cfg.attn_logit_softcap)
    return attn_lib.attn_out(p, cfg, out), cache


def _gqa_local_chunk(p, cfg: ModelConfig, x, cache, pos):
    """Chunked-prefill step (S >= 1 tokens from ``pos``) against a
    ring-buffer sliding-window cache.

    Writing the chunk into the ring first could overwrite positions that
    earlier queries of the same chunk still need, so attention runs over
    [old ring ∥ chunk keys] with absolute-position masks, and only then are
    the chunk's last min(S, W) tokens committed to the ring (earlier chunk
    tokens are out of every later query's window).
    """
    B, S, _ = x.shape
    dev = x.device
    q, k, v = attn_lib._project_qkv(p, cfg, x)
    posv = attn_lib._posv(pos, B, dev)
    qpos = posv[:, None] + torch.arange(S, device=dev)[None, :]          # [B, S]
    q = apply_rope(q, qpos, cfg.rope_theta, cfg.partial_rotary)
    k = apply_rope(k, qpos, cfg.rope_theta, cfg.partial_rotary)

    W = cache["k"].shape[1]
    slots = torch.arange(W, device=dev)[None, :]
    # ring slot s holds the latest written position p ≡ s (mod W), p <= pos-1;
    # a negative p was never written (masked below)
    ring_pos = (posv[:, None] - 1) - torch.remainder(posv[:, None] - 1 - slots, W)
    kpos = torch.cat([ring_pos.expand(B, W), qpos], dim=1)               # [B, W+S]
    k_all = torch.cat([cache["k"].to(k.dtype), k], dim=1)
    v_all = torch.cat([cache["v"].to(v.dtype), v], dim=1)
    mask = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qpos[:, :, None]) \
        & (kpos[:, None, :] > qpos[:, :, None] - W)
    out = attn_lib._sdpa(q, *attn_lib._read_kv(p, cfg, k_all, v_all), mask[:, None],
                         cfg.attn_logit_softcap)

    # commit the trailing min(S, W) chunk tokens to the ring
    Wp = min(S, W)
    tail_slot = torch.remainder(qpos[:, S - Wp:], W)                     # [B, Wp]
    bidx = torch.arange(B, device=dev)[:, None].expand(B, Wp)
    ck = cache["k"].index_put((bidx, tail_slot), k[:, S - Wp:].to(cache["k"].dtype))
    cv = cache["v"].index_put((bidx, tail_slot), v[:, S - Wp:].to(cache["v"].dtype))
    return attn_lib.attn_out(p, cfg, out), {"k": ck, "v": cv}


__all__ = ["apply_block", "group_params", "init_cache", "shared_block_params", "tail_params"]
