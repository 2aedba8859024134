"""Block assembly: layer stacks as groups of blocks; the port's counterpart of
``repro/models/transformer.py``.

The recurrent, ``mamba1`` and ``attn`` (dense transformer: GQA + gated MLP)
block kinds are ported so far.  A group is one period of
``ModelConfig.layer_pattern``; per-group parameters and decode caches are
stacked on a leading ``G`` axis, exactly as the reference lays them out for
its scan over groups.  Every other block kind (``attn_local``, ``moe``,
``cross``, ``mamba2``, ``shared_attn``) raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.recurrent import block as rnn_lib

from . import attention as attn_lib
from . import ssm as ssm_lib
from .config import ModelConfig
from .layers import mlp_apply, mlp_params, rmsnorm, rmsnorm_params

PyTree = Any


def _unported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"block kind '{kind}' is not ported to repro_torch yet (ROADMAP.md "
        "Queue 1); only 'recurrent', 'mamba1' and 'attn' run")


# ---------------------------------------------------------------------------
# per-block parameter construction
# ---------------------------------------------------------------------------

def _block_params(gen: torch.Generator, cfg: ModelConfig, kind: str) -> PyTree:
    if kind == "attn":
        ap = attn_lib.mla_params(gen, cfg) if cfg.use_mla else attn_lib.gqa_params(gen, cfg)
        return {
            "ln_attn": rmsnorm_params(cfg.d_model, cfg.p_dtype, gen.device),
            "attn": ap,
            "ln_mlp": rmsnorm_params(cfg.d_model, cfg.p_dtype, gen.device),
            "mlp": mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, cfg.p_dtype),
        }
    if kind == "recurrent":
        return {"ln": rmsnorm_params(cfg.d_model, cfg.p_dtype, gen.device),
                "rnn": rnn_lib.recurrent_params(gen, cfg)}
    if kind == "mamba1":
        return {"ln": rmsnorm_params(cfg.d_model, cfg.p_dtype, gen.device),
                "mamba": ssm_lib.mamba1_params(gen, cfg)}
    raise _unported(kind)


def group_params(gen: torch.Generator, cfg: ModelConfig) -> PyTree:
    return {f"b{i}_{kind}": _block_params(gen, cfg, kind)
            for i, kind in enumerate(cfg.layer_pattern)}


# ---------------------------------------------------------------------------
# cache construction (decode state)
# ---------------------------------------------------------------------------

def _block_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int, device) -> PyTree:
    if kind == "attn":
        if cfg.use_mla:
            raise _unported("attn (MLA)")
        shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=cfg.act_dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.act_dtype, device=device)}
    if kind == "recurrent":
        return rnn_lib.recurrent_init_state(cfg, batch, device)
    if kind == "mamba1":
        return ssm_lib.mamba1_init_state(cfg, batch, device)
    raise _unported(kind)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device) -> PyTree:
    """Decode cache ``{"groups": {name: leaves stacked over G}}`` — the
    serving state vector.  A recurrent block's leaves are ``h``/``c``
    ``[G, batch, H]``, a ``mamba1`` block's ``h [G, batch, DI, N]`` and
    ``conv [G, batch, k-1, DI]``, all in fp32; an ``attn`` block's are the
    full-length ``k``/``v`` ``[G, batch, max_seq, KV, hd]`` in the
    activation dtype."""
    if cfg.tail_pattern:
        raise _unported(f"tail {cfg.tail_pattern}")
    G = cfg.n_groups
    groups = {}
    for i, kind in enumerate(cfg.layer_pattern):
        one = _block_cache(cfg, kind, batch, max_seq, device)
        groups[f"b{i}_{kind}"] = {k: v.expand((G,) + v.shape).clone()
                                  for k, v in one.items()}
    return {"groups": groups}


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def apply_block(
    p_blk: PyTree,
    cfg: ModelConfig,
    kind: str,
    x: torch.Tensor,
    *,
    cache=None,
    pos=None,
    mode: str = "train",
):
    """One block, all modes.  Returns (x, new_cache, aux_loss).

    mode="chunk" is the resumable prefill step: S ≥ 1 tokens applied against
    an existing cache at offset ``pos`` — the same state-update map as
    decode, batched over a chunk of inputs (attention writes the chunk into
    the cache and masks causally; SSM and recurrent blocks resume their
    scan from the carried state).  Chaining chunks reproduces the one-shot
    prefill trajectory.
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "attn":
        acfg = cfg
        if cfg.global_every and cfg.rope_theta_global:
            acfg = dataclasses.replace(cfg, rope_theta=cfg.rope_theta_global)
        h = rmsnorm(p_blk["ln_attn"], x, cfg.norm_eps)
        decode = mode in ("decode", "chunk")
        if cfg.use_mla:
            a, cache = (attn_lib.mla_decode(p_blk["attn"], acfg, h, cache, pos) if decode
                        else attn_lib.mla_prefill(p_blk["attn"], acfg, h))
        elif decode:
            a, cache = attn_lib.gqa_decode(p_blk["attn"], acfg, h, cache, pos)
        else:
            a, kv = attn_lib.gqa_prefill(p_blk["attn"], acfg, h)
            cache = {"k": kv[0], "v": kv[1]} if mode == "prefill" else None
        x = x + a
        h = rmsnorm(p_blk["ln_mlp"], x, cfg.norm_eps)
        return x + mlp_apply(p_blk["mlp"], h, cfg.mlp_act), cache, aux
    if kind == "mamba1":
        # the serving state is the selective scan's {"h", "conv"}
        h = rmsnorm(p_blk["ln"], x, cfg.norm_eps)
        if mode == "chunk":
            y, cache = ssm_lib.mamba1_prefill(p_blk["mamba"], cfg, h, state=cache)
        elif mode == "decode":
            y, cache = ssm_lib.mamba1_decode(p_blk["mamba"], cfg, h, cache)
        else:
            y, st = ssm_lib.mamba1_prefill(p_blk["mamba"], cfg, h)
            cache = st if mode == "prefill" else None
        return x + y, cache, aux
    if kind != "recurrent":
        raise _unported(kind)
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


__all__ = ["apply_block", "group_params", "init_cache"]
