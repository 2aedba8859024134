"""Block assembly: layer stacks as groups of blocks; the port's counterpart of
``repro/models/transformer.py``.

The recurrent and ``mamba1`` block kinds are ported so far.  A group is one
period of ``ModelConfig.layer_pattern``; per-group parameters and decode
caches are stacked on a leading ``G`` axis, exactly as the reference lays
them out for its scan over groups.  Every other block kind raises.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.recurrent import block as rnn_lib

from . import ssm as ssm_lib
from .config import ModelConfig
from .layers import rmsnorm, rmsnorm_params

PyTree = Any


def _unported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"block kind '{kind}' is not ported to repro_torch yet (ROADMAP.md "
        "Queue 1); only 'recurrent' and 'mamba1' run")


# ---------------------------------------------------------------------------
# per-block parameter construction
# ---------------------------------------------------------------------------

def _block_params(gen: torch.Generator, cfg: ModelConfig, kind: str) -> PyTree:
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

def _block_cache(cfg: ModelConfig, kind: str, batch: int, device) -> PyTree:
    if kind == "recurrent":
        return rnn_lib.recurrent_init_state(cfg, batch, device)
    if kind == "mamba1":
        return ssm_lib.mamba1_init_state(cfg, batch, device)
    raise _unported(kind)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device) -> PyTree:  # noqa: ARG001 — max_seq sizes the attention caches of the unported kinds
    """Decode cache ``{"groups": {name: leaves stacked over G}}`` — the
    serving state vector.  A recurrent block's leaves are ``h``/``c``
    ``[G, batch, H]``, a ``mamba1`` block's ``h [G, batch, DI, N]`` and
    ``conv [G, batch, k-1, DI]``, all in fp32."""
    if cfg.tail_pattern:
        raise _unported(f"tail {cfg.tail_pattern}")
    G = cfg.n_groups
    groups = {}
    for i, kind in enumerate(cfg.layer_pattern):
        one = _block_cache(cfg, kind, batch, device)
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
    pos=None,  # noqa: ARG001 — recurrent and SSM blocks carry no positions; attention kinds will
    mode: str = "train",
):
    """One block, all modes.  Returns (x, new_cache, aux_loss).

    mode="chunk" is the resumable prefill step: a chunk of S ≥ 1 tokens
    resumes the scan from the carried state; chaining chunks reproduces the
    one-shot prefill trajectory.
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
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
