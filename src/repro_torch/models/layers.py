"""Shared neural layers: the port's copy of ``repro/models/layers.py``
(norms, RoPE, the gated MLP, embeddings and the logits head).

Parameters are plain nested dicts of tensors with the reference's layout.
Every random draw takes an explicit ``torch.Generator`` and lands on that
generator's device; shapes and scales match the reference's initialisers
(the numbers themselves differ: weights cross over from the reference as
arrays, see ``repro_torch.bridge``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.state_space import resolve_activation
from repro_torch.parallel import tensor_parallel as tp_lib

PyTree = Any


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype, scale_axis: int = 0) -> torch.Tensor:
    fan_in = shape[scale_axis]
    w = torch.randn(tuple(shape), generator=gen, device=gen.device) / np.sqrt(fan_in)
    return w.to(dtype)


def embed_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return (torch.randn(tuple(shape), generator=gen, device=gen.device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_params(dim: int, dtype, device) -> PyTree:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in fp32, returned in x's dtype."""
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


def layernorm_params(dim: int, dtype, device) -> PyTree:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm (biased variance) computed in fp32, returned in x's dtype."""
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE (with partial-rotary + position offsets for decode)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, partial: float = 1.0, device=None) -> torch.Tensor:
    """``1 / theta^(2i / rot)`` for the ``rot = int(head_dim·partial)``
    (rounded down to even) rotated channels, fp32.  The power is taken in
    fp64 and rounded once to fp32, the correctly rounded value that the
    reference's fp32 ``pow`` gives on the CPU; an ulp off here would grow
    with the position in every angle."""
    rot = int(head_dim * partial)
    rot -= rot % 2
    expo = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    power = torch.pow(torch.tensor(theta, dtype=torch.float64, device=device),
                      expo.double()).float()
    return 1.0 / power


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               partial: float = 1.0) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: [..., S] (int).  Rotates the
    interleaved pairs ``(x[2i], x[2i+1])`` of the first ``partial·hd``
    channels by ``positions·freqs[i]`` (fp32 angles) and passes the rest
    through (phi4-style)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, partial, x.device)            # [rot/2]
    rot = freqs.shape[0] * 2
    angles = positions[..., :, None].float() * freqs            # [..., S, rot/2]
    cos = torch.cos(angles)[..., :, None, :]                    # [..., S, 1, rot/2]
    sin = torch.sin(angles)[..., :, None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., ::2], x_rot[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    y = torch.stack([y1, y2], dim=-1).reshape(x_rot.shape)
    return torch.cat([y.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# MLP (gated SwiGLU/GeGLU or plain)
# ---------------------------------------------------------------------------

def mlp_params(gen: torch.Generator, d_model: int, d_ff: int, gated: bool, dtype) -> PyTree:
    p = {"w_in": dense_init(gen, (d_model, d_ff), dtype),
         "w_out": dense_init(gen, (d_ff, d_model), dtype)}
    if gated:
        p["w_gate"] = dense_init(gen, (d_model, d_ff), dtype)
    return p


def mlp_apply(params, x: torch.Tensor, act: str = "silu", *, split: bool = False) -> torch.Tensor:
    """``act(x @ w_gate) * (x @ w_in) @ w_out`` when gated, else
    ``act(x @ w_in) @ w_out``; ``act`` from the port's activation table.

    ``split``: the hidden columns are this rank's share over ``model``
    (column-parallel ``w_in``/``w_gate``, row-parallel ``w_out``), and the
    output is summed over the model ranks.  A ``w_out`` whose output dim
    is this rank's share (a tail block on a model shard) takes the whole
    hidden and its output columns are joined over ``model``."""
    fn = resolve_activation(act)
    if split:
        x = tp_lib.copy_to_model(x)
    h = x @ params["w_in"]
    h = fn(x @ params["w_gate"]) * h if "w_gate" in params else fn(h)
    w_out = params["w_out"]
    if w_out.shape[-1] != x.shape[-1]:
        return tp_lib.gather_from_model(tp_lib.copy_to_model(h) @ w_out)
    y = h @ w_out
    return tp_lib.reduce_from_model(y) if split else y


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------

def embedding_params(gen: torch.Generator, vocab: int, d_model: int, dtype) -> PyTree:
    return {"table": embed_init(gen, (vocab, d_model), dtype)}


def embed(params, tokens: torch.Tensor, vocab: int | None = None) -> torch.Tensor:
    """``table[tokens]``; given the full ``vocab``, a table of this rank's
    vocabulary rows looks up over ``model`` (``tensor_parallel.embed_lookup``)."""
    if vocab is None:
        return params["table"][tokens]
    return tp_lib.embed_lookup(params["table"], tokens, vocab)


def unembed(params, x: torch.Tensor, table: torch.Tensor | None = None) -> torch.Tensor:
    """Logits head ``x @ params["w"]``; pass ``table`` for tied embeddings
    (``x @ table.T``)."""
    return x @ table.T if table is not None else x @ params["w"]


__all__ = [
    "apply_rope",
    "dense_init",
    "embed",
    "embed_init",
    "embedding_params",
    "layernorm",
    "layernorm_params",
    "mlp_apply",
    "mlp_params",
    "rmsnorm",
    "rmsnorm_params",
    "rope_freqs",
    "unembed",
]
