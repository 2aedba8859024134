"""Shared neural layers: the port's copy of the parts of
``repro/models/layers.py`` that the recurrent language model uses.

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


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embedding_params(gen: torch.Generator, vocab: int, d_model: int, dtype) -> PyTree:
    return {"table": embed_init(gen, (vocab, d_model), dtype)}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


__all__ = [
    "dense_init",
    "embed",
    "embed_init",
    "embedding_params",
    "rmsnorm",
    "rmsnorm_params",
]
