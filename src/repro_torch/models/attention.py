"""Grouped-query attention: the port's counterpart of the GQA half of
``repro/models/attention.py``.

Every variant offers a *prefill* path (full sequence) and a *decode* path
(S ≥ 1 query tokens against a cache): the serving state-space view, in
which the KV cache is the **state vector**, decode is the state update f and
the logits head is the output map g.

Plain PyTorch by default; ``cfg.use_pallas`` routes the one-shot prefill's
attention core to ``kernels/flash_attention`` (the hand-written CUDA kernel
for CUDA tensors, its plain version on the CPU).  Decode and chunked prefill
attend over the cache in plain PyTorch, as the reference computes them
outside any Pallas kernel.  MLA (DeepSeek) and cross-attention
(llama-vision) are not ported: their entry points raise
``NotImplementedError`` naming ROADMAP.md.
"""

from __future__ import annotations

from typing import Any, TYPE_CHECKING

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops

from .layers import apply_rope, dense_init, rmsnorm, rmsnorm_params

if TYPE_CHECKING:
    from .config import ModelConfig

PyTree = Any

NEG_INF = -2.0 ** 30  # large-but-finite: keeps softmax NaN-free on fully-masked rows


def _unported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md Queue 1, item {item})")


# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------

def gqa_params(gen: torch.Generator, cfg: ModelConfig, lora_rank: int = 0) -> PyTree:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.p_dtype
    p = {
        "wq": dense_init(gen, (D, H * hd), dt),
        "wk": dense_init(gen, (D, KV * hd), dt),
        "wv": dense_init(gen, (D, KV * hd), dt),
        "wo": dense_init(gen, (H * hd, D), dt),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_params(hd, dt, gen.device)
        p["k_norm"] = rmsnorm_params(hd, dt, gen.device)
    if lora_rank:  # zamba2-style per-application LoRA deltas on q/k/v
        zeros = lambda n: torch.zeros((lora_rank, n), dtype=dt, device=gen.device)
        p["lora"] = {
            "qA": dense_init(gen, (D, lora_rank), dt), "qB": zeros(H * hd),
            "kA": dense_init(gen, (D, lora_rank), dt), "kB": zeros(KV * hd),
            "vA": dense_init(gen, (D, lora_rank), dt), "vB": zeros(KV * hd),
        }
    return p


def mla_params(gen, cfg):  # noqa: ARG001 — the reference's signature
    raise _unported("MLA attention (deepseek-v2-lite-16b)", 10)


def mla_prefill(p, cfg, x, positions=None):  # noqa: ARG001 — the reference's signature
    raise _unported("MLA attention (deepseek-v2-lite-16b)", 10)


def mla_decode(p, cfg, x, cache, pos):  # noqa: ARG001 — the reference's signature
    raise _unported("MLA attention (deepseek-v2-lite-16b)", 10)


def cross_attn_params(gen, cfg):  # noqa: ARG001 — the reference's signature
    raise _unported("cross-attention (llama-3.2-vision-90b)", 13)


def cross_attn(p, cfg, x, memory):  # noqa: ARG001 — the reference's signature
    raise _unported("cross-attention (llama-3.2-vision-90b)", 13)


# ---------------------------------------------------------------------------
# attention core (shared): grouped-query scaled dot-product w/ masking
# ---------------------------------------------------------------------------

def _sdpa(q, k, v, mask, softcap: float = 0.0):
    """q: [B,S,H,hd], k/v: [B,T,KV,hd(v)], mask: broadcastable [B,1,S,T] bool.
    GQA via head grouping — no KV repetition is materialized.  fp32 math,
    the result in q's dtype."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    scores = scores * hd ** -0.5
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    scores = torch.where(mask[:, :, None] if mask.ndim == 4 else mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, H, v.shape[-1]).to(q.dtype)


def causal_mask(S: int, T: int, offset: int = 0, window: int = 0, causal: bool = True,
                device=None) -> torch.Tensor:
    """[1, 1, S, T] boolean mask.  ``offset`` = absolute position of query 0.
    ``window``>0 restricts to a trailing sliding window."""
    qpos = torch.arange(S, device=device)[:, None] + offset
    kpos = torch.arange(T, device=device)[None, :]
    m = kpos <= qpos if causal else torch.ones((S, T), dtype=torch.bool, device=device)
    if window > 0:
        m = m & (kpos > qpos - window)
    return m[None, None]


# ---------------------------------------------------------------------------
# GQA forward: prefill + decode
# ---------------------------------------------------------------------------

def _project_qkv(p, cfg: ModelConfig, x):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "lora" in p:
        lo = p["lora"]
        q = q + (x @ lo["qA"]) @ lo["qB"]
        k = k + (x @ lo["kA"]) @ lo["kB"]
        v = v + (x @ lo["vA"]) @ lo["vB"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return q, k, v


def gqa_prefill(p, cfg: ModelConfig, x, *, window: int = 0, positions=None):
    """Full-sequence attention.  Returns (out, (k, v)) for cache seeding."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta, cfg.partial_rotary)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.partial_rotary)
    if cfg.use_pallas:
        out = fa_ops.flash_attention(q, k, v, causal=cfg.causal, window=window,
                                     softcap=cfg.attn_logit_softcap)
    else:
        mask = causal_mask(S, S, window=window, causal=cfg.causal, device=x.device)
        out = _sdpa(q, k, v, mask, cfg.attn_logit_softcap)
    return out.reshape(B, S, -1) @ p["wo"], (k, v)


def _posv(pos, B: int, device) -> torch.Tensor:
    """Normalize decode position to a per-sequence [B] vector."""
    return torch.as_tensor(pos, device=device).long().expand(B)


def gqa_decode(p, cfg: ModelConfig, x, cache: PyTree, pos, *, window: int = 0):
    """Cache-resident step for S ≥ 1 query tokens starting at ``pos``.

    cache = {"k": [B, S_max, KV, hd], "v": ...}; ``pos``: scalar or [B]
    (per-sequence positions for continuous batching).  S == 1 is the classic
    decode tick; S > 1 is a *chunked-prefill* continuation — the same state
    update applied to a block of inputs, causal within the chunk.  The new
    keys and values are scattered into a copy of the cache, which is
    returned; the caller's cache is not written.
    """
    B, S, _ = x.shape
    dev = x.device
    q, k, v = _project_qkv(p, cfg, x)
    posv = _posv(pos, B, dev)
    qpos = posv[:, None] + torch.arange(S, device=dev)[None, :]          # [B, S] absolute
    q = apply_rope(q, qpos, cfg.rope_theta, cfg.partial_rotary)
    k = apply_rope(k, qpos, cfg.rope_theta, cfg.partial_rotary)
    bidx = torch.arange(B, device=dev)[:, None].expand(B, S)
    ck = cache["k"].index_put((bidx, qpos), k.to(cache["k"].dtype))
    cv = cache["v"].index_put((bidx, qpos), v.to(cache["v"].dtype))
    T = ck.shape[1]
    kpos = torch.arange(T, device=dev)[None, None, None, :]
    mask = kpos <= qpos[:, None, :, None]
    if window > 0:
        mask = mask & (kpos > (qpos - window)[:, None, :, None])
    out = _sdpa(q, ck, cv, mask, cfg.attn_logit_softcap)
    return out.reshape(B, S, -1) @ p["wo"], {"k": ck, "v": cv}


__all__ = [
    "NEG_INF",
    "causal_mask",
    "cross_attn",
    "cross_attn_params",
    "gqa_decode",
    "gqa_params",
    "gqa_prefill",
    "mla_decode",
    "mla_params",
    "mla_prefill",
]
