"""Plain PyTorch version of blocked attention (causal / local window / GQA /
softcap); the port's copy of ``repro/kernels/flash_attention/ref.py``.

Contract (matches the kernel and ``ops``):
    out = flash_attention(q, k, v, causal, window, softcap)
      q    : [B, S, H, hd]
      k, v : [B, T, KV, hd]      H a multiple of KV; head h reads kv head h // (H/KV)
      out  : [B, S, H, hd]       in q's dtype, computed in fp32
    scores = (q · k) · hd^-0.5, then softcap · tanh(scores / softcap) when
    softcap > 0; query i and key j (both counted from 0, top-left aligned when
    S != T) are masked by ``j <= i`` (causal) and ``j > i - window``
    (window > 0).  A masked score is the finite NEG_INF = -2^30, so a row
    with no visible key averages v uniformly instead of giving NaN.
"""

from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0):
    """GQA by grouping q as ``[B, S, KV, G, hd]``: k and v are never repeated."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * hd ** -0.5
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


__all__ = ["NEG_INF", "flash_attention_ref"]
