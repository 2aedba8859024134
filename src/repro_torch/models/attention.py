"""Attention: grouped-query attention, MLA (DeepSeek) and cross-attention
(llama-vision); the port's counterpart of ``repro/models/attention.py``.

Every variant offers a *prefill* path (full sequence) and a *decode* path
(S ≥ 1 query tokens against a cache): the serving state-space view, in
which the KV cache is the **state vector**, decode is the state update f and
the logits head is the output map g (MLA's state is its low-rank latent).

Plain PyTorch by default; ``cfg.use_pallas`` routes the one-shot prefill's
attention core to ``kernels/flash_attention`` (the hand-written CUDA kernel
for CUDA tensors, its plain version on the CPU).  Decode and chunked prefill
attend over the cache in plain PyTorch, as the reference computes them
outside any Pallas kernel.  MLA has no kernel in either package: its naive
prefill and absorbed decode are plain einsums.  Cross-attention is plain
PyTorch in every mode, as the reference computes it outside any Pallas
kernel: its keys and values are projected from the memory on every call,
decode included (the memory is an input, not cached state).
"""

from __future__ import annotations

from typing import Any, TYPE_CHECKING

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.parallel import tensor_parallel as tp_lib
from repro_torch.parallel.sharding import current_model_shard

from .layers import apply_rope, dense_init, rmsnorm, rmsnorm_params

if TYPE_CHECKING:
    from .config import ModelConfig

PyTree = Any

NEG_INF = -2.0 ** 30  # large-but-finite: keeps softmax NaN-free on fully-masked rows


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


def mla_params(gen: torch.Generator, cfg: ModelConfig) -> PyTree:
    D, H = cfg.d_model, cfg.n_heads
    r = cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dt = cfg.p_dtype
    return {
        "wq": dense_init(gen, (D, H * (dn + dr)), dt),
        "w_dkv": dense_init(gen, (D, r), dt),        # down: shared latent
        "w_krope": dense_init(gen, (D, dr), dt),     # shared rope key
        "w_uk": dense_init(gen, (r, H * dn), dt),    # up: per-head keys
        "w_uv": dense_init(gen, (r, H * dv), dt),    # up: per-head values
        "wo": dense_init(gen, (H * dv, D), dt),
        "kv_norm": rmsnorm_params(r, dt, gen.device),
    }


def cross_attn_params(gen: torch.Generator, cfg: ModelConfig) -> PyTree:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.p_dtype
    return {
        "wq": dense_init(gen, (D, H * hd), dt),
        "wk": dense_init(gen, (cfg.frontend_dim, KV * hd), dt),
        "wv": dense_init(gen, (cfg.frontend_dim, KV * hd), dt),
        "wo": dense_init(gen, (H * hd, D), dt),
        "gate": torch.zeros((1,), dtype=dt, device=gen.device),  # tanh-gated residual
        "q_norm": rmsnorm_params(hd, dt, gen.device),
        "k_norm": rmsnorm_params(hd, dt, gen.device),
    }


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

def _whole_heads(hd: int, *ts):
    """Projections' columns ``[..., cols]`` of one leading shape: each as it
    is when its columns are whole heads (all of them, or this rank's
    heads), the others (part of a head: 8 KV heads of 128 over 16 ranks)
    joined whole over ``model`` together, exactly, so RoPE and the norms
    read whole heads."""
    part = [t for t in ts if t.shape[-1] % hd]
    if not part:
        return ts
    joined = iter(tp_lib.join_heads(*part))
    return tuple(next(joined) if t.shape[-1] % hd else t for t in ts)


def _rank_heads(p, cfg: ModelConfig) -> tuple[int, int, int]:
    """``(h0, h1, offset)``: the query heads ``[h0, h1)`` that cover this
    rank's ``wo`` rows and the rows' first column within them;
    ``(0, H, 0)`` where ``wo``'s rows are whole."""
    rows, hd = p["wo"].shape[0], cfg.head_dim
    if rows == cfg.n_heads * hd:
        return 0, cfg.n_heads, 0
    return tp_lib.query_heads(current_model_shard().index, rows, hd)


def _project_qkv(p, cfg: ModelConfig, x):
    """q ``[B, S, Hq, hd]`` on this rank's query heads and k, v ``[B, S,
    KVc, hd]`` as its cache holds them.  The heads are the projections'
    columns.  On a model shard whose columns are whole heads, a rank
    projects its ``H/tp`` query and ``KV/tp`` KV heads, and query head
    ``h`` of a shard reads KV head ``h // (H/KV)`` of the same shard: the
    contiguous cut keeps every GQA group on one rank.  Where the rules cut
    a projection into part of a head, its columns are joined whole over
    ``model`` (``_whole_heads``): the rank's query heads are those that
    cover its ``wo`` rows (``_rank_heads``), and k, v hold every KV head
    (``_read_kv`` picks the ones they read)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "lora" in p:
        lo = p["lora"]
        q = q + (x @ lo["qA"]) @ lo["qB"]
        k = k + (x @ lo["kA"]) @ lo["kB"]
        v = v + (x @ lo["vA"]) @ lo["vB"]
    q, k, v = (t.reshape(B, S, -1, hd) for t in _whole_heads(hd, q, k, v))
    whole_rows = p["wo"].shape[0] == cfg.n_heads * hd
    if q.shape[2] == cfg.n_heads and not whole_rows:
        h0, h1, _ = _rank_heads(p, cfg)
        q = q[:, :, h0:h1]
    if cfg.qk_norm:
        qn, kn = p["q_norm"], p["k_norm"]
        if not whole_rows:
            # replicated scales on this rank's heads: their gradients are
            # summed over model (each rank's holds its heads' part)
            qn, kn = ({"scale": tp_lib.copy_to_model(t["scale"])} for t in (qn, kn))
        q = rmsnorm(qn, q, cfg.norm_eps)
        k = rmsnorm(kn, k, cfg.norm_eps)
    if whole_rows and tp_lib.attn_splits(cfg) and tp_lib.splits(cfg.n_kv_heads):
        # whole projections on a model shard (a tail block): this rank's
        # heads, as its cache holds them
        q, k, v = (tp_lib.own_part(t, 2) for t in (q, k, v))
    return q, k, v


def _read_kv(p, cfg: ModelConfig, k, v):
    """The KV heads this rank's query heads read: k, v as they are, unless
    they hold every KV head while the rank attends on part of the query
    heads (heads that do not cut whole)."""
    if k.shape[2] != cfg.n_kv_heads or p["wo"].shape[0] == cfg.n_heads * cfg.head_dim:
        return k, v
    h0, h1, _ = _rank_heads(p, cfg)
    idx = torch.tensor(tp_lib.kv_heads(h0, h1, cfg.n_heads, cfg.n_kv_heads), device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _rank_columns(p, cfg: ModelConfig, o):
    """``o [B, S, Hq·hd]``, the attention output of ``_rank_heads``' query
    heads, cut to this rank's ``wo`` rows (itself where they are all)."""
    rows = p["wo"].shape[0]
    if o.shape[-1] == rows or rows == cfg.n_heads * cfg.head_dim:
        return o
    _, _, off = _rank_heads(p, cfg)
    return o[..., off:off + rows]


def attn_out(p, cfg: ModelConfig, out):
    """``out [B, S, heads, hd]`` through ``wo``.  On a model shard whose
    ``wo`` keeps its rows whole and cuts its output dim (a tail block), the
    heads are joined over ``model`` first and the output's columns after,
    so the result is whole on every rank; a row-parallel ``wo`` takes this
    rank's columns of the output (part of a head where the query heads do
    not cut whole) and leaves the sum over ``model`` to the caller."""
    B, S = out.shape[:2]
    o = _rank_columns(p, cfg, out.reshape(B, S, -1))
    w = p["wo"]
    if w.shape[0] != o.shape[-1]:
        o = tp_lib.gather_from_model(o)
    if w.shape[-1] != cfg.d_model:
        return tp_lib.gather_from_model(tp_lib.copy_to_model(o) @ w)
    return o @ w


def gqa_prefill(p, cfg: ModelConfig, x, *, window: int = 0, positions=None):
    """Full-sequence attention.  Returns (out, (k, v)) for cache seeding."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta, cfg.partial_rotary)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.partial_rotary)
    kr, vr = _read_kv(p, cfg, k, v)
    if cfg.use_pallas:
        out = fa_ops.flash_attention(q, kr, vr, causal=cfg.causal, window=window,
                                     softcap=cfg.attn_logit_softcap)
    else:
        mask = causal_mask(S, S, window=window, causal=cfg.causal, device=x.device)
        out = _sdpa(q, kr, vr, mask, cfg.attn_logit_softcap)
    return attn_out(p, cfg, out), (k, v)


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
    out = _sdpa(q, *_read_kv(p, cfg, ck, cv), mask, cfg.attn_logit_softcap)
    return attn_out(p, cfg, out), {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): compressed-latent cache; naive prefill + absorbed decode
# ---------------------------------------------------------------------------

def _mla_heads(p, cfg: ModelConfig) -> int:
    """The query heads ``wq``'s columns hold: this rank's ``H/tp`` on a
    model shard (``wq``, ``w_uk`` and ``w_uv`` cut in whole heads), else
    all ``H``."""
    return p["wq"].shape[-1] // (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def _mla_latent(p, cfg: ModelConfig, x, positions):
    """The latent ``c_kv [B,S,r]`` and the rope key ``[B,S,1,dr]``.  On a
    model shard the down projections and ``kv_norm`` are whole on every
    rank and feed only this rank's heads, so their gradients are summed
    over ``model``."""
    B, S, _ = x.shape
    w_dkv, w_krope, kv_norm = p["w_dkv"], p["w_krope"], p["kv_norm"]
    if _mla_heads(p, cfg) != cfg.n_heads:
        w_dkv, w_krope = tp_lib.copy_to_model(w_dkv), tp_lib.copy_to_model(w_krope)
        kv_norm = {"scale": tp_lib.copy_to_model(kv_norm["scale"])}
    c_kv = rmsnorm(kv_norm, x @ w_dkv, cfg.norm_eps)
    k_rope = apply_rope((x @ w_krope).reshape(B, S, 1, cfg.qk_rope_head_dim), positions,
                        cfg.rope_theta)
    return c_kv, k_rope


def _mla_q(p, cfg: ModelConfig, x, positions):
    B, S, _ = x.shape
    H = _mla_heads(p, cfg)
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = (x @ p["wq"]).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def mla_prefill(p, cfg: ModelConfig, x, positions=None):
    """Naive (expanded) prefill: the latent is up-projected to per-head K/V.
    Returns (out, (c_kv [B,S,r], k_rope [B,S,dr])) for cache seeding.  The
    score scale is ``(dn + dr) ** -0.5``; ``cfg.head_dim`` is not read.  On
    a model shard it attends on this rank's heads (``wo`` row-parallel: the
    caller sums the output over ``model``); the latent is whole."""
    B, S, _ = x.shape
    H = _mla_heads(p, cfg)
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(p, cfg, x, positions)

    c_kv, k_rope = _mla_latent(p, cfg, x, positions)                        # [B,S,r]
    k_nope = (c_kv @ p["w_uk"]).reshape(B, S, H, dn)
    v = (c_kv @ p["w_uv"]).reshape(B, S, H, dv)

    scale = (dn + dr) ** -0.5
    s_nope = torch.einsum("bshd,bthd->bhst", q_nope.float(), k_nope.float())
    s_rope = torch.einsum("bshd,bthd->bhst", q_rope.float(),
                          k_rope.expand(B, S, 1, dr).float())
    scores = (s_nope + s_rope) * scale
    mask = causal_mask(S, S, device=x.device)[:, 0]          # [1,S,T] -> broadcast over H
    scores = torch.where(mask[:, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v.float()).to(x.dtype)
    return out.reshape(B, S, -1) @ p["wo"], (c_kv, k_rope[:, :, 0, :])


def mla_decode(p, cfg: ModelConfig, x, cache: PyTree, pos):
    """Absorbed decode (the MLA serving trick): attend in the latent space,
    for S ≥ 1 query tokens from ``pos`` (S > 1 is a chunked-prefill step).

    cache = {"c_kv": [B, S_max, r], "k_rope": [B, S_max, dr]}: r + dr
    floats per token per layer instead of 2·H·hd, the low-rank *state*.
    W_UK is absorbed into the query, W_UV into the output:
        score = (q_nope Wuk_h) · c_kv + q_rope · k_rope
        out_h = (probs · c_kv) Wuv_h
    The new latents are scattered into a copy of the cache, which is
    returned; the caller's cache is not written.  On a model shard the
    cache is the whole latent and the rank attends on its heads, as in
    :func:`mla_prefill`.
    """
    B, S, _ = x.shape
    dev = x.device
    H = _mla_heads(p, cfg)
    dn, dr, dv, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    posv = _posv(pos, B, dev)
    qpos = posv[:, None] + torch.arange(S, device=dev)[None, :]          # [B, S] absolute
    q_nope, q_rope = _mla_q(p, cfg, x, qpos)

    c_new, kr_new = _mla_latent(p, cfg, x, qpos)
    kr_new = kr_new[:, :, 0]
    bidx = torch.arange(B, device=dev)[:, None].expand(B, S)
    c_kv = cache["c_kv"].index_put((bidx, qpos), c_new.to(cache["c_kv"].dtype))
    k_rope = cache["k_rope"].index_put((bidx, qpos), kr_new.to(cache["k_rope"].dtype))

    w_uk = p["w_uk"].reshape(r, H, dn)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope.float(), w_uk.float())
    s_lat = torch.einsum("bshr,btr->bhst", q_lat, c_kv.float())
    s_rope = torch.einsum("bshd,btd->bhst", q_rope.float(), k_rope.float())
    scores = (s_lat + s_rope) * ((dn + dr) ** -0.5)
    T = c_kv.shape[1]
    mask = torch.arange(T, device=dev)[None, None, None, :] <= qpos[:, None, :, None]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhst,btr->bshr", probs, c_kv.float())
    w_uv = p["w_uv"].reshape(r, H, dv)
    out = torch.einsum("bshr,rhd->bshd", o_lat, w_uv.float()).to(x.dtype)
    return out.reshape(B, S, -1) @ p["wo"], {"c_kv": c_kv, "k_rope": k_rope}


# ---------------------------------------------------------------------------
# Cross-attention (vision/audio memory; llama-3.2-vision style)
# ---------------------------------------------------------------------------

def cross_attn(p, cfg: ModelConfig, x, memory):
    """x: [B,S,D] attends to memory [B,M,frontend_dim] (every query sees
    every memory row; no RoPE; q and k RMS-normed over hd); the output is
    scaled by ``tanh(gate)``, so a closed gate adds nothing.

    On a model shard ``wq``'s columns hold this rank's ``H/tp`` query heads
    and ``wk``/``wv``'s its ``KV/tp`` KV heads (the whole memory projected
    onto them), or part of a head, whose columns are joined whole over
    ``model`` before the norms (as in ``_project_qkv``: the rank attends
    with the query heads that cover its ``wo`` rows, against the KV heads
    they read).  ``wo`` is row-parallel and its output is summed over
    ``model`` here, before the gate: the gate then scales the whole output
    on every rank, and its gradient is whole (not summed).  ``x`` and the
    memory feed column-parallel products and the replicated norm scales
    feed a rank's heads, so their gradients are summed over ``model``."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    M = memory.shape[1]
    qn, kn = p["q_norm"], p["k_norm"]
    split = p["wo"].shape[0] != cfg.n_heads * hd
    if split:
        x, memory = tp_lib.copy_to_model(x), tp_lib.copy_to_model(memory)
        qn, kn = ({"scale": tp_lib.copy_to_model(t["scale"])} for t in (qn, kn))
    (q,) = (t.reshape(B, S, -1, hd) for t in _whole_heads(hd, x @ p["wq"]))
    k, v = (t.reshape(B, M, -1, hd) for t in _whole_heads(hd, memory @ p["wk"],
                                                          memory @ p["wv"]))
    if split and q.shape[2] == cfg.n_heads:
        h0, h1, _ = _rank_heads(p, cfg)
        q = q[:, :, h0:h1]
    q = rmsnorm(qn, q, cfg.norm_eps)
    k = rmsnorm(kn, k, cfg.norm_eps)
    mask = torch.ones((1, 1, S, M), dtype=torch.bool, device=x.device)
    out = _sdpa(q, *_read_kv(p, cfg, k, v), mask).reshape(B, S, -1)
    out = _rank_columns(p, cfg, out) @ p["wo"]
    if split:
        out = tp_lib.reduce_from_model(out)
    return torch.tanh(p["gate"]) * out


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
