"""State-space sequence blocks: Mamba-1 (falcon-mamba) and Mamba-2 / SSD
(zamba2); the port's counterpart of ``repro/models/ssm.py``.

The network *is* a discrete state-space system ``h[t] = Ā_t h[t-1] + B̄_t
x_t``, ``y_t = C_t h_t`` (the paper's object of study).  Prefill runs the
scan over the whole prompt and emits the decode state; decode is the
one-step state update.

Mamba-1: the state is ``{"h": [B, DI, N], "conv": [B, k-1, DI]}``.
``cfg.use_pallas`` runs the selective scan through ``kernels/ssm_scan``
(the hand-written CUDA kernel for CUDA tensors, its plain version on the
CPU), with the carry ``h0`` as an input, so a resumed (chunked) prefill
runs the kernel too.  On a model shard (``parallel.tensor_parallel``) a
rank holds ``DI/tp`` of the inner channels and the kernel scans those.
Without it the scan is the plain step loop
(``kernels/ssm_scan/ref.py``): the reference's chunking of that loop
(``chunk``, ``cfg.ssm_chunk``) bounds its activation memory under XLA and
changes no number, so it is not carried over.

Mamba-2 / SSD: the decay is a scalar per head, so within a chunk of ``c``
steps the scan is two products (pairwise decay times the ``C·Bᵀ`` Gram
matrix, then chunk summaries) and only one ``[B, H, P, N]`` carry crosses
chunk boundaries: the paper's j-step transition with j = c.  The
reference computes it with ``jnp`` einsums and no Pallas kernel, so the
port's is plain PyTorch on either device.  The chunk size fixes the
summation order, so it follows the reference's rule exactly:
:data:`SSD_CHUNK` (or ``cfg.ssm_chunk``) halved until it divides T.  The
state is ``{"h": [B, H, P, N], "conv": {"x": [B, k-1, DI], "bc": [B, k-1,
2N]}}``.
"""

from __future__ import annotations

from typing import Any, TYPE_CHECKING

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.parallel import tensor_parallel as tp_lib
from repro_torch.parallel.sharding import current_model_shard

from .layers import dense_init, rmsnorm, rmsnorm_params

if TYPE_CHECKING:
    from .config import ModelConfig

PyTree = Any

SSD_CHUNK = 128   # the reference's default Mamba-2 chunk (the j of the j-step form)


# ---------------------------------------------------------------------------
# causal depthwise conv1d (k taps, "same" causal padding)
# ---------------------------------------------------------------------------

def causal_conv1d(x, w, b, tail=None):
    """x: [B,T,C], w: [k,C], b: [C].  y[t] = Σ_i w[i]·x[t-k+1+i] + b, the taps
    summed in order i = 0..k-1 as the reference does.

    ``tail`` ([B, k-1, C]) seeds the left context for resumable prefill: a
    chunk continuation convolves against the previous chunk's trailing
    inputs instead of zeros, so chunked == unchunked exactly."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0)) if tail is None \
        else torch.cat([tail.to(x.dtype), x], dim=1)
    y = sum(pad[:, i : i + x.shape[1]] * w[i] for i in range(k))
    return y + b


def conv_step(conv_state, x_t, w, b):
    """Single decode step.  conv_state: [B, k-1, C] (trailing inputs).  A
    bf16 model's fp32 state promotes the window, and the taps with it, as
    ``jnp.einsum`` promotes its operands."""
    window = torch.cat([conv_state, x_t[:, None]], dim=1)  # [B,k,C]
    y = torch.einsum("bkc,kc->bc", window, w.to(window.dtype)) + b
    return window[:, 1:], y


def _conv_tail(x_pre, tail0, k: int):
    """The trailing k-1 pre-conv inputs (decode's conv state), continuing
    ``tail0`` when the scan resumed."""
    if tail0 is not None:
        x_pre = torch.cat([tail0.to(x_pre.dtype), x_pre], dim=1)
    return F.pad(x_pre, (0, 0, k - 1, 0))[:, -(k - 1):]


# ---------------------------------------------------------------------------
# Mamba-1 (falcon-mamba-7b)
# ---------------------------------------------------------------------------

def mamba1_params(gen: torch.Generator, cfg: "ModelConfig") -> PyTree:
    """Random Mamba-1 parameters from ``gen`` (on its device), the
    reference's shapes and initialisers: split x/z projections, Δ initialised
    in [1e-3, 1e-1] through ``dt_bias``, ``A_log = log(1..N)``."""
    D, DI, N, R, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank_actual, cfg.d_conv
    dev, dt_ = gen.device, cfg.p_dtype
    u = torch.rand((DI,), generator=gen, device=dev)
    dt = torch.exp(u * (np.log(0.1) - np.log(0.001)) + np.log(0.001))
    return {
        "w_x": dense_init(gen, (D, DI), dt_),
        "w_z": dense_init(gen, (D, DI), dt_),
        "conv_w": (torch.randn((K, DI), generator=gen, device=dev) / np.sqrt(K)).to(dt_),
        "conv_b": torch.zeros((DI,), dtype=dt_, device=dev),
        "x_proj": dense_init(gen, (DI, R + 2 * N), dt_),
        "dt_proj": dense_init(gen, (R, DI), dt_),
        # softplus(dt_bias) = dt (the inverse of softplus)
        "dt_bias": (dt + torch.log(-torch.expm1(-dt))).to(dt_),
        "A_log": torch.log(torch.arange(1, N + 1, dtype=torch.float32, device=dev))
                      .expand(DI, N).to(dt_).contiguous(),
        "D": torch.ones((DI,), dtype=dt_, device=dev),
        "out_proj": dense_init(gen, (DI, D), dt_),
    }


def _mamba1_gather(p, cfg: "ModelConfig", u, conv_tail=None):
    """Shared projections: (x_pre, x_conv, z, Δ, B, C) for the scan.  The
    pre-conv projection ``x_pre`` is returned for the decode conv state, so
    it is not recomputed (the reference recomputes ``u @ w_x``; same math).

    On a model shard the inner channels are this rank's ``DI/tp``:
    ``w_x``/``w_z`` column-parallel, the conv, ``dt_proj``'s columns,
    ``dt_bias``, ``A_log``, ``D`` and the scan local, and ``x_proj``'s rows
    the rank's, so ``[..., R+2N]`` is summed over ``model`` once before Δ,
    B and C are split (and, being read by every rank's channels, its
    gradient is summed back)."""
    N, R = cfg.ssm_state, cfg.dt_rank_actual
    split = _splits_inner(cfg)
    if split:
        u = tp_lib.copy_to_model(u)
    x_pre = u @ p["w_x"]
    z = u @ p["w_z"]
    x = F.silu(causal_conv1d(x_pre, p["conv_w"], p["conv_b"], tail=conv_tail))
    dbc = x @ p["x_proj"]
    if split:
        dbc = tp_lib.copy_to_model(tp_lib.reduce_from_model(dbc))
    dt, B, C = dbc[..., :R], dbc[..., R : R + N], dbc[..., R + N :]
    delta = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])  # [B,T,DI]
    return x_pre, x, z, delta, B, C


def mamba1_prefill(p, cfg: "ModelConfig", u, h0=None, state: PyTree | None = None):
    """Selective scan over a prompt.  u: [B,T,D] → ([B,T,D], state).

    ``state`` (the decode-layout ``{"h", "conv"}``) resumes the scan
    mid-sequence: the h carry and the causal conv's left context continue
    from where the previous chunk stopped (serving's chunked prefill).  A
    bare ``h0=`` resumes the h carry only.
    """
    conv_tail0 = None
    if state is not None:
        h0 = state["h"]
        conv_tail0 = state["conv"]
    x_pre, x, z, delta, Bm, Cm = _mamba1_gather(p, cfg, u, conv_tail=conv_tail0)
    A = -torch.exp(p["A_log"].float())  # [DI,N]
    f32 = lambda t: t.to(torch.float32)
    scan = ssm_ops.ssm_scan if cfg.use_pallas else ssm_scan_ref
    y, h = scan(f32(x), f32(delta), A, f32(Bm), f32(Cm), h0)
    y = y + x * p["D"]
    y = y * F.silu(z)
    out = _out_proj(y.to(u.dtype), p, cfg)
    return out, {"h": h, "conv": _conv_tail(x_pre, conv_tail0, cfg.d_conv)}


def mamba1_decode(p, cfg: "ModelConfig", u_t, state: PyTree):
    """One token.  u_t: [B,1,D]; state = {"h": [B,DI,N], "conv": [B,k-1,DI]}."""
    N, R = cfg.ssm_state, cfg.dt_rank_actual
    split = _splits_inner(cfg)
    u0 = tp_lib.copy_to_model(u_t[:, 0]) if split else u_t[:, 0]
    x_pre = u0 @ p["w_x"]
    z = u0 @ p["w_z"]
    conv_state, x = conv_step(state["conv"], x_pre, p["conv_w"], p["conv_b"])
    x = F.silu(x)
    dbc = x @ p["x_proj"]
    if split:
        dbc = tp_lib.copy_to_model(tp_lib.reduce_from_model(dbc))
    dt, Bm, Cm = dbc[..., :R], dbc[..., R : R + N], dbc[..., R + N :]
    delta = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(delta[..., None] * A)
    b = (delta * x)[..., None] * Bm[:, None, :]
    h = a * state["h"] + b
    y = torch.einsum("bdn,bn->bd", h, Cm) + x * p["D"]
    y = y * F.silu(z)
    out = _out_proj(y.to(u_t.dtype), p, cfg)[:, None]
    return out, {"h": h, "conv": conv_state}


def mamba1_init_state(cfg: "ModelConfig", batch: int, device) -> PyTree:
    """``{"h": [B, DI, N], "conv": [B, k-1, DI]}`` in fp32, with this rank's
    ``DI/tp`` channels on a model shard (``cache_specs`` cuts them so)."""
    di = tp_lib.local(cfg.d_inner)
    return {
        "h": torch.zeros((batch, di, cfg.ssm_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.d_conv - 1, di), dtype=torch.float32, device=device),
    }


def _splits_inner(cfg: "ModelConfig") -> bool:
    return tp_lib.splits(cfg.d_inner)


def _out_proj(y, p, cfg: "ModelConfig"):
    """``y @ out_proj``; row-parallel on a model shard, summed over it."""
    out = y @ p["out_proj"]
    return tp_lib.reduce_from_model(out) if _splits_inner(cfg) else out


def _no_model_shard(what: str) -> None:
    if current_model_shard() is not None:
        raise NotImplementedError(
            f"{what}: Mamba-2's gated RMSNorm runs over the whole inner dim, so it does not "
            "compute on a model shard yet (ROADMAP.md, Queue 1 item 12c(c))")


# ---------------------------------------------------------------------------
# Mamba-2 / SSD (zamba2): scalar-per-head decay -> matrix form
# ---------------------------------------------------------------------------

def mamba2_params(gen: torch.Generator, cfg: "ModelConfig") -> PyTree:
    """Random Mamba-2 parameters from ``gen`` (on its device), the
    reference's shapes and initialisers: split z / x / (B, C) / Δ
    projections, the causal conv split into its x and (B, C) parts, zero
    biases, ``D = 1`` and ``A_log = log(linspace(1, 16, H))``."""
    D, DI, N, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.d_conv
    H = cfg.n_mamba_heads
    dev, dt_ = gen.device, cfg.p_dtype
    zeros = lambda n: torch.zeros((n,), dtype=dt_, device=dev)
    return {
        "w_z": dense_init(gen, (D, DI), dt_),
        "w_x": dense_init(gen, (D, DI), dt_),
        "w_bc": dense_init(gen, (D, 2 * N), dt_),
        "w_dt": dense_init(gen, (D, H), dt_),
        "conv_w_x": (torch.randn((K, DI), generator=gen, device=dev) / np.sqrt(K)).to(dt_),
        "conv_b_x": zeros(DI),
        "conv_w_bc": (torch.randn((K, 2 * N), generator=gen, device=dev) / np.sqrt(K)).to(dt_),
        "conv_b_bc": zeros(2 * N),
        "dt_bias": zeros(H),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)).to(dt_),
        "D": torch.ones((H,), dtype=dt_, device=dev),
        "norm": rmsnorm_params(DI, dt_, dev),
        "out_proj": dense_init(gen, (DI, D), dt_),
    }


def ssd_chunk_size(T: int, chunk: int = SSD_CHUNK) -> int:
    """The reference's SSD chunk for T steps: ``chunk`` halved until it
    divides T (T itself at or below ``chunk``; 1 for a prime T above it)."""
    c = min(chunk, T)
    while T % c:
        c //= 2
    return c


def _prefix_sum(x):
    """Inclusive prefix sum over the last axis, one fp32 add at a time in
    order (``torch.cumsum`` accumulates in fp64 on the CPU)."""
    out = torch.empty_like(x)
    acc = out[..., 0] = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = out[..., i] = acc + x[..., i]
    return out


def cumsum_blocked(x, base: int = 16):
    """Inclusive cumulative sum over the last axis in the order in which the
    reference's ``jnp.cumsum`` adds on the CPU (XLA rewrites the scan into
    blocks of ``base``): each block of ``base`` summed in sequence, the
    block totals scanned the same way (recursively), the exclusive total
    of the earlier blocks added last; the tail padded with zeros.

    The SSD's cumulative log-decay reaches hundreds within a chunk, and its
    pairwise decays are differences of it, so another summation order moves
    them by ~1e-5 relative; this one gives the reference's bits."""
    n = x.shape[-1]
    if n <= base:
        return _prefix_sum(x)
    nb = -(-n // base)
    xp = F.pad(x, (0, nb * base - n))
    P = _prefix_sum(xp.reshape(x.shape[:-1] + (nb, base)))
    inc = cumsum_blocked(P[..., -1], base)
    E = F.pad(inc[..., :-1], (1, 0))                           # exclusive block totals
    return (P + E[..., None]).reshape(xp.shape)[..., :n]


def _ssd_chunk(x, dt, B, C, A, h0, chunk: int):
    """SSD chunked scan.  x: [Bsz,T,H,P]; dt: [Bsz,T,H]; B, C: [Bsz,T,N];
    A: [H]; h0: [Bsz,H,P,N].  Returns (y [Bsz,T,H,P], h_last).

    Per head, state S ∈ R^{P×N}:  S_t = a_t S_{t-1} + Δ_t x_t B_tᵀ,
    y_t = S_t C_t, with a_t = exp(Δ_t A_h) a scalar per head: within a
    chunk the work is the pairwise decay ⊙ the (C_t·B_s) Gram matrix, and
    one carry crosses each chunk boundary.
    """
    Bsz, T, H, P = x.shape
    c = ssd_chunk_size(T, chunk)
    nc = T // c

    la = dt * A                                                # log decay [Bsz,T,H]
    res = lambda t: t.reshape((Bsz, nc, c) + t.shape[2:])    
    x_c, la_c, dt_c, B_c, C_c = res(x), res(la), res(dt), res(B), res(C)
    xdt = x_c * dt_c[..., None]                                # [B,nc,c,H,P]

    # [B,nc,c,H] within-chunk cumulative log Φ
    L = cumsum_blocked(la_c.transpose(2, 3)).transpose(2, 3)

    # intra-chunk: decay[t,s] = exp(L_t - L_s) for s <= t.  Masked BEFORE
    # the exp: the s > t half is >= 0 and overflows to inf.
    diff = L[:, :, :, None, :] - L[:, :, None, :, :]          # [B,nc,c,c,H]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    G = torch.exp(torch.where(tri[None, None, :, :, None], diff, -1e30))
    CB = torch.einsum("bitk,bisk->bits", C_c, B_c)             # [B,nc,c,c]
    W = G * CB[..., None]                                      # [B,nc,c,c,H]
    y_intra = torch.einsum("bitsh,bishp->bithp", W, xdt)

    # chunk summaries: S_i = Σ_s exp(L_end - L_s) Δ_s x_s B_sᵀ
    decay_to_end = torch.exp(L[:, :, -1:, :] - L)              # [B,nc,c,H]
    S = torch.einsum("bishp,bisk->bihpk", decay_to_end[..., None] * xdt, B_c)

    # inter-chunk serial carry (length nc, the j-step chain); h_in holds the
    # incoming state of each chunk
    a_chunk = torch.exp(L[:, :, -1, :])                        # [B,nc,H]
    h_in = torch.empty_like(S)
    h = h0
    for i in range(nc):
        h_in[:, i] = h
        h = a_chunk[:, i, :, None, None] * h + S[:, i]

    # inter-chunk contribution: y_t += exp(L_t) · (C_t · h_in)
    y_inter = torch.einsum("bitk,bihpk->bithp", C_c, h_in) * torch.exp(L)[..., None]

    y = (y_intra + y_inter).reshape(Bsz, T, H, P)
    return y, h


def mamba2_prefill(p, cfg: "ModelConfig", u, h0=None, state: PyTree | None = None):
    """SSD scan over a prompt.  u: [B,T,D] → ([B,T,D], state).

    ``state`` (the decode-layout ``{"h", "conv": {"x", "bc"}}``) resumes
    the scan mid-sequence: the h carry and both causal convs' left context
    continue from where the previous piece stopped (serving's chunked
    prefill).  The conv tails are the trailing k-1 *pre-conv* projections.
    """
    _no_model_shard("mamba2_prefill")
    Bsz, T, _ = u.shape
    DI, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.n_mamba_heads, cfg.mamba_headdim
    tail_x = tail_bc = None
    if state is not None:
        h0 = state["h"]
        tail_x, tail_bc = state["conv"]["x"], state["conv"]["bc"]
    z = u @ p["w_z"]
    x_pre = u @ p["w_x"]
    bc_pre = u @ p["w_bc"]
    x = F.silu(causal_conv1d(x_pre, p["conv_w_x"], p["conv_b_x"], tail=tail_x))
    bc = F.silu(causal_conv1d(bc_pre, p["conv_w_bc"], p["conv_b_bc"], tail=tail_bc))
    B, C = bc[..., :N], bc[..., N:]
    dt = F.softplus(u @ p["w_dt"] + p["dt_bias"])              # [B,T,H]
    A = -torch.exp(p["A_log"].float())                         # [H]
    x_h = x.reshape(Bsz, T, H, P).float()
    if h0 is None:
        h0 = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=u.device)
    y, h_last = _ssd_chunk(x_h, dt.float(), B.float(), C.float(), A, h0,
                           cfg.ssm_chunk or SSD_CHUNK)
    y = y + x_h * p["D"][:, None].float()
    y = y.reshape(Bsz, T, DI).to(u.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    conv = {"x": _conv_tail(x_pre, tail_x, cfg.d_conv),
            "bc": _conv_tail(bc_pre, tail_bc, cfg.d_conv)}
    return y @ p["out_proj"], {"h": h_last, "conv": conv}


def mamba2_decode(p, cfg: "ModelConfig", u_t, state: PyTree):
    """One token.  u_t: [B,1,D]; state = {"h": [B,H,P,N], "conv": {"x":
    [B,k-1,DI], "bc": [B,k-1,2N]}}."""
    _no_model_shard("mamba2_decode")
    Bsz = u_t.shape[0]
    DI, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.n_mamba_heads, cfg.mamba_headdim
    u0 = u_t[:, 0]
    z = u0 @ p["w_z"]
    conv_x, x = conv_step(state["conv"]["x"], u0 @ p["w_x"], p["conv_w_x"], p["conv_b_x"])
    conv_bc, bc = conv_step(state["conv"]["bc"], u0 @ p["w_bc"], p["conv_w_bc"],
                            p["conv_b_bc"])
    x = F.silu(x)
    bc = F.silu(bc)
    B, C = bc[..., :N].float(), bc[..., N:].float()
    dt = F.softplus(u0 @ p["w_dt"] + p["dt_bias"]).float()    # [B,H]
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt * A)                                      # [B,H]
    x_h = x.reshape(Bsz, H, P).float()
    dBx = (dt[..., None] * x_h)[..., None] * B[:, None, None, :]   # [B,H,P,N]
    h = a[..., None, None] * state["h"] + dBx
    y = torch.einsum("bhpk,bk->bhp", h, C)
    y = y + x_h * p["D"][:, None]
    y = y.reshape(Bsz, DI).to(u_t.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return (y @ p["out_proj"])[:, None], {"h": h, "conv": {"x": conv_x, "bc": conv_bc}}


def mamba2_init_state(cfg: "ModelConfig", batch: int, device) -> PyTree:
    _no_model_shard("mamba2_init_state")
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "h": torch.zeros((batch, cfg.n_mamba_heads, cfg.mamba_headdim, cfg.ssm_state), **f32),
        "conv": {
            "x": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), **f32),
            "bc": torch.zeros((batch, cfg.d_conv - 1, 2 * cfg.ssm_state), **f32),
        },
    }


__all__ = [
    "causal_conv1d",
    "conv_step",
    "mamba1_decode",
    "mamba1_init_state",
    "mamba1_params",
    "mamba1_prefill",
    "mamba2_decode",
    "mamba2_init_state",
    "mamba2_params",
    "mamba2_prefill",
    "SSD_CHUNK",
    "ssd_chunk_size",
]
