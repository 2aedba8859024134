"""State-space sequence blocks: Mamba-1 (falcon-mamba); the port's counterpart
of the Mamba-1 half of ``repro/models/ssm.py``.

The network *is* a discrete state-space system ``h[t] = Ā_t h[t-1] + B̄_t
x_t``, ``y_t = C_t h_t`` (the paper's object of study).  Prefill runs the
selective scan over the whole prompt and emits the decode state ``{"h":
[B, DI, N], "conv": [B, k-1, DI]}``; decode is the one-step state update.

Paths: ``cfg.use_pallas`` runs the scan through ``kernels/ssm_scan`` (the
hand-written CUDA kernel for CUDA tensors, its plain version on the CPU),
with the carry ``h0`` as an input, so a resumed (chunked) prefill runs the
kernel too.  Without it the scan is the plain step loop
(``kernels/ssm_scan/ref.py``): the reference's chunking of that loop
(``chunk``, ``cfg.ssm_chunk``) bounds its activation memory under XLA and
changes no number, so it is not carried over.

Mamba-2 / SSD (zamba2) waits for the hybrid family: the ``mamba2`` block
kind raises ``NotImplementedError`` naming ROADMAP.md.
"""

from __future__ import annotations

from typing import Any, TYPE_CHECKING

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

from .layers import dense_init

if TYPE_CHECKING:
    from .config import ModelConfig

PyTree = Any


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
    """Single decode step.  conv_state: [B, k-1, C] (trailing inputs)."""
    window = torch.cat([conv_state, x_t[:, None]], dim=1)  # [B,k,C]
    y = torch.einsum("bkc,kc->bc", window, w) + b
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
    it is not recomputed (the reference recomputes ``u @ w_x``; same math)."""
    N, R = cfg.ssm_state, cfg.dt_rank_actual
    x_pre = u @ p["w_x"]
    z = u @ p["w_z"]
    x = F.silu(causal_conv1d(x_pre, p["conv_w"], p["conv_b"], tail=conv_tail))
    dbc = x @ p["x_proj"]
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
    out = y.to(u.dtype) @ p["out_proj"]
    return out, {"h": h, "conv": _conv_tail(x_pre, conv_tail0, cfg.d_conv)}


def mamba1_decode(p, cfg: "ModelConfig", u_t, state: PyTree):
    """One token.  u_t: [B,1,D]; state = {"h": [B,DI,N], "conv": [B,k-1,DI]}."""
    N, R = cfg.ssm_state, cfg.dt_rank_actual
    x_pre = u_t[:, 0] @ p["w_x"]
    z = u_t[:, 0] @ p["w_z"]
    conv_state, x = conv_step(state["conv"], x_pre, p["conv_w"], p["conv_b"])
    x = F.silu(x)
    dbc = x @ p["x_proj"]
    dt, Bm, Cm = dbc[..., :R], dbc[..., R : R + N], dbc[..., R + N :]
    delta = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(delta[..., None] * A)
    b = (delta * x)[..., None] * Bm[:, None, :]
    h = a * state["h"] + b
    y = torch.einsum("bdn,bn->bd", h, Cm) + x * p["D"]
    y = y * F.silu(z)
    out = (y.to(u_t.dtype) @ p["out_proj"])[:, None]
    return out, {"h": h, "conv": conv_state}


def mamba1_init_state(cfg: "ModelConfig", batch: int, device) -> PyTree:
    return {
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=torch.float32,
                            device=device),
    }


__all__ = [
    "causal_conv1d",
    "conv_step",
    "mamba1_decode",
    "mamba1_init_state",
    "mamba1_params",
    "mamba1_prefill",
]
