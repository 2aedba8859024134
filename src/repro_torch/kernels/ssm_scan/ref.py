"""Plain PyTorch version of the selective scan (the Mamba-1 inner
recurrence); the port's copy of ``repro/kernels/ssm_scan/ref.py``.

Contract (matches the kernel and ``ops``):
    y, h_final = ssm_scan(x, delta, A, B, C, h0)
      x, delta : [Bsz, T, D]     (post-conv activations, softplus'd Δ)
      A        : [D, N]          (negative; A = -exp(A_log))
      B, C     : [Bsz, T, N]
      h0       : [Bsz, D, N], or None for a zero carry
    recurrence: h[t] = exp(Δ_t ⊙ A) ⊙ h[t-1] + (Δ_t x_t) ⊙ B_t
                y[t] = Σ_n h[t] C_t
Everything is computed in fp32; y and h_final come back in fp32.
"""

from __future__ import annotations

import torch


def ssm_scan_ref(x, delta, A, B, C, h0=None):
    """The recurrence as a time loop over ``[Bsz, D, N]`` states."""
    x, delta, A, B, C = (t.float() for t in (x, delta, A, B, C))
    h = (torch.zeros((x.shape[0], x.shape[2], A.shape[-1]), device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(x.shape[1]):
        d_t = delta[:, t]
        a = torch.exp(d_t[..., None] * A)                       # [Bsz, D, N]
        h = a * h + (d_t * x[:, t])[..., None] * B[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    return torch.stack(ys, dim=1), h


__all__ = ["ssm_scan_ref"]
