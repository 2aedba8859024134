"""j-step state-transition composition (paper §II-C, Fig. 3); the port's copy of
``repro/core/transition.py``.

For a linear state update ``x[k+1] = A[k] x[k]`` the j-step form

    x[k+1] = Φ_{k,j} x[k-j],     Φ_{k,j} = A[k] A[k-1] ... A[k-j]

shrinks the serial dependency chain by j×, because the Φ products do not
depend on the state and can be formed in parallel.  For *diagonal*
recurrences with drive, ``h[t] = a[t] * h[t-1] + b[t]`` (the SSM case),
composition of two steps is

    (a2, b2) ∘ (a1, b1) = (a2*a1, a2*b1 + b2)

which is associative: the foundation of the log-depth scan and of the
chunked form, the pattern of the selective-scan kernel.  PyTorch has no
``associative_scan``; :func:`linear_recurrence_assoc` is the log-depth
scan written out as recursive doubling.
"""

from __future__ import annotations

import math

import torch


# ---------------------------------------------------------------------------
# Dense transition matrices
# ---------------------------------------------------------------------------

def compose_dense(A_seq: torch.Tensor) -> torch.Tensor:
    """Φ = A[j-1] ··· A[0] for ``A_seq`` of shape [j, M, M] (newest last)."""
    phi = torch.eye(A_seq.shape[-1], dtype=A_seq.dtype, device=A_seq.device)
    for A_k in A_seq:
        phi = A_k @ phi
    return phi


def jstep_dense_scan(A_seq: torch.Tensor, x0: torch.Tensor, j: int) -> torch.Tensor:
    """x[N] via j-step Φ blocks: compose the A's in blocks of j (no
    dependency on x, so all blocks at once), then apply the T/j composed
    operators serially.  Equivalent to the step-by-step product; the serial
    chain drops from T to T/j.  Requires ``T % j == 0``."""
    T, M, _ = A_seq.shape
    if T % j:
        raise ValueError(f"sequence length {T} not divisible by j={j}")
    blocks = A_seq.reshape(T // j, j, M, M)
    # Φ of every block at once, batched over the blocks (Fig. 4's pipelined
    # multiplier)
    phis = torch.eye(M, dtype=A_seq.dtype, device=A_seq.device).expand(T // j, M, M)
    for k in range(j):
        phis = blocks[:, k] @ phis
    x = x0
    for phi in phis:
        x = phi @ x
    return x


def stepwise_dense_scan(A_seq: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """Reference serial execution x[k+1] = A[k] x[k]."""
    x = x0
    for A_k in A_seq:
        x = A_k @ x
    return x


# ---------------------------------------------------------------------------
# Diagonal (elementwise) affine recurrences — the SSM workhorse
# ---------------------------------------------------------------------------

def affine_compose(e1, e2):
    """Associative composition of h -> a*h + b elements (e2 applied after e1)."""
    a1, b1 = e1
    a2, b2 = e2
    return a2 * a1, a2 * b1 + b2


def linear_recurrence_serial(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """h[t] = a[t]*h[t-1] + b[t], returned for all t.  Shapes: a, b [T, ...]."""
    h = h0
    hs = []
    for a_t, b_t in zip(a, b):
        h = a_t * h + b_t
        hs.append(h)
    return torch.stack(hs)


def linear_recurrence_assoc(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """The same recurrence by a log-depth scan over (a, b) pairs: the
    maximal-j limit of the paper's Φ pipelining, every prefix Φ_{t,0} formed
    by a tree of compositions.  Recursive doubling: after the round with
    offset s, element t holds the composition of steps t-2s+1 .. t."""
    # fold h0 into the first drive term: h[0] = a[0]*h0 + b[0]
    b = torch.cat([(a[0] * h0 + b[0])[None], b[1:]])
    a = torch.cat([torch.ones_like(a[:1]), a[1:]])
    s = 1
    while s < a.shape[0]:
        a_new, b_new = affine_compose((a[:-s], b[:-s]), (a[s:], b[s:]))
        a = torch.cat([a[:s], a_new])
        b = torch.cat([b[:s], b_new])
        s *= 2
    return b


def linear_recurrence_chunked(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                              chunk: int) -> torch.Tensor:
    """Blocked j-step execution (j = ``chunk``), the pattern the TPU
    ``ssm_scan`` kernel implements.

    Within each chunk the cumulative products ``cumprod(a)`` (= the diagonal
    Φ_{t,j}) and chunk-local outputs are formed for all chunks at once; only
    one carry crosses chunk boundaries, so the serial chain is T/chunk long.
    """
    T = a.shape[0]
    if T % chunk:
        raise ValueError(f"T={T} not divisible by chunk={chunk}")
    n = T // chunk
    a_c = a.reshape((n, chunk) + a.shape[1:])
    b_c = b.reshape((n, chunk) + b.shape[1:])
    # p[t] = prod_{s<=t} a[s]; q[t] = sum_{s<=t} (prod_{s<r<=t} a[r]) b[s],
    # formed as p[t] * cumsum(b / p)
    p = torch.cumprod(a_c, dim=1)
    q = p * torch.cumsum(b_c / torch.where(p == 0, torch.ones_like(p), p), dim=1)
    # serial carry across chunks: h_end[i] = p[i,-1]*h_end[i-1] + q[i,-1];
    # each chunk gets its incoming boundary state
    h = h0
    h_in = []
    for p_last, q_last in zip(p[:, -1], q[:, -1]):
        h_in.append(h)
        h = p_last * h + q_last
    hs = p * torch.stack(h_in)[:, None] + q
    return hs.reshape((T,) + a.shape[1:])


# ---------------------------------------------------------------------------
# Serial-depth accounting (the critical path of the j-step form)
# ---------------------------------------------------------------------------

def serial_depth_estimate(T: int, j: int) -> int:
    """Dependency-chain length of the j-step form: T/j serial applications
    (+ log2(j) tree depth inside each Φ composition, which pipelines)."""
    return T // j + max(0, math.ceil(math.log2(max(j, 1))))


__all__ = [
    "affine_compose",
    "compose_dense",
    "jstep_dense_scan",
    "linear_recurrence_assoc",
    "linear_recurrence_chunked",
    "linear_recurrence_serial",
    "serial_depth_estimate",
    "stepwise_dense_scan",
]
