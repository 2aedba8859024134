"""Independent fixed-point golden model for the emitted RTL; the port's
counterpart of ``repro/verify/golden.py``, on int64 tensors.

``repro_torch.codegen.rtlsim`` simulates the Verilog *structurally* — J-copy
striding with gated pad lanes, bit-level AF address selects, MACCs as
float64 GEMMs of 16-bit limbs.  This module computes the same words a
second way, as integer linear algebra straight off the datapath graph,
sharing **no** arithmetic code with rtlsim (only the IR it walks, the
published word format and the ROM's activation samples).  ``difftest``
requires the two to agree **bit-exactly** on every generated spec; any
divergence is a bug in one of them (or in the emission they both model).

Word semantics implemented independently here:

* words are signed ``width``-bit codes of ``Q(4.width-4)`` values
  (round-to-nearest, saturate on quantization — the ROM load convention);
* MACC: an int64 broadcast product summed over the input lanes (wrapping
  mod 2^64), wrapped to ``2*width`` bits, arithmetic shift right by
  ``width-4`` (the RTL's ``[2W-5 -: W]`` select), wrap to ``width`` bits;
  bias adds wrap at ``width`` bits;
* AF ROMs: the activation's float32 samples at the 2^AF_ADDR_BITS bin
  centers over ``[-R, R)``, quantized; the address is the input's bin index
  (clamped), computed from the *real* value in float64 — equal to the RTL's
  shifted bit-select because every intermediate is a power-of-two-scaled
  integer, exact in float64;
* gate algebra is lane-wise: add/sub wrap at ``width``; mul takes the
  Q-aligned slice of the 2W-bit lane product.

int64 is exact for every step as long as ``2*width <= 64``: the sum wraps
mod 2^64, and reducing mod 2^(2·width) afterwards gives the same words.
:func:`fixed_forward` runs on the card unless the caller passes a CPU
device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.codegen.af_samples import AF_ADDR_BITS, samples
from repro_torch.codegen.ir import Program
from repro_torch.codegen.knobs import word_bits_reason
from repro_torch.device import resolve_device
from repro_torch.kernels._lut import RANGE as _AF_RANGE

DEFAULT_WIDTH = 18
_COMB = {"identity", "relu"}


def _wrap(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Two's-complement reinterpretation of the low ``bits`` bits."""
    if bits >= 64:  # int64 already wraps mod 2^64
        return v
    span = 1 << bits
    v = v & (span - 1)
    return torch.where(v >= (span >> 1), v - span, v)


def _quant(vals, width: int, device) -> torch.Tensor:
    """Real → signed word: round to nearest, saturate (ROM load rule)."""
    scale = 2.0 ** (width - 4)
    q = torch.round(torch.as_tensor(vals, device=device).to(torch.float64) * scale)
    top = 2 ** (width - 1)
    return torch.clamp(q, -top, top - 1).to(torch.int64)


def _macc(x: torch.Tensor, w: torch.Tensor, width: int, bias=None) -> torch.Tensor:
    """x[..., in] @ w[in, out] on the fixed-point datapath."""
    z = _wrap((x.unsqueeze(-1) * w).sum(dim=-2), 2 * width)
    z = _wrap(z >> (width - 4), width)
    if bias is not None:
        z = _wrap(z + bias, width)
    return z


def _mul(a: torch.Tensor, b: torch.Tensor, width: int) -> torch.Tensor:
    p = _wrap(a * b, 2 * width)
    return _wrap(p >> (width - 4), width)


def _af_table(fn: str, width: int, device) -> torch.Tensor:
    return _quant(np.asarray(samples(fn), np.float64), width, device)


def _af(fn: str, x: torch.Tensor, table, width: int) -> torch.Tensor:
    if fn == "identity":
        return x
    if fn == "relu":
        return torch.clamp(x, min=0)
    n = 2 ** AF_ADDR_BITS
    xr = x.to(torch.float64) / 2.0 ** (width - 4)
    idx = torch.floor((xr + _AF_RANGE) / (2 * _AF_RANGE) * n).to(torch.int64)
    return table[torch.clamp(idx, 0, n - 1)]


def _eval_graph(graph, consts, states, u, k: int, width: int, af_tables):
    env: dict[str, torch.Tensor] = {}
    for n in graph.nodes:
        if n.op == "input":
            env[n.name] = u
        elif n.op == "state":
            env[n.name] = states[n.name]
        elif n.op == "const":
            c = consts[n.name]
            env[n.name] = c[k] if n.attr("per_step") else c
        elif n.op == "macc":
            b = env[n.inputs[2]] if len(n.inputs) == 3 else None
            if b is not None and b.ndim > 1:
                b = b[0]
            env[n.name] = _macc(env[n.inputs[0]], env[n.inputs[1]], width, bias=b)
        elif n.op == "af":
            fn = n.attr("fn")
            env[n.name] = _af(fn, env[n.inputs[0]], af_tables.get(fn), width)
        elif n.op == "concat":
            lead = env[n.inputs[0]].shape[:-1]
            env[n.name] = torch.cat(
                [torch.broadcast_to(env[i], lead + (graph.node(i).width,))
                 for i in n.inputs], dim=-1)
        elif n.op == "slice":
            env[n.name] = env[n.inputs[0]][..., n.attr("start"):n.attr("stop")]
        elif n.op == "add":
            env[n.name] = _wrap(env[n.inputs[0]] + env[n.inputs[1]], width)
        elif n.op == "sub":
            env[n.name] = _wrap(env[n.inputs[0]] - env[n.inputs[1]], width)
        elif n.op == "mul":
            env[n.name] = _mul(env[n.inputs[0]], env[n.inputs[1]], width)
        else:  # pragma: no cover
            raise ValueError(f"unknown op {n.op}")
    new_states = {s: env[src] for s, src in graph.updates.items()}
    return new_states, env[graph.output] if graph.output else None


def fixed_forward(program: Program, u, width: int | None = None,
                  device=None) -> torch.Tensor:
    """Fixed-point forward pass on ``device`` (default: the card); returns
    the output **words** (int64 codes).

    Input shapes match the executable backends: mlp ``[B, L]``, recurrent
    ``[B, T, D]``, with a leading stream axis when ``c_slow > 1`` (streams
    are independent, so they ride broadcasting — no interleave loop).
    Divide by ``2**(width-4)`` for real values.
    """
    dev = resolve_device(device)
    spec = program.spec
    W = width if width is not None else (spec.quant_bits or DEFAULT_WIDTH)
    reason = word_bits_reason(W)
    if reason is not None:
        raise ValueError(f"golden model: {reason}")
    is_mlp = program.beta is not None

    stages = []
    for st in program.stages:
        consts = {n.name: _quant(st.params[n.name], W, dev) for n in st.graph.consts()}
        tables = {n.attr("fn"): _af_table(n.attr("fn"), W, dev)
                  for n in st.graph.af_nodes() if n.attr("fn") not in _COMB}
        stages.append((st, consts, tables))

    u_q = _quant(u if isinstance(u, torch.Tensor) else np.asarray(u), W, dev)
    C_q = _quant(program.C, W, dev)  # [P, M]

    if is_mlp:
        beta_q = _quant(program.beta, W, dev)  # [M, L]
        x = _macc(u_q, beta_q.T, W)
        st, consts, tables = stages[0]
        states = {name: x for name in st.graph.states}
        for k in range(st.schedule.steps):
            states, _ = _eval_graph(st.graph, consts, states, None, k, W, tables)
        x_final = states[program.readout_state]
    else:
        T = u_q.shape[-2]
        all_states = [
            {name: torch.zeros(u_q.shape[:-2] + (w_,), dtype=torch.int64, device=dev)
             for name, w_ in st.graph.states.items()}
            for st, _, _ in stages
        ]
        for k in range(T):
            bus = u_q[..., k, :]
            for si, (st, consts, tables) in enumerate(stages):
                all_states[si], bus = _eval_graph(
                    st.graph, consts, all_states[si], bus, k, W, tables)
        x_final = all_states[-1][program.readout_state]
    return _macc(x_final, C_q.T, W)


__all__ = ["fixed_forward", "AF_ADDR_BITS", "DEFAULT_WIDTH"]
