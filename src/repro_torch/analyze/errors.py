"""Static quantization-error model → per-bus SNR and minimal word length;
the port's counterpart of ``repro/analyze/errors.py``.

The range pass (:mod:`repro_torch.analyze.ranges`) proves word-space amplitudes;
this module propagates **real-space worst-case quantization error** bounds
``eps`` through the same datapath, vectorized over every legal word width
at once.  ``snr = 20·log10(amp / eps)`` is then a *static lower bound* on
the Fig. 11 quantization-SNR axis — no data, no simulation — and the
smallest width whose SNR clears a target is the **minimal safe word
length** per bus, the accuracy half of the tuner's accuracy-vs-area axis.

Error transfer (per node, ``q = 2^-(W-4)`` the LSB, amp the proven real
amplitude):

* input / const words: ``q/2`` (round-to-nearest);
* MACC ``Σ w·x (+b)``:  ``Σ|w|·eps_x + (q/2)·Σ amp_x + (q/2)·n·eps_x``
  (weight-ROM rounding × signal, signal error × weights, cross term)
  ``+ q`` (Q-align floor) ``+ q/2`` (bias ROM);
* AF: ``L·eps_x + L·binw/2 + q/2`` — Lipschitz constant ``L`` (¼ for
  sigmoid, 1 otherwise) over the input error and the 64-entry ROM's bin
  half-width, plus output rounding;
* mul: ``amp_a·eps_b + amp_b·eps_a + eps_a·eps_b + q``;  add/sub: sum.

Every bound is capped at ``2·amp + q`` (an estimate can never be worse
than "completely wrong"), which also makes the state fixpoint converge.
``eps`` is monotone decreasing in width, so SNR is nondecreasing in width
and the minimal word length is monotone in the SNR target.
"""

from __future__ import annotations

import numpy as np

from repro_torch.codegen.knobs import WORD_BITS_MAX, WORD_BITS_MIN
from repro_torch.codegen.verilog import AF_ADDR_BITS, _AF_RANGE, host64

from .intervals import Bd

#: activation Lipschitz constants over the ROM domain
_LIPSCHITZ = {"sigmoid": 0.25, "tanh": 1.0, "relu": 1.0, "identity": 1.0}
#: real width of one AF ROM bin: [-R, R) over 64 entries
_BIN_W = 2.0 * _AF_RANGE / (1 << AF_ADDR_BITS)
#: SNR ceiling so JSON artifacts never carry inf (zero-error buses)
_SNR_CAP_DB = 300.0


def _widths() -> np.ndarray:
    return np.arange(WORD_BITS_MIN, WORD_BITS_MAX + 1)


def _amp_lanes(bd: Bd, scale: float) -> np.ndarray:
    return np.array([max(abs(a), abs(b)) for a, b in zip(bd.lo, bd.hi)],
                    float) / scale


def _colsum_max(w) -> float:
    """max over output lanes (and ROM pages) of Σ_in |w| — the worst-case
    gain of one MACC output lane."""
    a = np.abs(host64(w))
    a = a.reshape(-1, a.shape[-2], a.shape[-1])  # [pages, in, out]
    return float(a.sum(axis=1).max()) if a.size else 0.0


class _EpsModel:
    def __init__(self, program, wires: dict[str, Bd], width: int,
                 input_range: float):
        self.program = program
        self.wires = wires
        self.scale = float(1 << (width - 4))
        self.widths = _widths()
        self.q = 2.0 ** (4.0 - self.widths.astype(float))
        self.input_range = float(input_range)
        self._colsums: dict[tuple[str, str], float] = {}

    def colsum(self, stage, name: str) -> float:
        """:func:`_colsum_max` of one weight ROM, read from its tensor once
        per analysis (the fixpoint asks every iteration)."""
        key = (stage.name, name)
        if key not in self._colsums:
            self._colsums[key] = _colsum_max(stage.params[name])
        return self._colsums[key]

    def amp_lanes(self, stage, name: str) -> np.ndarray:
        n = stage.graph.node(name)
        if n.op == "const":
            a = np.abs(host64(stage.params[name]))
            return a.reshape(-1, a.shape[-1]).max(axis=0)
        return _amp_lanes(self.wires[f"{stage.name}.{name}"], self.scale)

    def amp(self, stage, name: str) -> float:
        lanes = self.amp_lanes(stage, name)
        return float(lanes.max()) if lanes.size else 0.0

    def _cap(self, eps: np.ndarray, amp: float) -> np.ndarray:
        return np.minimum(eps, 2.0 * amp + self.q)

    def macc_eps(self, eps_x: np.ndarray, amp_x_sum: float, n_in: int,
                 colsum: float, has_bias: bool,
                 amp_out: float) -> np.ndarray:
        q = self.q
        eps = (colsum * eps_x + (q / 2.0) * amp_x_sum
               + (q / 2.0) * n_in * eps_x + q)
        if has_bias:
            eps = eps + q / 2.0
        return self._cap(eps, amp_out)

    def graph_eps(self, stage, state_eps: dict, bus_eps: np.ndarray | None):
        """One step of error propagation through ``stage.graph``; returns
        ``(env_eps, new_state_eps, out_eps)`` with per-node ``[n_widths]``
        bounds."""
        g = stage.graph
        q = self.q
        env: dict[str, np.ndarray] = {}
        for n in g.nodes:
            if n.op == "input":
                env[n.name] = bus_eps
            elif n.op == "state":
                env[n.name] = state_eps[n.name]
            elif n.op == "const":
                env[n.name] = q / 2.0
            elif n.op == "macc":
                x = n.inputs[0]
                amp_lanes = self.amp_lanes(stage, x)
                env[n.name] = self.macc_eps(
                    env[x], float(amp_lanes.sum()), g.node(x).width,
                    self.colsum(stage, n.inputs[1]),
                    len(n.inputs) == 3, self.amp(stage, n.name))
            elif n.op == "af":
                fn = n.attr("fn")
                if fn in ("identity", "relu"):  # combinational, exact
                    eps = env[n.inputs[0]]
                else:
                    lip = _LIPSCHITZ.get(fn, 1.0)
                    eps = (lip * env[n.inputs[0]]
                           + lip * _BIN_W / 2.0 + q / 2.0)
                env[n.name] = self._cap(eps, self.amp(stage, n.name))
            elif n.op == "concat":
                env[n.name] = np.maximum.reduce([env[i] for i in n.inputs])
            elif n.op == "slice":
                env[n.name] = env[n.inputs[0]]
            elif n.op in ("add", "sub"):
                env[n.name] = self._cap(
                    env[n.inputs[0]] + env[n.inputs[1]],
                    self.amp(stage, n.name))
            elif n.op == "mul":
                a, b = n.inputs
                ea, eb = env[a], env[b]
                eps = (self.amp(stage, a) * eb + self.amp(stage, b) * ea
                       + ea * eb + q)
                env[n.name] = self._cap(eps, self.amp(stage, n.name))
            else:  # pragma: no cover
                raise ValueError(f"unknown op {n.op}")
        new_state = {s: env[src] for s, src in g.updates.items()}
        out = env[g.output] if g.output is not None else None
        return env, new_state, out


def error_model(program, wires: dict[str, Bd], width: int,
                input_range: float = 1.0, snr_target_db: float = 20.0,
                max_iters: int = 512) -> dict:
    """Attach the eps/SNR/min-width model to proven range ``wires``.

    Returns ``{"wire_stats": {key: {bd, amp_real, eps_real, snr_db,
    min_word_bits}}, "static_snr_db": ..., "min_safe_width": ...}``.
    """
    m = _EpsModel(program, wires, width, input_range)
    q = m.q
    is_mlp = program.beta is not None

    eps_env_final: list[dict] = [{} for _ in program.stages]
    eps_inject = None
    if is_mlp:
        beta = host64(program.beta)                 # [M, L]
        n_in = beta.shape[1]
        amp_x0 = float(_amp_lanes(wires["inject.x0"], m.scale).max())
        eps_inject = m.macc_eps(q / 2.0, n_in * m.input_range, n_in,
                                float(np.abs(beta).sum(axis=1).max()),
                                False, amp_x0)
        state_eps = [{name: eps_inject
                      for name in program.stages[0].graph.states}]
        iter_limit = program.stages[0].schedule.steps
    else:
        state_eps = [{name: np.zeros_like(q) for name in st.graph.states}
                     for st in program.stages]
        iter_limit = max_iters

    for _ in range(max(1, iter_limit)):
        changed = False
        bus = q / 2.0
        for si, st in enumerate(program.stages):
            env, new_state, out = m.graph_eps(st, state_eps[si], bus)
            eps_env_final[si] = env
            for name, eps in new_state.items():
                merged = np.maximum(state_eps[si][name], eps)
                if not np.array_equal(merged, state_eps[si][name]):
                    changed = True
                    state_eps[si][name] = merged
            if out is not None:
                bus = out
        if not changed:
            break

    # readout: y = x_read · Cᵀ
    last = program.stages[-1]
    x_name = program.readout_state
    C = host64(program.C)                           # [P, M]
    eps_x = state_eps[-1][x_name]
    amp_x_lanes = m.amp_lanes(last, x_name)
    amp_y = float(_amp_lanes(wires["readout.y"], m.scale).max())
    eps_y = m.macc_eps(eps_x, float(amp_x_lanes.sum()), C.shape[1],
                       float(np.abs(C).sum(axis=1).max()), False, amp_y)

    def eps_of(key: str) -> np.ndarray:
        if key == "inject.x0":
            return eps_inject
        if key == "readout.y":
            return eps_y
        stage_name, node = key.split(".", 1)
        for si, st in enumerate(program.stages):
            if st.name == stage_name:
                return eps_env_final[si].get(node, q / 2.0)
        return q / 2.0

    widx = width - WORD_BITS_MIN
    wire_stats: dict[str, dict] = {}
    for key, bd in wires.items():
        amp = float(_amp_lanes(bd, m.scale).max()) if bd.lanes else 0.0
        eps = eps_of(key)
        with np.errstate(divide="ignore"):
            snr = np.where(eps > 0, 20.0 * np.log10(
                np.maximum(amp, 0.0) / np.where(eps > 0, eps, 1.0)),
                _SNR_CAP_DB)
        snr = np.minimum(np.where(amp > 0, snr, _SNR_CAP_DB), _SNR_CAP_DB)
        ok = np.nonzero(snr >= snr_target_db)[0]
        wire_stats[key] = {
            "bd": bd,
            "amp_real": amp,
            "eps_real": float(eps[widx]),
            "snr_db": float(snr[widx]),
            "min_word_bits": int(m.widths[ok[0]]) if ok.size else None,
        }
    y_stats = wire_stats["readout.y"]
    return {
        "wire_stats": wire_stats,
        "static_snr_db": y_stats["snr_db"],
        "min_safe_width": y_stats["min_word_bits"],
    }


__all__ = ["error_model"]
