"""Weight-only int8 serving (the paper's fixed-point deployment stage,
§III-C/§IV-E, applied to the LM zoo); the port's counterpart of
``repro/runtime/quantized.py``.

The paper chooses a fixed-point word length offline and ships quantized
weights to the FPGA.  The serving equivalent here is weight-only int8:
per-output-channel symmetric int8 weights, dequantized at load time, with
activations in the model's dtype.  ``quantize_lm_params`` and
``dequantize_lm_params`` round-trip any zoo model's tree; the SNR of the
logits against the full-precision model is the metric of the paper's
Fig. 11.  As in the reference, serving dequantizes: the ``int8_matmul``
kernel (int8 activations as well) is not on this path.

Matmul-weight leaves (ndim ≥ 2, both trailing dims ≥ 32, floating point)
are quantized; norms, biases and small SSM tensors stay in their original
dtype (they are <1 % of bytes and precision-critical, the paper's
"mixed-precision" note), and so does any leaf whose ``/``-joined path
names a ``router``: routing logits flip top-k under quantization.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.quantization import dequantize_int8, quantize_int8

PyTree = Any

_MIN_DIM = 32

_EXEMPT = ("router",)  # routing logits flip top-k under quantization; keep f32


def _is_weight(leaf) -> bool:
    return (
        isinstance(leaf, torch.Tensor) and leaf.dim() >= 2
        and leaf.shape[-1] >= _MIN_DIM and leaf.shape[-2] >= _MIN_DIM
        and leaf.is_floating_point()
    )


def quantize_lm_params(params: PyTree) -> tuple[PyTree, dict]:
    """→ (quantized tree, stats).  Weight leaves become ``{"__int8__": int8
    codes, "scale": fp32 per-output-channel (axis −2 kept as 1), "dtype":
    the original dtype's name}``; the stats hold the reference's keys."""
    n_in = n_q = 0
    bytes_in = bytes_q = 0

    def one(leaf, name):
        nonlocal n_in, n_q, bytes_in, bytes_q
        n_in += 1
        nbytes = leaf.numel() * leaf.element_size()
        bytes_in += nbytes
        if not _is_weight(leaf) or any(e in name for e in _EXEMPT):
            bytes_q += nbytes
            return leaf
        # per-output-channel scales: quantize along the contraction dim (-2)
        q, scale = quantize_int8(leaf.to(torch.float32), axis=-2)
        n_q += 1
        bytes_q += q.numel() + scale.numel() * 4
        return {"__int8__": q, "scale": scale, "dtype": str(leaf.dtype).removeprefix("torch.")}

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (str(k),)) for k, v in tree.items()}
        return one(tree, "/".join(path))

    qp = walk(params, ())
    return qp, {"weights_quantized": n_q, "leaves": n_in,
                "bytes_before": bytes_in, "bytes_after": bytes_q,
                "compression": bytes_in / max(bytes_q, 1)}


def _is_qleaf(x) -> bool:
    return isinstance(x, dict) and "__int8__" in x


def dequantize_lm_params(qparams: PyTree) -> PyTree:
    """Reconstruct a dense tree (weight-only int8: dequantize at load)."""
    if _is_qleaf(qparams):
        w = dequantize_int8(qparams["__int8__"], qparams["scale"])
        return w.to(getattr(torch, qparams["dtype"]))
    if isinstance(qparams, dict):
        return {k: dequantize_lm_params(v) for k, v in qparams.items()}
    return qparams


__all__ = ["dequantize_lm_params", "quantize_lm_params"]
