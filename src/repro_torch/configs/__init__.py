"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke_config``.

The recurrent (``paper-lstm``), Mamba-1 (``falcon-mamba-7b``), dense
transformer (``smollm-135m``, ``phi4-mini-3.8b``, ``gemma3-27b``,
``internlm2-20b``), hybrid (``zamba2-1.2b``) and MoE (``olmoe-1b-7b``;
``deepseek-v2-lite-16b`` with MLA) configurations are registered in the
port so far; the other families of the reference's registry
(cross-attention, the audio encoder) come with their blocks.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ALL_SHAPES, ModelConfig, ShapeSpec, applicable_shapes

_MODULES = {
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "gemma3-27b": "gemma3_27b",
    "internlm2-20b": "internlm2_20b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "paper-lstm": "paper_lstm",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "smollm-135m": "smollm_135m",
    "zamba2-1.2b": "zamba2_1_2b",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch '{arch_id}'; available: {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


__all__ = ["ARCH_IDS", "get_config", "get_smoke_config", "ModelConfig", "ShapeSpec",
           "ALL_SHAPES", "applicable_shapes"]
