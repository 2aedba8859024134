"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke_config``.

The reference's eleven architectures, in alphabetical order: MoE
(``deepseek-v2-lite-16b`` with MLA, ``olmoe-1b-7b``), the audio encoder
(``hubert-xlarge``), Mamba-1 (``falcon-mamba-7b``), dense transformers
(``gemma3-27b``, ``internlm2-20b``, ``smollm-135m``, ``phi4-mini-3.8b``),
the VLM (``llama-3.2-vision-90b``), the hybrid (``zamba2-1.2b``) and the
recurrent ``paper-lstm``.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ALL_SHAPES, ModelConfig, ShapeSpec, applicable_shapes

_MODULES = {
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "gemma3-27b": "gemma3_27b",
    "hubert-xlarge": "hubert_xlarge",
    "internlm2-20b": "internlm2_20b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
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
