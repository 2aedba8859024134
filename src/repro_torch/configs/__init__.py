"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke_config``.

The recurrent (``paper-lstm``), Mamba-1 (``falcon-mamba-7b``) and dense
transformer (``smollm-135m``, ``phi4-mini-3.8b``) configurations are
registered in the port so far; the other families of the reference's
registry come with their blocks.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "falcon-mamba-7b": "falcon_mamba_7b",
    "paper-lstm": "paper_lstm",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "smollm-135m": "smollm_135m",
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


__all__ = ["ARCH_IDS", "get_config", "get_smoke_config", "ModelConfig"]
