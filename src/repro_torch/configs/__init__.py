"""Architecture registry of the port, selectable by ``--arch <id>``: the
reference's ten architectures, in its order."""

from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.model import ModelConfig

_MODULES: Dict[str, str] = {
    "hymba-1.5b": "hymba_1_5b",
    "nemotron-4-15b": "nemotron_4_15b",
    "stablelm-3b": "stablelm_3b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "starcoder2-15b": "starcoder2_15b",
    "hubert-xlarge": "hubert_xlarge",
    "mamba2-370m": "mamba2_370m",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "qwen2-vl-7b": "qwen2_vl_7b",
}

ARCH_NAMES: List[str] = list(_MODULES)


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port builds "
                       f"{ARCH_NAMES}")
    return importlib.import_module(f"{__name__}.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _mod(name).config()


def get_smoke_config(name: str) -> ModelConfig:
    return _mod(name).smoke_config()
