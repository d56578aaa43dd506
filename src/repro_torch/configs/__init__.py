"""Architecture registry of the port, selectable by ``--arch <id>``.

It lists the architectures the port can build; the reference's other
architectures come with the slices that port their layers (ROADMAP
Queue 1) and raise ``KeyError`` until then."""

from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.model import ModelConfig

_MODULES: Dict[str, str] = {
    "mamba2-370m": "mamba2_370m",
    "hymba-1.5b": "hymba_1_5b",
}

ARCH_NAMES: List[str] = list(_MODULES)


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"arch {name!r} is not ported yet; the port builds "
                       f"{ARCH_NAMES}")
    return importlib.import_module(f"{__name__}.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _mod(name).config()


def get_smoke_config(name: str) -> ModelConfig:
    return _mod(name).smoke_config()
