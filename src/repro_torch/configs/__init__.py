"""Config registry: ``get_config(name)`` / ``list_configs()``.

One module per assigned architecture (exact public-literature dims)
plus the paper's own OFA-ResNet conv supernet.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec, shape_applicable

_ARCH_MODULES = (
    "qwen2p5_14b",
    "qwen2_1p5b",
    "h2o_danube_3_4b",
    "stablelm_3b",
    "mixtral_8x7b",
    "llama4_maverick_400b_a17b",
    "zamba2_2p7b",
    "xlstm_125m",
    "ofa_resnet",
)

_REGISTRY: Dict[str, ArchConfig] = {}


def _load() -> None:
    if _REGISTRY:
        return
    for mod_name in _ARCH_MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
        cfg: ArchConfig = mod.CONFIG
        _REGISTRY[cfg.name] = cfg


def get_config(name: str) -> ArchConfig:
    _load()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> List[str]:
    _load()
    return sorted(_REGISTRY)


def assigned_archs() -> List[str]:
    """The 10 graded LM-family architectures (excludes the paper's own)."""
    _load()
    return [n for n in sorted(_REGISTRY) if n != "ofa_resnet"]


__all__ = [
    "ArchConfig", "ShapeSpec", "SHAPES", "shape_applicable",
    "get_config", "list_configs", "assigned_archs",
]
