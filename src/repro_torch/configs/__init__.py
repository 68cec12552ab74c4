"""Architecture registry of the PyTorch port.

A copy of ``repro.configs`` restricted to the architectures the port can
serve so far: the dense ``llama3.2-1b`` and the SSM ``mamba2-2.7b``.
"""
from __future__ import annotations

from .base import (InputShape, INPUT_SHAPES, MLAConfig, MoEConfig, ModelConfig,
                   SSMConfig, HybridConfig)

from . import llama3_2_1b, mamba2_2_7b

ARCHITECTURES: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        llama3_2_1b.CONFIG,
        mamba2_2_7b.CONFIG,
    ]
}


def get_config(name: str) -> ModelConfig:
    try:
        return ARCHITECTURES[name]
    except KeyError:
        raise KeyError(
            f"unknown architecture {name!r}; available: {sorted(ARCHITECTURES)}")


__all__ = [
    "ARCHITECTURES", "INPUT_SHAPES", "ModelConfig", "InputShape", "MoEConfig",
    "MLAConfig", "SSMConfig", "HybridConfig", "get_config",
]
