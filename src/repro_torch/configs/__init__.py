"""Architecture registry of the PyTorch port.

A copy of ``repro.configs``: the port serves every architecture of the
JAX registry. The dense GQA decoders ``llama3.2-1b``, ``qwen2.5-32b``,
``mistral-nemo-12b``, ``internvl2-26b`` and ``musicgen-large``, the SSM
``mamba2-2.7b``, the MLA decoder ``minicpm3-4b``, the MoE decoders
``granite-moe-3b-a800m`` and ``grok-1-314b``, and the hybrid
``recurrentgemma-9b`` (RG-LRU blocks beside local attention).
``internvl2-26b`` and ``musicgen-large`` keep their family and
``num_prefix_embeddings``; the port serves them as plain token models, as
the JAX engine does. ``grok-1-314b`` (316.5 B parameters) does not fit one
80 GB card at full width; it runs at its own head and routing shapes on
smaller widths.
"""
from __future__ import annotations

from .base import (InputShape, INPUT_SHAPES, MLAConfig, MoEConfig, ModelConfig,
                   SSMConfig, HybridConfig)

from . import (qwen2_5_32b, musicgen_large, internvl2_26b, llama3_2_1b,
               mistral_nemo_12b, mamba2_2_7b, minicpm3_4b,
               granite_moe_3b_a800m, grok_1_314b, recurrentgemma_9b)

ARCHITECTURES: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        qwen2_5_32b.CONFIG,
        musicgen_large.CONFIG,
        internvl2_26b.CONFIG,
        llama3_2_1b.CONFIG,
        mistral_nemo_12b.CONFIG,
        mamba2_2_7b.CONFIG,
        minicpm3_4b.CONFIG,
        granite_moe_3b_a800m.CONFIG,
        grok_1_314b.CONFIG,
        recurrentgemma_9b.CONFIG,
    ]
}


def get_config(name: str) -> ModelConfig:
    try:
        return ARCHITECTURES[name]
    except KeyError:
        raise KeyError(
            f"unknown architecture {name!r}; available: {sorted(ARCHITECTURES)}")


def get_shape(name: str) -> InputShape:
    try:
        return INPUT_SHAPES[name]
    except KeyError:
        raise KeyError(f"unknown input shape {name!r}; available: {sorted(INPUT_SHAPES)}")


__all__ = [
    "ARCHITECTURES", "INPUT_SHAPES", "ModelConfig", "InputShape", "MoEConfig",
    "MLAConfig", "SSMConfig", "HybridConfig", "get_config", "get_shape",
]
