"""Architecture registry: ``get_config(arch_id)`` / ``list_archs()``."""
from importlib import import_module
from typing import Dict, List

from .base import (ModelConfig, MoEConfig, SHAPES, ShapeSpec, SSMConfig,
                   reduced, shape_supported)

_MODULES = {
    "phi-3-vision-4.2b": ".phi3_vision_4_2b",
    "gemma2-9b": ".gemma2_9b",
    "qwen3-14b": ".qwen3_14b",
    "qwen2-72b": ".qwen2_72b",
    "deepseek-7b": ".deepseek_7b",
    "hymba-1.5b": ".hymba_1_5b",
    "whisper-small": ".whisper_small",
    "arctic-480b": ".arctic_480b",
    "kimi-k2-1t-a32b": ".kimi_k2_1t_a32b",
    "mamba2-1.3b": ".mamba2_1_3b",
}


def list_archs() -> List[str]:
    return list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    try:
        mod = _MODULES[arch]
    except KeyError:
        raise ValueError(f"unknown arch {arch!r}; known: {list_archs()}") from None
    return import_module(mod, __package__).CONFIG


__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "SHAPES", "ShapeSpec",
           "get_config", "list_archs", "reduced", "shape_supported"]
