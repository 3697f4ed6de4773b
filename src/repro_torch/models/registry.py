"""Unified model API: ``build(cfg)`` returns the callables the serving
engine drives.

Counterpart of ``repro.models.registry`` with the reference's call
signatures — ``prefill(params, batch, max_len)`` and
``decode(params, cache, tokens)`` — so the engine is a line-for-line
port.  ``attention="kernel"`` (default) runs prefill attention through
the hand-written ``flash_attention`` kernel on CUDA tensors;
``attention="plain"`` asks for the plain ``attend`` everywhere (the
oracle a run on the card is held against).  Weights come from
``transformer.init_params`` or ``repro_torch.convert``; the dry-run
helpers (``input_specs``, ``param_shapes``) come with the dry-run slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from ..configs.base import ModelConfig
from . import transformer

ATTENTION = ("kernel", "plain")


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    forward: Callable              # (params, tokens) -> logits
    prefill: Callable              # (params, batch, max_len) -> (logits, cache)
    decode: Callable               # (params, cache, tokens) -> (logits, cache)


def build(cfg: ModelConfig, attention: str = "kernel") -> ModelAPI:
    if attention not in ATTENTION:
        raise ValueError(f"unknown attention {attention!r}; have "
                         f"{ATTENTION}")
    transformer.check_supported(cfg)
    kernel = attention == "kernel"
    return ModelAPI(
        cfg=cfg,
        forward=lambda p, tokens: transformer.forward(p, cfg, tokens,
                                                      kernel=kernel),
        prefill=lambda p, b, max_len=None: transformer.prefill(
            p, cfg, b["tokens"], max_len, kernel=kernel),
        decode=lambda p, c, t: transformer.decode_step(p, cfg, c, t,
                                                       kernel=kernel),
    )
