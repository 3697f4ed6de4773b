"""Unified model API: ``build(cfg)`` returns the callables that the
trainer and the serving engine drive.

Counterpart of ``repro.models.registry`` with the reference's call
signatures — ``init(seed, max_dec)``, ``loss(params, batch)``,
``prefill(params, batch, max_len)`` and ``decode(params, cache,
tokens)`` — so the trainer and the engine are line-for-line ports.
``init`` returns the port's numpy float32 tree (``init_params``; the
reference draws from JAX's PRNG, which torch cannot reproduce), which
``repro_torch.convert`` turns into tensors to train (``train_params``)
or to serve (``lm_tensors``).  ``loss`` is differentiable and always
runs the plain ``attend``, as the reference's does: the kernels have no
backward.  ``attention="kernel"`` (default) runs prefill attention
through the hand-written ``flash_attention`` kernel on CUDA tensors;
``attention="plain"`` asks for the plain ``attend`` everywhere (the
oracle a run on the card is held against).  The encoder-decoder family
(``cfg.encdec``) prefills from ``{"frames", "tokens"}`` and trains on
``{"frames", "tokens", "labels"}``; the VLM stub takes
``image_embeds`` beside the tokens.  The dry-run helpers
(``input_specs``, ``param_shapes``) come with the dry-run slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from ..configs.base import ModelConfig
from . import encdec, transformer

ATTENTION = ("kernel", "plain")


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable                 # (seed, max_dec) -> numpy fp32 tree
    loss: Callable                 # (params, batch) -> scalar
    forward: Callable              # (params, tokens, extra) -> logits
    prefill: Callable              # (params, batch, max_len) -> (logits, cache)
    decode: Callable               # (params, cache, tokens) -> (logits, cache)


def build(cfg: ModelConfig, attention: str = "kernel") -> ModelAPI:
    """Every family of the reference's registry.  ``forward``'s third
    argument is the encoder-decoder's ``frames`` (required) or the VLM
    stub's ``image_embeds`` (optional); a prefill batch holds
    ``tokens`` and, where the family takes them, ``frames`` or
    ``image_embeds``."""
    if attention not in ATTENTION:
        raise ValueError(f"unknown attention {attention!r}; have "
                         f"{ATTENTION}")
    kernel = attention == "kernel"
    if cfg.encdec:
        return ModelAPI(
            cfg=cfg,
            init=lambda seed=0, max_dec=4096: encdec.init_params(
                cfg, seed, max_dec),
            loss=lambda p, b: encdec.loss(p, cfg, b),
            forward=lambda p, tokens, frames: encdec.decode_train(
                p, cfg, tokens, encdec.encode(p, cfg, frames, kernel),
                kernel),
            prefill=lambda p, b, max_len=None: encdec.prefill(
                p, cfg, b["frames"], b["tokens"], max_len, kernel=kernel),
            decode=lambda p, c, t: encdec.decode_step(p, cfg, c, t),
        )
    return ModelAPI(
        cfg=cfg,
        init=lambda seed=0, max_dec=0: transformer.init_params(cfg, seed),
        loss=lambda p, b: transformer.loss(p, cfg, b),
        forward=lambda p, tokens, image_embeds=None: transformer.forward(
            p, cfg, tokens, image_embeds, kernel=kernel),
        prefill=lambda p, b, max_len=None: transformer.prefill(
            p, cfg, b["tokens"], max_len, kernel=kernel,
            img_embeds=b.get("image_embeds")),
        decode=lambda p, c, t: transformer.decode_step(p, cfg, c, t,
                                                       kernel=kernel),
    )
