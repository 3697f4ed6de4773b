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
``image_embeds`` beside the tokens.  ``init_cache(batch, max_len,
enc_len)`` is a zeroed decode cache.  The dry-run helpers
:func:`input_specs` and :func:`param_shapes` give tensors of each
cell's shapes and the reference's dtypes without drawing or allocating
anything: meta tensors, or fake ones under an active ``FakeTensorMode``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from ..configs.base import ModelConfig, ShapeSpec
from . import encdec, transformer

ATTENTION = ("kernel", "plain")
WHISPER_DEC_LEN = 448          # whisper decoder context (prompt length)
WHISPER_ENC_LEN = 1500         # encoder frames for decode cells


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable                 # (seed, max_dec) -> numpy fp32 tree
    loss: Callable                 # (params, batch) -> scalar
    forward: Callable              # (params, tokens, extra) -> logits
    prefill: Callable              # (params, batch, max_len) -> (logits, cache)
    decode: Callable               # (params, cache, tokens) -> (logits, cache)
    init_cache: Callable           # (batch, max_len, enc_len) -> cache


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
            init_cache=lambda batch, max_len, enc_len=WHISPER_ENC_LEN,
            **kw: encdec.init_cache(cfg, batch, max_len, enc_len, **kw),
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
        init_cache=lambda batch, max_len, enc_len=0, **kw:
            transformer.init_cache(cfg, batch, max_len, **kw),
    )


# ------------------------------------------------------------ input specs ---
def _sds(shape, dtype, device):
    return torch.empty(tuple(shape), dtype=getattr(torch, str(dtype)),
                       device=device)


def input_specs(cfg: ModelConfig, spec: ShapeSpec,
                device="meta") -> Dict:
    """Batch tensors of one (arch x shape) cell, with the reference's
    keys, shapes and dtypes.

    ``train``:  token/label batch (modality stubs included).
    ``prefill``: prompt batch.
    ``decode``:  one new token + a cache of ``seq_len`` positions, whose
    ``pos`` is a 0-d int32 tensor as in the reference (the port's decode
    takes it as a Python int).
    """
    B, S = spec.global_batch, spec.seq_len
    d = cfg.d_model
    act_dt = cfg.dtype

    dec_len = min(WHISPER_DEC_LEN, S)
    if spec.kind in ("train", "prefill"):
        if cfg.encdec:
            out = {"frames": _sds((B, S, d), act_dt, device),
                   "tokens": _sds((B, dec_len), "int32", device)}
            n = dec_len
        elif cfg.vlm_stub:
            P = cfg.num_patches
            out = {"tokens": _sds((B, S - P), "int32", device),
                   "image_embeds": _sds((B, P, d), act_dt, device)}
            n = S - P
        else:
            out = {"tokens": _sds((B, S), "int32", device)}
            n = S
        if spec.kind == "train":
            out["labels"] = _sds((B, n), "int32", device)
        return out

    # decode: one token against a seq_len cache
    cache = build(cfg).init_cache(B, S, device=device)
    cache["pos"] = _sds((), "int32", device)
    return {"tokens": _sds((B, 1), "int32", device), "cache": cache}


def param_shapes(cfg: ModelConfig, spec: Optional[ShapeSpec] = None,
                 device="meta"):
    """The params tree of ``cfg`` as tensors of the reference's shapes and
    dtypes (``cfg.dtype``, float32 for the norm-like leaves of
    ``convert.F32_LEAVES``), drawn from nothing: ``init_params``'
    shape-only path, so a full-size config costs no memory."""
    from ..convert import F32_LEAVES
    max_dec = spec.seq_len if (spec and cfg.encdec) else 4096

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        dt = "float32" if name in F32_LEAVES else cfg.dtype
        return _sds(tree, dt, device)

    if cfg.encdec:
        shapes = encdec.init_params(cfg, max_dec=max_dec, make=tuple)
    else:
        shapes = transformer.init_params(cfg, make=tuple)
    return walk(shapes)
