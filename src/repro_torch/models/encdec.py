"""Whisper-style encoder-decoder backbone (the conv/mel frontend is a stub:
the encoder consumes precomputed frame embeddings).

Counterpart of ``repro.models.encdec``: LayerNorm, plain GELU MLP,
learned decoder positions, sinusoidal encoder positions, no RoPE.  The
encoder's self-attention and the decoder's cross-attention are not
causal and reach the ``flash_attention`` kernel on CUDA tensors with
``causal=False`` (the cross-attention with Sq != Skv); decode attends
through ``decode_attend``.  As in ``models.transformer``: the layer scans
are Python loops, a layer group is stacked or a per-layer list, the
caches are preallocated and written in place, and :func:`init_params`
draws numpy float32 arrays from a seed.  :func:`loss` runs the encoder
and the decoder through the plain attention under autograd, each layer
recomputed in the backward with ``cfg.remat`` (the reference's
``jax.checkpoint`` of both scans).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..distributed.sharding import (hint, is_dtensor, reshape, shard_cache,
                                    write_seq)
from .attention import decode_attend, prefill_attend
from .layers import dot, layer_at, layer_norm, mlp, token_log_likelihood

F32 = torch.float32


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    half = channels // 2
    scale = math.log(10_000) / (half - 1)
    inv = torch.exp(-scale * torch.arange(half, dtype=F32, device=device))
    ang = torch.arange(length, dtype=F32, device=device)[:, None] \
        * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


def init_params(cfg: ModelConfig, seed: int = 0, max_dec: int = 4096,
                make=None) -> Dict:
    """float32 numpy params in the reference's tree, shapes and scales:
    every matrix normal * 0.02 (no depth scaling), ``pos_embed`` normal *
    0.01 with ``max_dec`` rows, layer norms one / zero; the encoder and
    decoder layers stacked on a leading axis.  ``make(shape)``, where
    given, makes every leaf instead and nothing is drawn (the shape-only
    path of ``registry.param_shapes``)."""
    rng = np.random.default_rng(seed)
    d, H, hd, f = cfg.d_model, cfg.num_heads, cfg.hd, cfg.d_ff

    def normal(shape, std):
        if make is not None:
            return make(shape)
        x = rng.standard_normal(shape, dtype=np.float32)
        x *= np.float32(std)
        return x

    def ln(*lead):
        if make is not None:
            return {"scale": make(lead + (d,)), "bias": make(lead + (d,))}
        return {"scale": np.ones(lead + (d,), np.float32),
                "bias": np.zeros(lead + (d,), np.float32)}

    def attn(n, names=("wq", "wk", "wv", "wo")):
        return {names[0]: normal((n, d, H * hd), 0.02),
                names[1]: normal((n, d, H * hd), 0.02),
                names[2]: normal((n, d, H * hd), 0.02),
                names[3]: normal((n, H * hd, d), 0.02)}

    def ffn(n):
        return {"w1": normal((n, d, f), 0.02), "w2": normal((n, f, d), 0.02)}

    E, L = cfg.enc_layers, cfg.num_layers
    params: Dict = {"embed": normal((cfg.vocab, d), 0.02),
                    "pos_embed": normal((max_dec, d), 0.01)}
    params["enc_blocks"] = {"ln1": ln(E), "attn": attn(E), "ln2": ln(E),
                            "mlp": ffn(E)}
    params["enc_norm"] = ln()
    params["dec_blocks"] = {"ln1": ln(L), "attn": attn(L), "lnc": ln(L),
                            "cross": attn(L, ("cq", "ck", "cv", "co")),
                            "ln2": ln(L), "mlp": ffn(L)}
    params["dec_norm"] = ln()
    return params


def _ln(x, p):
    return layer_norm(x, p["scale"], p["bias"])


def _self_attn(h, p, cfg, causal: bool, kernel: bool, cache_kv=None,
               pos: int = 0):
    """Returns (out, (k, v)); in decode, ``cache_kv`` is written in place
    at ``pos``."""
    B, S, _ = h.shape
    H, hd = cfg.num_heads, cfg.hd
    q = reshape(dot(h, p["wq"].to(h.dtype)), B, S, H, hd)
    k = reshape(dot(h, p["wk"].to(h.dtype)), B, S, H, hd).to(h.dtype)
    v = reshape(dot(h, p["wv"].to(h.dtype)), B, S, H, hd).to(h.dtype)
    if cache_kv is None:
        out = prefill_attend(q, k, v, causal=causal, kernel=kernel)
        kv = (k, v)
    else:
        ck, cv = cache_kv
        write_seq(ck, k, pos)
        write_seq(cv, v, pos)
        out = decode_attend(q, ck, cv, kv_len=pos + 1)
        kv = (ck, cv)
    return dot(reshape(out, B, S, H * hd),
               p["wo"].to(h.dtype)).to(h.dtype), kv


def _cross_attn(h, p, cfg, enc_kv, kernel: bool, single: bool = False):
    """Cross-attention to the encoder's k / v: the whole prompt through
    the kernel route (not causal, Sq != Skv), one decode token through
    ``decode_attend`` over the full encoder length."""
    B, S, _ = h.shape
    H, hd = cfg.num_heads, cfg.hd
    q = reshape(dot(h, p["cq"].to(h.dtype)), B, S, H, hd)
    k, v = enc_kv
    if single:
        out = decode_attend(q, k, v, kv_len=k.shape[1], q_pos=k.shape[1])
    else:
        out = prefill_attend(q, k, v, causal=False, kernel=kernel)
    return dot(reshape(out, B, S, H * hd),
               p["co"].to(h.dtype)).to(h.dtype)


def _layers(x, group, n: int, body, cfg: ModelConfig):
    """``x = body(x, lp)`` over the ``n`` layers of a group; with
    ``cfg.remat`` and gradients on, each layer is recomputed in the
    backward instead of keeping its activations."""
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(n):
        lp = layer_at(group, i)
        x = checkpoint(body, x, lp, use_reentrant=False) if remat \
            else body(x, lp)
    return x


def encode(params, cfg: ModelConfig, frames, kernel: bool = True):
    """frames: [B, S, D] precomputed embeddings (frontend stub)."""
    x = frames.to(getattr(torch, cfg.dtype))
    x = x + sinusoids(x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
    x = hint(x, "residual")

    def body(x, lp):
        a, _ = _self_attn(_ln(x, lp["ln1"]), lp["attn"], cfg, causal=False,
                          kernel=kernel)
        x = x + a
        return hint(x + mlp(_ln(x, lp["ln2"]), lp["mlp"], "gelu", False),
                    "residual")

    x = _layers(x, params["enc_blocks"], cfg.enc_layers, body, cfg)
    return _ln(x, params["enc_norm"])


def _dec_embed(params, tokens, pos0: int = 0):
    x = params["embed"][tokens.long()]
    S = tokens.shape[1]
    return x + params["pos_embed"][pos0:pos0 + S][None].to(x.dtype)


def _cross_kv(lp, cfg, enc_out):
    B, S, _ = enc_out.shape
    H, hd = cfg.num_heads, cfg.hd
    k = reshape(dot(enc_out, lp["ck"].to(enc_out.dtype)), B, S, H, hd)
    v = reshape(dot(enc_out, lp["cv"].to(enc_out.dtype)), B, S, H, hd)
    return k.to(enc_out.dtype), v.to(enc_out.dtype)


def _logits(params, x):
    x = _ln(x, params["dec_norm"])
    return dot(x, params["embed"].T.to(x.dtype))


def decode_train(params, cfg: ModelConfig, tokens, enc_out,
                 kernel: bool = True):
    """The decoder over a whole token sequence -> logits [B, S, V]."""
    x = hint(_dec_embed(params, tokens), "residual")

    def body(x, lp):
        a, _ = _self_attn(_ln(x, lp["ln1"]), lp["attn"], cfg, causal=True,
                          kernel=kernel)
        x = x + a
        x = x + _cross_attn(_ln(x, lp["lnc"]), lp["cross"], cfg,
                            _cross_kv(lp["cross"], cfg, enc_out), kernel)
        return hint(x + mlp(_ln(x, lp["ln2"]), lp["mlp"], "gelu", False),
                    "residual")

    x = _layers(x, params["dec_blocks"], cfg.num_layers, body, cfg)
    return hint(_logits(params, x), "logits")


def loss(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Mean next-token cross entropy of the decoder over
    ``batch["labels"]``, the encoder fed ``batch["frames"]``; the plain
    attention throughout, log-softmax in fp32."""
    enc = encode(params, cfg, batch["frames"], kernel=False)
    logits = decode_train(params, cfg, batch["tokens"], enc, kernel=False)
    return -token_log_likelihood(logits, batch["labels"]).mean()


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int,
               dtype=None, device=None) -> Dict:
    """Zeroed cache: self-attention k / v [L, B, max_len, H, hd] and the
    cross-attention's encoder k / v [L, B, enc_len, H, hd]."""
    dtype = dtype or getattr(torch, cfg.dtype)
    L, H, hd = cfg.num_layers, cfg.num_heads, cfg.hd

    def zeros(n):
        return torch.zeros((L, batch, n, H, hd), dtype=dtype, device=device)

    return {"pos": 0, "k": zeros(max_len), "v": zeros(max_len),
            "enc_k": zeros(enc_len), "enc_v": zeros(enc_len)}


def prefill(params, cfg: ModelConfig, frames, tokens,
            max_len: Optional[int] = None, kernel: bool = True
            ) -> Tuple[torch.Tensor, Dict]:
    """Encode the frames, build the cross k / v once, run the decoder
    prompt; returns (last-token logits [B, 1, V], the cache preallocated
    at ``max_len`` and filled to the prompt length)."""
    enc = encode(params, cfg, frames, kernel)
    B, S_dec = tokens.shape
    x = _dec_embed(params, tokens)
    cache = shard_cache(init_cache(
        cfg, B, max_len or S_dec, enc.shape[1], dtype=x.dtype,
        device="meta" if is_dtensor(x) else x.device), x)
    cache["pos"] = S_dec
    for i in range(cfg.num_layers):
        lp = layer_at(params["dec_blocks"], i)
        a, (k, v) = _self_attn(_ln(x, lp["ln1"]), lp["attn"], cfg,
                               causal=True, kernel=kernel)
        write_seq(cache["k"][i], k, 0)
        write_seq(cache["v"][i], v, 0)
        x = x + a
        ekv = _cross_kv(lp["cross"], cfg, enc)
        cache["enc_k"][i], cache["enc_v"][i] = ekv
        x = x + _cross_attn(_ln(x, lp["lnc"]), lp["cross"], cfg, ekv, kernel)
        x = hint(x + mlp(_ln(x, lp["ln2"]), lp["mlp"], "gelu", False),
                 "residual")
    return hint(_logits(params, x[:, -1:]), "logits"), cache


def decode_step(params, cfg: ModelConfig, cache: Dict, tokens):
    """One decode step: tokens [B, 1] -> (logits [B, 1, V], the cache,
    written in place at ``pos`` and advanced by one)."""
    pos = cache["pos"]
    if pos >= cache["k"].shape[2]:
        raise ValueError(f"decode_step: the cache holds "
                         f"{cache['k'].shape[2]} positions and all are "
                         f"filled")
    x = _dec_embed(params, tokens, pos0=pos)
    for i in range(cfg.num_layers):
        lp = layer_at(params["dec_blocks"], i)
        a, _ = _self_attn(_ln(x, lp["ln1"]), lp["attn"], cfg, causal=True,
                          kernel=False, cache_kv=(cache["k"][i],
                                                  cache["v"][i]), pos=pos)
        x = x + a
        x = x + _cross_attn(_ln(x, lp["lnc"]), lp["cross"], cfg,
                            (cache["enc_k"][i], cache["enc_v"][i]),
                            kernel=False, single=True)
        x = x + mlp(_ln(x, lp["ln2"]), lp["mlp"], "gelu", False)
    cache["pos"] = pos + 1
    return hint(_logits(params, x), "logits"), cache
