"""Decoder-only LM, dense family: init, forward, prefill and decode.

Counterpart of ``repro.models.transformer`` for the dense transformer
(deepseek, gemma2, qwen2, qwen3).  What differs from the reference:

  * The layer ``lax.scan`` over stacked params is a Python loop over
    layers; the per-layer sliding window is a Python int handed to the
    attention (and to the kernel).
  * The KV cache is preallocated at ``max_len`` by :func:`prefill` and
    written in place (the reference's ``dynamic_update_slice`` returns a
    new array); :func:`decode_step` updates the cache it is given and
    returns it.  ``cache["pos"]`` is a Python int.
  * Params are the dicts the serving engine reassembled on the device,
    used as they are (no copy into ``nn.Parameter``s): a model switch
    swaps one dict for another.  A layer group is either a dict of
    tensors stacked on a leading layer axis (the reference's layout) or
    a list of per-layer dicts.
  * :func:`init_params` draws from a numpy ``Generator`` (JAX's PRNG
    cannot be reproduced in torch) with the reference's shapes and
    scales, as float32 arrays; the dtype each leaf is served in is
    decided where the weights are carried over (``repro_torch.convert``).

The MoE, SSM, hybrid, encoder-decoder and vision families are later
slices of the port and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from .attention import decode_attend, prefill_attend
from .layers import dot, embed, mlp, norm, rms_norm, rotary, unembed

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    name: str
    kind: str              # dense (the families of later slices add more)
    n: int
    windows: Tuple[int, ...]   # per-layer sliding window (0 = global)


def check_supported(cfg: ModelConfig) -> None:
    """The dense family only: the others are later slices of the port."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is a later slice of the "
            f"port (moe, ssm, hybrid, encdec and vlm follow the dense "
            f"transformer)")


def build_groups(cfg: ModelConfig) -> List[GroupSpec]:
    """One group of the dense layers, with the reference's per-layer
    windows (gemma2: every ``window_pattern``-th layer from 0 local)."""
    check_supported(cfg)
    ws = []
    for li in range(cfg.num_layers):
        if cfg.sliding_window == 0:
            ws.append(0)
        elif cfg.window_pattern > 0:           # every Nth layer global
            ws.append(cfg.sliding_window if li % cfg.window_pattern == 0
                      else 0)
        else:
            ws.append(cfg.sliding_window)
    return [GroupSpec("blocks", "dense", cfg.num_layers, tuple(ws))]


# ------------------------------------------------------------------- init ---
def init_params(cfg: ModelConfig, seed: int = 0) -> Dict:
    """float32 numpy params in the reference's tree, shapes and scales
    (normal * 0.02; ``wo`` and ``w2`` also / sqrt(2 L); norms zero for
    rms, one for layer norm; qkv biases zero)."""
    check_supported(cfg)
    rng = np.random.default_rng(seed)
    d, H, K, hd, L = (cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.hd,
                      cfg.num_layers)
    out_scale = 0.02 / math.sqrt(2 * L)

    def normal(shape, std):
        x = rng.standard_normal(shape, dtype=np.float32)
        x *= np.float32(std)
        return x

    def norm_params(*lead):
        fill = np.zeros if cfg.norm_type == "rms" else np.ones
        p = {"scale": fill(lead + (d,), np.float32)}
        if cfg.norm_type == "layer":
            p["bias"] = np.zeros(lead + (d,), np.float32)
        return p

    attn = {"wq": normal((L, d, H * hd), 0.02),
            "wk": normal((L, d, K * hd), 0.02),
            "wv": normal((L, d, K * hd), 0.02),
            "wo": normal((L, H * hd, d), out_scale)}
    if cfg.qkv_bias:
        attn["bq"] = np.zeros((L, H * hd), np.float32)
        attn["bk"] = np.zeros((L, K * hd), np.float32)
        attn["bv"] = np.zeros((L, K * hd), np.float32)
    if cfg.qk_norm:
        attn["q_norm"] = np.zeros((L, hd), np.float32)
        attn["k_norm"] = np.zeros((L, hd), np.float32)
    ffn = {"w1": normal((L, d, cfg.d_ff), 0.02),
           "w2": normal((L, cfg.d_ff, d), out_scale)}
    if cfg.gated_mlp:
        ffn["w3"] = normal((L, d, cfg.d_ff), 0.02)
    params: Dict = {"embed": normal((cfg.vocab, d), 0.02),
                    "final_norm": norm_params()}
    if not cfg.tie_embeddings:
        params["head"] = normal((d, cfg.vocab), 0.02)
    params["blocks"] = {"ln1": norm_params(L), "attn": attn,
                        "ln2": norm_params(L), "mlp": ffn}
    return params


# ---------------------------------------------------------------- forward ---
def _layer(gparams, i: int):
    """Layer ``i`` of a group: an entry of a per-layer list, or a view of
    every stacked tensor at index ``i``."""
    if isinstance(gparams, (list, tuple)):
        return gparams[i]
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in gparams.items()}


def _attention(h, p, cfg: ModelConfig, positions, window: int,
               kernel: bool, cache_kv=None, pos: int = 0):
    """Returns (attn_out, (k, v)); in decode, ``cache_kv`` is written in
    place at ``pos`` and returned."""
    B, S, _ = h.shape
    H, K, hd = cfg.num_heads, cfg.kv_heads, cfg.hd
    q = dot(h, p["wq"].to(h.dtype))
    k = dot(h, p["wk"].to(h.dtype))
    v = dot(h, p["wv"].to(h.dtype))
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, K, hd)
    v = v.reshape(B, S, K, hd).to(h.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rotary(q, positions, cfg.rope_theta)
    k = rotary(k, positions, cfg.rope_theta).to(h.dtype)

    if cache_kv is None:                       # forward / prefill
        out = prefill_attend(q, k, v, window=window,
                             softcap=cfg.attn_softcap, kernel=kernel)
        new_kv = (k, v)
    else:                                      # decode: append then attend
        ck, cv = cache_kv
        # in place into the preallocated cache (the reference returns an
        # updated copy)
        ck[:, pos:pos + S] = k
        cv[:, pos:pos + S] = v
        out = decode_attend(q, ck, cv, kv_len=pos + 1, window=window,
                            softcap=cfg.attn_softcap)
        new_kv = (ck, cv)
    out = dot(out.reshape(B, S, H * hd), p["wo"].to(h.dtype))
    return out.to(h.dtype), new_kv


def _block(x, lp, window: int, cfg: ModelConfig, positions, kernel: bool,
           cache_kv=None, pos: int = 0):
    h = norm(x, lp["ln1"], cfg.norm_type, cfg.norm_eps)
    a, kv = _attention(h, lp["attn"], cfg, positions, window, kernel,
                       cache_kv=cache_kv, pos=pos)
    x = x + a
    h2 = norm(x, lp["ln2"], cfg.norm_type, cfg.norm_eps)
    y = mlp(h2, lp["mlp"], cfg.act, cfg.gated_mlp)
    return x + y.to(x.dtype), kv


def _run_group(x, gparams, g: GroupSpec, cfg: ModelConfig, positions,
               kernel: bool, cache=None, pos: int = 0, fill=None):
    """The layers of one group.  ``cache`` (decode): the group's cache,
    read and written at ``pos``; ``fill`` (prefill): the group's fresh
    cache, whose first S positions receive each layer's k and v."""
    for i in range(g.n):
        c = None if cache is None else (cache["k"][i], cache["v"][i])
        x, (k, v) = _block(x, _layer(gparams, i), g.windows[i], cfg,
                           positions, kernel, cache_kv=c, pos=pos)
        if fill is not None:
            S = k.shape[1]
            fill["k"][i, :, :S] = k
            fill["v"][i, :, :S] = v
    return x


def _head(params, cfg: ModelConfig):
    return params["embed"] if cfg.tie_embeddings else params["head"]


def forward(params, cfg: ModelConfig, tokens, kernel: bool = True):
    """Eval forward -> logits [B, S, V]."""
    x = embed(tokens, params["embed"], cfg.embed_scale)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for g in build_groups(cfg):
        x = _run_group(x, params[g.name], g, cfg, positions, kernel)
    x = norm(x, params["final_norm"], cfg.norm_type, cfg.norm_eps)
    return unembed(x, _head(params, cfg), cfg.tie_embeddings,
                   cfg.final_softcap)


# ---------------------------------------------------------------- serving ---
def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None) -> Dict:
    """Zeroed decode cache; ``pos`` tracks the filled length."""
    dtype = dtype or getattr(torch, cfg.dtype)
    cache: Dict = {"pos": 0}
    for g in build_groups(cfg):
        k = torch.zeros((g.n, batch, max_len, cfg.kv_heads, cfg.hd),
                        dtype=dtype, device=device)
        cache[g.name] = {"k": k, "v": torch.zeros_like(k)}
    return cache


def prefill(params, cfg: ModelConfig, tokens, max_len: Optional[int] = None,
            kernel: bool = True):
    """Process the prompt; returns (last-token logits [B, 1, V], a cache
    preallocated at ``max_len`` and filled to the prompt length)."""
    x = embed(tokens, params["embed"], cfg.embed_scale)
    B, S, _ = x.shape
    max_len = max_len or S
    positions = torch.arange(S, device=x.device)[None, :]
    cache = init_cache(cfg, B, max_len, dtype=x.dtype, device=x.device)
    cache["pos"] = S
    for g in build_groups(cfg):
        x = _run_group(x, params[g.name], g, cfg, positions, kernel,
                       fill=cache[g.name])
    x = norm(x, params["final_norm"], cfg.norm_type, cfg.norm_eps)
    logits = unembed(x[:, -1:], _head(params, cfg), cfg.tie_embeddings,
                     cfg.final_softcap)
    return logits, cache


def decode_step(params, cfg: ModelConfig, cache: Dict, tokens,
                kernel: bool = True):
    """One decode step: tokens [B, 1] -> (logits [B, 1, V], the cache,
    written in place at ``pos`` and advanced by one)."""
    pos = cache["pos"]
    groups = build_groups(cfg)
    max_len = cache[groups[0].name]["k"].shape[2]
    if pos >= max_len:
        raise ValueError(f"decode_step: the cache holds {max_len} "
                         f"positions and all are filled")
    x = embed(tokens, params["embed"], cfg.embed_scale)
    positions = torch.full((x.shape[0], 1), pos, device=x.device)
    for g in groups:
        x = _run_group(x, params[g.name], g, cfg, positions, kernel,
                       cache=cache[g.name], pos=pos)
    cache["pos"] = pos + 1
    x = norm(x, params["final_norm"], cfg.norm_type, cfg.norm_eps)
    logits = unembed(x, _head(params, cfg), cfg.tie_embeddings,
                     cfg.final_softcap)
    return logits, cache
