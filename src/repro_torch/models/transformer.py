"""Decoder-only LM covering the dense / moe / ssm / hybrid / vlm families:
init, forward, prefill and decode.

Counterpart of ``repro.models.transformer``.  Layers are grouped into
homogeneous stacks as in the reference (kimi-k2 = its dense first layer,
then the MoE layers; hymba = one group of hybrid attention + mamba
layers).  What differs from the reference:

  * The layer ``lax.scan`` over stacked params is a Python loop over
    layers; the per-layer sliding window is a Python int handed to the
    attention (and to the kernel).
  * The KV cache is preallocated at ``max_len`` by :func:`prefill` and
    written in place (the reference's ``dynamic_update_slice`` returns a
    new array); :func:`decode_step` updates the cache it is given (k / v
    at ``pos``, the conv and SSM states whole) and returns it.
    ``cache["pos"]`` is a Python int.
  * Params are the dicts the serving engine reassembled on the device,
    used as they are (no copy into ``nn.Parameter``s): a model switch
    swaps one dict for another.  A layer group is either a dict of
    tensors stacked on a leading layer axis (the reference's layout) or
    a list of per-layer dicts.
  * :func:`init_params` draws from a numpy ``Generator`` (JAX's PRNG
    cannot be reproduced in torch) with the reference's shapes and
    scales, as float32 arrays; the dtype each leaf is served in is
    decided where the weights are carried over (``repro_torch.convert``).

The encoder-decoder family (whisper) is ``models.encdec``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from .attention import decode_attend, prefill_attend
from .layers import (dot, embed, layer_at, mlp, norm, rms_norm, rotary,
                     unembed)
from .moe import moe_block
from .ssm import mamba_mixer, ssm_dims

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    name: str
    kind: str              # dense | moe | ssm | hybrid
    n: int
    windows: Tuple[int, ...]   # per-layer sliding window (0 = global)


def build_groups(cfg: ModelConfig) -> List[GroupSpec]:
    """The reference's layer groups: one homogeneous stack a group
    (kimi-k2: its dense first layers, then the MoE layers), with the
    per-layer windows (gemma2: every ``window_pattern``-th layer from 0
    local; hymba, ``window_pattern == -3``: the first, middle and last
    layers global)."""
    L = cfg.num_layers

    def windows(n, offset=0):
        ws = []
        for i in range(n):
            li = i + offset
            if cfg.sliding_window == 0:
                ws.append(0)
            elif cfg.window_pattern == -3:     # first/middle/last global
                ws.append(0 if li in (0, L // 2, L - 1)
                          else cfg.sliding_window)
            elif cfg.window_pattern > 0:       # every Nth layer global
                ws.append(cfg.sliding_window if li % cfg.window_pattern == 0
                          else 0)
            else:
                ws.append(cfg.sliding_window)
        return tuple(ws)

    if cfg.family == "ssm":
        return [GroupSpec("blocks", "ssm", L, (0,) * L)]
    if cfg.family == "hybrid":
        return [GroupSpec("blocks", "hybrid", L, windows(L))]
    if cfg.moe is not None:
        groups = []
        fd = cfg.first_dense_layers
        if fd:
            groups.append(GroupSpec("dense_blocks", "dense", fd,
                                    windows(fd)))
        groups.append(GroupSpec("blocks", "moe", L - fd,
                                windows(L - fd, fd)))
        return groups
    return [GroupSpec("blocks", "dense", L, windows(L))]


# ------------------------------------------------------------------- init ---
def init_params(cfg: ModelConfig, seed: int = 0) -> Dict:
    """float32 numpy params in the reference's tree, shapes and scales
    (normal * 0.02; ``wo``, ``w2``, ``ew2``, ``dw2`` and ``out_proj`` also
    / sqrt(2 L); norms zero for rms, one for layer norm; qkv biases zero;
    mamba's ``dt`` log-uniform in [1e-3, 1e-1] stored as
    ``log(expm1(dt))``, ``A_log = log(1..H)``, ``Dp`` ones, ``ssm_norm``
    zeros), every group stacked on a leading layer axis."""
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

    def attn_params(n):
        p = {"wq": normal((n, d, H * hd), 0.02),
             "wk": normal((n, d, K * hd), 0.02),
             "wv": normal((n, d, K * hd), 0.02),
             "wo": normal((n, H * hd, d), out_scale)}
        if cfg.qkv_bias:
            p["bq"] = np.zeros((n, H * hd), np.float32)
            p["bk"] = np.zeros((n, K * hd), np.float32)
            p["bv"] = np.zeros((n, K * hd), np.float32)
        if cfg.qk_norm:
            p["q_norm"] = np.zeros((n, hd), np.float32)
            p["k_norm"] = np.zeros((n, hd), np.float32)
        return p

    def mlp_params(n, f, prefix=""):
        p = {prefix + "w1": normal((n, d, f), 0.02),
             prefix + "w2": normal((n, f, d), out_scale)}
        if cfg.gated_mlp:
            p[prefix + "w3"] = normal((n, d, f), 0.02)
        return p

    def moe_params(n):
        m = cfg.moe
        E, f = m.num_experts, m.d_ff
        p = {"router": normal((n, d, E), 0.02),
             "ew1": normal((n, E, d, f), 0.02),
             "ew2": normal((n, E, f, d), out_scale)}
        if cfg.gated_mlp:
            p["ew3"] = normal((n, E, d, f), 0.02)
        if m.dense_ff:
            p.update(mlp_params(n, m.dense_ff, "d"))
        return p

    def mamba_params(n):
        s = cfg.ssm
        din, nh, conv_ch = ssm_dims(d, s)
        gn = s.n_groups * s.d_state
        dt = np.exp(rng.uniform(math.log(1e-3), math.log(1e-1), (n, nh))
                    ).astype(np.float32)
        return {
            "in_proj": normal((n, d, 2 * din + 2 * gn + nh), 0.02),
            "out_proj": normal((n, din, d), out_scale),
            "conv_w": normal((n, s.d_conv, conv_ch), 0.02),
            "conv_b": np.zeros((n, conv_ch), np.float32),
            "dt_bias": np.log(np.expm1(dt)).astype(np.float32),
            "A_log": np.tile(np.log(np.arange(1, nh + 1, dtype=np.float32)),
                             (n, 1)),
            "Dp": np.ones((n, nh), np.float32),
            "ssm_norm": np.zeros((n, din), np.float32),
        }

    def layer_params(kind, n):
        p: Dict = {"ln1": norm_params(n)}
        if kind == "ssm":
            p["mamba"] = mamba_params(n)
            return p
        p["attn"] = attn_params(n)
        if kind == "hybrid":
            p["mamba"] = mamba_params(n)
        p["ln2"] = norm_params(n)
        if kind == "moe":
            p["moe"] = moe_params(n)
        else:
            p["mlp"] = mlp_params(n, cfg.d_ff)
        return p

    # the layers are drawn before the embedding and the head (the dense
    # family's draw order since its slice)
    params: Dict = {g.name: layer_params(g.kind, g.n)
                    for g in build_groups(cfg)}
    params["embed"] = normal((cfg.vocab, d), 0.02)
    params["final_norm"] = norm_params()
    if not cfg.tie_embeddings:
        params["head"] = normal((d, cfg.vocab), 0.02)
    return params


# ---------------------------------------------------------------- forward ---
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


def _block(x, lp, window: int, cfg: ModelConfig, kind: str, positions,
           kernel: bool, cache=None, pos: int = 0):
    """One layer body.  ``cache``: this layer's cache views (decode, the
    k / v cache written in place at ``pos``) or None.  Returns (x, ys),
    ys holding this layer's cache material: k and v (prefill), the conv
    and SSM states."""
    h = norm(x, lp["ln1"], cfg.norm_type, cfg.norm_eps)
    ys: Dict = {}
    if kind in ("ssm", "hybrid"):
        m, (cst, sst) = mamba_mixer(
            h, lp["mamba"], cfg.d_model, cfg.ssm,
            conv_state=None if cache is None else cache["conv_state"],
            ssm_state=None if cache is None else cache["ssm_state"],
            decode=cache is not None)
        ys["conv_state"], ys["ssm_state"] = cst, sst
        if kind == "ssm":
            return x + m, ys
    a, (ys["k"], ys["v"]) = _attention(
        h, lp["attn"], cfg, positions, window, kernel,
        cache_kv=None if cache is None else (cache["k"], cache["v"]),
        pos=pos)
    x = x + 0.5 * (a + m) if kind == "hybrid" else x + a
    h2 = norm(x, lp["ln2"], cfg.norm_type, cfg.norm_eps)
    if kind == "moe":
        y = moe_block(h2, lp["moe"], cfg.moe, cfg.act, cfg.gated_mlp)
    else:
        y = mlp(h2, lp["mlp"], cfg.act, cfg.gated_mlp)
    return x + y.to(x.dtype), ys


def _run_group(x, gparams, g: GroupSpec, cfg: ModelConfig, positions,
               kernel: bool, cache=None, pos: int = 0, fill=None):
    """The layers of one group.  ``cache`` (decode): the group's cache,
    read at ``pos`` and written in place; ``fill`` (prefill): the group's
    fresh cache, whose first S positions receive each layer's k and v and
    whose states receive each layer's final conv and SSM states."""
    for i in range(g.n):
        c = None if cache is None else {k: v[i] for k, v in cache.items()}
        x, ys = _block(x, layer_at(gparams, i), g.windows[i], cfg, g.kind,
                       positions, kernel, cache=c, pos=pos)
        if fill is not None and "k" in ys:
            S = ys["k"].shape[1]
            fill["k"][i, :, :S] = ys["k"]
            fill["v"][i, :, :S] = ys["v"]
        states = fill if fill is not None else cache
        if states is not None and "ssm_state" in ys:
            states["conv_state"][i] = ys["conv_state"]
            states["ssm_state"][i] = ys["ssm_state"]
    return x


def _head(params, cfg: ModelConfig):
    return params["embed"] if cfg.tie_embeddings else params["head"]


def _embed_inputs(params, cfg: ModelConfig, tokens, img_embeds=None):
    """Token embeddings; the VLM stub puts the patch embeddings first."""
    x = embed(tokens, params["embed"], cfg.embed_scale)
    if cfg.vlm_stub and img_embeds is not None:
        x = torch.cat([img_embeds.to(x.dtype), x], dim=1)
    return x


def forward(params, cfg: ModelConfig, tokens, img_embeds=None,
            kernel: bool = True):
    """Eval forward -> logits [B, S_total, V] (S_total counts the image
    patches of the VLM stub)."""
    x = _embed_inputs(params, cfg, tokens, img_embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for g in build_groups(cfg):
        x = _run_group(x, params[g.name], g, cfg, positions, kernel)
    x = norm(x, params["final_norm"], cfg.norm_type, cfg.norm_eps)
    return unembed(x, _head(params, cfg), cfg.tie_embeddings,
                   cfg.final_softcap)


# ---------------------------------------------------------------- serving ---
def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None) -> Dict:
    """Zeroed decode cache; ``pos`` tracks the filled length.  Attention
    groups hold k / v [n, B, max_len, K, hd]; ssm and hybrid groups the
    conv tail [n, B, d_conv-1, conv_ch] (model dtype) and the SSM state
    [n, B, H, hd, N] (fp32)."""
    dtype = dtype or getattr(torch, cfg.dtype)
    cache: Dict = {"pos": 0}
    for g in build_groups(cfg):
        c: Dict = {}
        if g.kind in ("dense", "moe", "hybrid"):
            c["k"] = torch.zeros((g.n, batch, max_len, cfg.kv_heads,
                                  cfg.hd), dtype=dtype, device=device)
            c["v"] = torch.zeros_like(c["k"])
        if g.kind in ("ssm", "hybrid"):
            din, H, conv_ch = ssm_dims(cfg.d_model, cfg.ssm)
            c["conv_state"] = torch.zeros(
                (g.n, batch, cfg.ssm.d_conv - 1, conv_ch), dtype=dtype,
                device=device)
            c["ssm_state"] = torch.zeros(
                (g.n, batch, H, cfg.ssm.head_dim, cfg.ssm.d_state),
                dtype=F32, device=device)
        cache[g.name] = c
    return cache


def prefill(params, cfg: ModelConfig, tokens, max_len: Optional[int] = None,
            kernel: bool = True, img_embeds=None):
    """Process the prompt (after the image patches of the VLM stub);
    returns (last-token logits [B, 1, V], a cache preallocated at
    ``max_len`` and filled to the prompt length)."""
    x = _embed_inputs(params, cfg, tokens, img_embeds)
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
    written in place at ``pos`` (k / v) and in its conv and SSM states,
    and advanced by one)."""
    pos = cache["pos"]
    groups = build_groups(cfg)
    for g in groups:
        if "k" in cache[g.name] and pos >= cache[g.name]["k"].shape[2]:
            raise ValueError(f"decode_step: the cache holds "
                             f"{cache[g.name]['k'].shape[2]} positions and "
                             f"all are filled")
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
