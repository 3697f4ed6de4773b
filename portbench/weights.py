"""The served weights of a configuration, drawn from its ``store_seed``.

Both sides take them from here: the store build registers them into the
program's database (once per checkout), and the reference draws them
again after the window.  Nothing is read back from the store.

The tree is the one the program's LM path loads (``repro_torch.convert.
lm_tensors``): layer leaves stacked on a leading layer axis under
``blocks``, then ``embed``, ``final_norm`` and ``head``.  Matrices are
served in bfloat16, so they are drawn in float32 and rounded to it;
norm scales and the mixer's scalars stay float32, as the program serves
them.  A variant redraws the per-layer slices its configuration lists
(``"blocks/1/mlp/w1"``).

The draw runs on ``device`` with a ``torch.Generator`` there, in one
``randn`` for every normal leaf of a variant (and one ``rand`` for the
mixer's time steps), so it takes a fraction of a second on the card.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

#: leaves the program serves in float32 (its ``convert.F32_LEAVES`` of
#: this tree): norm scales and the mixer's scalars
F32_LEAVES = ("scale", "dt_bias", "A_log", "Dp", "ssm_norm")

Path = Tuple[str, ...]


def dims(cfg: Dict) -> Dict[str, int]:
    """The sizes the layout and the reference use, from a configuration."""
    d = cfg["hidden_size"]
    out = dict(d=d, L=cfg["num_hidden_layers"], H=cfg["num_attention_heads"],
               K=cfg["num_key_value_heads"], hd=cfg["head_dim"],
               f=cfg["intermediate_size"], V=cfg["vocab_size"])
    if cfg["architecture"] == "hybrid":
        din = cfg["mamba_expand"] * d
        gn = cfg["ssd_n_groups"] * cfg["mamba_d_state"]
        out.update(din=din, nh=din // cfg["ssd_head_dim"], gn=gn,
                   N=cfg["mamba_d_state"], G=cfg["ssd_n_groups"],
                   mhd=cfg["ssd_head_dim"], conv=cfg["mamba_d_conv"],
                   conv_ch=din + 2 * gn)
    return out


def windows(cfg: Dict) -> List[int]:
    """Each layer's attention window (0 = global)."""
    L = cfg["num_hidden_layers"]
    if cfg["architecture"] != "hybrid":
        return [0] * L
    glob = set(cfg["global_attn_idx"])
    return [0 if i in glob else cfg["attn_window_size"] for i in range(L)]


def leaf_specs(cfg: Dict) -> List[Tuple[Path, Tuple[int, ...], str, float]]:
    """(path, shape, init, scale) of every leaf, in draw order.  ``init``:
    ``normal`` (scale * N(0, 1)), ``one_plus`` (1 + scale * N(0, 1)),
    ``dt_bias`` (softplus^-1 of a log-uniform step in [1e-3, 1e-1]),
    ``a_log`` (log 1..H)."""
    z = dims(cfg)
    d, L, H, K, hd, f, V = (z[k] for k in ("d", "L", "H", "K", "hd", "f", "V"))
    out_std = 0.02 / math.sqrt(2 * L)
    specs = [(("blocks", "ln1", "scale"), (L, d), "normal", 0.1),
             (("blocks", "attn", "wq"), (L, d, H * hd), "normal", 0.02),
             (("blocks", "attn", "wk"), (L, d, K * hd), "normal", 0.02),
             (("blocks", "attn", "wv"), (L, d, K * hd), "normal", 0.02),
             (("blocks", "attn", "wo"), (L, H * hd, d), "normal", out_std)]
    if cfg["architecture"] == "hybrid":
        din, nh, gn, conv_ch = z["din"], z["nh"], z["gn"], z["conv_ch"]
        m = ("blocks", "mamba")
        specs += [(m + ("in_proj",), (L, d, 2 * din + 2 * gn + nh), "normal",
                   0.02),
                  (m + ("out_proj",), (L, din, d), "normal", out_std),
                  (m + ("conv_w",), (L, z["conv"], conv_ch), "normal", 0.02),
                  (m + ("conv_b",), (L, conv_ch), "normal", 0.02),
                  (m + ("dt_bias",), (L, nh), "dt_bias", 0.0),
                  (m + ("A_log",), (L, nh), "a_log", 0.0),
                  (m + ("Dp",), (L, nh), "one_plus", 0.1),
                  (m + ("ssm_norm",), (L, din), "normal", 0.1)]
    specs += [(("blocks", "ln2", "scale"), (L, d), "normal", 0.1),
              (("blocks", "mlp", "w1"), (L, d, f), "normal", 0.02),
              (("blocks", "mlp", "w3"), (L, d, f), "normal", 0.02),
              (("blocks", "mlp", "w2"), (L, f, d), "normal", out_std),
              (("embed",), (V, d), "normal", 0.02),
              (("final_norm", "scale"), (d,), "normal", 0.1),
              (("head",), (d, V), "normal", 0.02)]
    return specs


def served_dtype(path: Path) -> torch.dtype:
    return torch.float32 if path[-1] in F32_LEAVES else torch.bfloat16


def _draw(specs, gen: torch.Generator, device) -> Dict[Path, torch.Tensor]:
    """Every leaf of ``specs`` in its served dtype, from one normal draw
    and one uniform draw on ``device``."""
    sizes = [math.prod(shape) for _, shape, init, _ in specs
             if init in ("normal", "one_plus")]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    n_dt = sum(math.prod(shape) for _, shape, init, _ in specs
               if init == "dt_bias")
    uni = torch.rand(n_dt, generator=gen, device=device)
    out, at, at_u = {}, 0, 0
    for path, shape, init, scale in specs:
        n = math.prod(shape)
        if init in ("normal", "one_plus"):
            x = flat[at:at + n].view(shape) * scale
            at += n
            if init == "one_plus":
                x += 1.0
        elif init == "dt_bias":
            lo, hi = math.log(1e-3), math.log(1e-1)
            dt = torch.exp(lo + (hi - lo) * uni[at_u:at_u + n].view(shape))
            at_u += n
            x = torch.log(torch.expm1(dt))
        else:                                      # a_log
            h = torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                             device=device)
            x = torch.log(h).expand(shape).clone()
        out[path] = x.to(served_dtype(path))
    return out


def variant_weights(cfg: Dict, device) -> Dict[str, Dict[Path, torch.Tensor]]:
    """{variant: {path: tensor in its served dtype}}.  The first variant
    is drawn whole; each later one shares its leaves but for the layer
    slices it lists, drawn again in the configuration's order (a
    redrawn stacked leaf is a copy with those slices replaced)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(cfg["store"]["store_seed"]))
    specs = leaf_specs(cfg)
    names = list(cfg["variants"])
    base = _draw(specs, gen, device)
    out = {names[0]: base}
    by_path = {p: (shape, init, scale) for p, shape, init, scale in specs}
    for name in names[1:]:
        keys = cfg["variants"][name]
        redraw = []
        for key in keys:
            parts = key.split("/")
            path = (parts[0],) + tuple(parts[2:])
            shape, init, scale = by_path[path]
            redraw.append(((key,), shape[1:], init, scale))
        fresh = _draw(redraw, gen, device)
        tree = dict(base)
        for key in keys:
            parts = key.split("/")
            path, layer = (parts[0],) + tuple(parts[2:]), int(parts[1])
            if tree[path] is base[path]:
                tree[path] = base[path].clone()
            tree[path][layer] = fresh[(key,)]
        out[name] = tree
    return out


def nested(flat: Dict[Path, object]) -> Dict:
    """{("blocks", "attn", "wq"): x} -> {"blocks": {"attn": {"wq": x}}}."""
    tree: Dict = {}
    for path, leaf in flat.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf
    return tree
