"""The served weights of a configuration, drawn from its ``store_seed``.

Both sides take them from here: the store build registers them into the
program's database (once per checkout), and the reference draws them
again after the window.  Nothing is read back from the store.

The tree is the one the program's LM path loads (``repro_torch.convert.
lm_tensors``): layer leaves stacked on a leading layer axis under each
layer group (``blocks``; ``dense_blocks`` ...), then ``embed``,
``final_norm`` and ``head``; the configuration's architecture module
(``archs/``) lays it out.  Matrices are served in bfloat16, so they are
drawn in float32 and rounded to it; the leaves the architecture names in
its ``F32_LEAVES`` (norm scales, the mixer's scalars) stay float32, as
the program serves them.  A variant redraws the per-layer slices its
configuration lists (``"blocks/1/mlp/w1"``).

The draw runs on ``device`` with a ``torch.Generator`` there, in one
``randn`` for every normal leaf of a variant (and one ``rand`` for the
mixer's time steps), so it takes a fraction of a second on the card.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from portbench import archs

#: leaves every architecture serves in float32: the norm scales
NORMS = ("scale",)

Path = Tuple[str, ...]
Spec = Tuple[Path, Tuple[int, ...], str, float]


def dims(cfg: Dict) -> Dict[str, int]:
    """The sizes the layout and the reference use, from a configuration."""
    return archs.of(cfg).dims(cfg)


def windows(cfg: Dict) -> List[int]:
    """Each layer's attention window (0 = global)."""
    return archs.of(cfg).windows(cfg)


def leaf_specs(cfg: Dict) -> List[Spec]:
    """(path, shape, init, scale) of every leaf, in draw order.  ``init``:
    ``normal`` (scale * N(0, 1)), ``one_plus`` (1 + scale * N(0, 1)),
    ``dt_bias`` (softplus^-1 of a log-uniform step in [1e-3, 1e-1]),
    ``a_log`` (log 1..H), or a kind of the architecture's ``INITS``."""
    return archs.of(cfg).leaf_specs(cfg)


# the pieces the architectures' layouts are made of; ``group`` is the
# layer group's name, ``n`` its layers
def norm_spec(group: str, name: str, n: int, d: int) -> Spec:
    return ((group, name, "scale"), (n, d), "normal", 0.1)


def attention_specs(group: str, n: int, d: int, H: int, K: int, hd: int,
                    out_std: float) -> List[Spec]:
    a = (group, "attn")
    return [(a + ("wq",), (n, d, H * hd), "normal", 0.02),
            (a + ("wk",), (n, d, K * hd), "normal", 0.02),
            (a + ("wv",), (n, d, K * hd), "normal", 0.02),
            (a + ("wo",), (n, H * hd, d), "normal", out_std)]


def mlp_specs(prefix: Path, n: int, d: int, f: int,
              out_std: float) -> List[Spec]:
    """The gated feed-forward's ``w1``, ``w3``, ``w2`` under ``prefix``
    (``("blocks", "mlp")``)."""
    return [(prefix + ("w1",), (n, d, f), "normal", 0.02),
            (prefix + ("w3",), (n, d, f), "normal", 0.02),
            (prefix + ("w2",), (n, f, d), "normal", out_std)]


def mixer_specs(group: str, n: int, d: int, din: int, nh: int, gn: int,
                conv: int, out_std: float) -> List[Spec]:
    """Mamba-2's mixer: in_proj to z, x, B, C and dt; the causal
    convolution over x, B and C; the scan's scalars; the gated norm."""
    m, conv_ch = (group, "mamba"), din + 2 * gn
    return [(m + ("in_proj",), (n, d, 2 * din + 2 * gn + nh), "normal", 0.02),
            (m + ("out_proj",), (n, din, d), "normal", out_std),
            (m + ("conv_w",), (n, conv, conv_ch), "normal", 0.02),
            (m + ("conv_b",), (n, conv_ch), "normal", 0.02),
            (m + ("dt_bias",), (n, nh), "dt_bias", 0.0),
            (m + ("A_log",), (n, nh), "a_log", 0.0),
            (m + ("Dp",), (n, nh), "one_plus", 0.1),
            (m + ("ssm_norm",), (n, din), "normal", 0.1)]


def head_specs(d: int, V: int) -> List[Spec]:
    """The embedding, the final norm and an untied head."""
    return [(("embed",), (V, d), "normal", 0.02),
            (("final_norm", "scale"), (d,), "normal", 0.1),
            (("head",), (d, V), "normal", 0.02)]


def served_dtype(path: Path, f32: Sequence[str] = NORMS) -> torch.dtype:
    return torch.float32 if path[-1] in f32 else torch.bfloat16


def _draw(specs: Sequence[Spec], gen: torch.Generator, device, arch
          ) -> List[torch.Tensor]:
    """Every leaf of ``specs`` in its served dtype, in order: the shared
    kinds from one normal draw and one uniform draw on ``device``, then
    the architecture's own kinds, each from ``gen`` in turn."""
    sizes = [math.prod(shape) for _, shape, init, _ in specs
             if init in ("normal", "one_plus")]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    n_dt = sum(math.prod(shape) for _, shape, init, _ in specs
               if init == "dt_bias")
    uni = torch.rand(n_dt, generator=gen, device=device)
    inits = getattr(arch, "INITS", {})
    out, at, at_u = [], 0, 0
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
        elif init == "a_log":
            h = torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                             device=device)
            x = torch.log(h).expand(shape).clone()
        else:
            x = inits[init](shape, scale, gen, device)
        out.append(x.to(served_dtype(path, arch.F32_LEAVES)))
    return out


def variant_weights(cfg: Dict, device) -> Dict[str, Dict[Path, torch.Tensor]]:
    """{variant: {path: tensor in its served dtype}}.  The first variant
    is drawn whole; each later one shares its leaves but for the layer
    slices it lists (``"<group>/<layer>/<path in the layer>"``), drawn
    again in the configuration's order (a redrawn stacked leaf is a copy
    with those slices replaced)."""
    arch = archs.of(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(cfg["store"]["store_seed"]))
    specs = arch.leaf_specs(cfg)
    names = list(cfg["variants"])
    base = dict(zip([s[0] for s in specs], _draw(specs, gen, device, arch)))
    out = {names[0]: base}
    by_path = {p: (shape, init, scale) for p, shape, init, scale in specs}
    for name in names[1:]:
        slices = []
        for key in cfg["variants"][name]:
            parts = key.split("/")
            slices.append(((parts[0],) + tuple(parts[2:]), int(parts[1])))
        redraw = [(path,) + (by_path[path][0][1:],) + by_path[path][1:]
                  for path, _ in slices]
        tree = dict(base)
        for (path, layer), x in zip(slices,
                                    _draw(redraw, gen, device, arch)):
            if tree[path] is base[path]:
                tree[path] = base[path].clone()
            tree[path][layer] = x
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
