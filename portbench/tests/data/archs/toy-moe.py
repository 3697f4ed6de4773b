"""``toy-moe``: the program's MoE family, laid out as its reduced kimi-k2:
a dense first layer (``dense_blocks``: the Llama layer), then expert
layers (``blocks``): attention, then top-k softmax routing over
``n_routed_experts`` gated SiLU experts of ``moe_intermediate_size``, the
k gates renormalised to sum to 1, and no token dropped (the capacity
factor covers every token).  A test checkout adds it as a file alone.

The plain reference routes each token in float32 (``ref.select``, which
keeps each row's routing margin for the check's tie set) and runs each
expert over the tokens that chose it; the program routes through a bfloat16
product and runs every expert over its capacity slots.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench import weights
from portbench.check import BUDGET_BYTES
from portbench.counts import prefill

F32_LEAVES = weights.NORMS + ("router",)


def _fan_in_uniform(shape, scale, gen, device):
    """U(-1, 1) / sqrt(fan in): ``torch.nn.Linear``'s default weight."""
    u = torch.rand(shape, generator=gen, device=device)
    return (2.0 * u - 1.0) / math.sqrt(shape[-2])


INITS = {"fan_in_uniform": _fan_in_uniform}


def dims(cfg: Dict) -> Dict[str, int]:
    return dict(d=cfg["hidden_size"], L=cfg["num_hidden_layers"],
                Ld=cfg["first_k_dense_replace"],
                H=cfg["num_attention_heads"], K=cfg["num_key_value_heads"],
                hd=cfg["head_dim"], f=cfg["intermediate_size"],
                E=cfg["n_routed_experts"], k=cfg["num_experts_per_tok"],
                fe=cfg["moe_intermediate_size"], V=cfg["vocab_size"])


def groups(cfg: Dict) -> List[Tuple[str, int]]:
    z = dims(cfg)
    return [("dense_blocks", z["Ld"]), ("blocks", z["L"] - z["Ld"])]


def windows(cfg: Dict) -> List[int]:
    return [0] * cfg["num_hidden_layers"]


def attention_layers(cfg: Dict) -> List[Tuple[int, int, int, int]]:
    z = dims(cfg)
    return [(w, z["H"], z["K"], z["hd"]) for w in windows(cfg)]


def leaf_specs(cfg: Dict) -> List[weights.Spec]:
    z = dims(cfg)
    d, E, fe = z["d"], z["E"], z["fe"]
    out_std = 0.02 / math.sqrt(2 * z["L"])
    specs = []
    for g, n in groups(cfg):
        specs += [weights.norm_spec(g, "ln1", n, d)]
        specs += weights.attention_specs(g, n, d, z["H"], z["K"], z["hd"],
                                         out_std)
        specs += [weights.norm_spec(g, "ln2", n, d)]
        if g == "dense_blocks":
            specs += weights.mlp_specs((g, "mlp"), n, d, z["f"], out_std)
        else:
            m = (g, "moe")
            # the experts at torch.nn.Linear's scale, so that they carry
            # the stream: at the normal 0.02 / out_std of the other layers
            # their output was ~3% of it, and neither one expert layer in
            # float8 nor its router off by 10% moved the logits
            specs += [(m + (leaf,), shape, "fan_in_uniform", 0.0)
                      for leaf, shape in (("router", (n, d, E)),
                                          ("ew1", (n, E, d, fe)),
                                          ("ew3", (n, E, d, fe)),
                                          ("ew2", (n, E, fe, d)))]
    return specs + weights.head_specs(d, z["V"])


def program_config(cfg: Dict):
    from repro_torch.configs.base import ModelConfig, MoEConfig
    z = dims(cfg)
    if cfg["hidden_act"] != "silu" or cfg["tie_word_embeddings"]:
        raise ValueError(f"{cfg['name']}: the program's MoE layers have "
                         f"gated SiLU experts and an untied head")
    if cfg["scoring_func"] != "softmax" or not cfg["norm_topk_prob"]:
        raise ValueError(f"{cfg['name']}: the program routes by softmax "
                         f"and renormalises the k gates")
    if cfg["capacity_factor"] * z["k"] < z["E"]:
        raise ValueError(f"{cfg['name']}: a capacity factor under "
                         f"n_routed_experts / num_experts_per_tok drops "
                         f"tokens, which the reference never does")
    return ModelConfig(name=cfg["name"], family="moe", num_layers=z["L"],
                       d_model=z["d"], num_heads=z["H"], kv_heads=z["K"],
                       d_ff=z["f"], vocab=z["V"], head_dim=z["hd"],
                       rope_theta=cfg["rope_theta"],
                       norm_eps=cfg["rms_norm_eps"], act="silu",
                       gated_mlp=True, dtype=cfg["torch_dtype"],
                       moe=MoEConfig(num_experts=z["E"], top_k=z["k"],
                                     d_ff=z["fe"],
                                     capacity_factor=cfg["capacity_factor"]),
                       first_dense_layers=z["Ld"])


def experts(ref, h, p: Dict, k: int):
    """Each token through the k experts its router puts first, weighted
    by their softmax probabilities renormalised over the k; the choice on
    the probabilities, as the program's (``ref.select``)."""
    probs = torch.softmax(ref.linear(h, p["router"]), dim=-1)
    idx = ref.select(probs, k)
    top = probs.gather(-1, idx)
    gates = top / top.sum(-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in range(probs.shape[-1]):
        hit = idx == e                                  # [B, S, k]
        rows = hit.any(-1)
        if rows.any():
            g = (gates * hit).sum(-1)[rows]
            y[rows] += g[:, None] * ref.mlp(h[rows], {
                "w1": p["ew1"][e], "w3": p["ew3"][e], "w2": p["ew2"][e]})
    return y


def forward(ref, tokens, n_last: int):
    w, k = ref.w, ref.cfg["num_experts_per_tok"]
    x = w[("embed",)][tokens.long()]
    for g, n in groups(ref.cfg):
        for i in range(n):
            h = ref.norm(x, w[(g, "ln1", "scale")][i])
            x = x + ref.attention(h, ref.layer((g, "attn"), i), 0)
            h = ref.norm(x, w[(g, "ln2", "scale")][i])
            if g == "dense_blocks":
                x = x + ref.mlp(h, ref.layer((g, "mlp"), i))
            else:
                x = x + experts(ref, h, ref.layer((g, "moe"), i), k)
    return ref.head(x, n_last)


def block_rows(cfg: Dict, tokens: int) -> int:
    """Attention scores and their softmax, and the feed-forward's three
    activations (the dense layer's, or k experts' a token), a row."""
    z = dims(cfg)
    ff = max(z["f"], z["k"] * z["fe"])
    per_row = 4 * (3 * z["H"] * tokens * tokens + 3 * tokens * ff
                   + 2 * tokens * z["d"])
    return max(1, int(BUDGET_BYTES // per_row))


def prefill_flops(cfg: Dict, rows: int, tokens: int) -> float:
    """The routed tokens' expert products (k experts a token) and the
    router's, not the capacity slots the program also multiplies."""
    z = dims(cfg)
    d, T = z["d"], rows * tokens
    total = 0.0
    for i, (w, H, K, hd) in enumerate(attention_layers(cfg)):
        total += prefill.attention(rows, tokens, d, H, K, hd, w)
        if i < z["Ld"]:
            total += prefill.mlp(T, d, z["f"])
        else:
            total += 2.0 * T * d * z["E"] + z["k"] * prefill.mlp(T, d, z["fe"])
    return total + prefill.head(rows, d, z["V"])
