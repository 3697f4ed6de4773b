"""``dense``: the Llama layer (deepseek-llm-7b): x += attn(norm(x)); x +=
mlp(norm(x)); causal attention with rotary embedding on every layer, no
window; a gated SiLU feed-forward; an untied head.  The program's
``dense`` family: one group of layers, ``blocks``."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

from portbench import weights
from portbench.check import BUDGET_BYTES
from portbench.counts import prefill

F32_LEAVES = weights.NORMS


def dims(cfg: Dict) -> Dict[str, int]:
    return dict(d=cfg["hidden_size"], L=cfg["num_hidden_layers"],
                H=cfg["num_attention_heads"], K=cfg["num_key_value_heads"],
                hd=cfg["head_dim"], f=cfg["intermediate_size"],
                V=cfg["vocab_size"])


def windows(cfg: Dict) -> List[int]:
    return [0] * cfg["num_hidden_layers"]


def attention_layers(cfg: Dict) -> List[Tuple[int, int, int, int]]:
    z = dims(cfg)
    return [(w, z["H"], z["K"], z["hd"]) for w in windows(cfg)]


def leaf_specs(cfg: Dict) -> List[weights.Spec]:
    z = dims(cfg)
    d, L = z["d"], z["L"]
    out_std = 0.02 / math.sqrt(2 * L)
    return ([weights.norm_spec("blocks", "ln1", L, d)]
            + weights.attention_specs("blocks", L, d, z["H"], z["K"],
                                      z["hd"], out_std)
            + [weights.norm_spec("blocks", "ln2", L, d)]
            + weights.mlp_specs(("blocks", "mlp"), L, d, z["f"], out_std)
            + weights.head_specs(d, z["V"]))


def program_config(cfg: Dict):
    from repro_torch.configs.base import ModelConfig
    if cfg["hidden_act"] != "silu" or cfg["tie_word_embeddings"]:
        raise ValueError(f"{cfg['name']}: the program's dense layers have "
                         f"a gated SiLU feed-forward and an untied head")
    return ModelConfig(name=cfg["name"], family="dense",
                       num_layers=cfg["num_hidden_layers"],
                       d_model=cfg["hidden_size"],
                       num_heads=cfg["num_attention_heads"],
                       kv_heads=cfg["num_key_value_heads"],
                       d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
                       head_dim=cfg["head_dim"], rope_theta=cfg["rope_theta"],
                       norm_eps=cfg["rms_norm_eps"], act="silu",
                       gated_mlp=True, dtype=cfg["torch_dtype"])


def forward(ref, tokens, n_last: int):
    w = ref.w
    x = w[("embed",)][tokens.long()]
    for i, window in enumerate(windows(ref.cfg)):
        h = ref.norm(x, w[("blocks", "ln1", "scale")][i])
        x = x + ref.attention(h, ref.layer(("blocks", "attn"), i), window)
        x = x + ref.mlp(ref.norm(x, w[("blocks", "ln2", "scale")][i]),
                        ref.layer(("blocks", "mlp"), i))
    return ref.head(x, n_last)


def block_rows(cfg: Dict, tokens: int) -> int:
    """Attention scores and their softmax, and the feed-forward's three
    activations, a row."""
    z = dims(cfg)
    per_row = 4 * (3 * z["H"] * tokens * tokens + 3 * tokens * z["f"])
    return max(1, int(BUDGET_BYTES // per_row))


def prefill_flops(cfg: Dict, rows: int, tokens: int) -> float:
    z = dims(cfg)
    d, T = z["d"], rows * tokens
    total = 0.0
    for w, H, K, hd in attention_layers(cfg):
        total += prefill.attention(rows, tokens, d, H, K, hd, w)
        total += prefill.mlp(T, d, z["f"])
    return total + prefill.head(rows, d, z["V"])
