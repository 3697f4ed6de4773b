"""``hybrid``: Hymba's layer as the program builds it: grouped-query
attention (a sliding window outside ``global_attn_idx``) and Mamba-2's
mixer read one norm of x, x += (attn + mixer) / 2; then the gated SiLU
feed-forward; an untied head.  The program's ``hybrid`` family: one
group of layers, ``blocks``, global at 0, L // 2 and L - 1."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

from portbench import weights
from portbench.check import BUDGET_BYTES
from portbench.counts import prefill

F32_LEAVES = weights.NORMS + ("dt_bias", "A_log", "Dp", "ssm_norm")


def dims(cfg: Dict) -> Dict[str, int]:
    d = cfg["hidden_size"]
    din = cfg["mamba_expand"] * d
    gn = cfg["ssd_n_groups"] * cfg["mamba_d_state"]
    return dict(d=d, L=cfg["num_hidden_layers"],
                H=cfg["num_attention_heads"], K=cfg["num_key_value_heads"],
                hd=cfg["head_dim"], f=cfg["intermediate_size"],
                V=cfg["vocab_size"], din=din, nh=din // cfg["ssd_head_dim"],
                gn=gn, N=cfg["mamba_d_state"], G=cfg["ssd_n_groups"],
                mhd=cfg["ssd_head_dim"], conv=cfg["mamba_d_conv"],
                conv_ch=din + 2 * gn)


def windows(cfg: Dict) -> List[int]:
    glob = set(cfg["global_attn_idx"])
    return [0 if i in glob else cfg["attn_window_size"]
            for i in range(cfg["num_hidden_layers"])]


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
            + weights.mixer_specs("blocks", L, d, z["din"], z["nh"],
                                  z["gn"], z["conv"], out_std)
            + [weights.norm_spec("blocks", "ln2", L, d)]
            + weights.mlp_specs(("blocks", "mlp"), L, d, z["f"], out_std)
            + weights.head_specs(d, z["V"]))


def program_config(cfg: Dict):
    from repro_torch.configs.base import ModelConfig, SSMConfig
    if cfg["hidden_act"] != "silu" or cfg["tie_word_embeddings"]:
        raise ValueError(f"{cfg['name']}: the program's hybrid layers have "
                         f"a gated SiLU feed-forward and an untied head")
    L = cfg["num_hidden_layers"]
    if sorted(cfg["global_attn_idx"]) != sorted({0, L // 2, L - 1}):
        raise ValueError(f"{cfg['name']}: the program's hybrid layers "
                         f"are global at 0, L // 2 and L - 1")
    return ModelConfig(name=cfg["name"], family="hybrid", num_layers=L,
                       d_model=cfg["hidden_size"],
                       num_heads=cfg["num_attention_heads"],
                       kv_heads=cfg["num_key_value_heads"],
                       d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
                       head_dim=cfg["head_dim"], rope_theta=cfg["rope_theta"],
                       norm_eps=cfg["rms_norm_eps"], act="silu",
                       gated_mlp=True, dtype=cfg["torch_dtype"], hybrid=True,
                       sliding_window=cfg["attn_window_size"],
                       window_pattern=-3,
                       ssm=SSMConfig(d_state=cfg["mamba_d_state"],
                                     d_conv=cfg["mamba_d_conv"],
                                     expand=cfg["mamba_expand"],
                                     head_dim=cfg["ssd_head_dim"],
                                     n_groups=cfg["ssd_n_groups"]))


def forward(ref, tokens, n_last: int):
    z, w = dims(ref.cfg), ref.w
    x = w[("embed",)][tokens.long()]
    for i, window in enumerate(windows(ref.cfg)):
        h = ref.norm(x, w[("blocks", "ln1", "scale")][i])
        x = x + 0.5 * (ref.attention(h, ref.layer(("blocks", "attn"), i),
                                     window)
                       + ref.mixer(h, ref.layer(("blocks", "mamba"), i),
                                   z["nh"], z["mhd"], z["G"], z["N"]))
        x = x + ref.mlp(ref.norm(x, w[("blocks", "ln2", "scale")][i]),
                        ref.layer(("blocks", "mlp"), i))
    return ref.head(x, n_last)


def block_rows(cfg: Dict, tokens: int) -> int:
    """Attention scores and their softmax, the feed-forward's three
    activations, and the scan's tiles (lag, decay, C.B and their
    product), a row."""
    z = dims(cfg)
    per_row = 4 * (3 * z["H"] * tokens * tokens + 3 * tokens * z["f"])
    per_row += 4 * 4 * 256 * tokens * z["nh"]
    return max(1, int(BUDGET_BYTES // per_row))


def prefill_flops(cfg: Dict, rows: int, tokens: int) -> float:
    z = dims(cfg)
    d, T = z["d"], rows * tokens
    total = 0.0
    for w, H, K, hd in attention_layers(cfg):
        total += prefill.attention(rows, tokens, d, H, K, hd, w)
        total += prefill.mlp(T, d, z["f"])
        total += prefill.mixer(T, d, z["din"], z["nh"], z["gn"], z["conv"],
                               z["mhd"], z["N"])
    return total + prefill.head(rows, d, z["V"])
