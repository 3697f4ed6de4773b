"""The plain forward that decides ``correct``: float32 PyTorch, no kernel,
no cache, no batching across rows, and nothing of the program.

It follows the published layer equations of the two families the
benchmark runs, as the configuration files state them:

* ``dense`` (deepseek-llm-7b, the Llama layer): x += Wo attn(rope(Wq h),
  rope(Wk h), Wv h); x += W2 (silu(W1 h) * W3 h), each h an RMSNorm of x
  whose weight is 1 + scale; causal multi-head attention, rotary
  embedding on the two halves of each head, an untied head applied to
  the last position's final norm.
* ``hybrid`` (Hymba as the configuration states it): attention (grouped
  query heads; a sliding window outside ``global_attn_idx``) and a
  Mamba-2 mixer read one norm of x, and x += (attn + mixer) / 2; then the
  gated feed-forward as above.  The mixer: in_proj to z, x, B, C and dt;
  a depthwise causal convolution and SiLU on x, B, C; dt = softplus(dt +
  dt_bias), A = -exp(A_log); the scan h_t = exp(dt_t A) h_{t-1} + dt_t
  B_t x_t, y_t = C_t h_t + D x_t, here in its quadratic form (the sum over
  s <= t of C_t.B_s exp(sum of dt A over (s, t]) dt_s x_s), tiled over
  query positions; then RMSNorm(y * silu(z)) and out_proj.

``precision="fp8"`` is the control: every linear layer's operands are
rounded to float8 e4m3 with an absmax scale per row of the activation and
per output column of the weight, the next precision below the
configuration's bfloat16.  TF32 is off while either runs.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator

import torch
import torch.nn.functional as F

F32 = torch.float32
FP8_MAX = 448.0                               # largest finite e4m3


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """Full float32 products for the duration (the card would otherwise
    run float32 matrix products in TF32 where allowed)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to e4m3 with an absmax scale along ``dim``, back in fp32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(F32) * s


class Reference:
    """Last-position logits of a configuration's model over rows of
    tokens, from float32 weights ``w`` keyed as ``weights.leaf_specs``
    names them (layer leaves stacked on axis 0)."""

    def __init__(self, cfg: Dict, w: Dict, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.cfg, self.w, self.precision = cfg, w, precision
        self.eps = float(cfg["rms_norm_eps"])
        L = cfg["num_hidden_layers"]
        if cfg["architecture"] == "hybrid":
            glob = set(cfg["global_attn_idx"])
            self.windows = [0 if i in glob else cfg["attn_window_size"]
                            for i in range(L)]
        else:
            self.windows = [0] * L

    # ---------------------------------------------------------- pieces --
    def linear(self, x, wt):
        """x [..., n] @ wt [n, m] in the run's precision."""
        if self.precision == "fp8":
            x, wt = _fp8(x, -1), _fp8(wt, 0)
        return x @ wt

    def norm(self, x, scale):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) \
            * (1.0 + scale)

    def rope(self, x):
        """x [B, S, heads, hd]: rotate (first half, second half) of each
        head by angle pos * theta^(-i / half)."""
        S, hd = x.shape[1], x.shape[-1]
        half = hd // 2
        inv = float(self.cfg["rope_theta"]) ** (
            -torch.arange(half, dtype=F32, device=x.device) / half)
        ang = torch.arange(S, dtype=F32, device=x.device)[:, None] * inv
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        a, b = x[..., :half], x[..., half:]
        return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)

    def attention(self, h, i: int):
        c = self.cfg
        B, S, _ = h.shape
        H, K, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                    c["head_dim"])
        q = self.rope(self.linear(h, self.w["wq"][i]).view(B, S, H, hd))
        k = self.rope(self.linear(h, self.w["wk"][i]).view(B, S, K, hd))
        v = self.linear(h, self.w["wv"][i]).view(B, S, K, hd)
        k = k.repeat_interleave(H // K, dim=2)       # query head h reads h // G
        v = v.repeat_interleave(H // K, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        pos = torch.arange(S, device=h.device)
        lag = pos[:, None] - pos[None, :]
        seen = lag >= 0
        if self.windows[i]:
            seen &= lag < self.windows[i]
        s = s.masked_fill(~seen, float("-inf"))
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
        return self.linear(o.reshape(B, S, H * hd), self.w["wo"][i])

    def ssd(self, x, dt, A, Bm, Cm, D, tile: int = 256):
        """The scan's quadratic form.  x [B, S, nh, p]; dt [B, S, nh];
        A, D [nh]; Bm, Cm [B, S, G, N] -> y [B, S, nh, p]."""
        Bsz, S, nh, _ = x.shape
        r = nh // Bm.shape[2]
        Bh = Bm.repeat_interleave(r, dim=2)            # [B, S, nh, N]
        Ch = Cm.repeat_interleave(r, dim=2)
        cum = torch.cumsum(dt * A, dim=1)              # [B, S, nh]
        xs = dt[..., None] * x                         # dt_s x_s
        pos = torch.arange(S, device=x.device)
        ys = []
        for t0 in range(0, S, tile):
            t1 = min(S, t0 + tile)
            seen = pos[t0:t1, None] >= pos[None, :t1]  # [T, t1]: s <= t
            lag = cum[:, t0:t1, None, :] - cum[:, None, :t1, :]
            decay = torch.exp(lag.masked_fill(~seen[None, :, :, None],
                                              float("-inf")))
            cb = torch.einsum("bthn,bshn->btsh", Ch[:, t0:t1], Bh[:, :t1])
            ys.append(torch.einsum("btsh,bshp->bthp", cb * decay,
                                   xs[:, :t1]))
        return torch.cat(ys, dim=1) + D[:, None] * x

    def mixer(self, h, i: int):
        c, w = self.cfg, self.w
        B, S, d = h.shape
        din = c["mamba_expand"] * d
        p, N, G = c["ssd_head_dim"], c["mamba_d_state"], c["ssd_n_groups"]
        nh, gn = din // p, G * N
        zxbcdt = self.linear(h, w["in_proj"][i])
        z, xbc, dt = torch.split(zxbcdt, [din, din + 2 * gn, nh], dim=-1)
        kw = w["conv_w"][i]                                  # [k, ch]
        k = kw.shape[0]
        xp = F.pad(xbc, (0, 0, k - 1, 0))
        xbc = sum(kw[j] * xp[:, j:j + S] for j in range(k)) + w["conv_b"][i]
        xbc = F.silu(xbc)
        xs, Bm, Cm = torch.split(xbc, [din, gn, gn], dim=-1)
        dt = F.softplus(dt + w["dt_bias"][i])
        A = -torch.exp(w["A_log"][i])
        y = self.ssd(xs.reshape(B, S, nh, p), dt, A, Bm.reshape(B, S, G, N),
                     Cm.reshape(B, S, G, N), w["Dp"][i])
        y = self.norm(y.reshape(B, S, din) * F.silu(z), w["ssm_norm"][i])
        return self.linear(y, w["out_proj"][i])

    def mlp(self, h, i: int):
        w = self.w
        return self.linear(F.silu(self.linear(h, w["w1"][i]))
                           * self.linear(h, w["w3"][i]), w["w2"][i])

    # ---------------------------------------------------------- forward --
    def _rows(self, tokens: torch.Tensor, n_last: int) -> torch.Tensor:
        w = self.w
        x = w["embed"][tokens.long()]
        for i in range(self.cfg["num_hidden_layers"]):
            h = self.norm(x, w["ln1"][i])
            if self.cfg["architecture"] == "hybrid":
                x = x + 0.5 * (self.attention(h, i) + self.mixer(h, i))
            else:
                x = x + self.attention(h, i)
            x = x + self.mlp(self.norm(x, w["ln2"][i]), i)
        last = self.norm(x[:, -n_last:], w["final_norm"])
        return self.linear(last, w["head"])

    def last_logits(self, tokens: torch.Tensor, block: int,
                    n_last: int = 1) -> torch.Tensor:
        """[n, S] token ids -> [n, n_last, V] float32 logits of the last
        ``n_last`` positions, ``block`` rows at a time."""
        with torch.no_grad(), no_tf32():
            return torch.cat([self._rows(tokens[r:r + block], n_last)
                              for r in range(0, tokens.shape[0], block)])


def flat_weights(tree: Dict) -> Dict:
    """The reference's keys from a ``weights.variant_weights`` variant:
    the last part of each path (``blocks/attn/wq`` -> ``wq``; the norms
    by their parent), in float32."""
    out = {}
    for path, t in tree.items():
        key = path[-2] if path[-1] == "scale" else path[-1]
        out[key] = t.to(F32)
    return out
