"""The plain forward that decides ``correct``: float32 PyTorch, no kernel,
no cache, no batching across rows, and nothing of the program.

Each architecture's module (``archs/<architecture>.py``) writes its
forward from the pieces here, which follow the published layer equations
as the configuration files state them:

* ``norm``: RMSNorm whose weight is 1 + scale;
* ``attention``: causal multi-head attention with grouped query heads
  (query head h reads key head h // (H / K)), rotary embedding on the two
  halves of each head (``rope``), an optional sliding window;
* ``mixer``: Mamba-2's mixer: in_proj to z, x, B, C and dt; a depthwise
  causal convolution and SiLU on x, B, C; dt = softplus(dt + dt_bias),
  A = -exp(A_log); the scan h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t,
  y_t = C_t h_t + D x_t, here in its quadratic form (``ssd``: the sum
  over s <= t of C_t.B_s exp(sum of dt A over (s, t]) dt_s x_s), tiled
  over query positions; then RMSNorm(y * silu(z)) and out_proj;
* ``mlp``: the gated feed-forward W2 (silu(W1 h) * W3 h);
* ``head``: the final norm of the last positions and an untied head.

``dense`` (deepseek-llm-7b, the Llama layer) is x += attn(norm(x)); x +=
mlp(norm(x)); ``hybrid`` (Hymba) reads attention and the mixer off one
norm of x, x += (attn + mixer) / 2, then the feed-forward.

An architecture that routes calls ``Reference.select`` for its top-k:
the lower index first among equal scores (the program's order), and each
row's smallest margin between the k-th and the (k+1)-th score at the
positions ``last_logits`` compares, over every call of the forward, kept
in ``Reference.margins`` for the check's tie set (``check.py``).

``precision="fp8"`` is the control: every linear layer's operands are
rounded to float8 e4m3 with an absmax scale per row of the activation and
per output column of the weight, the next precision below the
configuration's bfloat16.  TF32 is off while either runs.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Tuple

import torch
import torch.nn.functional as F

from portbench import archs

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
    tokens, from float32 weights ``w`` keyed by path as
    ``weights.leaf_specs`` names them (layer leaves stacked on axis 0);
    the architecture's ``forward`` puts the pieces together."""

    def __init__(self, cfg: Dict, w: Dict, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.cfg, self.w, self.precision = cfg, w, precision
        self.eps = float(cfg["rms_norm_eps"])
        self.arch = archs.of(cfg)
        self._n_last = 1
        self._block = None                 # the block's [rows] margins
        self._margins = []                 # the finished blocks'

    def layer(self, prefix: Tuple[str, ...], i: int) -> Dict:
        """{name: layer i's slice} of the leaves under ``prefix``
        (``("blocks", "attn")``), named by the rest of their path."""
        n = len(prefix)
        return {"/".join(p[n:]): t[i] for p, t in self.w.items()
                if p[:n] == prefix}

    # ---------------------------------------------------------- pieces --
    def select(self, scores, k: int):
        """The indices [B, S, k] of the ``k`` largest of ``scores`` [B, S,
        E] (the block's rows), the lower index first among equal ones;
        keeps each row's smallest margin between its k-th and (k+1)-th
        score at the last ``n_last`` positions."""
        if self._block is None or scores.shape[0] != self._block.shape[0]:
            raise ValueError(f"select takes scores [rows, positions, E] of "
                             f"the forward's rows, not {tuple(scores.shape)}")
        vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
        if k < scores.shape[-1]:
            gap = vals[..., k - 1] - vals[..., k]
            self._block = torch.minimum(
                self._block, gap[:, -self._n_last:].amin(-1).to(F32))
        return idx[..., :k]

    @property
    def margins(self) -> torch.Tensor:
        """[n] each row's smallest routing margin in the last
        ``last_logits`` call; ``inf`` where nothing was routed."""
        return torch.cat(self._margins)

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

    def attention(self, h, p: Dict, window: int):
        """One layer's attention; ``p`` holds its ``wq``, ``wk``, ``wv``
        and ``wo``; ``window`` 0 is global."""
        c = self.cfg
        B, S, _ = h.shape
        H, K, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                    c["head_dim"])
        q = self.rope(self.linear(h, p["wq"]).view(B, S, H, hd))
        k = self.rope(self.linear(h, p["wk"]).view(B, S, K, hd))
        v = self.linear(h, p["wv"]).view(B, S, K, hd)
        k = k.repeat_interleave(H // K, dim=2)       # query head h reads h // G
        v = v.repeat_interleave(H // K, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        pos = torch.arange(S, device=h.device)
        lag = pos[:, None] - pos[None, :]
        seen = lag >= 0
        if window:
            seen &= lag < window
        s = s.masked_fill(~seen, float("-inf"))
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
        return self.linear(o.reshape(B, S, H * hd), p["wo"])

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

    def mixer(self, h, p: Dict, nh: int, hp: int, G: int, N: int):
        """One layer's Mamba-2 mixer of ``nh`` heads of ``hp``, ``G``
        groups of B and C of state ``N``; ``p`` holds its ``in_proj``,
        ``conv_w`` [k, ch], ``conv_b``, ``dt_bias``, ``A_log``, ``Dp``,
        ``ssm_norm`` and ``out_proj``."""
        B, S, _ = h.shape
        din, gn = nh * hp, G * N
        zxbcdt = self.linear(h, p["in_proj"])
        z, xbc, dt = torch.split(zxbcdt, [din, din + 2 * gn, nh], dim=-1)
        kw = p["conv_w"]
        k = kw.shape[0]
        xp = F.pad(xbc, (0, 0, k - 1, 0))
        xbc = sum(kw[j] * xp[:, j:j + S] for j in range(k)) + p["conv_b"]
        xbc = F.silu(xbc)
        xs, Bm, Cm = torch.split(xbc, [din, gn, gn], dim=-1)
        dt = F.softplus(dt + p["dt_bias"])
        A = -torch.exp(p["A_log"])
        y = self.ssd(xs.reshape(B, S, nh, hp), dt, A, Bm.reshape(B, S, G, N),
                     Cm.reshape(B, S, G, N), p["Dp"])
        y = self.norm(y.reshape(B, S, din) * F.silu(z), p["ssm_norm"])
        return self.linear(y, p["out_proj"])

    def mlp(self, h, p: Dict):
        """The gated feed-forward; ``p`` holds ``w1``, ``w3`` and ``w2``."""
        return self.linear(F.silu(self.linear(h, p["w1"]))
                           * self.linear(h, p["w3"]), p["w2"])

    def head(self, x, n_last: int):
        """Logits of the last ``n_last`` positions of x."""
        last = self.norm(x[:, -n_last:], self.w[("final_norm", "scale")])
        return self.linear(last, self.w[("head",)])

    # ---------------------------------------------------------- forward --
    def last_logits(self, tokens: torch.Tensor, block: int,
                    n_last: int = 1) -> torch.Tensor:
        """[n, S] token ids -> [n, n_last, V] float32 logits of the last
        ``n_last`` positions, ``block`` rows at a time."""
        self._n_last, self._margins, out = n_last, [], []
        with torch.no_grad(), no_tf32():
            for r in range(0, tokens.shape[0], block):
                rows = tokens[r:r + block]
                self._block = torch.full((rows.shape[0],), float("inf"),
                                         device=rows.device)
                out.append(self.arch.forward(self, rows, n_last))
                self._margins.append(self._block)
        self._block = None
        return torch.cat(out)


def flat_weights(tree: Dict) -> Dict:
    """The reference's weights from a ``weights.variant_weights`` variant:
    each leaf in float32, keyed by its path."""
    return {path: t.to(F32) for path, t in tree.items()}
