"""Optimizers (no external deps): AdamW and Adafactor.

Counterpart of ``repro.optim.optimizers``, with its formulas, defaults
and casts, as functions over parameter trees (nested dicts and lists of
tensors, :mod:`repro_torch.tree`):

* AdamW: fp32 ``m``/``v`` states, decoupled weight decay.
* Adafactor: factored second moment over the trailing two dims, no
  momentum, an RMS clip of the update.

Updates are computed in fp32 and cast back to the param dtype (bf16
params act as their own master copy).  The step counter is an int32
scalar on the params' device that starts at 0 and is incremented before
the update, and bias correction is in fp32.  ``update(grads, state,
params) -> (params, state, grad_norm)`` is functional: it returns new
trees (the new params require grad where the old ones did) and leaves
its arguments as they were.  ``torch.optim`` is not used: its Adafactor
is another algorithm.  ``state_specs(params, pspecs)`` gives the
state's ``PartitionSpec`` tree from the params' (``distributed.
sharding.param_specs``), as the reference's does: AdamW's ``m`` and
``v`` shard like their params; Adafactor's ``vr`` drops the spec's last
entry and ``vc`` its second-to-last.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..distributed.sharding import PartitionSpec as P
from ..tree import leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable         # params -> state
    update: Callable       # (grads, state, params) -> (params, state, gnorm)
    state_specs: Callable  # (params, param_specs tree) -> state specs tree


def cosine_schedule(base_lr: float, warmup: int = 200,
                    total: int = 10_000, min_frac: float = 0.1):
    def lr(step):
        step = step.to(F32)
        warm = base_lr * step / max(1, warmup)
        prog = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(l.to(F32) ** 2) for l in leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.to(F32) * scale, grads), norm


def _split(out, n: int):
    """A tree of n-tuples -> n trees."""
    is_tuple = lambda x: isinstance(x, tuple)    # noqa: E731
    return [tree_map(lambda o: o[i], out, is_leaf=is_tuple)
            for i in range(n)]


def _step0(params) -> torch.Tensor:
    device = leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=device)


def _new_param(p, value):
    """The updated leaf in p's dtype, a leaf that requires grad as p did."""
    return value.to(p.dtype).requires_grad_(p.requires_grad)


def adamw(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          schedule=None, max_grad_norm: float = 1.0) -> Optimizer:
    sched = schedule or (lambda s: lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=F32,    # noqa: E731
                                      device=p.device)
        return {"step": _step0(params),
                "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params):
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        step = state["step"] + 1
        lr_t = sched(step)
        bc1 = 1 - b1 ** step.to(F32)
        bc2 = 1 - b2 ** step.to(F32)

        def upd(g, m, v, p):
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            u = u + weight_decay * p.to(F32)
            return _new_param(p, p.to(F32) - lr_t * u), m, v

        new_p, new_m, new_v = _split(
            tree_map(upd, grads, state["m"], state["v"], params), 3)
        return new_p, {"step": step, "m": new_m, "v": new_v}, gnorm

    def state_specs(params, pspecs):
        return {"step": P(), "m": pspecs, "v": pspecs}

    return Optimizer(init, update, state_specs)


def adafactor(lr=1e-3, decay=0.8, eps=1e-30, weight_decay=0.0,
              schedule=None, max_grad_norm: float = 1.0) -> Optimizer:
    sched = schedule or (lambda s: lr)

    def _factored(p):
        return p.dim() >= 2

    def init(params):
        def st(p):
            kw = dict(dtype=F32, device=p.device)
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **kw),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **kw)}
            return {"v": torch.zeros(p.shape, **kw)}
        return {"step": _step0(params), "v": tree_map(st, params)}

    @torch.no_grad()
    def update(grads, state, params):
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        step = state["step"] + 1
        lr_t = sched(step)
        beta = 1.0 - (step.to(F32) + 1.0) ** (-decay)

        def upd(g, v, p):
            g2 = g * g + eps
            if _factored(p):
                vr = beta * v["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * v["vc"] + (1 - beta) * g2.mean(dim=-2)
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(vr.mean(dim=-1,
                                               keepdim=True)[..., None],
                                       min=eps))
                u = g / torch.sqrt(torch.clamp(denom, min=eps))
                nv = {"vr": vr, "vc": vc}
            else:
                nvv = beta * v["v"] + (1 - beta) * g2
                u = g / torch.sqrt(torch.clamp(nvv, min=eps))
                nv = {"v": nvv}
            # update clipping (Shazeer & Stern): RMS(u) <= 1
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp(rms, min=1.0)
            if weight_decay:
                u = u + weight_decay * p.to(F32)
            return _new_param(p, p.to(F32) - lr_t * u), nv

        new_p, new_v = _split(tree_map(upd, grads, state["v"], params), 2)
        return new_p, {"step": step, "v": new_v}, gnorm

    def state_specs(params, pspecs):
        def st(p, spec):
            parts = list(spec) + [None] * (len(p.shape) - len(spec))
            if len(p.shape) >= 2:
                # vr drops the last dim's axis; vc the second-to-last's.
                return {"vr": P(*parts[:-1]),
                        "vc": P(*(parts[:-2] + parts[-1:]))}
            return {"v": P(*parts)}
        return {"step": P(), "v": tree_map(st, params, pspecs)}

    return Optimizer(init, update, state_specs)


def make_optimizer(name: str, lr: float = 3e-4,
                   schedule=None) -> Optimizer:
    if name == "adamw":
        return adamw(lr=lr, schedule=schedule)
    if name == "adafactor":
        return adafactor(lr=lr, schedule=schedule)
    raise ValueError(f"unknown optimizer {name!r}")
