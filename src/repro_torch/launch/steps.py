"""Train, prefill, decode and serve steps, shared by the trainer and the
serving engine.

Counterpart of ``repro.launch.steps``.  The train step differentiates
``api.loss`` with respect to the parameter leaves (``torch.autograd``,
the reference's ``jax.value_and_grad``) and hands the gradients, after
``grad_transform``, to the functional optimizer.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models.registry import ModelAPI
from ..optim.optimizers import Optimizer
from ..tree import leaves, unflatten


def value_and_grad(loss_fn: Callable, params):
    """(loss, grads): ``loss_fn(params)`` and its gradient with respect to
    every leaf of ``params`` (a tree like it; zeros where the loss does
    not reach a leaf, as JAX gives)."""
    ps = leaves(params)
    loss = loss_fn(params)
    gs = torch.autograd.grad(loss, ps, allow_unused=True)
    gs = [torch.zeros_like(p) if g is None else g for p, g in zip(ps, gs)]
    return loss.detach(), unflatten(params, gs)


def make_train_step(api: ModelAPI, opt: Optimizer,
                    grad_transform: Optional[Callable] = None):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``grad_transform`` hooks in gradient compression / dedup-finetune
    masks (applied before the optimizer).
    """
    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(lambda p: api.loss(p, batch), params)
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt_state, gnorm = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}
    return train_step


def make_prefill_step(api: ModelAPI, max_len: Optional[int] = None):
    def prefill_step(params, batch):
        return api.prefill(params, batch, max_len)
    return prefill_step


def make_decode_step(api: ModelAPI):
    def decode_step(params, cache, tokens):
        return api.decode(params, cache, tokens)
    return decode_step


def make_serve_step(api: ModelAPI):
    """One new token against a filled cache (batch = {"tokens",
    "cache"})."""
    def serve_step(params, batch):
        logits, cache = api.decode(params, batch["cache"], batch["tokens"])
        return logits, cache
    return serve_step
