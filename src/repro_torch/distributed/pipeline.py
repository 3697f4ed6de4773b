"""Pipeline parallelism (GPipe schedule), single controller.

Counterpart of ``repro.distributed.pipeline``: layers are partitioned
into stages and microbatches stream through them, the handoff between
stages being one activation tensor a microbatch.  Bubble fraction =
(S-1)/(M+S-1) for S stages and M microbatches.

The reference runs the schedule SPMD (``shard_map`` over the ``pod``
axis, ``ppermute`` handoffs).  The port drives it from one process, as
it drives the sharded slab: stage s runs on ``devices[s]`` (default
``launch.mesh.shard_devices(S)``, so on one card every stage shares
``cuda:0``) and a handoff is a ``.to(next_device)`` copy.  The schedule
is the reference's: T = M + S - 1 ticks; at tick t stage 0 injects
microbatch ``min(t, M - 1)``, stage s works on what stage s - 1 handed
it at tick t - 1, and the last stage writes microbatch ``t - S + 1``.
Where the reference computes a bubble slot and throws it away (stage 0
re-injecting the last microbatch, a stage fed the zero buffer), the
port leaves the stage idle, so each stage runs each microbatch exactly
once.

``pipeline_apply`` is schedule-only and takes any per-stage function.

Self-check (the reference's workload: a 4-layer tanh MLP, 2 stages, 3
microbatches; on the CPU):

    python -m repro_torch.distributed.pipeline
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from ..tree import leaves, tree_map


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _stage_slices(stage_params, n_stages: Optional[int]):
    """Per-stage params: a list of per-stage trees, or one tree whose
    leaves carry a leading stage axis (the reference's layout)."""
    if isinstance(stage_params, (list, tuple)):
        return list(stage_params)
    n = n_stages or int(leaves(stage_params)[0].shape[0])
    return [tree_map(lambda a, s=s: a[s], stage_params) for s in range(n)]


def pipeline_apply(stage_fn: Callable, stage_params, microbatches, *,
                   devices: Optional[Sequence[torch.device]] = None,
                   kernel_mode: str = "auto"):
    """Run ``microbatches`` [M, ...] through all pipeline stages.

    ``stage_params``: a tree whose leaves carry a leading stage axis (as
    in the reference) or a list of per-stage trees; ``stage_fn(params,
    x) -> y`` applies one stage.  Returns the outputs [M, ...] on
    ``microbatches``' device.  Where the port differs from the
    reference's signature: no ``mesh`` / ``axis`` (the number of stages
    is the params' leading axis), and stage s runs on ``devices[s]``
    (default ``shard_devices(S, kernel_mode)``); each stage's params are
    used where they lie.
    """
    params = _stage_slices(stage_params, None)
    S = len(params)
    if devices is None:
        from ..launch.mesh import shard_devices
        devices = shard_devices(S, kernel_mode)
    devices = list(devices)
    if len(devices) != S:
        raise ValueError(f"pipeline_apply: {S} stages, {len(devices)} "
                         "devices")
    M = microbatches.shape[0]
    T = M + S - 1
    outs: List[Optional[torch.Tensor]] = [None] * M
    buf: List[Optional[torch.Tensor]] = [None] * S    # stage s's input
    for t in range(T):
        handoff: List[Optional[torch.Tensor]] = [None] * S
        for s in range(S):
            m = t - s                        # the microbatch stage s holds
            if not 0 <= m < M:
                continue                     # bubble: the stage idles
            x = microbatches[min(t, M - 1)].to(devices[0]) if s == 0 \
                else buf[s]
            y = stage_fn(params[s], x)
            if s + 1 < S:
                handoff[s + 1] = y.to(devices[s + 1])
            else:                            # the last stage, t - S + 1
                outs[t - (S - 1)] = y
        buf = handoff
    return torch.stack([o.to(microbatches.device) for o in outs])


def _self_check() -> float:
    """The reference's self-check workload on the CPU: a 4-layer tanh
    MLP split into 2 stages of 2 layers, 3 microbatches [8, 16]; returns
    the max error against the sequential chain."""
    import numpy as np
    rng = np.random.default_rng(0)
    W = torch.from_numpy((rng.standard_normal((4, 16, 16)) * 0.3)
                         .astype(np.float32))

    def two_layers(w_pair, x):
        for i in range(2):
            x = torch.tanh(x @ w_pair[i])
        return x

    stage_params = W.reshape(2, 2, 16, 16)       # [stages, 2, 16, 16]
    mb = torch.from_numpy(rng.standard_normal((3, 8, 16)).astype(np.float32))
    out = pipeline_apply(two_layers, stage_params, mb, kernel_mode="torch")
    ref = mb
    for i in range(4):
        ref = torch.tanh(ref @ W[i])
    err = float((out - ref).abs().max())
    print(f"pipeline self-check max err: {err:.2e}")
    assert err < 1e-6
    print(f"schedule: 2 stages x 3 microbatches, "
          f"bubble fraction {bubble_fraction(2, 3):.2f}")
    return err


if __name__ == "__main__":
    _self_check()
