"""Training launcher: the port's counterpart of ``repro.launch.train``.

Fault-tolerance features, as in the reference:
  * ``--resume auto``: restart from the newest complete checkpoint
    (the checkpoint format is the reference's: either package resumes
    the other's run).
  * host-sharded deterministic data: (seed, step, host) -> batch, so
    elastic re-mesh (``--hosts`` change across restarts) replays cleanly.
  * ``--compress-grads``: int8 error-feedback gradient compression.

Initial params are the port's ``init_params`` drawn from ``--seed`` in
the reference's dtypes (``convert.train_params``); the loss runs the
plain attention under autograd (the kernels have no backward).  The
step runs on ``--device`` (``cuda`` by default; without a CUDA device it
raises, and ``cpu`` runs only when asked).  :func:`train` takes a
config and the parsed flags, so a caller may hand it a config whose
depth is cut.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \\
      --reduced --steps 20 --batch 8 --seq 64 --ckpt /tmp/ckpt --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config, reduced
from ..convert import train_params
from ..data.pipeline import token_batches
from ..distributed.compression import (compress_with_feedback,
                                       init_error_state)
from ..models import build
from ..optim import cosine_schedule, make_optimizer
from ..tree import tree_map
from .steps import make_train_step, value_and_grad


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", default=None, choices=[None, "auto"])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--hosts", type=int, default=1)
    ap.add_argument("--host-index", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--overfit", action="store_true",
                    help="repeat the step-0 batch (optimizer smoke test: "
                         "uniform-random streams are at the entropy floor)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda by default; cpu "
                         "only when asked)")
    return ap.parse_args(argv)


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device; pass --device cpu to "
                           "train on the CPU")
    return device


def train(cfg, args: argparse.Namespace, init=None) -> dict:
    """Train ``cfg`` as the flags in ``args`` say.  ``init``, where given,
    is the numpy tree ``init_params`` draws from ``--seed`` (a caller that
    trains one config several times draws it once).  Returns the losses,
    the final params and optimizer state, and each step's seconds (host
    clock, ending when the step's loss reached the host)."""
    device = _device(args.device)
    api = build(cfg)
    opt = make_optimizer(cfg.optimizer, lr=args.lr,
                         schedule=cosine_schedule(args.lr, warmup=5,
                                                  total=args.steps))

    if init is None:
        init = api.init(args.seed, args.seq * 2)
    params = train_params(init, cfg, device)
    opt_state = opt.init(params)
    err_state = init_error_state(params) if args.compress_grads else None

    if args.compress_grads:
        def step_fn(params, opt_state, err, batch):
            loss, grads = value_and_grad(lambda p: api.loss(p, batch),
                                         params)
            grads, err = compress_with_feedback(grads, err)
            params, opt_state, gnorm = opt.update(grads, opt_state, params)
            return params, opt_state, err, {"loss": loss,
                                            "grad_norm": gnorm}
    else:
        base = make_train_step(api, opt)

    start = 0
    mgr = CheckpointManager(args.ckpt) if args.ckpt else None
    if mgr and args.resume == "auto":
        got = mgr.restore_latest(params, opt_state)
        if got:
            start, params, opt_state, manifest = got
            params = tree_map(lambda t: t.requires_grad_(), params)
            print(f"[resume] restored step {start} from {args.ckpt}")

    data = token_batches(cfg.vocab, args.batch, args.seq, seed=args.seed,
                         host_index=args.host_index, host_count=args.hosts)
    # Fast-forward the deterministic stream to the resume point.
    for _ in range(start):
        next(data)

    def on_device(b):
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    losses, step_s = [], []
    t0 = time.perf_counter()
    fixed = on_device(next(data)) if args.overfit else None
    for step in range(start, args.steps):
        ts = time.perf_counter()
        batch = fixed if args.overfit else on_device(next(data))
        if args.compress_grads:
            params, opt_state, err_state, metrics = step_fn(
                params, opt_state, err_state, batch)
        else:
            params, opt_state, metrics = base(params, opt_state, batch)
        loss = float(metrics["loss"])
        step_s.append(time.perf_counter() - ts)
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({time.perf_counter()-t0:.1f}s)")
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, params, opt_state,
                     extra={"arch": cfg.name, "loss": loss})
    if mgr:
        mgr.save(args.steps, params, opt_state,
                 extra={"arch": cfg.name, "loss": losses[-1]})
    return {"losses": losses, "params": params, "opt_state": opt_state,
            "step_seconds": step_s}


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    return train(cfg, args)


if __name__ == "__main__":
    main()
