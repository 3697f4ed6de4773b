"""Fault-tolerant checkpointing.

Counterpart of ``repro.checkpoint.manager``, in its on-disk format, so
each package restores the other's checkpoints:

* **Atomic commit**: a checkpoint directory is staged as ``tmp-<step>``
  and ``os.replace``d to ``step-<n>`` only after every leaf + manifest is
  on disk; a crash mid-save never corrupts the latest checkpoint.
* **Auto-resume**: ``restore_latest`` scans for the newest *complete*
  step (manifest present), so ``train.py --resume auto`` restarts after
  node failure with zero operator input.
* **Format**: ``params.npz`` and ``opt_state.npz`` hold one array a leaf
  under its path (dict keys and list indices joined with ``/``, as
  ``jax.tree_util`` names them), ``manifest.json`` the step, the extra
  record and whether optimizer state was saved.  A bf16 leaf is written
  as raw 2-byte void (``|V2``: what ``np.savez`` writes for a JAX bf16
  array) and read back through an int16 view.
* Restored leaves take the dtype, shape and device of the ``like``
  tree's leaves (unsharded arrays in the file; the trainer places them).
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..tree import leaves_with_path, tree_map

_VOID2 = np.dtype("V2")


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_VOID2)
    return t.numpy()


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {_key(path): _to_numpy(leaf)
            for path, leaf in leaves_with_path(tree)}


def _from_numpy(arr: np.ndarray, like) -> Any:
    if not isinstance(like, torch.Tensor):
        return arr
    if arr.dtype.kind == "V":                    # bf16 saved as raw bytes
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.require(arr, requirements="W"))
    return t.to(device=like.device, dtype=like.dtype).reshape(like.shape)


def _unflatten(like, flat):
    """``like``'s tree with each leaf read from ``flat`` (a dict or an
    open ``.npz``, read one leaf at a time) under its path."""
    paths = iter(path for path, _ in leaves_with_path(like))
    return tree_map(lambda leaf: _from_numpy(flat[_key(next(paths))], leaf),
                    like)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ----------------------------------------------------------------- save --
    def save(self, step: int, params, opt_state=None,
             extra: Optional[Dict[str, Any]] = None) -> str:
        stage = os.path.join(self.dir, f"tmp-{step}")
        final = os.path.join(self.dir, f"step-{step}")
        if os.path.exists(stage):
            shutil.rmtree(stage)
        os.makedirs(stage)
        np.savez(os.path.join(stage, "params.npz"), **_flatten(params))
        if opt_state is not None:
            np.savez(os.path.join(stage, "opt_state.npz"),
                     **_flatten(opt_state))
        manifest = {"step": step, "extra": extra or {},
                    "has_opt": opt_state is not None}
        with open(os.path.join(stage, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(stage, final)                 # atomic commit
        self._gc()
        return final

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step-{s}"),
                          ignore_errors=True)

    # -------------------------------------------------------------- restore --
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step-(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like_params, like_opt=None
                ) -> Tuple[Any, Any, Dict]:
        d = os.path.join(self.dir, f"step-{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "params.npz")) as pz:
            params = _unflatten(like_params, pz)
        opt = None
        if like_opt is not None and manifest.get("has_opt"):
            with np.load(os.path.join(d, "opt_state.npz")) as oz:
                opt = _unflatten(like_opt, oz)
        return params, opt, manifest

    def restore_latest(self, like_params, like_opt=None):
        step = self.latest_step()
        if step is None:
            return None
        params, opt, manifest = self.restore(step, like_params, like_opt)
        return step, params, opt, manifest
