"""Carry stores and weights from the JAX package into the port.

Two carriers:

  * the database itself — a store that ``repro.core.ModelStore.save``
    wrote to ``sqlite:///…`` (or a directory, or the object-store sim)
    opens with :meth:`repro_torch.core.ModelStore.open` as it is: both
    packages share the page and manifest format;
  * plain arrays — :func:`store_config_from_dict` rebuilds the port's
    :class:`~repro_torch.core.StoreConfig` from ``dataclasses.asdict`` of
    the reference's, and :func:`store_from_arrays` registers parameters
    exported as numpy arrays into a port :class:`ModelStore`.  With the
    same config and the same arrays in the same order, Alg. 1 makes the
    same dedup decisions and the two stores are byte-identical.

  * LM parameters — :func:`lm_tensors` flattens a parameter tree (the
    reference's pytree exported as nested numpy dicts, or the port's own
    ``init_params``) into the 2-D tensors the reference CLI registers,
    and returns the ``rebuild`` that turns served tensors back into the
    port's params.

Nothing here imports the JAX package: the caller hands over numpy
arrays and plain dictionaries.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple, Tuple

import numpy as np
import torch

from .core import DedupConfig, LSHConfig, ModelStore, StoreConfig

__all__ = ["store_config_from_dict", "store_from_arrays", "LMTensors",
           "lm_tensors"]

#: leaves the reference keeps in float32 whatever the model's dtype: norm
#: scales and biases, qk-norm scales, the MoE router, mamba's dt bias,
#: A_log, D and gated-norm scale
F32_LEAVES = ("scale", "bias", "q_norm", "k_norm", "router", "dt_bias",
              "A_log", "Dp", "ssm_norm")
#: the parameter groups whose leaves stack the layers on a leading axis
LAYERS = ("blocks", "dense_blocks", "enc_blocks", "dec_blocks")


def store_config_from_dict(d: Mapping[str, Any]) -> StoreConfig:
    """A :class:`StoreConfig` from ``dataclasses.asdict`` of a reference
    ``StoreConfig`` (or its JSON round trip, where tuples became lists)."""
    dd = dict(d.get("dedup", {}))
    lsh = LSHConfig(**dict(dd.pop("lsh", {})))
    if "block_shape" in dd:
        dd["block_shape"] = tuple(int(v) for v in dd["block_shape"])
    dedup = DedupConfig(lsh=lsh, **dd)
    rest = {k: v for k, v in d.items() if k != "dedup"}
    return StoreConfig(dedup=dedup, **rest)


def store_from_arrays(cfg: StoreConfig,
                      models: Mapping[str, Mapping[str, np.ndarray]]
                      ) -> ModelStore:
    """Register ``{model: {tensor: array}}`` (numpy, in the given order)
    into a fresh port store."""
    store = ModelStore(cfg)
    for model, tensors in models.items():
        arrays: Dict[str, np.ndarray] = {
            name: np.asarray(arr) for name, arr in tensors.items()}
        store.register(model, arrays)
    return store


class LMTensors(NamedTuple):
    """What registering an LM into the store takes, and what serving it
    gives back."""
    tensors: Dict[str, np.ndarray]         # key -> float32, at most 2-D
    shapes: Dict[str, Tuple[int, ...]]     # key -> the leaf's own shape
    dtypes: Dict[str, torch.dtype]         # key -> the dtype it serves in
    rebuild: Callable                      # (tensors, device=None) -> params


def _leaves(tree, prefix=()):
    """(path, leaf) in the order ``jax.tree_util`` flattens a dict tree
    (keys sorted at every level)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_dtype(dt) -> torch.dtype:
    return dt if isinstance(dt, torch.dtype) else getattr(torch, str(dt))


def lm_tensors(params: Mapping, dtype=None,
               per_layer: bool = False) -> LMTensors:
    """Flatten an LM parameter tree for the dedup store.

    Keys are the leaf paths joined with ``/`` (``blocks/attn/wq``), as
    the reference CLI names them.  Each leaf is registered as float32:
    a leaf of more than two dimensions as ``(shape[0], -1)``, the rest
    as they are.  ``dtype=None`` serves every leaf in its own dtype
    (a bfloat16 leaf exported from JAX stays bfloat16); a given
    ``dtype`` serves the matrices in it and the norm leaves
    (:data:`F32_LEAVES`) in float32, as the reference's ``init`` types
    them.

    ``per_layer=True`` registers each layer of a stacked group
    (:data:`LAYERS`) as its own matrices (``blocks/0/attn/wq``): a
    stacked ``[L, d, n]`` leaf canonicalised to ``(L, d * n)`` pads L up
    to a whole row block and inflates the store (``core/blocks.py``), so
    a full-width store holds per-layer matrices.  The params come back
    with such a group as a list of per-layer dicts, which the port's
    models take.

    ``rebuild(tensors, device=None)`` accepts numpy arrays (placed on
    ``device``, the CPU by default) or tensors (left on their device),
    reshapes each to its leaf's shape and casts it to its dtype."""
    tensors: Dict[str, np.ndarray] = {}
    shapes: Dict[str, Tuple[int, ...]] = {}
    dtypes: Dict[str, torch.dtype] = {}
    for path, leaf in _leaves(params):
        arr = np.asarray(leaf)
        if dtype is None:
            dt = _torch_dtype(arr.dtype.name)
        else:
            dt = torch.float32 if path[-1] in F32_LEAVES \
                else _torch_dtype(dtype)
        parts = [(path, arr)]
        if per_layer and path[0] in LAYERS:
            parts = [((path[0], str(i)) + path[1:], arr[i])
                     for i in range(arr.shape[0])]
        for p, a in parts:
            key = "/".join(p)
            a32 = np.asarray(a, np.float32)
            tensors[key] = a32.reshape(a32.shape[0], -1) \
                if a32.ndim > 2 else a32
            shapes[key] = tuple(a.shape)
            dtypes[key] = dt

    def rebuild(ts: Mapping, device=None) -> Dict:
        out: Dict = {}
        for key, shape in shapes.items():
            t = ts[key]
            if isinstance(t, np.ndarray):
                t = torch.as_tensor(t if t.flags.writeable else t.copy(),
                                    device=device)
            elif device is not None:
                t = t.to(device)
            node = out
            path = key.split("/")
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = t.reshape(shape).to(dtypes[key])
        for name in LAYERS:
            grp = out.get(name)
            if grp and all(k.isdigit() for k in grp):
                out[name] = [grp[str(i)] for i in range(len(grp))]
        return out

    return LMTensors(tensors, shapes, dtypes, rebuild)
