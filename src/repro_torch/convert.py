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

Nothing here imports the JAX package: the caller hands over numpy
arrays and plain dictionaries.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from .core import DedupConfig, LSHConfig, ModelStore, StoreConfig

__all__ = ["store_config_from_dict", "store_from_arrays"]


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
