"""Block magnitude statistics (Sec. 4.3, Step 1 / Fig. 4).

The paper deduplicates blocks in *ascending* order of an aggregated
magnitude statistic, defaulting to the 3rd quartile of ``|w|`` because it
reflects both the magnitude and the quantity of large weights in a block.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

MagnitudeFn = Callable[[np.ndarray], np.ndarray]


def _flat_abs(blocks: np.ndarray) -> np.ndarray:
    return np.abs(np.asarray(blocks, dtype=np.float32)).reshape(len(blocks), -1)


def q3(blocks: np.ndarray) -> np.ndarray:
    return np.quantile(_flat_abs(blocks), 0.75, axis=1)


def q1(blocks: np.ndarray) -> np.ndarray:
    return np.quantile(_flat_abs(blocks), 0.25, axis=1)


def median(blocks: np.ndarray) -> np.ndarray:
    return np.median(_flat_abs(blocks), axis=1)


def mean(blocks: np.ndarray) -> np.ndarray:
    return _flat_abs(blocks).mean(axis=1)


def l2(blocks: np.ndarray) -> np.ndarray:
    return np.sqrt((_flat_abs(blocks) ** 2).sum(axis=1))


MAGNITUDE_FNS: Dict[str, MagnitudeFn] = {
    "q3": q3,
    "q1": q1,
    "median": median,
    "mean": mean,
    "l2": l2,
}


def block_magnitudes(blocks: np.ndarray, stat: str = "q3") -> np.ndarray:
    """[n, bh, bw] -> [n] magnitude scores (ascending order = dedup first)."""
    try:
        fn = MAGNITUDE_FNS[stat]
    except KeyError:
        raise ValueError(f"unknown magnitude stat {stat!r}; "
                         f"choose from {sorted(MAGNITUDE_FNS)}") from None
    return fn(blocks)
