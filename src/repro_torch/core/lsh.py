"""L2 (p-stable) Locality Sensitive Hashing for tensor blocks (Sec. 4.2.2).

``h(x) = floor((a . x + b) / r)`` with ``a ~ N(0, 1)``, ``b ~ U[0, r)``
(Datar et al. 2004).  Signatures are split into *bands* of ``rows_per_band``
hashes; two signatures *match* when at least ``collision_threshold`` bands
are identical (the knob evaluated in paper Tab. 6).

The index is incremental (paper Fig. 3): groups of approximately-equal
blocks, each with a representative (the first-indexed block).
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LSHConfig:
    num_bands: int = 16
    rows_per_band: int = 4
    r: float = 4.0                      # bucket width (absolute, in block-L2 units)
    collision_threshold: int = 12       # min matching bands for a match
    seed: int = 0

    @property
    def num_hashes(self) -> int:
        return self.num_bands * self.rows_per_band


class L2LSH:
    """Vectorized signature computation for flattened blocks."""

    def __init__(self, dim: int, cfg: LSHConfig):
        self.cfg = cfg
        self.dim = int(dim)
        rng = np.random.default_rng(cfg.seed)
        # Projections kept fp32: blocks may be bf16/fp16 on device.
        self.proj = rng.standard_normal((self.dim, cfg.num_hashes)).astype(np.float32)
        self.bias = (rng.random(cfg.num_hashes) * cfg.r).astype(np.float32)

    def signatures(self, blocks: np.ndarray) -> np.ndarray:
        """``blocks``: [n, *block_shape] -> int32 signatures [n, num_hashes]."""
        flat = np.asarray(blocks, dtype=np.float32).reshape(len(blocks), -1)
        if flat.shape[1] != self.dim:
            raise ValueError(f"block dim {flat.shape[1]} != LSH dim {self.dim}")
        h = np.floor((flat @ self.proj + self.bias) / self.cfg.r)
        return h.astype(np.int32)

    def band_keys(self, sig: np.ndarray) -> List[bytes]:
        """Signature [num_hashes] -> one hashable key per band."""
        b = self.cfg.num_bands
        rows = self.cfg.rows_per_band
        s = np.ascontiguousarray(sig.reshape(b, rows))
        return [s[i].tobytes() for i in range(b)]


def estimate_r(blocks: np.ndarray, quantile: float = 0.1,
               sample: int = 256, seed: int = 0) -> float:
    """Suggest a bucket width from data: the ``quantile`` of sampled
    pairwise block distances.  Blocks closer than ~r tend to collide on
    most bands; the paper tunes this trade-off via the collision
    threshold (Tab. 6), but r must sit near the intra-variant noise scale
    for the threshold knob to be meaningful."""
    flat = np.asarray(blocks, dtype=np.float32).reshape(len(blocks), -1)
    rng = np.random.default_rng(seed)
    n = len(flat)
    i = rng.integers(0, n, size=min(sample, n * n))
    j = rng.integers(0, n, size=len(i))
    keep = i != j
    if not keep.any():
        return 1.0
    d = np.linalg.norm(flat[i[keep]] - flat[j[keep]], axis=1)
    return float(max(np.quantile(d, quantile), 1e-6))


@dataclasses.dataclass
class Group:
    """A cluster of approximately-equal blocks."""

    gid: int
    rep_signature: np.ndarray           # signature of the representative
    members: List[Tuple[str, str, int]] = dataclasses.field(default_factory=list)
    # members: (model, tensor, block_id) refs — paper's (tensorID, blockID)


class LSHIndex:
    """Banded LSH index over block groups (incremental across models)."""

    def __init__(self, dim: int, cfg: Optional[LSHConfig] = None):
        self.cfg = cfg or LSHConfig()
        self.lsh = L2LSH(dim, self.cfg)
        self.groups: Dict[int, Group] = {}
        self._buckets: List[Dict[bytes, List[int]]] = [
            dict() for _ in range(self.cfg.num_bands)
        ]
        self._next_gid = 0

    def __len__(self) -> int:
        return len(self.groups)

    # -- queries ------------------------------------------------------------
    def query(self, sig: np.ndarray) -> Optional[int]:
        """Best-matching group id (>= collision_threshold bands) or None."""
        keys = self.lsh.band_keys(sig)
        cand: Counter = Counter()
        for band, key in enumerate(keys):
            for gid in self._buckets[band].get(key, ()):  # bucket collision
                cand[gid] += 1
        if not cand:
            return None
        gid, nbands = max(cand.items(), key=lambda kv: (kv[1], -kv[0]))
        if nbands >= self.cfg.collision_threshold:
            return gid
        return None

    # -- updates ------------------------------------------------------------
    def insert_group(self, sig: np.ndarray,
                     ref: Tuple[str, str, int]) -> int:
        gid = self._next_gid
        self._next_gid += 1
        self.groups[gid] = Group(gid, np.array(sig, copy=True), [ref])
        for band, key in enumerate(self.lsh.band_keys(sig)):
            self._buckets[band].setdefault(key, []).append(gid)
        return gid

    def add_member(self, gid: int, ref: Tuple[str, str, int]) -> None:
        self.groups[gid].members.append(ref)

    def remove_member(self, gid: int, ref: Tuple[str, str, int]) -> bool:
        """Remove a member ref.  Returns True if the group became empty and
        was dropped (paper Sec. 7.6.1 Approach-1)."""
        g = self.groups.get(gid)
        if g is None:
            return False
        try:
            g.members.remove(ref)
        except ValueError:
            pass
        if not g.members:
            for band, key in enumerate(self.lsh.band_keys(g.rep_signature)):
                bucket = self._buckets[band].get(key)
                if bucket and gid in bucket:
                    bucket.remove(gid)
            del self.groups[gid]
            return True
        return False

    def stats(self) -> Dict[str, float]:
        sizes = [len(g.members) for g in self.groups.values()]
        return {
            "num_groups": len(self.groups),
            "num_members": int(sum(sizes)),
            "max_group": int(max(sizes, default=0)),
        }
