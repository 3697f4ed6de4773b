"""Duplicate-block detection (paper Sec. 4, Alg. 1) + baselines (Tab. 5).

The central object is :class:`Deduplicator`, which owns the incremental
LSH index (``idx`` in Alg. 1), the list of distinct physical blocks
(``L``), and per-model mappings ``F_T`` from logical block positions to
distinct-block ids.

Faithfulness notes:
  * Blocks are processed per layer, layers ordered by tensor size
    descending (Sec. 4.3); within a layer, ascending magnitude (q3).
  * Every ``k`` blocks the model is re-validated; once the accuracy drop
    exceeds ``t`` the model *stops deduplicating*: remaining blocks are
    inserted as their own new groups (Alg. 1 lines 23–27; the prose in
    Step 4 says "added to the corresponding group but not replaced" — we
    follow the algorithm listing, which keeps group⇄distinct 1:1).
  * No rollback of the last over-threshold batch (Sec. 7.3: "we do not
    roll back").
  * The validation-free variant (Sec. 4.3 "Alternative Approach") is
    ``validate=False`` + the LSH ``collision_threshold`` knob (Tab. 6).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .blocks import (BlockGrid, DEFAULT_BLOCK_SHAPE, block_tensor,
                     unblock_tensor)
from .lsh import LSHConfig, LSHIndex
from .magnitude import block_magnitudes

Evaluator = Callable[[Dict[str, np.ndarray]], float]
TensorRef = Tuple[str, str]  # (model, tensor)


@dataclasses.dataclass(frozen=True)
class DedupConfig:
    block_shape: Tuple[int, int] = DEFAULT_BLOCK_SHAPE
    lsh: LSHConfig = dataclasses.field(default_factory=LSHConfig)
    magnitude_stat: str = "q3"
    validate_every_k: int = 64          # "k" in Alg. 1
    accuracy_drop_threshold: float = 0.035  # "t" (paper uses 3.5%)
    validate: bool = True               # False => Tab. 6 threshold-only variant


@dataclasses.dataclass
class TensorEntry:
    name: str
    grid: BlockGrid
    dtype: np.dtype
    block_map: np.ndarray               # [num_blocks] -> distinct id (f_i in Alg. 1)


@dataclasses.dataclass
class DedupResult:
    model: str
    tensors: Dict[str, TensorEntry]
    total_blocks: int = 0
    deduped_blocks: int = 0             # logical blocks replaced by a pre-existing rep
    stopped: bool = False               # accuracy budget exhausted
    accuracy_before: Optional[float] = None
    accuracy_after: Optional[float] = None
    num_validations: int = 0
    index_query_seconds: float = 0.0


class Deduplicator:
    """Incremental cross-model block deduplication (the paper's Fig. 3)."""

    def __init__(self, cfg: Optional[DedupConfig] = None):
        self.cfg = cfg or DedupConfig()
        bh, bw = self.cfg.block_shape
        self.index = LSHIndex(bh * bw, self.cfg.lsh)
        # Distinct physical blocks ("L"); tombstoned with None on removal.
        self.distinct: List[Optional[np.ndarray]] = []
        # distinct id -> {(model, tensor): ref count}
        self.owners: List[Dict[TensorRef, int]] = []
        self._gid_to_did: Dict[int, int] = {}
        self._did_to_gid: Dict[int, int] = {}
        self.models: Dict[str, DedupResult] = {}

    # ------------------------------------------------------------------ utils
    @property
    def num_distinct(self) -> int:
        return sum(1 for b in self.distinct if b is not None)

    def pool(self, dtype=None) -> np.ndarray:
        """Stack live distinct blocks into ``[n, bh, bw]`` (tombstones kept
        as zero blocks so ids remain stable)."""
        bh, bw = self.cfg.block_shape
        out = np.zeros((len(self.distinct), bh, bw),
                       dtype=dtype or np.float32)
        for i, b in enumerate(self.distinct):
            if b is not None:
                out[i] = b
        return out

    def tensor_distinct_ids(self, model: str, tensor: str) -> np.ndarray:
        return np.unique(self.models[model].tensors[tensor].block_map)

    def materialize(self, model: str, tensor: str) -> np.ndarray:
        e = self.models[model].tensors[tensor]
        blocks = np.stack([self.distinct[d] for d in e.block_map])
        return unblock_tensor(blocks, e.grid).astype(e.dtype)

    def materialize_all(self, model: str) -> Dict[str, np.ndarray]:
        return {t: self.materialize(model, t)
                for t in self.models[model].tensors}

    def _new_distinct(self, block: np.ndarray, ref: TensorRef,
                      sig: np.ndarray, member) -> int:
        gid = self.index.insert_group(sig, member)
        did = len(self.distinct)
        self.distinct.append(np.array(block, copy=True))
        self.owners.append({ref: 1})
        self._gid_to_did[gid] = did
        self._did_to_gid[did] = gid
        return did

    def _add_ref(self, did: int, ref: TensorRef) -> None:
        self.owners[did][ref] = self.owners[did].get(ref, 0) + 1

    # ------------------------------------------------------------- Alg. 1 ---
    def add_model(self, model: str, tensors: Dict[str, np.ndarray],
                  evaluator: Optional[Evaluator] = None,
                  layers: Optional[Sequence[Sequence[str]]] = None
                  ) -> DedupResult:
        """Run Alg. 1 over every layer of ``model``; updates the shared index."""
        cfg = self.cfg
        if model in self.models:
            raise ValueError(f"model {model!r} already registered")
        res = DedupResult(model=model, tensors={})
        self.models[model] = res

        # Blocked working copies (mutated as blocks get replaced) so the
        # periodic evaluator sees the *deduplicated* model.
        blocked: Dict[str, np.ndarray] = {}
        for name, x in tensors.items():
            x = np.asarray(x)
            blk, grid = block_tensor(x, cfg.block_shape)
            blocked[name] = blk.astype(np.float32)
            res.tensors[name] = TensorEntry(
                name, grid, x.dtype,
                np.full(grid.num_blocks, -1, dtype=np.int64))
            res.total_blocks += grid.num_blocks

        def current_tensors() -> Dict[str, np.ndarray]:
            return {n: unblock_tensor(blocked[n], res.tensors[n].grid)
                    .astype(res.tensors[n].dtype)
                    for n in blocked}

        do_validate = cfg.validate and evaluator is not None
        if do_validate:
            res.accuracy_before = float(evaluator(current_tensors()))

        if layers is None:
            layers = [[n] for n in tensors]
        # Layers ordered by total tensor size descending (Sec. 4.3).
        layers = sorted(layers,
                        key=lambda ns: -sum(np.asarray(tensors[n]).size
                                            for n in ns))
        stopped = False
        for layer in layers:
            # Gather (tensor, block_id) for the whole layer, magnitude-sorted.
            names, bids, mags = [], [], []
            for n in layer:
                m = block_magnitudes(blocked[n], cfg.magnitude_stat)
                names.extend([n] * len(m))
                bids.extend(range(len(m)))
                mags.append(m)
            order = np.argsort(np.concatenate(mags), kind="stable")
            seq = [(names[i], bids[i]) for i in order]

            i = 0
            while i < len(seq):
                if stopped:
                    # Remaining blocks stay distinct (Alg. 1 lines 23–27).
                    for n, b in seq[i:]:
                        self._index_as_distinct(model, res, blocked, n, b)
                    break
                batch = seq[i: i + cfg.validate_every_k]
                for n, b in batch:
                    self._dedup_one(model, res, blocked, n, b)
                i += len(batch)
                if do_validate and i < len(seq):
                    res.num_validations += 1
                    acc = float(evaluator(current_tensors()))
                    if res.accuracy_before - acc > cfg.accuracy_drop_threshold:
                        stopped = True
            if stopped:
                # Stop applies to the whole model: remaining layers too.
                continue

        if do_validate:
            res.accuracy_after = float(evaluator(current_tensors()))
        res.stopped = stopped
        return res

    def _dedup_one(self, model: str, res: DedupResult,
                   blocked: Dict[str, np.ndarray], name: str, bid: int) -> None:
        block = blocked[name][bid]
        t0 = time.perf_counter()
        sig = self.index.lsh.signatures(block[None])[0]
        gid = self.index.query(sig)
        res.index_query_seconds += time.perf_counter() - t0
        ref: TensorRef = (model, name)
        member = (model, name, bid)
        if gid is not None:
            did = self._gid_to_did[gid]
            self.index.add_member(gid, member)
            self._add_ref(did, ref)
            blocked[name][bid] = self.distinct[did]      # replace by rep
            res.tensors[name].block_map[bid] = did
            res.deduped_blocks += 1
        else:
            res.tensors[name].block_map[bid] = \
                self._new_distinct(block, ref, sig, member)

    def _index_as_distinct(self, model: str, res: DedupResult,
                           blocked: Dict[str, np.ndarray],
                           name: str, bid: int) -> None:
        block = blocked[name][bid]
        sig = self.index.lsh.signatures(block[None])[0]
        res.tensors[name].block_map[bid] = self._new_distinct(
            block, (model, name), sig, (model, name, bid))

    # ------------------------------------------------- updates (Sec. 7.6.1) --
    def remove_model(self, model: str) -> None:
        """Approach-1: drop all refs; empty groups/tombstoned blocks removed."""
        res = self.models.pop(model)
        for name, e in res.tensors.items():
            ref: TensorRef = (model, name)
            for bid, did in enumerate(e.block_map):
                did = int(did)
                cnt = self.owners[did]
                cnt[ref] -= 1
                if cnt[ref] == 0:
                    del cnt[ref]
                gid = self._did_to_gid[did]
                dropped = self.index.remove_member(gid, (model, name, bid))
                if dropped:
                    self.distinct[did] = None            # tombstone
                    del self._did_to_gid[did]
                    del self._gid_to_did[gid]

    def update_model(self, model: str, tensors: Dict[str, np.ndarray],
                     evaluator: Optional[Evaluator] = None,
                     approach: int = 2) -> DedupResult:
        """Approach-1 (remove + re-insert) or Approach-2 (LSH delta)."""
        if approach == 1:
            self.remove_model(model)
            return self.add_model(model, tensors, evaluator)

        # Approach-2: only blocks whose LSH signature changed are
        # reprocessed (index query + validation skipped for the rest).
        old = self.models[model]
        plans = {}
        for name, x in tensors.items():
            blk, grid = block_tensor(np.asarray(x), self.cfg.block_shape)
            blk = blk.astype(np.float32)
            sigs = self.index.lsh.signatures(blk)
            olde = old.tensors.get(name)
            if olde is None or olde.grid != grid:
                mask = np.ones(len(blk), dtype=bool)
                old_map = None
            else:
                old_sigs = np.stack([
                    self.index.groups[self._did_to_gid[int(d)]].rep_signature
                    for d in olde.block_map])
                mask = np.any(sigs != old_sigs, axis=1)
                old_map = olde.block_map.copy()
            plans[name] = (blk, grid, sigs, mask, old_map,
                           np.asarray(x).dtype)

        self.remove_model(model)
        res = DedupResult(model=model, tensors={})
        self.models[model] = res
        blocked: Dict[str, np.ndarray] = {}
        for name, (blk, grid, sigs, mask, old_map, dtype) in plans.items():
            blocked[name] = blk
            res.tensors[name] = TensorEntry(
                name, grid, dtype,
                np.full(grid.num_blocks, -1, dtype=np.int64))
            res.total_blocks += grid.num_blocks
            for bid in range(grid.num_blocks):
                unchanged = (old_map is not None and not mask[bid])
                if unchanged:
                    did = int(old_map[bid])
                    # the old distinct block may have been tombstoned by
                    # remove_model if this model was its sole owner
                    if self.distinct[did] is not None \
                            and did in self._did_to_gid:
                        gid = self._did_to_gid[did]
                        self.index.add_member(gid, (model, name, bid))
                        self._add_ref(did, (model, name))
                        blocked[name][bid] = self.distinct[did]
                        res.tensors[name].block_map[bid] = did
                        if did != bid:
                            res.deduped_blocks += 1
                        continue
                # changed (or tombstoned): full Alg.-1 path for this block
                self._dedup_one(model, res, blocked, name, bid)
        n_changed = int(sum(m.sum() for _, _, _, m, om, _ in plans.values()
                            if om is not None)
                        + sum(len(m) for _, _, _, m, om, _ in plans.values()
                              if om is None))
        res.num_validations = max(
            1, n_changed // max(1, self.cfg.validate_every_k))
        if evaluator is not None:
            res.accuracy_after = float(evaluator(self.materialize_all(model)))
        return res

    # ------------------------------------------- reopened-store hydration --
    def rebuild_index(self) -> None:
        """Reconstruct the LSH index + group bookkeeping from the current
        distinct blocks and block maps (a store reopened from a
        :mod:`repro.storage` backend persists blocks and maps, not the
        index).  Signatures are recomputed vectorized under the *current*
        LSH config, so subsequent ``add_model``/``update_model`` calls
        dedup incrementally against the reloaded blocks exactly as if
        the store had never left memory."""
        bh, bw = self.cfg.block_shape
        self.index = LSHIndex(bh * bw, self.cfg.lsh)
        self._gid_to_did.clear()
        self._did_to_gid.clear()
        self.owners = [dict() for _ in self.distinct]
        live = [did for did, b in enumerate(self.distinct) if b is not None]
        if not live:
            return
        members_of: Dict[int, List[Tuple[str, str, int]]] = \
            {did: [] for did in live}
        for m, res in self.models.items():
            for name, e in res.tensors.items():
                for bid, did in enumerate(e.block_map):
                    did = int(did)
                    members_of[did].append((m, name, bid))
                    ref = (m, name)
                    self.owners[did][ref] = self.owners[did].get(ref, 0) + 1
        sigs = self.index.lsh.signatures(
            np.stack([self.distinct[did] for did in live]))
        for sig, did in zip(sigs, live):
            members = members_of[did] or [("__orphan__", "__orphan__", did)]
            gid = self.index.insert_group(sig, members[0])
            for ref in members[1:]:
                self.index.add_member(gid, ref)
            self._gid_to_did[gid] = did
            self._did_to_gid[did] = gid

    # ---------------------------------------------------- pagepack interface --
    def tensor_sets(self) -> Dict[TensorRef, frozenset]:
        """(model, tensor) -> frozenset of distinct ids (input to Sec. 5)."""
        out: Dict[TensorRef, frozenset] = {}
        for m, res in self.models.items():
            for name, e in res.tensors.items():
                out[(m, name)] = frozenset(int(d) for d in np.unique(e.block_map))
        return out

    def block_owners(self) -> Dict[int, frozenset]:
        """distinct id -> frozenset of owning (model, tensor) refs."""
        return {did: frozenset(cnt.keys())
                for did, cnt in enumerate(self.owners)
                if self.distinct[did] is not None and cnt}


# ===================================================================== baselines
def exact_dedup(blocks: np.ndarray) -> Tuple[np.ndarray, int, float]:
    """Mistique exact dedup: byte-identical blocks share one copy.

    Returns (block_map, num_distinct, seconds_per_query).
    """
    t0 = time.perf_counter()
    seen: Dict[bytes, int] = {}
    bmap = np.zeros(len(blocks), dtype=np.int64)
    nxt = 0
    for i, b in enumerate(np.asarray(blocks, dtype=np.float32)):
        h = hashlib.sha1(b.tobytes()).digest()
        if h in seen:
            bmap[i] = seen[h]
        else:
            seen[h] = nxt
            bmap[i] = nxt
            nxt += 1
    dt = (time.perf_counter() - t0) / max(1, len(blocks))
    return bmap, nxt, dt


def minhash_dedup(blocks: np.ndarray, num_perm: int = 32,
                  bins: int = 64, threshold: float = 0.7
                  ) -> Tuple[np.ndarray, int, float]:
    """Mistique *approximate* dedup: discretize values into bins, then
    MinHash the set of (position-bucket, value-bin) features.  Inherently
    slow (paper Tab. 5: 10+ s/block) — kept small-scale for benchmarks."""
    t0 = time.perf_counter()
    flat = np.asarray(blocks, dtype=np.float32).reshape(len(blocks), -1)
    lo, hi = flat.min(), flat.max() + 1e-9
    digit = ((flat - lo) / (hi - lo) * (bins - 1)).astype(np.int64)
    feats = digit + bins * np.arange(flat.shape[1])[None, :]   # (pos, bin) feature
    rng = np.random.default_rng(0)
    # Universal hashing h_i(x) = (a_i x + b_i) mod p
    p = (1 << 61) - 1
    a = rng.integers(1, p, size=num_perm, dtype=np.int64)
    b = rng.integers(0, p, size=num_perm, dtype=np.int64)
    reps: List[np.ndarray] = []
    bmap = np.zeros(len(blocks), dtype=np.int64)
    for i in range(len(blocks)):
        f = feats[i].astype(object)
        sig = np.array([int(min((int(ai) * f + int(bi)) % p))
                        for ai, bi in zip(a, b)], dtype=np.int64)
        match = -1
        for j, r in enumerate(reps):
            if (sig == r).mean() >= threshold:
                match = j
                break
        if match < 0:
            reps.append(sig)
            match = len(reps) - 1
        bmap[i] = match
    dt = (time.perf_counter() - t0) / max(1, len(blocks))
    return bmap, len(reps), dt


def pairwise_dedup(blocks: np.ndarray, dist_threshold: float,
                   magnitude_stat: str = "q3"
                   ) -> Tuple[np.ndarray, int, float]:
    """Enhanced pairwise comparison with magnitude ordering (Tab. 5 row 3):
    linear scan of representatives by Euclidean distance."""
    t0 = time.perf_counter()
    flat = np.asarray(blocks, dtype=np.float32).reshape(len(blocks), -1)
    order = np.argsort(block_magnitudes(np.asarray(blocks), magnitude_stat),
                       kind="stable")
    reps: List[int] = []
    bmap = np.zeros(len(blocks), dtype=np.int64)
    for i in order:
        match = -1
        if reps:
            d = np.linalg.norm(flat[np.array(reps)] - flat[i], axis=1)
            j = int(np.argmin(d))
            if d[j] <= dist_threshold:
                match = reps[j]
        if match < 0:
            reps.append(int(i))
            match = int(i)
        bmap[i] = match
    # renumber to dense ids
    uniq, dense = np.unique(bmap, return_inverse=True)
    dt = (time.perf_counter() - t0) / max(1, len(blocks))
    return dense, len(uniq), dt
