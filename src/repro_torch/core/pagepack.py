"""Packing distinct tensor blocks into pages (paper Sec. 5).

Every tensor must be *exactly* the union of a subset of pages (MTPPDP);
minimizing stored pages is NP-hard (reduction from Set Basis, Thm. 1).

Implemented strategies (paper Tab. 7):
  * ``pack_dedup_base``  — DedupBase: pack in write order, drop duplicate pages.
  * ``pack_greedy1``     — Alg. 2: per-equivalent-class packing.
  * ``pack_greedy2``     — Alg. 3: largest-tensor-first / hottest-block-first.
  * ``pack_two_stage``   — Alg. 2 then Alg. 3 on blocks from non-full pages.

A *page* is an ordered list of distinct-block ids (its slot layout); pages
may overlap in blocks (Alg. 3 may duplicate — Sec. 5.3 bounds the copies).
The coverage invariant (checked by :func:`check_coverage`, and by a
hypothesis property test) is: for every tensor, the union of the contents
of its assigned pages equals exactly its set of distinct blocks.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, FrozenSet, List, Mapping, Sequence, Tuple

import numpy as np

TensorRef = Tuple[str, str]


@dataclasses.dataclass
class PackResult:
    pages: List[List[int]]                      # page id -> ordered block slots
    tensor_pages: Dict[TensorRef, List[int]]    # tensor -> page ids (exact cover)
    strategy: str = ""

    @property
    def num_pages(self) -> int:
        return len(self.pages)

    def num_shared_pages(self) -> int:
        counts: Dict[int, int] = defaultdict(int)
        for pids in self.tensor_pages.values():
            for p in set(pids):
                counts[p] += 1
        return sum(1 for c in counts.values() if c > 1)

    def pages_of(self, tensor: TensorRef) -> List[List[int]]:
        return [self.pages[p] for p in self.tensor_pages[tensor]]


def equivalent_classes(tensor_sets: Mapping[TensorRef, FrozenSet[int]]
                       ) -> Dict[FrozenSet[TensorRef], List[int]]:
    """Group distinct blocks by the exact set of tensors owning them
    (Sec. 5.2, Fig. 6)."""
    owners: Dict[int, set] = defaultdict(set)
    for t, blocks in tensor_sets.items():
        for b in blocks:
            owners[b].add(t)
    classes: Dict[FrozenSet[TensorRef], List[int]] = defaultdict(list)
    for b in sorted(owners):
        classes[frozenset(owners[b])].append(b)
    return dict(classes)


def _chunk(blocks: Sequence[int], l: int) -> List[List[int]]:
    return [list(blocks[i: i + l]) for i in range(0, len(blocks), l)]


# --------------------------------------------------------------- DedupBase ---
def pack_dedup_base(tensor_seqs: Mapping[TensorRef, np.ndarray],
                    l: int) -> PackResult:
    """Default DB paging: blocks packed in write order per tensor, then
    byte-identical pages deduplicated (paper Fig. 5 'default packing')."""
    pages: List[List[int]] = []
    seen: Dict[Tuple[int, ...], int] = {}
    tensor_pages: Dict[TensorRef, List[int]] = {}
    for t, seq in tensor_seqs.items():
        pids: List[int] = []
        for chunk in _chunk([int(x) for x in seq], l):
            key = tuple(chunk)
            if key not in seen:
                seen[key] = len(pages)
                pages.append(chunk)
            pids.append(seen[key])
        tensor_pages[t] = pids
    return PackResult(pages, tensor_pages, "dedup_base")


# ------------------------------------------------------------------ Alg. 2 ---
def pack_greedy1(tensor_sets: Mapping[TensorRef, FrozenSet[int]],
                 l: int) -> PackResult:
    """Equivalent-class greedy (Alg. 2).  ``Alg2(P) <= OPT + 2^k - 1``."""
    classes = equivalent_classes(tensor_sets)
    pages: List[List[int]] = []
    tensor_pages: Dict[TensorRef, List[int]] = defaultdict(list)
    for owners in sorted(classes, key=lambda o: (-len(classes[o]), sorted(o))):
        for chunk in _chunk(classes[owners], l):
            pid = len(pages)
            pages.append(chunk)
            for t in owners:
                tensor_pages[t].append(pid)
    for t in tensor_sets:
        tensor_pages.setdefault(t, [])
    return PackResult(pages, dict(tensor_pages), "greedy1")


# ------------------------------------------------------------------ Alg. 3 ---
def _pack_approx(tensor_sets: Mapping[TensorRef, FrozenSet[int]],
                 l: int,
                 initial_pages: List[List[int]],
                 sharing_freq: Mapping[int, int],
                 class_of: Mapping[int, int]) -> Tuple[List[List[int]],
                                                       Dict[TensorRef, List[int]]]:
    """Alg. 3 core: largest-tensor-first, reuse packed pages, then pack the
    remainder hottest-block-first (sharing frequency, then class order)."""
    pages = [list(p) for p in initial_pages]
    page_sets = [frozenset(p) for p in pages]
    tensor_pages: Dict[TensorRef, List[int]] = {}
    order = sorted(tensor_sets, key=lambda t: (-len(tensor_sets[t]), t))
    for t in order:
        tset = tensor_sets[t]
        covered: set = set()
        pids: List[int] = []
        # Greedy maximal reusable subset: biggest new-coverage subset pages first.
        candidates = [i for i, ps in enumerate(page_sets) if ps and ps <= tset]
        candidates.sort(key=lambda i: -len(page_sets[i]))
        for i in candidates:
            new = page_sets[i] - covered
            if new:
                covered |= page_sets[i]
                pids.append(i)
        delta = sorted(tset - covered,
                       key=lambda b: (-sharing_freq.get(b, 1),
                                      class_of.get(b, 0), b))
        for chunk in _chunk(delta, l):
            pid = len(pages)
            pages.append(chunk)
            page_sets.append(frozenset(chunk))
            pids.append(pid)
        tensor_pages[t] = pids
    return pages, tensor_pages


def pack_greedy2(tensor_sets: Mapping[TensorRef, FrozenSet[int]],
                 l: int) -> PackResult:
    """Alg. 3 applied to the whole problem (Tab. 7 'Greedy-2')."""
    classes = equivalent_classes(tensor_sets)
    class_of: Dict[int, int] = {}
    freq: Dict[int, int] = {}
    for ci, owners in enumerate(sorted(classes, key=lambda o: sorted(o))):
        for b in classes[owners]:
            class_of[b] = ci
            freq[b] = len(owners)
    pages, tensor_pages = _pack_approx(tensor_sets, l, [], freq, class_of)
    return PackResult(pages, tensor_pages, "greedy2")


# --------------------------------------------------------------- Two-stage ---
def pack_two_stage(tensor_sets: Mapping[TensorRef, FrozenSet[int]],
                   l: int) -> PackResult:
    """Stage 1 = Alg. 2 keeping only *full* pages; stage 2 = Alg. 3 over the
    blocks that landed in non-full pages (Sec. 5.2)."""
    classes = equivalent_classes(tensor_sets)
    class_of: Dict[int, int] = {}
    freq: Dict[int, int] = {}
    for ci, owners in enumerate(sorted(classes, key=lambda o: sorted(o))):
        for b in classes[owners]:
            class_of[b] = ci
            freq[b] = len(owners)

    full_pages: List[List[int]] = []
    full_owner: List[FrozenSet[TensorRef]] = []
    leftover: Dict[TensorRef, set] = defaultdict(set)
    for owners in sorted(classes, key=lambda o: (-len(classes[o]), sorted(o))):
        blocks = classes[owners]
        n_full = (len(blocks) // l) * l
        for chunk in _chunk(blocks[:n_full], l):
            full_pages.append(chunk)
            full_owner.append(owners)
        for b in blocks[n_full:]:
            for t in owners:
                leftover[t].add(b)

    stage2_sets = {t: frozenset(bs) for t, bs in leftover.items() if bs}
    pages, s2_tensor_pages = _pack_approx(stage2_sets, l, list(full_pages),
                                          freq, class_of)

    tensor_pages: Dict[TensorRef, List[int]] = defaultdict(list)
    for pid, owners in enumerate(full_owner):
        for t in owners:
            tensor_pages[t].append(pid)
    for t, pids in s2_tensor_pages.items():
        tensor_pages[t].extend(pids)
    for t in tensor_sets:
        tensor_pages.setdefault(t, [])
    return PackResult(pages, dict(tensor_pages), "two_stage")


STRATEGIES = {
    "dedup_base": None,   # needs logical sequences, see pack()
    "greedy1": pack_greedy1,
    "greedy2": pack_greedy2,
    "two_stage": pack_two_stage,
}


def pack(tensor_sets: Mapping[TensorRef, FrozenSet[int]], l: int,
         strategy: str = "two_stage",
         tensor_seqs: Mapping[TensorRef, np.ndarray] = None) -> PackResult:
    if strategy == "dedup_base":
        if tensor_seqs is None:
            raise ValueError("dedup_base needs logical block sequences")
        return pack_dedup_base(tensor_seqs, l)
    try:
        fn = STRATEGIES[strategy]
    except KeyError:
        raise ValueError(f"unknown strategy {strategy!r}") from None
    return fn(tensor_sets, l)


# ------------------------------------------------------------- validation ---
def check_coverage(result: PackResult,
                   tensor_sets: Mapping[TensorRef, FrozenSet[int]],
                   l: int) -> None:
    """MTPPDP conditions: page size <= l and exact cover per tensor."""
    for p in result.pages:
        assert 0 < len(p) <= l, f"page size {len(p)} violates limit {l}"
    for t, tset in tensor_sets.items():
        union = set()
        for pid in result.tensor_pages[t]:
            union |= set(result.pages[pid])
        assert union == set(tset), (
            f"tensor {t}: page union != block set "
            f"(missing={set(tset) - union}, extra={union - set(tset)})")


def alg2_bound(tensor_sets: Mapping[TensorRef, FrozenSet[int]], l: int) -> int:
    """Thm. 2 upper bound: OPT_lower + 2^k - 1 where OPT >= ceil(|∪t_i|/l)."""
    all_blocks = set()
    for s in tensor_sets.values():
        all_blocks |= s
    k = len(tensor_sets)
    return -(-len(all_blocks) // l) + (1 << k) - 1
