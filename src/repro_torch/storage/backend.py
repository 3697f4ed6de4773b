"""PageBackend: the pluggable persistence API under ModelStore (DESIGN.md §4).

The paper's thesis is that deduplicated models live *in a database*: the
page — not the tensor — is the unit of storage, keyed by content hash.
``PageBackend`` is that contract.  A backend stores opaque page arrays
(``[blocks_per_page, bh, bw]`` in the store's native page dtype) under
content hashes, plus one manifest (the relational metadata: models →
tensors → block maps → pages) committed atomically/transactionally.

Implementations in this package:

  * :class:`~repro.storage.localdir.LocalDirBackend` — content-addressed
    ``page-<hash>.npy`` files + ``manifest.json`` (the historical
    ``ModelStore.save(path)`` format, unchanged on disk).
  * :class:`~repro.storage.sqlite.SQLiteBackend` — pages as BLOB rows and
    the manifest as proper relational tables (``models`` / ``tensors`` /
    ``manifest_pages`` / ``tensor_pages``) committed in one transaction:
    the paper's native habitat, stdlib-only.
  * :class:`~repro.storage.objsim.ObjectStoreSimBackend` — latency/
    bandwidth-injected wrapper simulating a remote object store (the
    fig-8 "working set exceeds the pool" regime).
  * :class:`MemoryBackend` (here) — dict-backed, for tests and as the
    default inner store of the object-store simulator.

``microbench()`` measures the backend's grouped-fetch characteristics and
returns a :class:`StorageProfile` (bandwidth, seek) that calibrates the
serving engine's :class:`~repro.serving.engine.StorageModel` virtual
clock — replacing the hardcoded hdd/ssd/nvme presets with numbers from
the tier actually serving the pages.
"""
from __future__ import annotations

import abc
import dataclasses
import time
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

MANIFEST_VERSION = 2

#: reserved hash prefix for microbench scratch pages (never collides with
#: real content hashes, which are hex)
_BENCH_PREFIX = "zbench-"


def resolve_dtype(name) -> np.dtype:
    """np.dtype lookup that also resolves ml_dtypes extras (bfloat16)
    when numpy alone doesn't know the name."""
    try:
        return np.dtype(name)
    except TypeError:
        import ml_dtypes
        return np.dtype(getattr(ml_dtypes, str(name)))


class ManifestConflictError(RuntimeError):
    """Optimistic-locking conflict: another writer committed a manifest
    after this handle last observed one.  The stale writer's transaction
    is rolled back; reload the manifest (``load_manifest``) to adopt the
    winner's state, re-apply the mutation, and commit again."""


@dataclasses.dataclass(frozen=True)
class StorageProfile:
    """Calibrated fetch model of a backend: ``seek + nbytes / bandwidth``."""
    backend: str                 # scheme/name of the measured backend
    bandwidth: float             # sustained grouped-read bytes/second
    seek: float                  # per-request fixed overhead, seconds
    page_bytes: int = 0          # page size the calibration used

    def fetch_seconds(self, nbytes: int) -> float:
        return self.seek + nbytes / self.bandwidth


class PageBackend(abc.ABC):
    """Abstract content-addressed page store + manifest commit point.

    Pages are ndarray values keyed by content-hash strings; the backend
    treats both as opaque (hashing and dtype policy live in ModelStore).
    ``get_pages`` is *grouped*: one call fetches a whole miss set so a
    backend can amortize its per-request overhead (one seek / one SQL
    query / one object-store round trip) across the batch.
    """

    scheme: str = "abstract"

    # ------------------------------------------------------------- pages --
    @abc.abstractmethod
    def put_pages(self, pages: Mapping[str, np.ndarray]) -> int:
        """Store pages by hash; already-present hashes are skipped
        (content addressing dedups on the backend too).  Returns the
        number of pages newly written."""

    @abc.abstractmethod
    def get_pages(self, hashes: Sequence[str]) -> Dict[str, np.ndarray]:
        """Grouped fetch: all requested pages in ONE backend request.
        Raises ``KeyError`` on the first missing hash."""

    @abc.abstractmethod
    def list_pages(self) -> List[str]:
        """All stored page hashes (sorted)."""

    @abc.abstractmethod
    def delete_pages(self, hashes: Sequence[str]) -> int:
        """Remove pages; unknown hashes are ignored.  Returns the number
        actually deleted (the orphan-pruning hook for ``ModelStore.save``)."""

    # ---------------------------------------------------------- manifest --
    @abc.abstractmethod
    def commit_manifest(self, manifest: Dict) -> None:
        """Atomically replace the manifest: a reader must observe either
        the previous manifest or this one, never a torn state (atomic
        rename for files, one transaction for SQL)."""

    @abc.abstractmethod
    def load_manifest(self) -> Dict:
        """The last committed manifest; ``FileNotFoundError`` if none."""

    def has_manifest(self) -> bool:
        try:
            self.load_manifest()
            return True
        except FileNotFoundError:
            return False

    # ------------------------------------------------------------ journal --
    # The write-ahead intent journal (storage/journal.py, DESIGN.md §11):
    # multi-step mutations append an intent before touching pages, a done
    # marker after, and ``journal_rewrite`` compacts/clears atomically.
    # Recovery on open replays whatever is left.  The base implementation
    # is in-process (exactly as durable as MemoryBackend itself); file and
    # SQL backends override with fsync'd / transactional storage.

    def journal_append(self, record: Dict) -> int:
        """Durably append one record; assigns and returns the next ``seq``
        unless the record already carries one (done markers echo their
        intent's seq)."""
        j = self.__dict__.setdefault("_journal", [])
        if "seq" not in record:
            record = {**record,
                      "seq": max((r.get("seq", 0) for r in j), default=0) + 1}
        j.append(dict(record))
        return int(record["seq"])

    def journal_records(self) -> List[Dict]:
        """All journal records in append order (empty = clean store)."""
        return [dict(r) for r in self.__dict__.get("_journal", [])]

    def journal_rewrite(self, records: Sequence[Dict]) -> None:
        """Atomically replace the journal (compaction; ``[]`` clears)."""
        self.__dict__["_journal"] = [dict(r) for r in records]

    def sweep_temp(self) -> int:
        """Remove staging debris a crash can strand (``*.tmp`` files for
        directory backends); returns how many items were swept."""
        return 0

    # ------------------------------------------------------------- admin --
    def url(self) -> str:
        """Round-trippable URL (``open_backend(b.url())`` reopens it)."""
        return f"{self.scheme}://"

    def close(self) -> None:
        """Release handles (no-op for stateless backends)."""

    # -------------------------------------------------------- calibration --
    def microbench(self, page_bytes: int = 128 * 1024, pages: int = 8,
                   repeats: int = 3) -> StorageProfile:
        """Measure (seek, bandwidth) with scratch pages, then clean up.

        Two timed operations per repeat — a single-page get (``seek +
        b/bw``) and a grouped ``pages``-page get (``seek + n*b/bw``) —
        give two equations in two unknowns; medians over ``repeats`` keep
        one scheduler hiccup from poisoning the calibration.  Backends
        with *injected* performance (the object-store sim) override this
        and return their configured profile directly.
        """
        side = max(1, int(np.sqrt(page_bytes / 4)))
        rng = np.random.default_rng(0)
        scratch = {f"{_BENCH_PREFIX}{i:04d}":
                   rng.standard_normal((side, side)).astype(np.float32)
                   for i in range(pages)}
        nbytes = side * side * 4
        names = sorted(scratch)
        self.put_pages(scratch)
        try:
            t_one, t_group = [], []
            for _ in range(repeats):
                t0 = time.perf_counter()
                self.get_pages(names[:1])
                t_one.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                self.get_pages(names)
                t_group.append(time.perf_counter() - t0)
            one = float(np.median(t_one))
            group = float(np.median(t_group))
        finally:
            self.delete_pages(names)
        bw = (pages - 1) * nbytes / max(group - one, 1e-9)
        bw = float(min(max(bw, 1e6), 1e12))       # clamp to sane hardware
        seek = float(max(one - nbytes / bw, 1e-7))
        return StorageProfile(self.scheme, bw, seek, nbytes)


class MemoryBackend(PageBackend):
    """In-process dict backend: tests, and the object-store sim's default
    inner store.  The manifest commit is trivially atomic (one rebind)."""

    scheme = "memory"

    def __init__(self):
        self._pages: Dict[str, np.ndarray] = {}
        self._manifest: Optional[Dict] = None

    def put_pages(self, pages: Mapping[str, np.ndarray]) -> int:
        new = 0
        for h, arr in pages.items():
            if h not in self._pages:
                self._pages[h] = np.array(arr, copy=True)
                new += 1
        return new

    def get_pages(self, hashes: Sequence[str]) -> Dict[str, np.ndarray]:
        return {h: self._pages[h].copy() for h in hashes}

    def list_pages(self) -> List[str]:
        return sorted(self._pages)

    def delete_pages(self, hashes: Sequence[str]) -> int:
        n = 0
        for h in hashes:
            if self._pages.pop(h, None) is not None:
                n += 1
        return n

    def commit_manifest(self, manifest: Dict) -> None:
        self._manifest = dict(manifest)

    def load_manifest(self) -> Dict:
        if self._manifest is None:
            raise FileNotFoundError("memory backend has no manifest")
        return dict(self._manifest)
