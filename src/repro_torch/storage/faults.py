"""Seeded fault injection + the typed recovery contract (DESIGN.md §8).

The paper's serving tier inherits the database's durability story; ours
assumed every ``get_pages`` and commit was perfect.  This module supplies
both halves of the missing fault model:

  * :class:`FaultInjectingBackend` — a composable wrapper (URL spelling
    ``fault+<inner-url>#<spec>``, resolved by ``open_backend``) that
    injects faults from a *seeded* schedule so chaos runs are exactly
    reproducible: transient read/write errors, bit-flip page corruption,
    latency spikes, ``database is locked`` contention, and torn commits
    (the write lands, the ack is lost).
  * The error taxonomy the recovery layer is typed against:
    :class:`TransientStorageError` (retry), :class:`CorruptPageError`
    (quarantine + refetch), :class:`FatalStorageError` (give up).
  * :class:`RetryPolicy` — bounded retries with exponential backoff and
    seeded jitter.  Backoff is *virtual*: no real sleeps — the seconds
    are returned to the caller and charged on the serving virtual clock
    as a named channel, so BENCH numbers stay honest under chaos.

``spec.max_consecutive`` caps the number of consecutive injections per
fault kind; after the cap the next operation is forced to succeed.  This
makes every bounded-retry loop convergent by construction, which is what
lets the chaos tests demand *bit-exact* logits at 10% injection rates.
"""
from __future__ import annotations

import dataclasses
import os
import sqlite3
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from .backend import _BENCH_PREFIX, ManifestConflictError, PageBackend

__all__ = [
    "StorageFaultError", "TransientStorageError", "CorruptPageError",
    "FatalStorageError", "is_transient", "FaultSpec",
    "FaultInjectingBackend", "RetryPolicy", "RetryOutcome",
    "RecoveryStats", "global_fault_spec", "set_global_fault_spec",
    "maybe_wrap", "fault_layer",
]


# ------------------------------------------------------------- taxonomy --
class StorageFaultError(RuntimeError):
    """Base of the storage fault taxonomy.  Subclasses tell the recovery
    layer what to do; anything else escaping a backend is a bug."""


class TransientStorageError(StorageFaultError):
    """The operation may succeed if simply retried (dropped connection,
    lost ack, scheduler hiccup).  :class:`RetryPolicy` retries these."""


class CorruptPageError(StorageFaultError):
    """A fetched page's bytes do not hash to its content address.  The
    page is quarantined and re-fetched as its own grouped call; this
    error surfaces only when refetching cannot produce clean bytes."""


class FatalStorageError(StorageFaultError):
    """Retries/backoff budget exhausted, or a non-recoverable backend
    condition.  Callers should degrade (host fallback) or abort."""


def is_transient(exc: BaseException) -> bool:
    """Classify an exception as retry-worthy.  ``database is locked`` is
    the canonical transient SQLite condition (another writer holds the
    reservation); :class:`ManifestConflictError` is *never* transient —
    it means the manifest moved and the caller must re-read and re-apply,
    not blindly re-commit."""
    if isinstance(exc, ManifestConflictError):
        return False
    if isinstance(exc, TransientStorageError):
        return True
    return (isinstance(exc, sqlite3.OperationalError)
            and "locked" in str(exc).lower())


# ------------------------------------------------------------ fault spec --
_FLOAT_FIELDS = ("transient", "corrupt", "lock", "torn", "latency",
                 "latency_ms")
_INT_FIELDS = ("seed", "max_consecutive")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Seeded fault schedule.  Rates are per-opportunity probabilities
    drawn from one ``default_rng(seed)`` stream, so for a fixed call
    sequence the schedule is exactly reproducible."""
    transient: float = 0.0       # P(transient error) per read/write op
    corrupt: float = 0.0         # P(bit flip) per fetched page
    lock: float = 0.0            # P("database is locked") per commit
    torn: float = 0.0            # P(commit lands but ack lost)
    latency: float = 0.0         # P(latency spike) per read/write op
    latency_ms: float = 5.0      # spike magnitude (virtual milliseconds)
    seed: int = 0
    max_consecutive: int = 2     # forced success after this many in a row

    @classmethod
    def parse(cls, text: "str | FaultSpec | None") -> "FaultSpec":
        """``"transient=0.1,corrupt=0.05,seed=7"`` -> FaultSpec.  The
        empty string parses to the all-zero (no-fault) spec."""
        if isinstance(text, FaultSpec):
            return text
        kw = {}
        for part in (text or "").split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"bad fault spec item {part!r} "
                                 "(expected key=value)")
            k, v = part.split("=", 1)
            k = k.strip()
            if k in _FLOAT_FIELDS:
                kw[k] = float(v)
            elif k in _INT_FIELDS:
                kw[k] = int(v)
            else:
                raise ValueError(
                    f"unknown fault spec key {k!r} (expected one of "
                    f"{_FLOAT_FIELDS + _INT_FIELDS})")
        return cls(**kw)

    def __str__(self) -> str:
        default = FaultSpec()
        items = [f"{f.name}={getattr(self, f.name)}"
                 for f in dataclasses.fields(self)
                 if getattr(self, f.name) != getattr(default, f.name)]
        return ",".join(items)

    def any_faults(self) -> bool:
        return any(getattr(self, f) > 0 for f in
                   ("transient", "corrupt", "lock", "torn", "latency"))


# ------------------------------------------------------- global chaos hook --
_GLOBAL_SPEC: Optional[FaultSpec] = None


def set_global_fault_spec(spec: "str | FaultSpec | None") -> None:
    """Programmatic override of the ``REPRO_FAULTS`` env spec (tests)."""
    global _GLOBAL_SPEC
    _GLOBAL_SPEC = None if spec is None else FaultSpec.parse(spec)


def global_fault_spec() -> Optional[FaultSpec]:
    """The chaos-mode spec: a programmatic override if set, else the
    ``REPRO_FAULTS`` environment variable, else None."""
    if _GLOBAL_SPEC is not None:
        return _GLOBAL_SPEC
    env = os.environ.get("REPRO_FAULTS", "")
    return FaultSpec.parse(env) if env else None


def maybe_wrap(backend: PageBackend) -> PageBackend:
    """Wrap ``backend`` in a :class:`FaultInjectingBackend` when chaos
    mode is on (and it is not already wrapped).  Applied by ModelStore /
    DedupDB at their *URL-resolution* attach points only, so tests that
    construct a backend instance directly keep their exact call-count
    assertions."""
    spec = global_fault_spec()
    if spec is None or not spec.any_faults() \
            or isinstance(backend, FaultInjectingBackend):
        return backend
    return FaultInjectingBackend(backend, spec)


def fault_layer(backend) -> Optional["FaultInjectingBackend"]:
    """The FaultInjectingBackend in a wrapper chain, if any (walks
    ``.inner`` links so ``fault+objsim://`` compositions resolve too)."""
    seen = 0
    while backend is not None and seen < 8:
        if isinstance(backend, FaultInjectingBackend):
            return backend
        backend = getattr(backend, "inner", None)
        seen += 1
    return None


# --------------------------------------------------------------- injector --
def _flip_bit(arr: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """One random bit flip on a *copy* — the inner store stays clean, so
    a quarantine refetch observes the true bytes."""
    out = np.array(arr, copy=True)
    buf = out.view(np.uint8).reshape(-1)
    i = int(rng.integers(buf.size))
    buf[i] ^= np.uint8(1 << int(rng.integers(8)))
    return out


class FaultInjectingBackend(PageBackend):
    """Composable fault-injecting wrapper around any :class:`PageBackend`.

    Injection draws come from one seeded stream in call order, so a run
    with the same traffic sees the same schedule.  Microbench scratch
    pages (``zbench-`` prefix) are exempt: calibration is not traffic.
    Latency spikes never sleep — they accumulate in a drainable counter
    that the recovery layer charges to the serving virtual clock.
    """

    scheme = "fault"

    def __init__(self, inner: PageBackend,
                 spec: "str | FaultSpec | None" = None):
        self.inner = inner
        self.spec = FaultSpec.parse(spec)
        self._rng = np.random.default_rng(self.spec.seed)
        self._consecutive: Dict[str, int] = {}
        #: injected-fault counts by kind (observability + test assertions)
        self.injected: Dict[str, int] = {}
        self._injected_latency_s = 0.0

    # ------------------------------------------------------------ schedule --
    def _draw(self, rate: float) -> bool:
        """One seeded schedule draw."""
        return rate > 0 and float(self._rng.random()) < rate

    def _forced_ok(self, op: str) -> bool:
        """True when ``op`` has failed ``max_consecutive`` times in a
        row: this call is forced to succeed cleanly, ending the run.
        The guard is per *operation* (a commit that alternates lock /
        transient / torn failures still converges), which is what makes
        every bounded-retry loop convergent by construction."""
        run = self._consecutive.get(op, 0)
        if self.spec.max_consecutive > 0 \
                and run >= self.spec.max_consecutive:
            self._consecutive[op] = 0
            return True
        return False

    def _fail(self, op: str, kind: str, exc: Exception):
        self._consecutive[op] = self._consecutive.get(op, 0) + 1
        self.injected[kind] = self.injected.get(kind, 0) + 1
        raise exc

    def _ok(self, op: str) -> None:
        self._consecutive[op] = 0

    def _maybe_latency(self) -> None:
        if self._draw(self.spec.latency):
            self.injected["latency"] = self.injected.get("latency", 0) + 1
            self._injected_latency_s += self.spec.latency_ms * 1e-3

    def drain_injected_latency(self) -> float:
        """Seconds of injected latency since the last drain (charged by
        the recovery layer on the virtual clock, never slept)."""
        s, self._injected_latency_s = self._injected_latency_s, 0.0
        return s

    # --------------------------------------------------------------- pages --
    def put_pages(self, pages: Mapping[str, np.ndarray]) -> int:
        real = any(not h.startswith(_BENCH_PREFIX) for h in pages)
        if real and not self._forced_ok("put"):
            self._maybe_latency()
            if self._draw(self.spec.transient):
                self._fail("put", "transient", TransientStorageError(
                    f"injected transient write error ({len(pages)} pages)"))
        n = self.inner.put_pages(pages)
        if real:
            self._ok("put")
        return n

    def get_pages(self, hashes: Sequence[str]) -> Dict[str, np.ndarray]:
        real = [h for h in hashes if not h.startswith(_BENCH_PREFIX)]
        inject = bool(real) and not self._forced_ok("get")
        if inject:
            self._maybe_latency()
            if self._draw(self.spec.transient):
                self._fail("get", "transient", TransientStorageError(
                    f"injected transient read error ({len(real)} pages)"))
        got = self.inner.get_pages(hashes)
        flipped = 0
        if inject and self.spec.corrupt > 0:
            for h in real:
                if self._draw(self.spec.corrupt):
                    got[h] = _flip_bit(np.asarray(got[h]), self._rng)
                    flipped += 1
        if flipped:
            # a corrupted batch counts as a failed get: the quarantine
            # refetch that follows is then guaranteed a clean batch
            # within max_consecutive rounds
            self.injected["corrupt"] = \
                self.injected.get("corrupt", 0) + flipped
            self._consecutive["get"] = self._consecutive.get("get", 0) + 1
        elif real:
            self._ok("get")
        return got

    def list_pages(self):
        return self.inner.list_pages()

    def delete_pages(self, hashes: Sequence[str]) -> int:
        return self.inner.delete_pages(hashes)

    # ------------------------------------------------------------- journal --
    # The intent journal is the recovery layer's own bookkeeping: faults
    # are never injected into it (a durability layer that corrupts its
    # undo log proves nothing), so all primitives delegate verbatim.
    def journal_append(self, record: Dict) -> int:
        return self.inner.journal_append(record)

    def journal_records(self) -> List[Dict]:
        return self.inner.journal_records()

    def journal_rewrite(self, records: Sequence[Dict]) -> None:
        self.inner.journal_rewrite(records)

    def sweep_temp(self) -> int:
        return self.inner.sweep_temp()

    # ------------------------------------------------------------ manifest --
    def commit_manifest(self, manifest: Dict) -> None:
        if self._forced_ok("commit"):
            return self.inner.commit_manifest(manifest)
        if self._draw(self.spec.lock):
            # raw, exactly as sqlite3 surfaces it, so the classifier in
            # the retry layer (not this wrapper) does the typing
            self._fail("commit", "lock",
                       sqlite3.OperationalError("database is locked"))
        if self._draw(self.spec.transient):
            self._fail("commit", "transient",
                       TransientStorageError("injected transient commit"))
        self.inner.commit_manifest(manifest)
        if self._draw(self.spec.torn):
            # torn commit: the write landed but the ack was lost.  The
            # retry that follows must be idempotent (all backends are:
            # content-addressed puts + versioned manifest replace).
            self._fail("commit", "torn",
                       TransientStorageError("injected torn commit "
                                             "(ack lost)"))
        self._ok("commit")

    def load_manifest(self) -> Dict:
        if not self._forced_ok("load"):
            self._maybe_latency()
            if self._draw(self.spec.transient):
                self._fail("load", "transient", TransientStorageError(
                    "injected transient manifest read"))
        out = self.inner.load_manifest()
        self._ok("load")
        return out

    def has_manifest(self) -> bool:
        return self.inner.has_manifest()

    # --------------------------------------------------------------- admin --
    def url(self) -> str:
        return f"fault+{self.inner.url()}#{self.spec}"

    def close(self) -> None:
        self.inner.close()

    def microbench(self, *a, **kw):
        # calibration reads the *inner* tier's characteristics; fault
        # overhead is charged separately (backoff/latency channels)
        return self.inner.microbench(*a, **kw)


# ------------------------------------------------------------ retry policy --
@dataclasses.dataclass
class RetryOutcome:
    """What one recovered call cost: retry count + virtual backoff."""
    retries: int = 0
    backoff_seconds: float = 0.0


@dataclasses.dataclass
class RecoveryStats:
    """Accumulator the store-level recovery layer maintains; serving
    tiers snapshot-diff it per batch into their ServeStats."""
    retries: int = 0
    corrupt_detected: int = 0
    refetch_pages: int = 0
    backoff_seconds: float = 0.0
    latency_seconds: float = 0.0

    def snapshot(self) -> "RecoveryStats":
        return dataclasses.replace(self)

    def since(self, prev: "RecoveryStats") -> "RecoveryStats":
        return RecoveryStats(
            retries=self.retries - prev.retries,
            corrupt_detected=self.corrupt_detected - prev.corrupt_detected,
            refetch_pages=self.refetch_pages - prev.refetch_pages,
            backoff_seconds=self.backoff_seconds - prev.backoff_seconds,
            latency_seconds=self.latency_seconds - prev.latency_seconds)

    def register_into(self, registry, namespace: str = "recovery") -> None:
        """Expose every field as a live metric view in a
        :class:`~repro.obs.metrics.MetricsRegistry` (duck-typed so this
        numpy-only layer never imports the obs package)."""
        registry.register_object(
            namespace, self, [f.name for f in dataclasses.fields(self)])


@dataclasses.dataclass
class RetryPolicy:
    """Bounded retries with exponential backoff + seeded jitter.

    Backoff never sleeps: accumulated seconds come back in the
    :class:`RetryOutcome` and are charged on the serving virtual clock
    as a named channel.  ``call_timeout`` caps the *virtual* backoff
    budget of one logical call — past it the call is fatal even if
    retries remain, mirroring a real per-request deadline.
    """
    max_retries: int = 4
    backoff_base: float = 0.002       # seconds (virtual)
    backoff_multiplier: float = 2.0
    jitter: float = 0.25              # +[0, jitter) fraction per step
    call_timeout: float = 1.0         # virtual-seconds budget per call
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def run(self, fn, describe: str = "storage call"):
        """``fn()`` with bounded retries on transient errors.  Returns
        ``(result, RetryOutcome)``.  Non-transient errors (including
        ManifestConflictError) propagate untouched; exhausting the retry
        or backoff budget raises :class:`FatalStorageError` chained to
        the last transient cause."""
        backoff = 0.0
        attempt = 0
        while True:
            try:
                return fn(), RetryOutcome(attempt, backoff)
            except Exception as exc:
                if not is_transient(exc):
                    raise
                attempt += 1
                if attempt > self.max_retries:
                    fatal = FatalStorageError(
                        f"{describe}: {self.max_retries} retries exhausted")
                    # the spent budget rides on the error so callers can
                    # still charge it to their RecoveryStats
                    fatal.outcome = RetryOutcome(attempt - 1, backoff)
                    raise fatal from exc
                step = self.backoff_base * \
                    self.backoff_multiplier ** (attempt - 1)
                step *= 1.0 + self.jitter * float(self._rng.random())
                backoff += step
                if backoff > self.call_timeout:
                    fatal = FatalStorageError(
                        f"{describe}: virtual backoff budget "
                        f"({self.call_timeout}s) exceeded")
                    fatal.outcome = RetryOutcome(attempt - 1, backoff)
                    raise fatal from exc
