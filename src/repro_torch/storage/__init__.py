"""Pluggable page-storage backends for the deduplicated model store.

``open_backend(url)`` resolves a storage URL to a :class:`PageBackend`:

===========  =========================================================
URL                                        backend
===========  =========================================================
``file:///abs/dir`` or bare path           :class:`LocalDirBackend`
``sqlite:///rel.db``, ``sqlite:////abs.db``  :class:`SQLiteBackend`
``objsim://[dir][?seek_ms=&bandwidth_mbps=]``  :class:`ObjectStoreSimBackend`
``memory://``                              :class:`MemoryBackend`
``fault+<inner-url>#<spec>``               :class:`FaultInjectingBackend`
===========  =========================================================

SQLite paths follow the SQLAlchemy convention: three slashes for a
relative path, four for an absolute one.  ``objsim://`` with a path
wraps a local directory backend; without one it wraps an in-memory
store (tests / benchmarks).  Bare strings with no scheme are treated as
local directories — the back-compat shim for the historical
``ModelStore.save(path)`` call sites.
"""
from __future__ import annotations

from urllib.parse import parse_qs, urlparse

from .backend import (MANIFEST_VERSION, ManifestConflictError,
                      MemoryBackend, PageBackend, StorageProfile,
                      resolve_dtype)
from .crashpoints import CrashPointReached, crash_point
from .faults import (CorruptPageError, FatalStorageError,
                     FaultInjectingBackend, FaultSpec, RetryPolicy,
                     StorageFaultError, TransientStorageError)
from .journal import Journal, RecoveryReport, recover_backend
from .localdir import LocalDirBackend
from .objsim import ObjectStoreSimBackend
from .sqlite import SQLiteBackend

__all__ = [
    "MANIFEST_VERSION", "ManifestConflictError", "MemoryBackend",
    "PageBackend", "StorageProfile", "resolve_dtype",
    "LocalDirBackend", "SQLiteBackend", "ObjectStoreSimBackend",
    "FaultInjectingBackend", "FaultSpec", "RetryPolicy",
    "StorageFaultError", "TransientStorageError", "CorruptPageError",
    "FatalStorageError", "CrashPointReached", "crash_point",
    "Journal", "RecoveryReport", "recover_backend",
    "open_backend",
]


def _sqlalchemy_path(rest: str) -> str:
    """``sqlite:///foo.db`` -> ``foo.db``; ``sqlite:////abs/foo.db`` ->
    ``/abs/foo.db`` (strip exactly one leading slash)."""
    return rest[1:] if rest.startswith("/") else rest


def _recovered(backend: PageBackend) -> PageBackend:
    """Journal replay at the URL attach point (DESIGN.md §11): a store a
    crashed writer left dirty is GC'd before anything reads it.  Clean
    journals make this a single cheap read."""
    recover_backend(backend)
    return backend


def open_backend(url) -> PageBackend:
    """Resolve a storage URL (or bare directory path, or an already-open
    backend) to a :class:`PageBackend`, replaying any crash-recovery
    journal the previous writer left behind."""
    if isinstance(url, PageBackend):
        return url
    url = str(url)
    if url.startswith("fault+"):
        # fault-injection composition: fault+<inner-url>#<spec>, e.g.
        # fault+sqlite:///m.db#transient=0.1,corrupt=0.05,seed=7 — the
        # spec rides in the fragment so inner query strings stay intact
        # (the inner open_backend already ran recovery on the real store)
        inner_url, _, spec = url[len("fault+"):].partition("#")
        return FaultInjectingBackend(open_backend(inner_url),
                                     FaultSpec.parse(spec))
    if "://" not in url:                       # bare path: legacy call sites
        return _recovered(LocalDirBackend(url))
    scheme, rest = url.split("://", 1)
    scheme = scheme.lower()
    if scheme == "file":
        # standard file URL: the path component is absolute
        parsed = urlparse(url)
        return _recovered(LocalDirBackend((parsed.netloc or "") + parsed.path))
    if scheme == "sqlite":
        return _recovered(
            SQLiteBackend(_sqlalchemy_path(rest.split("?", 1)[0])))
    if scheme == "memory":
        return MemoryBackend()
    if scheme == "objsim":
        path, _, query = rest.partition("?")
        params = parse_qs(query)
        kw = {}
        if "seek_ms" in params:
            kw["seek"] = float(params["seek_ms"][0]) * 1e-3
        if "bandwidth_mbps" in params:
            kw["bandwidth"] = float(params["bandwidth_mbps"][0]) * 1e6
        if not path:
            inner = None                       # in-memory inner store
        elif path.endswith((".db", ".sqlite")):
            inner = _recovered(SQLiteBackend(path))
        else:
            inner = _recovered(LocalDirBackend(path))
        return ObjectStoreSimBackend(inner, **kw)
    raise ValueError(f"unknown storage URL scheme {scheme!r} in {url!r} "
                     "(expected file | sqlite | objsim | memory)")
