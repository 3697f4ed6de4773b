"""Relational (SQLite) page backend — the paper's native habitat.

Pages are BLOB rows keyed by content hash; the manifest is *relational*:
``models`` / ``tensors`` / ``manifest_pages`` / ``tensor_pages`` tables
rewritten in ONE transaction per commit, so a crash mid-commit rolls
back to the previous manifest (the database's atomicity doing the job
``os.replace`` does for the directory backend).  Stdlib-only.

Concurrent writers: commits are optimistically locked on a
``commit_version`` counter in ``meta``.  Each handle remembers the
version it last observed (at open / ``load_manifest`` / its own
commit); ``commit_manifest`` takes the write lock (``BEGIN IMMEDIATE``,
so version check and rewrite are one critical section), compares the
stored counter against the observed one, and raises
:class:`~repro.storage.backend.ManifestConflictError` on mismatch — the
stale writer rolls back, reloads, and retries on top of the winner's
manifest instead of silently clobbering it.

Schema (DESIGN.md "Storage backends")::

    pages(hash TEXT PK, dtype TEXT, shape TEXT, data BLOB)
    meta(key TEXT PK, json TEXT)              -- store config + version
    models(model TEXT PK)
    tensors(model, tensor, shape TEXT, dtype TEXT, block_map BLOB,
            PK(model, tensor))                -- block_map: int64 LE bytes
    manifest_pages(page_idx INTEGER PK, hash TEXT, blocks TEXT)
    tensor_pages(model, tensor, seq INTEGER, page_idx INTEGER,
                 PK(model, tensor, seq))      -- exact per-tensor cover

``load_manifest`` reconstructs the ModelStore manifest dict from these
tables (they are load-bearing, not a cache of a JSON blob).
"""
from __future__ import annotations

import json
import os
import sqlite3
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np

from .backend import ManifestConflictError, PageBackend, resolve_dtype
from .crashpoints import crash_point, register_crash_points
from .faults import TransientStorageError, is_transient

register_crash_points({
    "sqlite.put_pages.staged":
        "page rows inserted in the open transaction, COMMIT not issued",
    "sqlite.commit_manifest.staged":
        "manifest rows rewritten inside BEGIN IMMEDIATE, COMMIT not issued",
    "sqlite.commit_manifest.committed":
        "immediately after the manifest transaction COMMIT",
    "sqlite.delete_pages.staged":
        "orphan rows deleted in the open transaction, COMMIT not issued",
    "sqlite.journal.appended":
        "after the journal-intent transaction COMMIT",
    "sqlite.journal.rewrite_staged":
        "journal compacted inside BEGIN IMMEDIATE, COMMIT not issued",
})

_SCHEMA = """
CREATE TABLE IF NOT EXISTS pages(
    hash  TEXT PRIMARY KEY,
    dtype TEXT NOT NULL,
    shape TEXT NOT NULL,
    data  BLOB NOT NULL);
CREATE TABLE IF NOT EXISTS meta(
    key  TEXT PRIMARY KEY,
    json TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS models(
    model TEXT PRIMARY KEY);
CREATE TABLE IF NOT EXISTS tensors(
    model     TEXT NOT NULL,
    tensor    TEXT NOT NULL,
    shape     TEXT NOT NULL,
    dtype     TEXT NOT NULL,
    block_map BLOB NOT NULL,
    PRIMARY KEY (model, tensor));
CREATE TABLE IF NOT EXISTS manifest_pages(
    page_idx INTEGER PRIMARY KEY,
    hash     TEXT NOT NULL,
    blocks   TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS tensor_pages(
    model    TEXT NOT NULL,
    tensor   TEXT NOT NULL,
    seq      INTEGER NOT NULL,
    page_idx INTEGER NOT NULL,
    PRIMARY KEY (model, tensor, seq));
CREATE TABLE IF NOT EXISTS journal(
    id   INTEGER PRIMARY KEY AUTOINCREMENT,
    seq  INTEGER NOT NULL,
    json TEXT NOT NULL);
"""

#: manifest keys that live in ``meta`` rather than the relational tables
_META_KEYS = ("version", "blocks_per_page", "block_shape", "page_dtype",
              "pack_strategy", "dedup_config")

#: meta key of the optimistic-locking commit counter (never part of the
#: manifest dict itself)
_COMMIT_VERSION = "commit_version"


class SQLiteBackend(PageBackend):
    """Pages as BLOB rows in a single-file SQLite database — the
    paper's models-in-the-RDBMS storage tier."""
    scheme = "sqlite"

    def __init__(self, path: str, timeout: float = 5.0,
                 lock_retries: int = 4, lock_backoff: float = 0.01):
        self.path = str(path)
        # explicit busy timeout: sqlite3's own lock wait, BEFORE the
        # bounded retry loop in commit_manifest gets involved
        self.timeout = float(timeout)
        self.lock_retries = int(lock_retries)
        self.lock_backoff = float(lock_backoff)
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        self._con = sqlite3.connect(self.path, timeout=self.timeout)
        self._con.executescript(_SCHEMA)
        # idempotent DDL bootstrap: CREATE IF NOT EXISTS at any crash
        # instant converges to the same schema on reopen
        self._con.commit()  # repro: allow-unjournaled
        # Test seam: invoked after the manifest rows are written but
        # before COMMIT — raising here simulates a crash mid-commit and
        # must leave the previous manifest readable (transaction rollback).
        self._pre_commit_hook: Optional[Callable[[], None]] = None
        # Optimistic locking: the commit counter this handle last saw
        # (0 = no manifest yet); refreshed by load_manifest and by our
        # own successful commits.
        self._seen_version = self._db_version()

    def url(self) -> str:
        return f"sqlite:///{os.path.abspath(self.path)}"

    def close(self) -> None:
        self._con.close()

    # ------------------------------------------------------------- pages --
    def put_pages(self, pages: Mapping[str, np.ndarray]) -> int:
        cur = self._con.cursor()
        new = 0
        for h, arr in pages.items():
            arr = np.ascontiguousarray(arr)
            cur.execute(
                "INSERT OR IGNORE INTO pages(hash, dtype, shape, data) "
                "VALUES (?, ?, ?, ?)",
                (h, arr.dtype.name, json.dumps(list(arr.shape)),
                 sqlite3.Binary(arr.tobytes())))
            new += cur.rowcount
        crash_point("sqlite.put_pages.staged")
        self._con.commit()
        return new

    def get_pages(self, hashes: Sequence[str]) -> Dict[str, np.ndarray]:
        hashes = list(hashes)
        if not hashes:
            return {}
        # ONE grouped query for the whole miss set — the per-request
        # overhead (parse/plan/seek) is paid once per batch, which is
        # exactly what StorageModel.fetch_group_seconds models.
        uniq = sorted(set(hashes))
        marks = ",".join("?" * len(uniq))
        rows = self._con.execute(
            f"SELECT hash, dtype, shape, data FROM pages "
            f"WHERE hash IN ({marks})", uniq).fetchall()
        got = {h: np.frombuffer(data, dtype=resolve_dtype(dt))
               .reshape(json.loads(shape)).copy()
               for h, dt, shape, data in rows}
        for h in uniq:
            if h not in got:
                raise KeyError(f"page {h!r} not in {self.path}")
        return {h: got[h] for h in hashes}

    def list_pages(self) -> List[str]:
        return [r[0] for r in self._con.execute(
            "SELECT hash FROM pages ORDER BY hash")]

    def delete_pages(self, hashes: Sequence[str]) -> int:
        hashes = list(hashes)
        if not hashes:
            return 0
        marks = ",".join("?" * len(hashes))
        cur = self._con.execute(
            f"DELETE FROM pages WHERE hash IN ({marks})", hashes)
        crash_point("sqlite.delete_pages.staged")
        self._con.commit()
        return cur.rowcount

    # ---------------------------------------------------------- manifest --
    def _db_version(self, cur=None) -> int:
        """Current commit counter in the database (0: never committed)."""
        row = (cur or self._con).execute(
            "SELECT json FROM meta WHERE key = ?",
            (_COMMIT_VERSION,)).fetchone()
        return int(json.loads(row[0])) if row else 0

    def commit_manifest(self, manifest: Dict) -> None:
        """Commit with bounded retry on lock contention.

        A concurrent writer holding the reservation surfaces as
        ``sqlite3.OperationalError: database is locked`` — a *transient*
        condition (the winner commits and releases), classified via
        :func:`~repro.storage.faults.is_transient` and retried with
        bounded exponential backoff on top of the connection's own
        ``timeout``.  :class:`ManifestConflictError` is the opposite — a
        hard optimistic-locking conflict that must NOT be retried
        blindly (the caller reloads and re-applies) — and propagates on
        the first occurrence."""
        attempt = 0
        while True:
            try:
                return self._commit_manifest_once(manifest)
            except ManifestConflictError:
                raise
            except sqlite3.OperationalError as exc:
                if not is_transient(exc):
                    raise
                attempt += 1
                if attempt > self.lock_retries:
                    raise TransientStorageError(
                        f"commit_manifest on {self.path}: lock still "
                        f"contended after {self.lock_retries} retries"
                    ) from exc
                time.sleep(self.lock_backoff * 2 ** (attempt - 1))

    def _commit_manifest_once(self, manifest: Dict) -> None:
        con = self._con
        con.commit()                   # close any implicit transaction
        try:
            cur = con.cursor()
            # BEGIN IMMEDIATE takes the write lock NOW, making the
            # version check + rewrite one critical section: a concurrent
            # writer blocks here until we commit, then sees our counter.
            cur.execute("BEGIN IMMEDIATE")
            current = self._db_version(cur)
            if current != self._seen_version:
                raise ManifestConflictError(
                    f"manifest in {self.path} is at commit version "
                    f"{current}, this handle last observed "
                    f"{self._seen_version}: another writer committed "
                    f"first — load_manifest() and retry on top of it")
            for t in ("models", "tensors", "manifest_pages", "tensor_pages"):
                cur.execute(f"DELETE FROM {t}")
            cur.execute("DELETE FROM meta")
            cur.execute("INSERT INTO meta(key, json) VALUES (?, ?)",
                        (_COMMIT_VERSION, json.dumps(current + 1)))
            for key in _META_KEYS:
                if key in manifest:
                    cur.execute("INSERT INTO meta(key, json) VALUES (?, ?)",
                                (key, json.dumps(manifest[key])))
            for idx, entry in enumerate(manifest["pages"]):
                cur.execute(
                    "INSERT INTO manifest_pages(page_idx, hash, blocks) "
                    "VALUES (?, ?, ?)",
                    (idx, entry["hash"],
                     json.dumps([int(b) for b in entry["blocks"]])))
            for model, tensors in manifest["models"].items():
                cur.execute("INSERT INTO models(model) VALUES (?)", (model,))
                for tensor, spec in tensors.items():
                    bm = np.asarray(spec["block_map"],
                                    dtype="<i8").tobytes()
                    cur.execute(
                        "INSERT INTO tensors(model, tensor, shape, dtype, "
                        "block_map) VALUES (?, ?, ?, ?, ?)",
                        (model, tensor, json.dumps(list(spec["shape"])),
                         spec["dtype"], sqlite3.Binary(bm)))
                    cur.executemany(
                        "INSERT INTO tensor_pages(model, tensor, seq, "
                        "page_idx) VALUES (?, ?, ?, ?)",
                        [(model, tensor, seq, int(pid))
                         for seq, pid in enumerate(spec["pages"])])
            if self._pre_commit_hook is not None:
                self._pre_commit_hook()
            crash_point("sqlite.commit_manifest.staged")
            con.commit()                          # the atomic commit point
            self._seen_version = current + 1
            crash_point("sqlite.commit_manifest.committed")
        except BaseException:
            con.rollback()
            raise

    def load_manifest(self) -> Dict:
        con = self._con
        meta = {k: json.loads(v)
                for k, v in con.execute("SELECT key, json FROM meta")}
        commit_version = int(meta.pop(_COMMIT_VERSION, 0))
        page_rows = con.execute(
            "SELECT page_idx, hash, blocks FROM manifest_pages "
            "ORDER BY page_idx").fetchall()
        if not meta or not page_rows:
            raise FileNotFoundError(f"no manifest committed in {self.path}")
        # reading the manifest adopts its version: a subsequent commit
        # from this handle builds on what it just observed
        self._seen_version = commit_version
        manifest: Dict = dict(meta)
        manifest["pages"] = [{"hash": h, "blocks": json.loads(blocks)}
                             for _, h, blocks in page_rows]
        models: Dict[str, Dict] = {
            m: {} for (m,) in con.execute("SELECT model FROM models")}
        cover: Dict = {}
        for model, tensor, pid in con.execute(
                "SELECT model, tensor, page_idx FROM tensor_pages "
                "ORDER BY model, tensor, seq"):
            cover.setdefault((model, tensor), []).append(int(pid))
        for model, tensor, shape, dtype, bm in con.execute(
                "SELECT model, tensor, shape, dtype, block_map FROM tensors"):
            models[model][tensor] = {
                "shape": json.loads(shape),
                "dtype": dtype,
                "block_map": np.frombuffer(bm, dtype="<i8").tolist(),
                "pages": cover.get((model, tensor), []),
            }
        manifest["models"] = models
        return manifest

    # ------------------------------------------------------------ journal --
    def journal_records(self) -> List[Dict]:
        return [json.loads(j) for (j,) in self._con.execute(
            "SELECT json FROM journal ORDER BY id")]

    def journal_append(self, record: Dict) -> int:
        con = self._con
        con.commit()                   # close any implicit transaction
        try:
            cur = con.cursor()
            # seq assignment and insert are one critical section, so two
            # concurrent writers can never mint the same intent seq
            cur.execute("BEGIN IMMEDIATE")
            if "seq" in record:
                seq = int(record["seq"])
            else:
                seq = int(cur.execute(
                    "SELECT COALESCE(MAX(seq), 0) + 1 FROM journal"
                ).fetchone()[0])
                record = {**record, "seq": seq}
            cur.execute("INSERT INTO journal(seq, json) VALUES (?, ?)",
                        (seq, json.dumps(record)))
            con.commit()
        except BaseException:
            con.rollback()
            raise
        crash_point("sqlite.journal.appended")
        return seq

    def journal_rewrite(self, records: Sequence[Dict]) -> None:
        con = self._con
        con.commit()
        try:
            cur = con.cursor()
            cur.execute("BEGIN IMMEDIATE")
            cur.execute("DELETE FROM journal")
            for r in records:
                cur.execute("INSERT INTO journal(seq, json) VALUES (?, ?)",
                            (int(r["seq"]), json.dumps(r)))
            crash_point("sqlite.journal.rewrite_staged")
            con.commit()
        except BaseException:
            con.rollback()
            raise
