"""Write-ahead intent journal + startup recovery (DESIGN.md §11).

A ModelStore save is a multi-step mutation — put pages, commit the
manifest, prune orphans — and only the manifest commit is atomic on its
own.  A crash anywhere else strands state: fresh pages with no
referencing manifest (undo work), or a committed manifest whose prune
never ran (redo work), plus ``*.tmp`` staging debris.  The journal makes
the whole sequence atomic-on-recovery:

  1. ``Journal.begin(op, keep=[...])`` durably appends an **intent**
     record *before* the first page is touched and returns its ``seq``.
  2. The operation runs, crossing its registered crash points.
  3. ``Journal.commit(seq)`` appends a **done** marker and compacts the
     journal (resolved intent/done pairs drop out; other writers'
     pending intents survive).

Record format (one JSON object per record)::

    {"v": 1, "phase": "intent", "op": "save"|"gc", "seq": N,
     "keep": [page hashes the op's manifest will reference]}
    {"v": 1, "phase": "done", "seq": N}

Recovery (:func:`recover_backend`, called by ``open_backend`` /
``ModelStore.open``) is intentionally dumb: *any* journal record —
pending intent or a resolved pair stranded by a crash mid-compaction —
marks the store dirty.  The committed manifest is the sole source of
truth for which pages deserve to live; everything recovery does reduces
to one idempotent, itself-journaled GC:

  * delete every stored page the committed manifest does not reference
    (undoes a crashed save's fresh pages; finishes a crashed save's
    prune — which of the two happened is recorded in the report by
    comparing each pending intent's keep-set against the manifest);
  * sweep temp staging files;
  * clear the journal (the GC's own commit).

A crash *during* recovery re-runs the same GC on the next open — the
proof obligation is idempotence, not ordering, and the crash-point
sweep (``storage/crashpoints.py``) kills recovery at its own seams to
hold it to that.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from .crashpoints import crash_point, register_crash_points

RECORD_VERSION = 1

register_crash_points({
    "recover.gc_journaled":
        "recovery's own gc intent journaled, nothing deleted yet",
    "recover.gc_done":
        "orphans deleted and temps swept, journal not yet cleared",
})


class Journal:
    """Intent journal over one backend's durable journal primitives."""

    def __init__(self, backend):
        self.backend = backend

    def begin(self, op: str, **payload) -> int:
        """Durably record the intent BEFORE the first mutation; returns
        the intent's seq for :meth:`commit`."""
        return self.backend.journal_append(
            {"v": RECORD_VERSION, "phase": "intent", "op": op, **payload})

    def commit(self, seq: int) -> None:
        """Mark intent ``seq`` done, then compact the journal."""
        self.backend.journal_append(
            {"v": RECORD_VERSION, "phase": "done", "seq": int(seq)})
        self.compact()

    def records(self) -> List[Dict]:
        return self.backend.journal_records()

    def pending(self) -> List[Dict]:
        """Intents with no matching done marker — the crash windows."""
        recs = self.records()
        done = {int(r["seq"]) for r in recs if r.get("phase") == "done"}
        return [r for r in recs
                if r.get("phase") == "intent" and int(r["seq"]) not in done]

    def compact(self) -> None:
        """Atomically drop resolved intent/done pairs; pending intents
        (e.g. a concurrent writer mid-save) survive verbatim."""
        self.backend.journal_rewrite(self.pending())

    def clear(self) -> None:
        self.backend.journal_rewrite([])


@dataclasses.dataclass
class RecoveryReport:
    """What one :func:`recover_backend` pass found and fixed."""
    recovered: bool = False           # False: journal was clean, no-op
    pending_intents: int = 0          # intents with no done marker
    redo: int = 0                     # intents whose commit had landed
    undo: int = 0                     # intents rolled back by the GC
    orphan_pages_deleted: int = 0
    temp_files_swept: int = 0

    def summary(self) -> str:
        if not self.recovered:
            return "clean (journal empty)"
        return (f"{self.pending_intents} pending intent(s) "
                f"({self.redo} redo / {self.undo} undo), "
                f"{self.orphan_pages_deleted} orphan page(s) deleted, "
                f"{self.temp_files_swept} temp file(s) swept")


def needs_recovery(backend) -> bool:
    """True iff the journal holds ANY record — pending intents, or a
    resolved pair stranded by a crash mid-compaction."""
    return bool(backend.journal_records())


def recover_backend(backend) -> RecoveryReport:
    """Replay the journal on a just-opened backend (idempotent).

    No-op when the journal is empty — a clean open costs exactly one
    journal read, never a page listing.  Otherwise runs the journaled
    GC described in the module docstring and returns the report.
    """
    jr = Journal(backend)
    recs = jr.records()
    if not recs:
        return RecoveryReport()
    report = RecoveryReport(recovered=True)
    try:
        manifest = backend.load_manifest()
        keep = {p["hash"] for p in manifest["pages"]}
    except FileNotFoundError:
        keep = set()                  # nothing ever committed: all garbage
    pend = jr.pending()
    report.pending_intents = len(pend)
    for r in pend:
        intent_keep = set(r.get("keep", []))
        # the intent's manifest landed iff the committed refs are exactly
        # what it promised to keep: finish its cleanup (redo); otherwise
        # the commit never happened and its fresh pages roll back (undo)
        if intent_keep and intent_keep == keep:
            report.redo += 1
        else:
            report.undo += 1
    if pend:
        jr.begin("gc", keep=sorted(keep))
        crash_point("recover.gc_journaled")
        stray = [h for h in backend.list_pages() if h not in keep]
        if stray:
            report.orphan_pages_deleted = int(backend.delete_pages(stray))
        report.temp_files_swept = int(backend.sweep_temp())
        crash_point("recover.gc_done")
    else:
        # resolved pairs stranded by a crash mid-compaction: no intent is
        # open, so pages are consistent — only staging debris can remain
        report.temp_files_swept = int(backend.sweep_temp())
    jr.clear()
    return report
