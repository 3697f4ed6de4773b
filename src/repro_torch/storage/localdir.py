"""Local-directory page backend: the historical ModelStore on-disk format.

Content-addressed ``page-<hash>.npy`` files plus a ``manifest.json``
committed by atomic rename — byte-compatible with stores written by the
old ``ModelStore.save(path)``, so existing checkpoints keep loading.

Durability additions (DESIGN.md §11): a line-oriented intent journal
(``journal.jsonl``, fsync'd appends, atomic-rename compaction) and a
``sweep_temp`` pass collecting the ``*.tmp`` staging files a crash
between ``mkstemp`` and ``os.replace`` strands.  Every rename seam is a
registered crash point so the kill-at-every-seam sweep can prove the
recovery story rather than assume it.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Mapping, Sequence

import numpy as np

from .backend import PageBackend
from .crashpoints import crash_point, register_crash_points

MANIFEST_NAME = "manifest.json"
JOURNAL_NAME = "journal.jsonl"

register_crash_points({
    "localdir.put_pages.tmp_written":
        "page bytes staged in a mkstemp file, rename not yet issued",
    "localdir.put_pages.page_committed":
        "after one page's atomic rename, before the next page",
    "localdir.commit_manifest.tmp_written":
        "manifest JSON staged, atomic rename not yet issued",
    "localdir.commit_manifest.committed":
        "immediately after the manifest atomic rename",
    "localdir.delete_pages.mid":
        "mid-prune: some orphan pages unlinked, the rest still present",
    "localdir.journal.appended":
        "after an fsync'd journal append (intent or done marker)",
    "localdir.journal.rewrite_staged":
        "compacted journal staged in a tmp file, rename not yet issued",
    "localdir.journal.rewritten":
        "immediately after the journal compaction rename",
})


class LocalDirBackend(PageBackend):
    """Pages as one .npy file each under a local directory."""
    scheme = "file"

    def __init__(self, path: str):
        self.path = str(path)
        os.makedirs(self.path, exist_ok=True)

    def url(self) -> str:
        return f"file://{os.path.abspath(self.path)}"

    def _page_path(self, h: str) -> str:
        return os.path.join(self.path, f"page-{h}.npy")

    # ------------------------------------------------------------- pages --
    def put_pages(self, pages: Mapping[str, np.ndarray]) -> int:
        new = 0
        for h, arr in pages.items():
            fp = self._page_path(h)
            if os.path.exists(fp):               # content addressing
                continue
            fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".npy.tmp")
            with os.fdopen(fd, "wb") as f:
                np.save(f, np.ascontiguousarray(arr))
            crash_point("localdir.put_pages.tmp_written")
            os.replace(tmp, fp)                  # no torn page files
            crash_point("localdir.put_pages.page_committed")
            new += 1
        return new

    def get_pages(self, hashes: Sequence[str]) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        for h in hashes:
            fp = self._page_path(h)
            if not os.path.exists(fp):
                raise KeyError(f"page {h!r} not in {self.path}")
            out[h] = np.load(fp)
        return out

    def list_pages(self) -> List[str]:
        out = []
        for name in os.listdir(self.path):
            # staging debris (*.tmp) is never a page, even if a crashed
            # rename left it with a page-like prefix
            if (name.startswith("page-") and name.endswith(".npy")
                    and not name.endswith(".tmp")):
                out.append(name[len("page-"):-len(".npy")])
        return sorted(out)

    def delete_pages(self, hashes: Sequence[str]) -> int:
        n = 0
        for h in hashes:
            try:
                os.remove(self._page_path(h))
                n += 1
            except FileNotFoundError:
                pass
            crash_point("localdir.delete_pages.mid")
        return n

    # ---------------------------------------------------------- manifest --
    def commit_manifest(self, manifest: Dict) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(manifest, f)
        crash_point("localdir.commit_manifest.tmp_written")
        # The atomic commit point: a crash before this line leaves the
        # previous manifest untouched (crash-safety test).
        os.replace(tmp, os.path.join(self.path, MANIFEST_NAME))
        crash_point("localdir.commit_manifest.committed")

    def load_manifest(self) -> Dict:
        with open(os.path.join(self.path, MANIFEST_NAME)) as f:
            return json.load(f)

    # ------------------------------------------------------------ journal --
    def _journal_path(self) -> str:
        return os.path.join(self.path, JOURNAL_NAME)

    def journal_records(self) -> List[Dict]:
        try:
            with open(self._journal_path()) as f:
                text = f.read()
        except FileNotFoundError:
            return []
        out: List[Dict] = []
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                # torn tail from a crash mid-append: the record never
                # became durable, so it never happened
                continue
        return out

    def journal_append(self, record: Dict) -> int:
        if "seq" not in record:
            seqs = [r.get("seq", 0) for r in self.journal_records()]
            record = {**record, "seq": max(seqs, default=0) + 1}
        with open(self._journal_path(), "a") as f:
            f.write(json.dumps(record) + "\n")
            f.flush()
            os.fsync(f.fileno())
        crash_point("localdir.journal.appended")
        return int(record["seq"])

    def journal_rewrite(self, records: Sequence[Dict]) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
            f.flush()
            os.fsync(f.fileno())
        crash_point("localdir.journal.rewrite_staged")
        os.replace(tmp, self._journal_path())
        crash_point("localdir.journal.rewritten")

    def sweep_temp(self) -> int:
        n = 0
        for name in os.listdir(self.path):
            if name.endswith(".tmp"):            # mkstemp staging debris
                os.remove(os.path.join(self.path, name))
                n += 1
        return n
