"""Object-store simulator: a latency/bandwidth-injected PageBackend.

Wraps any inner backend (in-memory by default) and *reports* remote-
object-store performance through ``microbench()`` instead of measuring:
the serving engine's :class:`~repro.serving.engine.StorageModel` virtual
clock then charges every pool miss as if pages lived behind an S3-like
tier (tens of ms per request, modest bandwidth) — the fig-8 "working set
exceeds the pool" regime where grouped fetches and prefetching earn
their keep — while the actual page bytes move at memory speed, keeping
benchmarks and tests fast and deterministic.

It also counts calls: ``get_calls`` vs ``pages_fetched`` is how tests
assert the miss path really is *grouped* (one backend request per batch).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from .backend import MemoryBackend, PageBackend, StorageProfile

#: S3-ish single-region defaults: first-byte latency ~20 ms, 200 MB/s
DEFAULT_SEEK = 20e-3
DEFAULT_BANDWIDTH = 200e6


class ObjectStoreSimBackend(PageBackend):
    """Wraps another backend with object-store-like latency accounting
    (per-request seek + bandwidth), for storage-tier experiments."""
    scheme = "objsim"

    def __init__(self, inner: Optional[PageBackend] = None,
                 seek: float = DEFAULT_SEEK,
                 bandwidth: float = DEFAULT_BANDWIDTH):
        self.inner = inner if inner is not None else MemoryBackend()
        self.seek = float(seek)
        self.bandwidth = float(bandwidth)
        self.get_calls = 0
        self.put_calls = 0
        self.pages_fetched = 0

    def url(self) -> str:
        # file and sqlite inners carry their (absolute) path in the URL;
        # open_backend() tells them apart by the .db/.sqlite suffix.  A
        # memory inner has no path — reopening its URL starts empty.
        inner_path = getattr(self.inner, "path", "")
        if inner_path:
            import os
            inner_path = os.path.abspath(inner_path)
        return (f"objsim://{inner_path}"
                f"?seek_ms={self.seek * 1e3:g}"
                f"&bandwidth_mbps={self.bandwidth / 1e6:g}")

    # ------------------------------------------------- delegated storage --
    def put_pages(self, pages: Mapping[str, np.ndarray]) -> int:
        self.put_calls += 1
        return self.inner.put_pages(pages)

    def get_pages(self, hashes: Sequence[str]) -> Dict[str, np.ndarray]:
        self.get_calls += 1
        self.pages_fetched += len(set(hashes))
        return self.inner.get_pages(hashes)

    def list_pages(self) -> List[str]:
        return self.inner.list_pages()

    def delete_pages(self, hashes: Sequence[str]) -> int:
        return self.inner.delete_pages(hashes)

    def commit_manifest(self, manifest: Dict) -> None:
        self.inner.commit_manifest(manifest)

    def load_manifest(self) -> Dict:
        return self.inner.load_manifest()

    def journal_append(self, record: Dict) -> int:
        return self.inner.journal_append(record)

    def journal_records(self) -> List[Dict]:
        return self.inner.journal_records()

    def journal_rewrite(self, records: Sequence[Dict]) -> None:
        self.inner.journal_rewrite(records)

    def sweep_temp(self) -> int:
        return self.inner.sweep_temp()

    def close(self) -> None:
        self.inner.close()

    # -------------------------------------------------------- calibration --
    def microbench(self, page_bytes: int = 128 * 1024, pages: int = 8,
                   repeats: int = 3) -> StorageProfile:
        """Injected, not measured: the whole point of the simulator."""
        return StorageProfile("objsim", self.bandwidth, self.seek,
                              page_bytes)
