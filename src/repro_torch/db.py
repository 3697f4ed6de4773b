"""DedupDB: the one-call facade over store + backend + server + engine.

Counterpart of ``repro.db``.  The paper's deployment story::

    from repro_torch.db import DedupDB

    db = DedupDB.open("sqlite:///models.db")     # or file:// / objsim://
    db.register("bert-v0", tensors)              # Alg. 1 dedup
    db.update("bert-v0", new_tensors)            # Sec. 7.6 delta update
    db.commit()                                  # transactional manifest
    engine = db.serve_embedding(heads)           # Eq.-2 pool + scheduler

``open`` on a URL with a committed manifest returns a *live* database:
pages stay paged in the backend and fault in (grouped) as serving
touches them.  The database files are the ones ``repro.db`` writes, so
the port serves a store the JAX package committed.  ``serve_embedding``
wires a :class:`~repro_torch.serving.engine.WeightServer` whose miss
costs are charged from a :meth:`StorageModel.from_backend`
microbenchmark calibration of the very backend serving the pages.

By default the server computes on the GPU (``compute_backend="device"``,
``kernel_mode="auto"`` = the CUDA kernels); a CPU caller asks for
``kernel_mode="torch"``/``"host"`` or ``compute_backend="numpy"``.
The LM engine and sharded slabs are later slices of the port.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np

from .core.dedup import DedupResult, Evaluator
from .core.store import ModelStore, StoreConfig
from .serving.engine import EmbeddingServingEngine, StorageModel, WeightServer
from .storage import PageBackend, open_backend

__all__ = ["DedupDB"]


class DedupDB:
    """A deduplicated model database bound to one storage backend."""

    def __init__(self, store: ModelStore, backend: PageBackend):
        self.store = store
        self.backend = backend

    # ------------------------------------------------------------- open --
    @classmethod
    def open(cls, url, cfg: Optional[StoreConfig] = None) -> "DedupDB":
        """Open (or initialize) a dedup database at a storage URL.

        With a committed manifest the store comes back *live* (paged,
        nothing densified); on a fresh target an empty store is bound to
        the backend and the first :meth:`commit` creates the manifest.
        ``cfg`` overrides the persisted store configuration."""
        from .storage.faults import maybe_wrap
        backend = maybe_wrap(open_backend(url))   # REPRO_FAULTS chaos hook
        if backend.has_manifest():
            store = ModelStore.open(backend, cfg)
        else:
            store = ModelStore(cfg)
            store._backend = backend             # bind for commit()/save()
        return cls(store, backend)

    def close(self) -> None:
        self.backend.close()

    # -------------------------------------------------------- lifecycle --
    def register(self, model: str, tensors: Mapping[str, np.ndarray],
                 evaluator: Optional[Evaluator] = None,
                 layers=None) -> DedupResult:
        return self.store.register(model, tensors, evaluator, layers)

    def update(self, model: str, tensors: Mapping[str, np.ndarray],
               evaluator: Optional[Evaluator] = None,
               approach: int = 2) -> DedupResult:
        return self.store.update(model, tensors, evaluator, approach)

    def remove(self, model: str) -> None:
        self.store.remove(model)

    def commit(self) -> Dict:
        """Persist the current packing: content-addressed pages + the
        transactional manifest, pruning pages orphaned by repacks."""
        return self.store.save(self.backend)

    def models(self):
        return sorted(self.store.dedup.models)

    # ---------------------------------------------------------- serving --
    def storage_model(self, page_bytes: Optional[int] = None,
                      **kw) -> StorageModel:
        """A :class:`StorageModel` calibrated from this backend's
        microbenchmark (the tier that actually holds the pages)."""
        if page_bytes is None:
            bh, bw = self.store.cfg.dedup.block_shape
            page_bytes = self.store.cfg.blocks_per_page * bh * bw \
                * self.store.native_page_dtype().itemsize
        return StorageModel.from_backend(self.backend,
                                         page_bytes=page_bytes, **kw)

    def weight_server(self, capacity_pages: Optional[int] = None,
                      policy: str = "optimized_mru",
                      storage: Optional[StorageModel] = None,
                      compute_backend: str = "device",
                      kernel_mode: str = "auto",
                      shards: int = 1,
                      transfer: str = "grouped") -> WeightServer:
        """ModelStore + Eq.-2 buffer pool + calibrated storage clock.
        ``compute_backend="device"`` serves through the device page slab
        (DESIGN.md §3); slab faults then source pages straight from this
        database's backend.  ``transfer`` selects the host->device
        movement path (DESIGN.md §6)."""
        if shards > 1:
            raise NotImplementedError(
                "shards > 1: the sharded slab (ShardedWeightServer) is a "
                "later slice of the port")
        if capacity_pages is None:
            capacity_pages = max(1, self.store.num_pages())
        return WeightServer(self.store, capacity_pages, policy,
                            storage or self.storage_model(),
                            backend=compute_backend, kernel_mode=kernel_mode,
                            transfer=transfer)

    def serve_embedding(self, heads: Dict[str, np.ndarray],
                        capacity_pages: Optional[int] = None,
                        policy: str = "optimized_mru",
                        scheduler="round_robin",
                        overlap: bool = False, prefetch: bool = False,
                        compute_backend: str = "device",
                        kernel_mode: str = "auto",
                        storage: Optional[StorageModel] = None,
                        embed_tensor: str = "embedding",
                        shards: int = 1,
                        transfer: str = "grouped",
                        ) -> EmbeddingServingEngine:
        """The paper's multi-model embedding scenario, served out of this
        database in one call.  Returns the engine; ``submit``/``run`` it."""
        server = self.weight_server(capacity_pages, policy, storage,
                                    compute_backend, kernel_mode,
                                    shards=shards, transfer=transfer)
        prefetcher = None
        if prefetch:
            from .serving.prefetch import Prefetcher
            prefetcher = Prefetcher(server)
            overlap = True        # speculation only pays under compute
        return EmbeddingServingEngine(server, heads,
                                      embed_tensor=embed_tensor,
                                      scheduler=scheduler,
                                      prefetcher=prefetcher, overlap=overlap)

    def serve_lm(self, *args, **kwargs):
        """LM variants via prefill/decode: not ported yet."""
        raise NotImplementedError(
            "serve_lm: the LM serving engine is slice 2 of the port "
            "(LMServingEngine, unblock, the dense transformer, "
            "flash_attention)")
