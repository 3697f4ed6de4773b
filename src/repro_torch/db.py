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

    engine = db.serve_lm(apis, templates)        # LM prefill/decode

By default the server computes on the GPU (``compute_backend="device"``,
``kernel_mode="auto"`` = the CUDA kernels); a CPU caller asks for
``kernel_mode="torch"``/``"host"`` or ``compute_backend="numpy"``.
Likewise ``register``, ``update`` and the re-index of a reopened store
sign blocks on the card (``index_mode="auto"``, the ``lsh_signature``
kernel); a CPU caller opens with ``index_mode="torch"``/``"host"``.
``shards > 1`` partitions the slab across per-shard slabs
(:class:`~repro_torch.serving.shard_pool.ShardedWeightServer`).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np

from .core.dedup import DedupResult, Evaluator
from .core.device_index import DeviceModelStore
from .core.store import ModelStore, StoreConfig
from .serving.engine import (EmbeddingServingEngine, LMServingEngine,
                             StorageModel, WeightServer)
from .storage import PageBackend, open_backend

__all__ = ["DedupDB"]


class DedupDB:
    """A deduplicated model database bound to one storage backend."""

    def __init__(self, store: ModelStore, backend: PageBackend):
        self.store = store
        self.backend = backend

    # ------------------------------------------------------------- open --
    @classmethod
    def open(cls, url, cfg: Optional[StoreConfig] = None,
             index_mode: str = "auto", device=None) -> "DedupDB":
        """Open (or initialize) a dedup database at a storage URL.

        With a committed manifest the store comes back *live* (paged,
        nothing densified); on a fresh target an empty store is bound to
        the backend and the first :meth:`commit` creates the manifest.
        ``cfg`` overrides the persisted store configuration.  The store
        is a :class:`DeviceModelStore`: its dedup index signs blocks in
        ``index_mode`` on ``device`` (resolved at the first signature,
        so opening to serve needs no card)."""
        from .storage.faults import maybe_wrap
        backend = maybe_wrap(open_backend(url))   # REPRO_FAULTS chaos hook
        if backend.has_manifest():
            store = DeviceModelStore.open(backend, cfg,
                                          index_mode=index_mode,
                                          device=device)
        else:
            store = DeviceModelStore(cfg, index_mode=index_mode,
                                     device=device)
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
                      placement: str = "sharers",
                      transfer: str = "grouped",
                      device=None) -> WeightServer:
        """ModelStore + Eq.-2 buffer pool + calibrated storage clock.
        ``compute_backend="device"`` serves through the device page slab
        (DESIGN.md §3); slab faults then source pages straight from this
        database's backend.  ``shards > 1`` partitions the slab across
        per-shard slabs with the selected placement policy (DESIGN.md
        §5; capacity is then per shard), each on the device
        :func:`~repro_torch.launch.mesh.shard_devices` gives it, or all on
        ``device`` when one is given.  ``transfer`` selects the
        host->device movement path (DESIGN.md §6); ``device`` places the
        slab (see :class:`WeightServer`)."""
        if capacity_pages is None:
            capacity_pages = max(1, self.store.num_pages())
        if shards > 1:
            if compute_backend != "device":
                raise ValueError("shards > 1 requires "
                                 "compute_backend='device'")
            from .launch.mesh import shard_devices
            from .serving.shard_pool import ShardedWeightServer
            devices = [device] * shards if device is not None \
                else shard_devices(shards, kernel_mode)
            return ShardedWeightServer(self.store, capacity_pages, policy,
                                       storage or self.storage_model(),
                                       shards=shards, placement=placement,
                                       kernel_mode=kernel_mode,
                                       devices=devices, transfer=transfer)
        return WeightServer(self.store, capacity_pages, policy,
                            storage or self.storage_model(),
                            backend=compute_backend, kernel_mode=kernel_mode,
                            transfer=transfer, device=device)

    def serve_embedding(self, heads: Dict[str, np.ndarray],
                        capacity_pages: Optional[int] = None,
                        policy: str = "optimized_mru",
                        scheduler="round_robin",
                        overlap: bool = False, prefetch: bool = False,
                        compute_backend: str = "device",
                        kernel_mode: str = "auto",
                        storage: Optional[StorageModel] = None,
                        embed_tensor: str = "embedding",
                        shards: int = 1, placement: str = "sharers",
                        transfer: str = "grouped",
                        ) -> EmbeddingServingEngine:
        """The paper's multi-model embedding scenario, served out of this
        database in one call.  Returns the engine; ``submit``/``run`` it."""
        server = self.weight_server(capacity_pages, policy, storage,
                                    compute_backend, kernel_mode,
                                    shards=shards, placement=placement,
                                    transfer=transfer)
        prefetcher = None
        if prefetch:
            from .serving.prefetch import Prefetcher
            prefetcher = Prefetcher(server)
            overlap = True        # speculation only pays under compute
        return EmbeddingServingEngine(server, heads,
                                      embed_tensor=embed_tensor,
                                      scheduler=scheduler,
                                      prefetcher=prefetcher, overlap=overlap)

    def serve_lm(self, apis: Dict[str, object],
                 params_template: Dict[str, dict],
                 capacity_pages: Optional[int] = None,
                 policy: str = "optimized_mru",
                 scheduler="fifo",
                 overlap: bool = False, prefetch: bool = False,
                 compute_backend: str = "device",
                 kernel_mode: str = "auto",
                 storage: Optional[StorageModel] = None,
                 shards: int = 1, placement: str = "sharers",
                 transfer: str = "grouped",
                 device=None,
                 ) -> LMServingEngine:
        """LM variants served via prefill/decode with weights faulted
        through the pool (and the backend) on model switch.  ``apis`` and
        ``params_template`` as :class:`LMServingEngine` takes them."""
        server = self.weight_server(capacity_pages, policy, storage,
                                    compute_backend, kernel_mode,
                                    shards=shards, placement=placement,
                                    transfer=transfer, device=device)
        prefetcher = None
        if prefetch:
            from .serving.prefetch import Prefetcher
            prefetcher = Prefetcher(server)
            overlap = True
        return LMServingEngine(server, apis, params_template,
                               scheduler=scheduler, prefetcher=prefetcher,
                               overlap=overlap)
