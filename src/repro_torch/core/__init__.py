"""Core library: the paper's contribution (dedup + paging + caching)."""
from .blocks import (BlockGrid, DEFAULT_BLOCK_SHAPE, block_tensor,
                     gather_blocks, make_grid, materialize, unblock_tensor)
from .bufferpool import POLICIES, BufferPool, PoolConfig, run_trace
from .dedup import (DedupConfig, DedupResult, Deduplicator, exact_dedup,
                    minhash_dedup, pairwise_dedup)
from .lsh import L2LSH, LSHConfig, LSHIndex
from .magnitude import block_magnitudes
from .pagepack import (PackResult, alg2_bound, check_coverage,
                       equivalent_classes, pack, pack_dedup_base,
                       pack_greedy1, pack_greedy2, pack_two_stage)
from .store import ModelStore, StoreConfig, VirtualTensor, load_store_tensors

__all__ = [
    "BlockGrid", "DEFAULT_BLOCK_SHAPE", "block_tensor", "gather_blocks",
    "make_grid", "materialize", "unblock_tensor",
    "POLICIES", "BufferPool", "PoolConfig", "run_trace",
    "DedupConfig", "DedupResult", "Deduplicator", "exact_dedup",
    "minhash_dedup", "pairwise_dedup",
    "L2LSH", "LSHConfig", "LSHIndex", "block_magnitudes",
    "PackResult", "alg2_bound", "check_coverage", "equivalent_classes",
    "pack", "pack_dedup_base", "pack_greedy1", "pack_greedy2",
    "pack_two_stage",
    "ModelStore", "StoreConfig", "VirtualTensor", "load_store_tensors",
]
