from .device_pool import KERNEL_MODES, DevicePagePool, resolve_kernel_mode
from .engine import (EmbeddingServingEngine, FetchComputeTimeline,
                     LMServingEngine, ServeStats, StorageModel, WeightServer)
from .frontend import BatchComputeModel, RequestLedger, ServingFrontend
from .kvcache import PagedKVCache
from .prefetch import Prefetcher, PrefetchStats
from .router import RouteDecision, ShardRouter
from .scheduler import (SCHEDULERS, BatchScheduler, DedupAffinityScheduler,
                        FifoScheduler, RoundRobinScheduler, ScheduledBatch,
                        make_scheduler)
from .shard_pool import (PLACEMENTS, Placement, ShardedPagePool,
                         ShardedWeightServer, hash_placement, make_placement,
                         sharers_placement)
from .traffic import (OpenLoopTraffic, Request, TrafficSpec, VirtualClock,
                      zipf_weights, zoo_popularity)
from .transfer import PendingGroup, TransferEngine, TransferStats, fit_channel

__all__ = ["DevicePagePool", "KERNEL_MODES", "resolve_kernel_mode",
           "EmbeddingServingEngine", "FetchComputeTimeline",
           "LMServingEngine", "ServeStats", "StorageModel", "WeightServer",
           "BatchComputeModel", "RequestLedger", "ServingFrontend",
           "PagedKVCache", "Prefetcher", "PrefetchStats",
           "SCHEDULERS", "BatchScheduler", "DedupAffinityScheduler",
           "FifoScheduler", "RoundRobinScheduler", "ScheduledBatch",
           "make_scheduler", "RouteDecision", "ShardRouter", "PLACEMENTS",
           "Placement", "ShardedPagePool", "ShardedWeightServer",
           "hash_placement", "make_placement", "sharers_placement",
           "OpenLoopTraffic", "Request", "TrafficSpec",
           "VirtualClock", "zipf_weights", "zoo_popularity",
           "PendingGroup", "TransferEngine", "TransferStats", "fit_channel"]
