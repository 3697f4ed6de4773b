from .device_pool import KERNEL_MODES, DevicePagePool, resolve_kernel_mode
from .engine import (EmbeddingServingEngine, FetchComputeTimeline,
                     ServeStats, StorageModel, WeightServer)
from .prefetch import Prefetcher, PrefetchStats
from .scheduler import (SCHEDULERS, BatchScheduler, DedupAffinityScheduler,
                        FifoScheduler, RoundRobinScheduler, ScheduledBatch,
                        make_scheduler)
from .transfer import PendingGroup, TransferEngine, TransferStats, fit_channel

__all__ = ["DevicePagePool", "KERNEL_MODES", "resolve_kernel_mode",
           "EmbeddingServingEngine", "FetchComputeTimeline", "ServeStats",
           "StorageModel", "WeightServer", "Prefetcher", "PrefetchStats",
           "SCHEDULERS", "BatchScheduler", "DedupAffinityScheduler",
           "FifoScheduler", "RoundRobinScheduler", "ScheduledBatch",
           "make_scheduler", "PendingGroup", "TransferEngine",
           "TransferStats", "fit_channel"]
