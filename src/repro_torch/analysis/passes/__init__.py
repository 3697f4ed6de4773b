"""Registry of the port's contract lint passes.

The passes are the reference's (``repro.analysis.passes``), keyed to
``repro_torch/...``: the modules that take their keys as constructor
arguments are verbatim copies, configured here; ``host_sync``,
``slab_writes``, ``channel_charge`` and ``durability`` are ported, with
the port's keys as their defaults and torch's host syncs, in-place slab
writes and channel charge added.
"""
from .api_drift import ApiDriftPass
from .channel_charge import ChannelChargePass
from .durability import DurabilityPass
from .frontend_clock import FrontendClockPass
from .host_sync import HostSyncPass
from .silent_except import SilentExceptPass
from .slab_writes import SlabWritePass
from .span_discipline import SpanDisciplinePass
from .unused import UnusedBindingPass
from .wallclock import WallClockPass

__all__ = [
    "ApiDriftPass",
    "ChannelChargePass",
    "DurabilityPass",
    "FrontendClockPass",
    "HostSyncPass",
    "SilentExceptPass",
    "SlabWritePass",
    "SpanDisciplinePass",
    "UnusedBindingPass",
    "WallClockPass",
    "ALL_PASSES",
    "default_passes",
]

ALL_PASSES = (
    SlabWritePass,
    HostSyncPass,
    ChannelChargePass,
    FrontendClockPass,
    SpanDisciplinePass,
    DurabilityPass,
    WallClockPass,
    ApiDriftPass,
    UnusedBindingPass,
    SilentExceptPass,
)

# the reference's DEFAULT_API_SURFACE and frontend files, in the port
PORT_API_SURFACE = (
    "repro_torch/serving/", "repro_torch/storage/", "repro_torch/analysis/",
    "repro_torch/core/store.py", "repro_torch/core/bufferpool.py",
    "repro_torch/db.py",
)
PORT_FRONTEND_FILES = ("repro_torch/serving/frontend.py",
                       "repro_torch/serving/traffic.py")


def default_passes():
    """Fresh instances of every registered pass, keyed to the port."""
    return [
        SlabWritePass(),
        HostSyncPass(),
        ChannelChargePass(),
        FrontendClockPass(files=PORT_FRONTEND_FILES),
        SpanDisciplinePass(path_fragment="repro_torch/"),
        DurabilityPass(),
        WallClockPass(),
        ApiDriftPass(surface=PORT_API_SURFACE),
        UnusedBindingPass(),
        SilentExceptPass(),
    ]
