"""Serving runtime: the continuous-batching ``server.DecodeServer``, its
``scheduler`` and asyncio front-end, the radix ``prefix_cache``, the seeded
``loadgen`` and the ``faults`` layer.  Training (``Trainer``) and mesh
placement (``ShardPlan``) are not ported yet."""

from .faults import FAULT_POINTS, FaultError, FaultPlan, FaultSpec, TransientFault, Watchdog
from .loadgen import Trace, TraceItem, TraceSpec, make_trace, replay
from .prefix_cache import PrefixCache
from .scheduler import AsyncServer, Scheduler, SchedulerConfig
from .server import DecodeServer, Request, splice_cache

__all__ = [
    "DecodeServer",
    "Request",
    "splice_cache",
    "AsyncServer",
    "Scheduler",
    "SchedulerConfig",
    "PrefixCache",
    "Trace",
    "TraceItem",
    "TraceSpec",
    "make_trace",
    "replay",
    "FAULT_POINTS",
    "FaultError",
    "FaultPlan",
    "FaultSpec",
    "TransientFault",
    "Watchdog",
]
