"""Runtime: ``trainer.Trainer`` on one device or a mesh (checkpoint/restart,
elastic re-sharding, failure injection, the straggler monitor) and the
serving stack: the continuous-batching ``server.DecodeServer``, its
``scheduler`` and asyncio front-end, the radix ``prefix_cache``, the seeded
``loadgen``, the ``faults`` layer, weight-only int8 serving (``quantized``,
imported by name) and mesh placement (``ShardPlan``, in both layouts)."""

from .faults import FAULT_POINTS, FaultError, FaultPlan, FaultSpec, TransientFault, Watchdog
from .loadgen import Trace, TraceItem, TraceSpec, make_trace, replay
from .prefix_cache import PrefixCache
from .scheduler import AsyncServer, Scheduler, SchedulerConfig
from .server import DecodeServer, Request, splice_cache
from .shard_plan import ShardPlan, make_shard_plan
from .trainer import SimulatedFailure, StragglerMonitor, Trainer, TrainerConfig

__all__ = [
    "SimulatedFailure",
    "StragglerMonitor",
    "Trainer",
    "TrainerConfig",
    "DecodeServer",
    "Request",
    "splice_cache",
    "ShardPlan",
    "make_shard_plan",
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
