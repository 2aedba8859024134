"""Batched decode server with slot-based continuous batching; the port's
counterpart of ``repro/runtime/server.py``.

B cache *slots* are the state registers of the serving state-space system;
each decode tick applies f once for all slots.  Requests claim free slots,
retire on EOS / max tokens / end of cache, and new requests are admitted
between ticks.

Two decode drivers share the slot machinery:

* ``step()`` — one ``decode_step`` per tick and one host↔device sync per
  tick: the logits come back to the host, which samples per slot.
* ``step_block()`` — ``block_k`` decode steps whose tokens, live masks and
  EOS / max-token / out-of-cache stopping stay on the device, with greedy
  argmax or ``torch.multinomial`` sampling on the device; the K×B token block
  comes back to the host in ONE sync.  The K steps are a Python loop of
  device work; the cache layout is the ``splice_cache`` layout, so admission
  between blocks is unchanged.

Prefill is one-shot (``lm.prefill`` per admitted prompt, then the B=1 state
is spliced into the slot) or chunked (``prefill_chunk=N``: N prompt tokens per
tick through ``lm.prefill_chunk``, at most ``prefill_chunks_per_tick`` chunks
a tick, interleaved with decode ticks; ``prefill_adaptive`` drains whole
jobs on ticks where no slot is decoding).  Under ``use_pallas`` every
one-shot prefill runs the model's kernel once per layer (``lstm_seq``,
``ssm_scan`` or ``flash_attention``, with gemma3's window on its local
layers and once per application of zamba2's shared block; zamba2's
Mamba-2 blocks have no kernel); chunks run ``lstm_seq`` and ``ssm_scan``
too, while attention chunks attend over the cache in plain PyTorch, as the
reference's do.
A VLM (no cross-attention memory: the reference's server passes none) and
an encoder (no decode) are refused at construction.
Cache leaves keep their slot and sequence axes where :data:`CACHE_AXES`
says (a tail block's leaves have no ``G`` axis), and every function that
writes or slices a slot reads them there.

The radix prefix cache (``prefix_cache_bytes``) stores chunk-boundary and
prompt-end states on the server's device: a full hit splices the stored
state (0 recomputed prompt steps), a partial hit resumes chunked prefill
from the deepest chunk-aligned boundary.  Fault points (``faults`` or the
ambient plan of ``runtime.faults``) and the stall watchdog (``watchdog_s``)
follow the reference: an injected NaN quarantines only its slot, a
transient dispatch fault retries the tick, a stall aborts in-flight work
with ``error:stalled``.  A real failure of a kernel is never caught.

Counters, spans, ``stats()`` and ``health()`` keys keep the reference's
names.

Mesh placement (``plan=``, a :class:`~repro_torch.runtime.shard_plan.ShardPlan`)
spreads the slot pool over the plan's data axis in contiguous per-shard
blocks, with one prefix cache a shard (1/dp of the byte budget each) and
shard-affine admission: the shard whose cache holds the deepest checkpoint
of the prompt, then the least loaded one, then the lowest id.  Two layouts:

* **folded** (``fold_data=True``): the shards are logical; one process
  decodes all of them through one datapath, exactly as ``plan=None`` does.
* **sharded**: the server is SPMD.  Every rank of the plan's process group
  runs this host logic on the same stream of ``submit`` calls and holds and
  computes only its own shard's slots: a prefill runs on the rank that owns
  its slot, a decode tick on each rank's slot rows.  What the host logic
  needs from another rank's tensors crosses a gloo group as host integers:
  one ``all_gather`` a decode tick (each slot's token and finite flag, or
  the packed block of ``step_block()``) and one ``broadcast`` from the
  owner a prefill call (the first token and the checkpoint's byte count).
  So the scheduler, the slot map, the prefix-cache trees and the counters
  are the same on every rank (:meth:`DecodeServer.host_state`), and rank 0's
  ``stats()``, ``health()`` and ``completed`` are the server's answer.
  Greedy decoding gives the unsharded server's tokens where a model's
  rows are independent (recurrent, SSM, attention); an MoE decode tick
  groups each rank's slots alone, so capacity drops can differ.  Sampled
  decoding draws each slot's token on its owner with that rank's
  generator, so the draws differ from the unsharded server's.  Decisions read from each
  rank's own clock would split the ranks, so this layout refuses the
  watchdog, load shedding, request deadlines and explicit priority aging,
  and its default scheduler does not age (ROADMAP.md, Queue 1 item 12c).
  At ``tp > 1`` the ranks along ``model`` of a data shard all hold its
  slots and compute them together on their model shards
  (``sharding.computes_on_model_shard``: the dense transformer, Mamba-1
  and MoE with GQA attention, its heads cut whole or not, or MLA): the
  server cuts the parameters to this rank's block
  (``ShardPlan.local_params``: its heads or columns of a head, FFN
  columns, inner channels, experts and vocabulary rows), its caches hold
  this rank's KV heads or inner channels (every KV head where they do not
  cut whole, as ``cache_specs`` keeps them; an MLA latent whole), and
  every logit row it samples from is joined exactly over ``model`` first
  (``tensor_parallel.join_vocab``), so the argmax and the draws are the
  same on every model rank.  The recurrent and hybrid families at
  ``tp > 1`` raise, citing item 12c(c); the VLM and the encoder, which compute on a model shard
  through ``lm``'s entry points, are refused here at every ``tp`` for
  the reasons above.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs as obs_lib
from repro_torch._tree import tree_leaves
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig

from repro_torch.parallel import comm
from repro_torch.parallel import tensor_parallel as tp_lib
from repro_torch.parallel.sharding import (computes_on_model_shard, model_shard,
                                           model_shard_refusal)

from . import faults as faults_lib
from .faults import Watchdog
from .prefix_cache import REMOTE, PrefixCache, entry_bytes
from .scheduler import REJECT_DUPLICATE_UID, Scheduler, SchedulerConfig
from .shard_plan import ShardPlan

PyTree = Any

DEFAULT_BLOCK_K = 8


_SEQ_LEAVES = ("k", "v", "c_kv", "k_rope")   # attention K/V and MLA's latent leaves

# Where a cache leaf keeps its slot and sequence axes, by the subtree it is
# in: per-group leaves are stacked on a leading G axis, tail leaves are not.
CACHE_AXES = {"groups": (1, 2), "tail": (0, 1)}


def _slot_major(caches: PyTree, *others: PyTree):
    """Yield ``(leaf name, view, *views of the same leaf in others)`` for
    every leaf of ``caches``, each view laid out ``[G, slot, seq, ...]``
    (:data:`CACHE_AXES`: a tail leaf gets a leading axis of 1).  ``others``
    are walked by ``caches``' keys.  The views share storage with the
    leaves, so an in-place write through one is a write to the cache."""

    def walk(trees, lead, name):
        if isinstance(trees[0], dict):
            for k in trees[0]:
                yield from walk([t[k] for t in trees], lead, k)
        else:
            yield (name, *(t if lead else t.unsqueeze(0) for t in trees))

    for top in caches:
        yield from walk([caches[top], *(o[top] for o in others)],
                        CACHE_AXES[top][0] == 1, top)


def splice_cache(caches: PyTree, prefill_caches: PyTree, b: int,
                 max_seq: int | None = None) -> PyTree:
    """Insert a B=1 prefill state into batch slot ``b`` of the server cache.

    Every leaf is handled with its slot and sequence axes from
    :data:`CACHE_AXES` (axes 1 and 2 under ``"groups"``, 0 and 1 under
    ``"tail"``).  A recurrent carry (``h``/``c``) and a Mamba state
    (Mamba-1's ``h`` and ``conv``, Mamba-2's ``h`` and ``conv.{x, bc}``)
    have no sequence axis, so admission is a pure slot write and never
    disturbs other slots.  An attention KV leaf (and MLA's ``c_kv`` and
    ``k_rope``) carries one:
    a one-shot prefill's ``L`` positions go left-aligned into the slot's
    row (positions ``0 .. L-1``); a chunked prefill's B=1 cache, already in
    the server's layout, is a slot row like the others.  A source longer
    than the destination wraps only into a sliding-window ring buffer, a
    destination shorter than ``max_seq``: its last ``W`` positions go to
    slot ``p mod W``.  Against a full-attention destination it raises:
    wrapping a full cache would overwrite early positions with late ones
    while the causal mask still exposes every position.

    The tail caches are spliced too.  Here the port departs from the
    reference on purpose: the reference's ``splice_cache`` matches tail
    leaves, which have no ``G`` axis, with neither of its branches and
    leaves them untouched, so its server decodes gemma3 from empty tail
    rings and zamba2 from zero tail Mamba-2 states (ROADMAP.md, Queue 3).
    The destination tensors are updated in place; the returned tree holds
    the same tensors.
    """
    for name, dst, src in _slot_major(caches, prefill_caches):
        if src.dim() >= 3 and dst.dim() == src.dim() and src.shape[2] != dst.shape[2] \
                and name in _SEQ_LEAVES:
            # sequence-bearing cache: [G, 1, L, ...] -> [G, B, S_dst, ...]
            L, S_dst = src.shape[2], dst.shape[2]
            if L <= S_dst:
                dst[:, b, :L] = src[:, 0].to(dst.dtype)
                continue
            if max_seq is None or S_dst >= max_seq:
                raise ValueError(
                    f"splice_cache: prompt of length {L} overflows the full-attention "
                    f"cache leaf '{name}' (S_max={S_dst}); admission must reject or "
                    "truncate it — only sliding-window ring buffers may wrap")
            # ring buffer (sliding window): the last W positions, p -> p mod W
            W = S_dst
            slots = torch.remainder(torch.arange(L - W, L, device=dst.device), W)
            dst[:, b, slots] = src[:, 0, L - W:].to(dst.dtype)
            continue
        if src.dim() == dst.dim() and src.shape[1] == 1 and src.shape[2:] == dst.shape[2:]:
            dst[:, b] = src[:, 0].to(dst.dtype)
            continue
        raise NotImplementedError(
            f"splice_cache: source {tuple(src.shape)} → destination "
            f"{tuple(dst.shape)} of leaf '{name}' is neither a slot-row state "
            "nor a left-aligned or ring-wrapped KV prefix")
    return caches


def scheduler_config(plan: ShardPlan | None = None, **kw) -> SchedulerConfig:
    """A ``SchedulerConfig`` with the server's defaults under ``plan``: the
    sharded layout does not age priorities (aging reads each rank's own
    clock, which would split the ranks)."""
    if plan is not None and not plan.fold_data:
        kw.setdefault("aging_rate", 0.0)
    return SchedulerConfig(**kw)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 16
    temperature: float = 0.0   # 0 = greedy
    priority: int = 1          # scheduler class; smaller = more urgent
    # TTL budget in seconds from submission (None = no deadline); expired
    # requests retire as "expired:queue" or "expired:decode".
    deadline_s: float | None = None
    deadline_at: float | None = None     # absolute (stamped at submit)
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    dispatched_at: float | None = None   # popped from the queue (slot found)
    first_token_at: float | None = None
    done_at: float | None = None
    retired_at: float | None = None      # == done_at; every path stamps it
    finish_reason: str | None = None
    truncated: bool = False     # prompt cut to the admission limit
    prefix_hit_tokens: int = 0  # prompt steps served from the prefix cache
    shard: int | None = None    # data shard placed on (None = unsharded)


@dataclasses.dataclass
class _PrefillJob:
    """A resumable prompt scan bound to a reserved slot."""

    req: Request
    slot: int
    caches: PyTree            # B=1 decode-layout state (None on a rank that
    #                           does not own the slot)
    pos: int = 0              # prompt tokens consumed so far
    logits: Any = None        # last-token logits of the latest chunk (device)


class DecodeServer:
    def __init__(self, cfg: ModelConfig, params: PyTree, num_slots: int, max_seq: int,
                 eos_id: int | None = None, seed: int = 0,
                 block_k: int = DEFAULT_BLOCK_K, persistent: bool = False,
                 prefill_chunk: int = 0,
                 prefix_cache_bytes: int = 0,
                 scheduler: Scheduler | SchedulerConfig | None = None,
                 prefill_chunks_per_tick: int = 1,
                 prefill_adaptive: bool = False,
                 obs: obs_lib.Observability | None = None,
                 faults: faults_lib.FaultPlan | None = None,
                 watchdog_s: float | None = None,
                 plan: ShardPlan | None = None,
                 device: str | torch.device | None = None):
        if plan is not None and not plan.fold_data:
            # first: what cannot compute on a model shard names item 12c(c)
            self._check_sharded(cfg, plan, scheduler, watchdog_s)
        if cfg.family == "vlm":
            raise NotImplementedError(
                f"DecodeServer: {cfg.name} is a VLM, and the reference's server passes no "
                "cross-attention memory (its cross blocks fail on memory=None); drive "
                "lm.prefill / lm.decode_step with memory= instead")
        if cfg.family == "encoder":
            raise NotImplementedError(
                f"DecodeServer: {cfg.name} is an encoder, and an encoder has no decode; "
                "use lm.forward")
        # Mesh placement: the slot pool in contiguous per-shard blocks over
        # the plan's data axis; plan=None is the single-device server.
        self.plan = plan
        self.dp = plan.dp if plan is not None else 1
        self._slots_per_shard = (plan.validate_slots(num_slots)
                                 if plan is not None else num_slots)
        self._rows = None           # this rank's slots (the sharded layout)
        self._tp_mesh = None        # the mesh whose model shard this rank computes on
        if plan is not None and not plan.fold_data:
            self._rows = plan.slots_of_shard(plan.local_shard, num_slots)
            if plan.tp > 1:
                # this rank's model block of the parameters; the model code
                # computes on it inside the model-shard context
                self._tp_mesh = plan.mesh
                params = plan.local_params(cfg, params)
            self._group = plan.control_group()
            world = self._group if self._group is not None else dist.group.WORLD
            # the shards' owners, in shard order: global ranks and group ranks
            self._owner = [plan.shard_rank(s) for s in range(plan.dp)]
            self._order = [dist.get_group_rank(world, r) for r in self._owner]
            if scheduler is None:
                scheduler = scheduler_config(plan)
        self.device = resolve_device(device)
        leaf = tree_leaves(params)[0]
        if leaf.device.type != self.device.type:
            raise ValueError(f"params are on {leaf.device}, the server runs on {self.device}")
        self.cfg, self.params = cfg, params
        self.B, self.S = num_slots, max_seq
        self.eos_id = eos_id
        self.block_k = block_k
        self.persistent = persistent
        self.prefill_chunk = int(prefill_chunk)
        self.prefill_chunks_per_tick = max(1, int(prefill_chunks_per_tick))
        # Adaptive chunk sizing: a tick with no slot decoding drains pending
        # prefill jobs whole (no live stream to protect from head-of-line
        # blocking); the chunk bound re-engages once any slot is live.
        self.prefill_adaptive = bool(prefill_adaptive)
        if self.prefill_adaptive and self.prefill_chunk <= 0:
            raise ValueError(
                "prefill_adaptive=True requires prefill_chunk > 0 "
                "(adaptive sizing adapts the chunked path; unchunked "
                "prefill is already one-shot)")
        # Per-server observability scope: counters always on (they ARE the
        # stats() numbers), tracing opt-in (obs=Observability(trace=True)).
        self.obs = obs if obs is not None else obs_lib.Observability()
        self._tr = self.obs.tracer
        self._tr.thread_name(0, "server")
        # one PrefixCache per data shard (1/dp of the budget each, counters
        # labelled shard=N): a hit is a hit only on the shard whose slots
        # hold the checkpointed rows
        if not prefix_cache_bytes:
            self.prefix_caches = None
        elif plan is None:
            self.prefix_caches = [PrefixCache(prefix_cache_bytes, metrics=self.obs.metrics)]
        else:
            per_shard = max(1, int(prefix_cache_bytes) // self.dp)
            self.prefix_caches = [PrefixCache(per_shard, metrics=self.obs.metrics, shard=s)
                                  for s in range(self.dp)]
        if isinstance(scheduler, Scheduler):
            self.scheduler = scheduler
            self.scheduler.prompt_limit = self.scheduler.prompt_limit or (max_seq - 1)
        else:
            self.scheduler = Scheduler(scheduler, prompt_limit=max_seq - 1,
                                       metrics=self.obs.metrics)
        # An explicit FaultPlan wins; otherwise the ambient plan installed
        # through runtime.faults is consulted per fire.  With no plan
        # anywhere, every fault check is one `is None`.
        self.faults = faults
        self._watch = Watchdog(watchdog_s) if watchdog_s else None
        self._last_work = 0                 # progress marker for the watchdog
        # the sharded layout allocates this rank's slot rows only (and, at
        # tp > 1, this rank's heads or channels)
        with self._model_ctx():
            self.caches = lm.init_cache(
                cfg, num_slots if self._rows is None else len(self._rows), max_seq, self.device)
        self.pos = np.zeros(num_slots, np.int32)        # next write position
        self.live = np.zeros(num_slots, bool)
        self.reserved = np.zeros(num_slots, bool)       # prefill job in flight
        self.quarantined = np.zeros(num_slots, bool)    # awaiting state scrub
        self.slot_req: list[Request | None] = [None] * num_slots
        self._inflight: dict[int, Request] = {}         # uid -> admitted req
        self.cur_tokens = np.zeros(num_slots, np.int32)
        self.completed: list[Request] = []
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._jobs: list[_PrefillJob] = []
        self._job_rr = 0                                # round-robin cursor
        # Decode-phase sync accounting (prefill excluded): host round-trips
        # per generated token — ~1/live for step(), ~1/(K·live) for
        # step_block().
        m = self.obs.metrics
        self._m_syncs = m.counter("decode_syncs",
                                  "host round-trips in the decode phase")
        self._m_tokens = m.counter("decoded_tokens", "tokens generated")
        self._m_prompt_steps = m.counter("prompt_steps_computed",
                                         "prompt tokens run on device")
        self._m_chunks = m.counter("prefill_chunks_run", "chunk dispatches")
        self._m_kernel_syncs = m.counter(
            "prefill_kernel_syncs",
            "host round-trips inside prefill kernel calls (a persistent kernel "
            "waits for its stream to read its grid barrier's error word)")
        self._m_tick_max = m.gauge(
            "max_prompt_steps_per_tick",
            "high-watermark of per-tick prompt work (boundedness proof)")
        self._m_tick_contended = m.gauge(
            "max_prompt_steps_contended_tick",
            "high-watermark of per-tick prompt work on ticks where a live "
            "slot was decoding — the bound adaptive prefill must honor")
        self._m_live = m.gauge("live_slots", "slots decoding")
        self._h_ttft = m.histogram("ttft_ms", "submit -> first token")
        self._h_tpot = m.histogram("tpot_ms", "per-token decode latency")
        self._h_queue = m.histogram("queue_wait_ms",
                                    "submit -> dispatch (or terminal event "
                                    "for requests that never dispatched)")
        self._m_quar = m.counter("slots_quarantined",
                                 "slots retired on non-finite state")
        self._m_disp_retries = m.counter(
            "decode_dispatch_retries",
            "decode ticks aborted on a transient dispatch error")
        self._m_stalled = m.counter(
            "server_stalled", "watchdog firings (no progress in bound)")
        # per-shard telemetry: token counters labelled shard=N, and one trace
        # track per data shard (tid = 10_000 + s) for live-slot counters
        self._m_tokens_shard = (
            [m.counter("decoded_tokens_shard", "tokens generated by data shard", shard=s)
             for s in range(self.dp)]
            if plan is not None else None)
        if plan is not None and self._tr.enabled:
            for s in range(self.dp):
                self._tr.thread_name(10_000 + s, f"shard {s}")
        self._tick_prompt_steps = 0
        self._tick_uncontended = True       # no slot is live before tick 0

    # registry-backed views ---------------------------------------------------

    @property
    def decode_syncs(self) -> int:
        return int(self._m_syncs.value)

    @property
    def prefill_kernel_syncs(self) -> int:
        """Host round-trips inside prefill kernel calls: one per call of a
        persistent kernel (``lstm_seq``, a generated stage), which waits for
        its stream to read its grid barrier's error word.  Not in
        ``decode_syncs``, which counts the decode phase only."""
        return int(self._m_kernel_syncs.value)

    @property
    def decoded_tokens(self) -> int:
        return int(self._m_tokens.value)

    @property
    def prompt_steps_computed(self) -> int:
        return int(self._m_prompt_steps.value)

    @property
    def prefill_chunks_run(self) -> int:
        return int(self._m_chunks.value)

    @property
    def max_prompt_steps_per_tick(self) -> int:
        return int(self._m_tick_max.value)

    @property
    def max_prompt_steps_contended_tick(self) -> int:
        return int(self._m_tick_contended.value)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Admission-controlled enqueue.  Rejected requests complete
        immediately with ``finish_reason='rejected:<reason>'`` and expired
        ones with ``'expired:queue'``."""
        now = time.perf_counter()
        req.submitted_at = now
        if req.deadline_s is not None and self._rows is not None:
            raise NotImplementedError(
                "DecodeServer(plan): request deadlines read each rank's own clock, "
                "which would split the ranks of a sharded server; not ported yet "
                "(ROADMAP.md, Queue 1 item 12c)")
        if req.deadline_s is not None:
            req.deadline_at = now + req.deadline_s
            if req.deadline_s <= 0:   # dead on arrival: expire before admit
                self._retire(req, now, "expired:queue")
                return False
        if req.uid in self._inflight:
            req.finish_reason = f"rejected:{REJECT_DUPLICATE_UID}"
            self.obs.metrics.counter("sched_rejected", "admission rejections",
                                     reason=REJECT_DUPLICATE_UID).inc()
            self._retire(req, now, req.finish_reason)
            return False
        admitted, _reason = self.scheduler.admit(req, now=now)
        for victim in self.scheduler.drain_evicted():
            self._retire(victim, now, victim.finish_reason)
        if not admitted:
            self._retire(req, now, req.finish_reason)
        else:
            self._inflight[req.uid] = req
        return admitted

    def _free_slot(self, shard: int | None = None) -> int | None:
        """First free slot: in ``shard``'s block when given, anywhere
        otherwise."""
        slots = range(self.B) if shard is None else self.plan.slots_of_shard(shard, self.B)
        for b in slots:
            if not self.live[b] and not self.reserved[b] and not self.quarantined[b]:
                return b
        return None

    @property
    def prefix_cache(self) -> PrefixCache | None:
        """The unsharded server's single prefix cache (None under a plan)."""
        return self.prefix_caches[0] if self.prefix_caches and self.plan is None else None

    # -- mesh placement (all trivial when plan is None) -----------------------

    @staticmethod
    def _check_sharded(cfg: ModelConfig, plan: ShardPlan, scheduler, watchdog_s) -> None:
        """The sharded layout's refusals: what it cannot run says so, and
        nothing falls back to one device."""
        if plan.tp > 1 and not computes_on_model_shard(cfg, plan.mesh):
            why = model_shard_refusal(cfg) or (
                f"{cfg.name}'s attention projections ({cfg.n_heads} query, {cfg.n_kv_heads} "
                f"KV heads of {cfg.head_dim}) do not cut over tp={plan.tp}")
            raise NotImplementedError(f"DecodeServer(plan) at tp={plan.tp}: {why}")
        plan.require_group()
        cfg = scheduler.cfg if isinstance(scheduler, Scheduler) else scheduler
        why = ("watchdog_s" if watchdog_s else
               "load shedding (SchedulerConfig.shed)" if cfg is not None and cfg.shed else
               "priority aging (SchedulerConfig.aging_rate > 0)"
               if cfg is not None and cfg.policy == "priority" and cfg.aging_rate > 0 else None)
        if why:
            raise NotImplementedError(
                f"DecodeServer(plan): {why} reads each rank's own clock, which would "
                "split the ranks of a sharded server; not ported yet (ROADMAP.md, "
                "Queue 1 item 12c)")

    def _shard_of(self, b: int) -> int:
        return 0 if self.plan is None else b // self._slots_per_shard

    def _owns(self, b: int) -> bool:
        """Whether this process holds slot ``b``'s state (every slot except
        in the sharded layout)."""
        return self._rows is None or b in self._rows

    def _lb(self, b: int) -> int:
        """Slot ``b``'s row in this process's cache tensors."""
        return b if self._rows is None else b - self._rows.start

    def _model_ctx(self):
        """The model-shard context at tp > 1 (every model call and cache
        allocation runs in it, and every logit row the server samples
        from is joined over ``model`` there: ``tensor_parallel.
        join_vocab``), else nothing."""
        return model_shard(self._tp_mesh) if self._tp_mesh is not None else \
            contextlib.nullcontext()

    def _pc(self, shard: int) -> PrefixCache | None:
        """The prefix cache of ``shard``'s slots (the single cache when
        unsharded)."""
        if self.prefix_caches is None:
            return None
        return self.prefix_caches[shard if self.plan is not None else 0]

    def _shard_load(self, shard: int) -> int:
        return sum(1 for b in self.plan.slots_of_shard(shard, self.B)
                   if self.live[b] or self.reserved[b])

    def _place(self, req: Request) -> int:
        """Shard-affine placement: among shards with a free slot, the one
        whose prefix cache holds the deepest checkpoint of the prompt (ties:
        least loaded, then lowest id); least loaded without prefix caches."""
        free = [s for s in range(self.dp) if self._free_slot(shard=s) is not None]
        if self.prefix_caches is not None:
            return min(free, key=lambda s: (-self.prefix_caches[s].peek_depth(req.prompt),
                                            self._shard_load(s), s))
        return min(free, key=lambda s: (self._shard_load(s), s))

    def _from_owner(self, b: int, *vals: int) -> list[int]:
        """Integers only slot ``b``'s owner can compute (a first token, a
        checkpoint's byte count), on every rank: one broadcast from the
        owner over the control group in the sharded layout.  Other ranks
        pass placeholders."""
        if self._rows is None:
            return [int(v) for v in vals]
        t = torch.tensor([int(v) if self._owns(b) else 0 for v in vals], dtype=torch.int64)
        comm.broadcast(t, self._owner[self._shard_of(b)], self._group)
        return t.tolist()

    def _gather_slots(self, local: np.ndarray) -> np.ndarray:
        """Each rank's ``[R, len(rows)]`` host integers → ``[R, B]`` in slot
        order on every rank: the one all_gather of a sharded decode tick."""
        t = torch.as_tensor(np.ascontiguousarray(local, np.int64))[None]
        parts = comm.all_gather(t, self._group)             # [dp, R, k] by group rank
        return parts[self._order].permute(1, 0, 2).reshape(local.shape[0], self.B).numpy()

    def _splice(self, src: PyTree, b: int) -> None:
        if self._owns(b):
            self.caches = splice_cache(self.caches, src, self._lb(b), self.S)

    def _retire(self, req: Request, now: float, reason: str) -> None:
        req.done_at = req.retired_at = now
        req.finish_reason = req.finish_reason or reason
        if self._inflight.get(req.uid) is req:
            del self._inflight[req.uid]
        self.completed.append(req)
        self._observe_retire(req, now)

    def _observe_retire(self, req: Request, now: float) -> None:
        """Latency metrics + the retroactive per-request trace track
        (``tid = uid + 1``: request ⊇ queue_wait → prefill → decode)."""
        self.obs.metrics.counter(
            "requests_completed", "retired requests by finish reason",
            reason=(req.finish_reason or "unknown").split(":")[0]).inc()
        n_out = len(req.out_tokens)
        if req.first_token_at is not None:
            self._h_ttft.observe((req.first_token_at - req.submitted_at) * 1e3)
            if n_out > 1 and req.done_at is not None:
                self._h_tpot.observe(
                    (req.done_at - req.first_token_at) / (n_out - 1) * 1e3)
        if req.dispatched_at is not None:
            self._h_queue.observe((req.dispatched_at - req.submitted_at) * 1e3)
        elif req.submitted_at:
            self._h_queue.observe((now - req.submitted_at) * 1e3)
        tr = self._tr
        if not tr.enabled:
            return
        tid = req.uid + 1
        tr.thread_name(tid, f"req {req.uid}")
        t_sub = tr.to_us(req.submitted_at)
        t_done = max(tr.to_us(now), t_sub)
        args = {"uid": req.uid, "prompt_tokens": len(req.prompt),
                "out_tokens": n_out, "finish_reason": req.finish_reason,
                "prefix_hit_tokens": req.prefix_hit_tokens}
        if req.shard is not None:
            args["shard"] = req.shard
        tr.complete("request", t_sub, t_done - t_sub, cat="request", tid=tid, args=args)
        t_disp = min(tr.to_us(req.dispatched_at), t_done) \
            if req.dispatched_at is not None else t_done
        tr.complete("queue_wait", t_sub, t_disp - t_sub, cat="request", tid=tid)
        if req.first_token_at is not None:
            t_first = min(tr.to_us(req.first_token_at), t_done)
            tr.complete("prefill", t_disp, t_first - t_disp, cat="request", tid=tid)
            tr.complete("decode", t_first, t_done - t_first, cat="request",
                        tid=tid, args={"tokens": n_out})

    # ------------------------------------------------------------------
    # fault points, quarantine, deadlines, cancellation
    # ------------------------------------------------------------------

    def _fire(self, point: str):
        """Consult the server's (or the ambient) fault plan at ``point``."""
        spec = faults_lib.fire(point, self.faults)
        if spec is not None:
            self.obs.metrics.counter("faults_injected", "injected faults",
                                     point=point).inc()
        return spec

    def _fault_slot(self, spec) -> int | None:
        """The poisoned slot: the rule's payload may pin ``slot=``; otherwise
        the point's seeded stream chooses among the live slots, as the
        reference's does."""
        if "slot" in spec.payload:
            b = int(spec.payload["slot"])
            return b if self.live[b] else None
        live = [b for b in range(self.B) if self.live[b]]
        if not live:
            return None
        plan = self.faults if self.faults is not None else faults_lib.get_plan()
        return plan.rng(spec.point).choice(live)

    def _dispatch_fault(self) -> bool:
        """An injected transient dispatch error at the ``decode.dispatch``
        point: the tick is aborted, to be retried the next tick (state
        untouched).  A short sleep keeps a permanent fault from spinning the
        host; the watchdog bounds the livelock."""
        if self._fire("decode.dispatch") is None:
            return False
        self._m_disp_retries.inc()
        time.sleep(0.001)
        return True

    def _slot_leaves(self, floating: bool = False) -> list[torch.Tensor]:
        """Every cache leaf as a view whose axis 1 is the slot axis
        (:data:`CACHE_AXES`; a tail leaf gets a leading axis of 1), so the
        tail's rings are poisoned and scrubbed with the groups' leaves."""
        return [view for _, view in _slot_major(self.caches)
                if view.is_floating_point() or not floating]

    def _poison_slot(self, b: int, mode: str = "nan") -> None:
        """Write NaN/Inf into slot ``b``'s float cache rows, in place: the
        injected effect of the carry and splice fault points.  Other slots'
        rows are untouched, so survivors stay bit-identical.  In the sharded
        layout only the owner holds the rows; the quarantine reaches every
        rank through the gathered finite flags."""
        if not self._owns(b):
            return
        bad = float("nan") if mode == "nan" else float("inf")
        for leaf in self._slot_leaves(floating=True):
            leaf[:, self._lb(b)] = bad

    def _scrub_slot(self, b: int) -> None:
        """Zero slot ``b``'s cache rows: quarantined state never leaks into
        the next request admitted to the slot."""
        if not self._owns(b):
            return
        for leaf in self._slot_leaves():
            leaf[:, self._lb(b)] = 0

    def _quarantine(self, b: int, now: float) -> None:
        """Retire slot ``b``'s request with ``error:nonfinite`` and pull the
        slot from service until its state is scrubbed (start of next tick)."""
        req = self.slot_req[b]
        if req is not None:
            self._retire(req, now, "error:nonfinite")
        self.slot_req[b] = None
        self.live[b] = False
        self.quarantined[b] = True
        self._m_quar.inc()
        if self.plan is not None:
            self.obs.metrics.counter("slots_quarantined_shard", "quarantines by data shard",
                                     shard=self._shard_of(b)).inc()

    def _scrub_quarantined(self) -> None:
        for b in range(self.B):
            if self.quarantined[b]:
                self._scrub_slot(b)
                self.quarantined[b] = False

    def _reap_deadlines(self, now: float) -> None:
        """Retire every expired request — queued (``expired:queue``), mid-
        prefill or mid-decode (``expired:decode``)."""
        for req in self.scheduler.reap_expired(now):
            self._retire(req, now, "expired:queue")
        for job in [j for j in self._jobs
                    if j.req.deadline_at is not None and now >= j.req.deadline_at]:
            self._jobs.remove(job)
            self.reserved[job.slot] = False
            self._retire(job.req, now, "expired:decode")
        for b in range(self.B):
            req = self.slot_req[b]
            if req is not None and self.live[b] \
                    and req.deadline_at is not None and now >= req.deadline_at:
                self._retire(req, now, "expired:decode")
                self.live[b] = False
                self.slot_req[b] = None

    def cancel(self, uid: int) -> bool:
        """Cancel a request anywhere in flight; it retires as ``cancelled``."""
        now = time.perf_counter()
        req = self.scheduler.remove(uid)
        if req is not None:
            self._retire(req, now, "cancelled")
            return True
        for job in self._jobs:
            if job.req.uid == uid:
                self._jobs.remove(job)
                self.reserved[job.slot] = False
                self._retire(job.req, now, "cancelled")
                return True
        for b in range(self.B):
            req = self.slot_req[b]
            if req is not None and req.uid == uid:
                self._retire(req, now, "cancelled")
                self.live[b] = False
                self.slot_req[b] = None
                return True
        return False

    def _abort_inflight(self, reason: str, now: float) -> None:
        """Retire every in-flight request with ``reason`` (stall recovery:
        nothing awaits forever, nothing silently disappears)."""
        while True:
            req = self.scheduler.next_request(now=now)
            if req is None:
                break
            self._retire(req, now, reason)
        for job in list(self._jobs):
            self.reserved[job.slot] = False
            self._retire(job.req, now, reason)
        self._jobs.clear()
        for b in range(self.B):
            req = self.slot_req[b]
            if req is not None:
                self._retire(req, now, reason)
                self.live[b] = False
                self.slot_req[b] = None

    def _watchdog_check(self) -> None:
        """Fire the stall watchdog when work is in flight but no tick has
        made progress (tokens decoded, prompt steps run, or requests
        retired) within the wall-clock bound."""
        if self._watch is None:
            return
        now = time.perf_counter()
        work = self.decoded_tokens + self.prompt_steps_computed + len(self.completed)
        if work != self._last_work:
            self._last_work = work
            self._watch.progress(now)
            return
        pending = bool(self.live.any() or self._jobs or len(self.scheduler))
        if pending and self._watch.stalled(now):
            self._m_stalled.inc()
            self._watch.fired += 1
            self._abort_inflight("error:stalled", now)
            self._watch.progress(now)

    def health(self) -> dict:
        """Readiness/liveness snapshot (also ``stats()["health"]``)."""
        stalled = int(self._m_stalled.value)
        quarantined = int(self.quarantined.sum())
        shed = int(self.obs.metrics.value("sched_rejected", reason="shed"))
        status = "stalled" if stalled else (
            "degraded" if quarantined or shed or int(self._m_quar.value) else "ok")
        out = {
            "status": status,
            "live_slots": int(self.live.sum()),
            "reserved_slots": int(self.reserved.sum()),
            "quarantined_slots": quarantined,
            "queued": len(self.scheduler),
            "slots_quarantined_total": int(self._m_quar.value),
            "dispatch_retries": int(self._m_disp_retries.value),
            "stalled_events": stalled,
            "watchdog_s": self._watch.bound_s if self._watch else None,
            "last_progress_idle_s": self._watch.idle_s() if self._watch else None,
        }
        if self.plan is not None:
            out["mesh"] = self.plan.describe()
            out["quarantined_by_shard"] = [
                sum(int(self.quarantined[b]) for b in self.plan.slots_of_shard(s, self.B))
                for s in range(self.dp)]
        plan = self.faults if self.faults is not None else faults_lib.get_plan()
        if plan is not None:
            out["faults"] = plan.report()
        return out

    # ------------------------------------------------------------------
    # prefill
    # ------------------------------------------------------------------

    def _tokens(self, toks) -> torch.Tensor:
        return torch.as_tensor(np.asarray(toks, np.int64), device=self.device)

    @staticmethod
    def _argmax(logits: torch.Tensor) -> int:
        """The greedy first token of a prefill's last-token logits."""
        return int(np.argmax(logits.float().cpu().numpy()))

    def _start_request(self, req: Request, b: int, first: int) -> None:
        """Go live after the prompt state is in slot ``b`` — or retire at
        admission when the prefill-sampled first token meets the budget."""
        now = time.perf_counter()
        req.out_tokens.append(first)
        req.first_token_at = now
        hit_eos = self.eos_id is not None and first == self.eos_id
        if len(req.out_tokens) >= req.max_new_tokens or hit_eos:
            self._retire(req, now, "eos" if hit_eos else "max_tokens")
            return
        self.slot_req[b] = req
        self.live[b] = True
        self.pos[b] = len(req.prompt)
        self.cur_tokens[b] = first

    def _run_prefill(self, fn, *args):
        """One prefill call, with the host round-trips its kernels make
        (counted on this thread) added to ``prefill_kernel_syncs``."""
        syncs = _build.host_syncs()
        with self._model_ctx():
            logits, caches = fn(self.params, self.cfg, *args)
            logits = tp_lib.join_vocab(logits, self.cfg.vocab)
        self._m_kernel_syncs.inc(_build.host_syncs() - syncs)
        return logits, caches

    def _cache_boundary(self, job: _PrefillJob, nbytes: int) -> None:
        """Checkpoint the job's current state into its shard's prefix cache.
        Only chunk-grid-aligned boundaries are resumable (a resumed scan then
        runs the same chunk shapes as a cold run); every boundary carries
        its last-token logits, which serve a full hit at the prompt's end.
        A rank that does not own the slot stores a placeholder of
        ``nbytes``."""
        pc = self._pc(self._shard_of(job.slot))
        if pc is None or job.pos == 0:
            return
        aligned = self.prefill_chunk > 0 and job.pos % self.prefill_chunk == 0
        if self._owns(job.slot):
            pc.insert(job.req.prompt[: job.pos], self._slice_prefix(job.caches, job.pos),
                      logits=job.logits[0], resumable=aligned)
        else:
            pc.insert(job.req.prompt[: job.pos], None, logits=REMOTE, resumable=aligned,
                      nbytes=nbytes)

    def _slice_prefix(self, caches: PyTree, p: int) -> PyTree:
        """Full-attention KV leaves (and MLA's latents) trimmed to their
        first ``p`` positions along their sequence axis (:data:`CACHE_AXES`),
        so a stored checkpoint costs O(prefix), not O(max_seq); sliding-window rings
        shorter than ``max_seq``, recurrent carries and Mamba-1 and Mamba-2
        states (``h``, ``conv``) are stored whole."""

        def walk(tree, seq_axis, name):
            if isinstance(tree, dict):
                return {k: walk(v, seq_axis, k) for k, v in tree.items()}
            if name in _SEQ_LEAVES and tree.dim() > seq_axis and tree.shape[seq_axis] == self.S:
                return tree.narrow(seq_axis, 0, p)
            return tree

        return {top: walk(sub, CACHE_AXES[top][1], top) for top, sub in caches.items()}

    def _inflate_entry(self, entry) -> PyTree:
        """A stored checkpoint re-expanded into a fresh B=1, ``max_seq``
        cache (a copy: the stored tensors are only read)."""
        with self._model_ctx():
            fresh = lm.init_cache(self.cfg, 1, self.S, self.device)
        return splice_cache(fresh, entry.caches, 0, self.S)

    def _admit(self) -> None:
        """Fill free slots from the scheduler.  Admission is a prefix-cache
        lookup first: a full hit splices the stored state (0 recomputed
        prompt steps); a partial hit resumes chunked prefill mid-prompt; a
        miss starts a prefill job (chunked) or runs the one-shot B=1 prefill
        and SPLICES its state into the slot (other slots are untouched).
        Under a plan the request is placed on a shard first (:meth:`_place`)
        and uses that shard's prefix cache; in the sharded layout the
        prefill runs on the slot's owner only."""
        while True:
            if self._free_slot() is None:
                return
            req = self.scheduler.next_request()
            if req is None:
                return
            if req.max_new_tokens <= 0:
                # budget already met: retire before spending any device work
                self._retire(req, time.perf_counter(), "max_tokens")
                continue
            if self.plan is None:
                shard, b = 0, self._free_slot()
            else:
                shard = self._place(req)
                b = self._free_slot(shard=shard)
                self.scheduler.record_placement(req, shard)
            owner = self._owns(b)
            plen = len(req.prompt)
            pc = self._pc(shard)
            entry = None
            if pc is not None:
                candidates = pc.lookup(req.prompt)
                full = next((e for e in candidates
                             if e.length == plen and e.logits is not None), None)
                if full is not None:
                    self._splice(full.caches, b)
                    spec = self._fire("prefix.splice")
                    if spec is not None:
                        # a corrupted checkpoint splice: caught downstream by
                        # the per-slot non-finite detection, not here
                        self._poison_slot(b, spec.mode)
                    req.prefix_hit_tokens = plen
                    pc.record_hit(plen, full=True)
                    first, = self._from_owner(b, self._argmax(full.logits) if owner else 0)
                    self._start_request(req, b, first)
                    continue
                if self.prefill_chunk > 0:
                    entry = next((e for e in candidates if e.resumable), None)
            if self.prefill_chunk > 0:
                # adaptive uncontended admission: with no live slot to stall
                # and no resumable state to splice, a chunk job only adds
                # work, so the prompt takes the one-shot path
                adaptive_oneshot = (self.prefill_adaptive and entry is None
                                    and self._tick_uncontended and not self._jobs)
                if not adaptive_oneshot:
                    caches = None
                    if owner:
                        if entry is not None:
                            caches = self._inflate_entry(entry)
                        else:
                            with self._model_ctx():
                                caches = lm.init_cache(self.cfg, 1, self.S, self.device)
                    start = entry.length if entry is not None else 0
                    if pc is not None:
                        if entry is not None:
                            req.prefix_hit_tokens = start
                            pc.record_hit(start, full=False)
                        else:
                            pc.record_miss()
                    self.reserved[b] = True
                    self._jobs.append(_PrefillJob(req=req, slot=b, caches=caches, pos=start))
                    continue
            # one-shot prefill
            if pc is not None:
                pc.record_miss()
            first = nbytes = 0
            if owner:
                with self._tr.span("prefill_oneshot", cat="prefill",
                                   args={"uid": req.uid, "tokens": plen}):
                    logits, pcaches = self._run_prefill(lm.prefill, self._tokens([req.prompt]))
                first = self._argmax(logits[0])
                if pc is not None and self._rows is not None:
                    nbytes = entry_bytes(pcaches, logits[0])
            first, nbytes = self._from_owner(b, first, nbytes)
            self._m_prompt_steps.inc(plen)
            self._tick_prompt_steps += plen
            if owner:
                self._splice(pcaches, b)
                if pc is not None:
                    pc.insert(req.prompt, pcaches, logits=logits[0], resumable=False)
            elif pc is not None:
                pc.insert(req.prompt, None, logits=REMOTE, resumable=False, nbytes=nbytes)
            self._start_request(req, b, first)

    def _advance_prefill(self) -> None:
        """Advance at most ``prefill_chunks_per_tick`` chunks, round-robin
        over in-flight jobs: per-tick prompt work stays bounded by the chunk
        size regardless of prompt length.  With ``prefill_adaptive`` a tick
        with no live slot drains every pending job whole instead.  In the
        sharded layout a chunk runs on its slot's owner, and every rank
        advances the job's position."""
        drain = bool(self.prefill_adaptive and self._jobs and self._tick_uncontended)
        budget = len(self._jobs) if drain else self.prefill_chunks_per_tick
        for _ in range(budget):
            if not self._jobs:
                return
            self._job_rr %= len(self._jobs)
            job = self._jobs[self._job_rr]
            owner = self._owns(job.slot)
            plen = len(job.req.prompt)
            c = plen - job.pos if drain else min(self.prefill_chunk, plen - job.pos)
            if owner:
                with self._tr.span("prefill_chunk", cat="prefill",
                                   args={"uid": job.req.uid, "pos": job.pos, "chunk": c}):
                    job.logits, job.caches = self._run_prefill(
                        lm.prefill_chunk,
                        self._tokens([job.req.prompt[job.pos:job.pos + c]]),
                        job.caches, job.pos)
            job.pos += c
            self._m_prompt_steps.inc(c)
            self._tick_prompt_steps += c
            self._m_chunks.inc()
            done = job.pos >= plen
            pc = self._pc(self._shard_of(job.slot))
            first = nbytes = 0
            if owner:
                first = self._argmax(job.logits[0]) if done else 0
                if pc is not None and self._rows is not None:
                    nbytes = entry_bytes(self._slice_prefix(job.caches, job.pos),
                                         job.logits[0])
            if done or pc is not None:
                first, nbytes = self._from_owner(job.slot, first, nbytes)
            self._cache_boundary(job, nbytes)
            if done:
                self._jobs.remove(job)
                self._splice(job.caches, job.slot)
                self.reserved[job.slot] = False
                self._start_request(job.req, job.slot, first)
            else:
                self._job_rr += 1

    def _begin_tick(self) -> None:
        self._tick_prompt_steps = 0
        spec = self._fire("tick.slow")
        if spec is not None and spec.delay_s > 0:
            time.sleep(spec.delay_s)
        # scrub quarantined slots and reap expired requests BEFORE admission
        # — freed slots are reused this same tick
        self._scrub_quarantined()
        self._reap_deadlines(time.perf_counter())
        # contention is a tick-level property, captured before admissions
        self._tick_uncontended = not self.live.any()
        self._admit()
        self._advance_prefill()
        self._admit()   # full-hit admissions may free the tick for decode
        self._m_tick_max.set_max(self._tick_prompt_steps)
        if not self._tick_uncontended:
            self._m_tick_contended.set_max(self._tick_prompt_steps)
        self._m_live.set(int(self.live.sum()))
        if self.plan is not None and self._tr.enabled:
            for s in range(self.dp):
                self._tr.counter(
                    "live_slots",
                    {"live": sum(int(self.live[b]) for b in self.plan.slots_of_shard(s, self.B))},
                    tid=10_000 + s)

    # ------------------------------------------------------------------
    # decode drivers
    # ------------------------------------------------------------------

    @torch.no_grad()
    def step(self) -> int:
        """One batched decode tick for all live slots.  Returns #live."""
        self._begin_tick()
        if not self.live.any():
            return 0
        spec = self._fire("decode.nan_carry")
        if spec is not None:
            b = self._fault_slot(spec)
            if b is not None:
                self._poison_slot(b, spec.mode)
        rows = slice(None) if self._rows is None else slice(self._rows.start, self._rows.stop)
        with self._tr.span("decode_step", cat="decode",
                           args={"live": int(self.live.sum())}):
            if self._dispatch_fault():
                return int(self.live.sum())
            with self._model_ctx():
                logits, self.caches = lm.decode_step(
                    self.params, self.cfg, self._tokens(self.cur_tokens[rows, None]),
                    self.caches, self._tokens(self.pos[rows]))
                logits = tp_lib.join_vocab(logits, self.cfg.vocab)
            with self._tr.span("device_sync", cat="sync"):
                logits = logits.float().cpu().numpy()
        self._m_syncs.inc()
        self.pos += self.live.astype(np.int32)
        now = time.perf_counter()
        spec = self._fire("decode.nan_logits")
        if spec is not None:
            b = self._fault_slot(spec)
            if b is not None and self._owns(b):
                logits[self._lb(b)] = np.nan if spec.mode == "nan" else np.inf
        # per-slot non-finite detection (an injected poison or a real one)
        # quarantines ONLY the affected slot
        finite = np.isfinite(logits).all(axis=-1)
        toks = None
        if self._rows is not None:
            # each rank picks its own slots' tokens; one all_gather gives
            # every rank every slot's token and finite flag
            mine = np.zeros((2, len(self._rows)), np.int64)
            for j, b in enumerate(self._rows):
                if self.live[b] and finite[j]:
                    mine[0, j] = self._next_token(b, logits[j])
            mine[1] = finite
            toks, finite = self._gather_slots(mine)
            finite = finite.astype(bool)
        for b in range(self.B):
            if not self.live[b]:
                continue
            if not finite[b]:
                self._quarantine(b, now)
                continue
            req = self.slot_req[b]
            nxt = self._next_token(b, logits[b]) if toks is None else int(toks[b])
            if req.temperature > 0:
                # the sampled id's int() is its own host↔device round-trip —
                # count it (in the sharded layout on every rank: the counters
                # are host state)
                self._m_syncs.inc()
            req.out_tokens.append(nxt)
            self._m_tokens.inc()
            if self._m_tokens_shard is not None:
                self._m_tokens_shard[self._shard_of(b)].inc()
            if req.first_token_at is None:
                req.first_token_at = now
            self.cur_tokens[b] = nxt
            full = len(req.out_tokens) >= req.max_new_tokens
            hit_eos = self.eos_id is not None and nxt == self.eos_id
            oom = self.pos[b] >= self.S - 1
            if full or hit_eos or oom:
                self._retire(req, now,
                             "eos" if hit_eos else
                             ("max_tokens" if full else "out_of_cache"))
                self.live[b] = False
                self.slot_req[b] = None
        return int(self.live.sum())

    def _next_token(self, b: int, logits_b: np.ndarray) -> int:
        """Slot ``b``'s next token from its host logits: greedy argmax, or
        a draw from the server's generator at the request's temperature."""
        req = self.slot_req[b]
        if req.temperature > 0:
            probs = torch.softmax(
                torch.as_tensor(logits_b, device=self.device) / req.temperature, -1)
            return int(torch.multinomial(probs, 1, generator=self._gen))
        return int(np.argmax(logits_b))

    def _decode_block(self, k: int, temps: np.ndarray, remaining: np.ndarray, rows: slice):
        """K decode steps with sampling and retirement decided on the device,
        for the slots ``rows`` that this process holds.  The carry is the
        server's device state (caches, cur, pos, live, remaining); returns
        the caches and ONE host array holding the [K, 4, B] block (token,
        emitted, done, finite) followed by the final cur/pos/live rows."""
        dev, S = self.device, self.S
        eos = -1 if self.eos_id is None else self.eos_id
        caches = self.caches
        cur = self._tokens(self.cur_tokens[rows])
        pos = self._tokens(self.pos[rows])
        live = torch.as_tensor(self.live[rows], device=dev)
        left = self._tokens(remaining)
        temps_t = torch.as_tensor(temps, device=dev)
        sampling = bool((temps > 0).any())
        outs = []
        for _ in range(k):
            with self._model_ctx():
                logits, caches = lm.decode_step(self.params, self.cfg, cur[:, None], caches, pos)
                logits = tp_lib.join_vocab(logits, self.cfg.vocab)
            logits = logits.float()
            pos = pos + live.long()
            finite = torch.isfinite(logits).all(dim=-1)
            nxt = torch.argmax(logits, dim=-1)
            if sampling:
                scaled = logits / temps_t.clamp_min(1e-6)[:, None]
                scaled = torch.where(finite[:, None], scaled, torch.zeros_like(scaled))
                sampled = torch.multinomial(torch.softmax(scaled, -1), 1,
                                            generator=self._gen)[:, 0]
                nxt = torch.where(temps_t > 0, sampled, nxt)
            nxt = torch.where(live, nxt, cur)          # dead slots idle
            emitted = live
            left = left - live.long()
            done_now = live & ((left <= 0) | (nxt == eos) | (pos >= S - 1))
            live = live & ~done_now
            cur = nxt
            outs.append(torch.stack([nxt, emitted.long(), done_now.long(), finite.long()]))
        block = torch.stack(outs).reshape(4 * k, -1)
        tail = torch.stack([cur, pos, live.long()])
        return caches, torch.cat([block, tail])

    @torch.no_grad()
    def step_block(self) -> int:
        """``block_k`` decode ticks with one host sync; returns #live after.

        Timestamps (first_token_at / done_at) are stamped at the block
        boundary, so per-request latency is quantized up to K-1 device ticks
        coarser than the per-token driver reports.
        """
        self._begin_tick()
        if not self.live.any():
            return 0
        spec = self._fire("decode.nan_carry") or self._fire("decode.nan_logits")
        if spec is not None:
            # the block samples on the device, so both poison points inject
            # into the carry; the in-block finite check catches it
            b = self._fault_slot(spec)
            if b is not None:
                self._poison_slot(b, spec.mode)
        k = self.block_k
        temps = np.array([r.temperature if r is not None else 0.0
                          for r in self.slot_req], np.float32)
        remaining = np.array([r.max_new_tokens - len(r.out_tokens) if r is not None else 0
                              for r in self.slot_req], np.int64)
        rows = slice(None) if self._rows is None else slice(self._rows.start, self._rows.stop)
        with self._tr.span("decode_block", cat="decode",
                           args={"live": int(self.live.sum()), "k": k}):
            if self._dispatch_fault():
                return int(self.live.sum())
            self.caches, packed = self._decode_block(k, temps[rows], remaining[rows], rows)
            # ONE sync: the K×B block plus the carry vectors to the host
            with self._tr.span("device_sync", cat="sync"):
                host = packed.cpu().numpy()
        if self._rows is not None:
            # the sharded layout's one exchange: every rank's block rows
            host = self._gather_slots(host)
        self._m_syncs.inc()
        blk = host[: 4 * k].reshape(k, 4, self.B)
        toks = blk[:, 0]
        emitted, done_now, finite = (blk[:, i].astype(bool) for i in (1, 2, 3))
        self.cur_tokens = host[4 * k].astype(np.int32)
        self.pos = host[4 * k + 1].astype(np.int32)
        self.live = host[4 * k + 2].astype(bool)
        now = time.perf_counter()
        # quarantine pass: a slot that went non-finite at inner tick t
        # produced garbage from t on — drop those emissions and retire it
        quarantine: list[int] = []
        for b in range(self.B):
            bad = emitted[:, b] & ~finite[:, b]
            if bad.any():
                tb = int(np.argmax(bad))
                emitted[tb:, b] = False
                done_now[tb:, b] = False
                quarantine.append(b)
        for t in range(k):
            for b in range(self.B):
                if not emitted[t, b]:
                    continue
                req = self.slot_req[b]
                nxt = int(toks[t, b])
                req.out_tokens.append(nxt)
                self._m_tokens.inc()
                if self._m_tokens_shard is not None:
                    self._m_tokens_shard[self._shard_of(b)].inc()
                if req.first_token_at is None:
                    req.first_token_at = now
                if done_now[t, b]:
                    reason = ("eos" if (self.eos_id is not None and nxt == self.eos_id) else
                              ("max_tokens" if len(req.out_tokens) >= req.max_new_tokens
                               else "out_of_cache"))
                    self._retire(req, now, reason)
                    self.slot_req[b] = None
        for b in quarantine:
            self._quarantine(b, now)
        return int(self.live.sum())

    # ------------------------------------------------------------------
    def tick(self) -> bool:
        """One scheduling quantum (prefill chunks + decode) and the watchdog
        check; True while the server has work in flight."""
        if self.persistent:
            self.step_block()
        else:
            self.step()
        self._watchdog_check()
        return bool(self.live.any() or self._jobs or len(self.scheduler))

    def stats(self, reset: bool = False) -> dict:
        """Serving telemetry, a view over the server's metrics registry:
        decode host round-trips per generated token, prefill boundedness,
        prefix-cache hits, scheduler, request-latency summaries.  ``reset=True`` zeroes the
        counters after building the dict."""
        toks = max(self.decoded_tokens, 1)
        out = {
            "decode_syncs": self.decode_syncs,
            "decoded_tokens": self.decoded_tokens,
            "syncs_per_token": self.decode_syncs / toks,
            "prefill": {
                "prompt_steps_computed": self.prompt_steps_computed,
                "chunks_run": self.prefill_chunks_run,
                "chunk_size": self.prefill_chunk,
                "adaptive": self.prefill_adaptive,
                "max_prompt_steps_per_tick": self.max_prompt_steps_per_tick,
                "max_prompt_steps_contended_tick": self.max_prompt_steps_contended_tick,
            },
            "latency": {
                "ttft_ms": self._h_ttft.summary(),
                "tpot_ms": self._h_tpot.summary(),
                "queue_wait_ms": self._h_queue.summary(),
            },
            "scheduler": self.scheduler.telemetry(),
            "health": self.health(),
        }
        if self.plan is not None:
            out["mesh"] = dict(
                self.plan.describe(),
                slots_per_shard=self._slots_per_shard,
                live_by_shard=[sum(int(self.live[b]) for b in self.plan.slots_of_shard(s, self.B))
                               for s in range(self.dp)],
                decoded_tokens_by_shard=[int(c.value) for c in self._m_tokens_shard],
            )
        if self.prefix_caches:
            if self.plan is None:
                out["prefix_cache"] = self.prefix_cache.telemetry()
            else:
                per = [c.telemetry() for c in self.prefix_caches]
                agg = {k: sum(p[k] for p in per)
                       for k in ("hits", "partial_hits", "misses", "insertions", "evictions",
                                 "prompt_steps_saved", "bytes_in_use", "budget_bytes",
                                 "entries")}
                agg["per_shard"] = per
                out["prefix_cache"] = agg
        if reset:
            self.reset_stats()
        return out

    def reset_stats(self) -> None:
        """Zero every counter of the server's scope; stored prefix-cache
        checkpoints and queued requests are untouched."""
        self.obs.metrics.reset()
        self.scheduler.reset_stats()
        for pc in self.prefix_caches or ():
            pc.reset_stats()

    def host_state(self) -> dict:
        """The host-side state that every rank of a sharded server holds
        alike: the slot map, positions, live/reserved/quarantine flags and
        current tokens, the queue, the prefill jobs, the retired requests,
        every shard's prefix-cache tree (prefixes, flags, byte counts, LRU
        clocks) and the counters.  Wall-clock readings (latencies, waits)
        and the kernels' own host syncs, which differ by rank, are left
        out."""

        def tree(pc):
            out = []

            def walk(node, prefix):
                if node.entry is not None:
                    e = node.entry
                    out.append((prefix, e.length, e.resumable, e.nbytes, e.last_used))
                for first in sorted(node.children):
                    child = node.children[first]
                    walk(child, prefix + child.edge)

            walk(pc.root, ())
            return out, pc.bytes_in_use, pc._clock

        snap = self.obs.metrics.snapshot()
        return {
            "slots": [None if r is None else r.uid for r in self.slot_req],
            "pos": self.pos.tolist(), "live": self.live.tolist(),
            "reserved": self.reserved.tolist(), "quarantined": self.quarantined.tolist(),
            "cur_tokens": self.cur_tokens.tolist(),
            "queued": sorted(r.uid for q in self.scheduler._queues.values() for r in q),
            "jobs": [(j.req.uid, j.slot, j.pos) for j in self._jobs],
            "completed": [(r.uid, list(r.out_tokens), r.finish_reason, r.shard,
                           r.prefix_hit_tokens) for r in self.completed],
            "prefix_caches": [tree(pc) for pc in self.prefix_caches or ()],
            "counters": {k: v for k, v in snap["counters"].items()
                         if not k.startswith("prefill_kernel_syncs")},
            "gauges": {k: v for k, v in snap["gauges"].items()
                       if not k.startswith("sched_max_wait_s")},
        }

    def run_until_drained(self, max_ticks: int = 10_000,
                          persistent: bool | None = None) -> list[Request]:
        use_block = self.persistent if persistent is None else persistent
        step = self.step_block if use_block else self.step
        ticks = 0
        while (len(self.scheduler) or self._jobs or self.live.any()) and ticks < max_ticks:
            step()
            self._watchdog_check()
            ticks += 1
        return self.completed


__all__ = ["DEFAULT_BLOCK_K", "DecodeServer", "Request", "ShardPlan", "scheduler_config",
           "splice_cache"]
