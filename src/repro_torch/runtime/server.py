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
``ssm_scan`` or ``flash_attention``); chunks run ``lstm_seq`` and
``ssm_scan`` too, while attention chunks attend over the cache in plain
PyTorch, as the reference's do.

The radix prefix cache (``prefix_cache_bytes``) stores chunk-boundary and
prompt-end states on the server's device: a full hit splices the stored
state (0 recomputed prompt steps), a partial hit resumes chunked prefill
from the deepest chunk-aligned boundary.  Fault points (``faults`` or the
ambient plan of ``runtime.faults``) and the stall watchdog (``watchdog_s``)
follow the reference: an injected NaN quarantines only its slot, a
transient dispatch fault retries the tick, a stall aborts in-flight work
with ``error:stalled``.  A real failure of a kernel is never caught.

Counters, spans, ``stats()`` and ``health()`` keys keep the reference's
names.  Not ported yet, and refused by the constructor: mesh placement
(``plan``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch import obs as obs_lib
from repro_torch._tree import tree_leaves
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig

from . import faults as faults_lib
from .faults import Watchdog
from .prefix_cache import PrefixCache
from .scheduler import REJECT_DUPLICATE_UID, Scheduler, SchedulerConfig

PyTree = Any

DEFAULT_BLOCK_K = 8


_SEQ_LEAVES = ("k", "v")     # the full-attention KV leaves (MLA's are not ported)


def splice_cache(caches: PyTree, prefill_caches: PyTree, b: int) -> PyTree:
    """Insert a B=1 prefill state into batch slot ``b`` of the server cache.

    A recurrent carry (``h``/``c`` of ``[G, 1, H]`` → row ``b`` of
    ``[G, B, H]``) and a Mamba-1 state (``h [G, 1, DI, N]``, ``conv
    [G, 1, k-1, DI]``) have no sequence axis, so admission is a pure
    batch-row write and never disturbs other slots.  A full-attention KV
    leaf carries one: a one-shot prefill's ``[G, 1, L, KV, hd]`` goes
    left-aligned into ``[G, B, S_max, KV, hd]`` (positions ``0 .. L-1`` of
    row ``b``); a chunked prefill's ``max_seq``-long B=1 cache is a batch
    row like the others.  A source longer than the destination raises:
    wrapping a full cache would overwrite early positions with late ones
    while the causal mask still exposes every position.  Sliding-window
    ring buffers, the only caches that may wrap, are not ported yet (gemma3,
    ROADMAP.md Queue 1 item 8).  The destination tensors are updated in
    place; the returned tree holds the same tensors.
    """

    def one(name, dst, src):
        if src.ndim >= 3 and dst.ndim == src.ndim and src.shape[2] != dst.shape[2] \
                and name in _SEQ_LEAVES:
            # sequence-bearing cache: [G, 1, L, ...] -> [G, B, S_dst, ...]
            L, S_dst = src.shape[2], dst.shape[2]
            if L > S_dst:
                raise ValueError(
                    f"splice_cache: prompt of length {L} overflows the full-attention "
                    f"cache leaf '{name}' (S_max={S_dst}); admission must reject or "
                    "truncate it (ring-buffer wrap for sliding windows is not ported: "
                    "ROADMAP.md Queue 1 item 8)")
            dst[:, b, :L] = src[:, 0].to(dst.dtype)
            return dst
        if src.ndim == dst.ndim and src.shape[1] == 1 and src.shape[2:] == dst.shape[2:]:
            dst[:, b] = src[:, 0].to(dst.dtype)
            return dst
        raise NotImplementedError(
            f"splice_cache: source {tuple(src.shape)} → destination "
            f"{tuple(dst.shape)} of leaf '{name}' is neither a batch-row state "
            "nor a left-aligned KV prefix")

    def walk(dst, src, name=""):
        if isinstance(dst, dict):
            return {key: walk(dst[key], src[key], key) for key in dst}
        return one(name, dst, src)

    return walk(caches, prefill_caches)


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


@dataclasses.dataclass
class _PrefillJob:
    """A resumable prompt scan bound to a reserved slot."""

    req: Request
    slot: int
    caches: PyTree            # B=1 decode-layout state
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
                 plan: Any = None,
                 device: str | torch.device | None = None):
        if plan is not None:
            raise NotImplementedError(
                "DecodeServer(plan): mesh placement is not ported to repro_torch yet "
                "(ROADMAP.md, Queue 1: Multi-device and launchers)")
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
        self.prefix_cache = (PrefixCache(prefix_cache_bytes, metrics=self.obs.metrics)
                             if prefix_cache_bytes else None)
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
        self.caches = lm.init_cache(cfg, num_slots, max_seq, self.device)
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

    def _free_slot(self) -> int | None:
        for b in range(self.B):
            if not self.live[b] and not self.reserved[b] and not self.quarantined[b]:
                return b
        return None

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
        tr.complete("request", t_sub, t_done - t_sub, cat="request", tid=tid,
                    args={"uid": req.uid, "prompt_tokens": len(req.prompt),
                          "out_tokens": n_out, "finish_reason": req.finish_reason,
                          "prefix_hit_tokens": req.prefix_hit_tokens})
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
        """Cache leaves whose axis 1 is the slot axis."""
        return [leaf for leaf in tree_leaves(self.caches)
                if leaf.dim() >= 2 and leaf.shape[1] == self.B
                and (leaf.is_floating_point() or not floating)]

    def _poison_slot(self, b: int, mode: str = "nan") -> None:
        """Write NaN/Inf into slot ``b``'s float cache rows, in place: the
        injected effect of the carry and splice fault points.  Other slots'
        rows are untouched, so survivors stay bit-identical."""
        bad = float("nan") if mode == "nan" else float("inf")
        for leaf in self._slot_leaves(floating=True):
            leaf[:, b] = bad

    def _scrub_slot(self, b: int) -> None:
        """Zero slot ``b``'s cache rows: quarantined state never leaks into
        the next request admitted to the slot."""
        for leaf in self._slot_leaves():
            leaf[:, b] = 0

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
        plan = self.faults if self.faults is not None else faults_lib.get_plan()
        if plan is not None:
            out["faults"] = plan.report()
        return out

    # ------------------------------------------------------------------
    # prefill
    # ------------------------------------------------------------------

    def _tokens(self, toks) -> torch.Tensor:
        return torch.as_tensor(np.asarray(toks, np.int64), device=self.device)

    def _start_request(self, req: Request, b: int, first_logits: np.ndarray) -> None:
        """Go live after the prompt state is in slot ``b`` — or retire at
        admission when the prefill-sampled first token meets the budget."""
        first = int(np.argmax(first_logits))
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
        out = fn(self.params, self.cfg, *args)
        self._m_kernel_syncs.inc(_build.host_syncs() - syncs)
        return out

    def _cache_boundary(self, job: _PrefillJob) -> None:
        """Checkpoint the job's current state into the prefix cache.  Only
        chunk-grid-aligned boundaries are resumable (a resumed scan then runs
        the same chunk shapes as a cold run); every boundary carries its
        last-token logits, which serve a full hit at the prompt's end."""
        pc = self.prefix_cache
        if pc is None or job.pos == 0:
            return
        aligned = self.prefill_chunk > 0 and job.pos % self.prefill_chunk == 0
        pc.insert(job.req.prompt[: job.pos], self._slice_prefix(job.caches, job.pos),
                  logits=job.logits[0] if job.logits is not None else None,
                  resumable=aligned)

    def _slice_prefix(self, caches: PyTree, p: int) -> PyTree:
        """Full-attention KV leaves trimmed to their first ``p`` positions,
        so a stored checkpoint costs O(prefix), not O(max_seq); recurrent
        and Mamba-1 states have no sequence axis and are stored whole."""

        def walk(tree, name=""):
            if isinstance(tree, dict):
                return {k: walk(v, k) for k, v in tree.items()}
            if tree.dim() >= 3 and name in _SEQ_LEAVES and tree.shape[2] == self.S:
                return tree[:, :, :p]
            return tree

        return walk(caches)

    def _inflate_entry(self, entry) -> PyTree:
        """A stored checkpoint re-expanded into a fresh B=1, ``max_seq``
        cache (a copy: the stored tensors are only read)."""
        return splice_cache(lm.init_cache(self.cfg, 1, self.S, self.device), entry.caches, 0)

    def _admit(self) -> None:
        """Fill free slots from the scheduler.  Admission is a prefix-cache
        lookup first: a full hit splices the stored state (0 recomputed
        prompt steps); a partial hit resumes chunked prefill mid-prompt; a
        miss starts a prefill job (chunked) or runs the one-shot B=1 prefill
        and SPLICES its state into the slot (other slots are untouched)."""
        while True:
            b = self._free_slot()
            if b is None:
                return
            req = self.scheduler.next_request()
            if req is None:
                return
            if req.max_new_tokens <= 0:
                # budget already met: retire before spending any device work
                self._retire(req, time.perf_counter(), "max_tokens")
                continue
            plen = len(req.prompt)
            pc = self.prefix_cache
            entry = None
            if pc is not None:
                candidates = pc.lookup(req.prompt)
                full = next((e for e in candidates
                             if e.length == plen and e.logits is not None), None)
                if full is not None:
                    self.caches = splice_cache(self.caches, full.caches, b)
                    spec = self._fire("prefix.splice")
                    if spec is not None:
                        # a corrupted checkpoint splice: caught downstream by
                        # the per-slot non-finite detection, not here
                        self._poison_slot(b, spec.mode)
                    req.prefix_hit_tokens = plen
                    pc.record_hit(plen, full=True)
                    self._start_request(req, b, full.logits.float().cpu().numpy())
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
                    caches = (self._inflate_entry(entry) if entry is not None
                              else lm.init_cache(self.cfg, 1, self.S, self.device))
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
            with self._tr.span("prefill_oneshot", cat="prefill",
                               args={"uid": req.uid, "tokens": plen}):
                logits, pcaches = self._run_prefill(lm.prefill, self._tokens([req.prompt]))
            self._m_prompt_steps.inc(plen)
            self._tick_prompt_steps += plen
            self.caches = splice_cache(self.caches, pcaches, b)
            if pc is not None:
                pc.insert(req.prompt, pcaches, logits=logits[0], resumable=False)
            self._start_request(req, b, logits[0].float().cpu().numpy())

    def _advance_prefill(self) -> None:
        """Advance at most ``prefill_chunks_per_tick`` chunks, round-robin
        over in-flight jobs: per-tick prompt work stays bounded by the chunk
        size regardless of prompt length.  With ``prefill_adaptive`` a tick
        with no live slot drains every pending job whole instead."""
        drain = bool(self.prefill_adaptive and self._jobs and self._tick_uncontended)
        budget = len(self._jobs) if drain else self.prefill_chunks_per_tick
        for _ in range(budget):
            if not self._jobs:
                return
            self._job_rr %= len(self._jobs)
            job = self._jobs[self._job_rr]
            plen = len(job.req.prompt)
            c = plen - job.pos if drain else min(self.prefill_chunk, plen - job.pos)
            with self._tr.span("prefill_chunk", cat="prefill",
                               args={"uid": job.req.uid, "pos": job.pos, "chunk": c}):
                job.logits, job.caches = self._run_prefill(
                    lm.prefill_chunk, self._tokens([job.req.prompt[job.pos:job.pos + c]]),
                    job.caches, job.pos)
            job.pos += c
            self._m_prompt_steps.inc(c)
            self._tick_prompt_steps += c
            self._m_chunks.inc()
            self._cache_boundary(job)
            if job.pos >= plen:
                self._jobs.remove(job)
                self.caches = splice_cache(self.caches, job.caches, job.slot)
                self.reserved[job.slot] = False
                self._start_request(job.req, job.slot, job.logits[0].float().cpu().numpy())
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
        with self._tr.span("decode_step", cat="decode",
                           args={"live": int(self.live.sum())}):
            if self._dispatch_fault():
                return int(self.live.sum())
            logits, self.caches = lm.decode_step(
                self.params, self.cfg, self._tokens(self.cur_tokens[:, None]),
                self.caches, self._tokens(self.pos))
            with self._tr.span("device_sync", cat="sync"):
                logits = logits.float().cpu().numpy()
        self._m_syncs.inc()
        self.pos += self.live.astype(np.int32)
        now = time.perf_counter()
        spec = self._fire("decode.nan_logits")
        if spec is not None:
            b = self._fault_slot(spec)
            if b is not None:
                logits[b] = np.nan if spec.mode == "nan" else np.inf
        # per-slot non-finite detection (an injected poison or a real one)
        # quarantines ONLY the affected slot
        finite = np.isfinite(logits).all(axis=-1)
        for b in range(self.B):
            if not self.live[b]:
                continue
            if not finite[b]:
                self._quarantine(b, now)
                continue
            req = self.slot_req[b]
            if req.temperature > 0:
                probs = torch.softmax(
                    torch.as_tensor(logits[b], device=self.device) / req.temperature, -1)
                nxt = int(torch.multinomial(probs, 1, generator=self._gen))
                # the int() is its own host↔device round-trip — count it
                self._m_syncs.inc()
            else:
                nxt = int(np.argmax(logits[b]))
            req.out_tokens.append(nxt)
            self._m_tokens.inc()
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

    def _decode_block(self, k: int, temps: np.ndarray, remaining: np.ndarray):
        """K decode steps with sampling and retirement decided on the device.
        The carry is the server's device state (caches, cur, pos, live,
        remaining); returns the caches and ONE host array holding the
        [K, 4, B] block (token, emitted, done, finite) followed by the final
        cur/pos/live rows."""
        dev, S = self.device, self.S
        eos = -1 if self.eos_id is None else self.eos_id
        caches = self.caches
        cur = self._tokens(self.cur_tokens)
        pos = self._tokens(self.pos)
        live = torch.as_tensor(self.live, device=dev)
        left = self._tokens(remaining)
        temps_t = torch.as_tensor(temps, device=dev)
        sampling = bool((temps > 0).any())
        outs = []
        for _ in range(k):
            logits, caches = lm.decode_step(self.params, self.cfg, cur[:, None], caches, pos)
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
        with self._tr.span("decode_block", cat="decode",
                           args={"live": int(self.live.sum()), "k": k}):
            if self._dispatch_fault():
                return int(self.live.sum())
            self.caches, packed = self._decode_block(k, temps, remaining)
            # ONE sync: the K×B block plus the carry vectors to the host
            with self._tr.span("device_sync", cat="sync"):
                host = packed.cpu().numpy()
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
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.telemetry()
        if reset:
            self.reset_stats()
        return out

    def reset_stats(self) -> None:
        """Zero every counter of the server's scope; stored prefix-cache
        checkpoints and queued requests are untouched."""
        self.obs.metrics.reset()
        self.scheduler.reset_stats()
        if self.prefix_cache is not None:
            self.prefix_cache.reset_stats()

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


__all__ = ["DEFAULT_BLOCK_K", "DecodeServer", "Request", "splice_cache"]
