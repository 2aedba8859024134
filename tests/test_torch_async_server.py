"""The port's ``AsyncServer`` against the reference's ``test_async_*``
behaviours, and per-server counting of kernel host round-trips.

``AsyncServer`` drives its ``DecodeServer`` from a background thread of its
own: concurrent ``generate()`` calls resolve with the tokens of a
synchronous drain (and of the reference's ``AsyncServer`` on the same
weights), cancelling an awaiting task cancels the request, an explicit
``cancel()`` resolves the awaiting call, a duplicate uid fails fast, and a
tick thread that dies fails every waiter.  Two servers on two threads each count
exactly their own ``prefill_kernel_syncs``.
"""

import asyncio
import threading

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.runtime import AsyncServer as JaxAsyncServer  # noqa: E402
from repro.runtime import server as jax_server  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.runtime import AsyncServer, DecodeServer, Request  # noqa: E402


@pytest.fixture(scope="module")
def smollm():
    jcfg = jax_configs.get_smoke_config("smollm-135m")
    p_j = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_smoke_config("smollm-135m")
    return jcfg, p_j, cfg, bridge.params_from_jax(jax.tree.map(np.asarray, p_j), cfg, "cpu")


def _requests(request_cls, vocab, n=4, max_new=4, seed=0):
    rng = np.random.default_rng(seed)
    return [request_cls(uid=i, prompt=[int(t) for t in rng.integers(1, vocab, 5)],
                        max_new_tokens=max_new) for i in range(n)]


def _server(smollm, **kw):
    _, _, cfg, p_pt = smollm
    return DecodeServer(cfg, p_pt, num_slots=kw.pop("slots", 2), max_seq=kw.pop("max_seq", 48),
                        device="cpu", **kw)


def test_concurrent_generate_matches_the_synchronous_drain_and_the_reference(smollm):
    jcfg, p_j, cfg, _ = smollm
    sync = _server(smollm)
    for r in _requests(Request, cfg.vocab):
        sync.submit(r)
    want = {r.uid: list(r.out_tokens) for r in sync.run_until_drained()}

    async def main(front, request_cls):
        reqs = _requests(request_cls, cfg.vocab)
        bad = request_cls(uid=77, prompt=[], max_new_tokens=4)
        return await asyncio.gather(*(front.generate(r) for r in reqs), front.generate(bad))

    front = AsyncServer(_server(smollm, prefill_chunk=2))
    results = asyncio.run(main(front, Request))
    front.close()
    ref = asyncio.run(main(JaxAsyncServer(jax_server.DecodeServer(
        jcfg, p_j, num_slots=2, max_seq=48, prefill_chunk=2)), jax_server.Request))
    by = {r.uid: (list(r.out_tokens), r.finish_reason) for r in results}
    assert by == {r.uid: (list(r.out_tokens), r.finish_reason) for r in ref}
    assert by.pop(77) == ([], "rejected:empty_prompt")
    assert {u: t for u, (t, _) in by.items()} == want


def test_cancel_and_await_cancellation(smollm):
    _, _, cfg, _ = smollm

    async def inner():
        front = AsyncServer(_server(smollm, max_seq=2048))
        victim = _requests(Request, cfg.vocab, 1, max_new=500)[0]
        task = asyncio.ensure_future(front.generate(victim))
        await asyncio.sleep(0.05)
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        assert victim.finish_reason == "cancelled"

        second = _requests(Request, cfg.vocab, 1, max_new=500, seed=2)[0]
        second.uid = 7
        task = asyncio.ensure_future(front.generate(second))
        await asyncio.sleep(0.05)
        assert front.cancel(7) is True
        out = await task
        assert out is second and out.finish_reason == "cancelled"
        assert front.cancel(12345) is False
        front.close()
        assert len(victim.out_tokens) < 500 and len(second.out_tokens) < 500

    asyncio.run(inner())


def test_duplicate_uid_fails_fast(smollm):
    _, _, cfg, _ = smollm

    async def inner():
        front = AsyncServer(_server(smollm))
        first = _requests(Request, cfg.vocab, 1)[0]
        task = asyncio.ensure_future(front.generate(first))
        await asyncio.sleep(0)
        dup = _requests(Request, cfg.vocab, 1, seed=5)[0]
        out = await front.generate(dup)
        assert out is dup and out.finish_reason == "rejected:duplicate_uid"
        assert out.submitted_at is not None and out.retired_at is not None
        done = await task
        assert done is first and done.finish_reason == "max_tokens"
        assert int(front.server.obs.metrics.value("requests_completed", reason="rejected")) == 1
        front.close()

    asyncio.run(inner())


def test_a_dead_tick_thread_fails_every_waiter(smollm, monkeypatch):
    _, _, cfg, _ = smollm
    srv = _server(smollm)
    monkeypatch.setattr(srv, "tick", lambda: (_ for _ in ()).throw(RuntimeError("card lost")))

    async def inner():
        front = AsyncServer(srv)
        reqs = _requests(Request, cfg.vocab, 2)
        results = await asyncio.gather(*(front.generate(r) for r in reqs),
                                       return_exceptions=True)
        front.close()
        return results

    results = asyncio.run(inner())
    assert all(isinstance(r, RuntimeError) and "card lost" in str(r) for r in results)


def test_ticks_run_on_the_tick_thread(smollm, monkeypatch):
    _, _, cfg, _ = smollm
    srv = _server(smollm)
    seen = set()
    real = srv.tick

    def tick():
        seen.add(threading.get_ident())
        return real()

    monkeypatch.setattr(srv, "tick", tick)

    async def inner():
        front = AsyncServer(srv)
        await asyncio.gather(*(front.generate(r) for r in _requests(Request, cfg.vocab, 3)))
        front.close()

    asyncio.run(inner())
    assert len(seen) == 1 and threading.get_ident() not in seen


def test_a_generate_during_a_tick_leaves_the_event_loop_free(smollm, monkeypatch):
    """A request that arrives while a tick runs does not block the event
    loop: the loop goes on and releases the tick that is still running."""
    _, _, cfg, _ = smollm
    srv = _server(smollm)
    in_tick, release, waited = threading.Event(), threading.Event(), []
    real = srv.tick

    def tick():
        in_tick.set()
        waited.append(release.wait(timeout=5))
        return real()

    monkeypatch.setattr(srv, "tick", tick)

    async def inner():
        front = AsyncServer(srv)
        first, second = _requests(Request, cfg.vocab, 2)
        a = asyncio.ensure_future(front.generate(first))
        while not in_tick.is_set():
            await asyncio.sleep(0.001)
        b = asyncio.ensure_future(front.generate(second))
        await asyncio.sleep(0.01)       # the second submission waits for the tick
        release.set()
        out = await asyncio.gather(a, b)
        front.close()
        return out

    out = asyncio.run(inner())
    assert all(waited) and [r.finish_reason for r in out] == ["max_tokens"] * 2


# ---------------------------------------------------------------------------
# kernel host round-trips: counted per server thread
# ---------------------------------------------------------------------------

def _stub_kernel_prefill(monkeypatch):
    """``lm.prefill`` with a persistent kernel's host round-trip in each of
    its layers (what ``lstm_seq`` and the generated stages count on the
    card), the two threads' layers taken in turns."""
    turns = threading.Barrier(2)
    real = lm.prefill

    def prefill(params, cfg, tokens):
        out = real(params, cfg, tokens)
        for _ in range(cfg.n_layers):
            _build.count_host_sync()
            turns.wait(timeout=30)      # the other server's layer comes next
        return out

    monkeypatch.setattr(lm, "prefill", prefill)


@pytest.mark.parametrize("front", ["threads", "async_servers"])
def test_two_servers_on_two_threads_count_their_own_kernel_syncs(smollm, monkeypatch, front):
    _, _, cfg, _ = smollm
    _stub_kernel_prefill(monkeypatch)
    servers = [_server(smollm, slots=4), _server(smollm, slots=3)]
    n_req = 3
    if front == "threads":
        def run(srv, seed):
            for r in _requests(Request, cfg.vocab, n_req, seed=seed):
                srv.submit(r)
            srv.run_until_drained()

        threads = [threading.Thread(target=run, args=(s, i)) for i, s in enumerate(servers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    else:
        async def inner():
            fronts = [AsyncServer(s) for s in servers]
            await asyncio.gather(*(f.generate(r) for i, f in enumerate(fronts)
                                   for r in _requests(Request, cfg.vocab, n_req, seed=i)))
            for f in fronts:
                f.close()

        asyncio.run(inner())
    for srv in servers:
        assert len(srv.completed) == n_req
        assert srv.prefill_kernel_syncs == n_req * cfg.n_layers
        assert srv.stats()["prefill"]["prompt_steps_computed"] == 5 * n_req
