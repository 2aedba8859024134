"""``DecodeServer(plan=)`` at tp = 2 on gloo CPU ranks against the
reference model's unsharded computation on bridged weights.

internlm2-20b (attention on 3 of 6 query and 1 of 2 KV heads a rank),
falcon-mamba-7b (64 of 128 inner channels a rank), smollm-135m (attention
replicated: ``attn_tp=False``) and gemma3-27b (sliding-window rings of
16, decode past the wrap, and the 2-block tail, whose ``wo``/``w_out``
the rules cut on their output dim) smoke configs, on the meshes
(1, 1, 2) (ranks 0 and 1) and (1, 2, 2) (four ranks, two data shards), one
spawn of four ranks.  Each config is served three ways: ``step()``,
``persistent=True`` and chunked prefill with a prefix cache (a repeated
prompt is a full hit).

TOKENS  — every request's greedy tokens equal the reference model's greedy
          loop (``lm.prefill``, then ``decode_step``).
LOGITS  — each request's one-shot prefill logits and every decode step's
          logits, joined over ``model``, within 1e-5 of max |logit| of the
          reference's ``lm.prefill``/``decode_step``.
SHAPES  — each rank's parameter and cache leaves have the shapes of their
          block under the reference's ``param_specs(fsdp=False)`` and
          ``cache_specs``.
HOST    — the host state is the same on every rank after every drain.
REFUSAL — tp = 2 on a family outside the slice (paper-lstm, zamba2) raises
          ``NotImplementedError`` citing 12c(c); the VLM and the encoder,
          which compute on a model shard (``tests/test_torch_tp_cross.py``),
          are refused with the server's own reasons (no memory, no
          decode), which do not name 12c(c).

The reference runs in the parent while the ranks (``launch.spawn``) run;
they import no JAX.
"""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.spawn import run_ranks  # noqa: E402

ARCHS = ("internlm2-20b", "falcon-mamba-7b", "smollm-135m", "gemma3-27b")
MESHES = {"1x1x2": (1, 2), "1x2x2": (2, 2)}
PROMPTS = [(7, 0), (12, 1), (3, 2), (9, 3)]      # (length, seed)
NEW = 5
SLOTS, MAX_SEQ = 4, 32
LOGIT_GAP = 1e-5
REFUSED = ("paper-lstm", "zamba2-1.2b")
NOT_SERVED = {"llama-3.2-vision-90b": "is a VLM", "hubert-xlarge": "is an encoder"}


def _prompt(n, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(1, 256, n)]


def _requests():
    from repro_torch.runtime import Request

    rs = [Request(uid=i, prompt=_prompt(*p), max_new_tokens=NEW) for i, p in enumerate(PROMPTS)]
    return rs


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tuple(tree.shape)}


def _serve(cfg, params, plan, **kw):
    """Drain the requests (plus a repeat of request 0 under the prefix
    cache): tokens by uid, prefill logits by uid, decode logits by (uid,
    position), the host state's digest, the server."""
    from repro_torch.models import lm
    from repro_torch.parallel import tensor_parallel as tp
    from repro_torch.runtime import DecodeServer, Request

    srv = DecodeServer(cfg, params, num_slots=SLOTS, max_seq=MAX_SEQ, plan=plan, device="cpu",
                       **kw)
    rows = plan.slots_of_shard(plan.local_shard, SLOTS)
    pre, dec = {}, {}
    by_prompt = {tuple(p): i for i, p in enumerate(_prompt(*q) for q in PROMPTS)}
    inner_pre, inner_dec = lm.prefill, lm.decode_step

    def prefill(p, c, tokens, **k):
        out = inner_pre(p, c, tokens, **k)
        pre.setdefault(by_prompt[tuple(tokens[0].tolist())],
                       tp.join_vocab(out[0], c.vocab)[0].numpy().copy())
        return out

    def decode(p, c, tokens, caches, pos, **k):
        out = inner_dec(p, c, tokens, caches, pos, **k)
        full = tp.join_vocab(out[0], c.vocab).numpy()
        for j, b in enumerate(rows):
            if srv.slot_req[b] is not None:
                dec.setdefault((srv.slot_req[b].uid, int(pos.reshape(-1)[j])), full[j].copy())
        return out

    lm.prefill, lm.decode_step = prefill, decode
    try:
        for r in _requests():
            srv.submit(r)
        srv.run_until_drained()
        if kw.get("prefix_cache_bytes"):
            srv.submit(Request(uid=9, prompt=_prompt(*PROMPTS[0]), max_new_tokens=NEW))
            srv.run_until_drained()
    finally:
        lm.prefill, lm.decode_step = inner_pre, inner_dec
    toks = {r.uid: list(r.out_tokens) for r in srv.completed}
    digest = hashlib.sha256(repr(srv.host_state()).encode()).hexdigest()
    return toks, pre, dec, digest, srv


DRIVERS = {"step": {}, "block": {"persistent": True, "block_k": 4},
           "chunk_pc": {"prefill_chunk": 4, "prefix_cache_bytes": 16 << 20}}


def _ranks(rank, world, p0s):
    import sys

    from repro_torch import bridge
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.runtime import DecodeServer, ShardPlan

    meshes = {name: make_local_mesh(*shape) for name, shape in MESHES.items()}
    out = {"runs": {}, "refused": {}}
    for name, mesh in meshes.items():
        if mesh.get_coordinate() is None:
            continue
        plan = ShardPlan(mesh)
        for arch in ARCHS:
            cfg = get_smoke_config(arch)
            params = bridge.params_from_jax(p0s[arch], cfg, "cpu")
            for drv, kw in DRIVERS.items():
                toks, pre, dec, digest, srv = _serve(cfg, params, plan, **kw)
                out["runs"][name, arch, drv] = (toks, pre, dec, digest)
            out["runs"][name, arch, "shapes"] = (_flat(srv.params), _flat(srv.caches))
        for arch in REFUSED + tuple(NOT_SERVED):
            cfg = get_smoke_config(arch)
            p = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
            try:
                DecodeServer(cfg, p, num_slots=SLOTS, max_seq=MAX_SEQ, plan=plan, device="cpu")
                out["refused"][name, arch] = None
            except NotImplementedError as e:
                out["refused"][name, arch] = str(e)
    out["jax"] = "jax" in sys.modules
    return out


@pytest.fixture(scope="module")
def both():
    """The ranks' results, and per arch the reference's: the bridged numpy
    weights, each prompt's one-shot prefill logits, its greedy tokens and
    its decode logits by position, and the per-rank shapes on each mesh.
    The reference computes while the ranks run."""
    import threading

    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh as JaxAbstractMesh

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import lm as jax_lm
    from repro.parallel import sharding as jax_sharding

    inits = {arch: jax_lm.init_params(jax_smoke_config(arch), jax.random.PRNGKey(0))
             for arch in ARCHS}
    p0s = {arch: jax.tree.map(np.asarray, p_j) for arch, p_j in inits.items()}
    got = {}

    def spawn():
        try:
            got["ranks"] = run_ranks(_ranks, 4, (p0s,), timeout_s=240)
        except BaseException as e:  # noqa: BLE001 - raised below
            got["ranks"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    prefill = jax.jit(jax_lm.prefill, static_argnums=1)
    chunk = jax.jit(jax_lm.prefill_chunk, static_argnums=1)
    decode = jax.jit(jax_lm.decode_step, static_argnums=1)
    out = {}
    for arch in ARCHS:
        jcfg = jax_smoke_config(arch)
        p_j = inits[arch]
        want = {"pre": {}, "toks": {}, "dec": {}}
        for uid, (n, seed) in enumerate(PROMPTS):
            prompt = _prompt(n, seed)
            lg, _ = prefill(p_j, jcfg, jnp.asarray([prompt], jnp.int32))
            want["pre"][uid] = np.asarray(lg[0])
            cache = jax_lm.init_cache(jcfg, 1, MAX_SEQ)
            _, cache = chunk(p_j, jcfg, jnp.asarray([prompt], jnp.int32), cache, jnp.int32(0))
            toks = [int(np.argmax(want["pre"][uid]))]
            for pos in range(n, n + NEW - 1):
                lg, cache = decode(p_j, jcfg, jnp.asarray([[toks[-1]]], jnp.int32), cache,
                                   jnp.int32(pos))
                want["dec"][uid, pos] = np.asarray(lg[0])
                toks.append(int(np.argmax(want["dec"][uid, pos])))
            want["toks"][uid] = toks
        shapes = {}
        for name, (dp, tp) in MESHES.items():
            jmesh = JaxAbstractMesh((1, dp, tp), ("pod", "data", "model"))
            sizes = {"pod": 1, "data": dp, "model": tp}
            ps = jax_sharding.param_specs(jcfg, p_j, jmesh, fsdp=False)
            cache = jax_lm.init_cache(jcfg, SLOTS, MAX_SEQ)
            cs = jax_sharding.cache_specs(jcfg, cache, jmesh, shard_seq=False)
            shapes[name] = (_cut(p_j, ps, sizes), _cut(cache, cs, sizes))
        want["shapes"] = shapes
        out[arch] = want
    thread.join()
    if isinstance(got["ranks"], BaseException):
        raise got["ranks"]
    return out, got["ranks"]


@pytest.fixture(scope="module")
def reference(both):
    return both[0]


@pytest.fixture(scope="module")
def ranks(both):
    return both[1]


def _cut(tree, specs, sizes):
    """``{path: the block's shape}`` of a reference tree under its specs."""
    import jax

    from repro.parallel import sharding as jax_sharding

    shape_of = {jax_sharding._path_str(p): tuple(x.shape)
                for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
        key = jax_sharding._path_str(path)
        shp = list(shape_of[key])
        for d, e in enumerate(tuple(spec)):
            for a in (() if e is None else (e if isinstance(e, tuple) else (e,))):
                shp[d] //= sizes[a]
        out[key] = tuple(shp)
    return out


def _members(ranks, name):
    return [r for r in ranks if any(k[0] == name for k in r["runs"])]


@pytest.mark.parametrize("drv", list(DRIVERS))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_tokens_and_logits_match_the_reference(reference, ranks, mesh, arch, drv):
    want = reference[arch]
    members = _members(ranks, mesh)
    assert len(members) == MESHES[mesh][0] * MESHES[mesh][1]
    prefills = decodes = 0
    for r in members:
        toks, pre, dec, _ = r["runs"][mesh, arch, drv]
        for uid, t in want["toks"].items():
            assert toks[uid] == t, (uid, toks[uid], t)
        if drv == "chunk_pc":
            assert toks[9] == want["toks"][0]        # the prefix cache's full hit
        for uid, lg in pre.items():
            ref = want["pre"][uid]
            assert np.max(np.abs(lg - ref)) <= LOGIT_GAP * np.max(np.abs(ref)), uid
            prefills += 1
        for key, lg in dec.items():
            if key not in want["dec"]:      # a retired slot idling in a block; the repeat
                continue
            ref = want["dec"][key]
            assert np.max(np.abs(lg - ref)) <= LOGIT_GAP * np.max(np.abs(ref)), key
            decodes += 1
    # every request's prefill and decode steps were compared on some rank
    assert decodes >= len(PROMPTS) * (NEW - 1)
    assert prefills >= (0 if drv == "chunk_pc" else len(PROMPTS))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_per_rank_shapes_are_the_reference_specs_blocks(reference, ranks, mesh, arch):
    want_p, want_c = reference[arch]["shapes"][mesh]
    for r in _members(ranks, mesh):
        got_p, got_c = r["runs"][mesh, arch, "shapes"]
        assert got_p == want_p
        assert got_c == want_c


@pytest.mark.parametrize("drv", list(DRIVERS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_host_state_is_the_same_on_every_rank(ranks, mesh, drv):
    for arch in ARCHS:
        digests = {r["runs"][mesh, arch, drv][3] for r in _members(ranks, mesh)}
        assert len(digests) == 1, arch


@pytest.mark.parametrize("arch", REFUSED)
def test_a_family_outside_the_slice_is_refused_at_tp2(ranks, arch):
    for r in ranks:
        for (name, a), msg in r["refused"].items():
            if a == arch:
                assert msg is not None and "12c(c)" in msg, (name, msg)
    assert not any(r["jax"] for r in ranks)


@pytest.mark.parametrize("arch", list(NOT_SERVED))
def test_the_vlm_and_the_encoder_are_refused_for_the_server_s_reasons_at_tp2(ranks, arch):
    """Both compute on a model shard now; the server still refuses them,
    as it does without a plan: it passes no memory, and an encoder has no
    decode."""
    seen = 0
    for r in ranks:
        for (name, a), msg in r["refused"].items():
            if a == arch:
                assert msg is not None and NOT_SERVED[arch] in msg, (name, msg)
                assert "12c" not in msg, (name, msg)
                seen += 1
    assert seen == 6           # two ranks on (1, 1, 2), four on (1, 2, 2)
