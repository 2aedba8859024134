"""MoE experts and MLA heads on the model shard: ``DecodeServer(plan=)``
and ``Trainer(mesh=)`` at tp = 2 on gloo CPU ranks, against the
reference's unsharded computation on bridged weights.

olmoe-1b-7b (8 experts, 2 of 4 query and KV heads a rank, qk-norm) and
deepseek-v2-lite-16b (MLA on 2 of 4 heads a rank with its latent whole, 8
routed and 1 shared expert) smoke configs, and deepseek with 5 experts
(the axis does not divide them: the rules keep the experts whole, and so
does the layer, while attention and the shared expert still split), on
the meshes (1, 1, 2) (ranks 0 and 1) and (1, 2, 2) (four ranks, two data
shards), one spawn of four ranks.

SERVING — ``step()`` and ``persistent=True``: every request's greedy
          tokens equal the reference model's greedy loop; each one-shot
          prefill's logits and every decode step's, joined over ``model``,
          within 1e-5 of max |logit| of the reference's ``lm.prefill``/
          ``decode_step``; every router call's expert ids the same on the
          model ranks of a data shard; per-rank parameter and cache shapes
          the blocks of the reference's ``param_specs(fsdp=False)`` and
          ``cache_specs``; the host state the same on every rank.  Two
          slots a server: with top-2 of 8 experts a decode group of two
          tokens drops none, so a slot's tokens do not depend on its
          neighbour's (the reference's loop decodes one row).
TRAINING — three steps of ``Trainer(mesh=)`` (olmoe with groups that span
          the data ranks, deepseek with aligned 16-token groups): step 0
          within 1e-5 of the reference ``Trainer``, later steps within
          1e-4; the model-shard path, no gather over ``model`` in a step;
          the leaves replicated along ``model`` (router, norms, ``w_dkv``,
          ``w_krope``, ``kv_norm``) bit-identical across the model ranks
          after every step; the router's and ``w_dkv``'s gradients of
          ``train_loss`` equal to the reference's (an aux gradient summed
          over ``model`` would count it twice); deepseek's checkpoints move
          between tp = 2 and ``mesh=None`` bit for bit, both ways.

The reference runs in the parent while the ranks (``launch.spawn``) run;
they import no JAX.
"""

import dataclasses
import hashlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.spawn import run_ranks  # noqa: E402

ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite-16b")
# (arch, replaced fields): deepseek-e5's 5 experts do not cut over tp = 2
SERVED = {"olmoe-1b-7b": ("olmoe-1b-7b", {}),
          "deepseek-v2-lite-16b": ("deepseek-v2-lite-16b", {}),
          "deepseek-e5": ("deepseek-v2-lite-16b", {"n_experts": 5})}
TRAINED = {"olmoe-1b-7b": ("olmoe-1b-7b", {}),
           "deepseek-v2-lite-16b": ("deepseek-v2-lite-16b", {"moe_group_size": 16})}
MESHES = {"1x1x2": (1, 2), "1x2x2": (2, 2)}
PROMPTS = [(7, 0), (12, 1), (3, 2), (9, 3)]      # (length, seed)
NEW = 5
SLOTS, MAX_SEQ = 2, 32
LOGIT_GAP = 1e-5
GRAD_GAP = 1e-5
DRIVERS = {"step": {}, "block": {"persistent": True, "block_k": 4}}
DATA = dict(vocab=256, branching=3, seq_len=16)
TRAIN = dict(total_steps=3, ckpt_every=100, log_every=1, ckpt_async=False, microbatches=1)
OPTIM = dict(lr_peak=3e-3, warmup_steps=2, total_steps=10)
BATCH = 8
CKPT_ARCH = "deepseek-v2-lite-16b"
GRAD_LEAVES = ("moe/router", "attn/w_dkv", "attn/w_krope", "attn/kv_norm/scale")


def _cfg(spec, smoke_config):
    arch, fields = spec
    return dataclasses.replace(smoke_config(arch), **fields)


def _prompt(n, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(1, 256, n)]


def _grad_batch():
    toks = np.random.default_rng(5).integers(0, 256, size=(4, 16)).astype(np.int32)
    return {"tokens": toks, "labels": toks}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


# -- the ranks ----------------------------------------------------------------

def _serve(cfg, params, plan, **kw):
    """Drain the requests: tokens by uid, prefill logits by uid, decode
    logits by (uid, position), every router call's ids, the host state's
    digest, the server."""
    from repro_torch.models import lm, moe
    from repro_torch.parallel import tensor_parallel as tp
    from repro_torch.runtime import DecodeServer, Request

    srv = DecodeServer(cfg, params, num_slots=SLOTS, max_seq=MAX_SEQ, plan=plan, device="cpu",
                       **kw)
    rows = plan.slots_of_shard(plan.local_shard, SLOTS)
    pre, dec, routes = {}, {}, []
    by_prompt = {tuple(p): i for i, p in enumerate(_prompt(*q) for q in PROMPTS)}
    inner_pre, inner_dec, inner_route = lm.prefill, lm.decode_step, moe.route

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

    def route(p, c, x, data=None):
        out = inner_route(p, c, x, data)
        routes.append(out[0].numpy().tobytes())
        return out

    lm.prefill, lm.decode_step, moe.route = prefill, decode, route
    try:
        for i, p in enumerate(PROMPTS):
            srv.submit(Request(uid=i, prompt=_prompt(*p), max_new_tokens=NEW))
        srv.run_until_drained()
    finally:
        lm.prefill, lm.decode_step, moe.route = inner_pre, inner_dec, inner_route
    toks = {r.uid: list(r.out_tokens) for r in srv.completed}
    digest = hashlib.sha256(repr(srv.host_state()).encode()).hexdigest()
    routes = hashlib.sha256(b"".join(routes)).hexdigest()
    return toks, pre, dec, routes, digest, srv


def _trainer(arch, p0, ckpt_dir, mesh):
    from repro_torch import bridge, optim
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = _cfg(TRAINED[arch], get_smoke_config)
    t = Trainer(cfg, TrainerConfig(ckpt_dir=str(ckpt_dir), **TRAIN), optim.AdamWConfig(**OPTIM),
                DataConfig(global_batch=BATCH, **DATA), mesh, device="cpu")
    t.load_full(bridge.params_from_jax(p0, cfg, "cpu"))
    return t


def _replicated_digests(t):
    """``{path: sha}`` of this rank's blocks of every leaf of the state
    that no spec cuts over ``model``."""
    from repro_torch.checkpoint.checkpoint import flatten_with_names

    state = flatten_with_names({"params": t.params, "opt": t.opt_state})
    flat_specs = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}/{k}")
        elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
            for k in tree._fields:
                walk(getattr(tree, k), f"{prefix}/{k}")
        else:
            flat_specs[prefix.lstrip("/")] = tree.entries

    walk(t.layout.specs, "")
    return {path: hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()
            for path, arr in state.items()
            if not any("model" in (e if isinstance(e, tuple) else (e,))
                       for e in flat_specs[path] if e is not None)}


def _train(arch, p0, ckpt_dir, mesh):
    from repro_torch.parallel import comm

    t = _trainer(arch, p0, ckpt_dir, mesh)
    inner, steps = t._step_fn, []

    def step(params, opt, batch):
        comm.reset_counts()
        res = inner(params, opt, batch)
        counts = comm.counters()
        t.params, t.opt_state = res[0], res[1]
        steps.append((counts, _replicated_digests(t)))
        return res

    t._step_fn = step
    res = t.run()
    return t, {"metrics": [(m["loss"], m["grad_norm"]) for m in res["metrics"]],
               "steps": steps, "model_shard": inner.model_shard}


def _grads(arch, p0, plan):
    """``train_loss``'s gradients of :data:`GRAD_LEAVES` on this rank's
    model shard (whole leaves: replicated along ``model``)."""
    from repro_torch import bridge
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import model_shard

    cfg = _cfg(TRAINED[arch], get_smoke_config)
    local = plan.local_params(cfg, bridge.params_from_jax(p0, cfg, "cpu"))
    p = tree_map(lambda t: t.clone().requires_grad_(True), local)
    batch = {k: torch.from_numpy(v) for k, v in _grad_batch().items()}
    with model_shard(plan.mesh):
        loss, _ = lm.train_loss(p, cfg, batch)
    loss.backward()
    return {k: v.grad.numpy().copy() for k, v in _flat(p).items()
            if k.endswith(GRAD_LEAVES)}


def _ranks(rank, world, p0s, tmp):
    import sys

    import torch.distributed as dist

    from repro_torch import bridge
    from repro_torch.checkpoint.checkpoint import flatten_with_names
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import local_shard, make_local_mesh, model_index
    from repro_torch.runtime import ShardPlan

    tmp = Path(tmp)
    meshes = {name: make_local_mesh(*shape) for name, shape in MESHES.items()}
    out = {"serve": {}, "train": {}, "grads": {}}
    for name, mesh in meshes.items():
        if mesh.get_coordinate() is None:
            continue
        plan = ShardPlan(mesh)
        out["coord", name] = (local_shard(mesh), model_index(mesh))
        for key, spec in SERVED.items():
            cfg = _cfg(spec, get_smoke_config)
            params = bridge.params_from_jax(p0s["serve"][key], cfg, "cpu")
            for drv, kw in DRIVERS.items():
                *run, srv = _serve(cfg, params, plan, **kw)
                out["serve"][name, key, drv] = tuple(run)
            out["serve"][name, key, "shapes"] = (
                {k: tuple(v.shape) for k, v in _flat(srv.params).items()},
                {k: tuple(v.shape) for k, v in _flat(srv.caches).items()})
        for arch in TRAINED:
            t, res = _train(arch, p0s["train"][arch], tmp / f"{arch}_{name}", mesh)
            out["train"][name, arch] = res
            if name == "1x1x2" and arch == CKPT_ARCH:
                out["tp_state"] = flatten_with_names(t.full_state())
            if name == "1x1x2":
                out["grads"][arch] = _grads(arch, p0s["train"][arch], plan)
    # tp = 2 -> mesh=None and mesh=None -> tp = 2, as test_torch_tp_train does
    none_dir, p0 = tmp / "none_ck", p0s["train"][CKPT_ARCH]
    if rank == 0:
        t = _trainer(CKPT_ARCH, p0, tmp / f"{CKPT_ARCH}_1x1x2", None)
        assert t.run()["losses"] == []             # resumed at the last step
        out["restored_at_none"] = flatten_with_names(t.full_state())
        t = _trainer(CKPT_ARCH, p0, none_dir, None)
        t.run()
        out["none_state"] = flatten_with_names(t.full_state())
    dist.barrier()
    if meshes["1x1x2"].get_coordinate() is not None:
        t = _trainer(CKPT_ARCH, p0, none_dir, meshes["1x1x2"])
        assert t.run()["losses"] == []
        out["restored_at_tp"] = flatten_with_names(t.full_state())
    out["jax"] = "jax" in sys.modules
    return out


# -- the reference --------------------------------------------------------------

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


def _reference_serving(jcfg, p_j):
    """Each prompt's one-shot prefill logits, greedy tokens and decode
    logits by position; the per-rank shapes on each mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh as JaxAbstractMesh

    from repro.models import lm as jax_lm
    from repro.parallel import sharding as jax_sharding

    prefill = jax.jit(jax_lm.prefill, static_argnums=1)
    chunk = jax.jit(jax_lm.prefill_chunk, static_argnums=1)
    decode = jax.jit(jax_lm.decode_step, static_argnums=1)
    want = {"pre": {}, "toks": {}, "dec": {}, "shapes": {}}
    for uid, (n, seed) in enumerate(PROMPTS):
        prompt = jnp.asarray([_prompt(n, seed)], jnp.int32)
        lg, _ = prefill(p_j, jcfg, prompt)
        want["pre"][uid] = np.asarray(lg[0])
        _, cache = chunk(p_j, jcfg, prompt, jax_lm.init_cache(jcfg, 1, MAX_SEQ), jnp.int32(0))
        toks = [int(np.argmax(want["pre"][uid]))]
        for pos in range(n, n + NEW - 1):
            lg, cache = decode(p_j, jcfg, jnp.asarray([[toks[-1]]], jnp.int32), cache,
                               jnp.int32(pos))
            want["dec"][uid, pos] = np.asarray(lg[0])
            toks.append(int(np.argmax(want["dec"][uid, pos])))
        want["toks"][uid] = toks
    for name, (dp, tp) in MESHES.items():
        jmesh = JaxAbstractMesh((1, dp, tp), ("pod", "data", "model"))
        sizes = {"pod": 1, "data": dp, "model": tp}
        ps = jax_sharding.param_specs(jcfg, p_j, jmesh, fsdp=False)
        cache = jax_lm.init_cache(jcfg, SLOTS, MAX_SEQ)
        cs = jax_sharding.cache_specs(jcfg, cache, jmesh, shard_seq=False)
        want["shapes"][name] = (_cut(p_j, ps, sizes), _cut(cache, cs, sizes))
    return want


def _reference_grads(jcfg, p_j):
    import jax
    import jax.numpy as jnp

    from repro.models import lm as jax_lm

    batch = {k: jnp.asarray(v) for k, v in _grad_batch().items()}
    grads = jax.grad(lambda p: jax_lm.train_loss(p, jcfg, batch)[0])(p_j)
    return {k: np.asarray(v) for k, v in _flat(grads).items() if k.endswith(GRAD_LEAVES)}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The reference's serving, training and gradients on each config,
    computed while the ranks run on its initial parameters (numpy)."""
    import threading

    import jax

    from repro import optim as jax_optim
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.data import DataConfig as JaxDataConfig
    from repro.models import lm as jax_lm
    from repro.runtime import Trainer as JaxTrainer
    from repro.runtime import TrainerConfig as JaxTrainerConfig

    served = {key: (_cfg(spec, jax_smoke_config),) for key, spec in SERVED.items()}
    served = {key: (jcfg, jax_lm.init_params(jcfg, jax.random.PRNGKey(0)))
              for key, (jcfg,) in served.items()}
    trainers = {arch: JaxTrainer(_cfg(spec, jax_smoke_config), JaxTrainerConfig(
        ckpt_dir=str(tmp_path_factory.mktemp(arch)), **TRAIN), jax_optim.AdamWConfig(**OPTIM),
        JaxDataConfig(global_batch=BATCH, **DATA)) for arch, spec in TRAINED.items()}
    p0s = {"serve": {key: jax.tree.map(np.asarray, p_j) for key, (_, p_j) in served.items()},
           "train": {arch: jax.tree.map(np.asarray, jt.params) for arch, jt in trainers.items()}}
    got = {}

    def spawn():
        try:
            got["ranks"] = run_ranks(_ranks, 4, (p0s, str(tmp_path_factory.mktemp("tp_moe"))),
                                     timeout_s=240)
        except BaseException as e:  # noqa: BLE001 - raised below
            got["ranks"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    out = {"serve": {key: _reference_serving(jcfg, p_j) for key, (jcfg, p_j) in served.items()},
           "grads": {arch: _reference_grads(jt.cfg, jt.params) for arch, jt in trainers.items()},
           "train": {arch: [(m["loss"], m["grad_norm"]) for m in jt.run()["metrics"]]
                     for arch, jt in trainers.items()}}
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


def _members(ranks, name):
    return [r for r in ranks if ("coord", name) in r]


# -- serving ----------------------------------------------------------------------

@pytest.mark.parametrize("drv", list(DRIVERS))
@pytest.mark.parametrize("key", list(SERVED))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_served_tokens_and_logits_match_the_reference(reference, ranks, mesh, key, drv):
    want = reference["serve"][key]
    members = _members(ranks, mesh)
    assert len(members) == MESHES[mesh][0] * MESHES[mesh][1]
    prefills = decodes = 0
    for r in members:
        toks, pre, dec, _, _ = r["serve"][mesh, key, drv]
        assert toks == want["toks"]
        for uid, lg in pre.items():
            ref = want["pre"][uid]
            assert np.max(np.abs(lg - ref)) <= LOGIT_GAP * np.max(np.abs(ref)), uid
            prefills += 1
        for k, lg in dec.items():
            if k not in want["dec"]:        # a retired slot idling in a block
                continue
            ref = want["dec"][k]
            assert np.max(np.abs(lg - ref)) <= LOGIT_GAP * np.max(np.abs(ref)), k
            decodes += 1
    assert decodes >= len(PROMPTS) * (NEW - 1)
    assert prefills >= len(PROMPTS)


@pytest.mark.parametrize("drv", list(DRIVERS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_routing_and_host_state_agree_across_ranks(ranks, mesh, drv):
    """Every router call's ids are the same on the model ranks of a data
    shard (their residual streams are the same bits); the host state on
    every rank."""
    for key in SERVED:
        by_shard, digests = {}, set()
        for r in _members(ranks, mesh):
            _, _, _, routes, digest = r["serve"][mesh, key, drv]
            by_shard.setdefault(r["coord", mesh][0], set()).add(routes)
            digests.add(digest)
        assert all(len(v) == 1 for v in by_shard.values()), key
        assert len(by_shard) == MESHES[mesh][0] and len(digests) == 1, key


@pytest.mark.parametrize("key", list(SERVED))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_per_rank_shapes_are_the_reference_specs_blocks(reference, ranks, mesh, key):
    want_p, want_c = reference["serve"][key]["shapes"][mesh]
    for r in _members(ranks, mesh):
        got_p, got_c = r["serve"][mesh, key, "shapes"]
        assert got_p == want_p
        assert got_c == want_c
        experts = got_p["groups/b0_moe/moe/w_in"][1]
        assert experts == (5 if key == "deepseek-e5" else 8 // 2)


# -- training ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(TRAINED))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_trained_losses_and_grad_norms_match_the_reference(reference, ranks, mesh, arch):
    want = np.array(reference["train"][arch])
    members = _members(ranks, mesh)
    assert len(members) == MESHES[mesh][0] * MESHES[mesh][1]
    for r in members:
        run = r["train"][mesh, arch]
        assert run["model_shard"]
        got = np.array(run["metrics"])
        assert got.shape == want.shape == (TRAIN["total_steps"], 2)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        np.testing.assert_allclose(got[1:], want[1:], rtol=1e-4)
        assert run["metrics"] == members[0]["train"][mesh, arch]["metrics"]


@pytest.mark.parametrize("arch", list(TRAINED))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_a_step_gathers_nothing_over_model_and_keeps_replicas_equal(ranks, mesh, arch):
    dp = MESHES[mesh][0]
    by_shard = {}
    for r in _members(ranks, mesh):
        steps = r["train"][mesh, arch]["steps"]
        for counts, _ in steps:
            assert "gather_exact" not in counts, counts
            assert ("gather_data" in counts) == (dp > 1), counts
        by_shard.setdefault(r["coord", mesh][0], []).append(steps)
    for shard, runs in by_shard.items():
        assert len(runs) == MESHES[mesh][1]
        for step in range(TRAIN["total_steps"]):
            digests = [steps[step][1] for steps in runs]
            assert any("moe/router" in k for k in digests[0]), digests[0].keys()
            assert all(d == digests[0] for d in digests), (shard, step)


@pytest.mark.parametrize("arch", list(TRAINED))
def test_replicated_gradients_match_the_reference(reference, ranks, arch):
    """The router's gradient (its combine part summed over ``model``, the
    aux part once) and MLA's down projections' against ``jax.grad`` of the
    reference's ``train_loss``."""
    want = reference["grads"][arch]
    assert any(k.endswith("moe/router") for k in want)
    assert any(k.endswith("attn/w_dkv") for k in want) == (arch == "deepseek-v2-lite-16b")
    for r in ranks[:2]:
        got = r["grads"][arch]
        assert got.keys() == want.keys()
        for k, g in got.items():
            assert np.max(np.abs(g - want[k])) <= GRAD_GAP * np.max(np.abs(want[k])), k


def test_checkpoints_move_between_tp2_and_one_device_bit_for_bit(ranks):
    tp_state = ranks[0]["tp_state"]
    got = ranks[0]["restored_at_none"]
    assert got.keys() == tp_state.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], tp_state[k], err_msg=k)
    none_state = ranks[0]["none_state"]
    for r in ranks[:2]:
        got = r["restored_at_tp"]
        assert got.keys() == none_state.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], none_state[k], err_msg=k)
    assert not any(r["jax"] for r in ranks)
