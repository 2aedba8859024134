"""Cross-attention and the encoder on the model shard: the prefill, decode
and train steps (``make_prefill_step``/``make_serve_step(mesh=)``,
``Trainer(mesh=)``) at tp = 2 on gloo CPU ranks, against the reference's
unsharded computation on bridged weights.

llama-3.2-vision-90b at its smoke widths and 10 layers (two groups of four
``attn`` blocks and one gated ``cross`` block; 2 of 4 query and 1 of 2 KV
heads a rank, the memory whole) and hubert-xlarge's smoke config (the
encoder: non-causal attention on 2 of 4 heads, ``embed/proj`` replicated,
16 of 32 vocabulary rows a rank), on the meshes (1, 1, 2) (ranks 0 and 1)
and (1, 2, 2) (four ranks, two data shards), one spawn of four ranks.
Every cross ``gate`` is opened to 0.5 on the numpy tree before bridging:
the reference draws it closed, and a closed gate hides the cross path from
every check (the mutation check below shows it).

SERVING — prefill logits of the rows a rank holds, joined over ``model``,
          within 1e-5 of max |logit| of the reference's ``lm.prefill``
          (``memory=`` for the VLM, frame embeddings for the encoder);
          llama's greedy decode through ``make_serve_step`` from the
          prefill's cache, every step's logits at 1e-5 and the tokens
          equal; hubert's ``lm.forward`` at every position; per-rank
          parameter and cache shapes the blocks of the reference's
          ``param_specs(fsdp=False)`` and ``cache_specs``;
          ``ShardPlan.draw_local`` equal, bit for bit, to ``local_params``
          of the whole draw (on every registered arch's smoke config).
TRAINING — three steps of ``Trainer(mesh=)`` on batches with a memory
          (llama) and on frame embeddings (hubert): step 0 within 1e-5 of
          the reference's train step, later steps within 1e-4; the
          model-shard path, no gather over ``model``; the leaves replicated
          along ``model`` bit-identical across the model ranks after
          every step; the gradients of ``cross/gate``, ``cross/q_norm``,
          ``cross/k_norm`` and ``embed/proj`` against ``jax.grad`` of the
          reference's ``train_loss`` (a gate applied after the sum over
          ``model`` has a whole gradient; the norms' are summed); hubert
          with 33 vocabulary ids, which do not cut over tp = 2 (as 504 do
          not over 16), keeps its head whole and counts its loss once;
          llama's checkpoints move between tp = 2 and ``mesh=None`` bit
          for bit, both ways.
MUTATION — ``cross/wk``'s KV heads rolled by one before the cut: with the
          gates open the prefill logits miss the 1e-5 bar; with the gates
          closed the same mutation leaves them bit-identical.

The reference's ``Trainer`` jits its step for a ``{"tokens", "labels"}``
batch only, so the reference side runs its train-step body (the
``accumulate_grads`` and ``optim.apply`` of ``Trainer._build``) under
``jax.jit`` on the same batches.  The reference runs in the parent while
the ranks (``launch.spawn``) run; they import no JAX.
"""

import dataclasses
import hashlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.launch.spawn import run_ranks  # noqa: E402

LLAMA, HUBERT = "llama-3.2-vision-90b", "hubert-xlarge"
# (arch, replaced fields)
CONFIGS = {"llama": (LLAMA, {"n_layers": 10}),
           "hubert": (HUBERT, {}),
           "hubert-v33": (HUBERT, {"vocab": 33})}
SERVED = ("llama", "hubert")
TRAINED = ("llama", "hubert")
MESHES = {"1x1x2": (1, 2), "1x2x2": (2, 2)}
ROWS, S, NEW, MAX_SEQ = 2, 12, 4, 24
GATE = 0.5
LOGIT_GAP = 1e-5
GRAD_GAP = 1e-5
TRAIN = dict(total_steps=3, ckpt_every=100, log_every=1, ckpt_async=False, microbatches=1)
OPTIM = dict(lr_peak=3e-3, warmup_steps=2, total_steps=10)
BATCH, SEQ = 8, 16
CKPT = "llama"
GRAD_LEAVES = {"llama": ("cross/gate", "cross/q_norm/scale", "cross/k_norm/scale"),
               "hubert": ("embed/proj",),
               "hubert-v33": ("embed/proj", "head/w", "final_norm/scale")}


def _cfg(key, smoke_config):
    arch, fields = CONFIGS[key]
    return dataclasses.replace(smoke_config(arch), **fields)


def _open_gates(p_np, gate=GATE):
    """``p_np`` with every cross block's gate set to ``gate`` (a copy)."""
    out = {k: v for k, v in p_np.items()}
    if "b4_cross" in p_np["groups"]:
        groups = dict(p_np["groups"])
        blk = dict(groups["b4_cross"])
        blk["cross"] = dict(blk["cross"], gate=np.full_like(blk["cross"]["gate"], gate))
        groups["b4_cross"] = blk
        out["groups"] = groups
    return out


def _inputs(cfg):
    """The serving rows: token ids (an encoder's frame embeddings) and a
    VLM's memory, from numpy."""
    rng = np.random.default_rng(11)
    if cfg.family == "encoder":
        return {"embeds": rng.standard_normal((ROWS, S, cfg.frontend_dim), dtype=np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab, size=(ROWS, S)).astype(np.int32),
            "memory": rng.standard_normal((ROWS, cfg.frontend_tokens, cfg.frontend_dim),
                                          dtype=np.float32)}


def batch_at(pipe, cfg, step):
    """The pipeline's global batch at ``step`` with the model's other
    input: a VLM's memory beside the tokens, or an encoder's frame
    embeddings in place of them, drawn from numpy with the step as seed."""
    b = pipe.global_batch_at(step)
    rng = np.random.default_rng(100 + step)
    n, s = b["tokens"].shape
    if cfg.family == "encoder":
        return {"embeds": rng.standard_normal((n, s, cfg.frontend_dim), dtype=np.float32),
                "labels": b["labels"]}
    return b | {"memory": rng.standard_normal((n, cfg.frontend_tokens, cfg.frontend_dim),
                                              dtype=np.float32)}


class _Batches:
    """A ``TokenPipeline`` whose ``global_batch_at`` is :func:`batch_at`'s."""

    def __init__(self, pipe, cfg):
        self.pipe, self.cfg = pipe, cfg

    def global_batch_at(self, step):
        return batch_at(self.pipe, self.cfg, step)

    def __getattr__(self, name):
        return getattr(self.pipe, name)


def _data(cfg):
    return dict(vocab=cfg.vocab, branching=3, seq_len=SEQ)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


# -- the ranks ----------------------------------------------------------------

def _serve(cfg, p_full, mesh, inputs):
    """Prefill (and llama's greedy decode, hubert's forward) through the
    step functions on this rank's shards and rows: logits joined over
    ``model`` by position, the tokens, the shapes."""
    from repro_torch.launch.mesh import local_shard, mesh_dp
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import lm
    from repro_torch.parallel import tensor_parallel as tp
    from repro_torch.parallel import zero
    from repro_torch.parallel.sharding import model_shard
    from repro_torch.runtime import ShardPlan

    layout = zero.param_layout(cfg, mesh)
    shards = layout.shard(p_full)
    rows = zero.local_rows({k: torch.from_numpy(v) for k, v in inputs.items()}, 1,
                           mesh_dp(mesh), local_shard(mesh))
    prefill = make_prefill_step(cfg, mesh)
    # the context for join_vocab and init_cache (the steps enter it themselves)
    with torch.no_grad(), model_shard(mesh):
        lg, caches = prefill(shards, rows)
        out = {"model_shard": prefill.model_shard, "prefill": tp.join_vocab(lg, cfg.vocab).numpy()}
        if cfg.family == "encoder":
            full, _ = lm.forward(layout.gather(shards, keep_model=True), cfg, rows["embeds"])
            out["forward"] = tp.join_vocab(full, cfg.vocab).numpy()
        else:
            n = rows["tokens"].shape[0]
            dcache = lm.init_cache(cfg, n, MAX_SEQ, "cpu")
            for name, leaf in dcache["groups"].items():
                if isinstance(leaf, dict):
                    for k in ("k", "v"):
                        leaf[k][:, :, :S] = caches["groups"][name][k]
            out["cache_shapes"] = {k: tuple(v.shape) for k, v in _flat(dcache).items()}
            serve = make_serve_step(cfg, mesh)
            toks = [out["prefill"].argmax(-1)]
            out["decode"] = {}
            for pos in range(S, S + NEW - 1):
                step_in = {"tokens": torch.from_numpy(toks[-1][:, None].astype(np.int32)),
                           "memory": rows["memory"]}
                lg, dcache = serve(shards, step_in, dcache, pos)
                out["decode"][pos] = tp.join_vocab(lg, cfg.vocab).numpy()
                toks.append(out["decode"][pos].argmax(-1))
            out["tokens"] = np.stack(toks, 1)
    plan = ShardPlan(mesh)
    local = plan.local_params(cfg, p_full)
    out["param_shapes"] = {k: tuple(v.shape) for k, v in _flat(local).items()}
    out["draw_local_equal"] = _drawn_equal(cfg, plan)
    return out


def _drawn_equal(cfg, plan):
    """Whether this rank's block drawn leaf by leaf (``draw_local``) is the
    cut of the whole draw (``local_params`` of ``lm.init_params``), bit for
    bit."""
    from repro_torch._tree import tree_leaves
    from repro_torch.models import lm

    drawn = plan.draw_local(cfg, torch.Generator().manual_seed(0), device="cpu")
    whole = plan.local_params(cfg, lm.init_params(cfg, torch.Generator().manual_seed(0),
                                                  device="cpu"))
    pairs = list(zip(tree_leaves(drawn), tree_leaves(whole), strict=True))
    return all(a.shape == b.shape and torch.equal(a, b) for a, b in pairs)


def _mutated_prefill(cfg, p_full, mesh, inputs, gate):
    """(prefill logits with the gates at ``gate``, the same with
    ``cross/wk``'s KV heads rolled by one), each joined over ``model``."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.parallel import tensor_parallel as tp
    from repro_torch.parallel import zero
    from repro_torch.parallel.sharding import model_shard

    layout = zero.param_layout(cfg, mesh)
    rows = {k: torch.from_numpy(v) for k, v in inputs.items()}
    prefill = make_prefill_step(cfg, mesh)
    out = []
    for roll in (0, cfg.head_dim):
        p = {k: v for k, v in p_full.items()}
        groups = dict(p["groups"])
        blk = dict(groups["b4_cross"])
        cross = dict(blk["cross"])
        cross["gate"] = torch.full_like(cross["gate"], gate)
        cross["wk"] = torch.roll(cross["wk"], roll, dims=-1)
        blk["cross"] = cross
        groups["b4_cross"] = blk
        p["groups"] = groups
        with torch.no_grad(), model_shard(mesh):
            lg, _ = prefill(layout.shard(p), rows)
            out.append(tp.join_vocab(lg, cfg.vocab).numpy())
    return out


def _trainer(key, p0, ckpt_dir, mesh):
    from repro_torch import bridge, optim
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = _cfg(key, get_smoke_config)
    t = Trainer(cfg, TrainerConfig(ckpt_dir=str(ckpt_dir), **TRAIN), optim.AdamWConfig(**OPTIM),
                DataConfig(global_batch=BATCH, **_data(cfg)), mesh, device="cpu")
    t.data = _Batches(t.data, cfg)
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


def _train(key, p0, ckpt_dir, mesh):
    from repro_torch.parallel import comm

    t = _trainer(key, p0, ckpt_dir, mesh)
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


def _grads(key, p0, plan, batch):
    """``train_loss`` and its gradients of :data:`GRAD_LEAVES` on this
    rank's model shard (leaves whole along ``model``)."""
    from repro_torch import bridge
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import model_shard

    cfg = _cfg(key, get_smoke_config)
    local = plan.local_params(cfg, bridge.params_from_jax(p0, cfg, "cpu"))
    p = tree_map(lambda t: t.clone().requires_grad_(True), local)
    with model_shard(plan.mesh):
        loss, _ = lm.train_loss(p, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return float(loss.detach()), {k: v.grad.numpy().copy() for k, v in _flat(p).items()
                                  if k.endswith(GRAD_LEAVES[key])}


def _ranks(rank, world, p0s, inputs, grad_batches, tmp):
    import sys

    import torch.distributed as dist

    from repro_torch import bridge
    from repro_torch.checkpoint.checkpoint import flatten_with_names
    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.launch.mesh import local_shard, make_local_mesh, model_index
    from repro_torch.runtime import ShardPlan

    torch.set_num_threads(1)
    tmp = Path(tmp)
    meshes = {name: make_local_mesh(*shape) for name, shape in MESHES.items()}
    out = {"serve": {}, "train": {}, "grads": {}, "draw_local": {}}
    for name, mesh in meshes.items():
        if mesh.get_coordinate() is None:
            continue
        out["coord", name] = (local_shard(mesh), model_index(mesh))
        for key in SERVED:
            cfg = _cfg(key, get_smoke_config)
            p_full = bridge.params_from_jax(p0s[key], cfg, "cpu")
            out["serve"][name, key] = _serve(cfg, p_full, mesh, inputs[key])
            if name == "1x1x2" and key == "llama":
                closed = bridge.params_from_jax(_open_gates(p0s[key], 0.0), cfg, "cpu")
                out["mutation"] = {
                    "open": _mutated_prefill(cfg, p_full, mesh, inputs[key], GATE),
                    "closed": _mutated_prefill(cfg, closed, mesh, inputs[key], 0.0)}
        for key in TRAINED:
            t, res = _train(key, p0s[key], tmp / f"{key}_{name}", mesh)
            out["train"][name, key] = res
            if name == "1x1x2" and key == CKPT:
                out["tp_state"] = flatten_with_names(t.full_state())
        if name == "1x1x2":
            plan = ShardPlan(mesh)
            for key in GRAD_LEAVES:
                out["grads"][key] = _grads(key, p0s[key], plan, grad_batches[key])
            for arch in ARCH_IDS:
                out["draw_local"][arch] = _drawn_equal(get_smoke_config(arch), plan)
    # tp = 2 -> mesh=None and mesh=None -> tp = 2
    none_dir, p0 = tmp / "none_ck", p0s[CKPT]
    if rank == 0:
        t = _trainer(CKPT, p0, tmp / f"{CKPT}_1x1x2", None)
        assert t.run()["losses"] == []             # resumed at the last step
        out["restored_at_none"] = flatten_with_names(t.full_state())
        t = _trainer(CKPT, p0, none_dir, None)
        t.run()
        out["none_state"] = flatten_with_names(t.full_state())
    dist.barrier()
    if meshes["1x1x2"].get_coordinate() is not None:
        t = _trainer(CKPT, p0, none_dir, meshes["1x1x2"])
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


def _reference_serving(jcfg, p_j, inputs):
    """The prefill's last logits, llama's greedy decode logits by position
    and tokens from the prefill's cache, hubert's forward logits; the
    per-rank shapes on each mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh as JaxAbstractMesh

    from repro.models import lm as jax_lm
    from repro.parallel import sharding as jax_sharding

    x = {k: jnp.asarray(v) for k, v in inputs.items()}
    lead = x.get("embeds", x.get("tokens"))
    want = {"shapes": {}}
    lg, caches = jax.jit(jax_lm.prefill, static_argnums=1)(p_j, jcfg, lead,
                                                           memory=x.get("memory"))
    want["prefill"] = np.asarray(lg)
    if jcfg.family == "encoder":
        want["forward"] = np.asarray(jax.jit(jax_lm.forward, static_argnums=1)(p_j, jcfg,
                                                                              lead)[0])
    else:
        cache = jax_lm.init_cache(jcfg, ROWS, MAX_SEQ)
        groups = dict(cache["groups"])
        for name, leaf in groups.items():
            if isinstance(leaf, dict):
                groups[name] = {k: leaf[k].at[:, :, :S].set(caches["groups"][name][k])
                                for k in leaf}
        cache = dict(cache, groups=groups)
        decode = jax.jit(jax_lm.decode_step, static_argnums=1)
        toks, want["decode"] = [want["prefill"].argmax(-1)], {}
        for pos in range(S, S + NEW - 1):
            lg, cache = decode(p_j, jcfg, jnp.asarray(toks[-1][:, None], jnp.int32), cache,
                               jnp.int32(pos), memory=x["memory"])
            want["decode"][pos] = np.asarray(lg)
            toks.append(want["decode"][pos].argmax(-1))
        want["tokens"] = np.stack(toks, 1)
    for name, (dp, tp) in MESHES.items():
        jmesh = JaxAbstractMesh((1, dp, tp), ("pod", "data", "model"))
        sizes = {"pod": 1, "data": dp, "model": tp}
        ps = jax_sharding.param_specs(jcfg, p_j, jmesh, fsdp=False)
        shapes = [_cut(p_j, ps, sizes), None]
        if jcfg.family != "encoder":
            cache = jax_lm.init_cache(jcfg, ROWS, MAX_SEQ)
            cs = jax_sharding.cache_specs(jcfg, cache, jmesh, shard_seq=False)
            shapes[1] = _cut(cache, cs, sizes)
        want["shapes"][name] = tuple(shapes)
    return want


def _reference_train(jcfg, p_j, pipe):
    """``TRAIN["total_steps"]`` steps of the reference Trainer's step body
    on :func:`batch_at`'s batches: (loss, grad norm) a step."""
    import jax
    import jax.numpy as jnp

    from repro import optim as jax_optim
    from repro.models import lm as jax_lm

    ocfg = jax_optim.AdamWConfig(**OPTIM)

    def train_step(params, opt_state, batch):
        loss_fn = lambda p, b: jax_lm.train_loss(p, jcfg, b)  # noqa: E731
        loss, grads, _ = jax_optim.accumulate_grads(loss_fn, params, batch,
                                                    TRAIN["microbatches"])
        new_params, new_opt, om = jax_optim.apply(ocfg, grads, opt_state, params)
        return new_params, new_opt, {"loss": loss, "grad_norm": om["grad_norm"]}

    step = jax.jit(train_step)
    params, opt, out = p_j, jax_optim.init(p_j), []
    for i in range(TRAIN["total_steps"]):
        batch = {k: jnp.asarray(v) for k, v in batch_at(pipe, jcfg, i).items()}
        params, opt, m = step(params, opt, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def _reference_grads(jcfg, p_j, batch, leaves):
    import jax
    import jax.numpy as jnp

    from repro.models import lm as jax_lm

    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(lambda p: jax_lm.train_loss(p, jcfg, batch)[0])(p_j)
    return float(loss), {k: np.asarray(v) for k, v in _flat(grads).items() if k.endswith(leaves)}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The reference's serving, training and gradients on each config,
    computed while the ranks run on its initial parameters (numpy, the
    gates open)."""
    import threading

    import jax

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.data import DataConfig as JaxDataConfig
    from repro.data import TokenPipeline as JaxTokenPipeline
    from repro.models import lm as jax_lm

    jcfgs = {key: _cfg(key, jax_smoke_config) for key in CONFIGS}
    p0s = {key: _open_gates(jax.tree.map(np.asarray, jax_lm.init_params(
        jcfg, jax.random.PRNGKey(0)))) for key, jcfg in jcfgs.items()}
    pipes = {key: JaxTokenPipeline(JaxDataConfig(global_batch=BATCH, **_data(jcfg)))
             for key, jcfg in jcfgs.items()}
    inputs = {key: _inputs(jcfgs[key]) for key in SERVED}
    grad_batches = {key: {k: v[:4] for k, v in batch_at(pipes[key], jcfgs[key], 5).items()}
                    for key in GRAD_LEAVES}
    got = {}

    def spawn():
        try:
            got["ranks"] = run_ranks(_ranks, 4, (p0s, inputs, grad_batches,
                                                 str(tmp_path_factory.mktemp("tp_cross"))),
                                     timeout_s=240)
        except BaseException as e:  # noqa: BLE001 - raised below
            got["ranks"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    p_js = {key: jax.tree.map(jax.numpy.asarray, p) for key, p in p0s.items()}
    out = {"serve": {key: _reference_serving(jcfgs[key], p_js[key], inputs[key])
                     for key in SERVED},
           "train": {key: _reference_train(jcfgs[key], p_js[key], pipes[key])
                     for key in TRAINED},
           "grads": {key: _reference_grads(jcfgs[key], p_js[key], grad_batches[key],
                                           GRAD_LEAVES[key]) for key in GRAD_LEAVES}}
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


def _gap(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


# -- serving ----------------------------------------------------------------------

@pytest.mark.parametrize("key", SERVED)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_prefill_decode_and_forward_logits_match_the_reference(reference, ranks, mesh, key):
    want = reference["serve"][key]
    members = _members(ranks, mesh)
    dp, tp = MESHES[mesh]
    assert len(members) == dp * tp
    for r in members:
        got = r["serve"][mesh, key]
        assert got["model_shard"]
        rows = slice(r["coord", mesh][0] * ROWS // dp, (r["coord", mesh][0] + 1) * ROWS // dp)
        assert _gap(got["prefill"], want["prefill"][rows]) <= LOGIT_GAP
        if key == "hubert":
            assert _gap(got["forward"], want["forward"][rows]) <= LOGIT_GAP
            continue
        np.testing.assert_array_equal(got["tokens"], want["tokens"][rows])
        assert got["decode"].keys() == want["decode"].keys()
        for pos, lg in got["decode"].items():
            assert _gap(lg, want["decode"][pos][rows]) <= LOGIT_GAP, pos


@pytest.mark.parametrize("key", SERVED)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_per_rank_shapes_are_the_reference_specs_blocks(reference, ranks, mesh, key):
    want_p, want_c = reference["serve"][key]["shapes"][mesh]
    for r in _members(ranks, mesh):
        got = r["serve"][mesh, key]
        assert got["param_shapes"] == want_p
        assert got.get("cache_shapes") == want_c
        assert got["draw_local_equal"]
    if key == "llama":
        # the cross block cut by heads; its gate and norms whole
        assert want_p["groups/b4_cross/cross/wk"] == (2, 48, 16)
        assert want_p["groups/b4_cross/cross/wo"] == (2, 32, 64)
        assert want_p["groups/b4_cross/cross/gate"] == (2, 1)
    else:
        assert want_p["embed/proj"] == (24, 64) and want_p["head/w"] == (64, 16)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_draw_local_is_the_cut_of_the_whole_draw(ranks, arch):
    """Every registered arch's smoke config: a rank's leaves drawn and cut
    one by one hold the values of the whole seeded draw's cut, on both
    ranks of (1, 1, 2)."""
    for r in ranks[:2]:
        assert r["draw_local"][arch]


def test_a_closed_gate_hides_a_wrong_cross_head_order(reference, ranks):
    """``cross/wk``'s KV heads rolled by one: with the gates open the
    prefill misses the bar; closed, the logits do not move at all."""
    want = reference["serve"]["llama"]["prefill"]
    for r in _members(ranks, "1x1x2"):
        right, wrong = r["mutation"]["open"]
        assert _gap(right, want) <= LOGIT_GAP
        assert _gap(wrong, want) > 100 * LOGIT_GAP
        closed, closed_wrong = r["mutation"]["closed"]
        np.testing.assert_array_equal(closed, closed_wrong)


# -- training ---------------------------------------------------------------------

@pytest.mark.parametrize("key", TRAINED)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_trained_losses_and_grad_norms_match_the_reference(reference, ranks, mesh, key):
    want = np.array(reference["train"][key])
    members = _members(ranks, mesh)
    assert len(members) == MESHES[mesh][0] * MESHES[mesh][1]
    for r in members:
        run = r["train"][mesh, key]
        assert run["model_shard"]
        got = np.array(run["metrics"])
        assert got.shape == want.shape == (TRAIN["total_steps"], 2)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        np.testing.assert_allclose(got[1:], want[1:], rtol=1e-4)
        assert run["metrics"] == members[0]["train"][mesh, key]["metrics"]


@pytest.mark.parametrize("key", TRAINED)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_a_step_gathers_nothing_over_model_and_keeps_replicas_equal(ranks, mesh, key):
    dp = MESHES[mesh][0]
    replicated = {"llama": "cross/gate", "hubert": "embed/proj"}[key]
    by_shard = {}
    for r in _members(ranks, mesh):
        steps = r["train"][mesh, key]["steps"]
        for counts, _ in steps:
            assert "gather_exact" not in counts, counts
            assert ("gather_data" in counts) == (dp > 1), counts
        by_shard.setdefault(r["coord", mesh][0], []).append(steps)
    for shard, runs in by_shard.items():
        assert len(runs) == MESHES[mesh][1]
        for step in range(TRAIN["total_steps"]):
            digests = [steps[step][1] for steps in runs]
            assert any(replicated in k for k in digests[0]), digests[0].keys()
            assert all(d == digests[0] for d in digests), (shard, step)


@pytest.mark.parametrize("key", list(GRAD_LEAVES))
def test_replicated_gradients_match_the_reference(reference, ranks, key):
    """The gate's gradient whole (it scales the output summed over
    ``model``), the q/k norms' summed over ``model``, ``embed/proj``'s
    whole; hubert-v33's head whole and its loss counted once."""
    want_loss, want = reference["grads"][key]
    assert want.keys() and all(any(k.endswith(leaf) for k in want) for leaf in GRAD_LEAVES[key])
    for r in ranks[:2]:
        loss, got = r["grads"][key]
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
        assert got.keys() == want.keys()
        for k, g in got.items():
            assert g.shape == want[k].shape, k
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


def test_the_production_meshes_cut_hubert_whole_heads_and_llama_not():
    """hubert computes on its shard at tp = 2 and 16 (16/16 heads; at 16 its
    504-row head stays whole, as hubert-v33's does above); llama too, in
    whole heads at tp = 2 and at 16 with its 8 KV heads cut into half a
    head a rank (``wk``'s 1024 columns into 64: joined whole,
    ``tests/test_torch_tp_heads.py``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import AXES, AbstractMesh
    from repro_torch.parallel.sharding import (
        computes_on_model_shard,
        model_shard_refusal,
        param_specs,
    )
    from repro_torch.parallel.zero import param_shapes

    hubert, llama = get_config(HUBERT), get_config(LLAMA)
    assert model_shard_refusal(hubert) is None and model_shard_refusal(llama) is None
    for tp, h_ok, l_ok in ((2, True, True), (16, True, True)):
        mesh = AbstractMesh((1, 16, tp), AXES)
        assert computes_on_model_shard(hubert, mesh) is h_ok
        assert computes_on_model_shard(llama, mesh) is l_ok
    specs = param_specs(hubert, param_shapes(hubert), AbstractMesh((1, 16, 16), AXES))
    assert specs["head"]["w"] == ("data", None)
    assert specs["groups"]["b0_attn"]["attn"]["wq"] == (None, "data", "model")
    lspecs = param_specs(llama, param_shapes(llama), AbstractMesh((1, 16, 16), AXES))
    assert lspecs["groups"]["b0_attn"]["attn"]["wk"] == (None, "data", "model")
