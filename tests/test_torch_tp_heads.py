"""Attention whose heads do not cut whole, on the model shard: the serving,
prefill/decode and train steps at tp = 4 on four gloo CPU ranks
(1, 1, 4), against the reference's unsharded computation on bridged
weights.

At tp = 4 the smoke configs' heads (hd 16) cut as internlm2-20b's and
llama-3.2-vision-90b's 8 KV heads of 128 do over 16 ranks: the rules cut
``wk``/``wv`` into half a KV head a rank, and ``cache_specs``' guard keeps
the cache's KV axis whole.  A rank joins the columns whole exactly before
RoPE and the norms, writes every KV head into its cache, and attends with
the query heads that cover its ``wo`` rows.

CONFIGS — llama: llama-3.2-vision-90b's smoke config (4 query and 2 KV
          heads: 1 query head and half a KV head a rank; four ``attn``
          blocks and a ``cross`` block, its gate opened to 0.5 on the numpy
          tree); internlm2: internlm2-20b's (6 and 2: 1.5 query heads and
          half a KV head); internlm2-h8: with ``n_heads = 8`` (2 whole query
          heads and half a KV head: the full width's case).
SERVING — internlm2's through ``DecodeServer(plan=)`` under ``step()`` and
          chunked prefill, llama's through ``make_prefill_step`` and
          ``make_serve_step(mesh=)``: prefill and decode logits, joined over
          ``model``, within 1e-5 of max |logit| of the reference's, and the
          greedy tokens equal; the caches (every leaf replicated along
          ``model`` here) bit-identical across the ranks after every
          prefill, chunk and decode call.
SHAPES  — each rank's parameter and cache leaves the blocks of the
          reference's ``param_specs(fsdp=False)`` and ``cache_specs``.
TRAINING — three ``Trainer(mesh=)`` steps: step 0 within 1e-5 of the
          reference's train step, later steps within 1e-4, on the model
          shard, no parameter gathered over ``model`` (the K/V joins are the
          only gathers), the replicated leaves bit-identical across the
          ranks after every step.
GRADIENTS — ``attn/wk``, ``attn/wv`` and ``cross/wk`` (and ``wq``, ``wo``)
          on each rank against its block of ``jax.grad`` of the reference's
          ``train_loss`` at 1e-5: a backward that kept only this rank's part
          of a joined head's gradient would miss it.
MUTATION — the two halves of one KV head's ``wk`` columns swapped before
          the cut: the prefill logits miss the 1e-5 bar.

The reference runs in the parent while the ranks (``launch.spawn``) run;
they import no JAX.
"""

import dataclasses
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.launch.spawn import run_ranks  # noqa: E402

TP = 4
# (arch, replaced fields)
CONFIGS = {"llama": ("llama-3.2-vision-90b", {}),
           "internlm2": ("internlm2-20b", {}),
           "internlm2-h8": ("internlm2-20b", {"n_heads": 8})}
SERVED = ("internlm2", "internlm2-h8")      # through DecodeServer(plan=)
PROMPTS = [(7, 0), (12, 1), (3, 2)]         # (length, seed)
NEW = 4
SLOTS, MAX_SEQ = 4, 24
DRIVERS = {"step": {}, "chunk": {"prefill_chunk": 4}}
ROWS, S = 2, 12                             # llama's prefill rows
GATE = 0.5
LOGIT_GAP = 1e-5
GRAD_GAP = 1e-5
TRAIN = dict(total_steps=3, ckpt_every=0, log_every=1, ckpt_async=False, microbatches=1)
OPTIM = dict(lr_peak=3e-3, warmup_steps=2, total_steps=10)
BATCH, SEQ = 8, 16
GRAD_LEAVES = ("attn/wk", "attn/wv", "attn/wq", "attn/wo", "cross/wk", "cross/wv")
MUTATED = "internlm2"


def _cfg(key, smoke_config):
    arch, fields = CONFIGS[key]
    return dataclasses.replace(smoke_config(arch), **fields)


def _open_gates(p_np):
    """``p_np`` with every cross block's gate at :data:`GATE` (a copy)."""
    if "b4_cross" not in p_np["groups"]:
        return p_np
    groups = dict(p_np["groups"])
    blk = dict(groups["b4_cross"])
    blk["cross"] = dict(blk["cross"], gate=np.full_like(blk["cross"]["gate"], GATE))
    groups["b4_cross"] = blk
    return dict(p_np, groups=groups)


def _swap_halves(p_np):
    """``p_np`` with the two halves of KV head 0's ``wk`` columns swapped in
    every layer (a copy)."""
    groups = {k: dict(v) for k, v in p_np["groups"].items()}
    wk = groups["b0_attn"]["attn"]["wk"].copy()
    half = wk.shape[-1] // 4          # 2 KV heads: a head is half the columns
    wk[..., :half], wk[..., half:2 * half] = wk[..., half:2 * half].copy(), wk[..., :half].copy()
    groups["b0_attn"] = dict(groups["b0_attn"], attn=dict(groups["b0_attn"]["attn"], wk=wk))
    return dict(p_np, groups=groups)


def _prompt(n, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(1, 256, n)]


def _memory(cfg, rows, seed):
    return np.random.default_rng(seed).standard_normal(
        (rows, cfg.frontend_tokens, cfg.frontend_dim), dtype=np.float32)


def _inputs(cfg):
    rng = np.random.default_rng(11)
    return {"tokens": rng.integers(0, cfg.vocab, size=(ROWS, S)).astype(np.int32),
            "memory": _memory(cfg, ROWS, 12)}


def batch_at(pipe, cfg, step):
    """The pipeline's global batch at ``step``; a VLM's with a memory drawn
    from numpy with the step as seed."""
    b = pipe.global_batch_at(step)
    if cfg.family != "vlm":
        return b
    return b | {"memory": _memory(cfg, b["tokens"].shape[0], 100 + step)}


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


def _digest(tree):
    h = hashlib.sha256()
    for k, v in sorted(_flat(tree).items()):
        h.update(k.encode())
        h.update(np.ascontiguousarray(v.detach().numpy()).tobytes())
    return h.hexdigest()


# -- the ranks ----------------------------------------------------------------

def _serve(cfg, params, plan, **kw):
    """The prompts through ``DecodeServer(plan=)``: tokens by uid, prefill
    logits by uid, decode logits by (uid, position), the caches' digest
    after every model call, the server."""
    from repro_torch.models import lm
    from repro_torch.parallel import tensor_parallel as tp
    from repro_torch.runtime import DecodeServer, Request

    srv = DecodeServer(cfg, params, num_slots=SLOTS, max_seq=MAX_SEQ, plan=plan, device="cpu",
                       **kw)
    pre, dec, digests = {}, {}, []
    by_prompt = {tuple(p): i for i, p in enumerate(_prompt(*q) for q in PROMPTS)}
    inner = lm.prefill, lm.prefill_chunk, lm.decode_step

    def prefill(p, c, tokens, **k):
        out = inner[0](p, c, tokens, **k)
        pre[by_prompt[tuple(tokens[0].tolist())]] = tp.join_vocab(out[0], c.vocab)[0].numpy()
        digests.append(_digest(out[1]))
        return out

    def chunk(p, c, tokens, caches, pos, **k):
        out = inner[1](p, c, tokens, caches, pos, **k)
        digests.append(_digest(out[1]))
        return out

    def decode(p, c, tokens, caches, pos, **k):
        out = inner[2](p, c, tokens, caches, pos, **k)
        full = tp.join_vocab(out[0], c.vocab).numpy()
        for b in range(SLOTS):
            if srv.slot_req[b] is not None:
                dec.setdefault((srv.slot_req[b].uid, int(pos.reshape(-1)[b])), full[b].copy())
        digests.append(_digest(out[1]))
        return out

    lm.prefill, lm.prefill_chunk, lm.decode_step = prefill, chunk, decode
    try:
        for uid, q in enumerate(PROMPTS):
            srv.submit(Request(uid=uid, prompt=_prompt(*q), max_new_tokens=NEW))
        srv.run_until_drained()
    finally:
        lm.prefill, lm.prefill_chunk, lm.decode_step = inner
    toks = {r.uid: list(r.out_tokens) for r in srv.completed}
    return {"tokens": toks, "pre": pre, "dec": dec, "digests": digests,
            "param_shapes": {k: tuple(v.shape) for k, v in _flat(srv.params).items()},
            "cache_shapes": {k: tuple(v.shape) for k, v in _flat(srv.caches).items()}}


def _prefill_decode(cfg, p_full, mesh, inputs):
    """llama's prefill and greedy decode through the step functions on
    this rank's shards: logits joined over ``model``, the tokens, the
    caches' digest after every call, the shapes."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import lm
    from repro_torch.parallel import tensor_parallel as tp
    from repro_torch.parallel import zero
    from repro_torch.parallel.sharding import model_shard
    from repro_torch.runtime import ShardPlan

    shards = zero.param_layout(cfg, mesh).shard(p_full)
    rows = {k: torch.from_numpy(v) for k, v in inputs.items()}
    prefill, serve = make_prefill_step(cfg, mesh), make_serve_step(cfg, mesh)
    out = {"model_shard": prefill.model_shard and serve.model_shard, "decode": {},
           "digests": []}
    with torch.no_grad(), model_shard(mesh):
        lg, caches = prefill(shards, rows)
        out["prefill"] = tp.join_vocab(lg, cfg.vocab).numpy()
        out["digests"].append(_digest(caches))
        dcache = lm.init_cache(cfg, ROWS, MAX_SEQ, "cpu")
        for name, leaf in dcache["groups"].items():
            if isinstance(leaf, dict):
                for k in ("k", "v"):
                    leaf[k][:, :, :S] = caches["groups"][name][k]
        out["cache_shapes"] = {k: tuple(v.shape) for k, v in _flat(dcache).items()}
        toks = [out["prefill"].argmax(-1)]
        for pos in range(S, S + NEW - 1):
            step_in = {"tokens": torch.from_numpy(toks[-1][:, None].astype(np.int32)),
                       "memory": rows["memory"]}
            lg, dcache = serve(shards, step_in, dcache, pos)
            out["decode"][pos] = tp.join_vocab(lg, cfg.vocab).numpy()
            out["digests"].append(_digest(dcache))
            toks.append(out["decode"][pos].argmax(-1))
        out["tokens"] = np.stack(toks, 1)
    out["param_shapes"] = {k: tuple(v.shape)
                           for k, v in _flat(ShardPlan(mesh).local_params(cfg, p_full)).items()}
    return out


def _mutated_prefill(cfg, p_full, mesh, inputs):
    """The prefill's logits, joined over ``model``, of ``p_full``."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.parallel import tensor_parallel as tp
    from repro_torch.parallel import zero
    from repro_torch.parallel.sharding import model_shard

    prefill = make_prefill_step(cfg, mesh)
    with torch.no_grad(), model_shard(mesh):
        lg, _ = prefill(zero.param_layout(cfg, mesh).shard(p_full),
                        {"tokens": torch.from_numpy(inputs["tokens"])})
        return tp.join_vocab(lg, cfg.vocab).numpy()


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


def _train(key, p0, mesh, tmp):
    from repro_torch import bridge, optim
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.parallel import comm
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = _cfg(key, get_smoke_config)
    t = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp), **TRAIN), optim.AdamWConfig(**OPTIM),
                DataConfig(global_batch=BATCH, **_data(cfg)), mesh, device="cpu")
    t.data = _Batches(t.data, cfg)
    t.load_full(bridge.params_from_jax(p0, cfg, "cpu"))
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
    return {"metrics": [(m["loss"], m["grad_norm"]) for m in res["metrics"]],
            "steps": steps, "model_shard": inner.model_shard}


def _grads(cfg, p_full, plan, batch):
    """``train_loss`` and its gradients of :data:`GRAD_LEAVES` on this
    rank's model shard."""
    from repro_torch._tree import tree_map
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import model_shard

    p = tree_map(lambda t: t.clone().requires_grad_(True), plan.local_params(cfg, p_full))
    with model_shard(plan.mesh):
        loss, _ = lm.train_loss(p, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return float(loss.detach()), {k: v.grad.numpy().copy() for k, v in _flat(p).items()
                                  if k.endswith(GRAD_LEAVES)}


def _ranks(rank, world, p0s, inputs, grad_batches, tmp):
    import sys

    from repro_torch import bridge
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_local_mesh, model_index
    from repro_torch.runtime import ShardPlan

    torch.set_num_threads(1)
    mesh = make_local_mesh(1, world)
    plan = ShardPlan(mesh)
    out = {"index": model_index(mesh), "serve": {}, "train": {}, "grads": {}}
    for key in CONFIGS:
        cfg = _cfg(key, get_smoke_config)
        p_full = bridge.params_from_jax(p0s[key], cfg, "cpu")
        if key in SERVED:
            for drv, kw in DRIVERS.items():
                out["serve"][key, drv] = _serve(cfg, p_full, plan, **kw)
        else:
            out["serve"][key, "steps"] = _prefill_decode(cfg, p_full, mesh, inputs[key])
        out["grads"][key] = _grads(cfg, p_full, plan, grad_batches[key])
        out["train"][key] = _train(key, p0s[key], mesh, f"{tmp}/{key}")
    cfg = _cfg(MUTATED, get_smoke_config)
    out["mutation"] = [_mutated_prefill(cfg, bridge.params_from_jax(p, cfg, "cpu"), mesh,
                                        inputs[MUTATED])
                       for p in (p0s[MUTATED], _swap_halves(p0s[MUTATED]))]
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


def _reference_shapes(jcfg, p_j, batch):
    import jax.numpy as jnp  # noqa: F401 - jax is configured by the caller
    from jax.sharding import AbstractMesh as JaxAbstractMesh

    from repro.models import lm as jax_lm
    from repro.parallel import sharding as jax_sharding

    jmesh = JaxAbstractMesh((1, 1, TP), ("pod", "data", "model"))
    sizes = {"pod": 1, "data": 1, "model": TP}
    cache = jax_lm.init_cache(jcfg, batch, MAX_SEQ)
    return (_cut(p_j, jax_sharding.param_specs(jcfg, p_j, jmesh, fsdp=False), sizes),
            _cut(cache, jax_sharding.cache_specs(jcfg, cache, jmesh, shard_seq=False), sizes))


def _reference_served(jcfg, p_j):
    """Each prompt's one-shot prefill logits, greedy tokens and decode
    logits by (uid, position)."""
    import jax
    import jax.numpy as jnp

    from repro.models import lm as jax_lm

    prefill = jax.jit(jax_lm.prefill, static_argnums=1)
    chunk = jax.jit(jax_lm.prefill_chunk, static_argnums=1)
    decode = jax.jit(jax_lm.decode_step, static_argnums=1)
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
    want["shapes"] = _reference_shapes(jcfg, p_j, SLOTS)
    return want


def _reference_steps(jcfg, p_j, inputs):
    """llama's prefill logits, its greedy decode logits by position and
    tokens from the prefill's cache."""
    import jax
    import jax.numpy as jnp

    from repro.models import lm as jax_lm

    x = {k: jnp.asarray(v) for k, v in inputs.items()}
    lg, caches = jax.jit(jax_lm.prefill, static_argnums=1)(p_j, jcfg, x["tokens"],
                                                           memory=x["memory"])
    want = {"prefill": np.asarray(lg), "decode": {}}
    cache = jax_lm.init_cache(jcfg, ROWS, MAX_SEQ)
    groups = dict(cache["groups"])
    for name, leaf in groups.items():
        if isinstance(leaf, dict):
            groups[name] = {k: leaf[k].at[:, :, :S].set(caches["groups"][name][k]) for k in leaf}
    cache = dict(cache, groups=groups)
    decode = jax.jit(jax_lm.decode_step, static_argnums=1)
    toks = [want["prefill"].argmax(-1)]
    for pos in range(S, S + NEW - 1):
        lg, cache = decode(p_j, jcfg, jnp.asarray(toks[-1][:, None], jnp.int32), cache,
                           jnp.int32(pos), memory=x["memory"])
        want["decode"][pos] = np.asarray(lg)
        toks.append(want["decode"][pos].argmax(-1))
    want["tokens"] = np.stack(toks, 1)
    want["shapes"] = _reference_shapes(jcfg, p_j, ROWS)
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


def _reference_grads(jcfg, p_j, batch):
    import jax
    import jax.numpy as jnp

    from repro.models import lm as jax_lm

    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(lambda p: jax_lm.train_loss(p, jcfg, batch)[0])(p_j)
    return float(loss), {k: np.asarray(v) for k, v in _flat(grads).items()
                         if k.endswith(GRAD_LEAVES)}


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
    inputs = {key: _inputs(jcfgs[key]) for key in CONFIGS}
    grad_batches = {key: {k: v[:4] for k, v in batch_at(pipes[key], jcfgs[key], 5).items()}
                    for key in CONFIGS}
    got = {}

    def spawn():
        try:
            got["ranks"] = run_ranks(_ranks, TP, (p0s, inputs, grad_batches,
                                                  str(tmp_path_factory.mktemp("tp_heads"))),
                                     timeout_s=240)
        except BaseException as e:  # noqa: BLE001 - raised below
            got["ranks"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    p_js = {key: jax.tree.map(jax.numpy.asarray, p) for key, p in p0s.items()}
    out = {"serve": {key: (_reference_served if key in SERVED else _reference_steps)(
               jcfgs[key], p_js[key], *(() if key in SERVED else (inputs[key],)))
               for key in CONFIGS},
           "train": {key: _reference_train(jcfgs[key], p_js[key], pipes[key])
                     for key in CONFIGS},
           "grads": {key: _reference_grads(jcfgs[key], p_js[key], grad_batches[key])
                     for key in CONFIGS},
           "mutation": np.asarray(jax.jit(jax_lm.prefill, static_argnums=1)(
               p_js[MUTATED], jcfgs[MUTATED], jax.numpy.asarray(inputs[MUTATED]["tokens"]))[0])}
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


def _gap(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


# -- the rule's pieces ----------------------------------------------------------

def test_the_smoke_configs_cut_part_of_a_head_at_tp4():
    """Each config computes on its model shard at tp = 4 with ``wk``'s
    columns half a KV head a rank, as internlm2-20b's and llama's do at
    tp = 16 (and the query heads 1, 1.5 and 2 a rank)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.mesh import AXES, AbstractMesh
    from repro_torch.parallel.sharding import computes_on_model_shard

    for key in CONFIGS:
        cfg = _cfg(key, get_smoke_config)
        assert computes_on_model_shard(cfg, AbstractMesh((1, 1, TP), AXES))
        assert cfg.n_kv_heads * cfg.head_dim // TP == cfg.head_dim // 2
    for arch in ("internlm2-20b", "llama-3.2-vision-90b"):
        cfg = get_config(arch)
        for shape in ((1, 16, 16), (2, 16, 16)):
            assert computes_on_model_shard(cfg, AbstractMesh(shape, AXES)), (arch, shape)
        assert cfg.n_kv_heads * cfg.head_dim // 16 == cfg.head_dim // 2


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_no_config_of_the_production_mesh_is_refused_for_its_heads(arch):
    """On 16×16 and 2×16×16 a config computes on its model shard exactly
    when its family does (``model_shard_refusal``): no attention cut is
    refused, whatever part of a head a rank's columns hold."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import AXES, AbstractMesh
    from repro_torch.parallel.sharding import computes_on_model_shard, model_shard_refusal

    cfg = get_config(arch)
    for shape in ((1, 16, 16), (2, 16, 16)):
        assert computes_on_model_shard(cfg, AbstractMesh(shape, AXES)) is (
            model_shard_refusal(cfg) is None), shape


@pytest.mark.parametrize("H,KV,tp", [(48, 8, 16), (64, 8, 16), (6, 2, 4), (8, 2, 4),
                                     (4, 2, 4), (9, 3, 2), (9, 3, 16)])
def test_query_heads_and_the_kv_heads_they_read(H, KV, tp):
    """Every rank's query heads cover its ``wo`` rows; the KV heads listed
    give each of those query heads the KV head ``h // (H/KV)`` under the
    attention core's map (local head ``j`` reads entry ``j // (Hq/len)``)."""
    from repro_torch.parallel import tensor_parallel as tp_lib

    hd = 16
    cols = H * hd // tp
    for index in range(tp):
        h0, h1, off = tp_lib.query_heads(index, cols, hd)
        assert h0 * hd + off == index * cols and (h1 - 1) * hd < (index + 1) * cols <= h1 * hd
        read = tp_lib.kv_heads(h0, h1, H, KV)
        per = (h1 - h0) // len(read)
        assert per * len(read) == h1 - h0
        for j in range(h1 - h0):
            assert read[j // per] == (h0 + j) // (H // KV), (index, j, read)


# -- serving ----------------------------------------------------------------------

@pytest.mark.parametrize("drv", list(DRIVERS))
@pytest.mark.parametrize("key", SERVED)
def test_served_tokens_and_logits_match_the_reference(reference, ranks, key, drv):
    want = reference["serve"][key]
    assert len(ranks) == TP
    decodes = 0
    for r in ranks:
        got = r["serve"][key, drv]
        assert got["tokens"] == want["toks"]
        for uid, lg in got["pre"].items():
            assert _gap(lg, want["pre"][uid]) <= LOGIT_GAP, uid
        for k, lg in got["dec"].items():
            if k in want["dec"]:
                assert _gap(lg, want["dec"][k]) <= LOGIT_GAP, k
                decodes += 1
        assert len(got["pre"]) == (len(PROMPTS) if drv == "step" else 0)
    assert decodes >= TP * len(PROMPTS) * (NEW - 1)


def test_llama_prefill_and_decode_match_the_reference(reference, ranks):
    want = reference["serve"]["llama"]
    for r in ranks:
        got = r["serve"]["llama", "steps"]
        assert got["model_shard"]
        assert _gap(got["prefill"], want["prefill"]) <= LOGIT_GAP
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        assert got["decode"].keys() == want["decode"].keys()
        for pos, lg in got["decode"].items():
            assert _gap(lg, want["decode"][pos]) <= LOGIT_GAP, pos


@pytest.mark.parametrize("run", [(k, d) for k in SERVED for d in DRIVERS] + [("llama", "steps")],
                         ids=lambda r: "-".join(r))
def test_replicated_caches_are_bit_identical_across_the_ranks(ranks, run):
    digests = [r["serve"][run]["digests"] for r in ranks]
    assert len(digests[0]) >= NEW          # a prefill and NEW - 1 decode calls at least
    assert all(d == digests[0] for d in digests)


@pytest.mark.parametrize("key", list(CONFIGS))
def test_per_rank_shapes_are_the_reference_specs_blocks(reference, ranks, key):
    want_p, want_c = reference["serve"][key]["shapes"]
    run = (key, "step") if key in SERVED else (key, "steps")
    for r in ranks:
        got = r["serve"][run]
        assert got["param_shapes"] == want_p
        assert got["cache_shapes"] == want_c
    # half a KV head of wk a rank; the cache's KV heads whole
    assert want_p["groups/b0_attn/attn/wk"][-1] == 8
    assert want_c["groups/b0_attn/k"][-2] == 2


def test_a_half_head_swap_misses_the_bar(reference, ranks):
    """The halves of KV head 0's ``wk`` columns swapped before the cut (each
    rank then holds the other rank's half): the prefill misses the bar,
    where the unmutated one meets it."""
    want = reference["mutation"]
    for r in ranks:
        right, wrong = r["mutation"]
        assert _gap(right, want) <= LOGIT_GAP
        assert _gap(wrong, want) > 100 * LOGIT_GAP


# -- training ---------------------------------------------------------------------

@pytest.mark.parametrize("key", list(CONFIGS))
def test_trained_losses_and_grad_norms_match_the_reference(reference, ranks, key):
    want = np.array(reference["train"][key])
    for r in ranks:
        run = r["train"][key]
        assert run["model_shard"]
        got = np.array(run["metrics"])
        assert got.shape == want.shape == (TRAIN["total_steps"], 2)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        np.testing.assert_allclose(got[1:], want[1:], rtol=1e-4)
        assert run["metrics"] == ranks[0]["train"][key]["metrics"]


@pytest.mark.parametrize("key", list(CONFIGS))
def test_a_step_joins_only_kv_columns_and_keeps_replicas_equal(ranks, key):
    for r in ranks:
        for counts, _ in r["train"][key]["steps"]:
            assert sorted(k for k in counts if k.startswith("gather")) == ["gather_heads"]
    for step in range(TRAIN["total_steps"]):
        digests = [r["train"][key]["steps"][step][1] for r in ranks]
        assert any("norm" in k for k in digests[0]), digests[0].keys()
        assert all(d == digests[0] for d in digests), step


@pytest.mark.parametrize("key", list(CONFIGS))
def test_projection_gradients_match_the_reference_blocks(reference, ranks, key):
    """Each rank's gradient of ``wq``, ``wk``, ``wv`` (cross blocks' too)
    and ``wo`` is its block of the reference's: the columns of the
    projections, the rows of ``wo``."""
    want_loss, want = reference["grads"][key]
    assert any(k.endswith("attn/wk") for k in want)
    assert (key == "llama") == any(k.endswith("cross/wk") for k in want)
    for r in ranks:
        loss, got = r["grads"][key]
        i = r["index"]
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
        assert got.keys() == want.keys()
        for k, g in got.items():
            d = -2 if k.endswith("/wo") else -1
            n = g.shape[d]
            block = np.take(want[k], range(i * n, (i + 1) * n), axis=d)
            assert g.shape == block.shape, k
            assert np.max(np.abs(g - block)) <= GRAD_GAP * np.max(np.abs(want[k])), k
    assert not any(r["jax"] for r in ranks)
