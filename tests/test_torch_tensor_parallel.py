"""``parallel.tensor_parallel`` on two gloo CPU ranks against the unsharded
torch computation.

Each op of the module runs on a (1, 1, 2) mesh inside the model-shard
context, on the two halves of the same seeded tensors, and is held to the
computation on the whole tensors, forward and gradient:

* ``copy_to_model`` → a column-parallel product → ``reduce_from_model``
  (the Megatron pair) against the whole product;
* the vocab-parallel embedding lookup, bit for bit, and its table
  gradient;
* the vocab-parallel head (tied and untied) and ``join_vocab``, bit for
  bit against the whole head's columns;
* ``lse_and_gold`` against ``torch.logsumexp`` and the label's logit, and
  ``lm.train_loss``'s CE and z-loss on the internlm2 and gemma3 smoke
  models' model shards against their unsharded ``train_loss``, with every
  gradient leaf;
* an argmax tie placed across the shard boundary resolves to the lower
  index, as ``np.argmax`` does.

Outside the context every op is the plain computation and counts no
collective.  The ranks (``launch.spawn``) import no JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.spawn import run_ranks  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
V, D, B, S = 32, 8, 3, 5
# internlm2: heads and vocab cut; gemma3: qk-norm scales replicated on a
# rank's heads, and its tail block's output columns joined
LM_ARCHS = ("internlm2-20b", "gemma3-27b")


def _data():
    g = np.random.default_rng(0)
    return {"x": g.standard_normal((B, S, D)).astype(np.float32),
            "w": g.standard_normal((D, 12)).astype(np.float32),
            "w2": g.standard_normal((12, D)).astype(np.float32),
            "table": g.standard_normal((V, D)).astype(np.float32),
            "head": g.standard_normal((D, V)).astype(np.float32),
            "ids": g.integers(0, V, (B, S)),
            "labels": np.where(g.random((B, S)) < 0.2, -1, g.integers(0, V, (B, S)))}


def _ops(d, cut):
    """The ops' forward values and gradients; ``cut(t, dim)`` gives this
    rank's block of a whole tensor (the identity for the plain run)."""
    from repro_torch.parallel import tensor_parallel as tp

    t = {k: torch.tensor(v) for k, v in d.items()}
    out = {}
    x = t["x"].clone().requires_grad_(True)
    w, w2 = cut(t["w"], 1).requires_grad_(True), cut(t["w2"], 0).requires_grad_(True)
    y = tp.reduce_from_model(torch.tanh(tp.copy_to_model(x) @ w) @ w2)
    (y * torch.arange(D, dtype=torch.float32)).sum().backward()
    out["mlp"], out["mlp_dx"] = y.detach(), x.grad
    out["mlp_dw"], out["mlp_dw2"] = w.grad, w2.grad

    table = cut(t["table"], 0).requires_grad_(True)
    e = tp.embed_lookup(table, t["ids"], V)
    (e * torch.arange(D, dtype=torch.float32)).sum().backward()
    out["embed"], out["embed_dtable"] = e.detach(), table.grad

    h = t["x"].clone().requires_grad_(True)
    head = cut(t["head"], 1).requires_grad_(True)
    tied = cut(t["table"], 0)
    out["tied"] = tp.join_vocab(tp.vocab_logits(t["x"], tied, V, tied=True), V)
    logits = tp.vocab_logits(h, head, V, tied=False)
    out["logits"] = tp.join_vocab(logits, V)
    lse, gold = tp.lse_and_gold(logits, t["labels"], V)
    (lse.square().sum() - 3 * gold.sum()).backward()
    out["lse"], out["gold"] = lse.detach(), gold.detach()
    out["ce_dh"], out["ce_dhead"] = h.grad, head.grad
    return {k: v.detach().numpy() for k, v in out.items()}


def _train_loss(cfg, params, batch):
    from repro_torch.models import lm
    from repro_torch.optim.adamw import value_and_grad

    (loss, m), grads = value_and_grad(lambda p, b: lm.train_loss(p, cfg, b), params, batch)
    return float(loss), float(m["ce"]), float(m["z_loss"]), grads


def _ranks(rank, world, d, batch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.parallel import comm
    from repro_torch.parallel import tensor_parallel as tp
    from repro_torch.parallel.sharding import model_shard, param_specs
    from repro_torch.parallel.zero import ShardLayout
    from repro_torch.checkpoint.checkpoint import flatten_with_names

    mesh = make_local_mesh(1, 2)

    def cut(t, dim):
        n = t.shape[dim] // 2
        return t.narrow(dim, rank * n, n).clone()

    out = {}
    comm.reset_counts()
    out["plain"] = _ops(d, lambda t, dim: t.clone())
    out["plain_counts"] = comm.counters()
    with model_shard(mesh):
        out["sharded"] = _ops(d, cut)
        # an argmax tie across the boundary: the same max at id 3 (rank 0)
        # and id V/2 + 1 (rank 1)
        row = torch.full((1, V // 2), -1.0)
        row[0, 3 if rank == 0 else 1] = 7.0
        out["tie"] = int(torch.argmax(tp.join_vocab(row, V)))
        out["tie_np"] = int(np.argmax(tp.join_vocab(row, V).numpy()))

    tb = {k: torch.tensor(v) for k, v in batch.items()}
    for arch in LM_ARCHS:
        cfg = get_smoke_config(arch)
        params = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        *plain, grads_plain = _train_loss(cfg, params, tb)
        layout = ShardLayout(mesh, param_specs(cfg, params, mesh, fsdp=False))
        with model_shard(mesh):
            *sharded, grads = _train_loss(cfg, layout.shard(params), tb)
        out[arch] = (plain, sharded, flatten_with_names(grads_plain),
                     flatten_with_names(layout.gather(grads)))
    return out


@pytest.fixture(scope="module")
def ranks():
    g = np.random.default_rng(1)
    batch = {"tokens": g.integers(0, 256, (2, 12)),
             "labels": np.where(g.random((2, 12)) < 0.2, -1, g.integers(0, 256, (2, 12)))}
    return run_ranks(_ranks, 2, (_data(), batch), timeout_s=120)


def _whole(name, parts, dim):
    return np.concatenate(parts, axis=dim) if dim is not None else parts[0]


# (key, dim along which the ranks' results join; None: each rank holds it whole)
OPS = [("mlp", None), ("mlp_dx", None), ("mlp_dw", 1), ("mlp_dw2", 0), ("embed", None),
       ("embed_dtable", 0), ("lse", None), ("gold", None), ("ce_dh", None), ("ce_dhead", 1)]


@pytest.mark.parametrize("key,dim", OPS, ids=[k for k, _ in OPS])
def test_each_op_matches_the_unsharded_computation(ranks, key, dim):
    want = ranks[0]["plain"][key]
    got = _whole(key, [r["sharded"][key] for r in ranks], dim)
    np.testing.assert_allclose(got, want, **TOL)
    if dim is None:     # every model rank holds the same bits
        np.testing.assert_array_equal(ranks[0]["sharded"][key], ranks[1]["sharded"][key])


@pytest.mark.parametrize("key", ["embed", "tied", "logits"])
def test_lookup_and_joined_logits_are_bit_exact(ranks, key):
    for r in ranks:
        np.testing.assert_array_equal(r["sharded"][key], ranks[0]["plain"][key])


def test_outside_the_context_nothing_is_communicated(ranks):
    assert ranks[0]["plain_counts"] == {}


def test_an_argmax_tie_across_the_boundary_takes_the_lower_index(ranks):
    for r in ranks:
        assert r["tie"] == r["tie_np"] == 3


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_vocab_parallel_ce_and_z_loss_match_train_loss(ranks, arch):
    """``train_loss``'s loss, CE and z-loss on the model shard against the
    unsharded ones, and every gradient leaf (gathered whole)."""
    for r in ranks:
        plain, sharded, grads_plain, grads = r[arch]
        np.testing.assert_allclose(sharded, plain, rtol=1e-5)
        assert grads.keys() == grads_plain.keys()
        for k, want in grads_plain.items():
            np.testing.assert_allclose(grads[k], want, rtol=1e-4, atol=1e-6, err_msg=k)
