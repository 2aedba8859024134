"""MoE training on a data mesh: ``Trainer(mesh=)`` and ``make_train_step(
mesh=)`` with the olmoe and deepseek smoke configs on gloo CPU ranks,
against the reference's single-device step.

The reference forms MoE groups over the global microbatch and takes the
Switch aux loss's means over every token; the port's ranks form the same
groups (``models.moe.moe_apply``): aligned groups (a group inside one
rank's rows, ``moe_group_size`` 16) and spanning ones (a group across
ranks: the default 2048 over 64-token microbatches).  Held here:

* per-step loss and grad norm within 1e-5 relative of the reference
  ``Trainer`` on the same bridged weights and batches, at dp = 2, dp = 4
  and (pod, data, model) = (2, 2, 2), where no routing decision differs
  (each rank's expert ids against the port's ``mesh=None`` run's);
* the aux counted once: the ranks' aux shares sum to one device's aux, and
  their router and input gradients to its gradients;
* ``run_minidryrun.py``'s three cases (smollm, olmoe, zamba2 smoke,
  ``remat=False``, 8 × 16 on (2, 2, 2)): the port's sharded step loss
  within 1e-5 of the reference's unsharded one (jax 0.9.0 cannot run the
  reference's sharded step: ROADMAP Queue 3).

The reference runs in the parent; its parameters cross to the ranks as
numpy arrays, and the ranks (one spawn of eight) import no JAX.
"""

import dataclasses
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.spawn import run_ranks  # noqa: E402

WORLD = 8
RTOL = 1e-5
ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite-16b")
GROUPS = {"aligned": 16, "spanning": 0}       # moe_group_size (0: the default 2048)
MESHES = {"dp2": (1, 2, 1), "dp4": (1, 4, 1), "pod2_dp2_tp2": (2, 2, 2)}
DATA = dict(vocab=64, seq_len=16, global_batch=8, branching=3)
TRAIN = dict(total_steps=2, ckpt_every=100, log_every=1, ckpt_async=False, microbatches=2)
OPTIM = dict(lr_peak=3e-3, warmup_steps=2, total_steps=10)
MINI = ("smollm-135m", "olmoe-1b-7b", "zamba2-1.2b")
AUX_ROWS, AUX_SEQ = 4, 16                     # 64 tokens over dp = 2


def _cfg(arch, group):
    from repro_torch.configs import get_smoke_config

    return dataclasses.replace(get_smoke_config(arch), vocab=DATA["vocab"],
                               moe_group_size=GROUPS[group])


def _mesh(shape):
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import AXES

    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=AXES)


def _trainer_run(arch, group, p0, ckpt_dir, mesh):
    """Each logged step's (loss, lr, grad_norm) and every router call's
    expert ids."""
    from repro_torch import bridge, optim
    from repro_torch.data import DataConfig
    from repro_torch.models import moe
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = _cfg(arch, group)
    t = Trainer(cfg, TrainerConfig(ckpt_dir=ckpt_dir, **TRAIN), optim.AdamWConfig(**OPTIM),
                DataConfig(**DATA), mesh, device="cpu")
    t.load_full(bridge.params_from_jax(p0, cfg, "cpu"))
    ids, route = [], moe.route

    def spy(p, cfg, x, data=None):
        out = route(p, cfg, x, data)
        ids.append(out[0].reshape(-1, out[0].shape[-1]).numpy().copy())
        return out

    moe.route = spy
    try:
        res = t.run()
    finally:
        moe.route = route
    return [(m["loss"], m["lr"], m["grad_norm"]) for m in res["metrics"]], ids


def _aux_case(mesh, group_size, x_full, p_full):
    """This rank's rows of ``x_full`` through ``moe_apply`` inside the
    train step's pin: its aux share and the gradients of that share."""
    from repro_torch.launch.mesh import local_shard
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import activation_constraints

    cfg = _cfg("olmoe-1b-7b", "aligned")
    n = AUX_ROWS // 2
    r = local_shard(mesh)
    x = torch.tensor(x_full[r * n:(r + 1) * n], requires_grad=True)
    p = {k: torch.tensor(v, requires_grad=k == "router") for k, v in p_full.items()}
    with activation_constraints(mesh, global_batch=AUX_ROWS):
        y, aux = moe.moe_apply(p, cfg, x, group_size=group_size)
    aux.backward()
    return aux.item(), p["router"].grad.numpy(), x.grad.numpy(), y.detach().numpy()


def _recompute_thread(mesh):
    """The data share another thread sees (autograd runs a CUDA backward,
    and so a remat group's recompute, on a thread of its own): none, and
    inside the recompute's context the forward's."""
    from repro_torch.parallel.sharding import activation_constraints, data_share, \
        recompute_contexts

    with activation_constraints(mesh, global_batch=AUX_ROWS):
        here = data_share(AUX_ROWS // 2)[1:]
        _, recompute = recompute_contexts()
    seen = {}

    def other():
        seen["bare"] = data_share(AUX_ROWS // 2)
        with recompute:
            seen["recompute"] = data_share(AUX_ROWS // 2)[1:]

    t = threading.Thread(target=other)
    t.start()
    t.join()
    return here, seen["bare"], seen["recompute"]


def _mini_step(arch, p0, batch, mesh):
    """``run_minidryrun.py``'s step on this rank's shards: the mesh loss."""
    from repro_torch import bridge, optim
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.parallel import zero

    cfg = dataclasses.replace(get_smoke_config(arch), remat=False)
    full = bridge.params_from_jax(p0, cfg, "cpu")
    state = zero.state_layout(cfg, mesh).shard({"params": full, "opt": optim.init(full)})
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, _, m = make_train_step(cfg, optim.AdamWConfig(), mesh=mesh)(
        state["params"], state["opt"], batch)
    return float(m["loss"])


def _ranks(rank, world, p0s, aux_in, minis, tmp):
    from repro_torch.launch.mesh import make_local_mesh

    # every rank builds every mesh (DeviceMesh makes its groups collectively)
    meshes = {name: _mesh(shape) for name, shape in MESHES.items()}
    dp2 = make_local_mesh(2, 1)
    out = {"runs": {}, "none": {}, "aux": {}, "mini": {}}
    for (arch, group), p0 in p0s.items():
        if rank == 4 + ARCHS.index(arch) * 2 + list(GROUPS).index(group):
            out["none"][arch, group] = _trainer_run(arch, group, p0, f"{tmp}/{arch}_{group}_none",
                                                    None)
        for name, mesh in meshes.items():
            if mesh.get_coordinate() is not None:
                out["runs"][arch, group, name] = _trainer_run(
                    arch, group, p0, f"{tmp}/{arch}_{group}_{name}_{rank}", mesh)
    if dp2.get_coordinate() is not None:
        for group, g in (("aligned", 16), ("spanning", 64)):
            out["aux"][group] = _aux_case(dp2, g, *aux_in)
        out["recompute"] = _recompute_thread(dp2)
    for arch, (p0, batch) in minis.items():
        out["mini"][arch] = _mini_step(arch, p0, batch, meshes["pod2_dp2_tp2"])
    out["jax"] = "jax" in sys.modules
    return out


def _aux_inputs():
    """olmoe smoke MoE weights and 4 × 16 inputs, and one device's aux,
    its router and input gradients and its outputs, per group size."""
    from repro_torch.models import moe

    cfg = _cfg("olmoe-1b-7b", "aligned")
    gen = torch.Generator().manual_seed(27)
    p = {k: v.numpy() for k, v in moe.moe_params(gen, cfg).items() if k != "shared"}
    x = (0.5 * torch.randn(AUX_ROWS, AUX_SEQ, cfg.d_model, generator=gen)).numpy()
    want = {}
    for group, g in (("aligned", 16), ("spanning", 64)):
        xt = torch.tensor(x, requires_grad=True)
        pt = {k: torch.tensor(v, requires_grad=k == "router") for k, v in p.items()}
        y, aux = moe.moe_apply(pt, cfg, xt, group_size=g)
        aux.backward()
        want[group] = (aux.item(), pt["router"].grad.numpy(), xt.grad.numpy(),
                       y.detach().numpy())
    return (x, p), want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference Trainer's steps on each (arch, grouping) and
    run_minidryrun.py's unsharded step losses, computed here while the
    eight ranks run on the reference's initial parameters (numpy): returns
    (reference, one device's aux case, the ranks' results)."""
    import jax

    from repro import optim as jax_optim
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.data import DataConfig as JaxDataConfig
    from repro.launch import steps as jax_steps
    from repro.models import lm as jax_lm
    from repro.runtime import Trainer as JaxTrainer
    from repro.runtime import TrainerConfig as JaxTrainerConfig

    trainers = {}
    for arch in ARCHS:
        for group, gs in GROUPS.items():
            jcfg = dataclasses.replace(jax_smoke_config(arch), vocab=DATA["vocab"],
                                       moe_group_size=gs)
            trainers[arch, group] = JaxTrainer(jcfg, JaxTrainerConfig(
                ckpt_dir=str(tmp_path_factory.mktemp(f"{arch}_{group}")), **TRAIN),
                jax_optim.AdamWConfig(**OPTIM), JaxDataConfig(**DATA))
    p0s = {key: jax.tree.map(np.asarray, jt.params) for key, jt in trainers.items()}
    mini_cfgs = {arch: dataclasses.replace(jax_smoke_config(arch), remat=False) for arch in MINI}
    mini_in = {}
    for arch, cfg in mini_cfgs.items():
        toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0, cfg.vocab))
        mini_in[arch] = (jax.tree.map(np.asarray, jax_lm.init_params(cfg, jax.random.PRNGKey(0))),
                         {"tokens": toks, "labels": toks})
    aux_in, aux_want = _aux_inputs()

    done = {}

    def ranks():
        try:
            done["ranks"] = run_ranks(_ranks, WORLD, (p0s, aux_in, mini_in,
                                                      str(tmp_path_factory.mktemp("moe_mesh"))),
                                      timeout_s=300)
        except BaseException as e:  # noqa: BLE001 - raised in the fixture below
            done["error"] = e

    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        ref = {key: [(m["loss"], m["lr"], m["grad_norm"]) for m in jt.run()["metrics"]]
               for key, jt in trainers.items()}
        minis = {}
        for arch, cfg in mini_cfgs.items():
            params, batch = mini_in[arch]
            step = jax_steps.make_train_step(cfg, jax_optim.AdamWConfig())
            _, _, m = jax.jit(step)(params, jax_optim.init(params), batch)
            minis[arch] = float(m["loss"])
    finally:
        thread.join()
    if "error" in done:
        raise done["error"]
    return {"trainer": ref, "mini": minis}, aux_want, done["ranks"]


def _data_shard(rank, mesh):
    pod, data, model = MESHES[mesh]
    if rank >= pod * data * model:
        return None
    return (rank // (data * model)) * data + (rank // model) % data, rank % model


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("group", list(GROUPS))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_trainer_on_a_data_mesh_matches_the_reference(runs, arch, group, mesh):
    reference, _, ranks = runs
    want = np.array(reference["trainer"][arch, group])
    _, none_ids = next(out["none"][arch, group] for out in ranks if (arch, group) in out["none"])
    members = {}
    for rank, out in enumerate(ranks):
        if (arch, group, mesh) in out["runs"]:
            members[_data_shard(rank, mesh)] = out["runs"][arch, group, mesh]
    dp = MESHES[mesh][0] * MESHES[mesh][1]
    assert len(members) == dp * MESHES[mesh][2]
    # routing first: every router call's ids, this rank's tokens, against mesh=None's
    for (shard, _), (_, ids) in members.items():
        assert len(ids) == len(none_ids)
        for got, full in zip(ids, none_ids):
            if group == "spanning":
                np.testing.assert_array_equal(got, full)
            else:
                n = full.shape[0] // dp
                np.testing.assert_array_equal(got, full[shard * n:(shard + 1) * n])
    for steps, _ in members.values():
        np.testing.assert_allclose(np.array(steps), want, rtol=RTOL)   # loss, lr, grad_norm
        assert steps == next(iter(members.values()))[0]                # every rank logs alike


@pytest.mark.parametrize("group", ["aligned", "spanning"])
def test_the_aux_counts_once_in_value_and_gradient(runs, group):
    _, want, ranks = runs
    aux, router_g, x_g, y = want[group]
    shares = [out["aux"][group] for out in ranks[:2]]
    assert abs(sum(s[0] for s in shares) - aux) <= 1e-6 * abs(aux)
    np.testing.assert_allclose(sum(s[1] for s in shares), router_g,
                               atol=1e-6 * np.abs(router_g).max())
    np.testing.assert_allclose(np.concatenate([s[2] for s in shares]), x_g,
                               atol=1e-6 * np.abs(x_g).max())
    np.testing.assert_allclose(np.concatenate([s[3] for s in shares]), y,
                               atol=1e-6 * np.abs(y).max())
    if group == "aligned":      # each rank's share differs: it is not the global aux
        assert shares[0][0] != shares[1][0]
    else:                       # the whole microbatch on each rank, aux / dp
        assert shares[0][0] == shares[1][0]


def test_a_recompute_on_another_thread_sees_the_forward_s_data_share(runs):
    for rank, out in enumerate(runs[2][:2]):
        here, bare, recompute = out["recompute"]
        assert here == recompute == (rank, 2) and bare is None


@pytest.mark.parametrize("arch", MINI)
def test_minidryrun_sharded_step_matches_the_reference_unsharded_loss(runs, arch):
    reference, _, ranks = runs
    want = reference["mini"][arch]
    for out in ranks:
        assert abs(out["mini"][arch] - want) <= RTOL * abs(want), (out["mini"][arch], want)
        assert not out["jax"]
