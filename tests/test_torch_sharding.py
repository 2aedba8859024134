"""The port's sharding rules and ``ShardPlan`` against the JAX reference.

The reference's rules run on ``jax.sharding.AbstractMesh`` over the shapes
``jax.eval_shape`` gives; the port's run on its own ``AbstractMesh`` over
the shapes of a parameter tree built under ``FakeTensorMode`` (no storage,
so the full-width configs cost nothing).  Every leaf's path, shape and spec
must agree, for every registered config of the port, with ``fsdp`` on and
off, on four meshes.  Specs are compared as tuples padded to the leaf's
rank (``PartitionSpec(None, None)`` and ``PartitionSpec()`` are the same
placement), with a one-axis tuple entry read as its axis (the installed
JAX normalises ``("data",)`` to ``"data"``; the port keeps the tuple the
rule wrote, which places the same).
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh as JaxAbstractMesh  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.parallel import sharding as jax_sharding  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.runtime import ShardPlan, make_shard_plan  # noqa: E402

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "1x8x1": ((1, 8, 1), tmesh.AXES),
    "1x4x2": ((1, 4, 2), tmesh.AXES),
}
ARCHS = configs.ARCH_IDS


def _jmesh(name):
    return JaxAbstractMesh(*MESHES[name])


def _tmesh(name):
    return tmesh.AbstractMesh(*MESHES[name])


def _norm(spec, rank):
    spec = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)
    return spec + (None,) * (rank - len(spec))


def _flat_ref(specs, shapes):
    """{path: (shape, padded spec)} of the reference's spec tree."""
    out = {}
    pairs = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    shape_of = {jax_sharding._path_str(p): tuple(s.shape)
                for p, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    for path, spec in pairs:
        key = jax_sharding._path_str(path)
        shp = shape_of[key]
        out[key] = (shp, _norm(tuple(spec), len(shp)))
    return out


def _flat_port(specs, shapes):
    out = {}
    sharding.map_with_path(lambda p, leaf: out.__setitem__(p, [tuple(leaf.shape)]), shapes)

    def put(p, spec):
        shp = out[p][0]
        out[p] = (shp, _norm(spec, len(shp)))

    _walk_specs(specs, "", put)
    return out


def _walk_specs(tree, prefix, fn):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _walk_specs(v, f"{prefix}/{k}" if prefix else str(k), fn)
    else:
        fn(prefix, tree)


_SHAPES: dict = {}


def _param_shapes(arch):
    if arch not in _SHAPES:
        jcfg = jax_configs.get_config(arch)
        ref = jax.eval_shape(lambda k: jax_lm.init_params(jcfg, k), jax.random.PRNGKey(0))
        with FakeTensorMode():
            port = lm.init_params(configs.get_config(arch), torch.Generator(), device="cpu")
        _SHAPES[arch] = (jcfg, ref, port)
    return _SHAPES[arch]


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "nofsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference_leaf_by_leaf(arch, mesh, fsdp):
    jcfg, ref_shapes, port_shapes = _param_shapes(arch)
    want = _flat_ref(jax_sharding.param_specs(jcfg, ref_shapes, _jmesh(mesh), fsdp=fsdp),
                     ref_shapes)
    got = _flat_port(sharding.param_specs(configs.get_config(arch), port_shapes,
                                          _tmesh(mesh), fsdp=fsdp), port_shapes)
    assert got == want
    # the opt-state specs are the parameters' (ZeRO), as in the reference
    assert sharding.opt_state_specs(configs.get_config(arch), port_shapes, _tmesh(mesh)) \
        == sharding.param_specs(configs.get_config(arch), port_shapes, _tmesh(mesh))


def _cache_shapes(arch, batch, max_seq):
    jcfg = jax_configs.get_smoke_config(arch)
    ref = jax.eval_shape(lambda: jax_lm.init_cache(jcfg, batch, max_seq))
    with FakeTensorMode():
        port = lm.init_cache(configs.get_smoke_config(arch), batch, max_seq, "cpu")
    return jcfg, ref, port


@pytest.mark.parametrize("shard_seq", [False, True], ids=["batch", "seq"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_the_reference(arch, mesh, shard_seq):
    # a batch of 16 and a cache of 64 divide every mesh's axes, so the
    # guard's drops come from the leaves' own widths
    jcfg, ref, port = _cache_shapes(arch, 16, 64)
    want = _flat_ref(jax_sharding.cache_specs(jcfg, ref, _jmesh(mesh), shard_seq=shard_seq), ref)
    got = _flat_port(sharding.cache_specs(configs.get_smoke_config(arch), port, _tmesh(mesh),
                                          shard_seq=shard_seq), port)
    assert got == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match_the_reference(arch, mesh):
    jcfg = jax_configs.get_smoke_config(arch)
    shapes = {"tokens": (16, 32), "labels": (16, 32), "mask": (6, 32), "scalar": ()}
    ref = {k: jax.ShapeDtypeStruct(s, np.int32) for k, s in shapes.items()}
    port = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    want = _flat_ref(jax_sharding.batch_specs(jcfg, None, _jmesh(mesh), ref), ref)
    got = _flat_port(sharding.batch_specs(configs.get_smoke_config(arch), None,
                                          _tmesh(mesh), port), port)
    assert got == want


@pytest.mark.parametrize("case", ["indivisible", "past_rank", "repeated"])
def test_guard_drops_each_rule_as_the_reference_does(case):
    spec, shape = {
        "indivisible": (("data", "model"), (24, 32)),   # 16 does not divide 24
        "past_rank": (("data", "model", "model"), (32, 32)),
        "repeated": (("data", "data"), (32, 32)),
    }[case]
    want = {"indivisible": (None, "model"), "past_rank": ("data", "model", None),
            "repeated": ("data", None)}[case]
    got = sharding._guard(spec, shape, _tmesh("16x16"))
    ref = tuple(jax_sharding._guard(jax.sharding.PartitionSpec(*spec), shape, _jmesh("16x16")))
    assert got == want == ref + (None,) * (len(got) - len(ref))
    # a tuple entry divides by the product of its axes
    assert sharding._guard((("pod", "data"),), (64,), _tmesh("2x16x16")) == (("pod", "data"),)
    assert sharding._guard((("pod", "data"),), (48,), _tmesh("2x16x16")) == (None,)


def test_placements_turn_specs_into_dtensor_placements():
    from torch.distributed.tensor import Replicate, Shard

    m = _tmesh("2x16x16")
    assert sharding.placements((("pod", "data"), None, "model"), m) == [Shard(0), Shard(0), Shard(2)]
    assert sharding.placements((None, "model"), m) == [Replicate(), Replicate(), Shard(1)]
    assert sharding.placements((), m) == [Replicate()] * 3


def test_shard_plan_placement_arithmetic_and_identity():
    plan = ShardPlan(_tmesh("1x4x2"))
    assert (plan.dp, plan.tp, plan.dp_axes) == (4, 2, ("pod", "data"))
    assert plan.validate_slots(8) == 2
    assert [plan.shard_of_slot(b, 8) for b in range(8)] == [0, 0, 1, 1, 2, 2, 3, 3]
    assert list(plan.slots_of_shard(3, 8)) == [6, 7]
    with pytest.raises(ValueError, match="must divide evenly over dp=4"):
        plan.validate_slots(6)
    assert plan.describe() == {"dp": 4, "tp": 2, "axes": {"pod": 1, "data": 4, "model": 2},
                               "devices": 8, "layout": "sharded"}
    folded = ShardPlan(_tmesh("1x8x1"), fold_data=True)
    assert folded.describe()["layout"] == "folded" and folded.dp == 8
    # the key holds names, shape, ranks and the layout
    assert plan.key() == (tmesh.AXES, (1, 4, 2), None, False)
    assert folded.key() != ShardPlan(_tmesh("1x8x1")).key()
    assert ShardPlan(_tmesh("16x16")).dp_axes == ("data",)
    assert ShardPlan(tmesh.AbstractMesh((8,), ("model",))).dp == 1
    assert make_shard_plan(None) is None
    assert make_shard_plan(_tmesh("1x8x1")) == ShardPlan(_tmesh("1x8x1"))
    # the replicated and per-slot specs, and their placements
    assert plan.replicated() == ()
    assert plan.batch_sharding(2) == (("pod", "data"), None)
    from torch.distributed.tensor import Replicate, Shard

    assert plan.batch_sharding(2, as_placements=True) == [Shard(0), Shard(0), Replicate()]
    # the folded layout holds one copy: to_mesh is the identity
    t = {"w": torch.ones(3)}
    assert folded.to_mesh(t) is t


def test_shard_plan_errors():
    with pytest.raises(ValueError, match="tensor parallelism needs the physical layout"):
        ShardPlan(_tmesh("1x4x2"), fold_data=True)
    with pytest.raises(TypeError, match="AbstractMesh or a DeviceMesh"):
        ShardPlan(object())
    with pytest.raises(RuntimeError, match="needs a DeviceMesh"):
        ShardPlan(_tmesh("1x8x1")).require_group()
    with pytest.raises(ValueError, match="repeated axis"):
        tmesh.AbstractMesh((2, 2), ("data", "data"))


def test_serving_specs_on_the_plan_match_the_reference():
    """``ShardPlan.param_shardings`` is ``param_specs(fsdp=False)`` and
    ``cache_shardings`` is ``cache_specs(shard_seq=False)``, as in the
    reference's plan."""
    jcfg, ref, port = _param_shapes("paper-lstm")
    plan = ShardPlan(_tmesh("1x4x2"))
    got = _flat_port(plan.param_shardings(configs.get_config("paper-lstm"), port), port)
    want = _flat_ref(jax_sharding.param_specs(jcfg, ref, _jmesh("1x4x2"), fsdp=False), ref)
    assert got == want
    jc, rc, pc = _cache_shapes("paper-lstm", 8, 32)
    got = _flat_port(plan.cache_shardings(configs.get_smoke_config("paper-lstm"), pc), pc)
    want = _flat_ref(jax_sharding.cache_specs(jc, rc, _jmesh("1x4x2"), shard_seq=False), rc)
    assert got == want
    pl = plan.cache_shardings(configs.get_smoke_config("paper-lstm"), pc, as_placements=True)
    from torch.distributed.tensor import Replicate, Shard

    # h [G, B, H]: slots over (pod, data), H = 48 over the 2-way model axis
    assert pl["groups"]["b0_recurrent"]["h"] == [Shard(1), Shard(1), Shard(2)]


def test_production_and_local_mesh_arguments():
    assert tmesh.make_production_mesh().shape == {"data": 16, "model": 16}
    assert tmesh.make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16, "model": 16}
    with pytest.raises(ValueError, match="pass both dp and tp"):
        tmesh.make_local_mesh(dp=2)
    with pytest.raises(ValueError, match="must be >= 1"):
        tmesh.make_local_mesh(dp=0, tp=1)
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        tmesh.make_local_mesh(dp=2, tp=1)
