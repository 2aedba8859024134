"""The dry run (``repro_torch.launch.dryrun``, ``launch.steps``' dry-run
half, ``launch.trace_analysis``) against the reference's.

* The shape cells and each arch's applicable shapes are the reference's.
* ``input_specs`` equals the reference's (``jax.eval_shape``) leaf by leaf,
  shape and dtype, for every port arch × applicable shape at full size
  under ``dryrun_config``; each rank's shard shapes on 16×16 and 2×16×16
  equal the reference's ``PartitionSpec``s cut on a mesh of that size.
* FLOPs: on the smoke configs (``remat=False``, ``run_minidryrun.py``'s
  8 × 16 batch) the trace's FLOPs equal the reference's
  ``hlo_analysis.analyze`` of its compiled step on one CPU device (exactly
  for smollm and olmoe; zamba2 within ``ZAMBA_FLOPS_RTOL``, see below),
  and on smollm-135m at full size on 16×16, on its model shard, the
  analytic 6·D·(replicated N + TP'd N / 16) plus the plain attention's
  12·L·S·H·hd a token; on internlm2-20b at full size on 16×16, whose 8 KV
  heads cut into half a head a rank, on its model shard too: 6·D·(its
  matmul parameters / 16) plus the attention of its 3 query heads, and its
  K/V columns joined over ``model`` (``gather_heads``).
* Collectives: on a (1, 2, 2) olmoe smoke cell, which computes on its
  model shard (experts and heads over ``model``, the parameters gathered
  along ``data`` only), the dry run's counts and bytes by kind, and its
  argument bytes, equal a real ``make_train_step(mesh=)`` step's on four
  gloo CPU ranks.
* The CLI writes a record with the reference's keys; a fake group never
  reaches a real step.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.spawn import run_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MINI = ("smollm-135m", "olmoe-1b-7b", "zamba2-1.2b")
# zamba2: the forward's FLOPs are equal (the prefill step's, exactly); the
# reference's backward has more, the port's step 1.53% less in all here.
# At one SSD chunk the reference differentiates the scan's emitted incoming
# state, a dot of 2·B·c·H·P·N a mamba2 layer (6 × 524 288), where the port's
# incoming state is the zero initial state and takes no gradient; another
# 2·T·N² a mamba2 layer (6 × 65 536 here, 6 × 524 288 at 2 × 512 tokens)
# whose source in the reference's backward is not identified.
ZAMBA_FLOPS_RTOL = 0.02
COLL_MESH = (1, 2, 2)


def _flat(tree, path=""):
    """``{path: leaf}`` over dicts, NamedTuples, tuples and lists."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for k in tree._fields:
            out.update(_flat(getattr(tree, k), f"{path}/{k}"))
        return out
    if isinstance(tree, (list, tuple)) and not _is_spec(tree):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}/{i}"))
        return out
    return {path: tree}


def _is_spec(t):
    return isinstance(t, tuple) and all(e is None or isinstance(e, (str, tuple)) for e in t)


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


# -- shape cells and input specs ---------------------------------------------

def test_shape_cells_are_the_reference_s():
    from repro.configs import get_config as jax_config
    from repro.models import config as jax_config_mod

    from repro_torch.configs import ALL_SHAPES, ARCH_IDS, applicable_shapes, get_config

    assert [dataclasses.astuple(s) for s in ALL_SHAPES] == \
        [dataclasses.astuple(s) for s in jax_config_mod.ALL_SHAPES]
    for arch in ARCH_IDS:
        assert [s.name for s in applicable_shapes(get_config(arch))] == \
            [s.name for s in jax_config_mod.applicable_shapes(jax_config(arch))], arch


@pytest.fixture(scope="module")
def specs():
    """Both packages' full-size input specs for every port arch × shape."""
    from repro.configs import get_config as jax_config
    from repro.launch import steps as jax_steps

    from repro_torch.configs import ARCH_IDS, applicable_shapes, get_config
    from repro_torch.launch import steps

    out = {}
    for arch in ARCH_IDS:
        cfg, jcfg = (steps.dryrun_config(get_config(arch)),
                     jax_steps.dryrun_config(jax_config(arch)))
        for shape in applicable_shapes(cfg):
            out[arch, shape.name] = (cfg, shape, steps.input_specs(cfg, shape), jcfg,
                                     jax_steps.input_specs(jcfg, shape))
    return out


def test_input_specs_match_the_reference_leaf_by_leaf(specs):
    from repro_torch.configs import ARCH_IDS

    assert {arch for arch, _ in specs} == set(ARCH_IDS)
    for key, (_, _, mine, _, ref) in specs.items():
        got, want = _flat(mine), _flat(ref)
        assert sorted(got) == sorted(want), key
        for path, leaf in want.items():
            assert tuple(got[path].shape) == tuple(leaf.shape), (key, path)
            assert _dtype_name(got[path].dtype) == str(leaf.dtype), (key, path)
            assert got[path].device.type == "meta"


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_shard_shapes_match_the_reference_plan(specs, multi_pod):
    """Each rank's block of every input under ``plan_shardings`` against
    the reference's ``PartitionSpec``s on an abstract mesh of that size."""
    from jax.sharding import AbstractMesh as JaxAbstractMesh

    from repro.launch import mesh as jax_mesh  # noqa: F401 - the reference's layout
    from repro.parallel import sharding as jax_shd

    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=multi_pod)
    jmesh = JaxAbstractMesh(mesh.axis_sizes, mesh.axis_names)
    for key, (cfg, shape, mine, jcfg, ref) in specs.items():
        plan = _flat(steps.plan_shardings(cfg, shape, mesh, mine))
        want = {"/params": jax_shd.param_specs(jcfg, ref["params"], jmesh),
                "/batch": jax_shd.batch_specs(jcfg, shape, jmesh, ref["batch"])}
        if shape.kind == "decode":
            shard_seq = shape.global_batch < mesh.shape.get("data", 1)
            want["/caches"] = jax_shd.cache_specs(jcfg, ref["caches"], jmesh, shard_seq=shard_seq)
        leaves = _flat(mine)
        for prefix, tree in want.items():
            for path, pspec in _flat(tree).items():
                full = leaves[prefix + path].shape
                ref_shape = tuple(
                    n // math.prod(mesh.shape[a] for a in
                                   (() if e is None else (e if isinstance(e, tuple) else (e,))))
                    for n, e in zip(full, tuple(pspec) + (None,) * (len(full) - len(pspec))))
                assert steps.local_shape(plan[prefix + path], full, mesh) == ref_shape, \
                    (key, prefix + path)
        if shape.kind == "train":      # the moments are laid out as their parameters
            for path, spec in _flat(steps.plan_shardings(cfg, shape, mesh, mine)["params"]).items():
                assert plan["/opt_state/m" + path] == plan["/opt_state/v" + path] == spec


def test_every_arch_decodes_in_bf16_on_fake_tensors():
    """``dryrun_config``'s bf16 weights and activations trace a decode
    step end to end on every port arch with a decoder (the smoke configs;
    an encoder has none, as the reference's
    ``test_smoke_decode_matches_prefill`` skips it): the fp32 recurrent and
    SSM states meet bf16 activations, which ``jnp`` promotes and the port
    must too."""
    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.models.config import ShapeSpec

    for arch in ARCH_IDS:
        if not get_smoke_config(arch).is_decoder:
            continue
        cell = steps.lower_cell(steps.dryrun_config(get_smoke_config(arch)),
                                ShapeSpec("decode", 64, 2, "decode"), None, device="cpu")
        assert cell.rows == 2 and cell.stats.flops > 0, arch


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "hubert-xlarge"])
def test_vlm_and_encoder_cells_trace_on_one_device_and_a_mesh(arch):
    """Every applicable shape of the VLM and the encoder (their smoke
    configs, 4 rows of 32 tokens) traces through the port's step functions
    on one device, on rank 0 of a fake (1, 2, 1) mesh and on rank 0 of a
    fake (1, 1, 2) one: the encoder's ``embeds`` and the VLM's ``memory``
    reach every step; on (1, 2, 1) each rank computes its half of the rows,
    on (1, 1, 2) all 4 rows on its model shard (a ``cross`` block's heads
    too), about half of the one-device cell's FLOPs (the replicated
    ``embed/proj`` and norms add the rest).  With them ``--all`` sweeps the
    reference's 36 cells a mesh (``tests/test_archs_smoke.py``'s count)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import ARCH_IDS, applicable_shapes, get_config, get_smoke_config
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import AXES, AbstractMesh

    assert sum(len(applicable_shapes(get_config(a))) for a in ARCH_IDS) == 36
    cfg = get_smoke_config(arch)
    shapes = [dataclasses.replace(s, seq_len=32, global_batch=4)
              for s in applicable_shapes(get_config(arch))]
    assert [s.kind for s in shapes] == (["train", "prefill", "decode"] if cfg.is_decoder
                                        else ["train", "prefill"])
    one = {}
    for shape in shapes:
        cell = steps.lower_cell(cfg, shape, None, device="cpu")
        assert cell.rows == 4 and cell.stats.flops > 0, shape
        one[shape.name] = cell.stats.flops
    cells = [(AbstractMesh(m, AXES), s) for m in ((1, 2, 1), (1, 1, 2)) for s in shapes]
    with ThreadPoolExecutor(len(cells)) as pool:
        recs = list(pool.map(lambda c: dryrun.spawn_cell(
            arch, c[1].name, False, device="cpu", mesh_shape=c[0], shape=c[1], cfg=cfg,
            timeout_s=240), cells))
    for (mesh, shape), rec in zip(cells, recs):
        name = "x".join(map(str, mesh.axis_sizes))
        assert (rec["mesh"], rec["n_devices"], rec["shape"]) == (name, 2, shape.name)
        assert rec["flops_corrected"] > 0, rec
        if shape.kind == "train":      # the loss and the gradients summed over data
            assert rec["collectives"]["all_reduce"]["count"] > 0
        if name == "1x2x1":
            assert rec["rows_per_rank"] == 2 and not rec["model_shard"], rec
            continue
        assert rec["rows_per_rank"] == 4 and rec["model_shard"] is True, rec
        assert "gather_exact" not in rec["collectives"], rec["collectives"]
        share = rec["flops_corrected"] / one[shape.name]
        assert 0.5 <= share <= 0.52, (shape.name, share)


# -- FLOPs -------------------------------------------------------------------

def _mini_shape():
    from repro_torch.models.config import ShapeSpec

    return ShapeSpec("mini_train", seq_len=16, global_batch=8, kind="train")


@pytest.mark.parametrize("arch", MINI)
def test_flops_match_the_reference_hlo_analysis(arch):
    import jax

    from repro import optim as jax_optim
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.launch import hlo_analysis
    from repro.launch import steps as jax_steps

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps

    shape = _mini_shape()
    jcfg = dataclasses.replace(jax_smoke_config(arch), remat=False)
    js = jax_steps.input_specs(jcfg, shape)
    compiled = jax.jit(jax_steps.make_train_step(jcfg, jax_optim.AdamWConfig())).lower(
        js["params"], js["opt_state"], js["batch"]).compile()
    want = hlo_analysis.analyze(compiled.as_text()).flops
    cfg = dataclasses.replace(get_smoke_config(arch), remat=False)
    got = steps.lower_cell(cfg, shape, None, device="cpu").stats.flops
    if arch == "zamba2-1.2b":
        assert abs(got - want) <= ZAMBA_FLOPS_RTOL * want and got != want, (got, want)
    else:
        assert got == want


@pytest.mark.parametrize("arch,kind", [("falcon-mamba-7b", "train"), ("paper-lstm", "prefill")])
def test_stepwise_cells_extrapolate_to_a_direct_trace(arch, kind):
    """One layer of the Mamba-1 and LSTM smoke configs: the figures from
    traces at three lengths (16, 32, 48: ``dryrun.TRACE_LENGTHS`` scaled
    down) against a direct trace at 80 tokens, exact but for the Mamba-1
    train step's peak (a max over the step's moments, extended along a
    line: within 0.5%)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps, trace_analysis
    from repro_torch.models.config import ShapeSpec

    cfg = dataclasses.replace(get_smoke_config(arch), n_layers=1, remat=False)
    trace = lambda n: steps.lower_cell(cfg, ShapeSpec("x", n, 4, kind), None,  # noqa: E731
                                       device="cpu").stats
    lengths = [16, 32, 48]
    got = trace_analysis.extrapolate([trace(n) for n in lengths], lengths, 80)
    want = trace(80)
    for field in ("flops", "bytes_accessed", "memory_traffic", "argument_bytes",
                  "output_bytes", "collectives"):
        assert getattr(got, field) == getattr(want, field), field
    if (arch, kind) == ("falcon-mamba-7b", "train"):
        assert abs(got.peak_bytes - want.peak_bytes) <= 5e-3 * want.peak_bytes, \
            (got.peak_bytes, want.peak_bytes)
    else:
        assert got.peak_bytes == want.peak_bytes


# -- the CLI, and collectives against real ranks -----------------------------

def _rank_step(rank, world, cfg, batch):
    """One real ``make_train_step(mesh=)`` step on this rank's shards: its
    collectives and its argument bytes."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import optim
    from repro_torch.launch.mesh import AXES
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.trace_analysis import tensor_bytes
    from repro_torch.models import lm
    from repro_torch.parallel import comm, zero

    mesh = DeviceMesh("cpu", torch.arange(world).reshape(COLL_MESH), mesh_dim_names=AXES)
    full = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = zero.state_layout(cfg, mesh).shard({"params": full, "opt": optim.init(full)})
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    args = (state["params"], state["opt"], batch)
    step = make_train_step(cfg, optim.AdamWConfig(), mesh=mesh)
    comm.reset_counts()
    _, _, m = step(*args)
    return comm.counters(), tensor_bytes(args), float(m["loss"])


FAKE_GROUP_CODE = (
    "import torch\n"
    "from repro_torch.launch.mesh import AXES, AbstractMesh, make_fake_mesh, make_local_mesh\n"
    "from repro_torch.parallel import zero\n"
    "mesh = make_fake_mesh(AbstractMesh((2, 16, 16), AXES))\n"
    "print(mesh.get_coordinate(), torch.distributed.get_world_size())\n"
    "for call in (lambda: make_local_mesh(), lambda: zero.ShardLayout(mesh, {'w': ()})):\n"
    "    try:\n"
    "        call()\n"
    "    except RuntimeError as e:\n"
    "        print('refused:', e)\n"
    "from torch._subclasses.fake_tensor import FakeTensorMode\n"
    "with FakeTensorMode():\n"
    "    print(type(zero.ShardLayout(mesh, {'w': ()})).__name__)\n")


class _Background:
    """The module's slow pieces, started together when the module starts:
    the CLI (smollm-135m's and internlm2-20b's train_4k cells on 16×16, no
    remat), the fake group's refusals, and the (1, 2, 2) olmoe smoke
    cell's dry run beside four real ranks."""

    def __init__(self, out: Path):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
        popen = lambda args: subprocess.Popen(  # noqa: E731
            [sys.executable, *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.out = out
        cli = lambda arch: popen(["-m", "repro_torch.launch.dryrun", "--arch", arch,  # noqa: E731
                                  "--shape", "train_4k", "--mesh", "pod", "--no-remat",
                                  "--device", "cpu", "--out", str(out)])
        self.procs = {"cli": cli("smollm-135m"), "cli_heads": cli("internlm2-20b"),
                      "fake": popen(["-c", FAKE_GROUP_CODE])}
        self.done: dict = {}
        self.threads = [threading.Thread(target=self._run, args=(name, fn))
                        for name, fn in (("ranks", self._ranks), ("record", self._record))]
        for t in self.threads:
            t.start()

    def _run(self, name, fn):
        try:
            self.done[name] = fn()
        except BaseException as e:  # noqa: BLE001 - raised where it is read
            self.done[name] = e

    def _batch(self):
        from repro_torch.configs import get_smoke_config

        cfg = get_smoke_config("olmoe-1b-7b")
        toks = np.random.default_rng(12).integers(0, cfg.vocab, size=(8, 16)).astype(np.int32)
        return cfg, {"tokens": toks, "labels": toks}

    def _ranks(self):
        return run_ranks(_rank_step, 4, self._batch(), timeout_s=180)

    def _record(self):
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import AXES, AbstractMesh

        return dryrun.spawn_cell("olmoe-1b-7b", "mini_train", False, device="cpu",
                                 mesh_shape=AbstractMesh(COLL_MESH, AXES), shape=_mini_shape(),
                                 cfg=self._batch()[0], timeout_s=180)

    def proc(self, name):
        p = self.procs[name]
        try:
            text, _ = p.communicate(timeout=300)
        finally:
            if p.poll() is None:
                p.kill()
                p.communicate()
        return p.returncode, text

    def result(self, name):
        for t in self.threads:
            t.join()
        val = self.done[name]
        if isinstance(val, BaseException):
            raise val
        return val

    def close(self):
        for name in self.procs:
            self.proc(name)
        for t in self.threads:
            t.join()


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    bg = _Background(tmp_path_factory.mktemp("dryrun"))
    yield bg
    bg.close()


@pytest.fixture(scope="module")
def cli(background):
    """(returncode, output, the record) of the CLI's run."""
    rc, text = background.proc("cli")
    rec = background.out / "smollm-135m__train_4k__16x16.json"
    return rc, text, json.loads(rec.read_text()) if rec.exists() else None


@pytest.fixture(scope="module")
def cli_heads(background):
    """(returncode, output, the record) of the internlm2-20b CLI run."""
    rc, text = background.proc("cli_heads")
    rec = background.out / "internlm2-20b__train_4k__16x16.json"
    return rc, text, json.loads(rec.read_text()) if rec.exists() else None


@pytest.fixture(scope="module")
def collectives(background):
    """The dry run's record of the (1, 2, 2) cell and the four ranks'
    (counters, argument bytes, loss)."""
    return background.result("record"), background.result("ranks")


def test_dry_run_collectives_equal_a_real_step_s(collectives):
    rec, ranks = collectives
    assert rec["mesh"] == "1x2x2" and rec["n_devices"] == 4
    # on the model shard: the gather along data only, the spanning MoE
    # groups' rows, nothing gathered whole over model
    assert rec["model_shard"] is True
    assert set(rec["collectives"]) >= {"all_reduce", "gather_data", "gather_rows"}
    assert "gather_exact" not in rec["collectives"]
    for counters, arg_bytes, loss in ranks:
        assert counters == rec["collectives"] == rec["collectives_corrected"]
        assert arg_bytes == rec["memory_analysis"]["argument_size_in_bytes"]
        assert math.isfinite(loss)


def test_cli_writes_the_reference_s_record(cli):
    rc, text, rec = cli
    assert rc == 0, text[-3000:]
    assert rec is not None and "[ok]" in text
    for key in ("arch", "shape", "mesh", "n_devices", "lower_s", "microbatches", "tag",
                "cost_analysis", "memory_analysis", "collectives", "flops_corrected",
                "memory_traffic", "collectives_corrected"):
        assert key in rec, key
    for key in ("compile_s", "while_trips", "hlo_bytes"):
        assert key not in rec, key
    assert set(rec["cost_analysis"]) == {"flops", "bytes accessed"}
    assert {"argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes"} <= set(rec["memory_analysis"])
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["n_devices"]) == \
        ("smollm-135m", "train_4k", "16x16", 256)
    # smollm computes on its model shard: the parameters gathered along the
    # data axis only (one exact gather, nothing over ``model``), the label
    # count, the loss and the gradients summed over data, the grad norm's
    # squares over the mesh
    assert rec["model_shard"] is True
    assert rec["collectives"]["gather_data"]["count"] == 1
    assert "gather_exact" not in rec["collectives"]
    assert rec["memory_analysis"]["temp_size_in_bytes"] > 0


def test_full_size_flops_are_6ND_plus_the_attention(cli):
    """smollm-135m on 16×16: 16 rows of 4096 tokens a rank, on its model
    shard, no remat.  The matmul parameters (all but the norm scales; the
    tied table once, as the head) give 6·D·(N_replicated + N_TP / 16): the
    table and the MLP are cut over ``model``, the attention is replicated
    (``attn_tp=False``).  The plain attention's scores and values over all
    S keys, on all heads, add 4·S·H·hd a token forward, 12 with the
    backward."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.parallel import zero

    rec = cli[2]
    cfg = get_config("smollm-135m")
    assert not cfg.attn_tp
    leaves = _flat(zero.param_shapes(steps.dryrun_config(cfg)))
    assert cfg.tie_embeddings and "/head/w" not in leaves
    n = {"tp": 0, "replicated": 0}
    for path, t in leaves.items():
        if not path.endswith("/scale"):
            n["replicated" if "/attn/" in path else "tp"] += t.numel()
    assert n["tp"] % 16 == 0 and n["replicated"] > 0
    S, D = 4096, 16 * 4096
    want = 6 * (n["replicated"] + n["tp"] // 16) * D \
        + 12 * cfg.n_layers * S * cfg.n_heads * cfg.head_dim * D
    assert rec["rows_per_rank"] == 16
    assert rec["flops_corrected"] == rec["cost_analysis"]["flops"]
    assert abs(rec["flops_corrected"] - want) <= 1e-9 * want, (rec["flops_corrected"], want)


def test_internlm2_computes_on_its_shard_with_half_kv_heads(cli_heads):
    """internlm2-20b on 16×16: 16 rows of 4096 tokens a rank, no remat, on
    its model shard although its 8 KV heads cut into half a head a rank.
    Every matmul parameter is cut over ``model`` (the table too, whose
    lookup is no matmul): 6·D·(N / 16); the plain attention on the rank's
    3 of 48 query heads adds 12·L·S·(H/16)·hd a token.  The K and V
    columns are joined over ``model`` together, once in each layer's
    forward (the recompute-free backward joins nothing); the parameters
    are gathered along ``data`` only."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.parallel import zero

    rc, text, rec = cli_heads
    assert rc == 0, text[-3000:]
    cfg = get_config("internlm2-20b")
    assert cfg.attn_tp and cfg.n_kv_heads % 16 and cfg.n_heads % 16 == 0
    assert rec["model_shard"] is True and rec["rows_per_rank"] == 16
    leaves = _flat(zero.param_shapes(steps.dryrun_config(cfg)))
    n = sum(t.numel() for path, t in leaves.items()
            if not path.endswith(("/scale", "embed/table")))
    assert n % 16 == 0
    S, D = 4096, 16 * 4096
    want = 6 * n // 16 * D + 12 * cfg.n_layers * S * (cfg.n_heads // 16) * cfg.head_dim * D
    assert rec["flops_corrected"] == rec["cost_analysis"]["flops"]
    assert abs(rec["flops_corrected"] - want) <= 1e-9 * want, (rec["flops_corrected"], want)
    coll = rec["collectives"]
    assert coll["gather_heads"]["count"] == cfg.n_layers
    # each join carries the whole K and V of the rank's rows: D tokens × 2 × 1024
    # columns in the cell's activation dtype
    size = torch.empty((), dtype=steps.dryrun_config(cfg).act_dtype).element_size()
    assert coll["gather_heads"]["bytes"] == \
        cfg.n_layers * D * 2 * cfg.n_kv_heads * cfg.head_dim * size
    assert coll["gather_data"]["count"] == 1 and "gather_exact" not in coll


def test_a_fake_group_never_reaches_a_real_step(background):
    rc, text = background.proc("fake")
    assert rc == 0, text[-3000:]
    lines = text.splitlines()
    assert lines[0] == "(0, 0, 0) 512"
    assert [ln.startswith("refused:") for ln in lines[1:3]] == [True, True]
    assert "fake group" in lines[1] and "fake group" in lines[2]
    assert lines[3] == "ShardLayout"
