"""``synthesize(mesh=)`` and the IR backends' ``compile_program(mesh=)`` on 8
gloo ranks against the reference's ``run_sharded_synthesis.py`` contracts.

TP     — the eager backend at ``dp=4, tp=2`` on the script's lstm
         (8 → 2×8 → 4, T = 6; the gate weight is ``[16, 32]``, whose rows
         split over tp = 2) within 1e-5 of the reference's single-device
         ``xla_backend`` program (TP changes the summation order), with one
         counted ``all_reduce`` a gate contraction.
KERNEL — the kernel backend's CPU path (the plan interpreter) with
         ``c_slow=4`` at ``dp=4``: bit for bit the port's unsharded kernel
         backend, and within 1e-5 of the reference's unsharded Pallas
         program in interpret mode.  (The reference's sharded Pallas path
         cannot serve as the oracle: under the installed JAX it fails on
         ``shard_map(check_rep=)``, ROADMAP Queue 3.)
CACHE  — ``synthesize(mesh=)`` gets memo keys of its own and a ledger row
         ending in ``|mesh4x2``; the mesh is normalised away on "ref" and
         "verilog".

The reference runs in the parent process; its weights and inputs cross to
the ranks as numpy arrays, and the ranks import no JAX.
"""

import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import AXES, AbstractMesh  # noqa: E402
from repro_torch.launch.spawn import run_ranks  # noqa: E402

WORLD, DP, TP = 8, 4, 2
SPEC = dict(num_inputs=8, num_hidden_layers=2, nodes_per_layer=8, num_outputs=4,
            cell="lstm", seq_len=6)
SPEC_C = dict(num_inputs=8, num_hidden_layers=1, nodes_per_layer=8, num_outputs=4,
              cell="lstm", seq_len=6, c_slow=4)


def _ranks_synthesis(rank, world, prog_np, u, prog_c_np, uc):
    from repro_torch import obs
    from repro_torch.bridge import program_from_jax
    from repro_torch.codegen import eager_backend, kernel_backend
    from repro_torch.core import synthesis
    from repro_torch.core.synthesis import NetworkSpec
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import comm
    from torch.distributed.device_mesh import DeviceMesh

    mesh = make_local_mesh(dp=DP, tp=TP)
    out = {}
    with torch.no_grad():
        prog = program_from_jax(prog_np, NetworkSpec(**SPEC), device="cpu")
        ut = torch.as_tensor(u)
        out["eager_1dev"] = eager_backend.compile_program(prog, device="cpu")(prog.params, ut).numpy()
        fwd = eager_backend.compile_program(prog, mesh=mesh, device="cpu")
        comm.reset_counts()
        out["eager_tp"] = fwd(prog.params, ut).numpy()
        out["eager_counts"] = dict(comm.COUNTS)
        comm.reset_counts()
        out["eager_ragged"] = fwd(prog.params, ut[:3]).numpy()   # 3 rows over dp=4
        out["ragged_counts"] = dict(comm.COUNTS)
        # two DP axes (pod 2 × data 2): the data ranks of a model index are
        # a group of their own
        pods = DeviceMesh("cpu", torch.arange(world).reshape(2, 2, 2), mesh_dim_names=AXES)
        out["eager_pods"] = eager_backend.compile_program(prog, mesh=pods, device="cpu")(
            prog.params, ut).numpy()

        prog_c = program_from_jax(prog_c_np, NetworkSpec(**SPEC_C), device="cpu")
        uct = torch.as_tensor(uc)
        out["kernel_1dev"] = kernel_backend.compile_program(prog_c, device="cpu")(
            prog_c.params, uct).numpy()
        kfwd = kernel_backend.compile_program(prog_c, mesh=mesh, device="cpu")
        comm.reset_counts()
        out["kernel_dp"] = kfwd(prog_c.params, uct).numpy()
        out["kernel_counts"] = dict(comm.COUNTS)
        out["kernel_ragged"] = kfwd(prog_c.params, uct[:3]).numpy()
        out["kernel_ragged_1dev"] = kernel_backend.compile_program(prog_c, device="cpu")(
            prog_c.params, uct[:3]).numpy()
        out["sources"] = len(kfwd.sources)

        spec = NetworkSpec(**SPEC)
        synthesis.synthesize_cache_clear()
        r0 = synthesis.synthesize(spec, batch=8, backend="eager", measure=False, device="cpu")
        r1 = synthesis.synthesize(spec, batch=8, backend="eager", mesh=mesh, measure=False,
                                  device="cpu")
        r2 = synthesis.synthesize(spec, batch=8, backend="eager", mesh=mesh, measure=False,
                                  device="cpu")
        rk = synthesis.synthesize(NetworkSpec(**SPEC_C), batch=8, backend="kernel", mesh=mesh,
                                  measure=True, device="cpu")
    out["synth"] = (r0.cache_hit, r1.cache_hit, r2.cache_hit, r1.backend, r1.fallback_from,
                    rk.backend, rk.output_shape)
    out["ledger"] = sorted(r["program"] for r in obs.OBS.ledger.report())
    out["saw_jax"] = "jax" in sys.modules
    return out


@pytest.fixture(scope="module")
def runs():
    import jax

    from repro.codegen import build_program, pallas_backend, xla_backend
    from repro.core.synthesis import NetworkSpec as JaxSpec

    prog = build_program(JaxSpec(**SPEC))
    u = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8, 6, 8)))
    y0 = np.asarray(jax.jit(xla_backend.compile_program(prog))(prog.params, u))
    prog_c = build_program(JaxSpec(**SPEC_C))
    uc = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (4, 8, 6, 8)))
    yc0 = np.asarray(jax.jit(pallas_backend.compile_program(prog_c))(prog_c.params, uc))
    n_macc = sum(len(st.graph.macc_nodes()) for st in prog.stages)
    results = run_ranks(_ranks_synthesis, WORLD,
                        (jax.tree.map(np.asarray, prog.params), u,
                         jax.tree.map(np.asarray, prog_c.params), uc), timeout_s=300)
    return y0, yc0, n_macc, results


def test_eager_tp_matches_the_reference_with_one_all_reduce_a_contraction(runs):
    y0, _, n_macc, results = runs
    for rank, out in enumerate(results):
        assert not out["saw_jax"], rank
        np.testing.assert_allclose(out["eager_tp"], y0, atol=1e-5)
        np.testing.assert_allclose(out["eager_1dev"], y0, atol=1e-5, rtol=1e-5)
        # every rank returns the whole output, the same bits
        np.testing.assert_array_equal(out["eager_tp"], results[0]["eager_tp"])
        # one all-reduce per gate contraction per step, one join of the
        # data ranks' row blocks
        assert out["eager_counts"] == {"all_reduce": n_macc * SPEC["seq_len"],
                                       "gather_rows": 1}, out["eager_counts"]
        # a leading axis that dp does not divide runs whole on every rank
        np.testing.assert_allclose(out["eager_ragged"], y0[:3], atol=1e-5)
        np.testing.assert_allclose(out["eager_pods"], y0, atol=1e-5)
        assert out["ragged_counts"] == {"all_reduce": n_macc * SPEC["seq_len"]}
    print(f"eager TP vs the reference: max |err| = "
          f"{float(np.abs(results[0]['eager_tp'] - y0).max()):.3e}")


def test_kernel_backend_data_parallel_equals_its_unsharded_path(runs):
    _, yc0, _, results = runs
    for out in results:
        np.testing.assert_array_equal(out["kernel_dp"], out["kernel_1dev"])
        np.testing.assert_allclose(out["kernel_dp"], yc0, atol=1e-5)
        assert out["kernel_counts"] == {"gather_rows": 1}
        np.testing.assert_array_equal(out["kernel_ragged"], out["kernel_ragged_1dev"])
        assert out["sources"] == 1
    print(f"kernel dp=4 vs the reference's Pallas (interpret): max |err| = "
          f"{float(np.abs(results[0]['kernel_dp'] - yc0).max()):.3e}")


def test_synthesize_mesh_forks_the_memo_and_ledger_keys(runs):
    *_, results = runs
    for out in results:
        c0, c1, c2, backend, fallback, kbackend, kshape = out["synth"]
        assert (c0, c1, c2) == (False, False, True)      # distinct memo keys
        assert backend == "eager" and fallback is None
        assert kbackend == "kernel" and kshape == (4, 8, 4)
        assert any(p.endswith("|mesh4x2") and "|eager|" in p for p in out["ledger"])
        assert any(p.endswith("|mesh4x2") and "|kernel|" in p for p in out["ledger"])
        assert any("|eager|" in p and "mesh" not in p for p in out["ledger"])


def test_mesh_normalisation_and_refusals():
    from repro_torch.core import synthesis
    from repro_torch.core.synthesis import NetworkSpec

    spec = NetworkSpec(**SPEC)
    m = AbstractMesh((1, DP, TP), AXES)
    dev = torch.device("cpu")
    # ref and verilog ignore the mesh: same memo and ledger keys as without
    for bk in ("ref", "verilog"):
        assert synthesis._cache_key(spec, 8, bk, dev, m) == synthesis._cache_key(spec, 8, bk, dev)
        assert synthesis._ledger_key(spec, 8, bk, mesh=m) == synthesis._ledger_key(spec, 8, bk)
    for bk in ("eager", "kernel"):
        assert synthesis._cache_key(spec, 8, bk, dev, m) != synthesis._cache_key(spec, 8, bk, dev)
        assert synthesis._ledger_key(spec, 8, bk, mesh=m).endswith("|mesh4x2")
    # a mesh with no ranks behind it is refused, never run on one device
    with pytest.raises(RuntimeError, match="needs a DeviceMesh"):
        synthesis.synthesize(spec, batch=8, backend="eager", mesh=m, measure=False, device="cpu")
    r = synthesis.synthesize(dataclasses.replace(spec, seq_len=3), batch=2, backend="ref",
                             mesh=m, measure=False, device="cpu")
    assert r.backend == "ref"
