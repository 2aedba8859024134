"""Expert-parallel MoE on 8 gloo ranks against the reference's oracle.

The reference's ``tests/multidevice_scripts/run_ep_moe.py`` scenario: olmoe
smoke with ``n_experts=16, top_k=2, capacity_factor=1.5``, ``T_local=64``
tokens a rank, held against ``moe_apply(..., group_size=T_local)`` at the
script's bar of 2e-4.  The reference runs here, in the parent process; the
weights and tokens cross to the ranks as numpy arrays, and the ranks import
no JAX.  The script counts the all-to-alls in the compiled HLO; here the
port's counted collectives (``repro_torch.parallel.comm.COUNTS``) must show
exactly two ``all_to_all_single`` a layer.  deepseek smoke (one shared
expert) runs the same way, for the shared-expert path.
"""

import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.spawn import run_ranks  # noqa: E402

WORLD, T_LOCAL = 8, 64
BAR = 2e-4              # run_ep_moe.py's
CASES = {"olmoe-1b-7b": dict(n_experts=16, top_k=2, capacity_factor=1.5),
         "deepseek-v2-lite-16b": dict(n_experts=16, top_k=2, capacity_factor=1.5)}


def _ranks_ep(rank, world, cases):
    """One rank: every case's local rows and the collectives it issued."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe
    from repro_torch.parallel import comm
    from repro_torch.parallel.ep_moe import ep_moe_apply

    mesh = make_local_mesh()                       # (1, 1, world): EP over "model"
    out = {}
    for arch, (kw, p_np, x_np) in cases.items():
        cfg = dataclasses.replace(get_smoke_config(arch), **kw)
        p = {k: ({kk: torch.as_tensor(vv) for kk, vv in v.items()} if isinstance(v, dict)
                 else torch.as_tensor(v)) for k, v in p_np.items()}
        x = torch.as_tensor(x_np[rank * T_LOCAL:(rank + 1) * T_LOCAL])
        comm.reset_counts()
        with torch.no_grad():
            y = ep_moe_apply(p, cfg, x, mesh, axis="model")
            # the port's own one-device oracle on this rank's group
            y_own, _ = moe.moe_apply(p, cfg, x[None], group_size=T_LOCAL)
        out[arch] = (y.numpy(), y_own[0].numpy(), dict(comm.COUNTS))
    return out, "jax" in sys.modules


def _reference(arch, kw):
    import jax

    from repro import configs as jax_configs
    from repro.models import moe as jax_moe

    cfg = dataclasses.replace(jax_configs.get_smoke_config(arch), **kw)
    p = jax_moe.moe_params(jax.random.PRNGKey(0), cfg)
    D = cfg.d_model
    x = jax.random.normal(jax.random.PRNGKey(1), (WORLD * T_LOCAL, D)) * 0.5
    y_ref, _ = jax_moe.moe_apply(p, cfg, x.reshape(WORLD, T_LOCAL, D), group_size=T_LOCAL)
    p_np = jax.tree.map(np.asarray, p)
    return p_np, np.asarray(x), np.asarray(y_ref).reshape(WORLD * T_LOCAL, D)


def test_ep_moe_matches_the_reference_with_two_all_to_alls_a_layer():
    refs = {arch: _reference(arch, kw) for arch, kw in CASES.items()}
    cases = {arch: (CASES[arch], p_np, x_np) for arch, (p_np, x_np, _) in refs.items()}
    results = run_ranks(_ranks_ep, WORLD, (cases,), timeout_s=240)
    for rank, (out, saw_jax) in enumerate(results):
        assert not saw_jax, f"rank {rank} imported jax"
        for arch, (y, y_own, counts) in out.items():
            assert counts == {"all_to_all_single": 2}, (arch, rank, counts)
            np.testing.assert_allclose(y, y_own, atol=1e-5, rtol=1e-5)
    for arch, (_, _, y_ref) in refs.items():
        y_ep = np.concatenate([out[arch][0] for out, _ in results])
        err = float(np.max(np.abs(y_ep - y_ref)))
        print(f"{arch}: EP vs moe_apply(group_size={T_LOCAL}) max |err| = {err:.3e}")
        assert err < BAR, f"{arch}: EP vs einsum mismatch: {err}"
        assert np.abs(y_ref).max() > 0.1          # the experts did real work


def test_ep_moe_refuses_an_uneven_expert_split():
    results = run_ranks(_ranks_uneven, 3, timeout_s=120)
    assert all("do not split over 3 ranks" in r for r in results)


def _ranks_uneven(rank, world):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe
    from repro_torch.parallel.ep_moe import ep_moe_apply

    cfg = get_smoke_config("olmoe-1b-7b")            # 8 experts over 3 ranks
    p = moe.moe_params(torch.Generator().manual_seed(0), cfg)
    try:
        ep_moe_apply(p, cfg, torch.zeros(4, cfg.d_model), make_local_mesh())
    except ValueError as e:
        return str(e)
    return "no error"
