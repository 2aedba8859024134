"""The GPipe/C-slow pipeline (``repro_torch.parallel.pipeline``) on 4 gloo
ranks against the reference.

``tests/multidevice_scripts/run_pipeline.py``'s case: P = 4 stages of
``tanh(x @ w + b)``, C = 6 microbatches of 8 rows, D = 16, the reference's
weights and microbatches (drawn by its ``jax.random`` keys here, in the
parent) bridged as numpy arrays.  The output on every rank is within 1e-5
of the reference's ``sequential_reference`` and of the port's, and one call
makes exactly C + P − 1 ring transfers (the script finds the
``collective-permute`` in its HLO) and one final sum.
"""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.spawn import run_ranks  # noqa: E402

P_STAGES, C, MB, D = 4, 6, 8, 16
ATOL = 1e-5      # run_pipeline.py's


def _stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _ranks_pipeline(rank, world, params, mb):
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.parallel import comm
    from repro_torch.parallel.pipeline import pipeline_apply, sequential_reference

    mesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("stage",))
    p = {k: torch.as_tensor(v) for k, v in params.items()}
    x = torch.as_tensor(mb)
    comm.reset_counts()
    out = pipeline_apply(_stage, p, x, mesh)
    counts = dict(comm.COUNTS)
    return out.numpy(), sequential_reference(_stage, p, x).numpy(), counts, "jax" in sys.modules


@pytest.fixture(scope="module")
def case():
    import jax
    import jax.numpy as jnp

    from repro.parallel.pipeline import sequential_reference

    key = jax.random.PRNGKey(0)
    params = {"w": jax.random.normal(key, (P_STAGES, D, D)) / np.sqrt(D),
              "b": 0.1 * jax.random.normal(key, (P_STAGES, D))}
    mb = jax.random.normal(jax.random.PRNGKey(1), (C, MB, D))
    ref = sequential_reference(lambda p, x: jnp.tanh(x @ p["w"] + p["b"]), params, mb)
    params = jax.tree.map(np.asarray, params)
    return np.asarray(ref), run_ranks(_ranks_pipeline, P_STAGES, (params, np.asarray(mb)),
                                      timeout_s=120)


def test_pipeline_matches_the_references_sequential_run(case):
    ref, ranks = case
    for out, _, _, saw_jax in ranks:
        assert out.shape == (C, MB, D) and not saw_jax
        np.testing.assert_allclose(out, ref, atol=ATOL)


def test_pipeline_matches_the_ports_sequential_run(case):
    _, ranks = case
    for out, seq, _, _ in ranks:
        np.testing.assert_allclose(out, seq, atol=ATOL)


def test_one_ring_transfer_a_tick(case):
    _, ranks = case
    for _, _, counts, _ in ranks:
        assert counts == {"ppermute": C + P_STAGES - 1, "all_reduce": 1}
