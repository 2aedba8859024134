"""The int8 error-feedback all-reduce (``repro_torch.parallel.compression``)
on 8 gloo ranks against the reference's ``_compress_psum_leaf``.

``tests/multidevice_scripts/run_compression.py``'s case: world 8, leaves
``w [32, 16]`` and ``b [16]`` (numpy seed 0 here), thirty steps on the same
gradients with the residual carried.  The oracle is the reference's
per-leaf step run in this process on one CPU device under
``jax.vmap(..., axis_name="data")``, whose ``pmax``/``psum`` reduce over the
mapped axis: every step's mean and every rank's residual must be its bits
exactly.  Then the script's bounds (one step within the int8 step size,
the thirty-step average within 0.2 of it) and its wire-format check: the
collective that carries the gradients is an integer one
(``comm.COUNTS``).
"""

import sys
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.spawn import run_ranks  # noqa: E402

WORLD, STEPS = 8, 30
SHAPES = {"w": (32, 16), "b": (16,)}


def _grads():
    rng = np.random.default_rng(0)
    return {"w": rng.normal(size=(WORLD, 32, 16)).astype(np.float32),
            "b": (0.1 * rng.normal(size=(WORLD, 16))).astype(np.float32)}


def _ranks_compress(rank, world, grads):
    """This rank's gradients through ``STEPS`` compressed all-reduces: each
    step's mean and residual, and the collectives of one call."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import comm
    from repro_torch.parallel.compression import init_error_feedback, make_compressed_allreduce

    allreduce = make_compressed_allreduce(make_local_mesh(world, 1), "data")
    g = {k: torch.as_tensor(v[rank]) for k, v in grads.items()}
    err = init_error_feedback(g)
    steps = []
    for i in range(STEPS):
        comm.reset_counts()
        mean, err = allreduce(g, err)
        steps.append(({k: v.numpy() for k, v in mean.items()},
                      {k: v.numpy() for k, v in err.items()}))
        counts = dict(comm.COUNTS)
    return steps, counts, "jax" in sys.modules


@pytest.fixture(scope="module")
def runs():
    grads = _grads()
    return grads, run_ranks(_ranks_compress, WORLD, (grads,), timeout_s=120)


@pytest.fixture(scope="module")
def oracle(runs):
    """The reference's leaf step under ``jax.vmap`` over the 8 ranks, the
    residual carried for ``STEPS`` steps: ``[(mean, err)]`` per step."""
    import jax
    import jax.numpy as jnp

    from repro.parallel.compression import _compress_psum_leaf

    grads, _ = runs
    step = jax.jit(jax.vmap(partial(_compress_psum_leaf, axis_name="data"), axis_name="data"))
    err = {k: jnp.zeros_like(v) for k, v in grads.items()}
    out = []
    for _ in range(STEPS):
        res = {k: step(jnp.asarray(grads[k]), err[k]) for k in grads}
        err = {k: r[1] for k, r in res.items()}
        out.append({k: (np.asarray(r[0]), np.asarray(r[1])) for k, r in res.items()})
    return out


@pytest.mark.parametrize("leaf", list(SHAPES))
def test_mean_and_residual_are_the_references_bits_every_step(runs, oracle, leaf):
    _, ranks = runs
    for i, want in enumerate(oracle):
        w_mean, w_err = want[leaf]
        for rank, (steps, _, _) in enumerate(ranks):
            mean, err = steps[i]
            assert mean[leaf].shape == SHAPES[leaf]
            assert np.array_equal(mean[leaf], w_mean[rank]), (
                f"step {i} rank {rank} {leaf} {SHAPES[leaf]}: mean differs by "
                f"{np.abs(mean[leaf] - w_mean[rank]).max():.3e}")
            assert np.array_equal(err[leaf], w_err[rank]), (
                f"step {i} rank {rank} {leaf} {SHAPES[leaf]}: residual differs by "
                f"{np.abs(err[leaf] - w_err[rank]).max():.3e}")


@pytest.mark.parametrize("leaf", list(SHAPES))
def test_run_compression_bounds(runs, leaf):
    from repro_torch.parallel.compression import reference_mean

    grads, ranks = runs
    exact = reference_mean({leaf: torch.as_tensor(grads[leaf])})[leaf].numpy()
    scale = float(np.abs(grads[leaf]).max()) / 127.0
    for steps, _, _ in ranks:
        # one step: the quantization error within the int8 step size
        assert float(np.abs(steps[0][0][leaf] - exact).max()) <= scale
        # error feedback: the average over the steps converges to the mean
        avg = sum(m[leaf] for m, _ in steps) / STEPS
        assert float(np.abs(avg - exact).max()) < 0.2 * scale


def test_the_payload_is_integer(runs):
    _, ranks = runs
    for _, counts, saw_jax in ranks:
        assert not saw_jax
        # per leaf: one max of the amax, one int32 sum of the codes
        assert counts == {"all_reduce_max": len(SHAPES), "all_reduce_int32": len(SHAPES)}
