"""The port's Mamba-1 path on the CPU against the JAX package: the selective
scan's plain version, the Mamba-1 block and the j-step transition library.

Inputs come from numpy seeds; block parameters are the reference's
(``repro.models.ssm.mamba1_params``) moved over as arrays.  Bars: the scan at
2e-5 in fp32 and 3e-2 in bf16 (the reference's own kernel bars,
``tests/test_kernels.py``); the plain Mamba-1 block and the transition
functions at 1e-5; the ``use_pallas`` block against the reference's Pallas
kernel (interpret mode) at the reference's own 2e-4 / 1e-3
(``tests/test_ssm.py``), as is prefill against a decode rollout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.core import transition as jax_tr  # noqa: E402
from repro.kernels.ssm_scan import ops as jax_scan_ops  # noqa: E402
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_scan_ref  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch._tree import tree_map  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import transition as tr  # noqa: E402
from repro_torch.kernels.ssm_scan import ops  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref  # noqa: E402
from repro_torch.models import lm, ssm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
KERNEL_TOL = dict(atol=2e-4, rtol=1e-3)
SHAPES = [(1, 32, 8, 4), (2, 64, 32, 8), (1, 128, 64, 16), (3, 96, 24, 4)]


def _close(pt, ref, **tol):
    np.testing.assert_allclose(np.asarray(pt.float()), np.asarray(ref, np.float32),
                               **(tol or TOL))


def _scan_arrays(Bsz, T, D, N, seed):
    r = np.random.default_rng(seed)
    return (r.normal(size=(Bsz, T, D)), r.uniform(0.001, 0.8, size=(Bsz, T, D)),
            -np.exp(r.normal(size=(D, N))), r.normal(size=(Bsz, T, N)),
            r.normal(size=(Bsz, T, N)))


def _both(arrays, dtype):
    """The same values for both packages: JAX arrays in ``dtype`` (A in fp32)
    and torch tensors made from their exact fp32 values."""
    j = [jnp.asarray(a, jnp.float32 if i == 2 else dtype) for i, a in enumerate(arrays)]
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    t = [torch.as_tensor(np.array(a, np.float32)).to(torch.float32 if i == 2 else tdt)
         for i, a in enumerate(j)]
    return j, t


# ---------------------------------------------------------------------------
# ssm_scan: the plain version against the reference's kernel and oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Bsz,T,D,N", SHAPES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_ssm_scan_plain_matches_reference(Bsz, T, D, N, dtype):
    (x, dl, A, B, C), (xt, dlt, At, Bt, Ct) = _both(_scan_arrays(Bsz, T, D, N, seed=T + D), dtype)
    y_k, h_k = jax_scan_ops.ssm_scan(x, dl, A, B, C, chunk=32, block_d=16, w=8)
    y_r, h_r = jax_scan_ref(x, dl, A, B, C, jnp.zeros((Bsz, D, N)))
    y, h = ops.ssm_scan(xt, dlt, At, Bt, Ct)
    assert y.dtype == xt.dtype and h.dtype == torch.float32
    assert tuple(y.shape) == (Bsz, T, D) and tuple(h.shape) == (Bsz, D, N)
    tol = 2e-5 if dtype == jnp.float32 else 3e-2
    for want_y, want_h in ((y_k, h_k), (y_r, h_r)):
        _close(y, want_y, atol=tol, rtol=tol)
        _close(h, want_h, atol=tol, rtol=tol)


def test_ssm_scan_carry_is_an_input():
    """A nonzero h0 is an input of the port's scan (the reference's wrapper
    falls back to its oracle for it): the scan split in two and resumed from
    h_final gives the one-shot result bit for bit, and matches the
    reference's resumed scan."""
    arrays = _scan_arrays(2, 64, 16, 4, seed=5)
    (x, dl, A, B, C), (xt, dlt, At, Bt, Ct) = _both(arrays, jnp.float32)
    y_full, h_full = ops.ssm_scan(xt, dlt, At, Bt, Ct)
    k = 23
    y1, h_mid = ops.ssm_scan(xt[:, :k], dlt[:, :k], At, Bt[:, :k], Ct[:, :k])
    y2, h_end = ops.ssm_scan(xt[:, k:], dlt[:, k:], At, Bt[:, k:], Ct[:, k:], h0=h_mid)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y_full, atol=0, rtol=0)
    torch.testing.assert_close(h_end, h_full, atol=0, rtol=0)
    h0 = np.random.default_rng(6).normal(size=(2, 16, 4)).astype(np.float32)
    y_j, h_j = jax_scan_ops.ssm_scan(x, dl, A, B, C, h0=jnp.asarray(h0))
    y_p, h_p = ops.ssm_scan(xt, dlt, At, Bt, Ct, h0=torch.as_tensor(h0))
    _close(y_p, y_j, atol=2e-5, rtol=2e-5)
    _close(h_p, h_j, atol=2e-5, rtol=2e-5)


def test_ssm_scan_cpu_path_is_the_plain_version():
    """A CPU tensor takes ref.ssm_scan_ref and never counts a launch; T = 1
    and a prime T with ragged D go through the same loop."""
    ops.ssm_scan.launches = 0
    for Bsz, T, D, N in ((3, 1, 5, 3), (2, 17, 7, 16)):
        _, (xt, dlt, At, Bt, Ct) = _both(_scan_arrays(Bsz, T, D, N, seed=T), jnp.float32)
        h0 = torch.zeros((Bsz, D, N))
        got = ops.ssm_scan(xt, dlt, At, Bt, Ct)
        want = ssm_scan_ref(xt, dlt, At, Bt, Ct, h0)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=0, rtol=0)
    assert ops.ssm_scan.launches == 0


# ---------------------------------------------------------------------------
# the Mamba-1 block (falcon-mamba-7b smoke widths)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def block():
    jcfg = dataclasses.replace(jax_configs.get_smoke_config("falcon-mamba-7b"), remat=False)
    cfg = get_smoke_config("falcon-mamba-7b")
    p_j = jax_ssm.mamba1_params(jax.random.PRNGKey(0), jcfg)
    p_t = tree_map(lambda a: torch.as_tensor(np.array(a)), jax.tree.map(np.asarray, p_j))
    return jcfg, cfg, p_j, p_t


def _u(B, T, d, seed):
    a = (np.random.default_rng(seed).normal(size=(B, T, d)) * 0.5).astype(np.float32)
    return jnp.asarray(a), torch.as_tensor(a)


def _carry(cfg, B, seed):
    r = np.random.default_rng(seed)
    h = (r.normal(size=(B, cfg.d_inner, cfg.ssm_state)) * 0.3).astype(np.float32)
    conv = (r.normal(size=(B, cfg.d_conv - 1, cfg.d_inner)) * 0.5).astype(np.float32)
    return h, conv


def test_mamba1_params_layout_matches_reference(block):
    jcfg, cfg, p_j, _ = block
    p = ssm.mamba1_params(torch.Generator().manual_seed(0), cfg)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in p_j.items()}
    _close(p["A_log"], p_j["A_log"])
    _close(p["D"], p_j["D"])
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 0.1 * (1 + 1e-5)


def test_causal_conv1d_and_conv_step_match_reference(block):
    _, cfg, p_j, p_t = block
    uj, ut = _u(2, 9, cfg.d_inner, seed=1)
    _, conv = _carry(cfg, 2, seed=2)
    for tail in (None, conv):
        want = jax_ssm.causal_conv1d(uj, p_j["conv_w"], p_j["conv_b"] + 0.1,
                                     tail=None if tail is None else jnp.asarray(tail))
        got = ssm.causal_conv1d(ut, p_t["conv_w"], p_t["conv_b"] + 0.1,
                                tail=None if tail is None else torch.as_tensor(tail))
        _close(got, want)
    st_j, y_j = jax_ssm.conv_step(jnp.asarray(conv), uj[:, 0], p_j["conv_w"], p_j["conv_b"])
    st_t, y_t = ssm.conv_step(torch.as_tensor(conv), ut[:, 0], p_t["conv_w"], p_t["conv_b"])
    _close(st_t, st_j)
    _close(y_t, y_j)


@pytest.mark.parametrize("resume", ["fresh", "h0", "state"])
def test_mamba1_prefill_plain_matches_reference(block, resume):
    jcfg, cfg, p_j, p_t = block
    uj, ut = _u(2, 12, cfg.d_model, seed=3)
    h, conv = _carry(cfg, 2, seed=4)
    kw_j, kw_t = {}, {}
    if resume == "h0":
        kw_j, kw_t = dict(h0=jnp.asarray(h)), dict(h0=torch.as_tensor(h))
    elif resume == "state":
        kw_j = dict(state={"h": jnp.asarray(h), "conv": jnp.asarray(conv)})
        kw_t = dict(state={"h": torch.as_tensor(h), "conv": torch.as_tensor(conv)})
    y_j, st_j = jax_ssm.mamba1_prefill(p_j, jcfg, uj, **kw_j)
    y_t, st_t = ssm.mamba1_prefill(p_t, cfg, ut, **kw_t)
    _close(y_t, y_j)
    _close(st_t["h"], st_j["h"])
    _close(st_t["conv"], st_j["conv"])


@pytest.mark.parametrize("bare_h0", [False, True])
def test_mamba1_use_pallas_matches_reference_kernel_path(block, bare_h0):
    """``use_pallas`` on both sides: the reference's Pallas kernel in
    interpret mode (its fallback oracle for a live h0) against the port's
    wrapper, which on the CPU runs the plain version."""
    jcfg, cfg, p_j, p_t = block
    jcfg, cfg = (dataclasses.replace(c, use_pallas=True) for c in (jcfg, cfg))
    uj, ut = _u(2, 32, cfg.d_model, seed=5)
    h, _ = _carry(cfg, 2, seed=6)
    kw_j = dict(h0=jnp.asarray(h)) if bare_h0 else {}
    kw_t = dict(h0=torch.as_tensor(h)) if bare_h0 else {}
    y_j, st_j = jax_ssm.mamba1_prefill(p_j, jcfg, uj, **kw_j)
    y_t, st_t = ssm.mamba1_prefill(p_t, cfg, ut, **kw_t)
    _close(y_t, y_j, **KERNEL_TOL)
    _close(st_t["h"], st_j["h"], atol=1e-4, rtol=1e-3)
    _close(st_t["conv"], st_j["conv"])


@pytest.mark.parametrize("use_pallas", [False, True])
def test_mamba1_chunk_invariance(block, use_pallas):
    """Chained state= resumes over chunks of 5 and 16 steps reproduce the
    one-shot prefill (the reference holds its chunking to 1e-4)."""
    _, cfg, _, p_t = block
    cfg = dataclasses.replace(cfg, use_pallas=use_pallas)
    _, ut = _u(2, 37, cfg.d_model, seed=7)
    y_one, st_one = ssm.mamba1_prefill(p_t, cfg, ut)
    for c in (5, 16):
        st = ssm.mamba1_init_state(cfg, 2, "cpu")
        ys = []
        for s in range(0, 37, c):
            y, st = ssm.mamba1_prefill(p_t, cfg, ut[:, s:s + c], state=st)
            ys.append(y)
        torch.testing.assert_close(torch.cat(ys, dim=1), y_one, **TOL)
        for k in ("h", "conv"):
            torch.testing.assert_close(st[k], st_one[k], **TOL)


def test_mamba1_prefill_equals_decode_rollout(block):
    """T tokens through prefill == T applications of the decode step (the
    state-space map f), at the reference's own bar."""
    _, cfg, _, p_t = block
    _, ut = _u(2, 12, cfg.d_model, seed=8)
    y_pre, st_pre = ssm.mamba1_prefill(p_t, cfg, ut)
    st = ssm.mamba1_init_state(cfg, 2, "cpu")
    ys = []
    for t in range(12):
        y, st = ssm.mamba1_decode(p_t, cfg, ut[:, t:t + 1], st)
        ys.append(y)
    torch.testing.assert_close(torch.cat(ys, dim=1), y_pre, **KERNEL_TOL)
    torch.testing.assert_close(st["h"], st_pre["h"], **KERNEL_TOL)
    torch.testing.assert_close(st["conv"], st_pre["conv"], atol=1e-5, rtol=0)


def test_mamba1_decode_matches_reference(block):
    jcfg, cfg, p_j, p_t = block
    uj, ut = _u(3, 1, cfg.d_model, seed=9)
    h, conv = _carry(cfg, 3, seed=10)
    y_j, st_j = jax_ssm.mamba1_decode(p_j, jcfg, uj, {"h": jnp.asarray(h),
                                                       "conv": jnp.asarray(conv)})
    y_t, st_t = ssm.mamba1_decode(p_t, cfg, ut, {"h": torch.as_tensor(h),
                                                  "conv": torch.as_tensor(conv)})
    _close(y_t, y_j)
    _close(st_t["h"], st_j["h"])
    _close(st_t["conv"], st_j["conv"])
    init = ssm.mamba1_init_state(cfg, 3, "cpu")
    init_j = jax_ssm.mamba1_init_state(jcfg, 3)
    assert {k: (tuple(v.shape), v.dtype) for k, v in init.items()} == \
        {k: (tuple(v.shape), torch.float32) for k, v in init_j.items()}


def test_mamba2_family_raises_naming_the_roadmap():
    cfg = ModelConfig(**dataclasses.asdict(jax_configs.get_smoke_config("zamba2-1.2b")))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


# ---------------------------------------------------------------------------
# the j-step transition library
# ---------------------------------------------------------------------------

def _affine(T, shape, seed):
    r = np.random.default_rng(seed)
    a = r.uniform(0.5, 1.0, size=(T,) + shape).astype(np.float32)
    b = r.normal(size=(T,) + shape).astype(np.float32)
    h0 = r.normal(size=shape).astype(np.float32)
    return a, b, h0


@pytest.mark.parametrize("name,T,chunk", [
    ("serial", 1, None), ("serial", 37, None),
    ("assoc", 1, None), ("assoc", 16, None), ("assoc", 37, None),
    ("chunked", 16, 4), ("chunked", 36, 12), ("chunked", 8, 8),
])
def test_linear_recurrences_match_reference(name, T, chunk):
    a, b, h0 = _affine(T, (3, 5), seed=T)
    extra = () if chunk is None else (chunk,)
    want = getattr(jax_tr, f"linear_recurrence_{name}")(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0), *extra)
    at, bt, ht = (torch.as_tensor(x) for x in (a, b, h0))
    got = getattr(tr, f"linear_recurrence_{name}")(at, bt, ht, *extra)
    _close(got, want)
    torch.testing.assert_close(got, tr.linear_recurrence_serial(at, bt, ht), **TOL)


def test_chunked_recurrence_rejects_a_ragged_chunk():
    a, b, h0 = (torch.as_tensor(x) for x in _affine(10, (2,), seed=0))
    with pytest.raises(ValueError, match="not divisible"):
        tr.linear_recurrence_chunked(a, b, h0, 4)


def test_affine_compose_matches_reference():
    (a1, b1, _), (a2, b2, _) = _affine(4, (3,), seed=1), _affine(4, (3,), seed=2)
    want = jax_tr.affine_compose((jnp.asarray(a1), jnp.asarray(b1)),
                                 (jnp.asarray(a2), jnp.asarray(b2)))
    got = tr.affine_compose((torch.as_tensor(a1), torch.as_tensor(b1)),
                            (torch.as_tensor(a2), torch.as_tensor(b2)))
    for g, w in zip(got, want):
        _close(g, w)


def _dense(T, M, seed):
    r = np.random.default_rng(seed)
    A = (r.normal(size=(T, M, M)) / np.sqrt(M)).astype(np.float32)
    x0 = r.normal(size=(M,)).astype(np.float32)
    return A, x0


@pytest.mark.parametrize("j", [1, 4, 12])
def test_dense_jstep_scan_matches_reference(j):
    """Φ blocks of j composed in parallel, then T/j serial applications:
    equal to the reference's and to the step-by-step product."""
    A, x0 = _dense(24, 6, seed=j)
    want = jax_tr.jstep_dense_scan(jnp.asarray(A), jnp.asarray(x0), j)
    got = tr.jstep_dense_scan(torch.as_tensor(A), torch.as_tensor(x0), j)
    _close(got, want)
    step = tr.stepwise_dense_scan(torch.as_tensor(A), torch.as_tensor(x0))
    _close(step, jax_tr.stepwise_dense_scan(jnp.asarray(A), jnp.asarray(x0)))
    torch.testing.assert_close(got, step, **TOL)
    with pytest.raises(ValueError, match="not divisible"):
        tr.jstep_dense_scan(torch.as_tensor(A[:7]), torch.as_tensor(x0), 2)


def test_compose_dense_matches_reference():
    A, _ = _dense(5, 4, seed=3)
    _close(tr.compose_dense(torch.as_tensor(A)), jax_tr.compose_dense(jnp.asarray(A)))
    assert tr.serial_depth_estimate(256, 8) == jax_tr.serial_depth_estimate(256, 8)
