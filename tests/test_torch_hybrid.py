"""The port's hybrid family (``zamba2-1.2b``: Mamba-2 / SSD blocks and one
shared transformer block applied with per-application LoRA) on the CPU
against the JAX reference.

Parameters are drawn by the reference (``repro.models.lm.init_params``,
``jax.random.PRNGKey(0)``) and bridged; inputs come from numpy seeds.  The
reference initialises some leaves to constants that hide half a block
(LoRA ``qB``/``kB``/``vB`` zero, so LoRA is the identity; ``dt_bias`` and
the conv biases zero; ``D`` one), so every test here first draws those
leaves anew from a seed, nonzero, on both sides.

Bars: 1e-5 (fp32, atol = rtol) on the block functions wherever the SSD
runs chunks of one step (T = 1, 131) or a short chunk (T = 7), on decode
from equal states, the shared block and the splice; 1e-4 on what follows a
long SSD chunk (T >= 100) and on the whole model (logits and every state
leaf, the bar ``test_torch_dense_local.py`` holds gemma3 to).  The reason
is the reference's own rounding, measured by
``test_ssd_chunk_matches_reference_on_identical_inputs``: within a chunk
of 128 the cumulative log-decay reaches hundreds and the pairwise decays
are differences of it, so ONE ulp of Δ moves the reference's own output by
~5e-5, and the port's Δ comes out of its own matmul.  On identical inputs
the port's SSD gives the reference's numbers within 1e-6.  Greedy tokens
equal.

On zamba2 the reference's ``DecodeServer`` is no oracle: its
``splice_cache`` drops the two tail Mamba-2 states (ROADMAP.md, Queue 3).
The port's server is held against the reference *model's* greedy loop
(``prefill_chunk`` over the prompt from a fresh cache, then
``decode_step``), and one test shows that the reference server leaves it.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models import transformer as jax_tr  # noqa: E402
from repro.runtime import server as jax_server  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch._tree import tree_map  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.models import lm, ssm, transformer  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.runtime import AsyncServer  # noqa: E402
from repro_torch.runtime.prefix_cache import tree_bytes  # noqa: E402
from repro_torch.runtime.server import DecodeServer, Request, splice_cache  # noqa: E402

ARCH = "zamba2-1.2b"
TOL = dict(atol=1e-5, rtol=1e-5)
SSD_TOL = dict(atol=1e-4, rtol=1e-4)
MAX_SEQ = 192

# prompts either side of the smoke SSD chunk (128; 131 is prime, so its
# one-shot scan runs chunks of 1, and 160 runs five of 32); two slots, so
# slots are reused and hold an earlier request's states
PROMPTS = [(20, 10), (7, 12), (131, 6), (33, 8), (160, 5), (12, 6)]
DRIVERS = {"step": (False, 0), "step_block": (True, 0), "chunked": (False, 16)}


def _prompt(n, seed, vocab=256):
    return [int(t) for t in np.random.default_rng(seed).integers(1, vocab, n)]


def _perturb(tree, seed=0):
    """A copy of a reference parameter tree (numpy leaves) whose
    constant-initialised leaves are drawn anew, nonzero: every
    ``shared_attn`` block's LoRA ``qB``/``kB``/``vB`` and every ``mamba2``
    block's ``dt_bias``, ``D``, ``conv_b_x`` and ``conv_b_bc``."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(np.array, tree)
    for top in ("groups", "tail"):
        for name, blk in out.get(top, {}).items():
            if name.endswith("_shared_attn"):
                lo = blk["lora"]
                for leaf in ("qB", "kB", "vB"):
                    r = lo[leaf].shape[-2]
                    lo[leaf] = (rng.normal(size=lo[leaf].shape) / np.sqrt(r)).astype(np.float32)
            elif name.endswith("_mamba2"):
                m = blk["mamba"]
                m["dt_bias"] = rng.normal(-1.0, 0.5, m["dt_bias"].shape).astype(np.float32)
                m["D"] = rng.normal(1.0, 0.5, m["D"].shape).astype(np.float32)
                for leaf in ("conv_b_x", "conv_b_bc"):
                    m[leaf] = rng.normal(0.0, 0.5, m[leaf].shape).astype(np.float32)
    return out


def _bridged(**over):
    jcfg = dataclasses.replace(jax_configs.get_smoke_config(ARCH), **over)
    tree = _perturb(jax_lm.init_params(jcfg, jax.random.PRNGKey(0)))
    cfg = dataclasses.replace(get_smoke_config(ARCH), **over)
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), bridge.params_from_jax(tree, cfg, "cpu")


@pytest.fixture(scope="module")
def zamba():
    return _bridged()


_JIT = {}


def _ref(fn, static=(1,)):
    """A reference function, jitted once (its cfg argument static)."""
    if (fn, static) not in _JIT:
        _JIT[fn, static] = jax.jit(fn, static_argnums=static)
    return _JIT[fn, static]


def _close(pt, ref, **tol):
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(ref), **(tol or TOL))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, path + (key,)).items()}
    return {path: tree}


def _close_tree(pt, ref, **tol):
    flat_pt = _flat(pt)
    flat_ref = {tuple(getattr(p, "key", p) for p in path): v
                for path, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert set(flat_pt) == set(flat_ref)
    for k, v in flat_ref.items():
        _close(flat_pt[k], v, **tol)


def _ref_greedy(jcfg, p_j, prompt, n, chunk=8):
    """The reference model's greedy loop: the prompt in chained chunks of
    ``chunk`` from a fresh cache, then ``decode_step``."""
    cache = jax_lm.init_cache(jcfg, 1, MAX_SEQ)
    for s in range(0, len(prompt), chunk):
        lg, cache = _ref(jax_lm.prefill_chunk)(
            p_j, jcfg, jnp.asarray([prompt[s:s + chunk]], jnp.int32), cache, jnp.int32(s))
    out = [int(np.argmax(np.asarray(lg[0])))]
    pos = len(prompt)
    while len(out) < n:
        lg, cache = _ref(jax_lm.decode_step)(p_j, jcfg, jnp.asarray([[out[-1]]], jnp.int32),
                                             cache, jnp.int32(pos))
        out.append(int(np.argmax(np.asarray(lg[0]))))
        pos += 1
    return out


_GREEDY = {}


def _greedy(jcfg, p_j, prompt, n):
    key = (tuple(prompt), n)
    if key not in _GREEDY:
        _GREEDY[key] = _ref_greedy(jcfg, p_j, prompt, n)
    return _GREEDY[key]


# ---------------------------------------------------------------------------
# the config, the layouts, the bridge
# ---------------------------------------------------------------------------

def test_config_registered_and_equal_to_reference():
    assert ARCH in ARCH_IDS
    for ours, theirs in ((get_config(ARCH), jax_configs.get_config(ARCH)),
                         (get_smoke_config(ARCH), jax_configs.get_smoke_config(ARCH))):
        assert ours == ModelConfig(**dataclasses.asdict(theirs))
        assert (ours.layer_pattern, ours.n_groups) == (theirs.layer_pattern, theirs.n_groups)
        assert ours.kv_cache_bytes(3, 777) == theirs.kv_cache_bytes(3, 777)
    cfg = get_config(ARCH)
    assert cfg.layer_pattern == ("mamba2",) * 5 + ("shared_attn",) and cfg.n_groups == 6
    assert cfg.tail_pattern == ("mamba2", "mamba2") and cfg.n_mamba_heads == 64


def test_full_width_param_count_and_cache_bytes():
    """zamba2-1.2b at its published widths: 1 026 412 544 parameters
    (counted from shapes), and ``init_cache``'s bytes per slot: 32 Mamba-2
    states of 1 MiB ``h`` and 50 688 conv bytes, and the six shared K/V
    caches at 96 KiB a position in fp32.  ``kv_cache_bytes`` (the
    reference's estimate) counts K/V in bf16 and leaves out the tail."""
    cfg = get_config(ARCH)
    D, DI, N, K, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.d_conv, cfg.n_mamba_heads
    mamba2 = D + 2 * D * DI + 2 * D * N + D * H + K * (DI + 2 * N) + DI + 2 * N + 3 * H \
        + DI + DI * D
    r, hd = cfg.shared_attn_lora_rank, cfg.head_dim
    lora = 2 * D + 3 * (D * r + r * cfg.n_heads * hd)
    shared = 4 * D * cfg.n_heads * hd + 3 * D * cfg.d_ff
    total = 32 * mamba2 + 6 * lora + shared + 2 * cfg.vocab * D + D
    assert total == 1_026_412_544
    S = 16
    got = tree_bytes(lm.init_cache(cfg, 1, S, "cpu"))
    state = 4 * (H * cfg.mamba_headdim * N + (K - 1) * (DI + 2 * N))
    assert state == (1 << 20) + 50_688
    assert got == 32 * state + S * 98_304
    # kv_cache_bytes: 6 groups of 5 states and K/V at 2 bytes an element
    assert got == cfg.kv_cache_bytes(1, S) + 2 * state + 6 * 2 * S * 2048 * 2


def test_init_params_and_cache_layout_match_reference(zamba):
    jcfg, cfg, p_j, _ = zamba
    p = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), p) == \
        jax.tree.map(lambda a: tuple(a.shape), p_j)
    assert set(p) == {"embed", "groups", "shared", "tail", "final_norm", "head"}
    assert lm.param_count(p) == jax_lm.param_count(p_j)
    for B, S in ((3, 8), (2, 40)):
        assert jax.tree.map(lambda t: tuple(t.shape), lm.init_cache(cfg, B, S, "cpu")) == \
            jax.tree.map(lambda a: tuple(a.shape), jax_lm.init_cache(jcfg, B, S))
    c = lm.init_cache(cfg, 2, 40, "cpu")
    assert c["groups"]["b0_mamba2"]["h"].shape == (2, 2, 4, 32, 16)
    assert c["groups"]["b0_mamba2"]["conv"]["bc"].shape == (2, 2, 3, 32)
    assert c["groups"]["b2_shared_attn"]["k"].shape == (2, 2, 40, 4, 16)   # never a ring
    assert c["tail"]["t1_mamba2"]["conv"]["x"].shape == (2, 3, 128)        # no G axis


def test_mamba2_params_keys_and_shapes_match_reference(zamba):
    jcfg, cfg, _, _ = zamba
    got = ssm.mamba2_params(torch.Generator().manual_seed(0), cfg)
    want = jax_ssm.mamba2_params(jax.random.PRNGKey(1), jcfg)
    assert jax.tree.map(lambda t: tuple(t.shape), got) == \
        jax.tree.map(lambda a: tuple(a.shape), want)
    assert set(got) == {"w_z", "w_x", "w_bc", "w_dt", "conv_w_x", "conv_b_x", "conv_w_bc",
                        "conv_b_bc", "dt_bias", "A_log", "D", "norm", "out_proj"}


def test_bridge_checks_the_shared_block(zamba):
    jcfg, cfg, p_j, _ = zamba
    tree = jax.tree.map(np.asarray, p_j)
    without = {k: v for k, v in tree.items() if k != "shared"}
    with pytest.raises(ValueError, match="'shared' subtree is missing"):
        bridge.params_from_jax(without, cfg, "cpu")
    falcon = get_smoke_config("falcon-mamba-7b")
    with pytest.raises(ValueError, match="'shared' subtree is given"):
        bridge.params_from_jax({"groups": {"b0_mamba1": {}}, "shared": {}}, falcon, "cpu")
    c = bridge.cache_from_jax(jax.tree.map(np.asarray, jax_lm.init_cache(jcfg, 2, 20)), "cpu")
    assert c["tail"]["t0_mamba2"]["conv"]["bc"].shape == (2, 3, 32)
    assert c["groups"]["b1_mamba2"]["conv"]["x"].dtype == torch.float32


# ---------------------------------------------------------------------------
# Mamba-2 / SSD block functions
# ---------------------------------------------------------------------------

def _mamba(bridged):
    """Block b0_mamba2's parameters of group 0, both sides."""
    jcfg, cfg, p_j, p_pt = bridged
    pj = jax.tree.map(lambda a: a[0], p_j["groups"]["b0_mamba2"]["mamba"])
    pp = tree_map(lambda t: t[0], p_pt["groups"]["b0_mamba2"]["mamba"])
    return jcfg, cfg, pj, pp


def _u(cfg, B, T, seed):
    return np.random.default_rng(seed).normal(size=(B, T, cfg.d_model)).astype(np.float32)


def _state(cfg, B, seed):
    """A nonzero decode-layout Mamba-2 state (numpy leaves)."""
    r = np.random.default_rng(seed)
    f = lambda *s: (0.5 * r.normal(size=s)).astype(np.float32)
    k = cfg.d_conv - 1
    return {"h": f(B, cfg.n_mamba_heads, cfg.mamba_headdim, cfg.ssm_state),
            "conv": {"x": f(B, k, cfg.d_inner), "bc": f(B, k, 2 * cfg.ssm_state)}}


def _both(tree):
    return jax.tree.map(jnp.asarray, tree), tree_map(torch.as_tensor, tree)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("T", [1, 7, 128, 131, 256])
def test_mamba2_prefill_matches_reference(zamba, T, with_h0):
    """T = 131 is prime, so both sides run the SSD in chunks of 1; 256
    runs two of 128 (bar 1e-4 after a chunk of 128, module docstring)."""
    jcfg, cfg, pj, pp = _mamba(zamba)
    assert ssm.ssd_chunk_size(T) == {1: 1, 7: 7, 128: 128, 131: 1, 256: 128}[T]
    u = _u(cfg, 2, T, seed=T)
    h0_j = h0_pt = None
    if with_h0:
        h0_j, h0_pt = _both(_state(cfg, 2, seed=T + 1)["h"])
    y_j, st_j = _ref(jax_ssm.mamba2_prefill)(pj, jcfg, jnp.asarray(u), h0_j)
    y_pt, st_pt = ssm.mamba2_prefill(pp, cfg, torch.as_tensor(u), h0_pt)
    tol = SSD_TOL if T >= 128 and T != 131 else TOL
    _close(y_pt, y_j, **tol)
    _close_tree(st_pt, st_j, **tol)


@pytest.mark.parametrize("T,dt_scale", [(128, 0.05), (128, 0.3), (160, 1.0)])
def test_ssd_chunk_matches_reference_on_identical_inputs(T, dt_scale):
    """``_ssd_chunk`` on the same fp32 inputs as the reference's (the
    cumulative log-decay summed in the reference's order) agrees with it
    at 1e-5 and is as close as it is to the same function in fp64.  The
    reference's own output moves by more than 1e-5 when Δ moves by one
    ulp once Δ·A sums to hundreds within a chunk (Δ ~ 0.3 and up): the
    floor under every comparison of inputs computed apart."""
    r = np.random.default_rng(T)
    Bsz, H, P, N = 2, 4, 32, 16
    x = r.normal(size=(Bsz, T, H, P)).astype(np.float32)
    dt = (dt_scale * r.uniform(0.2, 2.0, size=(Bsz, T, H))).astype(np.float32)
    Bm, Cm = (r.normal(size=(Bsz, T, N)).astype(np.float32) for _ in range(2))
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    h0 = (0.5 * r.normal(size=(Bsz, H, P, N))).astype(np.float32)
    args = (x, dt, Bm, Cm, A, h0)
    ref = _ref(jax_ssm._ssd_chunk, static=(6,))
    y_j, h_j = ref(*args, 128)
    y_pt, h_pt = ssm._ssd_chunk(*map(torch.as_tensor, args), 128)
    y_64, h_64 = ssm._ssd_chunk(*(torch.as_tensor(a).double() for a in args), 128)
    _close(y_pt, y_j)
    _close(h_pt, h_j)
    err_ref = float(np.abs(np.asarray(y_j) - y_64.numpy()).max())
    err_pt = float((y_pt.double() - y_64).abs().max())
    assert err_pt <= 1.5 * err_ref + 1e-6, (err_pt, err_ref)
    up = np.where(r.random(dt.shape) < 0.5, np.float32(np.inf), np.float32(-np.inf))
    y_ulp, _ = ref(x, np.nextafter(dt, up.astype(np.float32)), Bm, Cm, A, h0, 128)
    moved = float(np.abs(np.asarray(y_ulp) - np.asarray(y_j)).max())
    assert (moved > 1e-5) == (dt_scale >= 0.3), moved


@pytest.mark.parametrize("pieces", [(100, 31), (128, 128), (160, 96)])
def test_mamba2_resume_and_decode_match_reference(zamba, pieces):
    """The scan chained through ``state=`` in two pieces from a nonzero
    state: a piece of 160 runs five SSD chunks of 32, so the resume starts
    inside a multi-chunk scan.  Then 8 ``mamba2_decode`` steps from the
    states reached (bar 1e-4, module docstring) and 8 from equal states
    (1e-5)."""
    jcfg, cfg, pj, pp = _mamba(zamba)
    u = _u(cfg, 2, sum(pieces), seed=sum(pieces))
    st_j, st_pt = _both(_state(cfg, 2, seed=7))
    s = 0
    for n in pieces:
        y_j, st_j = _ref(jax_ssm.mamba2_prefill)(pj, jcfg, jnp.asarray(u[:, s:s + n]),
                                                 state=st_j)
        y_pt, st_pt = ssm.mamba2_prefill(pp, cfg, torch.as_tensor(u[:, s:s + n]), state=st_pt)
        _close(y_pt, y_j, **SSD_TOL)
        _close_tree(st_pt, st_j, **SSD_TOL)
        s += n
    ud = _u(cfg, 2, 8, seed=99)
    for t in range(8):
        y_j, st_j = _ref(jax_ssm.mamba2_decode)(pj, jcfg, jnp.asarray(ud[:, t:t + 1]), st_j)
        y_pt, st_pt = ssm.mamba2_decode(pp, cfg, torch.as_tensor(ud[:, t:t + 1]), st_pt)
        _close(y_pt, y_j, **SSD_TOL)
    _close_tree(st_pt, st_j, **SSD_TOL)
    # from equal states, decode agrees at the fp32 bar
    st_j, st_pt = _both(_state(cfg, 2, seed=8))
    for t in range(8):
        y_j, st_j = _ref(jax_ssm.mamba2_decode)(pj, jcfg, jnp.asarray(ud[:, t:t + 1]), st_j)
        y_pt, st_pt = ssm.mamba2_decode(pp, cfg, torch.as_tensor(ud[:, t:t + 1]), st_pt)
        _close(y_pt, y_j)
    _close_tree(st_pt, st_j)
    init = ssm.mamba2_init_state(cfg, 2, "cpu")
    assert jax.tree.map(lambda t: (tuple(t.shape), t.dtype), init) == \
        jax.tree.map(lambda a: (tuple(a.shape), torch.float32), jax_ssm.mamba2_init_state(jcfg, 2))


# ---------------------------------------------------------------------------
# the shared transformer block
# ---------------------------------------------------------------------------

def _ref_shared_block(p_blk, shared, cfg, x, cache, pos, mode):
    return jax_tr.apply_block(p_blk, shared, cfg, "shared_attn", x, cache=cache, pos=pos,
                              mode=mode)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_shared_attn_block_matches_reference(zamba, use_pallas):
    """Block b2_shared_attn of group 1 (its own nonzero LoRA on the shared
    weights): one-shot prefill, chained chunks of 5 and 6 decode steps,
    with ``use_pallas`` on both sides (the reference's flash kernel in
    interpret mode, the port's wrapper on its plain version)."""
    jcfg, cfg, p_j, p_pt = zamba
    jcfg, cfg = (dataclasses.replace(c, use_pallas=use_pallas) for c in (jcfg, cfg))
    name = "b2_shared_attn"
    bj = jax.tree.map(lambda a: a[1], p_j["groups"][name])
    bp = tree_map(lambda t: t[1], p_pt["groups"][name])
    assert float(np.abs(np.asarray(bj["lora"]["vB"])).min()) > 0
    x = _u(cfg, 2, 24, seed=5)
    apply_j = _ref(_ref_shared_block, static=(2, 6))

    def run(x_np, cache_j, cache_pt, pos, mode):
        o_j, c_j, _ = apply_j(bj, p_j["shared"], jcfg, jnp.asarray(x_np), cache_j, pos, mode)
        o_pt, c_pt, _ = transformer.apply_block(bp, p_pt["shared"], cfg, "shared_attn",
                                                torch.as_tensor(x_np), cache=cache_pt,
                                                pos=pos, mode=mode)
        _close(o_pt, o_j)
        _close_tree(c_pt, c_j)
        return c_j, c_pt

    run(x, None, None, None, "prefill")
    c_j = jax_tr._block_cache(jcfg, "shared_attn", 2, 40)
    c_pt = transformer._block_cache(cfg, "shared_attn", 2, 40, "cpu")
    for s in range(0, 24, 5):
        c_j, c_pt = run(x[:, s:s + 5], c_j, c_pt, s, "chunk")
    xd = _u(cfg, 2, 6, seed=6)
    for t in range(6):
        c_j, c_pt = run(xd[:, t:t + 1], c_j, c_pt, 24 + t, "decode")


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas,T", [(False, 131), (True, 24)])
def test_prefill_logits_and_caches_match_reference(zamba, use_pallas, T):
    """One-shot prefill: 131 tokens run every Mamba-2 block's SSD in chunks
    of 1; 24 tokens with ``use_pallas`` on both sides."""
    jcfg, cfg, p_j, p_pt = zamba
    jcfg, cfg = (dataclasses.replace(c, use_pallas=use_pallas) for c in (jcfg, cfg))
    toks = np.random.default_rng(T).integers(0, cfg.vocab, size=(2, T)).astype(np.int32)
    lg_j, c_j = _ref(jax_lm.prefill)(p_j, jcfg, jnp.asarray(toks))
    lg_pt, c_pt = lm.prefill(p_pt, cfg, torch.as_tensor(toks))
    _close(lg_pt, lg_j, **SSD_TOL)
    _close_tree(c_pt, c_j, **SSD_TOL)


def test_chained_chunks_and_decode_match_reference(zamba):
    """A 160-token prompt as chained ``prefill_chunk`` pieces of 100 and 60
    (the one-shot scan runs five SSD chunks of 32, so the resume crosses a
    chunk boundary of it), each against the reference's and the chain
    against one-shot ``prefill``; then 8 decode steps at per-row
    positions."""
    jcfg, cfg, p_j, p_pt = zamba
    toks = np.random.default_rng(8).integers(0, cfg.vocab, size=(2, 160)).astype(np.int32)
    c_pt = lm.init_cache(cfg, 2, MAX_SEQ, "cpu")
    c_j = jax_lm.init_cache(jcfg, 2, MAX_SEQ)
    for s, n in ((0, 100), (100, 60)):
        lg, c_pt = lm.prefill_chunk(p_pt, cfg, torch.as_tensor(toks[:, s:s + n]), c_pt, s)
        lg_j, c_j = _ref(jax_lm.prefill_chunk)(p_j, jcfg, jnp.asarray(toks[:, s:s + n]), c_j,
                                               jnp.int32(s))
        _close(lg, lg_j, **SSD_TOL)
        _close_tree(c_pt, c_j, **SSD_TOL)
    lg_one, _ = lm.prefill(p_pt, cfg, torch.as_tensor(toks))
    torch.testing.assert_close(lg, lg_one, **SSD_TOL)
    nxt = np.argmax(np.asarray(lg_j), -1).astype(np.int32)[:, None]
    pos = np.array([160, 160], np.int32)
    for _ in range(8):
        lg, c_pt = lm.decode_step(p_pt, cfg, torch.as_tensor(nxt), c_pt, torch.as_tensor(pos))
        lg_j, c_j = _ref(jax_lm.decode_step)(p_j, jcfg, jnp.asarray(nxt), c_j, jnp.asarray(pos))
        _close(lg, lg_j, **SSD_TOL)
        nxt = np.argmax(np.asarray(lg_j), -1).astype(np.int32)[:, None]
        pos = pos + 1
    _close_tree(c_pt, c_j, **SSD_TOL)


# ---------------------------------------------------------------------------
# splice_cache, and the tail the reference drops
# ---------------------------------------------------------------------------

def test_splice_cache_writes_the_mamba2_tail_into_the_slot(zamba):
    """A one-shot prefill's B=1 caches into slot 1 of three: the groups'
    Mamba-2 states and shared K/V equal the reference's splice, both tail
    Mamba-2 states (``h`` and ``conv.{x, bc}``) land in the slot, which
    the reference leaves undone, and the other slots are untouched."""
    jcfg, cfg, _, _ = zamba
    r = np.random.default_rng(9)
    dst_np = jax.tree.map(lambda a: r.normal(size=a.shape).astype(np.float32),
                          jax_lm.init_cache(jcfg, 3, 40))
    src_np = jax.tree.map(lambda a: r.normal(size=a.shape).astype(np.float32),
                          jax_lm.init_cache(jcfg, 1, 40))
    for leaf in ("k", "v"):                                    # a 23-token prefix
        src_np["groups"]["b2_shared_attn"][leaf] = \
            src_np["groups"]["b2_shared_attn"][leaf][:, :, :23]
    ref = jax_server.splice_cache(jax.tree.map(jnp.asarray, dst_np),
                                  jax.tree.map(jnp.asarray, src_np), 1, 23, 40)
    got = splice_cache(bridge.cache_from_jax(dst_np, "cpu"),
                       bridge.cache_from_jax(src_np, "cpu"), 1, 40)
    _close_tree({"groups": got["groups"]}, {"groups": ref["groups"]}, atol=0, rtol=0)
    for name in ("t0_mamba2", "t1_mamba2"):
        for path, t in _flat(got["tail"][name]).items():
            want = _flat(dst_np["tail"][name])[path].copy()
            want[1] = _flat(src_np["tail"][name])[path][0]
            np.testing.assert_array_equal(t.numpy(), want)
            np.testing.assert_array_equal(np.asarray(_flat(ref["tail"][name])[path]),
                                          _flat(dst_np["tail"][name])[path])


def test_reference_server_drops_the_tail_and_the_port_does_not(zamba):
    """The fault ROADMAP.md Queue 3 records, held as an inequality: the
    reference's server decodes from zero tail states and leaves its own
    model's greedy loop; the port's server gives the loop's tokens."""
    jcfg, cfg, p_j, p_pt = zamba
    prompt = _prompt(20, 0)
    loop = _greedy(jcfg, p_j, prompt, 10)
    ref = jax_server.DecodeServer(jcfg, p_j, num_slots=2, max_seq=MAX_SEQ)
    ref.submit(jax_server.Request(uid=0, prompt=prompt, max_new_tokens=10))
    assert ref.run_until_drained()[0].out_tokens != loop
    srv = DecodeServer(cfg, p_pt, num_slots=2, max_seq=MAX_SEQ, device="cpu")
    srv.submit(Request(uid=0, prompt=prompt, max_new_tokens=10))
    assert srv.run_until_drained()[0].out_tokens == loop


# ---------------------------------------------------------------------------
# the port's server
# ---------------------------------------------------------------------------

def _prompts():
    return [(_prompt(n, seed=30 + i), m) for i, (n, m) in enumerate(PROMPTS)]


def _serve(cfg, params, driver, prompts, uid0=0, srv=None, **kw):
    persistent, chunk = DRIVERS[driver]
    if srv is None:
        srv = DecodeServer(cfg, params, num_slots=2, max_seq=MAX_SEQ, block_k=4,
                           prefill_chunk=chunk, device="cpu", **kw)
    for i, (prompt, n) in enumerate(prompts):
        srv.submit(Request(uid=uid0 + i, prompt=list(prompt), max_new_tokens=n))
    done = srv.run_until_drained(persistent=persistent)
    return {r.uid: (r.out_tokens, r.finish_reason) for r in done if r.uid >= uid0}, srv


def _want(zamba, prompts):
    jcfg, _, p_j, _ = zamba
    return {uid: (_greedy(jcfg, p_j, p, n), "max_tokens") for uid, (p, n) in enumerate(prompts)}


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_server_matches_reference_greedy_loop(zamba, driver):
    """Prompts of 7-160 tokens on two slots under ``step()``,
    ``step_block()`` and chunked prefill (16-token pieces, so the one-shot
    chunk-1 and five-chunk scans become other chunkings)."""
    _, cfg, _, p_pt = zamba
    prompts = _prompts()
    got, _ = _serve(cfg, p_pt, driver, prompts)
    assert got == _want(zamba, prompts)


def test_prefix_cache_hits_and_adaptive_prefill_give_the_reference_tokens(zamba):
    """Chunked prefill with the prefix cache: a cold pass, the same prompts
    again under new uids (every one a full hit, no prompt step computed),
    and two prompts sharing the 131-token prompt as a prefix (partial
    hits resumed mid-prompt).  Then adaptive prefill under ``step_block()``
    with the cache, whose pieces have other lengths, so other SSD
    chunkings; every stored checkpoint holds (and counts) the Mamba-2
    states whole and the shared K/V trimmed to its prefix."""
    jcfg, cfg, p_j, p_pt = zamba
    prompts = _prompts()
    cold, srv = _serve(cfg, p_pt, "chunked", prompts, prefix_cache_bytes=1 << 26)
    warm, srv = _serve(cfg, p_pt, "chunked", prompts, uid0=100, srv=srv)
    st = srv.stats()
    assert st["prefix_cache"]["hits"] == len(prompts)
    want = _want(zamba, prompts)
    assert cold == want and {u - 100: v for u, v in warm.items()} == want
    fleet = [(prompts[2][0] + _prompt(k, seed=50 + k), 5) for k in (3, 14)]
    got, srv = _serve(cfg, p_pt, "chunked", fleet, uid0=200, srv=srv)
    assert srv.stats()["prefix_cache"]["partial_hits"] >= 2
    for i, (prompt, n) in enumerate(fleet):
        assert got[200 + i] == (_greedy(jcfg, p_j, prompt, n), "max_tokens")
    for node in srv.prefix_cache._entry_nodes:
        e = node.entry
        assert e.caches["groups"]["b2_shared_attn"]["k"].shape[2] == e.length
        assert e.caches["tail"]["t1_mamba2"]["h"].shape == (1, 4, 32, 16)

    srv = DecodeServer(cfg, p_pt, num_slots=2, max_seq=MAX_SEQ, block_k=4, prefill_chunk=16,
                       prefill_adaptive=True, prefix_cache_bytes=1 << 26, device="cpu")
    got, srv = _serve(cfg, p_pt, "step_block", prompts, srv=srv)
    assert got == want
    entries = [node.entry for node in srv.prefix_cache._entry_nodes]
    assert entries and all(set(e.caches) == {"groups", "tail"} for e in entries)
    assert srv.prefix_cache.bytes_in_use == sum(
        tree_bytes(e.caches) + e.logits.numel() * e.logits.element_size() for e in entries)


def test_async_server_gives_the_reference_tokens(zamba):
    """Every prompt at once through ``AsyncServer`` (its ticks on a thread
    of its own) over a chunked server."""
    _, cfg, _, p_pt = zamba
    prompts = _prompts()
    srv = DecodeServer(cfg, p_pt, num_slots=2, max_seq=MAX_SEQ, block_k=4, prefill_chunk=16,
                       device="cpu")

    async def drive():
        front = AsyncServer(srv)
        try:
            return await asyncio.gather(*(front.generate(Request(
                uid=i, prompt=list(p), max_new_tokens=n)) for i, (p, n) in enumerate(prompts)))
        finally:
            front.close()

    done = asyncio.run(drive())
    assert {r.uid: (r.out_tokens, r.finish_reason) for r in done} == _want(zamba, prompts)
