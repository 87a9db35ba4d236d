"""The port's Mamba-2 block (``repro_torch/models/mamba2.py``) and the
attention of the hybrid family's window paths
(``repro_torch/models/attention.py``) on the CPU against the live JAX
reference on the same seeded numpy inputs:

* the blocked SSD and the token scan (the inputs of
  ``tests/test_core.py::test_mamba_ssd_chunked_equals_token_scan``), the
  causal conv and ``mamba_forward`` with a carried state at S = 128 (the
  blocked form) and S = 100 (the token scan), float32 and bf16;
* ``blockwise_causal_attention`` with and without a window, causal and
  not, at ragged S, with Q blocks or without;
* ``gqa_forward`` (which takes the blockwise attention, never K7, with a
  window) and ``gqa_decode_step`` on zamba2-7b's smoke config with a
  window set.

Tolerances: float32 rtol = atol = 1e-5 (the SSD primitives at an atol of
1e-5 times the output's largest magnitude: test_core's decays reach
e^{|L|} ~ 1e4 across a chunk); bf16 at the LM zoo's ``BF16`` (rtol
2e-2, atol 6.25e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as ja
from repro.models import mamba2 as jm
from repro_torch import configs
from repro_torch.kernels import flash_attention as kfa
from repro_torch.models import attention, mamba2

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=6.25e-2)
DT = {"float32": (torch.float32, jnp.float32),
      "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _both(a: np.ndarray, dtype: str):
    """The same values in both packages, rounded once to ``dtype``."""
    ja_ = jnp.asarray(a, jnp.float32).astype(DT[dtype][1])
    return torch.from_numpy(np.array(ja_.astype(jnp.float32))).to(
        DT[dtype][0]), ja_


def _cfgs(dtype="float32", **kw):
    return (configs.get_config("zamba2-7b", smoke=True).with_(dtype=dtype,
                                                              **kw),
            jconfigs.get_config("zamba2-7b", smoke=True).with_(dtype=dtype,
                                                               **kw))


def _ssd_inputs(seed=1):
    rng = np.random.default_rng(seed)
    b, nh, p_dim, n = 2, 3, 8, 16
    s = 2 * mamba2.CHUNK
    f = np.float32
    return (rng.standard_normal((b, s, nh, p_dim)).astype(f),
            rng.standard_normal((b, s, n)).astype(f),
            rng.standard_normal((b, s, n)).astype(f),
            np.abs(rng.standard_normal((b, s, nh))).astype(f),
            np.exp(-np.abs(rng.standard_normal((b, s, nh)))).astype(f),
            (rng.standard_normal((b, nh, p_dim, n)) * 0.1).astype(f))


def _jax_token_scan(xs, bmat, cmat, dt, decay, h0):
    """The reference's token scan (the step of ``mamba_forward``)."""
    def step(h, inp):
        xt, bt, ct, dct, dtt = inp
        dbx = dtt[..., None, None] * xt[..., :, None] * bt[:, None, None, :]
        h_new = dct[..., None, None] * h + dbx
        return h_new, jnp.einsum("bhpn,bn->bhp", h_new, ct)
    t = [jnp.asarray(a) for a in (xs, bmat, cmat, decay, dt)]
    xs_t = (t[0].transpose(1, 0, 2, 3), t[1].transpose(1, 0, 2),
            t[2].transpose(1, 0, 2), t[3].transpose(1, 0, 2),
            t[4].transpose(1, 0, 2))
    h_fin, ys = jax.lax.scan(step, jnp.asarray(h0), xs_t)
    return ys.transpose(1, 0, 2, 3), h_fin


@pytest.mark.parametrize("form", ["chunked", "scan"])
def test_ssd_matches_reference(form):
    inp = _ssd_inputs()
    if form == "chunked":
        want = jm._ssd_chunked(*(jnp.asarray(t) for t in inp))
        got = mamba2._ssd_chunked(*(torch.from_numpy(t) for t in inp))
    else:
        want = _jax_token_scan(*inp)
        got = mamba2._ssd_scan(*(torch.from_numpy(t) for t in inp))
    for g, w in zip(got, want):
        w = _np(w)
        np.testing.assert_allclose(_np(g), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


def test_ssd_forms_agree():
    inp = [torch.from_numpy(t) for t in _ssd_inputs(4)]
    for a, b in zip(mamba2._ssd_chunked(*inp), mamba2._ssd_scan(*inp)):
        torch.testing.assert_close(a, b, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 100])
def test_causal_conv_matches_reference(s, dtype):
    rng = np.random.default_rng(5)
    c = 40
    xbc, jxbc = _both(rng.standard_normal((2, s, c)), dtype)
    w, jw = _both(rng.standard_normal((mamba2.CONV_K, c)) * 0.5, dtype)
    tail = rng.standard_normal((2, mamba2.CONV_K - 1, c)).astype(np.float32)
    out, new_tail = mamba2._causal_conv(xbc, w, torch.from_numpy(tail))
    jout, jtail = jax.jit(jm._causal_conv)(jxbc, jw, jnp.asarray(tail))
    assert out.dtype == new_tail.dtype == DT[dtype][0]
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_np(out), _np(jout), **tol)
    np.testing.assert_array_equal(_np(new_tail), _np(jtail))


def _block(dtype, seed=0):
    """(port params, reference params) of one Mamba-2 block; a_log, d_skip
    and dt_bias given a random spread (the init's constants would hide a
    wrong term)."""
    cfg, jcfg = _cfgs(dtype)
    jp = jm.mamba_init(jax.random.PRNGKey(seed), jcfg, DT[dtype][1])
    rng = np.random.default_rng(seed + 10)
    for k, lo, hi in (("a_log", -1, 1), ("d_skip", 0, 2), ("dt_bias", -2, 1)):
        jp[k] = jnp.asarray(rng.uniform(lo, hi, jp[k].shape), jnp.float32)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return jax.tree.map(leaf, jp), jp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [128, 100])
def test_mamba_forward_matches_reference(s, dtype):
    """One block with a carried (non-zero) state: the output, its dtype,
    and the new state (h and the conv tail, float32)."""
    cfg, jcfg = _cfgs(dtype)
    p, jp = _block(dtype)
    rng = np.random.default_rng(7)
    x, jx = _both(rng.standard_normal((2, s, cfg.d_model)), dtype)
    d_inner, nh, n = mamba2._dims(cfg)
    st = ((rng.standard_normal((2, nh, mamba2.HEAD_DIM, n)) * 0.1).astype(
        np.float32), rng.standard_normal(
        (2, mamba2.CONV_K - 1, d_inner + 2 * n)).astype(np.float32))
    want, jnew = jax.jit(jm.mamba_forward, static_argnums=1)(
        jp, jcfg, jx, jm.MambaState(*(jnp.asarray(t) for t in st)))
    got, new = mamba2.mamba_forward(
        p, cfg, x, mamba2.MambaState(*(torch.from_numpy(t) for t in st)))
    assert got.dtype == DT[dtype][0]
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    for g, w in zip(new, jnew):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), _np(w), **tol)


def test_init_matches_reference_tree():
    cfg, jcfg = _cfgs("bfloat16")
    jp = jax.eval_shape(lambda: jm.mamba_init(jax.random.PRNGKey(0), jcfg))
    p = mamba2.mamba_init(torch.Generator().manual_seed(0), cfg)
    assert (jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), p)
            == jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp))
    st = mamba2.init_state(cfg, 3)
    assert [tuple(t.shape) for t in st] == [
        a.shape for a in jm.init_state(jcfg, 3)]


# (S, block, q_block, window, causal): ragged S against the blocks, one
# block or several, Q blocks or one
BLOCKWISE = [(37, 16, None, None, True), (37, 16, None, None, False),
             (37, 16, 8, 5, True), (37, 16, None, 5, False),
             (50, 1024, None, 12, True), (64, 16, 16, None, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BLOCKWISE, ids=str)
def test_blockwise_attention_matches_reference(case, dtype):
    s, block, q_block, window, causal = case
    rng = np.random.default_rng(s + block)
    q, k, v = (_both(rng.standard_normal((2, s, 3, 16)), dtype)
               for _ in range(3))
    kw = dict(block=block, q_block=q_block, window=window, causal=causal)
    want = ja.blockwise_causal_attention(q[1], k[1], v[1], **kw)
    got = attention.blockwise_causal_attention(q[0], k[0], v[0], **kw)
    assert got.dtype == DT[dtype][0] and tuple(got.shape) == want.shape
    tol = F32 if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _attn(cfg, jcfg, seed=0):
    jp = ja.attn_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp), jp


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 6])
def test_gqa_forward_window_matches_reference(window, causal):
    """With a window, gqa_forward takes the blockwise attention (no K7
    launch); without, K7's plain version: both equal the reference."""
    cfg, jcfg = _cfgs(window=window)
    p, jp = _attn(cfg, jcfg)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    pos = np.arange(21)[None, :]
    kfa.flash_attention.launches = 0
    got = attention.gqa_forward(p, cfg, torch.from_numpy(x),
                                torch.from_numpy(pos), causal=causal)
    want = ja.gqa_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                          causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    assert kfa.flash_attention.launches == 0


def test_gqa_decode_step_window_matches_reference():
    """Twelve steps of 2 slots at different lengths through a window of
    4: logits at every step, the cache and its lengths after."""
    cfg, jcfg = _cfgs(window=4)
    p, jp = _attn(cfg, jcfg, 1)
    rng = np.random.default_rng(12)
    cache = attention.init_cache(cfg, 2, 16, torch.float32)
    jcache = ja.init_cache(jcfg, 2, 16, jnp.float32)
    cache.length[1] = 3
    jcache = jcache._replace(length=jnp.asarray([0, 3], jnp.int32))
    step = jax.jit(ja.gqa_decode_step, static_argnums=1)
    for _ in range(12):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        got, cache = attention.gqa_decode_step(p, cfg, torch.from_numpy(x),
                                               cache)
        want, jcache = step(jp, jcfg, jnp.asarray(x), jcache)
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    for g, w in zip(cache, jcache):
        np.testing.assert_allclose(_np(g), _np(w), **F32)
    # the window changes the result: the same steps without it differ
    cfg0 = cfg.with_(window=None)
    cache0 = attention.init_cache(cfg0, 2, 16, torch.float32)
    for _ in range(6):
        out0, cache0 = attention.gqa_decode_step(
            p, cfg0, torch.ones((2, 1, cfg.d_model)), cache0)
    cache = attention.init_cache(cfg, 2, 16, torch.float32)
    for _ in range(6):
        out, cache = attention.gqa_decode_step(
            p, cfg, torch.ones((2, 1, cfg.d_model)), cache)
    assert not torch.allclose(out, out0)
