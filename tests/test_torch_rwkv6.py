"""The port's RWKV-6 block (``repro_torch/models/rwkv6.py``) on the CPU
against the live JAX reference (``repro/models/rwkv6.py``) on the same
seeded numpy inputs: the chunk-parallel wkv and the token scan (the
inputs of ``tests/test_core.py::test_rwkv_chunked_equals_token_scan``),
the time mix and the channel mix with a carried state at S = 128 (the
chunked form) and S = 100 (the token scan), in float32 and bf16, and the
block's init tree.

Tolerances: float32 rtol = atol = 1e-5 on the model's inputs; the wkv
primitives on test_core's harsher decays, whose chunked form multiplies
factors up to e^{|L|} ~ 1e3 inside a chunk, at rtol 1e-5 and an atol of
1e-5 times the output's largest magnitude. bf16 at the LM zoo's ``BF16``
(rtol 2e-2, atol 6.25e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import rwkv6 as jr
from repro_torch import configs
from repro_torch.models import rwkv6

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=6.25e-2)
HS = rwkv6.HEAD_SIZE


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


def _cfgs(dtype="float32"):
    return (configs.get_config("rwkv6-3b", smoke=True).with_(dtype=dtype),
            jconfigs.get_config("rwkv6-3b", smoke=True).with_(dtype=dtype))


def _wkv_inputs(s: int, seed=0):
    cfg, _ = _cfgs()
    rng = np.random.default_rng(seed)
    b, h = 2, cfg.d_model // HS
    r, k, v = (rng.standard_normal((b, s, h, HS)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((b, s, h, HS)) - 2)).astype(
        np.float32)
    u = rng.standard_normal((h, HS)).astype(np.float32)
    s0 = (rng.standard_normal((b, h, HS, HS)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


def _jax_token_scan(r, k, v, w, u, s0):
    """The reference's token scan (the step of ``time_mix_forward``)."""
    def step(st, inp):
        rt, kt, vt, wt = inp
        kv = kt[..., :, None] * vt[..., None, :]
        o = jnp.einsum("bhk,bhkv->bhv", rt, st + u[..., None] * kv)
        return wt[..., None] * st + kv, o
    xs = tuple(jnp.asarray(t).transpose(1, 0, 2, 3) for t in (r, k, v, w))
    s_fin, out = jax.lax.scan(step, jnp.asarray(s0), xs)
    return out.transpose(1, 0, 2, 3), s_fin


@pytest.mark.parametrize("form", ["chunked", "scan"])
def test_wkv_matches_reference(form):
    """Both forms of the port against the reference's own form on
    test_core's inputs (two chunks), output and final state."""
    inp = _wkv_inputs(2 * rwkv6.CHUNK)
    if form == "chunked":
        want = jr._wkv_chunked(*(jnp.asarray(t) for t in inp))
        got = rwkv6._wkv_chunked(*(torch.from_numpy(t) for t in inp))
    else:
        want = _jax_token_scan(*inp)
        got = rwkv6._wkv_scan(*(torch.from_numpy(t) for t in inp))
    for g, w in zip(got, want):
        w = _np(w)
        np.testing.assert_allclose(_np(g), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


def test_wkv_forms_agree():
    """The port's chunked form against its token scan, at test_core's
    tolerance for the two reference forms."""
    inp = [torch.from_numpy(t) for t in _wkv_inputs(2 * rwkv6.CHUNK, 3)]
    for a, b in zip(rwkv6._wkv_chunked(*inp), rwkv6._wkv_scan(*inp)):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


def _block(dtype, seed=0):
    """(port params, reference params) of one rwkv block, the reference's
    init with its float32 leaves given a random spread (zeros and
    constants there would hide a wrong term)."""
    cfg, jcfg = _cfgs(dtype)
    jp = jr.rwkv_init(jax.random.PRNGKey(seed), jcfg,
                      jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    rng = np.random.default_rng(seed + 10)
    tm = jp["time_mix"]
    tm["mu"] = jnp.asarray(rng.uniform(0, 1, tm["mu"].shape), jnp.float32)
    tm["w0"] = jnp.asarray(rng.uniform(-7, -1, tm["w0"].shape), jnp.float32)
    tm["u"] = jnp.asarray(rng.standard_normal(tm["u"].shape), jnp.float32)
    tm["ln_x"]["bias"] = jnp.asarray(rng.standard_normal(
        tm["ln_x"]["bias"].shape) * 0.1, jnp.float32)
    cm = jp["channel_mix"]
    cm["mu"] = jnp.asarray(rng.uniform(0, 1, cm["mu"].shape), jnp.float32)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return jax.tree.map(leaf, jp), jp


def _state(cfg, seed=1):
    rng = np.random.default_rng(seed)
    h = cfg.d_model // HS
    return (rng.standard_normal((2, h, HS, HS)).astype(np.float32) * 0.1,
            rng.standard_normal((2, cfg.d_model)).astype(np.float32),
            rng.standard_normal((2, cfg.d_model)).astype(np.float32))


def _x(cfg, s, dtype, seed=2):
    x = np.random.default_rng(seed).standard_normal((2, s, cfg.d_model))
    jx = jnp.asarray(x, jnp.float32).astype(
        jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    return torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32), jx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [128, 100])
@pytest.mark.parametrize("mix", ["time", "channel"])
def test_mix_forward_matches_reference(mix, s, dtype):
    """A mix with a carried (non-zero) state: the output, its dtype, and
    every field of the new state."""
    cfg, jcfg = _cfgs(dtype)
    p, jp = _block(dtype)
    x, jx = _x(cfg, s, dtype)
    st = _state(cfg)
    key = "time_mix" if mix == "time" else "channel_mix"
    fn = rwkv6.time_mix_forward if mix == "time" else \
        rwkv6.channel_mix_forward
    jfn = jr.time_mix_forward if mix == "time" else jr.channel_mix_forward
    want, jnew = jax.jit(jfn, static_argnums=1)(
        jp[key], jcfg, jx, jr.RWKVState(*(jnp.asarray(t) for t in st)))
    got, new = fn(p[key], cfg, x,
                  rwkv6.RWKVState(*(torch.from_numpy(t) for t in st)))
    assert str(got.dtype)[6:] == str(want.dtype)
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    for g, w in zip(new, jnew):
        assert g.dtype == torch.float32 and str(w.dtype) == "float32"
        np.testing.assert_allclose(_np(g), _np(w), **F32)


def test_shift_seeds_the_first_position():
    x = torch.arange(2 * 3 * 4, dtype=torch.bfloat16).reshape(2, 3, 4)
    prev = torch.full((2, 4), -1.0)
    y = rwkv6._shift(x, prev)
    assert y.dtype == torch.float32          # promoted, as jnp.concatenate
    assert torch.equal(y[:, 0], prev) and torch.equal(y[:, 1:], x[:, :-1]
                                                      .float())
    assert torch.equal(rwkv6._shift(x)[:, 0], torch.zeros((2, 4),
                                                          dtype=x.dtype))


def test_init_matches_reference_tree():
    cfg, jcfg = _cfgs("bfloat16")
    jp = jax.eval_shape(lambda: jr.rwkv_init(jax.random.PRNGKey(0), jcfg))
    p = rwkv6.rwkv_init(torch.Generator().manual_seed(0), cfg)
    assert (jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), p)
            == jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp))
    st = rwkv6.init_state(cfg, 3)
    jst = jr.init_state(jcfg, 3)
    assert [(tuple(t.shape), t.dtype) for t in st] == [
        (a.shape, torch.float32) for a in jst]
