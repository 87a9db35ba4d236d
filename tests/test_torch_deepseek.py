"""The port's moe family (``repro_torch/models/transformer.py`` with
``mla.py`` and ``moe.py``) on the CPU against the live JAX reference, for
both deepseek smoke configs (deepseek-v2-lite-16b: no q-LoRA, 4 experts;
deepseek-v2-236b: q-LoRA, 8 experts; 3 layers, the first with a dense
FFN): prefill, forward_train's logits and aux loss, decode steps, the
served tokens, the weight hot-swap and the serving CLI.

Both sides run on the reference's ``init_params`` tree carried across by
``params_from_numpy`` and the same seeded numpy tokens. Tolerances:
float32 rtol = atol = 1e-5; bf16 logits at the LM zoo's ``BF16`` (rtol
2e-2, atol 6.25e-2) with argmax equal wherever the reference's top-1
leads its runner-up by more than 2·atol; served tokens equal.

Routing near-ties: a token whose k-th and (k+1)-th router probabilities
lie closer than the two packages' hidden states differ can take another
expert set in each, and its output then differs by far more than any
tolerance. So the forward test records both routers at every MoE layer,
requires every position whose top-k set differs to have a relative gap
(p_k - p_k+1) / p_k below ``ROUTE_MARGIN`` in the reference, and leaves
such positions, and the later ones of their sequence, out of the logit
comparison. float32 allows 1e-5 (a rounding of the router's float32
sums). bfloat16 allows 0.05: the two packages round bf16 hidden states
in different places (relative 2^-9 an element, a few such roundings a
layer), which moved router logits enough to swap experts at relative
gaps 0.014 and 0.021 on deepseek-v2-236b's smoke config.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro.serve import ServingEngine as JServingEngine
from repro_torch import configs
from repro_torch.kernels import flash_attention as kfa
from repro_torch.launch import serve
from repro_torch.models import mla, moe
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import ServingEngine

ARCHS = ("deepseek-v2-lite-16b", "deepseek-v2-236b")
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=6.25e-2)
ROUTE_MARGIN = {"float32": 1e-5, "bfloat16": 0.05}
# the reference compiled once per (cfg, shape), not op by op
jforward_train = jax.jit(jt.forward_train, static_argnums=0)
jdecode_step = jax.jit(jt.decode_step, static_argnums=0)



@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for these smoke-sized tensors: the test runner
    runs several workers side by side, whose thread pools would otherwise
    contend for every small op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def models(arch: str, dtype: str = "float32", seed: int = 0):
    """(port cfg, reference cfg, reference params, port params). The
    bfloat16 tree is the float32 one cast leaf by leaf to the dtypes of the
    reference's bfloat16 ``init_params``, which draws in float32 and casts
    the same way."""
    jcfg = jconfigs.get_config(arch, smoke=True).with_(dtype=dtype)
    cfg = configs.get_config(arch, smoke=True).with_(dtype=dtype)
    if dtype == "float32":
        jp = jax.jit(jt.init_params, static_argnums=0)(
            jcfg, jax.random.PRNGKey(seed))
    else:
        spec = jax.eval_shape(lambda: jt.init_params(
            jcfg, jax.random.PRNGKey(seed)))
        jp = jax.tree.map(lambda a, s: a.astype(s.dtype),
                          models(arch, "float32", seed)[2], spec)
    return cfg, jcfg, jp, tf.params_from_numpy(
        cfg, jax.tree.map(np.asarray, jp))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _tokens(cfg, shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference_tree(arch):
    cfg, jcfg, _, _ = models(arch)
    cfg, jcfg = (c.with_(dtype="bfloat16") for c in (cfg, jcfg))
    jp = jax.eval_shape(lambda: jt.init_params(jcfg, jax.random.PRNGKey(0)))
    p = tf.init_params(cfg, torch.Generator().manual_seed(0))
    assert set(p) == {"embed", "final_norm", "head", "stack0_dense_attn_mla",
                      "stack1_moe"}
    assert (tf.tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), p)
            == jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp))
    assert p["stack1_moe"]["moe"]["router"]["w"].dtype == torch.float32
    # ModelConfig.param_count leaves out the norm scales (ln1, ln2, the
    # kv-norm, the q-norm with q-LoRA, the final norm)
    n_norm = cfg.n_layers * (2 * cfg.d_model + cfg.kv_lora_rank
                             + cfg.q_lora_rank) + cfg.d_model
    assert sum(t.numel() for t in tf.tree_leaves(p)) == (
        jcfg.param_count() + n_norm)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_cross_unchanged(arch):
    _, _, jp, p = models(arch, "bfloat16")
    back = tf.numpy_params(p)
    for path, a in jax.tree_util.tree_leaves_with_path(jp):
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(a, np.float32))
    assert [str(t.dtype)[6:] for t in tf.tree_leaves(p)] == [
        str(a.dtype) for a in jax.tree.leaves(jp)]


def _recorded_routes(monkeypatch):
    """Record (expert_idx, probs) of every MoE layer call, as numpy, in
    the reference (through ``jax.debug.callback``) and the port."""
    ref, port = [], []
    j_apply, t_route = jmoe.moe_apply, moe.route

    def j_recorded(p, cfg, x):
        probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"]["w"],
                               axis=-1)
        idx = jax.lax.top_k(probs, cfg.top_k)[1]
        jax.debug.callback(lambda i, pr: ref.append(
            (np.asarray(i), np.asarray(pr))), idx, probs, ordered=True)
        return j_apply(p, cfg, x)

    def t_recorded(p, cfg, x):
        out = t_route(p, cfg, x)
        port.append((out[2].numpy(), out[0].numpy()))
        return out
    monkeypatch.setattr(jmoe, "moe_apply", j_recorded)
    monkeypatch.setattr(moe, "route", t_recorded)
    return ref, port


def _comparable(ref, port, k: int, margin: float) -> np.ndarray:
    """(B, S) mask of the positions before the first routing difference
    of their sequence in any MoE layer; each difference must be a
    near-tie of the reference's router within ``margin``."""
    keep = None
    assert len(ref) == len(port) > 0
    for (ji, jpr), (ti, _) in zip(ref, port):
        differ = np.any(np.sort(ji, -1) != np.sort(ti, -1), axis=-1)
        top = -np.sort(-jpr, axis=-1)
        gap = (top[..., k - 1] - top[..., k]) / top[..., k - 1]
        assert np.all(gap[differ] < margin), (
            f"routing differs at a relative gap {gap[differ].max():.3g}")
        first = np.where(differ.any(-1), differ.argmax(-1), differ.shape[-1])
        here = np.arange(differ.shape[-1])[None, :] < first[:, None]
        keep = here if keep is None else keep & here
    return keep


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference(arch, dtype, monkeypatch):
    cfg, jcfg, jp, p = models(arch, dtype)
    toks = _tokens(cfg, (2, 16))
    jtoks = jnp.asarray(toks, jnp.int32)
    ref, port = _recorded_routes(monkeypatch)
    want, want_aux = jax.jit(jt.forward_train, static_argnums=0)(
        jcfg, jp, jt.Batch(jtoks, jtoks))
    jax.effects_barrier()
    logits, aux = tf.forward_train(cfg, p, tf.Batch(torch.from_numpy(toks),
                                                    torch.from_numpy(toks)))
    keep = _comparable(ref, port, cfg.top_k, ROUTE_MARGIN[dtype])
    if dtype == "float32":
        assert keep.all()
    pre = tf.prefill(cfg, p, torch.from_numpy(toks))
    assert logits.dtype == (torch.bfloat16 if dtype == "bfloat16"
                            else torch.float32)
    tol = F32 if dtype == "float32" else BF16
    # aux is a float32 function of the hidden states, which differ by bf16
    # roundings in a bf16 model
    assert aux.dtype == torch.float32 and float(aux) > 0
    np.testing.assert_allclose(float(aux), float(want_aux), **tol)
    got, want = _np(logits), _np(want)
    np.testing.assert_allclose(_np(pre), got[:, -1:], **tol)
    # the reference's prefill is its forward's last position
    for g, w, kept in ((got, want, keep), (_np(pre), want[:, -1:],
                                           keep[:, -1:])):
        np.testing.assert_allclose(g[kept], w[kept], **tol)
        top2 = np.sort(w[kept], axis=-1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > 2 * tol["atol"]
        assert np.all((g[kept].argmax(-1) == w[kept].argmax(-1)) | ~clear)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    """Eight decode steps of 2 slots from an empty cache of 8: the last
    step fills it. Logits at every step and the caches after."""
    cfg, jcfg, jp, p = models(arch)
    jstate = jt.init_serve_state(jcfg, 2, 8)
    state = tf.init_serve_state(cfg, 2, 8)
    assert isinstance(state.caches, mla.MLACache)
    toks = _tokens(cfg, (2, 8), seed=1)
    for i in range(8):
        want, jstate = jdecode_step(jcfg, jp, jstate,
                                    jnp.asarray(toks[:, i:i + 1], jnp.int32))
        got, state = tf.decode_step(cfg, p, state,
                                    torch.from_numpy(toks[:, i:i + 1]))
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    for g, w in zip(state.caches, jstate.caches):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), **F32)
    assert state.caches.length.tolist() == [[8, 8]] * cfg.n_layers
    assert int(state.length) == int(jstate.length) == 8


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_decode_loop(arch):
    """An 8-token prompt (no MoE row can drop a token) through prefill and
    through decode_step token by token, in the port alone."""
    cfg, _, _, p = models(arch)
    toks = torch.from_numpy(_tokens(cfg, (1, 8), seed=2))
    want = tf.prefill(cfg, p, toks)[0, -1]
    state = tf.init_serve_state(cfg, 1, 8)
    for i in range(8):
        logits, state = tf.decode_step(cfg, p, state, toks[:, i:i + 1])
    torch.testing.assert_close(logits[0, -1], want, **F32)


MIXED = ([3, 7, 5, 2, 6], 6)            # prompt lengths, max_new


def _prompts(cfg, seed=9):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (n,)).tolist() for n in MIXED[0]]


def _serve(eng, prompts, max_new=MIXED[1]):
    rids = [eng.submit(pr, max_new_tokens=max_new) for pr in prompts]
    out = eng.run()
    return [out[r] for r in rids]


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_engine_matches_reference(arch):
    cfg, jcfg, jp, p = models(arch)
    prompts = _prompts(cfg)
    want = _serve(JServingEngine(jcfg, jp, n_slots=3, max_len=24), prompts)
    eng = ServingEngine(cfg, p, n_slots=3, max_len=24, device="cpu")
    assert isinstance(eng.state.caches, mla.MLACache)
    assert _serve(eng, prompts) == want
    assert all(len(t) == MIXED[1] for t in want)


@pytest.mark.parametrize("arch", ARCHS)
def test_swap_params_in_place(arch):
    """A swap copies a second seed's tree into the engine's own weights
    (same storage), leaves the caller's tree alone, and serves as a fresh
    engine on those weights."""
    cfg, _, _, p = models(arch)
    p2 = models(arch, seed=1)[3]
    before = [t.clone() for t in tf.tree_leaves(p)]
    prompts = _prompts(cfg)
    eng = ServingEngine(cfg, p, n_slots=3, max_len=24, device="cpu")
    first = _serve(eng, prompts)
    ptrs = [t.data_ptr() for t in eng.params]
    eng.swap_params(eng.model.swap_arrays(p2))
    assert [t.data_ptr() for t in eng.params] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(before, tf.tree_leaves(p)))
    after = _serve(eng, prompts)
    fresh = _serve(ServingEngine(cfg, p2, n_slots=3, max_len=24,
                                 device="cpu"), prompts)
    assert after == fresh and after != first


def test_reset_slot_zeroes_the_latent_cache():
    cfg, _, _, p = models("deepseek-v2-lite-16b")
    eng = ServingEngine(cfg, p, n_slots=2, max_len=8, device="cpu")
    for t in eng.state.caches:
        t.fill_(1)
    eng.model.reset_slot(eng.state, 1, 2)
    for t in eng.state.caches:
        assert not bool(t[:, 1].any()) and bool((t[:, 0] == 1).all())


@pytest.mark.parametrize("quant", ["none", "binary_weights"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_cpu(capsys, arch, quant):
    kfa.flash_attention.launches = 0
    assert serve.main(["--device", "cpu", "--arch", arch, "--smoke",
                       "--quant", quant, "--swap", "--requests", "3",
                       "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "served 6/6 requests" in out and "hot-swap OK" in out
    assert kfa.flash_attention.launches == 0
