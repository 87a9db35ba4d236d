"""The port's audio family (whisper-medium: ``repro_torch/models/
transformer.py``'s encoder and ``dec_xattn`` stack, ``attention.py::
cross_attn_forward``, ``serve/engine.py``'s per-slot encoder K/V and the
serving CLI) on the CPU against the live JAX reference, on the smoke
config (2 encoder and 2 decoder layers, d 64, 4 heads of 16, 32 frames).

Both sides run on the reference's ``init_params`` tree carried across by
``params_from_numpy`` and the same seeded numpy tokens and frame
embeddings. On the CPU the encoder's non-causal attention is K7's plain
version; the reference's is its blockwise scan.

The reference's dtype rule is kept: ``audio_proj`` runs in the frames'
dtype, so float32 frames encode in float32 in a bf16 model and bf16
frames in bf16; the tests hold ``_encode``'s output dtype to the
reference's for both.

Tolerances: float32 rtol = atol = 1e-5; served tokens equal. bf16 logits
by the zoo's rule (``tests/test_torch_zoo_recurrent.py``): ``BF16``
(rtol 2e-2, atol 6.25e-2) on all but ``BF16_SHARE`` of the elements, no
element further from the reference than twice the reference's own
largest distance from its float32 logits on the same weights
(``truth``), an RMS distance from ``truth`` at most 1.25 times the
reference's, and argmax equal where the reference's top-1 leads by more
than 2·atol.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import transformer as jt
from repro.serve import ServingEngine as JServingEngine
from repro_torch import configs
from repro_torch.kernels import flash_attention as kfa
from repro_torch.launch import serve
from repro_torch.models import attention
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import ServingEngine

ARCH = "whisper-medium"
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=6.25e-2)
BF16_SHARE = 1e-3
jforward_train = jax.jit(jt.forward_train, static_argnums=0)
jdecode_step = jax.jit(jt.decode_step, static_argnums=0)
jencode = jax.jit(jt._encode, static_argnums=0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def models(dtype: str = "float32", seed: int = 0):
    """(port cfg, reference cfg, reference params, port params). The
    bfloat16 tree is the float32 one cast leaf by leaf to the dtypes of
    the reference's bfloat16 ``init_params``."""
    jcfg = jconfigs.get_config(ARCH, smoke=True).with_(dtype=dtype)
    cfg = configs.get_config(ARCH, smoke=True).with_(dtype=dtype)
    if dtype == "float32":
        jp = jax.jit(jt.init_params, static_argnums=0)(
            jcfg, jax.random.PRNGKey(seed))
    else:
        spec = jax.eval_shape(lambda: jt.init_params(
            jcfg, jax.random.PRNGKey(seed)))
        jp = jax.tree.map(lambda a, s: a.astype(s.dtype),
                          models("float32", seed)[2], spec)
    return cfg, jcfg, jp, tf.params_from_numpy(
        cfg, jax.tree.map(np.asarray, jp))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _tokens(cfg, shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _frames(cfg, b: int, seed=3, dtype="float32"):
    """(port, reference) (b, S_enc, d) frame embeddings in ``dtype``."""
    fe = np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    t, j = torch.from_numpy(fe), jnp.asarray(fe)
    if dtype == "bfloat16":
        t, j = t.to(torch.bfloat16), j.astype(jnp.bfloat16)
    return t, j


def _assert_argmax(got, want, atol):
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * atol
    assert np.all((got.argmax(-1) == want.argmax(-1)) | ~clear)


def _assert_bf16(got, want, truth):
    got, want, truth = _np(got), _np(want), _np(truth)
    out = np.abs(got - want) > BF16["atol"] + BF16["rtol"] * np.abs(want)
    assert out.mean() <= BF16_SHARE, f"{out.sum()} of {out.size} beyond BF16"
    noise = np.abs(want - truth)
    assert np.abs(got - want).max() <= 2 * noise.max()
    rms = lambda a: float(np.sqrt(np.mean(np.square(a))))
    assert rms(got - truth) <= 1.25 * rms(want - truth)
    _assert_argmax(got, want, BF16["atol"])


def test_init_params_matches_reference_tree():
    cfg, jcfg, _, _ = models()
    cfg, jcfg = (c.with_(dtype="bfloat16") for c in (cfg, jcfg))
    jp = jax.eval_shape(lambda: jt.init_params(jcfg, jax.random.PRNGKey(0)))
    p = tf.init_params(cfg, torch.Generator().manual_seed(0))
    assert set(p) == {"embed", "final_norm", "head", "stack0_dec_xattn",
                      "enc", "enc_norm", "audio_proj"}
    assert set(p["stack0_dec_xattn"]) == {"ln1", "attn", "ln2", "xattn",
                                          "ln3", "mlp"}
    assert set(p["enc"]["mlp"]) == {"wi", "wo"}            # GELU
    assert (tf.tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), p)
            == jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp))
    full = configs.get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jconfigs.get_config(ARCH))
    assert (full.n_encoder_layers, full.encoder_seq, full.head_dim) == (
        24, 1500, 64)


@pytest.mark.parametrize("enc_dtype", ["float32", "bfloat16"])
def test_cross_attn_forward_matches_reference(enc_dtype):
    """(2, 12) queries against (2, 32) encoder K/V of either dtype, on the
    float32 model's layer 0."""
    cfg, jcfg, jp, p = models()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    kv = [rng.standard_normal((2, cfg.encoder_seq, cfg.n_heads,
                               cfg.head_dim)).astype(np.float32)
          for _ in range(2)]
    jdt = jnp.bfloat16 if enc_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if enc_dtype == "bfloat16" else torch.float32
    jl = jax.tree.map(lambda a: a[0], jp["stack0_dec_xattn"]["xattn"])
    want = jattn.cross_attn_forward(jl, jcfg, jnp.asarray(x),
                                    *(jnp.asarray(a, jdt) for a in kv))
    pl = tf.tree_map(lambda a: a[0], p["stack0_dec_xattn"]["xattn"])
    got = attention.cross_attn_forward(pl, cfg, torch.from_numpy(x),
                                       *(torch.from_numpy(a).to(tdt)
                                         for a in kv))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("frames", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_reference(dtype, frames):
    """``_encode``'s cross K/V: shape (L, B, S_enc, H, hd), the frames'
    dtype as in the reference, values at F32 (float32 frames) or BF16."""
    cfg, jcfg, jp, p = models(dtype)
    fe, jfe = _frames(cfg, 2, dtype=frames)
    jk, jv = jencode(jcfg, jp, jfe)
    kfa.flash_attention.launches = 0
    k, v = tf._encode(cfg, p, fe)
    assert kfa.flash_attention.launches == 0            # CPU: plain K7
    for got, want in ((k, jk), (v, jv)):
        assert tuple(got.shape) == want.shape == (
            cfg.n_layers, 2, cfg.encoder_seq, cfg.n_heads, cfg.head_dim)
        assert str(got.dtype)[6:] == str(want.dtype) == frames
        tol = F32 if frames == "float32" else BF16
        np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_encode_binary_quant_matches_reference():
    """quant="binary": the encoder's MLP binarizes its activations, its
    attention and the cross K/V take binary_weights."""
    cfg, jcfg, jp, p = models()
    cfg, jcfg = (c.with_(quant="binary") for c in (cfg, jcfg))
    fe, jfe = _frames(cfg, 1, seed=6)
    for got, want in zip(tf._encode(cfg, p, fe), jencode(jcfg, jp, jfe)):
        np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_encode_needs_frames():
    cfg, _, _, p = models()
    with pytest.raises(ValueError, match="frontend"):
        tf.prefill(cfg, p, torch.zeros((1, 4), dtype=torch.int64))


@pytest.mark.parametrize("frames", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_prefill_match_reference(dtype, frames):
    """forward_train's logits and prefill's last position at S = 24 with
    2 sequences of frames."""
    cfg, jcfg, jp, p = models(dtype)
    toks = _tokens(cfg, (2, 24))
    jtoks = jnp.asarray(toks, jnp.int32)
    fe, jfe = _frames(cfg, 2, dtype=frames)
    want, _ = jforward_train(jcfg, jp, jt.Batch(jtoks, jtoks, jfe))
    t = torch.from_numpy(toks)
    logits, aux = tf.forward_train(cfg, p, tf.Batch(t, t, fe))
    pre = tf.prefill(cfg, p, t, frontend=fe)
    assert logits.shape == (2, 24, cfg.vocab_size) and float(aux) == 0.0
    assert str(logits.dtype)[6:] == str(want.dtype) == dtype
    if dtype == "float32" and frames == "float32":
        for g, w in ((logits, want), (pre, want[:, -1:])):
            np.testing.assert_allclose(_np(g), _np(w), **F32)
            _assert_argmax(_np(g), _np(w), F32["atol"])
        np.testing.assert_allclose(_np(pre), _np(logits)[:, -1:], **F32)
        return
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    truth, _ = jforward_train(jcfg.with_(dtype="float32"), jp32,
                              jt.Batch(jtoks, jtoks,
                                       jfe.astype(jnp.float32)))
    _assert_bf16(logits, want, truth)
    _assert_bf16(pre, want[:, -1:], truth[:, -1:])


@pytest.mark.parametrize("quant", ["binary_weights", "binary"])
def test_forward_quant_matches_reference(quant):
    cfg, jcfg, jp, p = models()
    cfg, jcfg = (c.with_(quant=quant) for c in (cfg, jcfg))
    toks = _tokens(cfg, (2, 16), seed=5)
    jtoks = jnp.asarray(toks, jnp.int32)
    fe, jfe = _frames(cfg, 2, seed=7)
    want, _ = jforward_train(jcfg, jp, jt.Batch(jtoks, jtoks, jfe))
    t = torch.from_numpy(toks)
    got, _ = tf.forward_train(cfg, p, tf.Batch(t, t, fe))
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    _assert_argmax(_np(got), _np(want), F32["atol"])


def test_audio_changes_the_logits():
    cfg, _, _, p = models()
    t = torch.from_numpy(_tokens(cfg, (1, 8)))
    a, b = (_frames(cfg, 1, seed=s)[0] for s in (3, 4))
    assert not torch.allclose(tf.prefill(cfg, p, t, frontend=a),
                              tf.prefill(cfg, p, t, frontend=b))


def test_decode_steps_match_reference():
    """Eight decode steps of 2 slots from an empty cache of 8 and no
    encoder K/V: the first step encodes ``frontend`` (the reference's
    "encode when state.enc_kv is None"), the rest reuse the state's.
    Logits at every step, the caches and enc_kv after."""
    cfg, jcfg, jp, p = models()
    fe, jfe = _frames(cfg, 2, seed=8)
    jstate = jt.init_serve_state(jcfg, 2, 8)
    state = tf.init_serve_state(cfg, 2, 8)
    assert state.enc_kv is None and jstate.enc_kv is None
    toks = _tokens(cfg, (2, 8), seed=1)
    for i in range(8):
        want, jstate = jdecode_step(
            jcfg, jp, jstate, jnp.asarray(toks[:, i:i + 1], jnp.int32),
            jfe if i == 0 else None)
        got, state = tf.decode_step(cfg, p, state,
                                    torch.from_numpy(toks[:, i:i + 1]),
                                    frontend=fe if i == 0 else None)
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    for g, w in zip((*state.caches, *state.enc_kv),
                    (*jax.tree.leaves(jstate.caches), *jstate.enc_kv)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), **F32)
    assert int(state.length) == int(jstate.length) == 8


def test_prefill_matches_decode_loop():
    """A 24-token prompt through prefill and through decode_step token by
    token on the same frames, in the port alone."""
    cfg, _, _, p = models()
    fe, _ = _frames(cfg, 1, seed=2)
    toks = torch.from_numpy(_tokens(cfg, (1, 24), seed=2))
    want = tf.prefill(cfg, p, toks, frontend=fe)[0, -1]
    state = tf.init_serve_state(cfg, 1, 24)
    for i in range(24):
        logits, state = tf.decode_step(cfg, p, state, toks[:, i:i + 1],
                                       frontend=fe)
    torch.testing.assert_close(logits[0, -1], want, **F32)
    assert int(logits[0, -1].argmax()) == int(want.argmax())


def _frame_list(cfg, n: int, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((cfg.encoder_seq, cfg.d_model)).astype(
        np.float32) for _ in range(n)]


def _serve(eng, prompts, frames, max_new=4):
    rids = [eng.submit(pr, max_new_tokens=max_new, frontend=f)
            for pr, f in zip(prompts, frames)]
    out = eng.run()
    return [out[r] for r in rids]


def test_whisper_enc_dec_serving():
    """The reference's ``tests/test_serve.py::test_whisper_enc_dec_
    serving``: three requests of one prompt with different audio through
    2 slots, each equal to the same request served alone, and to the
    reference engine's tokens; and different audio matters."""
    cfg, jcfg, jp, p = models()
    frames = _frame_list(cfg, 3)
    prompts = [[1, 2, 3]] * 3
    eng = ServingEngine(cfg, p, n_slots=2, max_len=32, device="cpu")
    enc = eng.state.enc_kv
    assert all(tuple(t.shape) == (cfg.n_layers, 2, cfg.encoder_seq,
                                  cfg.n_heads, cfg.head_dim) for t in enc)
    batched = _serve(eng, prompts, frames)
    assert all(len(t) == 4 for t in batched)
    want = _serve(JServingEngine(jcfg, jp, n_slots=2, max_len=32), prompts,
                  frames)
    assert batched == want
    solo = [_serve(ServingEngine(cfg, p, n_slots=1, max_len=32,
                                 device="cpu"), [pr], [f])[0]
            for pr, f in zip(prompts[:2], frames[:2])]
    assert solo == batched[:2]
    # the encoder input matters: the admitted slots hold different K/V,
    # and one prompt's logits differ with the audio
    assert not torch.equal(enc[0][:, 0], enc[0][:, 1])
    state = tf.init_serve_state(cfg, 1, 8)
    a, _ = tf.decode_step(cfg, p, state, torch.ones((1, 1), dtype=torch.long),
                          frontend=torch.from_numpy(frames[0])[None])
    state = tf.init_serve_state(cfg, 1, 8)
    b, _ = tf.decode_step(cfg, p, state, torch.ones((1, 1), dtype=torch.long),
                          frontend=torch.from_numpy(frames[1])[None])
    assert not torch.allclose(a, b)


def test_mixed_prompts_match_reference():
    """Five mixed-length prompts with their own audio through 3 slots
    (slots reused mid-run): every request equals the reference's."""
    cfg, jcfg, jp, p = models()
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).tolist()
               for n in (3, 7, 5, 2, 6)]
    frames = _frame_list(cfg, 5, seed=10)
    want = _serve(JServingEngine(jcfg, jp, n_slots=3, max_len=24), prompts,
                  frames, max_new=6)
    got = _serve(ServingEngine(cfg, p, n_slots=3, max_len=24, device="cpu"),
                 prompts, frames, max_new=6)
    assert got == want


def test_stale_enc_kv_is_kept_as_in_the_reference():
    """The reference's admission overwrites a slot's encoder K/V only when
    the request brings a frontend, and reset_slot zeroes the caches only:
    a request without one cross-attends to the previous request's audio
    in that slot. Pinned in both packages: on one slot, B after A equals
    B served with A's audio."""
    cfg, jcfg, jp, p = models()
    fa = _frame_list(cfg, 1, seed=11)[0]
    a, b = [4, 5, 6], [7, 8]

    def both(requests):
        out = []
        for eng in (ServingEngine(cfg, p, n_slots=1, max_len=24,
                                  device="cpu"),
                    JServingEngine(jcfg, jp, n_slots=1, max_len=24)):
            out.append(_serve(eng, [r[0] for r in requests],
                              [r[1] for r in requests]))
        assert out[0] == out[1]
        return out[0]

    stale = both([(a, fa), (b, None)])[1]
    assert stale == both([(b, fa)])[0]
    eng = ServingEngine(cfg, p, n_slots=1, max_len=24, device="cpu")
    _serve(eng, [a], [fa])
    kept = [t.clone() for t in eng.state.enc_kv]
    ptrs = [t.data_ptr() for t in eng.state.enc_kv]
    eng.model.reset_slot(eng.state, 0, 1)
    assert [t.data_ptr() for t in eng.state.enc_kv] == ptrs
    assert all(torch.equal(x, y) for x, y in zip(kept, eng.state.enc_kv))
    assert all(not bool(t.any()) for t in eng.state.caches)


def test_swap_params_in_place():
    cfg, _, _, p = models()
    p2 = models(seed=1)[3]
    frames = _frame_list(cfg, 3, seed=12)
    prompts = [[1, 2, 3], [4, 5], [6]]
    eng = ServingEngine(cfg, p, n_slots=2, max_len=24, device="cpu")
    first = _serve(eng, prompts, frames)
    ptrs = [t.data_ptr() for t in eng.params]
    eng.swap_params(eng.model.swap_arrays(p2))
    assert [t.data_ptr() for t in eng.params] == ptrs
    after = _serve(eng, prompts, frames)
    fresh = _serve(ServingEngine(cfg, p2, n_slots=2, max_len=24,
                                 device="cpu"), prompts, frames)
    assert after == fresh and after != first


@pytest.mark.parametrize("quant", ["none", "binary"])
def test_serve_cli_cpu(capsys, quant):
    kfa.flash_attention.launches = 0
    assert serve.main(["--device", "cpu", "--arch", ARCH, "--smoke",
                       "--quant", quant, "--swap", "--requests", "3",
                       "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "served 6/6 requests" in out and "hot-swap OK" in out
    assert kfa.flash_attention.launches == 0
