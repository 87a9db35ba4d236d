"""The port's packed serving form of the LM zoo (``repro_torch/serve/
packing.py``, the packed branch of ``models/layers.py::dense``, the MoE's
packed experts) and the small helpers (``layers.dense_packed_init``,
``core/bitpack.py::xnor_popcount_words`` / ``pm1_from_xnor`` /
``packed_nbytes``, ``kernels/ops.py::pack_weights``,
``kernels/ref.py::xnor_matmul_pm1_ref``, ``configs.get_shapes`` /
``get_skipped_shapes``) on the CPU against the live JAX reference.

Packing folds only projections with at least 256 input rows, so the
trees are the smoke configs of qwen3-8b (dense), deepseek-v2-lite-16b
(moe) and whisper-medium (audio) widened to d_model 256 (``WIDE``), with
the reference's ``init_params`` carried across by ``params_from_numpy``.
Packed words and α are held bit for bit; forwards and decode steps at
float32 rtol = atol = 1e-5; served tokens equal; the helpers exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import bitpack as jbitpack
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro.serve import ServingEngine as JServingEngine
from repro.serve import packing as jpacking
from repro_torch import configs
from repro_torch.core import bitpack
from repro_torch.kernels import ops, ref
from repro_torch.models import layers, moe
from repro_torch.models import transformer as tf
from repro_torch.serve import packing
from repro_torch.serve.engine import ServingEngine

F32 = dict(rtol=1e-5, atol=1e-5)
WIDE = {
    "qwen3-8b": dict(d_model=256, d_ff=512, n_heads=4, n_kv_heads=2,
                     head_dim=64),
    "deepseek-v2-lite-16b": dict(d_model=256, d_ff=512, moe_d_ff=256,
                                 kv_lora_rank=256),
    "whisper-medium": dict(d_model=256, d_ff=512, n_heads=4, n_kv_heads=4,
                           head_dim=64),
}
ARCHS = tuple(WIDE)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def models(arch: str, quant: str = "none"):
    """(port cfg, reference cfg, reference params, port params, reference
    packed tree, port packed tree), float32."""
    kw = dict(WIDE[arch], dtype="float32", quant=quant)
    jcfg = jconfigs.get_config(arch, smoke=True).with_(**kw)
    cfg = configs.get_config(arch, smoke=True).with_(**kw)
    if quant != "none":
        _, _, jp, p, jpp, pp = models(arch)
        return cfg, jcfg, jp, p, jpp, pp
    jp = jax.jit(jt.init_params, static_argnums=0)(jcfg,
                                                  jax.random.PRNGKey(0))
    p = tf.params_from_numpy(cfg, jax.tree.map(np.asarray, jp))
    return (cfg, jcfg, jp, p, jpacking.pack_params_for_serving(jp),
            packing.pack_params_for_serving(p))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _flat(tree, path=()) -> dict:
    """{key path: leaf} of a nested dict."""
    if not isinstance(tree, dict):
        return {path: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, path + (k,)))
    return out


def _assert_trees_equal(got: dict, want) -> int:
    """Every leaf of the port's tree equal to the reference's bit for bit
    (same keys, shapes, dtypes); returns the packed leaves."""
    got = _flat(got)
    want = {tuple(k.key for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(want)}
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert str(g.dtype)[6:] == str(w.dtype), key
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=str(
            key))
    return sum(k[-1] in ("w_packed", "alpha") for k in got)


@pytest.mark.parametrize("arch", ARCHS)
def test_pack_tree_matches_reference(arch):
    """pack_params_for_serving: the same leaves packed, words and α bit
    for bit, every other leaf unchanged; packed_fraction equal."""
    _, _, _, p, jpp, pp = models(arch)
    n = _assert_trees_equal(pp, jpp)
    assert n >= 14                  # qwen3: 7 projections a layer
    assert packing.packed_fraction(pp) == jpacking.packed_fraction(jpp)
    assert packing.packed_fraction(pp) > 0.85
    assert packing.packed_fraction(p) == 0.0
    # the caller's full-precision leaves are shared, not copied
    assert pp["embed"]["embedding"] is p["embed"]["embedding"]


def test_pack_policy_keeps_first_last_fp():
    """The reference's ``test_pack_policy_keeps_first_last_fp`` and
    ``test_pack_moe_experts_and_router``, on the widened trees."""
    cfg, _, _, _, _, pp = models("qwen3-8b")
    assert "embedding" in pp["embed"] and "w" in pp["head"]
    st = pp["stack0_dense_attn"]
    assert st["attn"]["wq"]["w_packed"].dtype == torch.int32
    assert st["mlp"]["wi"]["w_packed"].shape[-1] == cfg.d_model // 32
    assert tuple(st["mlp"]["wi"]["alpha"].shape) == (cfg.n_layers, cfg.d_ff)
    cfg, _, _, _, _, pp = models("deepseek-v2-lite-16b")
    mp = pp["stack1_moe"]["moe"]
    assert tuple(mp["experts"]["wi"]["w_packed"].shape) == (
        cfg.n_layers - cfg.first_dense_layers, cfg.n_experts, cfg.moe_d_ff,
        cfg.d_model // 32)
    assert "w" in mp["router"]
    assert "w" in pp["stack1_moe"]["attn"]["wk_b"]
    _, _, _, _, _, pp = models("whisper-medium")
    assert "w" in pp["audio_proj"]
    assert "w_packed" in pp["enc"]["attn"]["wq"]
    assert "w_packed" in pp["stack0_dec_xattn"]["xattn"]["wk"]


def test_pack_expert_stacks_of_3_and_4_dims():
    """MoE expert stacks of one layer (E, d_in, d_out) and of the layer
    stack (L, E, d_in, d_out), folded as the reference's nested ``vmap``
    of ``_pack_leaf`` folds them."""
    _, _, jp, p, _, _ = models("deepseek-v2-lite-16b")
    for k in ("wi", "wg", "wo"):
        w4 = p["stack1_moe"]["moe"]["experts"][k]
        jw4 = jp["stack1_moe"]["moe"]["experts"][k]
        assert w4.dim() == 4
        _assert_trees_equal(packing._pack_leaf(w4), jpacking._pack_leaf(jw4))
        _assert_trees_equal(packing._pack_leaf(w4[0]),
                            jpacking._pack_leaf(jw4[0]))
    layer = tf.tree_map(lambda a: a[0], p["stack1_moe"]["moe"])
    jlayer = jax.tree.map(lambda a: a[0], jp["stack1_moe"]["moe"])
    _assert_trees_equal(packing.pack_params_for_serving(layer),
                        jpacking.pack_params_for_serving(jlayer))


@pytest.mark.parametrize("rows", [256, 512, 1024, 2048, 4096])
def test_alpha_sum_order_matches_reference(rows):
    """α of (rows, 96) weights, and stacked (3, rows, 40), bit for bit:
    the windowed float32 sum of ``packing._sum_rows``."""
    rng = np.random.default_rng(rows)
    for shape in ((rows, 96), (3, rows, 40)):
        w = rng.standard_normal(shape).astype(np.float32)
        _assert_trees_equal(packing._pack_leaf(torch.from_numpy(w)),
                            jpacking._pack_leaf(jnp.asarray(w)))


def test_dense_packed_equals_sign_matmul():
    """The reference's case: a packed (256, 96) dense == x @ (sign(w) α)
    (float32 here, so at F32 where the reference's bf16 needs 2e-2)."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((256, 96)).astype(np.float32)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    y = layers.dense(packing._pack_leaf(torch.from_numpy(w)),
                     torch.from_numpy(x))
    want = x @ (np.where(w >= 0, 1.0, -1.0) * np.abs(w).mean(axis=0))
    np.testing.assert_allclose(_np(y), want, **F32)
    jy = jlayers.dense(jpacking._pack_leaf(jnp.asarray(w)), jnp.asarray(x))
    np.testing.assert_allclose(_np(y), _np(jy), **F32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_packed_stacked_artifact(dtype):
    """A stacked (E, out, words) artifact with (E, out) α on (E, M, in)
    activations == each expert's 2-D artifact on its own rows."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((3, 256, 40)).astype(
        np.float32))
    x = torch.from_numpy(rng.standard_normal((3, 5, 256)).astype(
        np.float32)).to(dtype)
    art = packing._pack_leaf(w)
    y = layers.dense(art, x, "binary_weights")
    assert y.dtype == dtype and tuple(y.shape) == (3, 5, 40)
    for e in range(3):
        one = {k: v[e] for k, v in art.items()}
        assert torch.equal(y[e], layers.dense(one, x[e]))


@pytest.mark.parametrize("quant", ["none", "binary_weights", "binary"])
@pytest.mark.parametrize("arch", ARCHS)
def test_packed_forward_matches_reference(arch, quant):
    """forward_train on each package's own packed tree, (2, 16) tokens
    (whisper: with 2 sequences of frames), at F32."""
    cfg, jcfg, _, _, jpp, pp = models(arch, quant)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16))
    jtoks = jnp.asarray(toks, jnp.int32)
    fe = jfe = None
    if cfg.family == "audio":
        f = np.random.default_rng(3).standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        fe, jfe = torch.from_numpy(f), jnp.asarray(f)
    want, jaux = jt.forward_train(jcfg, jpp, jt.Batch(jtoks, jtoks, jfe))
    t = torch.from_numpy(toks)
    got, aux = tf.forward_train(cfg, pp, tf.Batch(t, t, fe))
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(float(aux), float(jaux), **F32)


def test_packed_moe_apply_matches_reference():
    """moe_apply of one layer with packed experts (3-dim stacks), float32
    and bf16 activations: y and the aux loss."""
    cfg, jcfg, jp, p, _, _ = models("deepseek-v2-lite-16b")
    layer = packing.pack_params_for_serving(
        tf.tree_map(lambda a: a[0], p["stack1_moe"]["moe"]))
    jlayer = jpacking.pack_params_for_serving(
        jax.tree.map(lambda a: a[0], jp["stack1_moe"]["moe"]))
    assert "w_packed" in layer["experts"]["wo"]
    x = np.random.default_rng(4).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        y, aux = moe.moe_apply(layer, cfg, torch.from_numpy(x).to(tdt))
        jy, jaux = jmoe.moe_apply(jlayer, jcfg, jnp.asarray(x, jdt))
        assert y.dtype == tdt
        tol = F32 if tdt == torch.float32 else dict(rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(_np(y), _np(jy), **tol)
        np.testing.assert_allclose(float(aux), float(jaux), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_decode_and_serve_match_reference(arch):
    """The reference's ``test_packed_forward_runs`` (a decode step on a
    packed tree at quant binary_weights) held against the reference's
    logits, then three requests served through 2 slots, tokens equal."""
    cfg, jcfg, _, _, jpp, pp = models(arch, "binary_weights")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 1))
    f = np.random.default_rng(6).standard_normal(
        (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    audio = cfg.family == "audio"
    want, _ = jt.decode_step(jcfg, jpp, jt.init_serve_state(jcfg, 2, 16),
                             jnp.asarray(toks, jnp.int32),
                             jnp.asarray(f) if audio else None)
    got, _ = tf.decode_step(cfg, pp, tf.init_serve_state(cfg, 2, 16),
                            torch.from_numpy(toks),
                            torch.from_numpy(f) if audio else None)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9]]
    frames = [f[0], f[1], f[0]] if audio else [None] * 3

    def run(eng):
        rids = [eng.submit(pr, max_new_tokens=4, frontend=fr)
                for pr, fr in zip(prompts, frames)]
        out = eng.run()
        return [out[r] for r in rids]
    eng = ServingEngine(cfg, pp, n_slots=2, max_len=16, device="cpu")
    assert run(eng) == run(JServingEngine(jcfg, jpp, n_slots=2, max_len=16))


def test_dense_packed_init():
    g = torch.Generator().manual_seed(0)
    got = layers.dense_packed_init(g, 300, 48)
    want = jax.eval_shape(lambda: jlayers.dense_packed_init(
        jax.random.PRNGKey(0), 300, 48))
    for k in ("w_packed", "alpha"):
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype)[6:] == str(want[k].dtype)
    assert torch.equal(got["alpha"], torch.ones(48))
    x = torch.randn((2, 300), generator=g)
    assert tuple(layers.dense(got, x).shape) == (2, 48)


def _rand_pm1(rng, shape) -> np.ndarray:
    return np.where(rng.standard_normal(shape) >= 0, 1.0, -1.0).astype(
        np.float32)


KERNEL_SHAPES = [(8, 64, 16), (16, 256, 32), (128, 1024, 128),
                 (130, 300, 70), (1, 512, 256)]


@pytest.mark.parametrize("m,k,n", KERNEL_SHAPES)
def test_xnor_matmul_pm1_ref_matches_reference(m, k, n):
    """``tests/test_kernels.py::test_xnor_matmul_matches_oracle``'s
    shapes: the ±1-domain oracle equal to the reference's, to the packed
    oracle and to ``ops.xnor_matmul`` (plain on the CPU) on words made by
    ``pack_weights``."""
    rng = np.random.default_rng(m * 7 + k + n)
    a, w = _rand_pm1(rng, (m, k)), _rand_pm1(rng, (n, k))
    got = ref.xnor_matmul_pm1_ref(torch.from_numpy(a), torch.from_numpy(w))
    want = jref.xnor_matmul_pm1_ref(jnp.asarray(a), jnp.asarray(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    aw = ops.pack_weights(torch.from_numpy(a))
    ww = ops.pack_weights(torch.from_numpy(w))
    np.testing.assert_array_equal(ww.numpy(), np.asarray(
        jops.pack_weights(jnp.asarray(w))))
    assert torch.equal(ref.xnor_matmul_ref(aw, ww, k), got)
    assert torch.equal(ops.xnor_matmul(aw, ww, k=k, path="xla"), got)


def test_batched_leading_dims():
    rng = np.random.default_rng(3)
    a, w = _rand_pm1(rng, (4, 6, 96)), _rand_pm1(rng, (24, 96))
    y = ops.xnor_matmul(ops.pack_weights(torch.from_numpy(a)),
                        ops.pack_weights(torch.from_numpy(w)), k=96,
                        path="mxu")
    assert tuple(y.shape) == (4, 6, 24)
    want = ref.xnor_matmul_pm1_ref(torch.from_numpy(a.reshape(24, 96)),
                                   torch.from_numpy(w)).reshape(4, 6, 24)
    assert torch.equal(y, want)


@pytest.mark.parametrize("k", [1, 31, 32, 33, 70, 200, 257])
def test_xnor_words_and_pm1_from_xnor(k):
    """``tests/test_properties.py::test_xnor_dot_equals_pm1_dot`` on
    seeded draws: per-word XNOR popcounts equal to the reference's, and
    eq. 6 turns xnor_dot's agree-counts back into the ±1 dot."""
    rng = np.random.default_rng(k)
    a, w = _rand_pm1(rng, (3, k)), _rand_pm1(rng, (5, k))
    aw, ww = bitpack.pack_pm1(torch.from_numpy(a)), bitpack.pack_pm1(
        torch.from_numpy(w))
    pc = bitpack.xnor_popcount_words(aw[:, None, :], ww[None, :, :])
    jpc = jbitpack.xnor_popcount_words(
        jnp.asarray(aw.numpy())[:, None, :], jnp.asarray(ww.numpy())[None])
    assert pc.dtype == torch.int32
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jpc))
    y_l = bitpack.xnor_dot(aw[:, None, :], ww[None, :, :], k)
    y = bitpack.pm1_from_xnor(y_l, k)
    np.testing.assert_array_equal(y.numpy(), (a @ w.T).astype(np.int64))
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(jbitpack.pm1_from_xnor(jnp.asarray(
            y_l.numpy()), k)))


@pytest.mark.parametrize("shape", [(7,), (1, 32), (3, 33), (2, 4, 1024),
                                   (5, 0, 64)])
def test_packed_nbytes(shape):
    assert bitpack.packed_nbytes(shape) == jbitpack.packed_nbytes(shape)


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCH_MODULES)
                         + sorted(jconfigs.BINARY_LM_MODULES))
def test_get_shapes(arch):
    got, want = configs.get_shapes(arch), jconfigs.get_shapes(arch)
    assert [getattr(s, "__dict__", s) for s in got] == [
        getattr(s, "__dict__", s) for s in want]
    assert configs.get_skipped_shapes(arch) == (
        jconfigs.get_skipped_shapes(arch))
