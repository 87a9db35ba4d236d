"""The port's LM training path past the loss (``repro_torch/train/
train_loop.py``, ``models/transformer.py``'s CE chunks and remat, the
quant modes) on the CPU against the live JAX reference
(``repro/train/train_loop.py``, ``repro/train/checkpoint.py``), on the
reference's ``init_params`` trees carried across by ``params_from_numpy``
and the same ``SyntheticLM`` batches (smoke configs).

Tolerances, each with its reason:

* float32: loss, nll and the global gradient norm at rtol 1e-5; every
  gradient leaf, updated weight, Adam moment and error-feedback residual
  within relative L2 1e-4 of the reference's, plus an absolute 1e-8 for
  leaves about 0 (float sums in another order). With 1-bit compression
  a leaf's elements become ±mean|g + e|, so an element whose g + e lies
  within the two sides' rounding gap of 0 may take the other sign in
  each. Every element whose sign differs must lie below 1e-5 of the
  leaf's mean |g + e| in the reference; such elements are left out of
  the weight, moment and residual checks, and counted (0.1% at most).
* A checkpoint written by one package and restored by the other:
  bitwise, bf16 leaves included. The third step each package takes from
  it (bf16, compressed): loss, gradients and every leaf at the zoo's
  ``BF16`` rtol, relative L2 2e-2 (two packages that round activations
  in different places); a sign that differs must lie below 0.1 of the
  leaf's mean |g + e| (0.057 measured) and is left out as above (1% at
  most; 0.05-0.8% of a leaf measured).
* quant ``binary_weights`` / ``binary`` (qwen3-8b, float32): as float32.
  The STE passes a gradient where |x| <= 1. The weights' STE inputs are
  the shared leaves, equal bit for bit in both packages, so no weight
  sits on the edge in one package only. An STE input within rounding
  (1e-6) of |x| = 1 could take the other side in each, which moves every
  upstream gradient: such elements are counted, and must be none.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jt
from repro.train import checkpoint as jck
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch import configs
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.train import frontend_shape
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.train import checkpoint as ck
from repro_torch.train import optimizer as opt
from repro_torch.train import train_loop, tree

LOSS_F32, F32_REL, ABS = 1e-5, 1e-4, 1e-8
BF16_REL = 2e-2                 # the zoo's BF16 rtol
# 1-bit codes that may differ in sign: |g + e| within SIGN_EDGE of the
# leaf's mean |g + e|, at most SIGN_SHARE of the elements
SIGN_EDGE = {"float32": 1e-5, "bfloat16": 0.1}
SIGN_SHARE = {"float32": 1e-3, "bfloat16": 1e-2}
STE_EDGE = 1e-6
LR = 3e-4
STEP_BATCH, STEP_SEQ = 4, 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these smoke-sized tensors: the test runner
    runs several workers side by side, whose thread pools would otherwise
    contend for every small op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, dtype, remat=False, quant="none"):
    cfg = configs.get_config(arch, smoke=True, quant=quant)
    jcfg = jconfigs.get_config(arch, smoke=True, quant=quant)
    return (cfg.with_(dtype=dtype, remat=remat),
            jcfg.with_(dtype=dtype, remat=remat))


@functools.lru_cache(maxsize=None)
def reference_tree(arch: str, dtype: str, quant: str = "none"):
    """The reference's ``init_params`` tree in ``dtype``."""
    _, jcfg = _configs(arch, dtype, quant=quant)
    return jax.jit(jt.init_params, static_argnums=0)(jcfg,
                                                     jax.random.PRNGKey(0))


def port_tree(arch, dtype, quant="none"):
    cfg, _ = _configs(arch, dtype, quant=quant)
    return tf.params_from_numpy(cfg, jax.tree.map(
        np.asarray, reference_tree(arch, dtype, quant)))


def batches(cfg, batch: int, seq: int, step: int):
    """(port Batch, reference Batch) of ``SyntheticLM``'s batch ``step``."""
    b = SyntheticLM(cfg.vocab_size, seq, batch, seed=0,
                    frontend=frontend_shape(cfg)).batch(step)
    fe = None if b.frontend is None else jnp.asarray(b.frontend.numpy())
    return b, jt.Batch(jnp.asarray(b.tokens.numpy()),
                       jnp.asarray(b.targets.numpy()), fe)


def rel_err(got, want) -> tuple[float, float]:
    """(‖got − want‖, ‖want‖) in float64 of two arrays or tensors."""
    got = np.asarray(got.to(torch.float32) if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)), float(np.linalg.norm(want))


def grads_close(got, want, rel=F32_REL):
    """``got`` [(path, port gradient)] against the reference's leaves."""
    assert len(got) == len(want)
    for (key, g), w in zip(got, want):
        assert tuple(g.shape) == w.shape, key
        err, norm = rel_err(g, w)
        assert err <= rel * norm + ABS, (key, err, norm)


def reference_value_and_grad(jcfg, jp, jb):
    (loss, _), g = jax.jit(jax.value_and_grad(
        lambda p, b: jt.loss_fn(jcfg, p, b), has_aux=True))(jp, jb)
    return float(loss), [np.asarray(a, np.float32) for a in jax.tree.leaves(g)]


def port_value_and_grad(cfg, params, b):
    loss, nll, g = train_loop.value_and_grad(cfg, params, b)
    return float(loss), tree.leaves_with_path(g)


# ------------------------------------------------- CE chunks and remat
def test_loss_chunks_and_leftover_positions():
    """S = 1088: two CE chunks of 512, the last 64 positions left out,
    and two blockwise KV blocks (the second padded)."""
    cfg, jcfg = _configs("qwen3-8b", "float32")
    params = port_tree("qwen3-8b", "float32")
    b, jb = batches(cfg, 2, 1088, 0)
    want_loss, want = reference_value_and_grad(
        jcfg, reference_tree("qwen3-8b", "float32"), jb)
    loss, got = port_value_and_grad(cfg, params, b)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_F32)
    grads_close(got, want)
    # the left-out positions: changing their targets changes nothing
    moved = b.targets.clone()
    moved[:, 1024:] = (moved[:, 1024:] + 1) % cfg.vocab_size
    with torch.no_grad():
        a = tf.loss_fn(cfg, params, b)[0]
        c = tf.loss_fn(cfg, params, b._replace(targets=moved))[0]
    assert torch.equal(a, c)
    assert tf.LOSS_CHUNK == 512


def test_remat_changes_no_value(monkeypatch):
    """remat on and off give the same loss and gradients bitwise (the
    recompute repeats the forward exactly), and remat wraps every layer
    in ``torch.utils.checkpoint``: the encoder's and the decoder's; the
    CE chunks run under it whenever grad mode is on."""
    cfg, _ = _configs("whisper-medium", "float32")
    params = port_tree("whisper-medium", "float32")
    b = batches(cfg, 2, 64, 0)[0]
    off = train_loop.value_and_grad(cfg, params, b)
    calls = []
    real = tf.checkpoint

    def counted(fn, *args, **kw):
        calls.append(fn.__name__)
        return real(fn, *args, **kw)
    monkeypatch.setattr(tf, "checkpoint", counted)
    on = train_loop.value_and_grad(cfg.with_(remat=True), params, b)
    assert torch.equal(off[0], on[0])
    assert all(torch.equal(x, y) for x, y in zip(tree.tree_leaves(off[2]),
                                                  tree.tree_leaves(on[2])))
    assert calls.count("_apply_enc_layer") == cfg.n_encoder_layers
    assert calls.count("_apply_dec_xattn") == cfg.n_layers
    assert calls.count("_ce_chunk") == 1
    calls.clear()
    with torch.no_grad():
        tf.loss_fn(cfg.with_(remat=True), params, b)
    assert not calls


# ------------------------------------------------------------------ quant
@pytest.mark.parametrize("quant", ["binary_weights", "binary"])
def test_binary_quant_grads_match_reference(quant, monkeypatch):
    inputs = []
    real = layers.binarize_ste

    def recorded(x):
        inputs.append(x.detach().clone())
        return real(x)
    monkeypatch.setattr(layers, "binarize_ste", recorded)
    cfg, jcfg = _configs("qwen3-8b", "float32", True, quant)
    b, jb = batches(cfg, 2, 64, 0)
    want_loss, want = reference_value_and_grad(
        jcfg, reference_tree("qwen3-8b", "float32", quant), jb)
    loss, got = port_value_and_grad(cfg, port_tree("qwen3-8b", "float32",
                                                   quant), b)
    # each layer binarizes its 7 weights, and in "binary" mode the MLP's
    # 3 inputs too; remat runs every layer twice
    per_layer = 7 + 3 * (quant == "binary")
    assert len(inputs) == 2 * cfg.n_layers * per_layer
    edge = sum(int(((x.abs() - 1).abs() <= STE_EDGE).sum()) for x in inputs)
    assert edge == 0, f"{edge} STE inputs within {STE_EDGE} of |x| = 1"
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_F32)
    grads_close(got, want)


# -------------------------------------------------------- the train step
def _states(arch, dtype, compress, adamw, jadamw, quant="none"):
    """(port TrainState, reference TrainState) on the shared weights."""
    p = port_tree(arch, dtype, quant)
    jp = reference_tree(arch, dtype, quant)
    return (train_loop.TrainState(p, adamw.init(p),
                                  opt.ef_init(p) if compress else None),
            jtl.TrainState(jp, jadamw.init(jp),
                           jopt.ef_init(jp) if compress else None))


def sign_flips(grads, want, ef, edge: float) -> dict:
    """Per parameter path the elements where the two packages' 1-bit
    codes take opposite signs: ``grads`` (the port's) and ``want`` (the
    reference's gradient leaves) plus the shared residual ``ef``. Each
    such element must lie within ``edge`` of the leaf's mean |g + e| of
    0 in the reference, where the code is decided by rounding."""
    out = {}
    for (key, g), w, e in zip(tree.leaves_with_path(grads), want,
                              tree.tree_leaves(ef.residual)):
        e = e.numpy()
        t, tw = g.to(torch.float32).numpy() + e, w + e
        flip = (t >= 0) != (tw >= 0)
        assert np.all(np.abs(tw[flip]) < edge * np.abs(tw).mean()), key
        out[key] = flip
    return out


def _param_path(key: str) -> str:
    for prefix in ("params/", "opt/m/", "opt/v/", "ef/residual/"):
        if key.startswith(prefix):
            return key[len(prefix):]
    return key


def states_close(port, ref, rel, flips=None) -> int:
    """Every leaf of the port's ``TrainState`` against the reference's
    (``jck._flatten`` paths: the checkpoint keys), leaving out each
    parameter's ``flips`` elements in its weight, moments and residual.
    Returns the number of elements left out."""
    want = jck._flatten(ref)
    got = tree.leaves_with_path(port)
    assert {k for k, _ in got} == set(want)
    left = 0
    for key, a in got:
        w = want[key]
        if a is None:
            assert w is None, key
            continue
        assert tuple(a.shape) == np.shape(w) and str(a.dtype)[6:] == str(
            w.dtype), key
        if key == "opt/step":
            assert int(a) == int(w)
            continue
        a = a.to(torch.float32).numpy()
        w = np.asarray(w, np.float32)
        if flips is not None:
            mask = flips[_param_path(key)]
            left += int(mask.sum())
            a, w = np.where(mask, 0, a), np.where(mask, 0, w)
        err, norm = rel_err(a, w)
        assert err <= rel * norm + ABS, (key, err, norm)
    return left


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches, compress):
    cfg, jcfg = _configs("qwen3-8b", "float32")
    adamw, jadamw = opt.AdamW(lr=LR), jopt.AdamW(lr=LR)
    state, jstate = _states("qwen3-8b", "float32", compress, adamw, jadamw)
    b, jb = batches(cfg, STEP_BATCH, STEP_SEQ, 0)
    step = train_loop.make_train_step(cfg, adamw, microbatches=microbatches,
                                      compress_grads=compress,
                                      keep_grads=True)
    jstep = jax.jit(jtl.make_train_step(jcfg, jadamw,
                                        microbatches=microbatches,
                                        compress_grads=compress))
    new, m = step(state, b)
    jnew, jm = jstep(jstate, jb)
    for k in ("loss", "nll", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=LOSS_F32)
    # the gradients the reference's step took, at the same tolerance
    want = reference_value_and_grad(jcfg, jstate.params, jb)[1]
    if microbatches == 1:
        grads_close(tree.leaves_with_path(m["grads"]), want)
    else:
        assert all(g.dtype == torch.float32
                   for g in tree.tree_leaves(m["grads"]))
    flips = (sign_flips(m["grads"], want, state.ef, SIGN_EDGE["float32"])
             if compress else None)
    left = states_close(new, jnew, F32_REL, flips)
    n = sum(t.numel() for t in tree.tree_leaves(state.params))
    assert left <= SIGN_SHARE["float32"] * 4 * n   # params, m, v, residual
    assert (new.ef is None) == (not compress)
    # the parameters keep their dtype; the caller's state is untouched
    assert all(torch.equal(a, b_) for a, b_ in zip(
        tree.tree_leaves(state.params),
        tree.tree_leaves(port_tree("qwen3-8b", "float32"))))


def test_microbatches_mean_the_full_batch():
    """Two microbatches of a batch give the full batch's loss and
    gradients (the CE means over equal halves), within float32
    rounding."""
    cfg, _ = _configs("qwen3-8b", "float32")
    params = port_tree("qwen3-8b", "float32")
    adamw = opt.AdamW(lr=LR)
    state = train_loop.TrainState(params, adamw.init(params), None)
    b = batches(cfg, STEP_BATCH, STEP_SEQ, 0)[0]
    one = train_loop.make_train_step(cfg, adamw, keep_grads=True)(state, b)
    two = train_loop.make_train_step(cfg, adamw, microbatches=2,
                                     keep_grads=True)(state, b)
    np.testing.assert_allclose(float(two[1]["loss"]), float(one[1]["loss"]),
                               rtol=LOSS_F32)
    for a, w in zip(tree.tree_leaves(two[1]["grads"]),
                    tree.tree_leaves(one[1]["grads"])):
        err, norm = rel_err(a, w.numpy())
        assert err <= F32_REL * norm + ABS
    with pytest.raises(ValueError, match="multiple"):
        train_loop.make_train_step(cfg, adamw, microbatches=3)(state, b)


def test_init_train_state_and_serve_step(monkeypatch):
    """``init_train_state`` builds the reference's ``TrainState``
    structure (the checkpoint keys, shapes and dtypes), zero moments and
    residuals; ``make_serve_step`` is ``decode_step``."""
    for compress in (False, True):
        cfg, jcfg = _configs("deepseek-v2-lite-16b", "bfloat16")
        adamw = opt.AdamW()
        state = train_loop.init_train_state(
            cfg, torch.Generator().manual_seed(0), adamw, compress,
            device="cpu")
        jstate = jax.eval_shape(lambda: jtl.init_train_state(
            jcfg, jax.random.PRNGKey(0), jopt.AdamW(), compress))
        want = {k: (np.shape(v), None if v is None else str(v.dtype))
                for k, v in jck._flatten(jstate).items()}
        got = {k: (tuple(v.shape), str(v.dtype)[6:]) if v is not None
               else ((), None) for k, v in tree.leaves_with_path(state)}
        assert got == want
        assert all(not bool(t.any()) for t in tree.tree_leaves(
            (state.opt.m, state.opt.v)))
        assert int(state.opt.step) == 0
    cfg, _ = _configs("qwen3-8b", "float32")
    params = port_tree("qwen3-8b", "float32")
    toks = torch.from_numpy(np.array([[3], [7]]))
    a = train_loop.make_serve_step(cfg)(params, tf.init_serve_state(
        cfg, 2, 8), toks)[0]
    b = tf.decode_step(cfg, params, tf.init_serve_state(cfg, 2, 8), toks)[0]
    assert torch.equal(a, b)
    # the default device is the card: no quiet CPU where there is none
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train_loop.init_train_state(cfg, torch.Generator(), adamw)


# ---------------------------------------------------- checkpoints crossing
def _two_then_third(save_with: str, tmp_path):
    """Two compressed bf16 steps in one package, a checkpoint written by
    it and restored by the other (bitwise), then the third step by each
    from there."""
    cfg, jcfg = _configs("qwen3-8b", "bfloat16")
    adamw, jadamw = opt.AdamW(lr=LR), jopt.AdamW(lr=LR)
    state, jstate = _states("qwen3-8b", "bfloat16", True, adamw, jadamw)
    step = train_loop.make_train_step(cfg, adamw, compress_grads=True)
    jstep = jax.jit(jtl.make_train_step(jcfg, jadamw, compress_grads=True))
    d = str(tmp_path)
    if save_with == "jax":
        for i in range(2):
            jstate, _ = jstep(jstate, batches(cfg, 2, STEP_SEQ, i)[1])
        jck.save(d, 2, jstate)
        state, at = ck.restore(d, state)
    else:
        for i in range(2):
            state, _ = step(state, batches(cfg, 2, STEP_SEQ, i)[0])
        ck.save(d, 2, state)
        jstate, at = jck.restore(d, jstate)
    assert at == 2
    flat = jck._flatten(jstate)
    for key, a in tree.leaves_with_path(state):
        w = flat[key]
        assert (a is None) == (w is None), key
        if a is not None:
            assert str(a.dtype)[6:] == str(w.dtype), key
            np.testing.assert_array_equal(a.to(torch.float32).numpy(),
                                          np.asarray(w, np.float32))
    assert any(a.dtype == torch.bfloat16 for a in tree.tree_leaves(state))
    b, jb = batches(cfg, 2, STEP_SEQ, 2)
    new, m = train_loop.make_train_step(cfg, adamw, compress_grads=True,
                                        keep_grads=True)(state, b)
    jnew, jm = jstep(jstate, jb)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=BF16_REL)
    want = reference_value_and_grad(jcfg, jstate.params, jb)[1]
    grads_close(tree.leaves_with_path(m["grads"]), want, BF16_REL)
    flips = sign_flips(m["grads"], want, state.ef, SIGN_EDGE["bfloat16"])
    left = states_close(new, jnew, BF16_REL, flips)
    n = sum(t.numel() for t in tree.tree_leaves(state.params))
    assert left <= SIGN_SHARE["bfloat16"] * 4 * n


@pytest.mark.parametrize("save_with", ["jax", "port"])
def test_checkpoint_crosses_packages(save_with, tmp_path):
    _two_then_third(save_with, tmp_path)
