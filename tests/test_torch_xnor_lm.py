"""The port's XNOR LM serving slice on the CPU against the live JAX
reference (``repro/models/xnor_lm.py``, ``repro/serve/engine.py``), at the
reference tests' ``CFG`` and the registry's ``SMOKE_CONFIG``.

Both sides get the same latent params, made with numpy
(``models/xnor_lm.py::numpy_params``: random BN statistics, γ of both
signs) and folded by each side. The reference's Pallas kernels run in
interpret mode, as its own tests run them; never against its fixed-seed
goldens.

* ``fold`` leaves are equal, and every projection's agree-counts are
  exact in both modes when fed the reference's own activations.
* Logits: allclose at rtol = atol = 1e-5 with equal argmax. The integer
  parts are exact, but RMSNorm's mean, rsqrt and the softmax sum in
  another order in float32 (a few ulps; 1e-6 measured); a binarize input
  within that distance of 0 would flip a bit and show up here as a
  larger error. In the port, "bw" and "xnor" are bitwise equal.
* Greedy tokens and served tokens are equal to the reference's.
* The engine: co-tenancy independence, in-place hot-swap, incompatible
  swaps and overlong prompts rejected, idle slots stepped past the cache.
* The tuner's mode race under fake clocks, and the serving CLI.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binarize as jbinarize
from repro.core import blinear as jblinear
from repro.models import xnor_lm as jxl
from repro_torch import configs
from repro_torch.core import binarize
from repro_torch.core import execution_plan as xp
from repro_torch.kernels import autotune as at
from repro_torch.kernels import ref
from repro_torch.launch import serve
from repro_torch.models import xnor_lm as xl

CFG = xl.XnorLMConfig(vocab_size=32, d_model=32, n_layers=2, n_heads=2,
                      d_ff=32, max_len=32)
JCFG = jxl.XnorLMConfig(vocab_size=32, d_model=32, n_layers=2, n_heads=2,
                        d_ff=32, max_len=32)
PROMPT = [3, 1, 4, 1, 5]
TOL = dict(rtol=1e-5, atol=1e-5)
MIXED = [(3, 7, 5, 2, 6), 6]          # prompt lengths, max_new


def to_jax(p):
    """The port's numpy latent params as the reference's XnorLMParams."""
    def blin(b):
        return jblinear.BLinearParams(
            w=jnp.asarray(b.w), bn_mean=jnp.asarray(b.bn_mean),
            bn_var=jnp.asarray(b.bn_var), bn_gamma=jnp.asarray(b.bn_gamma),
            bn_beta=jnp.asarray(b.bn_beta))
    blocks = tuple(jxl.XnorBlockParams(
        ln1=jnp.asarray(b.ln1), wq=blin(b.wq), wk=blin(b.wk), wv=blin(b.wv),
        wo=blin(b.wo), ln2=jnp.asarray(b.ln2), w_up=blin(b.w_up),
        w_down=blin(b.w_down)) for b in p.blocks)
    return jxl.XnorLMParams(
        tok_embed=jnp.asarray(p.tok_embed), pos_embed=jnp.asarray(p.pos_embed),
        blocks=blocks, ln_f=jnp.asarray(p.ln_f), w_head=jnp.asarray(p.w_head))


@functools.lru_cache(maxsize=None)
def models(seed: int = 0, cfg: xl.XnorLMConfig = CFG):
    """(port packed, reference packed) from one set of numpy params."""
    npp = xl.numpy_params(cfg, seed)
    jcfg = jxl.XnorLMConfig(**{f: getattr(cfg, f) for f in (
        "vocab_size", "d_model", "n_layers", "n_heads", "d_ff", "max_len")})
    return (xl.fold(cfg, xl.params_from_numpy(npp)),
            jxl.fold(jcfg, to_jax(npp)))


def mixed_prompts():
    rng = np.random.default_rng(2)
    return [[int(t) for t in rng.integers(0, CFG.vocab_size, (n,))]
            for n in MIXED[0]]


@pytest.fixture(scope="module")
def ref_engine_out():
    """The reference engine's tokens for the mixed prompts (3 slots)."""
    _, pj = models()
    eng, _ = jxl.make_serving_engine(JCFG, pj, n_slots=3)
    rids = [eng.submit(p, max_new_tokens=MIXED[1]) for p in mixed_prompts()]
    out = eng.run()
    return [out[r] for r in rids]


# ------------------------------------------------------------------ config
def test_config_checks_and_param_count_match_reference():
    for bad in (dict(d_model=48), dict(d_ff=100), dict(d_model=64, n_heads=3)):
        with pytest.raises(ValueError):
            xl.XnorLMConfig(**bad)
    # the port's latent params hold as many numbers as the reference counts
    p = xl.init(CFG, torch.Generator().manual_seed(0))
    assert sum(t.numel() for t in xl.split_packed(p)[0]) == JCFG.param_count()
    assert CFG.head_dim == JCFG.head_dim
    tiny = configs.get_config("xnor-lm-tiny")
    assert (tiny.vocab_size, tiny.d_model, tiny.n_layers, tiny.n_heads,
            tiny.d_ff, tiny.max_len) == (256, 128, 4, 4, 256, 256)
    assert configs.get_config("xnor-lm-tiny", smoke=True).d_ff == 96
    # the LM zoo, every family of it, is registered beside it
    assert configs.get_config("qwen3-8b").family == "dense"
    assert configs.get_config("whisper-medium").family == "audio"
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("whisper-tiny")


def test_binarize_matches_reference():
    x = np.array([-2.0, -1e-9, 0.0, 1e-9, 3.0], np.float32)
    np.testing.assert_array_equal(
        binarize.binarize_ste(torch.from_numpy(x)).numpy(),
        np.asarray(jbinarize.binarize_ste(jnp.asarray(x))))


def test_init_distributions():
    p = xl.init(CFG, torch.Generator().manual_seed(0))
    assert tuple(p.tok_embed.shape) == (32, 32)
    for b in p.blocks:
        assert float(b.wq.w.abs().max()) <= 1.0
        assert torch.equal(b.w_up.bn_var, torch.ones(32))


# ------------------------------------------------------------------ parity
def test_fold_leaves_equal_reference():
    pt, pj = models()
    import jax
    jleaves = jax.tree_util.tree_leaves(pj)
    tleaves: list = []
    xl._flatten(pt, tleaves)
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        if isinstance(t, torch.Tensor):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        else:
            assert t == j


@pytest.mark.parametrize("mode", ["bw", "xnor"])
def test_agree_counts_exact_on_reference_inputs(mode):
    """Run the reference forward, keep each projection's ±1 input and
    its agree-counts; the port's ``_agree_counts`` on the same input is
    equal, projection by projection."""
    pt, pj = models()
    rng = np.random.default_rng(4)
    toks = jnp.asarray(rng.integers(0, CFG.vocab_size, (2, 7)), jnp.int32)
    seen = []
    jproj = jxl._make_proj_packed(mode, "mxu")

    def proj(pp, a_pm1, out):
        seen.append((np.array(a_pm1), np.asarray(jxl._agree_counts(
            pp, a_pm1, mode=mode, path="mxu"))))
        return jproj(pp, a_pm1, out)

    x = pj.tok_embed[toks] + pj.pos_embed[:7][None]
    for blk in pj.blocks:
        x = jxl._block(JCFG, blk, x, proj,
                       lambda q, k, v: jxl._attn_full(JCFG, q, k, v))
    names = ["wq", "wk", "wv", "wo", "w_up", "w_down"]
    assert len(seen) == len(names) * CFG.n_layers
    for i, (a, want) in enumerate(seen):
        pp = getattr(pt.blocks[i // 6], names[i % 6])
        got = xl._agree_counts(pp, torch.from_numpy(a), mode=mode,
                               path="mxu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_packed_matches_reference(seed):
    pt, pj = models(seed)
    rng = np.random.default_rng(5 + seed)
    toks = rng.integers(0, CFG.vocab_size, (3, 11))
    got = {m: xl.forward_packed(CFG, pt, torch.from_numpy(toks), mode=m)
           for m in ("bw", "xnor")}
    assert torch.equal(got["bw"], got["xnor"])            # bitwise
    for mode in ("bw", "xnor"):
        want = np.asarray(jxl.forward_packed(
            JCFG, pj, jnp.asarray(toks, jnp.int32), mode=mode))
        np.testing.assert_allclose(got[mode].numpy(), want, **TOL)
        np.testing.assert_array_equal(got[mode].numpy().argmax(-1),
                                      want.argmax(-1))


def test_decode_steps_match_reference():
    """Two slots at different depths over a prompt: logits, K/V caches
    and lengths step by step."""
    pt, pj = models()
    st = xl.init_serve_state(CFG, 2, 16)
    sj = jxl.init_serve_state(JCFG, 2, 16)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, CFG.vocab_size, (6, 2, 1))
    st.length[1] = 3                      # slot 1 starts deeper
    sj = sj._replace(length=sj.length.at[1].set(3))
    for t in toks:
        lt, st = xl.decode_step(CFG, pt, st, torch.from_numpy(t))
        lj, sj = jxl.decode_step(JCFG, pj, sj, jnp.asarray(t, jnp.int32))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        np.testing.assert_array_equal(lt.numpy().argmax(-1),
                                      np.asarray(lj).argmax(-1))
    np.testing.assert_array_equal(st.length.numpy(), np.asarray(sj.length))
    np.testing.assert_allclose(st.k_cache.numpy(), np.asarray(sj.k_cache),
                               **TOL)
    np.testing.assert_allclose(st.v_cache.numpy(), np.asarray(sj.v_cache),
                               **TOL)


@pytest.mark.parametrize("seed,mode", [(0, "bw"), (1, "xnor"), (2, "bw")])
def test_greedy_decode_equals_reference(seed, mode):
    pt, pj = models(seed)
    want = jxl.greedy_decode(JCFG, pj, PROMPT, 8, mode=mode)
    assert xl.greedy_decode(CFG, pt, PROMPT, 8, mode=mode) == want


def test_smoke_config_greedy_equals_reference():
    cfg = configs.get_config("xnor-lm-tiny", smoke=True)
    pt, pj = models(3, cfg)
    jcfg = jxl.XnorLMConfig(vocab_size=64, d_model=64, n_layers=2,
                            n_heads=2, d_ff=96, max_len=64)
    assert (xl.greedy_decode(cfg, pt, PROMPT, 6)
            == jxl.greedy_decode(jcfg, pj, PROMPT, 6))


# ------------------------------------------------------------------ engine
def test_engine_mixed_prompts_equal_solo_and_reference(ref_engine_out):
    pt, _ = models()
    eng, _ = xl.make_serving_engine(CFG, pt, n_slots=3, device="cpu")
    prompts = mixed_prompts()
    rids = [eng.submit(p, max_new_tokens=MIXED[1]) for p in prompts]
    out = eng.run()
    assert [out[r] for r in rids] == ref_engine_out
    for rid, p in zip(rids, prompts):
        assert out[rid] == xl.greedy_decode(CFG, pt, p, MIXED[1])


def test_engine_xnor_mode_and_plan(ref_engine_out):
    """``plan.lm_mode`` picks the decode GEMM; both modes serve the same
    tokens."""
    pt, _ = models()
    plan = xp.ExecutionPlan(path="xla", lm_mode="xnor")
    eng, model = xl.make_serving_engine(CFG, pt, n_slots=3, plan=plan,
                                        device="cpu")
    assert (model.mode, model.path) == ("xnor", "xla")
    rids = [eng.submit(p, max_new_tokens=MIXED[1]) for p in mixed_prompts()]
    out = eng.run()
    assert [out[r] for r in rids] == ref_engine_out


def test_hot_swap_in_place():
    pt, _ = models()
    pt2, _ = models(1)
    eng, model = xl.make_serving_engine(CFG, pt, n_slots=2, device="cpu")
    eng.submit(PROMPT, max_new_tokens=4)
    out1 = eng.run()
    ptrs = [t.data_ptr() for t in eng.params]
    eng.swap_params(model.swap_arrays(pt2))
    assert [t.data_ptr() for t in eng.params] == ptrs
    assert torch.equal(eng.params[0], pt2.tok_embed)
    # the engine owns its weights: the caller's packed net is untouched
    assert not torch.equal(pt.tok_embed, pt2.tok_embed)
    assert torch.equal(pt.tok_embed, torch.from_numpy(
        xl.numpy_params(CFG, 0).tok_embed))
    rid = eng.submit(PROMPT, max_new_tokens=4)
    out2 = eng.run()
    assert out2[rid] == xl.greedy_decode(CFG, pt2, PROMPT, 4)
    assert out2[rid] != next(iter(out1.values()))


def test_incompatible_swap_raises():
    pt, _ = models()
    other_cfg = dataclasses.replace(CFG, d_ff=64)
    other = xl.fold(other_cfg, xl.params_from_numpy(
        xl.numpy_params(other_cfg, 3)))
    with pytest.raises(ValueError):
        xl.assert_swap_compatible(pt, other)
    deeper_cfg = dataclasses.replace(CFG, n_layers=3)
    deeper = xl.fold(deeper_cfg, xl.params_from_numpy(
        xl.numpy_params(deeper_cfg, 3)))
    with pytest.raises(ValueError, match="structure"):
        xl.assert_swap_compatible(pt, deeper)
    eng, model = xl.make_serving_engine(CFG, pt, n_slots=2, device="cpu")
    with pytest.raises(ValueError):
        model.swap_arrays(other)
    bad = tuple(torch.zeros((2, 2)) for _ in model.arrays)
    with pytest.raises(ValueError, match="shape/dtype mismatch"):
        eng.swap_params(bad)
    with pytest.raises(ValueError, match="structure"):
        eng.swap_params(model.arrays[:-1])


def test_engine_rejects_overlong_prompt():
    pt, _ = models()
    eng, _ = xl.make_serving_engine(CFG, pt, n_slots=2, max_len=16,
                                    device="cpu")
    with pytest.raises(ValueError, match="prompt length"):
        eng.submit(list(range(15)), max_new_tokens=2)


def test_idle_slots_step_past_max_len():
    """One request at a time through 3 slots with a 16-position cache:
    the idle slots step on and their lengths pass 16. Their cache writes
    are dropped (an out-of-range index would raise on the CPU), and every
    request still equals its solo decode."""
    pt, _ = models()
    eng, _ = xl.make_serving_engine(CFG, pt, n_slots=3, max_len=16,
                                    device="cpu")
    for p in ([1, 2, 3, 4], [5, 6], [7, 8, 9]):
        rid = eng.submit(p, max_new_tokens=12)
        out = eng.run()[rid]
        assert out == xl.greedy_decode(CFG, pt, p, len(out), max_len=16)
    assert int(eng.state.length.max()) > 2 * 16
    assert eng.steps_executed > 16


# ------------------------------------------------------------------ tuner
class FakeTimer:
    """Counter clock: each call advances by 1 plus ``cost`` per plain
    matmul of the spied kind run since the last call."""

    def __init__(self):
        self.t, self.work = 0.0, 0

    def __call__(self):
        self.t += 1.0 + 50.0 * self.work
        self.work = 0
        return self.t


@pytest.mark.parametrize("slow", [None, "xnor", "bw"])
def test_autotune_lm_mode_fake_timer(monkeypatch, slow):
    """Equal intervals keep the default "bw"; a mode made slow by the
    fake clock loses, and the result repeats."""
    pt, _ = models()
    timer = FakeTimer()
    if slow is not None:
        name = ("xnor_matmul_ref" if slow == "xnor"
                else "binary_weight_matmul_ref")
        real = getattr(ref, name)

        def spy(*a, **kw):
            timer.work += 1
            return real(*a, **kw)
        monkeypatch.setattr(ref, name, spy)
    picks = []
    for _ in range(2):
        report = {}
        picks.append(at.autotune_lm_mode(CFG, pt, device="cpu", timer=timer,
                                         reps=3, warmup=0, report=report))
        assert report["equal"] and set(report["scores"]) == {"bw", "xnor"}
    assert picks[0] == picks[1] == ("xnor" if slow == "bw" else "bw")


# ------------------------------------------------------------------ CLI
def test_serve_cli_cpu_smoke_swap(capsys):
    assert serve.main(["--device", "cpu", "--smoke", "--swap", "--requests",
                       "4", "--max-new", "6"]) == 0
    out = capsys.readouterr().out
    assert "served 8/8 requests" in out and "hot-swap OK" in out
