"""The port's restartable BCNN trainer (``train/bcnn_train.py``) and its
CLI (``launch/train_bcnn.py``) on the CPU, at full Table 2 width: the
reference's trainer tests (``tests/test_bcnn_train.py``), checkpoints that
cross between the packages in both directions, and the trained artifact
served by the port and read by the reference.

Tolerances:

* resume: bitwise (the whole state and every overlapping loss);
* a checkpoint written by one package and restored by the other: bitwise;
* the third step taken from it by each package (``assert_step_close``):
  loss at rtol 1e-5; every gradient leaf, Adam moment and running
  statistic within relative L2 1e-4 (float sums in another order); a
  weight or BN affine may differ by more than 1e-6 (at most 2·lr) only
  where the two gradients differ in sign or both lie below 1e-6. Adam's
  u = m̂ / (sqrt(v̂) + eps) is ±1 wherever a leaf's gradients are far
  from 0, and a gradient within the two sides' rounding gap of 0 (BN's
  mean subtraction makes some exactly 0 in exact arithmetic) may take
  the other sign;
* evaluate: top-1 agreement ≥ ``MIN_FOLD_AGREEMENT`` (0.97), the
  reference's gate; the served artifact: top-1 equal to ``forward_eval``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bcnn as jbcnn
from repro.core import bcnn_artifact as jart
from repro.train import bcnn_train as jbt
from repro.train import checkpoint as jck
from repro_torch.core import bcnn, bcnn_artifact
from repro_torch.data.pipeline import SyntheticImages
from repro_torch.launch import serve_bcnn, train_bcnn
from repro_torch.serve.bcnn_engine import BCNNEngine
from repro_torch.train import bcnn_train
from repro_torch.train import checkpoint as ck
from repro_torch.train import tree


DEFAULT_THREADS = torch.get_num_threads()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, module fixtures included: the test workers
    share the CPUs, and torch's default of one thread per CPU each
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def default_torch_threads():
    """torch's default intra-op thread count for one test. The state two
    train steps reach depends on the sum order the thread count sets; at
    one thread, 2 of CONV-6's 65,536 BN outputs on the cross-package
    step's batch land on the STE's |z| = 1 clip boundary, one ulp from the
    reference's, and the two gradients then differ by 1% (a discontinuity,
    as a sign at z = 0 is), beyond what that step check allows."""
    torch.set_num_threads(DEFAULT_THREADS)
    yield
    torch.set_num_threads(1)


STEPS, BATCH = 4, 16
CROSS_BATCH = 8
LR = 2e-3


def assert_states_equal(a, b):
    la, lb = tree.leaves_with_path(a), tree.leaves_with_path(b)
    assert len(la) == len(lb) == 136
    for (k, x), (_, y) in zip(la, lb):
        assert torch.equal(x, y), k


@pytest.fixture(scope="module")
def straight_run():
    return bcnn_train.train(steps=STEPS, batch=BATCH, verbose=False,
                            device="cpu")


def test_loss_decreases():
    """The trainer learns: over 32 steps at batch 16 the mean loss of the
    last 8 is below that of the first 8. Over 4 steps neither package's
    loss reliably falls (at seed 0 the port's goes 2.39 → 2.98 and the
    reference's 2.89 → 2.67; their inits differ, as torch and
    ``jax.random`` are different streams), so the window is longer than
    the reference test's."""
    _, info = bcnn_train.train(steps=32, batch=BATCH, verbose=False,
                               device="cpu")
    losses = [info["losses"][s] for s in range(32)]
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-8:]) < np.mean(losses[:8])


def test_straight_run_records_every_step(straight_run):
    _, info = straight_run
    assert sorted(info["losses"]) == list(range(STEPS))
    assert info["start_step"] == 0


def test_latent_weights_stay_clipped(straight_run):
    state, _ = straight_run
    for p in (state.params.conv1, *state.params.convs, *state.params.fcs):
        assert float(p.w.min()) >= -1.0 and float(p.w.max()) <= 1.0
    assert int(state.opt.step) == STEPS
    assert state.opt.step.dtype == torch.int32


def test_train_state_checkpoint_roundtrip(tmp_path, straight_run):
    state, _ = straight_run
    ck.save(str(tmp_path), STEPS, state)
    got, step = ck.restore(str(tmp_path), state)
    assert step == STEPS and int(got.opt.step) == STEPS
    assert_states_equal(state, got)


@pytest.fixture(scope="module")
def resumed_run(tmp_path_factory):
    """Killed after step 2 of 4 (checkpoint at 2), resumed to the end."""
    ckdir = str(tmp_path_factory.mktemp("bcnn_ck"))
    with pytest.raises(bcnn_train.SimulatedCrash):
        bcnn_train.train(steps=STEPS, batch=BATCH, ckpt_dir=ckdir,
                         ckpt_every=2, crash_at=2, verbose=False,
                         device="cpu")
    assert ck.latest_step(ckdir) == 2
    state, info = bcnn_train.train(steps=STEPS, batch=BATCH, ckpt_dir=ckdir,
                                   ckpt_every=2, resume=True, verbose=False,
                                   device="cpu")
    return state, info, ckdir


def test_resume_is_bit_exact(resumed_run, straight_run):
    ref_state, ref_info = straight_run
    state, info, ckdir = resumed_run
    assert info["start_step"] == 2
    assert_states_equal(ref_state, state)
    for s in range(2, STEPS):
        assert info["losses"][s] == ref_info["losses"][s]
    # the resumed run saved step 4; saving it again is the same-step
    # re-save path
    assert ck.latest_step(ckdir) == 4
    ck.save(ckdir, 4, state)
    got, _ = ck.restore(ckdir, state, step=4)
    assert_states_equal(state, got)


def test_exact_numerics_restores_settings():
    before = (torch.backends.cudnn.allow_tf32,
              torch.are_deterministic_algorithms_enabled())
    with bcnn_train.exact_numerics():
        assert torch.are_deterministic_algorithms_enabled()
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32,
            torch.are_deterministic_algorithms_enabled()) == before


def test_lifecycle_end_to_end(tmp_path, resumed_run):
    """train → checkpoint → kill/resume → export → the port's engine
    serves the artifact: slot and batch top-1 equal the training-graph
    oracle's (``forward_eval``)."""
    state, _, _ = resumed_run
    art = str(tmp_path / "art")
    bcnn_artifact.save_packed(art, bcnn.fold_model(state.params),
                              provenance={"steps": STEPS})
    x = np.random.default_rng(3).random((6, 32, 32, 3)).astype(np.float32)
    oracle = bcnn.forward_eval(state.params, torch.tensor(x)).argmax(-1)
    eng = BCNNEngine.from_packed(bcnn_artifact.load_packed(art), n_slots=2,
                                 device="cpu")
    rids = [eng.submit(img) for img in x]
    out = eng.run()
    slot_top1 = np.argmax(np.stack([out[r] for r in rids]), -1)
    np.testing.assert_array_equal(slot_top1, oracle.numpy())
    np.testing.assert_array_equal(np.argmax(eng.classify_batch(x), -1),
                                  oracle.numpy())
    assert eng.step_cache_size == 1


def test_evaluate_agreement(straight_run):
    state, _ = straight_run
    ev = bcnn_train.evaluate(state.params, batch=16, n_batches=2)
    assert ev["n"] == 32 and ev["agree"] >= bcnn_train.MIN_FOLD_AGREEMENT
    bcnn_train.report_eval(ev)
    with pytest.raises(RuntimeError, match="diverged"):
        bcnn_train.report_eval(dict(ev, agree=0.5))


# ------------------------------------------- checkpoints across packages
def jax_grads(jparams, x, y):
    return jax.grad(lambda p: jbcnn.loss_fn(p, x, y)[0])(jparams)


def port_step(state, x, y):
    """(next state, loss, gradients by leaf path) of the port's step."""
    p = tree.tree_map(lambda t: t.detach().requires_grad_(), state.params)
    loss, _ = bcnn.loss_fn(p, torch.tensor(x), torch.tensor(y))
    grads = torch.autograd.grad(loss, tree.tree_leaves(p), allow_unused=True)
    keys = [k for k, _ in tree.leaves_with_path(p)]
    step = bcnn_train.make_train_step(bcnn_train.make_adamw(LR))
    new, _ = step(state, torch.tensor(x), torch.tensor(y))
    return new, loss.item(), {
        "params/" + k: g for k, g in zip(keys, grads) if g is not None}


def assert_step_close(port_state, port_loss, port_grads, jax_state,
                      jax_loss, jax_grads_):
    np.testing.assert_allclose(port_loss, float(jax_loss), rtol=1e-5)
    jg = dict(("params/" + k, g) for k, g in jck._flatten(jax_grads_).items())
    for key, g in port_grads.items():
        w = np.asarray(jg[key])
        assert np.linalg.norm(g.numpy() - w) <= 1e-4 * np.linalg.norm(w), key
    jleaves = jck._flatten(jax_state)
    for key, got in tree.leaves_with_path(port_state):
        got, want = got.numpy(), np.asarray(jleaves[key])
        if key == "opt/step":
            assert int(got) == int(want)
        elif key.startswith("opt/") or key.endswith(("bn_mean", "bn_var")):
            gap = np.linalg.norm(got - want)
            assert gap <= 1e-4 * np.linalg.norm(want) + 1e-12, key
        else:
            ga = port_grads[key].numpy()
            gb = np.asarray(jg[key])
            diff = np.abs(got - want)
            moved = diff > 1e-6
            free = (np.sign(ga) != np.sign(gb)) | (
                np.maximum(np.abs(ga), np.abs(gb)) < 1e-6)
            assert not (moved & ~free).any(), key
            assert diff.max() <= 2 * LR + 1e-6, key


def _third_batch():
    return SyntheticImages(global_batch=CROSS_BATCH, seed=0).batch(2)


def test_jax_checkpoint_continued_by_port(tmp_path):
    d = str(tmp_path)
    jstate2, _ = jbt.train(steps=2, batch=CROSS_BATCH, ckpt_dir=d,
                           ckpt_every=2, verbose=False)
    template = bcnn_train.init_state(torch.Generator().manual_seed(0),
                                     bcnn_train.make_adamw(LR))
    state2, step = ck.restore(d, template)
    assert step == 2
    jleaves = jck._flatten(jstate2)
    for key, leaf in tree.leaves_with_path(state2):
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaves[key]))
    x, y = _third_batch()
    state3, loss, grads = port_step(state2, x, y)
    jstep = jbt.make_train_step(jbt.make_adamw(LR))
    jstate3, jm = jstep(jstate2, jnp.asarray(x), jnp.asarray(y))
    assert int(state3.opt.step) == 3
    assert_step_close(state3, loss, grads, jstate3, jm["loss"],
                      jax_grads(jstate2.params, jnp.asarray(x),
                                jnp.asarray(y)))


def test_port_checkpoint_continued_by_jax(tmp_path, default_torch_threads):
    d = str(tmp_path)
    state2, _ = bcnn_train.train(steps=2, batch=CROSS_BATCH, ckpt_dir=d,
                                 ckpt_every=2, verbose=False, device="cpu")
    jtemplate = jax.eval_shape(lambda: jbt.init_state(
        jax.random.PRNGKey(0), jbt.make_adamw(LR)))
    jstate2, step = jck.restore(d, jtemplate)
    assert step == 2
    jleaves = jck._flatten(jstate2)
    for key, leaf in tree.leaves_with_path(state2):
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaves[key]))
    x, y = _third_batch()
    jstep = jbt.make_train_step(jbt.make_adamw(LR))
    jstate3, jm = jstep(jstate2, jnp.asarray(x), jnp.asarray(y))
    state3, loss, grads = port_step(state2, x, y)
    assert int(jstate3.opt.step) == 3
    assert_step_close(state3, loss, grads, jstate3, jm["loss"],
                      jax_grads(jstate2.params, jnp.asarray(x),
                                jnp.asarray(y)))


# ------------------------------------------------------------------ the CLI
def test_cli_crash_resume_export_and_serve(tmp_path, capsys):
    """``launch/train_bcnn.py --device cpu``: crash after step 2, resume
    to step 4 and export — the artifact equals a straight run's leaf for
    leaf, the port's ``serve_bcnn --artifact`` serves it and the
    reference's ``load_packed`` reads it."""
    common = ["--device", "cpu", "--steps", "4", "--batch", "8",
              "--eval-batches", "1", "--log-every", "1"]
    ckdir, art, art2 = (str(tmp_path / n) for n in ("ck", "art", "art2"))
    with pytest.raises(SystemExit, match="crash-at"):
        train_bcnn.main(common + ["--ckpt-dir", ckdir, "--ckpt-every", "2",
                                  "--crash-at", "2"])
    assert train_bcnn.main(common + ["--ckpt-dir", ckdir, "--ckpt-every",
                                     "2", "--resume", "--export-artifact",
                                     art]) == 0
    out = capsys.readouterr().out
    assert "[resume] restored step 2" in out and "top-1 agreement" in out
    assert train_bcnn.main(common + ["--export-artifact", art2]) == 0
    resumed = dict(bcnn_artifact.walk(bcnn_artifact.load_packed(art)))
    straight = dict(bcnn_artifact.walk(bcnn_artifact.load_packed(art2)))
    assert list(resumed) == list(straight)
    for key, leaf in resumed.items():
        if isinstance(leaf, torch.Tensor):
            assert torch.equal(leaf, straight[key]), key
        else:
            assert leaf == straight[key], key
    jloaded = dict(jart._walk(jart.load_packed(art)))
    assert list(jloaded) == list(resumed)
    for key, leaf in resumed.items():
        if isinstance(leaf, torch.Tensor):
            np.testing.assert_array_equal(np.asarray(jloaded[key]),
                                          leaf.numpy(), err_msg=key)
    manifest = bcnn_artifact.load_manifest(art)
    assert manifest["provenance"]["steps"] == 4
    assert manifest["provenance"]["device"] == "cpu"
    assert serve_bcnn.main(["--device", "cpu", "--artifact", art,
                            "--requests", "4"]) == 0
    assert "served 4/4" in capsys.readouterr().out


def test_cuda_default_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the trainer runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_bcnn.main(["--steps", "1", "--batch", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bcnn_train.train(steps=1, batch=2, verbose=False)
