"""Weight hot-swap of the port's packed BCNN (``core/bcnn.py::
split_packed`` / ``assert_swap_compatible`` / ``PackedForward.swap``,
``serve/bcnn_engine.py::BCNNEngine.swap_packed``) against the JAX
reference, at full Table 2 width on the CPU, plus the pieces that make a
captured step countable and safe across threads (``kernels/
launch_count.py``, ``kernels/streams.py``, ``kernels/_build.py::load``).

Both sides get the same nets: numpy latent params from
``bcnn.numpy_params`` folded by each package, or the reference's net
loaded from its artifact. Tolerances: leaves and per-layer bits exact
(integer arithmetic); logits ``allclose(rtol=1e-5, atol=1e-5)`` with the
same argmax (the reference promises no more for float outputs); the
port's engine against its own ``forward_packed``: exact.

On the CPU the step stays eager, so ``cache_size`` counts the input
shapes seen; on the card it counts CUDA graphs (``chip_smoke.py`` phase
3 holds replays against eager launches, bit for bit).
"""
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bcnn as jbcnn
from repro.core import bcnn_artifact as jart
from repro.core import bconv as jbconv
from repro.core import blinear as jblinear
from repro_torch.core import bcnn, bcnn_artifact
from repro_torch.kernels import _build, launch_count, streams
from repro_torch.serve.bcnn_engine import BCNNEngine

N_SLOTS = 3


def jax_params(p) -> jbcnn.BCNNParams:
    """The port's numpy latent params as the reference's BCNNParams."""
    def conv(cls, q):
        return cls(*[jnp.asarray(getattr(q, f)) for f in cls._fields])
    return jbcnn.BCNNParams(
        conv1=conv(jbconv.FpConvParams, p.conv1),
        convs=tuple(conv(jbconv.BConvParams, q) for q in p.convs),
        fcs=tuple(conv(jblinear.BLinearParams, q) for q in p.fcs))


@pytest.fixture(scope="module")
def nets():
    """{seed: (reference net, port net)} for seeds 0 and 1."""
    out = {}
    for seed in (0, 1):
        npp = bcnn.numpy_params(seed)
        out[seed] = (jbcnn.fold_model(jax_params(npp)),
                     bcnn.fold_model(bcnn.params_from_numpy(npp)))
    return out


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).random(
        (N_SLOTS, 32, 32, 3)).astype(np.float32)


def _forward(packed, x):
    return bcnn.forward_packed(packed, torch.from_numpy(x),
                               path="xla").numpy()


# ------------------------------------------------------ split and validate
def test_split_packed_leaves_match_reference(nets, tmp_path):
    """On one artifact's net: the port's weight tensors in the
    reference's ``split_packed`` order, and a rebuild threads them back."""
    jpk = nets[0][0]
    jart.save_packed(str(tmp_path), jpk)
    tpk = bcnn_artifact.load_packed(str(tmp_path))
    jarrs, _ = jbcnn.split_packed(jpk)
    tarrs, rebuild = bcnn.split_packed(tpk)
    assert len(tarrs) == len(jarrs) == 36
    for i, (j, t) in enumerate(zip(jarrs, tarrs)):
        j = np.asarray(j)
        assert t.numpy().dtype == j.dtype and t.shape == j.shape, i
        np.testing.assert_array_equal(t.numpy(), j, err_msg=f"leaf {i}")
    again = rebuild(tarrs)
    assert again == tpk and bcnn.split_packed(again)[0] == tarrs


def _mutations(pk, lib):
    """(name, mutated net) pairs, built alike for both packages."""
    cat = jnp.concatenate if lib == "jax" else torch.cat
    f32 = ((lambda a: a.astype(jnp.float32)) if lib == "jax"
           else (lambda t: t.to(torch.float32)))
    conv0 = pk.convs[0]
    return {
        "static": pk._replace(fc3_k=pk.fc3_k + 1),
        "shape": pk._replace(fc3_w_words=cat([pk.fc3_w_words,
                                               pk.fc3_w_words])),
        "dtype": pk._replace(convs=(conv0._replace(
            w_words=f32(conv0.w_words)),) + tuple(pk.convs[1:])),
        "filter": pk._replace(convs=(conv0._replace(fh=5),)
                              + tuple(pk.convs[1:])),
        "structure": pk._replace(convs=tuple(pk.convs[:4])),
    }


@pytest.mark.parametrize("case", ["static", "shape", "dtype", "filter",
                                  "structure"])
def test_assert_swap_compatible_rejects_like_reference(nets, case):
    (jpk, tpk), (jpk_b, tpk_b) = nets[0], nets[1]
    with pytest.raises(ValueError) as ej:
        jbcnn.assert_swap_compatible(jpk, _mutations(jpk_b, "jax")[case])
    with pytest.raises(ValueError) as et:
        bcnn.assert_swap_compatible(tpk, _mutations(tpk_b, "torch")[case])
    # same leaf index and the same kind of mismatch
    head = {"static": "static mismatch", "shape": "shape/dtype mismatch",
            "dtype": "shape/dtype mismatch", "filter": "static mismatch",
            "structure": "packed tree structure differs"}[case]
    assert head in str(ej.value) and head in str(et.value)
    assert str(ej.value).split(":")[0] == str(et.value).split(":")[0]
    new = bcnn.assert_swap_compatible(tpk, tpk_b)
    assert new == bcnn.split_packed(tpk_b)[0]


# ------------------------------------------------------ PackedForward.swap
def test_swap_matches_reference_swap(nets, images):
    """Swap a to b on both sides: per-layer bits equal, logits allclose
    with equal argmax, and the port equal to a fresh fold of b."""
    (jpk, tpk), (jpk_b, tpk_b) = nets[0], nets[1]
    jfwd = jbcnn.make_packed_forward(jpk, path="xla")
    tfwd = bcnn.make_packed_forward(tpk, path="xla", device="cpu")
    x = jnp.asarray(images)
    jfwd(x)
    tfwd(torch.from_numpy(images))
    jfwd.swap(jpk_b)
    tfwd.swap(tpk_b)
    want = np.asarray(jfwd(x))
    got = tfwd(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    np.testing.assert_array_equal(got, _forward(tpk_b, images))
    hj, ht = x, torch.from_numpy(images)
    for idx in range(jbcnn.N_LAYERS - 1):
        hj = jbcnn.apply_packed_layer(jfwd.packed, idx, hj, path="xla")
        ht = bcnn.apply_packed_layer(tfwd.packed, idx, ht, path="xla")
        if idx:                         # CONV-1: see test_torch_bcnn.py
            np.testing.assert_array_equal(ht.numpy(), np.asarray(hj),
                                          err_msg=f"layer {idx}")
        hj = jnp.asarray(ht.numpy())     # feed both the same input
    assert jfwd.cache_size() == tfwd.cache_size() == 1


def test_swap_keeps_storage_and_leaves_callers_net(nets, images):
    _, tpk = nets[0]
    _, tpk_b = nets[1]
    before = [t.clone() for t in bcnn.split_packed(tpk)[0]]
    fwd = bcnn.make_packed_forward(tpk, path="xla", device="cpu")
    twin = bcnn.make_packed_forward(tpk, path="xla", device="cpu")
    mine = bcnn.split_packed(fwd.packed)[0]
    ptrs = [t.data_ptr() for t in mine]
    # owned copies: nothing shared with the caller or the other forward
    theirs = {t.data_ptr() for t in bcnn.split_packed(tpk)[0]}
    theirs |= {t.data_ptr() for t in bcnn.split_packed(twin.packed)[0]}
    assert not theirs & set(ptrs)
    fwd.swap(tpk_b)
    assert [t.data_ptr() for t in bcnn.split_packed(fwd.packed)[0]] == ptrs
    for old, now in zip(before, bcnn.split_packed(tpk)[0]):
        assert torch.equal(old, now)     # the caller's net is untouched
    for got, want in zip(mine, bcnn.split_packed(tpk_b)[0]):
        assert torch.equal(got, want)
    x = torch.from_numpy(images)
    np.testing.assert_array_equal(twin(x).numpy(), _forward(tpk, images))
    np.testing.assert_array_equal(fwd(x).numpy(), _forward(tpk_b, images))


def test_packed_forward_swap_direct(nets):
    """The reference's direct contract: swap then call gives the new
    net's logits, one cache entry per input shape, none per swap."""
    _, tpk = nets[0]
    _, tpk_b = nets[1]
    fwd = bcnn.make_packed_forward(tpk, path="xla", device="cpu")
    x = np.random.default_rng(2).random((2, 32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(fwd(torch.from_numpy(x)).numpy(),
                                  _forward(tpk, x))
    fwd.swap(tpk_b)
    np.testing.assert_array_equal(fwd(torch.from_numpy(x)).numpy(),
                                  _forward(tpk_b, x))
    assert fwd.cache_size() == 1
    fwd(torch.from_numpy(x[:1]))
    assert fwd.cache_size() == 2         # a new shape is a new entry
    fwd.close()
    assert fwd.cache_size() == 2
    with pytest.raises(RuntimeError, match="closed"):
        fwd(torch.from_numpy(x))
    with pytest.raises(RuntimeError, match="closed"):
        fwd.swap(tpk)


# ------------------------------------------------------ the engine's swap
def _occupancy_sweep(eng, images):
    """Drive occupancies 1..n_slots; returns {rid: logits} of the last."""
    out = {}
    for k in range(1, eng.n_slots + 1):
        rids = [eng.submit(img) for img in images[:k]]
        res = eng.run()
        out = {r: res[r] for r in rids}
    return out


def test_swap_under_live_occupancy_sweep(nets, images):
    _, tpk = nets[0]
    _, tpk_b = nets[1]
    eng = BCNNEngine.from_packed(tpk, n_slots=N_SLOTS, path="xla",
                                 device="cpu")
    out = _occupancy_sweep(eng, images)
    np.testing.assert_array_equal(np.stack([out[r] for r in sorted(out)]),
                                  _forward(tpk, images))
    assert eng.swap_packed(tpk_b) == {}  # no slot occupied between steps
    out = _occupancy_sweep(eng, images)
    np.testing.assert_array_equal(np.stack([out[r] for r in sorted(out)]),
                                  _forward(tpk_b, images))
    assert eng.step_cache_size == 1 and eng.forward.cache_size() == 1


def test_queued_requests_get_new_weights(nets, images):
    _, tpk = nets[0]
    _, tpk_b = nets[1]
    eng = BCNNEngine.from_packed(tpk, n_slots=N_SLOTS, path="xla",
                                 device="cpu")
    rid = eng.submit(images[0])          # queued, not admitted (no step yet)
    drained = eng.swap_packed(tpk_b)
    assert drained == {} and eng.sched.n_queued == 1
    np.testing.assert_array_equal(eng.run()[rid],
                                  _forward(tpk_b, images[:1])[0])


def test_incompatible_swap_rejected(nets):
    _, tpk = nets[0]
    _, tpk_b = nets[1]
    eng = BCNNEngine.from_packed(tpk, n_slots=2, path="xla", device="cpu")
    rid = eng.submit(np.zeros((32, 32, 3), np.float32))
    with pytest.raises(ValueError, match="static"):
        eng.swap_packed(tpk_b._replace(fc3_k=tpk_b.fc3_k + 1))
    with pytest.raises(ValueError, match="shape"):
        eng.swap_packed(tpk_b._replace(fc3_w_words=torch.cat(
            [tpk_b.fc3_w_words, tpk_b.fc3_w_words])))
    assert eng.sched.n_queued == 1 and eng.steps_executed == 0
    np.testing.assert_array_equal(
        eng.run()[rid], _forward(tpk, np.zeros((1, 32, 32, 3),
                                               np.float32))[0])


def test_opaque_forward_rejects_swap(nets):
    _, tpk_b = nets[1]
    eng = BCNNEngine(lambda x: x.sum(dim=(1, 2, 3))[:, None], n_slots=2,
                     input_shape=(4, 4, 1), device="cpu")
    with pytest.raises(TypeError, match="hot-swap"):
        eng.swap_packed(tpk_b)
    eng.warmup()
    eng.submit(np.ones((4, 4, 1), np.float32))
    eng.run()
    assert eng.step_cache_size == 1      # shapes seen by an opaque forward


def test_classify_batch_slot_route(nets, images):
    _, tpk = nets[0]
    eng = BCNNEngine.from_packed(tpk, n_slots=2, path="xla", device="cpu")
    empty = eng.classify_batch(np.zeros((0, 32, 32, 3), np.float32))
    assert empty.shape == (0, 10) and eng.steps_executed == 0
    got = eng.classify_batch(images)
    assert got.shape == (N_SLOTS, 10) and eng.steps_executed == 2
    rids = [eng.submit(img) for img in images]
    out = eng.run()
    np.testing.assert_array_equal(got, np.stack([out[r] for r in rids]))
    np.testing.assert_array_equal(got, _forward(tpk, images))
    with pytest.raises(ValueError, match="batch shape"):
        eng.classify_batch(images[:, :16])
    assert eng.step_cache_size == 1


# --------------------------------------------- counters, streams, the build
def test_launch_count_records_a_capture_and_adds_replays():
    def kernel():
        pass
    kernel.launches = 0
    launch_count.add(kernel)
    with launch_count.recording() as tally:
        launch_count.add(kernel)
        launch_count.add(kernel, n=2)
    assert kernel.launches == 1          # a capture launches nothing
    assert tally == {(kernel, "launches"): 3}
    for _ in range(4):                   # four replays
        launch_count.add_all(tally)
    assert kernel.launches == 13


def test_launch_count_threads_lose_nothing():
    """More threads than cores bump one counter under a short switch
    interval while one of them records a capture: no increment is lost,
    and only the recording thread's go to its tally."""
    def kernel():
        pass
    kernel.launches = 0
    n_threads, n_adds = 16, 2000
    tallies = []

    def work(record):
        if record:
            with launch_count.recording() as tally:
                for _ in range(n_adds):
                    launch_count.add(kernel)
            tallies.append(tally)
        else:
            for _ in range(n_adds):
                launch_count.add(kernel)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i == 0,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert kernel.launches == (n_threads - 1) * n_adds
    assert tallies == [{(kernel, "launches"): n_adds}]


class _FakeStream:
    """PyTorch's pool, as ``torch.cuda.Stream()`` hands it out: 32 ids
    per device, round robin."""
    drawn = 0

    def __init__(self, device=None):
        self.device_index = 0
        self.stream_id = _FakeStream.drawn % streams.POOL
        _FakeStream.drawn += 1


def test_streams_never_hand_out_a_held_stream(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(streams, "_HELD", set())
    held = [streams.acquire(torch.device("cuda")) for _ in range(streams.POOL)]
    assert len({s.stream_id for s in held}) == streams.POOL
    with pytest.raises(RuntimeError, match="held"):
        streams.acquire(torch.device("cuda"))
    streams.release(held[7])
    streams.release(held[7])             # idempotent
    assert streams.acquire(torch.device("cuda")).stream_id == 7


def test_build_load_runs_one_build_for_racing_threads(monkeypatch):
    inside, peak, calls = [0], [0], []

    def fake_load():
        inside[0] += 1
        peak[0] = max(peak[0], inside[0])
        time.sleep(0.01)
        calls.append(1)
        inside[0] -= 1
        return "lib"
    monkeypatch.setattr(_build, "_load", fake_load)
    threads = [threading.Thread(target=_build.load) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert peak[0] == 1 and len(calls) == 8
