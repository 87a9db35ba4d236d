"""The port's data-parallel bulk forward (``parallel/bcnn_data_parallel.py``)
and ``BCNNEngine.classify_batch``'s bulk route against the port's own
``forward_packed`` and against the reference, at full Table 2 width on
the CPU.

``tests/test_bcnn_data_parallel.py`` case for case, on nets handed across
as numpy latents:

* the sharded logits are bitwise equal to ``forward_packed`` for every
  (batch, shards, stages) combination, ragged tails and batches smaller
  than one chunk included, and ``allclose(rtol=1e-5, atol=1e-5)`` with
  the same argmax to the reference's ``make_sharded_forward`` (the bar of
  ``test_torch_bcnn.py``: CONV-1 is the exact integer dot by design);
* one shape per shard or stage for every batch size (``cache_size`` 1);
* the engine routes as the reference's does — batches at or above
  ``batch_threshold`` to the bulk forward, smaller ones through the
  slots, the empty batch answered on the host — with bitwise equal
  logits on both routes and ``batch_cache_size`` 0 before first use.

A list of devices takes the place of the reference's mesh; its
multi-device case (simulated host devices in a subprocess) runs here on
lists naming the CPU several times.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bcnn as jbcnn
from repro.core import bconv as jbconv
from repro.core import blinear as jblinear
from repro.parallel.bcnn_data_parallel import \
    make_sharded_forward as j_make_sharded_forward
from repro.serve import BCNNEngine as JBCNNEngine
from repro_torch.core import bcnn
from repro_torch.parallel.bcnn_data_parallel import make_sharded_forward
from repro_torch.serve.bcnn_engine import BCNNEngine


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, module fixtures included: the test workers
    share the CPUs, and torch's default of one thread per CPU each
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = torch.device("cpu")


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
    npp = bcnn.numpy_params(0)
    return (jbcnn.fold_model(jax_params(npp)),
            bcnn.fold_model(bcnn.params_from_numpy(npp)))


@pytest.fixture(scope="module")
def packed(nets):
    return nets[1]


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).random((6, 32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def ref_logits(packed, images):
    return bcnn.forward_packed(packed, torch.from_numpy(images),
                               path="xla").numpy()


def _sharded(packed, shards=1, **kw):
    kw.setdefault("micro_batch", 2)
    kw.setdefault("devices", [CPU] * shards)
    return make_sharded_forward(packed, data_shards=shards, path="xla", **kw)


def _run(fwd, x):
    return fwd(torch.from_numpy(x)).numpy()


def _close_to_reference(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


# ----------------------------------------------------------------- parity
def test_parity_with_forward_packed(nets, images, ref_logits):
    """Bitwise at 1 shard across ragged batch sizes, one shape in all
    (5 images vs chunk 2: 3 chunks with a padded tail; 1 image: padded);
    allclose to the reference's sharded forward."""
    jpk, tpk = nets
    fwd = _sharded(tpk)
    assert fwd.plan.chunk == 2
    got = _run(fwd, images[:5])
    np.testing.assert_array_equal(got, ref_logits[:5])
    np.testing.assert_array_equal(_run(fwd, images[:1]), ref_logits[:1])
    np.testing.assert_array_equal(_run(fwd, images[:4]), ref_logits[:4])
    assert fwd.cache_size() == 1
    jfwd = j_make_sharded_forward(jpk, data_shards=1, micro_batch=2,
                                  path="xla")
    _close_to_reference(got, np.asarray(jfwd(images[:5])))


def test_empty_batch(packed):
    fwd = _sharded(packed)
    out = fwd(torch.zeros((0, 32, 32, 3)))
    assert out.shape == (0, 10) and out.dtype == torch.float32
    assert fwd.cache_size() == 0                      # nothing ran


def test_two_d_plan_single_device(nets, images, ref_logits):
    """data × stage with more grid cells than devices: the stage columns
    cycle placement, results unchanged, one shape per stage."""
    jpk, tpk = nets
    fwd = _sharded(tpk, n_stages=3)
    assert fwd.plan.n_stages == 3
    assert fwd.plan.stage_plan.n_stages == 3
    got = _run(fwd, images[:5])
    np.testing.assert_array_equal(got, ref_logits[:5])
    assert fwd.cache_size() == 1
    jfwd = j_make_sharded_forward(jpk, data_shards=1, micro_batch=2,
                                  n_stages=3, path="xla")
    _close_to_reference(got, np.asarray(jfwd(images[:5])))


@pytest.mark.parametrize("n_stages,fusion", [(1, False), (2, False),
                                             (2, True), (3, True)])
def test_plan_metadata_roundtrips(nets, n_stages, fusion):
    jpk, tpk = nets
    fwd = _sharded(tpk, micro_batch=4, n_stages=n_stages,
                   conv_fusion=fusion)
    meta = fwd.plan.describe()
    assert meta == json.loads(json.dumps(meta))       # JSON-clean
    assert meta["data_shards"] == 1 and meta["n_stages"] == n_stages
    assert meta["micro_batch"] == 4 and meta["chunk"] == 4
    assert meta["stage_bounds"][0] == 0
    assert meta["stage_bounds"][-1] == bcnn.N_LAYERS
    jfwd = j_make_sharded_forward(jpk, data_shards=1, micro_batch=4,
                                  n_stages=n_stages, path="xla",
                                  conv_fusion=fusion)
    assert meta == jfwd.plan.describe()


def test_rejects_bad_arguments(packed):
    with pytest.raises(ValueError, match="micro_batch"):
        _sharded(packed, micro_batch=0)
    with pytest.raises(ValueError, match="n_stages"):
        _sharded(packed, n_stages=0)
    with pytest.raises(ValueError, match="data_shards"):
        make_sharded_forward(packed, data_shards=0, devices=[CPU])
    with pytest.raises(ValueError, match="data mesh needs 2 devices, have 1"):
        make_sharded_forward(packed, data_shards=2, devices=[CPU])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
            make_sharded_forward(packed, data_shards=1)


def test_swap_and_close(packed, images):
    tpk_b = bcnn.fold_model(bcnn.params_from_numpy(bcnn.numpy_params(1)))
    want_b = bcnn.forward_packed(tpk_b, torch.from_numpy(images),
                                 path="xla").numpy()
    for fwd in (_sharded(packed, shards=2), _sharded(packed, shards=2,
                                                     n_stages=2)):
        _run(fwd, images)
        fwd.swap(tpk_b)
        np.testing.assert_array_equal(_run(fwd, images), want_b)
        assert fwd.cache_size() == 1
        fwd.close()
        assert fwd.cache_size() == 1
        with pytest.raises(RuntimeError, match="closed"):
            _run(fwd, images)


# ----------------------------------------------------------------- engine
def test_engine_routes_large_batches_to_sharded_forward(packed, images,
                                                        ref_logits):
    eng = BCNNEngine.from_packed(packed, n_slots=2, device="cpu",
                                 data_shards=1, data_micro_batch=2)
    assert eng.batch_forward is not None
    assert eng.batch_threshold == 2
    assert eng.batch_cache_size == 0                  # not yet used
    got = eng.classify_batch(images[:5])              # 5 >= threshold 2
    np.testing.assert_array_equal(got, ref_logits[:5])
    assert eng.batch_cache_size == 1                  # sharded path ran
    assert eng.steps_executed == 0                    # slots untouched


def test_engine_routes_small_batches_through_slots(packed, images,
                                                   ref_logits):
    eng = BCNNEngine.from_packed(packed, n_slots=2, device="cpu",
                                 data_shards=1, data_micro_batch=2,
                                 batch_threshold=4)
    got = eng.classify_batch(images[:3])              # 3 < threshold 4
    np.testing.assert_array_equal(got, ref_logits[:3])
    assert eng.steps_executed > 0                     # streamed via slots
    assert eng.batch_cache_size == 0                  # bulk path not used
    assert eng.step_cache_size == 1
    got = eng.classify_batch(images[:5])
    np.testing.assert_array_equal(got, ref_logits[:5])
    assert eng.batch_cache_size == 1


def test_engine_without_data_shards_still_classifies(packed, images,
                                                     ref_logits):
    eng = BCNNEngine.from_packed(packed, n_slots=2, device="cpu")
    assert eng.batch_forward is None and eng.batch_threshold == 0
    assert eng.batch_cache_size == 0
    got = eng.classify_batch(images[:5])
    np.testing.assert_array_equal(got, ref_logits[:5])
    assert eng.step_cache_size == 1


def test_engine_classify_batch_rejects_bad_shape(packed):
    eng = BCNNEngine.from_packed(packed, n_slots=2, device="cpu")
    with pytest.raises(ValueError, match="batch shape"):
        eng.classify_batch(np.zeros((2, 16, 16, 3), np.float32))


def test_classify_batch_empty_skips_device(packed):
    """tests/test_bcnn_engine.py's case: an empty batch is answered on
    the host on an engine with a bulk route; a real one afterwards runs
    it once."""
    eng = BCNNEngine.from_packed(packed, n_slots=2, device="cpu",
                                 data_shards=1, data_micro_batch=2)
    out = eng.classify_batch(np.zeros((0, 32, 32, 3), np.float32))
    assert out.shape == (0, 10) and out.dtype == np.float32
    assert eng.batch_cache_size == 0 and eng.steps_executed == 0
    got = eng.classify_batch(np.zeros((2, 32, 32, 3), np.float32))
    assert got.shape == (2, 10) and eng.batch_cache_size == 1


@pytest.mark.parametrize("kw,sizes", [
    (dict(data_shards=1, data_micro_batch=2), (1, 2, 5)),
    (dict(data_shards=1, data_micro_batch=2, batch_threshold=4), (3, 4)),
    (dict(data_shards=2, data_micro_batch=1), (1, 2, 3)),
    (dict(data_shards=1, data_micro_batch=2, pipeline_stages=2), (1, 3)),
])
def test_engine_routing_matches_reference(nets, images, kw, sizes):
    """Route by route, the port's engine and the reference's take the
    same path for each batch size (the threshold, slot steps and the
    bulk forward's captures agree) with allclose logits. The reference
    builds ``data_shards`` on its one CPU device only at 1 shard, so at
    2 shards the port is held to the reference's routing rule alone."""
    jpk, tpk = nets
    eng = BCNNEngine.from_packed(tpk, n_slots=2, device="cpu", **kw)
    jeng = (JBCNNEngine.from_packed(jpk, n_slots=2, path="xla", **kw)
            if kw["data_shards"] == 1 else None)
    chunk = kw["data_shards"] * kw["data_micro_batch"]
    assert eng.batch_threshold == kw.get("batch_threshold", chunk)
    used = False
    for n in sizes:
        steps = eng.steps_executed
        got = eng.classify_batch(images[:n])
        bulk = n >= eng.batch_threshold
        used = used or bulk
        assert (eng.steps_executed == steps) == bulk
        assert eng.batch_cache_size == int(used)
        if jeng is not None:
            jsteps = jeng.steps_executed
            want = jeng.classify_batch(images[:n])
            assert jeng.batch_threshold == eng.batch_threshold
            assert (jeng.steps_executed - jsteps
                    == eng.steps_executed - steps)
            assert jeng.batch_cache_size == eng.batch_cache_size
            _close_to_reference(got, want)
    assert eng.step_cache_size == 1


# ------------------------------------------------------------- multi-device
def test_sharded_forward_multi_device(packed, images, ref_logits):
    """Shards on lists of 2 and 4 devices and the 2×2 data × stage grid:
    bitwise parity, one shape per shard or stage."""
    for shards in (2, 4):
        fwd = _sharded(packed, shards=shards, micro_batch=1)
        assert fwd.data_shards == shards and len(fwd.devices) == shards
        np.testing.assert_array_equal(_run(fwd, images), ref_logits)
        np.testing.assert_array_equal(_run(fwd, images[:3]),
                                      ref_logits[:3])
        assert fwd.cache_size() == 1, (shards, fwd.cache_size())
    fwd = _sharded(packed, shards=2, n_stages=2, devices=[CPU] * 4)
    assert [len(col.devices) for col in fwd._shards] == [2, 2]
    np.testing.assert_array_equal(_run(fwd, images), ref_logits)
    assert fwd.cache_size() == 1
    # the shard count follows the devices passed
    sub = make_sharded_forward(packed, devices=[CPU] * 2, micro_batch=1,
                               path="xla")
    assert sub.data_shards == 2 and sub.plan.chunk == 2


@pytest.mark.parametrize("argv,expect", [
    (["--data-shards", "1", "--offline", "--requests", "16"],
     ["data-parallel bulk forward: 1 shard(s) × 1 stage(s), micro-batch 8",
      "via the bulk path", "batch_cache_size 1"]),
    (["--offline", "--requests", "4"],
     ["via the slot path", "step_cache_size 1, batch_cache_size 0"]),
    (["--pipeline-stages", "2", "--data-shards", "1",
      "--data-micro-batch", "2", "--offline", "--requests", "4"],
     ["pipelined forward: 2 stages", "stage 1: Conv 5 + Conv 6 + FC 1",
      "1 shard(s) × 2 stage(s)", "via the bulk path"]),
    (["--pipeline-stages", "3", "--requests", "4"],
     ["stage 2: Conv 6 + FC 1 + FC 2 + FC 3", "step_cache_size 1"]),
])
def test_serve_bcnn_cli_routes(capsys, argv, expect):
    """launch/serve_bcnn.py's new flags on the CPU: the plans printed as
    the reference prints them, and the route ``--offline`` took."""
    from repro_torch.launch import serve_bcnn
    assert serve_bcnn.main(["--device", "cpu"] + argv) == 0
    out = capsys.readouterr().out
    for line in expect:
        assert line in out, out
