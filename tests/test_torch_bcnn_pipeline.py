"""The port's stage-pipelined BCNN forward (``parallel/bcnn_pipeline.py``)
against its own ``forward_packed`` and against the reference's
``make_pipelined_forward``, at full Table 2 width on the CPU.

``tests/test_bcnn_pipeline.py`` case for case, on nets handed across as
numpy latents (``bcnn.numpy_params`` folded by each package):

* the stage plan, the schedule model and the boundary wire format equal
  the reference's exactly (pure Python / integer arithmetic);
* the pipelined logits are bitwise equal to the port's ``forward_packed``
  (each stage runs the same layers on the same bits), and
  ``allclose(rtol=1e-5, atol=1e-5)`` with the same argmax to the
  reference's pipelined forward — the bar of ``test_torch_bcnn.py``,
  since CONV-1 is the exact integer dot by design;
* every stage sees one shape (``cache_size`` 1) for any batch size and
  through the engine for any occupancy.

The reference's two-device case runs on simulated host devices in a
subprocess; here the stages run on a list that names the CPU twice
(co-resident stages, the only form the CPU has). On the card,
``chip_smoke.py``'s pipeline phase holds the captured stages bitwise
equal to ``PackedForward``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bcnn as jbcnn
from repro.core import bconv as jbconv
from repro.core import blinear as jblinear
from repro.parallel import bcnn_pipeline as jbp
from repro_torch.core import bcnn, bitpack
from repro_torch.parallel import bcnn_pipeline as bp
from repro_torch.serve.bcnn_engine import BCNNEngine

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
def images():
    return np.random.default_rng(0).random((5, 32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def ref_logits(nets, images):
    return bcnn.forward_packed(nets[1], torch.from_numpy(images),
                               path="xla").numpy()


def _pipelined(packed, n_stages, **kw):
    kw.setdefault("micro_batch", 2)
    return bp.make_pipelined_forward(packed, n_stages=n_stages,
                                     devices=[CPU], path="xla", **kw)


# ---------------------------------------------------------------- stage plan
def test_layer_costs_match_table2():
    costs = bp.layer_costs()
    assert len(costs) == bcnn.N_LAYERS
    assert costs[0] == 3538944.0          # Conv 1
    assert costs[5] == 150994944.0        # Conv 6
    assert costs[6] == 8192 * 1024        # FC 1
    assert costs[8] == 1024 * 10          # FC 3
    assert costs == jbp.layer_costs()
    assert bp.LAYER_NAMES == jbp.LAYER_NAMES
    assert bp._CONV_BOUNDS == jbp._CONV_BOUNDS


def test_plan_properties():
    total = sum(bp.layer_costs())
    prev_bottleneck = float("inf")
    for s in range(1, bcnn.N_LAYERS + 1):
        plan = bp.plan_bcnn_stages(s)
        assert plan.n_stages == s
        assert plan.bounds[0] == 0 and plan.bounds[-1] == bcnn.N_LAYERS
        assert all(a < b for a, b in zip(plan.bounds, plan.bounds[1:]))
        assert sum(plan.stage_costs) == total
        assert 0 < plan.balance <= 1.0
        assert plan.bottleneck <= prev_bottleneck
        prev_bottleneck = plan.bottleneck
        want = jbp.plan_bcnn_stages(s)
        assert tuple(plan) == tuple(want)
        assert (plan.bottleneck, plan.balance) == (want.bottleneck,
                                                   want.balance)
        assert [plan.stage_layers(i) for i in range(s)] == \
            [want.stage_layers(i) for i in range(s)]
    assert bp.plan_bcnn_stages(1).bounds == (0, bcnn.N_LAYERS)
    # the cuts that decide which kernels run on the card: 3 stages cut
    # both fused pairs (CONV-3|4, CONV-5|6), 2 keep both
    assert bp.plan_bcnn_stages(2).bounds == (0, 4, 9)
    assert bp.plan_bcnn_stages(3).bounds == (0, 3, 5, 9)
    assert bp.plan_bcnn_stages(4).bounds == (0, 2, 3, 5, 9)


def test_plan_beats_naive_even_split():
    costs = bp.layer_costs()
    plan = bp.plan_bcnn_stages(3)
    naive = max(sum(costs[0:3]), sum(costs[3:6]), sum(costs[6:9]))
    assert plan.bottleneck <= naive


def test_plan_rejects_bad_stage_counts():
    for s in (0, bcnn.N_LAYERS + 1):
        with pytest.raises(ValueError, match="n_stages"):
            bp.plan_bcnn_stages(s)


def test_schedule_stream_limits():
    plan = bp.plan_bcnn_stages(3)
    few = bp.schedule_stream(plan, n_micro=3)
    many = bp.schedule_stream(plan, n_micro=4096)
    assert 0 < few["bubble_fraction"] < 1
    assert many["bubble_fraction"] < 0.01          # eq. 12 limit
    assert many["steady_rate"] == pytest.approx(1.0 / plan.bottleneck)
    for s in (1, 2, 3, 9):
        for m in (1, 7, 64):
            assert bp.schedule_stream(bp.plan_bcnn_stages(s), m) == \
                jbp.schedule_stream(jbp.plan_bcnn_stages(s), m)


# ------------------------------------------------------- boundary repacking
def test_boundary_roundtrip_exact():
    rng = np.random.default_rng(1)
    for i, (h, w, c) in bp._CONV_BOUNDS.items():
        bits = rng.integers(0, 2, (2, h, w, c)).astype(np.int8)
        words = bp.pack_boundary(i, torch.from_numpy(bits))
        assert words.shape == (2, h, w, c // bitpack.PACK)
        assert words.dtype == torch.int32
        np.testing.assert_array_equal(
            words.numpy(), np.asarray(jbp.pack_boundary(i, jnp.asarray(bits))))
        np.testing.assert_array_equal(bp.unpack_boundary(i, words).numpy(),
                                      bits)
    img = torch.ones((2, 32, 32, 3))
    assert bp.pack_boundary(0, img) is img
    assert bp.unpack_boundary(9, img) is img
    assert bp.pad_rows(img, 2) is img
    padded = bp.pad_rows(img, 5)
    assert padded.shape == (5, 32, 32, 3) and not padded[2:].any()


# ----------------------------------------------------------------- parity
@pytest.mark.parametrize("n_stages", [1, 2, 3])
def test_parity_with_forward_packed(nets, images, ref_logits, n_stages):
    """Bitwise equal to forward_packed across stage counts, with a ragged
    tail (5 images, micro-batch 2) and a batch smaller than one
    micro-batch; allclose with the same argmax to the reference's
    pipelined forward; one shape per stage."""
    jpk, tpk = nets
    fwd = _pipelined(tpk, n_stages)
    got = fwd(torch.from_numpy(images)).numpy()
    np.testing.assert_array_equal(got, ref_logits)
    np.testing.assert_array_equal(fwd(torch.from_numpy(images[:1])).numpy(),
                                  ref_logits[:1])
    assert fwd.cache_size() == 1
    want = np.asarray(jbp.make_pipelined_forward(
        jpk, n_stages=n_stages, micro_batch=2, path="xla")(images))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


@pytest.mark.parametrize("n_stages", [2, 3])
def test_fused_stages_cut_pairs_like_reference(nets, images, ref_logits,
                                               n_stages):
    """Fusion within a stage, never across a cut: the port's per-stage
    groups are the reference's, and the logits stay bitwise equal."""
    jpk, tpk = nets
    fwd = _pipelined(tpk, n_stages, conv_fusion=True)
    jfwd = jbp.make_pipelined_forward(jpk, n_stages=n_stages, micro_batch=2,
                                      path="xla", conv_fusion=True)
    assert fwd.fused_groups() == jfwd.fused_groups()
    pairs = [g for stage in fwd.fused_groups() for g in stage if len(g) == 2]
    assert pairs == ([(2, 3), (4, 5)] if n_stages == 2 else [])
    np.testing.assert_array_equal(fwd(torch.from_numpy(images)).numpy(),
                                  ref_logits)


def test_single_device_stage_cycling(nets, images, ref_logits):
    """More stages than devices: placement cycles, results unchanged."""
    fwd = _pipelined(nets[1], 3)
    assert fwd.devices == (CPU, CPU, CPU) and fwd.device == CPU
    np.testing.assert_array_equal(fwd(torch.from_numpy(images)).numpy(),
                                  ref_logits)


def test_pipelined_forward_two_devices(nets, images, ref_logits):
    """The reference's two-device case on a list naming two devices:
    stage s on devices[s], one shape per stage, micro-batch 1."""
    fwd = bp.make_pipelined_forward(nets[1], n_stages=2, micro_batch=1,
                                    devices=["cpu", "cpu"], path="xla")
    assert len(fwd.devices) == 2
    np.testing.assert_array_equal(fwd(torch.from_numpy(images[:4])).numpy(),
                                  ref_logits[:4])
    assert fwd.cache_size() == 1


def test_empty_batch_and_stage_times(nets, images):
    fwd = _pipelined(nets[1], 3)
    out = fwd(torch.zeros((0, 32, 32, 3)))
    assert out.shape == (0, 10) and fwd.cache_size() == 0
    times = fwd.stage_times(torch.from_numpy(images), reps=1)
    assert len(times) == 3 and all(t > 0 for t in times)
    assert fwd.cache_size() == 1


def test_swap_and_close(nets, images):
    _, tpk = nets
    tpk_b = bcnn.fold_model(bcnn.params_from_numpy(bcnn.numpy_params(1)))
    fwd = _pipelined(tpk, 2)
    x = torch.from_numpy(images)
    fwd(x)
    fwd.swap(tpk_b)
    np.testing.assert_array_equal(
        fwd(x).numpy(), bcnn.forward_packed(tpk_b, x, path="xla").numpy())
    assert fwd.cache_size() == 1
    with pytest.raises(ValueError, match="static"):
        fwd.swap(tpk_b._replace(fc3_k=tpk_b.fc3_k + 1))
    fwd.close()
    assert fwd.cache_size() == 1
    with pytest.raises(RuntimeError, match="closed"):
        fwd(x)


def test_rejects_bad_arguments(nets):
    with pytest.raises(ValueError, match="micro_batch"):
        _pipelined(nets[1], 2, micro_batch=0)
    with pytest.raises(ValueError, match="n_stages"):
        _pipelined(nets[1], 0)


def test_devices_default_to_cuda_and_raise_without_it(nets):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: devices=None uses it")
    with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
        bp.make_pipelined_forward(nets[1], n_stages=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bp.make_pipelined_forward(nets[1], n_stages=2, devices=["cuda"])


# ----------------------------------------------------------------- engine
def test_engine_on_pipeline_zero_recompile(nets, images, ref_logits):
    """BCNNEngine stepping the pipelined forward: an occupancy sweep
    1..n_slots keeps every stage at one shape, and the logits equal the
    single-device forward bit for bit."""
    eng = BCNNEngine.from_packed(nets[1], n_slots=4, device="cpu",
                                 pipeline_stages=2, pipeline_micro_batch=1)
    assert isinstance(eng.forward, bp.PipelinedForward)
    for k in range(1, 5):
        rids = [eng.submit(images[i % len(images)]) for i in range(k)]
        out = eng.run()
        assert sorted(out) == sorted(rids)
    assert eng.step_cache_size == 1
    np.testing.assert_array_equal(out[rids[0]], ref_logits[0])
