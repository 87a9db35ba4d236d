"""The port's slot engine and serving CLI on ``device="cpu"`` (the plain
PyTorch path), at full Table 2 width: every request completes, in FIFO
order, with the logits of ``core/bcnn.py::forward_packed`` on the same
images — exactly, since every layer is integer arithmetic or the same
float32 op sequence whatever the batch composition."""
import numpy as np
import pytest
import torch

from repro_torch.core import bcnn
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.launch import serve_bcnn
from repro_torch.serve.bcnn_engine import BCNNEngine, drive_poisson


@pytest.fixture(scope="module")
def packed():
    return bcnn.fold_model(bcnn.params_from_numpy(bcnn.numpy_params(1)))


@pytest.fixture(scope="module")
def images():
    x, _ = SyntheticImages(global_batch=6, seed=1).batch(0)
    return x


def test_engine_serves_in_order_with_forward_logits(packed, images):
    eng = BCNNEngine.from_packed(packed, n_slots=4, device="cpu")
    assert eng.plan.path == "xla" and eng.device.type == "cpu"
    rids = [eng.submit(img) for img in images]
    out = eng.run()
    assert sorted(out) == rids
    assert eng.steps_executed == 2                  # 6 requests, 4 slots
    assert [r.rid for r in eng.sched.finished] == rids
    want = bcnn.forward_packed(packed, torch.from_numpy(images),
                               path="xla").numpy()
    got = np.stack([out[r] for r in rids])
    np.testing.assert_array_equal(got, want)
    st = eng.stats()
    assert st["n"] == 6 and st["p50"] > 0


def test_engine_rejects_wrong_image_shape(packed):
    eng = BCNNEngine.from_packed(packed, n_slots=2, device="cpu")
    with pytest.raises(ValueError, match="image shape"):
        eng.submit(np.zeros((28, 28, 3), np.float32))


def test_drive_poisson_serves_everything(packed, images):
    eng = BCNNEngine.from_packed(packed, n_slots=2, device="cpu",
                                 path="vpu")
    d = drive_poisson(eng, images[:4], rate_hz=1000.0, seed=3)
    assert len(d["results"]) == 4
    assert d["stats"]["n"] == 4 and d["offered_hz"] == 1000.0
    want = bcnn.forward_packed(packed, torch.from_numpy(images[:4])).numpy()
    got = np.stack([d["results"][r] for r in sorted(d["results"])])
    np.testing.assert_array_equal(got, want)


def test_make_packed_forward_on_cpu(packed, images):
    fwd = bcnn.make_packed_forward(packed, device="cpu", path="mxu")
    assert fwd.plan.path == "mxu"
    np.testing.assert_array_equal(
        fwd(torch.from_numpy(images[:2])).numpy(),
        bcnn.forward_packed(packed, torch.from_numpy(images[:2])).numpy())


def test_serve_cli_on_cpu(capsys):
    assert serve_bcnn.main(["--device", "cpu", "--requests", "3",
                            "--slots", "2"]) == 0
    out = capsys.readouterr().out
    assert "served 3/3 requests" in out and "engine on cpu" in out
