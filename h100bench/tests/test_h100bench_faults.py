"""A run driven to its end with the timed path broken underneath, on the
CPU (the card check skipped; the port's plain path; small slots, batches
and the port's small DeepSeek preset): each fault a cell can have makes
``correct`` come out false, with the cell's own limits."""
import time

import numpy as np
import pytest
import torch

from h100bench import harness

SEED = 3 * 2 ** 31 + 1


def cpu_run(cell, **params):
    smoke = params.pop("smoke", False)
    run = harness.new_run(cell, SEED, 3.0, False, device="cpu")
    run.smoke = smoke
    run.workload["params"].update(params)
    return run


ONLINE = dict(n_slots=4, rate_hz=30.0, images=8)
BULK = dict(images=32, data_micro_batch=8)
LONG = dict(smoke=True, lengths=[24, 40], pool_rows=4)
BATCH = dict(smoke=True, lengths=[16], pool_rows=16, batch=4)


def test_sound_runs_are_correct():
    for cell, params in (("bcnn.online64", ONLINE), ("bcnn.bulk4096", BULK),
                         ("dsv2lite.prefill_long", LONG),
                         ("dsv2lite.prefill_batch", BATCH)):
        line = harness.measure(cpu_run(cell, **params), time.perf_counter())
        assert line["correct"], (cell, line["checks"])


def altered_step(monkeypatch):
    from repro_torch.serve.bcnn_engine import BCNNEngine
    step = BCNNEngine.step

    def bad(self):
        out = step(self)
        for rid in list(out)[:1]:
            out[rid] = out[rid] + np.float32(1e-3)
        return out
    monkeypatch.setattr(BCNNEngine, "step", bad)


def dropped_half_step(monkeypatch):
    from repro_torch.serve.bcnn_engine import BCNNEngine
    step = BCNNEngine.step

    def bad(self):
        out = step(self)
        return dict(list(out.items())[: (len(out) + 1) // 2])
    monkeypatch.setattr(BCNNEngine, "step", bad)


def altered_batch(monkeypatch):
    from repro_torch.serve.bcnn_engine import BCNNEngine
    classify = BCNNEngine.classify_batch

    def bad(self, images):
        out = classify(self, images).copy()
        out[-1, 0] += 1e-3
        return out
    monkeypatch.setattr(BCNNEngine, "classify_batch", bad)


def half_batch(monkeypatch):
    from repro_torch.serve.bcnn_engine import BCNNEngine
    classify = BCNNEngine.classify_batch

    def bad(self, images):
        return classify(self, images[: len(images) // 2])
    monkeypatch.setattr(BCNNEngine, "classify_batch", bad)


def altered_logits(monkeypatch):
    from repro_torch.models import transformer
    prefill = transformer.prefill

    def bad(cfg, params, tokens, frontend=None):
        out = prefill(cfg, params, tokens, frontend)
        return torch.roll(out, 1, dims=-1)
    monkeypatch.setattr(transformer, "prefill", bad)


def half_rows(monkeypatch):
    """Half of the batch left out: the other rows' logits stand in."""
    from repro_torch.models import transformer
    prefill = transformer.prefill

    def bad(cfg, params, tokens, frontend=None):
        half = prefill(cfg, params, tokens[: max(1, len(tokens) // 2)])
        return half.repeat(2, 1, 1)[: len(tokens)]
    monkeypatch.setattr(transformer, "prefill", bad)


@pytest.mark.parametrize("cell,params,fault", [
    ("bcnn.online64", ONLINE, altered_step),
    ("bcnn.online64", ONLINE, dropped_half_step),
    ("bcnn.bulk4096", BULK, altered_batch),
    ("bcnn.bulk4096", BULK, half_batch),
    ("dsv2lite.prefill_long", LONG, altered_logits),
    ("dsv2lite.prefill_batch", BATCH, altered_logits),
    ("dsv2lite.prefill_batch", BATCH, half_rows),
], ids=lambda x: getattr(x, "__name__", str(x) if isinstance(x, str)
                         else ""))
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, params,
                                            fault):
    run = cpu_run(cell, **params)
    driver = harness.load_module("drivers", run.workload["driver"])
    state = driver.setup(run)            # set up on the sound program
    fault(monkeypatch)
    line = harness.measure(run, time.perf_counter(),
                           driver=_prepared(driver, state))
    assert not line["correct"], line["checks"]


def _prepared(driver, state):
    """The driver with its set-up already made (the fault goes in after
    the warm-up, under the timed window)."""
    class D:
        setup = staticmethod(lambda run: state)
        drive = staticmethod(driver.drive)
        check = staticmethod(driver.check)
    return D
