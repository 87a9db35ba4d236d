"""The controls of the correctness checks: the plain reference computed in
the precision below the configuration's, put in the program's place, must
come out not correct. On the CPU at sizes a test run holds; on the card
(``card`` marker) at each cell's own size, a short window, three seeds."""
import time

import pytest
import torch

from h100bench import harness

CELLS = ("bcnn.online64", "bcnn.bulk4096", "dsv2lite.prefill_long",
         "dsv2lite.prefill_batch")
SMALL = {"bcnn.online64": dict(n_slots=4, rate_hz=30.0, images=8),
         "bcnn.bulk4096": dict(images=32, data_micro_batch=8),
         "dsv2lite.prefill_long": dict(lengths=[24, 40], pool_rows=4),
         "dsv2lite.prefill_batch": dict(lengths=[16], pool_rows=16,
                                        batch=4)}


def readings(run):
    driver = harness.load_module("drivers", run.workload["driver"])
    state = driver.setup(run)
    record = driver.drive(run, state)
    limits = run.params["limits"]
    program = driver.check(run, state, record)
    control = driver.check(run, state, record, control=True)
    return limits, program, control


def fails(limits, numbers):
    return any(numbers[k] > limits[k] for k in limits)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_cpu(cell):
    run = harness.new_run(cell, 2 ** 35 + 3, 3.0, False, device="cpu")
    run.smoke = cell.startswith("dsv2lite")
    run.workload["params"].update(SMALL[cell])
    if run.smoke:
        # the port's small preset, run in float32 (at its few experts a
        # bf16 routing near-tie at the last token moves the logits by
        # tens of percent): the float8 control has to read far above it
        run.config["torch_dtype"] = "float32"
    limits, program, control = readings(run)
    assert not fails(limits, program), program
    if run.smoke:
        k = "logit_rel_err_median"
        assert control[k] > 100 * program[k], (program, control)
    else:
        assert fails(limits, control), control


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2 ** 33 + 17, 2 ** 34 + 29, 2 ** 35 + 41])
def test_control_fails_at_the_cells_size(card, cell, seed):
    t0 = time.perf_counter()
    run = harness.new_run(cell, seed, 3.0, False)
    limits, program, control = readings(run)
    assert not fails(limits, program), program
    assert fails(limits, control), control
    del run
    torch.cuda.empty_cache()
    assert time.perf_counter() - t0 < 900
