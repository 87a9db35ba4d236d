"""Kernel ms (copies left out) of one engine step, from the traced slice:
the captured BCNN forward at the engine's batch of slots."""
from h100bench import readers


def read(run):
    return readers.kernel_ms_per(run, "steps_in")
