"""Kernel ms (copies left out) of one bulk batch, from the traced slice."""
from h100bench import readers


def read(run):
    return readers.kernel_ms_per(run, "batches_in")
