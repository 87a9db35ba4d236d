"""Kernel ms (copies left out) per 1,000 prompt tokens prefilled in the
traced slice: the whole model step on the device."""
from h100bench import readers


def read(run):
    ms = readers.kernel_ms_per(run, "tokens_in")
    return None if ms is None else ms * 1e3
