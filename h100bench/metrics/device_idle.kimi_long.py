"""Share of the traced slice in which no kernel, copy or fill ran on the
card (the union of the profiler's device intervals)."""
from h100bench import readers


def read(run):
    return readers.idle_pct(run)
