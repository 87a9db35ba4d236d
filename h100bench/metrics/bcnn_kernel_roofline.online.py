"""K1-K5's share of their roofline in the online cell: the least time of
the eight binary layers at the engine's batch, at the 1-bit peak
(``work/bcnn.py``), times the steps of the slice, over the measured time of
every K1-K5 launch in it."""
from h100bench import readers
from h100bench.work import bcnn


def read(run):
    r = run.record
    bound = bcnn.binary_layer_bounds_s(r["forward_batch"]) * r["steps_in"]
    return readers.roofline_pct(run, readers.BCNN_KERNELS, bound)
