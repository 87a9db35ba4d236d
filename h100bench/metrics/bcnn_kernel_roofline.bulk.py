"""K1-K5's share of their roofline in the bulk cell: the least time of the
eight binary layers at the bulk route's chunk, once per chunk of every
batch of the slice, over the measured time of every K1-K5 launch in it."""
from h100bench import readers
from h100bench.work import bcnn


def read(run):
    r = run.record
    chunks = -(-r["batch"] // r["chunk"]) * r["batches_in"]
    bound = bcnn.binary_layer_bounds_s(r["chunk"]) * chunks
    return readers.roofline_pct(run, readers.BCNN_KERNELS, bound)
