"""The bulk route's share of the 1-bit peak: the ops of the images
classified outside the traced slice over the window's time outside it."""
from h100bench import readers
from h100bench.work import bcnn, peaks


def read(run):
    r = run.record
    return readers.share_pct(r["images_out"] * bcnn.ops_per_image(),
                             r["time_out"], peaks.B1_OPS)
