"""The online step's share of the 1-bit peak: the ops of the images served
(``work/bcnn.py``, 1.234 GOP an image) over the summed engine-step time,
outside the traced slice."""
from h100bench import readers
from h100bench.work import bcnn, peaks


def read(run):
    r = run.record
    return readers.share_pct(r["images_out"] * bcnn.ops_per_image(),
                             r["step_s_out"], peaks.B1_OPS)
