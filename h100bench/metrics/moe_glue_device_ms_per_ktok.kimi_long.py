"""Device ms of the MoE's glue (``moe.route``, ``moe.dispatch`` and
``moe.combine``: the sigmoid router over all experts, the sort and the
writes of the held pairs into the share's capacity buffer, the gated
gather and sum) per 1,000 prompt tokens prefilled in the traced slice."""
from h100bench import spans


def read(run):
    return spans.device_ms_per_ktok(
        run, ("moe.route", "moe.dispatch", "moe.combine"))
