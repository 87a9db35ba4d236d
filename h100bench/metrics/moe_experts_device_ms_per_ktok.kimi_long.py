"""Device ms of the experts (``moe.experts``: every held expert's SwiGLU
over its capacity buffer, and the shared expert) per 1,000 prompt tokens
prefilled in the traced slice."""
from h100bench import spans


def read(run):
    return spans.device_ms_per_ktok(run, ("moe.experts",))
