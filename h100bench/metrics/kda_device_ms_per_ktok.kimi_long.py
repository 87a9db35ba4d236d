"""Device ms of the KDA layers' mixers (``kda.proj``: projections, conv
and gates; ``kda.scan``: the chunked delta rule; ``kda.out``: norm, gate
and the output projection; each timed by its span's device marks) per
1,000 prompt tokens prefilled in the traced slice."""
from h100bench import spans


def read(run):
    return spans.device_ms_per_ktok(run, ("kda.proj", "kda.scan",
                                          "kda.out"))
