"""Device ms of the NoPE MLA layers' attention (``mla.attention``:
projections, the latents, K7 and the output projection, timed by the
span's device marks) per 1,000 prompt tokens prefilled in the traced
slice."""
from h100bench import spans


def read(run):
    return spans.device_ms_per_ktok(run, ("mla.attention",))
