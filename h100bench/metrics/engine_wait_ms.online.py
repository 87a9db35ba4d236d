"""Host ms a step blocked on the device (``engine.wait``: the copy of the
logits back, which waits for the step's forward), summed over the traced
slice's ``engine.step`` spans and divided by their number."""
from h100bench import spans


def read(run):
    return spans.host_ms_per(run, "engine.wait", "engine.step")
