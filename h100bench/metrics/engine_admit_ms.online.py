"""Host ms of the engine's admission a step (``engine.admit``: the
scheduler's FIFO admission and the host slot fills), summed over the
traced slice's ``engine.step`` spans and divided by their number.
Inflated by the profiler, which records each slot fill's ``select`` and
``copy_`` as host operations: the untraced admission is shorter."""
from h100bench import spans


def read(run):
    return spans.host_ms_per(run, "engine.admit", "engine.step")
