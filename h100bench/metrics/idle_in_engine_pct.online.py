"""Share of the traced slice's device-idle time (the gaps between its
device intervals) that falls inside an ``engine.step`` span; the rest is
the traffic loop's own work between steps."""
from h100bench import spans


def read(run):
    return spans.idle_inside_pct(run, "engine.step")
