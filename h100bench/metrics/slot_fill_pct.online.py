"""Share of the forward's slots that held a request, over the traced
slice's steps: the program's ``engine.slots_occupied`` counter over
``engine.steps`` times the engine's slots (the forward always runs all of
them). Inflated by the profiler: it slows the host loop, so a traced step
takes longer and finds more requests queued than an untraced one (PERF.md
§5 gives the untraced fill beside it)."""
from h100bench import spans


def read(run):
    steps = spans.counter(run, "engine.steps")
    return spans.ratio_pct(spans.counter(run, "engine.slots_occupied"),
                           steps and steps * run.record["forward_batch"])
