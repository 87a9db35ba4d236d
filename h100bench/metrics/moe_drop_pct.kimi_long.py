"""Share of the held (token, choice) pairs dropped at the MoE's capacity
(1.25) in the traced slice: the program's ``moe.pairs_dropped`` counter
over ``moe.pairs_held`` (the pairs whose expert the share holds)."""
from h100bench import spans


def read(run):
    return spans.ratio_pct(spans.counter(run, "moe.pairs_dropped"),
                           spans.counter(run, "moe.pairs_held"))
