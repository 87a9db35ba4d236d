"""95th percentile of the wait from a request's due time to its admission
into a slot (``serve/slots.py``'s ``t_admit`` stamp), over the requests
answered outside the traced slice."""


def read(run):
    return run.record.get("queue_wait_p95_ms")
