"""Device ms of the host-device copies (the images in, the logits out) of
one bulk batch, from the traced slice."""
from h100bench import readers


def read(run):
    return readers.copy_ms_per(run, "batches_in")
