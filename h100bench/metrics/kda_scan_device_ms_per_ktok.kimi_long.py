"""Device ms of the chunked delta rule alone (``kda.scan``: the chunks'
algebra and the state's pass from chunk to chunk) per 1,000 prompt
tokens prefilled in the traced slice."""
from h100bench import spans


def read(run):
    return spans.device_ms_per_ktok(run, ("kda.scan",))
