"""wiener_gram_ms: device time a batch of the operations launched inside
the port's ``mmse_full.gram`` span (E, D, the float64 gram, σ² and the
right-hand side of the Wiener system), in ms (``harness.port_spans``)."""
from benchmark.harness import port_spans


def read(ctx):
    reading = port_spans.of(ctx)
    if reading is None:
        return None
    return reading.device_ms_under.get("mmse_full.gram")
