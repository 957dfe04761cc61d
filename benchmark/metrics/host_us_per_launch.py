"""host_us_per_launch: the host's µs a device operation inside the port:
the host time inside the port's ``physics.simulate``,
``estimators.estimate`` and ``metrics.nmse`` spans, less the time in
synchronizing runtime calls there, over the device operations launched
inside them (``harness.port_spans``: a second traced stretch of the same
batches with the port's spans recording)."""
from benchmark.harness import port_spans


def read(ctx):
    reading = port_spans.of(ctx)
    return None if reading is None else reading.host_us_per_launch
