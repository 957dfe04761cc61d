"""dispatch_idle_ms: the ms a batch the card sat idle while the host was
inside one of the port's spans and not in a synchronizing runtime call,
each idle gap placed by its midpoint (``harness.port_spans``)."""
from benchmark.harness import port_spans


def read(ctx):
    reading = port_spans.of(ctx)
    return None if reading is None else reading.dispatch_idle_ms
