"""host_rebuilds_per_batch: host work a steady batch should not repeat,
a batch: the port's counters ``time_rank.computed`` (the time rank's QR
loop), ``tables.built`` (device tables built from a profile table) and
``kernels.loaded`` (CUDA libraries loaded or built), summed over the
second traced stretch of ``harness.port_spans``."""
from benchmark.harness import port_spans


def read(ctx):
    reading = port_spans.of(ctx)
    return None if reading is None else reading.host_rebuilds_per_batch
