"""syncs_per_batch: synchronizing runtime calls (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize``, ``cudaMemcpy``
without ``Async``) inside the port's spans, a batch
(``harness.port_spans``)."""
from benchmark.harness import port_spans


def read(ctx):
    reading = port_spans.of(ctx)
    return None if reading is None else reading.syncs_per_batch
