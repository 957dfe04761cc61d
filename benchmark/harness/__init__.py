"""The harness: finds a cell's configuration, traffic, limits and metric
readers by the names in ``BENCHMARK.json``, drives the port through its
timed window, traces a stretch of it on request, and decides ``correct``
against ``benchmark.reference``.

* ``spec``: ``BENCHMARK.json`` and the files it names;
* ``draws``: the batches' inputs, made on the card from the seed;
* ``program``: the port's timed entry (simulate → estimate → score);
* ``window``: the closed loop and its clock;
* ``trace``: a ``torch.profiler`` trace reduced to device operations
  attributed to the benchmark's spans;
* ``check``: the comparison with the reference;
* ``runner``: one run of one cell.
"""
