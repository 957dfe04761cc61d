"""The benchmark of the PyTorch/CUDA port ``ce5g_torch``: ``run.py`` runs
one cell of ``BENCHMARK.json`` and prints one JSON line (see ``harness``)."""
