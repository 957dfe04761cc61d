"""One reader a metric: ``<name>.py`` defines ``read(ctx)``, which returns
the metric's value or None where it finds nothing to read (the harness
then leaves the metric out). ``ctx`` is ``harness.runner.Context``."""
