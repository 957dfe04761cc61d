"""Evaluation studies of the port: the Phase-2 classical-estimator parity
study (``parity``)."""
