"""Evaluation of the port: the Phase-2 classical-estimator parity study
(``parity``) and the test-split evaluation of the classical and neural
estimators (``evaluate``)."""
