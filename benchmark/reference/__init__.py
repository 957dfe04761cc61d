"""The plain reference that decides whether a run of the benchmark is correct.

Plain PyTorch, in float64 (``precision.REFERENCE``), written from the
published equations or as frozen copies of the port's plain paths where
the port defines the law (the pilot pattern's tie rule, the k-NN
interpolation, the time prior's rank). It imports nothing of the port and
nothing of the JAX package, and takes only the draws the benchmark made:
the pilot pattern, the channel, the priors and the Wiener system are
worked out again here. ``precision.CONTROL`` runs the same code a step
lower (float32, TF32 operands in every matmul): the control that a sound
limit has to fail.
"""
