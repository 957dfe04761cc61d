"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version and a launch counter: ``hpd_solve`` and ``interp_fused``. The
sources are in ``ce5g_torch/csrc``; ``_build`` compiles them on first use."""
