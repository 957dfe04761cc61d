"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version and a launch counter: ``hpd_solve``, ``interp_fused``, ``interp``,
``nmse`` (the score's reduction), ``pilot_select`` (the scattered pilots),
``channel`` (the channel H and the received grid) and ``profile_gram`` (the
Wiener MMSE's pilot sums E and D). The sources are in ``ce5g_torch/csrc``;
``_build`` compiles them on first use."""
