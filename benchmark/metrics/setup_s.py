"""setup_s: from the process's start to the window's: imports, the CUDA
context, the kernels built or loaded, the port's tables and two warm
batches of the cell's shapes."""


def read(ctx):
    return ctx.setup_s
