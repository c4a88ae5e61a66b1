"""setup_s: process start to the first timed request (import, the CUDA
context, the kernels' build or load, the weights made from the seed, one
warm-up request of every shape the mix serves)."""


def read(run):
    return run.setup_s
