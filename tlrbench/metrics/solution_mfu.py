"""The solutions' FLOPs (Algorithm 5 for the preconditioner, then PCG's
iterations) over their seconds, as a share of the FP64 peak."""

from tlrbench import readers


def read(record):
    return readers.fp64_share(record)
