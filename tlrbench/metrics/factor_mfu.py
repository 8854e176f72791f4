"""The factorizations' FLOPs by the frozen count of Algorithm 5, over their
seconds, as a share of the FP64 peak."""

from tlrbench import readers


def read(record):
    return readers.fp64_share(record)
