"""Mean seconds of the preconditioner's shift and factorization, host clock
with a device sync at each end."""

from tlrbench import readers


def read(record):
    return readers.step_mean(record, "precond_s")
