"""Seconds per solution (preconditioner factorization and PCG): the
window's time over the whole solutions in it."""

from tlrbench import readers


def read(record):
    return readers.per_step_seconds(record)
