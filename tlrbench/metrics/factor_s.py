"""Seconds per TLR Cholesky: the window's time over the whole
factorizations in it."""

from tlrbench import readers


def read(record):
    return readers.per_step_seconds(record)
