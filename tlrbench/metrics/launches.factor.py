"""Kernel launches in one profiled factorization."""

from tlrbench import readers


def read(record):
    return readers.launches(record)
