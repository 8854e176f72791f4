"""Share of a profiled factorization's time with no operation on the device."""

from tlrbench import readers


def read(record):
    return readers.device_idle(record)
