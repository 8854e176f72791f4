"""Mean seconds of PCG, host clock with a device sync at each end."""

from tlrbench import readers


def read(record):
    return readers.step_mean(record, "pcg_s")
