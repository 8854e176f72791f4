"""Mean PCG iterations per solution."""

from tlrbench import readers


def read(record):
    return readers.step_mean(record, "pcg_iters")
