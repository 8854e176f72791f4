"""The sampling kernels' roofline seconds at their live ranks over their
device seconds, in a profiled solution."""

from tlrbench import readers


def read(record):
    return readers.sampling_roofline(record)
