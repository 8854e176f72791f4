"""Seconds of set-up: imports, kernel libraries (built on a checkout's
first run), the inputs and the warm-up."""

from tlrbench import readers


def read(record):
    return record["setup_s"]
