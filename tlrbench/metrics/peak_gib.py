"""The window's peak of device memory allocated (GiB), reset after
set-up."""


def read(record):
    peak = record["peak_bytes"]
    return None if peak is None else peak / 2**30
