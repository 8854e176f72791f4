"""The benchmark's yardstick, in plain PyTorch and numpy.

Everything here is fixed once a benchmark cell exists: the generators
of the inputs (``problems/``, ``geometry.py``, ``compress.py``), the
reference that judges the program's answers (``reference.py``), the
operation and byte counts behind the utilization and roofline metrics
(``counts.py``) and the device's published peaks (``peaks.py``).

No module of this package imports the program under test: the reference
works out again whatever the program derived from the inputs.
"""
