"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one cell
of ``BENCHMARK.json`` per run of ``python3 tlrbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>``. See ``harness.py``."""
