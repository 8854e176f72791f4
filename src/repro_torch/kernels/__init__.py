"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``ops`` dispatches by tensor device; ``build`` compiles ``csrc/*.cu`` with
nvcc on first use and loads them with ctypes.
"""
