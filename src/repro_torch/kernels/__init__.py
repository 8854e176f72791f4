"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Five kernels, one per Pallas TPU kernel of the JAX package: ``batched_gemm``,
``tile_chain`` and ``lr_sample`` (the left-looking sampling chain), and
``batched_qr`` and ``small_svd`` (the rounding pass of the tile algebra and
the right-looking driver). ``ops`` dispatches by tensor device; ``build``
compiles ``csrc/*.cu`` with nvcc on first use and loads them with ctypes.
"""
