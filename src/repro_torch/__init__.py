"""PyTorch/CUDA port of the H2OPUS-TLR reproduction (``repro``).

Compress a dense SPD operator into tile low rank form, round it, factor it
with the left-looking ARA Cholesky or LDL^T (with inter-tile pivoting,
if asked) or with the right-looking driver (sequential or lookahead,
flat or rank-bucketed), optionally checked for breakdowns and repaired
(``check=True``), then solve, take log-determinants and draw
samples; compute with TLR matrices (GEMM, SYRK, axpy) and precondition
PCG with a loose factorization or a Newton-Schulz TLR inverse, one
right-hand side or a block of them (``BatchedPCG``); and serve a resident
factorization to a stream of solve / logdet / sample / pcg_solve
requests through fixed ``(n, slots)`` blocks (``fact.serve()``,
``repro_torch.serve``) -- on an NVIDIA Hopper card, with the five Pallas
TPU kernels of the JAX package replaced by hand-written CUDA kernels
(``kernels/csrc``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
where every kernel runs its plain PyTorch version. The package imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``.
"""

from .device import pin_precision, resolve_device

pin_precision()

from .core import (CholOptions, TLRFactorization, TLRMatrix,  # noqa: E402
                   TLROperator, TLRTiles, covariance_problem,
                   fractional_diffusion_problem, pcg, tlr_cholesky,
                   tlr_ldlt, tlr_newton_schulz)

__all__ = [
    "CholOptions", "TLRFactorization", "TLRMatrix", "TLROperator",
    "TLRTiles", "covariance_problem", "fractional_diffusion_problem",
    "pcg", "resolve_device", "tlr_cholesky", "tlr_ldlt",
    "tlr_newton_schulz",
]
