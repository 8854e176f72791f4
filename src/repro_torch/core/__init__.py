"""Core TLR layers of the port: layout, compression, rounding, tile
algebra, factorization, solves, PCG and the Newton-Schulz preconditioner."""

from .algebra import (TLRTiles, generalize, offd_index, offd_pairs,
                      symmetrize, tlr_add_diag, tlr_axpy, tlr_gemm,
                      tlr_round, tlr_round_tiles, tlr_scale, tlr_syrk,
                      tlr_syrk_column, tlr_transpose)
from .ara import ARAParams, torch_probes
from .cholesky import CholOptions, tlr_cholesky, tlr_ldlt
from .dense_ref import (blocked_cholesky_left, dense_cholesky, dense_ldlt,
                        spectral_norm_est, spectral_norm_est_op)
from .generators import (covariance_matrix, covariance_problem,
                         fractional_diffusion, fractional_diffusion_matrix,
                         fractional_diffusion_points,
                         fractional_diffusion_problem)
from .operator import TLRFactorization, TLROperator
from .precond import NewtonSchulzInfo, tlr_newton_schulz
from .solve import (PCGHistory, pcg, tlr_matvec, tlr_tri_matvec, tlr_trsv,
                    tlr_trsv_reference)
from .tlr import TLRMatrix, num_tiles, tlr_to_dense, tril_index, tril_pairs

__all__ = [
    "ARAParams", "CholOptions", "NewtonSchulzInfo", "PCGHistory",
    "TLRFactorization", "TLRMatrix", "TLROperator", "TLRTiles",
    "blocked_cholesky_left", "covariance_matrix", "covariance_problem",
    "dense_cholesky", "dense_ldlt", "fractional_diffusion",
    "fractional_diffusion_matrix", "fractional_diffusion_points",
    "fractional_diffusion_problem",
    "generalize", "num_tiles", "offd_index", "offd_pairs", "pcg",
    "spectral_norm_est", "spectral_norm_est_op", "symmetrize",
    "tlr_add_diag", "tlr_axpy", "tlr_cholesky", "tlr_gemm", "tlr_ldlt",
    "tlr_matvec", "tlr_newton_schulz", "tlr_round", "tlr_round_tiles",
    "tlr_scale", "tlr_syrk", "tlr_syrk_column", "tlr_to_dense",
    "tlr_transpose", "tlr_tri_matvec", "tlr_trsv", "tlr_trsv_reference",
    "torch_probes", "tril_index", "tril_pairs",
]
