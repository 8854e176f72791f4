"""Core TLR layers of the port: layout, compression, rounding,
factorization, solves."""

from .algebra import tlr_round, tlr_round_tiles, tlr_syrk_column
from .ara import ARAParams, torch_probes
from .cholesky import CholOptions, tlr_cholesky, tlr_ldlt
from .generators import covariance_matrix, covariance_problem
from .operator import TLRFactorization, TLROperator
from .solve import (tlr_matvec, tlr_tri_matvec, tlr_trsv,
                    tlr_trsv_reference)
from .tlr import TLRMatrix, num_tiles, tlr_to_dense, tril_index, tril_pairs

__all__ = [
    "ARAParams", "CholOptions", "TLRFactorization", "TLRMatrix",
    "TLROperator", "covariance_matrix", "covariance_problem", "num_tiles",
    "tlr_cholesky", "tlr_ldlt", "tlr_matvec", "tlr_round",
    "tlr_round_tiles", "tlr_syrk_column", "tlr_to_dense",
    "tlr_tri_matvec", "tlr_trsv", "tlr_trsv_reference", "torch_probes",
    "tril_index", "tril_pairs",
]
