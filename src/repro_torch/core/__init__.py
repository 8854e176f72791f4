"""Core TLR layers of the port: layout, compression, rounding, tile
algebra, factorization (with its stage graph, schedules and health
checks), solves, PCG and the Newton-Schulz preconditioner."""

from .algebra import (TLRTiles, generalize, offd_index, offd_pairs,
                      symmetrize, tlr_add_diag, tlr_axpy, tlr_gemm,
                      tlr_round, tlr_round_tiles, tlr_scale, tlr_syrk,
                      tlr_syrk_column, tlr_transpose)
from .ara import (ARAParams, ara_compress_dense, run_ara_fused,
                  torch_probes)
from .batching import (BatchPlan, RankBucket, TilePlan,
                       batching_trace_count, bucket_width,
                       bucketed_round_tiles, choose_batching,
                       plan_rank_buckets, rank_ladder, resolve_batching,
                       resolve_policy, tile_plan)
from .buckets import trace_count, trace_counts, trace_counts_diff
from .cholesky import (CholOptions, dense_ldlt_tile, robust_cholesky,
                       tlr_cholesky, tlr_ldlt)
from .dense_ref import (blocked_cholesky_left, dense_cholesky, dense_ldlt,
                        spectral_norm_est, spectral_norm_est_op)
from .generators import (ball_points, covariance_matrix, covariance_problem,
                         exp_covariance, fractional_diffusion,
                         fractional_diffusion_matrix,
                         fractional_diffusion_points,
                         fractional_diffusion_problem, grid_points,
                         matern32_covariance)
from .health import (BreakdownReport, FactorizationBreakdown, HealthEvent,
                     HealthMonitor, RetryPolicy, column_flags)
from .operator import TLRFactorization, TLROperator
from .ordering import kd_tree_ordering, morton_ordering
from .precond import NewtonSchulzInfo, tlr_newton_schulz
from .solve import (BatchedPCG, PCGHistory, pcg, tile_perm_to_element_perm,
                    tlr_matvec, tlr_tri_matvec, tlr_trsv,
                    tlr_trsv_reference)
from .stages import (LookaheadSchedule, Schedule, SequentialSchedule, Stage,
                     build_deps, run_graph)
from .tlr import (TLRMatrix, num_tiles, rank_heatmap, tlr_to_dense,
                  tril_index, tril_pairs, zeros_like_structure)

__all__ = [
    "ARAParams", "BatchPlan", "BatchedPCG", "BreakdownReport", "CholOptions",
    "FactorizationBreakdown", "HealthEvent", "HealthMonitor",
    "LookaheadSchedule", "NewtonSchulzInfo", "PCGHistory", "RankBucket",
    "RetryPolicy", "Schedule", "SequentialSchedule", "Stage",
    "TLRFactorization", "TLRMatrix", "TLROperator", "TLRTiles", "TilePlan",
    "ara_compress_dense", "ball_points", "batching_trace_count",
    "blocked_cholesky_left", "bucket_width", "bucketed_round_tiles",
    "build_deps", "choose_batching", "column_flags", "covariance_matrix",
    "covariance_problem", "dense_cholesky", "dense_ldlt", "dense_ldlt_tile",
    "exp_covariance", "fractional_diffusion", "fractional_diffusion_matrix",
    "fractional_diffusion_points", "fractional_diffusion_problem",
    "generalize", "grid_points", "kd_tree_ordering", "matern32_covariance",
    "morton_ordering", "num_tiles", "offd_index", "offd_pairs", "pcg",
    "plan_rank_buckets", "rank_heatmap", "rank_ladder", "resolve_batching",
    "resolve_policy", "robust_cholesky", "run_ara_fused", "run_graph", "spectral_norm_est", "spectral_norm_est_op",
    "symmetrize", "tile_perm_to_element_perm", "tile_plan", "tlr_add_diag",
    "tlr_axpy", "tlr_cholesky", "tlr_gemm", "tlr_ldlt", "tlr_matvec",
    "tlr_newton_schulz", "tlr_round", "tlr_round_tiles", "tlr_scale",
    "tlr_syrk", "tlr_syrk_column", "tlr_to_dense", "tlr_transpose",
    "tlr_tri_matvec", "tlr_trsv", "tlr_trsv_reference", "torch_probes",
    "trace_count", "trace_counts", "trace_counts_diff", "tril_index",
    "tril_pairs", "zeros_like_structure",
]
