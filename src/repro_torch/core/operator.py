"""Operator-first public API: ``TLROperator`` and ``TLRFactorization``.

Port of ``repro/core/operator.py:53-392,402-499``: compress -> factor ->
solve/logdet/sample (section 6).

* ``TLROperator`` wraps a ``TLRMatrix``: ``compress`` / ``from_dense`` /
  ``from_kernel`` (one batched SVD or batched ARA over all nt tiles),
  ``matvec`` / ``@``, ``to_dense``, ``memory_stats``, ``trace`` /
  ``diagonal`` / ``diagonal_tiles``, the tile-algebra arithmetic (``+``,
  ``-``, scalar ``*``, negation, ``compose``, ``round``; ``core/algebra.py``),
  ``plan`` (the rank-bucket execution plan of ``core/batching.py``), and
  ``cholesky`` / ``ldlt`` returning a factorization handle.
* ``TLRFactorization`` is the result handle of the factorizations:
  ``solve``, ``tri_matvec``, ``tri_solve``, ``logdet``, ``sample`` and
  ``serve`` (a ``repro_torch.serve.TLRServer`` with the factor resident).

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..device import resolve_device, torch_dtype
from . import solve as _solve
from .ara import ARAParams, ara_compress_dense, torch_probes
from .tlr import TLRMatrix, tril_pairs


# -- batched tile compression (construction hot path) --------------------------


def _split_tiles(A: torch.Tensor, nb: int, b: int):
    """Diagonal tiles (nb, b, b) and packed lower tiles (nt, b, b)."""
    Ab = A.reshape(nb, b, nb, b)
    diag = torch.arange(nb, device=A.device)
    D = Ab[diag, :, diag, :]
    pairs = torch.as_tensor(tril_pairs(nb), device=A.device)
    tiles = Ab[pairs[:, 0], :, pairs[:, 1], :]
    return D, tiles


def _svd_compress_tiles(tiles: torch.Tensor, eps: float, *, r_max: int,
                        rel: bool):
    """Batched truncated SVD of (nt, b, b) tiles: keep singular values
    > eps (absolute) or > eps * s_max (relative), 0 <= rank <= r_max,
    columns past the rank zeroed. A numerically zero tile has rank 0."""
    nt, b = tiles.shape[0], tiles.shape[1]
    k = min(r_max, b)
    Ub, s, Vh = torch.linalg.svd(tiles, full_matrices=False)
    cut = eps * (s[:, :1] if rel else torch.ones_like(s[:, :1]))
    ranks = (s > cut).sum(dim=1).clamp(0, r_max).to(torch.int32)
    mask = (torch.arange(k, device=tiles.device)[None, :]
            < ranks[:, None]).to(tiles.dtype)
    U = tiles.new_zeros((nt, b, r_max))
    V = tiles.new_zeros((nt, b, r_max))
    U[:, :, :k] = Ub[:, :, :k] * (s[:, None, :k] * mask[:, None, :])
    V[:, :, :k] = Vh.transpose(1, 2)[:, :, :k] * mask[:, None, :]
    return U, V, ranks


# -- the operator handle -------------------------------------------------------


@dataclasses.dataclass
class TLROperator:
    """Symmetric TLR operator handle wrapping a ``TLRMatrix``."""

    A: TLRMatrix

    @property
    def shape(self) -> tuple[int, int]:
        return (self.A.n, self.A.n)

    @property
    def dtype(self) -> torch.dtype:
        return self.A.dtype

    @property
    def device(self) -> torch.device:
        return self.A.device

    @property
    def nb(self) -> int:
        return self.A.nb

    @property
    def b(self) -> int:
        return self.A.b

    @property
    def n(self) -> int:
        return self.A.n

    @property
    def r_max(self) -> int:
        return self.A.r_max

    @property
    def ranks(self) -> torch.Tensor:
        return self.A.ranks

    # -- construction -----------------------------------------------------

    @classmethod
    def compress(
        cls,
        dense: Union[torch.Tensor, np.ndarray],
        tile: int,
        r_max: Optional[int] = None,
        eps: float = 1e-6,
        *,
        rel: bool = False,
        method: str = "svd",
        store_dtype=None,
        bs: int = 16,
        seed: int = 0,
        probes: Optional[Callable] = None,
        device=None,
    ) -> "TLROperator":
        """Compress a dense symmetric matrix into TLR form, batched: one
        batched truncated SVD (``method="svd"``) or the batched ARA of
        Algorithm 1 (``method="ara"``) over all nt off-diagonal tiles.

        A tensor stays on its device unless ``device`` says otherwise; a
        numpy array goes to ``device`` (the card by default). ``probes``
        (``probes(k, it, shape, dtype, device)``, called with k = 0) feeds
        the ARA probes; by default they come from :func:`torch_probes` of
        ``seed``.

        ``store_dtype``: optional lower precision (a torch or numpy dtype)
        for the off-diagonal U/V factors (the paper's section 7
        mixed-precision proposal), applied after the compression; the
        diagonal tiles stay in the working precision. Every read of such
        an operator promotes U and V to the working precision where they
        meet working-precision operands (matvec, the factorizations'
        gathers), so the kernels run in the working precision; rounding
        (``op.round``) runs and stores in the storage precision, as in the
        JAX package.
        """
        if isinstance(dense, torch.Tensor) and device is None:
            A = dense
        else:
            A = torch.as_tensor(dense, device=resolve_device(device))
        n = A.shape[0]
        if n % tile:
            raise ValueError(f"n={n} must be a multiple of tile size b={tile}")
        nb = n // tile
        r_max = r_max or tile
        D, tiles = _split_tiles(A, nb, tile)
        if tiles.shape[0] == 0:
            U = A.new_zeros((0, tile, r_max))
            V = A.new_zeros((0, tile, r_max))
            ranks = torch.zeros((0,), dtype=torch.int32, device=A.device)
        elif method == "svd":
            U, V, ranks = _svd_compress_tiles(tiles, eps, r_max=r_max,
                                              rel=rel)
        elif method == "ara":
            if rel:
                raise ValueError("rel thresholds are SVD-only; ARA uses the "
                                 "absolute 2-norm residual estimate")
            p = ARAParams(bs=min(bs, r_max), r_max=r_max, eps=eps)
            src = probes or torch_probes(seed)
            U, B, ranks, _ = ara_compress_dense(
                tiles, lambda it, shape, dt, dev: src(0, it, shape, dt, dev),
                p)
            V = B  # tile ~= Q B^T  =>  U=Q, V=B
        else:
            raise ValueError(f"method must be 'svd' or 'ara', got {method!r}")
        if store_dtype is not None:
            sdt = torch_dtype(store_dtype)
            U, V = U.to(sdt), V.to(sdt)
        return cls(TLRMatrix(D=D, U=U, V=V, ranks=ranks))

    @classmethod
    def from_dense(cls, dense, tile: int, r_max: Optional[int] = None,
                   eps: float = 1e-6, **kw) -> "TLROperator":
        """Alias of :meth:`compress` (scipy-style constructor name)."""
        return cls.compress(dense, tile, r_max, eps, **kw)

    @classmethod
    def from_kernel(
        cls,
        points: np.ndarray,
        kernel: str = "exp",
        *,
        tile: int,
        eps: float = 1e-8,
        ell: Optional[float] = None,
        nugget: float = 1e-8,
        r_max: Optional[int] = None,
        device=None,
        dtype=torch.float64,
        **kw,
    ) -> "TLROperator":
        """Covariance operator of a point cloud (already in tile order),
        with the kernel evaluated on ``device`` (the card by default)."""
        from .generators import covariance_matrix

        K = covariance_matrix(points, kernel, ell, nugget, device=device,
                              dtype=dtype)
        return cls.compress(K, tile, r_max, eps, **kw)

    # -- algebra ----------------------------------------------------------

    def matvec(self, x: torch.Tensor, *,
               batching: str | None = "auto") -> torch.Tensor:
        """y = A @ x; x is (n,) or batched (n, m). ``batching`` picks flat
        vs rank-bucketed dispatch (``"auto"`` lets the plan decide)."""
        return _solve.tlr_matvec(self.A, x, batching=batching)

    def plan(self):
        """The memoized :class:`~.batching.TilePlan` of this operator's
        rank distribution (rank buckets, ladder widths), the execution plan
        every batched path dispatches through."""
        from .batching import tile_plan

        return tile_plan(self.A.ranks, self.A.r_max)

    def __matmul__(self, x):
        if isinstance(x, torch.Tensor):
            return self.matvec(x)
        return NotImplemented

    def to_dense(self) -> torch.Tensor:
        return self.A.to_dense()

    def memory_stats(self) -> dict:
        return self.A.memory_stats()

    def diagonal_tiles(self) -> torch.Tensor:
        return self.A.D

    def trace(self) -> torch.Tensor:
        """tr(A): the sum of the dense diagonal tiles' diagonals (the
        Newton-Schulz scaling ``alpha = 1/trace``, core/precond.py)."""
        return torch.einsum("kbb->", self.A.D)

    def diagonal(self) -> torch.Tensor:
        """diag(A) as an (n,) vector, from the dense diagonal tiles."""
        return torch.einsum("kbb->kb", self.A.D).reshape(self.n)

    # -- tile-algebra arithmetic (core/algebra.py) -------------------------

    def __add__(self, other):
        """A + B, exact low-rank concatenation (ranks add; call
        :meth:`round` to recompress)."""
        from .algebra import tlr_axpy

        if isinstance(other, TLROperator):
            return TLROperator(tlr_axpy(1.0, self.A, other.A))
        return NotImplemented

    def __sub__(self, other):
        from .algebra import tlr_axpy

        if isinstance(other, TLROperator):
            return TLROperator(tlr_axpy(-1.0, other.A, self.A))
        return NotImplemented

    def __mul__(self, alpha):
        from .algebra import tlr_scale

        if isinstance(alpha, (int, float, np.number)) or (
                isinstance(alpha, (torch.Tensor, np.ndarray))
                and alpha.ndim == 0):
            return TLROperator(tlr_scale(alpha, self.A))
        return NotImplemented

    __rmul__ = __mul__

    def __neg__(self):
        return self * -1.0

    def compose(self, other, eps: float = 0.0, r_max_out=None, *,
                batching: str = "auto"):
        """C = A @ other as a general (nonsymmetric) ``TLRTiles`` grid,
        compressed at ``eps`` (0.0 keeps everything up to the rank cap).
        ``other`` is a ``TLROperator``, ``TLRMatrix`` or ``TLRTiles``.
        ``batching="ranked"`` runs the accumulation chains at the
        rank-bucketed widths; ``"auto"`` (default) lets the rank histogram
        decide."""
        from .algebra import tlr_gemm

        return tlr_gemm(self.A, other, eps, r_max_out, batching=batching)

    def round(self, eps: float, r_max_out: Optional[int] = None, *,
              batching: str = "auto") -> "TLROperator":
        """Recompress every off-diagonal tile at ``eps`` (batched QR +
        small-SVD, ``core/algebra.py::tlr_round``): one r_max-wide pass
        (``"flat"``), one pass per rank bucket (``"ranked"``), or as the
        rank histogram decides (``"auto"``)."""
        from .algebra import tlr_round

        return TLROperator(tlr_round(self.A, eps, r_max_out,
                                     batching=batching))

    # -- factorization ----------------------------------------------------

    def cholesky(self, opts=None) -> "TLRFactorization":
        """TLR Cholesky; ``opts.algo`` picks the left-looking ARA driver
        (Algorithm 6, default) or the right-looking one. Returns the
        handle."""
        from .cholesky import CholOptions, tlr_cholesky

        return tlr_cholesky(self.A, opts or CholOptions())

    def ldlt(self, opts=None) -> "TLRFactorization":
        """TLR LDL^T (Algorithm 10, or right-looking with
        ``opts.algo="right"``); returns the handle."""
        from .cholesky import CholOptions, tlr_ldlt

        return tlr_ldlt(self.A, opts or CholOptions())


# -- the factorization handle --------------------------------------------------


@dataclasses.dataclass
class TLRFactorization:
    """Handle for a TLR factorization  P A P^T = L L^T  (or L D L^T).

    ``L.D`` holds the dense diagonal blocks L(k,k) (unit-lower for LDL^T),
    ``d`` the LDL diagonal (None for Cholesky), ``perm`` the tile
    permutation (logical -> original; the identity unless the left driver
    pivoted), ``stats`` the driver's per-column record.
    """

    L: TLRMatrix
    d: Optional[torch.Tensor]
    perm: np.ndarray
    stats: dict

    @property
    def nb(self) -> int:
        return self.L.nb

    @property
    def b(self) -> int:
        return self.L.b

    @property
    def n(self) -> int:
        return self.L.n

    @property
    def shape(self) -> tuple[int, int]:
        return (self.L.n, self.L.n)

    @property
    def dtype(self) -> torch.dtype:
        return self.L.dtype

    @property
    def device(self) -> torch.device:
        return self.L.device

    @property
    def is_ldlt(self) -> bool:
        return self.d is not None

    def solve(self, y: torch.Tensor) -> torch.Tensor:
        """x = A^{-1} y through the factorization; y is (n,) or (n, m)."""
        return _solve._factor_solve_impl(self, y)

    def matvec(self, y: torch.Tensor) -> torch.Tensor:
        """Preconditioner action ``A^{-1} y`` (aliases :meth:`solve`)."""
        return self.solve(y)

    def tri_matvec(self, x: torch.Tensor, *, trans: bool = False,
                   batching: str | None = "auto") -> torch.Tensor:
        """y = L @ x (or L^T @ x)."""
        return _solve.tlr_tri_matvec(self.L, x, trans=trans,
                                     batching=batching)

    def tri_solve(self, y: torch.Tensor, *, trans: bool = False,
                  batching: str | None = "auto") -> torch.Tensor:
        """x = L^{-1} y (or L^{-T} y) via the bucketed blocked TRSM
        (``batching`` picks flat vs plan-width column steps)."""
        return _solve.tlr_trsv(self.L, y, trans=trans, batching=batching)

    def plan(self):
        """The memoized :class:`~.batching.TilePlan` of the factor's rank
        distribution (what the TRSM / tri_matvec read paths dispatch on)."""
        from .batching import tile_plan

        return tile_plan(self.L.ranks, self.L.r_max)

    def logdet(self) -> torch.Tensor:
        """log |det A| from the factorization diagonals."""
        return _solve._logdet_impl(self)

    def sample(self, num: int = 1, *, generator=None,
               z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x ~ N(0, A) via x = P^T L z (Cholesky factorizations only);
        ``z`` (n, num) may be passed in, else it is drawn from
        ``generator``."""
        return _solve._mvn_sample_impl(self, num, generator=generator, z=z)

    def serve(self, *, operator=None, slots: int = 8, check_every: int = 4,
              seed: int = 0, warmup: bool = True):
        """A :class:`~repro_torch.serve.TLRServer` with this factorization
        resident (fid ``"default"``): continuous-batching solve / logdet /
        sample / pcg_solve through fixed ``(n, slots)`` RHS blocks on the
        factor's device.

        Pass ``operator`` (the compressed A this handle factors) to enable
        ``pcg_solve`` requests: the server builds a width-``slots`` batched
        PCG engine over it, preconditioned by this factorization.
        ``warmup=True`` runs every fixed-shape operation of the serve path
        once before returning.
        """
        from ..serve import TLRServer

        srv = TLRServer(slots, check_every=check_every, seed=seed)
        srv.register("default", self, operator=operator)
        if warmup:
            srv.warmup()
        return srv
