"""The fractional-diffusion PCG slice end to end against the JAX package:
the 3D operator at n = 512, tile 64 compressed at 1e-10 (JAX's arrays
carried across), then PCG on it preconditioned by

* the loose-eps TLR Cholesky of ``K + eps I`` (``tlr_add_diag`` of the
  compressed operator, as chip_smoke.py builds it; JAX's probes injected,
  so both packages run the same randomized factorization), and
* the Newton-Schulz TLR inverse (``scale="norm"``).

Gates: equal PCG iteration counts for both preconditioners, both below
plain CG's; the Newton-Schulz ``alpha`` within 1e-12 and its X within
1e-8 relative (Frobenius) of the JAX package's. Two Newton-Schulz
iterations keep the file's CPU time down: the plain Jacobi SVD of the 56
dense 64 x 64 product tiles dominates it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TLROperator as JOperator
from repro.core import CholOptions as JCholOptions
from repro.core import pcg as jax_pcg
from repro.core import tlr_newton_schulz as jax_newton_schulz
from repro.core.algebra import tlr_add_diag as jax_add_diag
from repro_torch.convert import operator_from_numpy
from repro_torch.core import (CholOptions, TLROperator,
                              fractional_diffusion_problem, pcg,
                              tlr_add_diag, tlr_newton_schulz)
from test_torch_factorization import jax_probes

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def slice_ops():
    _, K = fractional_diffusion_problem(512, 64)
    jop = JOperator.compress(jnp.asarray(K), 64, eps=1e-10)
    top = operator_from_numpy(jop.A.D, jop.A.U, jop.A.V, jop.A.ranks,
                              device="cpu")
    rhs = np.random.default_rng(0).standard_normal(512)
    _, it_plain, _ = pcg(top, torch.as_tensor(rhs), tol=1e-6, maxiter=300)
    _, it_plain_j, _ = jax_pcg(jop, jnp.asarray(rhs), tol=1e-6, maxiter=300)
    assert it_plain == it_plain_j
    return K, jop, top, rhs, it_plain


def test_cholesky_preconditioner_matches_jax(slice_ops):
    K, jop, top, rhs, it_plain = slice_ops
    eps = 1e-2
    fj = JOperator(jax_add_diag(jop.A, eps)).cholesky(
        JCholOptions(eps=eps, bs=16))
    ft = TLROperator(tlr_add_diag(top.A, eps)).cholesky(
        CholOptions(eps=eps, bs=16, probes=jax_probes(0)))
    np.testing.assert_array_equal(ft.L.ranks.numpy(), np.asarray(fj.L.ranks))
    x, it, hist = pcg(top, torch.as_tensor(rhs), precond=ft, tol=1e-6,
                      maxiter=300)
    _, itj, _ = jax_pcg(jop, jnp.asarray(rhs), precond=fj, tol=1e-6,
                        maxiter=300)
    assert it == itj < it_plain and hist[-1] < 1e-6
    assert np.linalg.norm(K @ x.numpy() - rhs) / np.linalg.norm(rhs) < 1e-5


def test_newton_schulz_preconditioner_matches_jax(slice_ops):
    K, jop, top, rhs, it_plain = slice_ops
    X, info = tlr_newton_schulz(top, iters=2, eps=1e-8, scale="norm")
    Xj, infoj = jax_newton_schulz(jop, iters=2, eps=1e-8, scale="norm")
    assert abs(info.alpha - infoj.alpha) <= 1e-12 * infoj.alpha
    w = np.asarray(Xj.to_dense())
    assert np.linalg.norm(X.to_dense().numpy() - w) / np.linalg.norm(w) \
        <= 1e-8
    x, it, hist = pcg(top, torch.as_tensor(rhs), precond=X, tol=1e-6,
                      maxiter=300)
    _, itj, _ = jax_pcg(jop, jnp.asarray(rhs), precond=Xj, tol=1e-6,
                        maxiter=300)
    assert it == itj < it_plain and hist[-1] < 1e-6
    assert np.linalg.norm(K @ x.numpy() - rhs) / np.linalg.norm(rhs) < 1e-5
