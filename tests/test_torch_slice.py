"""End-to-end parity of the port's first slice against the JAX package: the
quickstart path (covariance -> compress -> left-looking dynamic ARA
Cholesky -> solve / logdet / sample / matvec) at n=512, tile 64, with the
same probes on both sides; solving with a JAX-computed factor carried
across through ``repro_torch.convert``; and the import rule (the port,
chip_smoke.py and tools/*.py import neither jax nor repro).

Tolerances: the factorizations agree to ~1e-14 (see
tests/test_torch_factorization.py), so solves, logdet and samples are held
to 1e-8 relative, which a single flipped ARA rank decision (an O(eps=1e-6)
change of the factor) would break.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CholOptions as JCholOptions
from repro.core import TLROperator as JOperator
from repro.core import covariance_problem as jax_covariance_problem
from repro_torch import CholOptions, TLROperator, covariance_problem
from repro_torch.convert import factorization_from_numpy

ROOT = Path(__file__).resolve().parents[1]
N, TILE, EPS = 512, 64, 1e-6


def jax_probes(seed: int = 0):
    """The JAX driver's Omega: normal(fold_in(fold_in(PRNGKey(seed), k), it))."""
    key = jax.random.PRNGKey(seed)

    def probes(k, it, shape, dtype, device):
        kk = jax.random.fold_in(jax.random.fold_in(key, k), it)
        z = np.array(jax.random.normal(kk, shape, jnp.float64))
        return torch.as_tensor(z, dtype=dtype, device=device)

    return probes


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def quickstart():
    _, K = jax_covariance_problem(N, 3, TILE)
    jop = JOperator.compress(jnp.asarray(K), TILE, eps=EPS * 1e-2)
    jfact = jop.cholesky(JCholOptions(eps=EPS, bs=16, mode="dynamic",
                                      batching="flat"))
    _, Kt = covariance_problem(N, 3, TILE, device="cpu")
    op = TLROperator.compress(Kt, TILE, eps=EPS * 1e-2)
    fact = op.cholesky(CholOptions(eps=EPS, bs=16, mode="dynamic",
                                   batching="flat", probes=jax_probes(0)))
    return K, Kt, jop, jfact, op, fact


def test_quickstart_path_matches_jax(quickstart):
    K, Kt, jop, jfact, op, fact = quickstart
    np.testing.assert_allclose(Kt.numpy(), K, rtol=1e-14, atol=1e-14)
    np.testing.assert_array_equal(op.ranks.numpy(), np.asarray(jop.ranks))
    np.testing.assert_array_equal(fact.L.ranks.numpy(),
                                  np.asarray(jfact.L.ranks))
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(N)
    y = K @ x_true
    x = fact.solve(torch.from_numpy(y))
    assert _rel(x, jfact.solve(jnp.asarray(y))) <= 1e-8
    assert _rel(x, x_true) < 1e-3
    Y = K @ rng.standard_normal((N, 4))
    X = fact.solve(torch.from_numpy(Y))
    assert X.shape == (N, 4)
    assert _rel(X, jfact.solve(jnp.asarray(Y))) <= 1e-8
    ld, jld = float(fact.logdet()), float(jfact.logdet())
    assert abs(ld - jld) <= 1e-8 * abs(jld)
    Ax = op @ x
    assert _rel(Ax, jop @ jnp.asarray(x.numpy())) <= 1e-12
    assert _rel(Ax, y) < 1e-6


def test_sample_with_the_same_z(quickstart):
    """JAX draws z from jax.random inside sample(); hand the port that z."""
    _, _, _, jfact, _, fact = quickstart
    key = jax.random.PRNGKey(0)
    z = np.array(jax.random.normal(key, (N, 2), jnp.float64))
    want = np.asarray(jfact.sample(key, num=2))
    got = fact.sample(2, z=torch.from_numpy(z))
    assert got.shape == (N, 2)
    assert _rel(got, want) <= 1e-8
    assert _rel(fact.tri_matvec(torch.from_numpy(z)), want) <= 1e-8
    g = torch.Generator().manual_seed(0)
    s = fact.sample(3, generator=g)
    assert s.shape == (N, 3) and torch.isfinite(s).all()


def test_solve_with_a_jax_factor(quickstart):
    K, _, _, jfact, _, _ = quickstart
    L = jfact.L
    fact = factorization_from_numpy(L.D, L.U, L.V, L.ranks, perm=jfact.perm,
                                    device="cpu")
    y = K @ np.random.default_rng(1).standard_normal((N, 2))
    assert _rel(fact.solve(torch.from_numpy(y)),
                jfact.solve(jnp.asarray(y))) <= 1e-12
    assert abs(float(fact.logdet()) - float(jfact.logdet())) <= \
        1e-12 * abs(float(jfact.logdet()))


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", *sorted((ROOT / "tools").glob("*.py"))]
    assert len(files) > 10
    for path in files:
        bad = _imports(path) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
