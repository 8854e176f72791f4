"""Kernel parity of the PyTorch port (``repro_torch.kernels``) against the
JAX package: each plain PyTorch version against ``repro.kernels.ref`` and
against the Pallas kernel in interpret mode, on the same inputs.

Shapes and tolerances are those of tests/test_kernels.py: f64 1e-12, f32
1e-5, bf16 5e-2 (bf16 accumulates in f32 on both sides), with the same
``atol`` scaling by the contraction length. The CUDA kernels themselves run
only on a card: tests/test_torch_gpu.py compares them with the plain
versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.batched_gemm import batched_gemm_pallas
from repro.kernels.lr_sample import lr_sample_pallas
from repro.kernels.tlr_matvec import tile_chain_pallas
from repro_torch.device import resolve_device
from repro_torch.kernels import build, ops
from repro_torch.kernels import batched_gemm as tbg
from repro_torch.kernels import lr_sample as tlr
from repro_torch.kernels import tlr_matvec as ttc

TOL = {
    jnp.float64: dict(rtol=1e-12, atol=1e-12),
    jnp.float32: dict(rtol=1e-5, atol=1e-5),
    jnp.bfloat16: dict(rtol=5e-2, atol=5e-2),
}
TORCH_DTYPE = {jnp.float64: torch.float64, jnp.float32: torch.float32,
               jnp.bfloat16: torch.bfloat16}


def _rand(key, shape, dtype):
    return jax.random.normal(key, shape, jnp.float32).astype(dtype)


def _t(x, dtype):
    """JAX array -> torch tensor of the same values (bf16 exactly, via f32)."""
    return torch.from_numpy(np.asarray(x, np.float64).copy()).to(
        TORCH_DTYPE[dtype])


def _close(got_t, want_j, rtol, atol):
    np.testing.assert_allclose(got_t.double().numpy(),
                               np.asarray(want_j, np.float64),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64, jnp.bfloat16])
@pytest.mark.parametrize("T,k,b,r,s", [
    (1, 1, 32, 8, 8),
    (3, 4, 64, 16, 8),
    (2, 7, 128, 32, 16),
    (5, 2, 96, 24, 4),
])
def test_lr_sample_plain_matches_jax(T, k, b, r, s, dtype):
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    Ui = _rand(ks[0], (T, k, b, r), dtype)
    Vi = _rand(ks[1], (T, k, b, r), dtype)
    W2 = _rand(ks[2], (k, b, s), dtype)
    got = ops.lr_sample(_t(Ui, dtype), _t(Vi, dtype), _t(W2, dtype))
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == (T, b, s)
    tol = TOL[dtype]
    for want in (ref.lr_sample_ref(Ui, Vi, W2),
                 lr_sample_pallas(Ui, Vi, W2, interpret=True)):
        _close(got, want, tol["rtol"], tol["atol"] * k * np.sqrt(b))


def test_lr_sample_k_zero_and_width():
    out = ops.lr_sample(torch.zeros((2, 0, 32, 8)), torch.zeros((2, 0, 32, 8)),
                        torch.zeros((0, 32, 4)))
    assert out.shape == (2, 32, 4) and (out == 0).all()
    # width= keeps the leading factor columns only: zero-padded factors give
    # the unsliced result, and arbitrary tails are ignored exactly as the
    # Pallas kernel's pre-call slice ignores them.
    rng = np.random.default_rng(4)
    Ui = rng.standard_normal((3, 4, 64, 32))
    Vi = rng.standard_normal((3, 4, 64, 32))
    W2 = rng.standard_normal((4, 64, 8))
    got = ops.lr_sample(*(torch.from_numpy(a) for a in (Ui, Vi, W2)), width=12)
    want = lr_sample_pallas(jnp.asarray(Ui), jnp.asarray(Vi), jnp.asarray(W2),
                            interpret=True, width=12)
    _close(got, want, 1e-12, 1e-12 * 4 * 8)
    sliced = ops.lr_sample(torch.from_numpy(Ui[..., :12].copy()),
                           torch.from_numpy(Vi[..., :12].copy()),
                           torch.from_numpy(W2))
    np.testing.assert_array_equal(got.numpy(), sliced.numpy())


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64, jnp.bfloat16])
@pytest.mark.parametrize("T,m,k,n", [
    (1, 16, 8, 16),
    (4, 64, 32, 8),
    (3, 128, 64, 128),
])
def test_batched_gemm_plain_matches_jax(T, m, k, n, dtype):
    ks = jax.random.split(jax.random.PRNGKey(1), 2)
    A = _rand(ks[0], (T, m, k), dtype)
    B = _rand(ks[1], (T, k, n), dtype)
    ranks = np.random.default_rng(0).integers(0, k + 1, T).astype(np.int32)
    got = ops.batched_gemm(_t(A, dtype), _t(B, dtype), torch.from_numpy(ranks))
    assert got.dtype == TORCH_DTYPE[dtype]
    tol = TOL[dtype]
    rj = jnp.asarray(ranks)
    for want in (ref.batched_gemm_ref(A, B, rj),
                 batched_gemm_pallas(A, B, rj, interpret=True)):
        _close(got, want, tol["rtol"], tol["atol"] * np.sqrt(k))


def test_batched_gemm_rank_masking():
    """rank=0 gives exactly zero; full rank gives the plain GEMM."""
    got = ops.batched_gemm(torch.ones((2, 8, 4)), torch.ones((2, 4, 8)),
                           torch.tensor([0, 4], dtype=torch.int32))
    assert (got[0] == 0).all() and (got[1] == 4).all()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64, jnp.bfloat16])
@pytest.mark.parametrize("T,b,r,s", [
    (1, 32, 8, 1),
    (6, 64, 16, 4),
    (3, 128, 48, 2),
])
def test_tile_chain_plain_matches_jax(T, b, r, s, dtype):
    ks = jax.random.split(jax.random.PRNGKey(3), 3)
    U = _rand(ks[0], (T, b, r), dtype)
    V = _rand(ks[1], (T, b, r), dtype)
    X = _rand(ks[2], (T, b, s), dtype)
    got = ops.tile_chain(_t(U, dtype), _t(V, dtype), _t(X, dtype))
    assert got.dtype == TORCH_DTYPE[dtype]
    tol = TOL[dtype]
    for want in (ref.tile_chain_ref(U, V, X),
                 tile_chain_pallas(U, V, X, interpret=True)):
        _close(got, want, tol["rtol"], tol["atol"] * np.sqrt(b))


def test_tile_chain_width():
    rng = np.random.default_rng(5)
    U, V, X = (rng.standard_normal(s) for s in
               ((4, 64, 32), (4, 64, 32), (4, 64, 3)))
    got = ops.tile_chain(*(torch.from_numpy(a) for a in (U, V, X)), width=8)
    want = tile_chain_pallas(jnp.asarray(U), jnp.asarray(V), jnp.asarray(X),
                             interpret=True, width=8)
    _close(got, want, 1e-12, 1e-12 * 8)


def test_cuda_requests_raise_without_a_card(monkeypatch):
    """No silent CPU fallback: without a card, asking for the card raises,
    and the kernel launchers refuse CPU tensors."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="need a CUDA card"):
        build.build_all()
    x = torch.zeros((1, 4, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tbg.batched_gemm_cuda(x, x, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ttc.tile_chain_cuda(x, x, x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tlr.lr_sample_cuda(x[None], x[None], x)
    m = torch.zeros((1, 4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.tile_chain(m, m, m)
    assert ops.launch_counts() == {"batched_gemm": 0, "tile_chain": 0,
                                   "lr_sample": 0, "batched_qr": 0,
                                   "small_svd": 0}
