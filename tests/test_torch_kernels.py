"""Kernel parity of the PyTorch port (``repro_torch.kernels``) against the
JAX package: each plain PyTorch version against ``repro.kernels.ref`` and
against the Pallas kernel in interpret mode, on the same inputs.

Shapes and tolerances are those of tests/test_kernels.py: f64 1e-12, f32
1e-5, bf16 5e-2 (bf16 accumulates in f32 on both sides), with the same
``atol`` scaling by the contraction length. The CUDA kernels themselves run
only on a card: tests/test_torch_gpu.py compares them with the plain
versions there.
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import buckets as jax_buckets
from repro.kernels import ref
from repro.kernels.batched_gemm import batched_gemm_pallas
from repro.kernels.lr_sample import lr_sample_pallas
from repro.kernels.tlr_matvec import tile_chain_pallas
from repro_torch.core.buckets import _bucket_ladder, _column_buckets
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
@pytest.mark.parametrize("T,m,k,n,ranks_kind", [
    pytest.param(1, 16, 8, 16, "random", id="1-16-8-16"),
    pytest.param(4, 64, 32, 8, "random", id="4-64-32-8"),
    pytest.param(3, 128, 64, 128, "random", id="3-128-64-128"),
    pytest.param(2, 40, 27, 20, "garbage", id="2-40-27-20-garbage"),
    pytest.param(5, 24, 17, 9, "garbage", id="5-24-17-9-garbage"),
    pytest.param(4, 40, 27, 20, "edges", id="4-40-27-20-edges"),
    pytest.param(4, 128, 64, 128, "edges", id="4-128-64-128-edges"),
])
def test_batched_gemm_plain_matches_jax(T, m, k, n, ranks_kind, dtype):
    """Random ranks in [0, k]; with "garbage", +-1e6 in A's columns and B's
    rows past each rank; "edges": ranks 0, k, above k and negative (none),
    garbage past them. m, k and n need not be multiples of 8 or 16."""
    ks = jax.random.split(jax.random.PRNGKey(1), 2)
    A = _rand(ks[0], (T, m, k), dtype)
    B = _rand(ks[1], (T, k, n), dtype)
    if ranks_kind == "edges":
        ranks = np.resize(np.array([0, k, k + 3, -2], np.int32), T)
    else:
        ranks = np.random.default_rng(0).integers(0, k + 1, T).astype(
            np.int32)
    if ranks_kind != "random":
        dead = jnp.arange(k)[None, :] >= jnp.asarray(ranks)[:, None]
        A = jnp.where(dead[:, None, :], 1e6, A).astype(dtype)
        B = jnp.where(dead[:, :, None], -1e6, B).astype(dtype)
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


@pytest.mark.parametrize("ldr,width,s", [
    (128, None, 17), (128, None, 128), (128, None, 200), (128, 37, 17),
    (128, 37, 128), (128, 37, 200), (160, None, 70), (160, 129, 70),
    (256, None, 70), (512, 300, 40),
])
def test_tile_chain_ragged_f64_matches_jax(ldr, width, s):
    """The f64 shapes that tests/test_torch_gpu.py holds the card's kernels
    to (b = 100, all factor columns or a ``width=`` slice, s from 17 to 200;
    widths past 128 as the tensor-core kernel of 128 < r <= 512 takes
    them), against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(7)
    U, V, X = (rng.standard_normal(shape) for shape in
               ((2, 100, ldr), (2, 100, ldr), (2, 100, s)))
    got = ops.tile_chain(*(torch.from_numpy(a) for a in (U, V, X)),
                         width=width)
    want = tile_chain_pallas(jnp.asarray(U), jnp.asarray(V), jnp.asarray(X),
                             interpret=True, width=width)
    _close(got, want, 1e-12, 1e-12 * np.sqrt(100))


_LR_RAGGED = [(T, J, s, 128, 37) for s in (16, 17, 20)
              for T, J in ((1, 1), (3, 5))] + [(1, 1, 16, 256, 200),
                                              (3, 5, 20, 512, 384)]


@pytest.mark.parametrize("T,J,s,ldr,width", _LR_RAGGED, ids=[
    f"{T}-{J}-{s}" + ("" if ldr == 128 else f"-ldr{ldr}-width{width}")
    for T, J, s, ldr, width in _LR_RAGGED])
def test_lr_sample_ragged_f64_matches_jax(T, J, s, ldr, width):
    """The f64 shapes that tests/test_torch_gpu.py holds the card's
    tensor-core kernels to (b = 100, 37 of 128 factor columns by
    ``width=``, one or two 16-column chunks; and ``width=`` slices past 128
    of rows of 256 and 512, as the kernel of 128 < r <= 512 takes them),
    against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(8)
    Ui, Vi, W2 = (rng.standard_normal(shape) for shape in
                  ((T, J, 100, ldr), (T, J, 100, ldr), (J, 100, s)))
    got = ops.lr_sample(*(torch.from_numpy(a) for a in (Ui, Vi, W2)),
                        width=width)
    want = lr_sample_pallas(jnp.asarray(Ui), jnp.asarray(Vi), jnp.asarray(W2),
                            interpret=True, width=width)
    _close(got, want, 1e-12, 1e-12 * np.sqrt(100 * J))


def test_lr_sample_smoke_cases_follow_the_column_buckets():
    """chip_smoke.py times lr_sample at the (T, J) shapes the left-looking
    factorization gives it at N = 32768, tile 512: the column buckets
    ``_column_buckets(64, k, _bucket_ladder(63))``, k = 0 .. 62, at the
    largest, the smallest and the buckets between."""
    buckets = {_column_buckets(64, k, _bucket_ladder(63)) for k in range(63)}
    assert buckets == {jax_buckets._column_buckets(
        64, k, jax_buckets._bucket_ladder(63)) for k in range(63)}
    assert buckets == {(63, 30), (32, 46), (16, 54), (8, 58), (4, 60),
                       (2, 61), (1, 62)}
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert set(smoke.LR_BUCKETS) == buckets
    cases = smoke.kernel_cases(torch, torch.ones(63, dtype=torch.int32),
                               device="cpu")
    shapes = set()
    for name, label, headline, _ in cases:
        m = re.fullmatch(r"T=(\d+) J=(\d+) b=512 r=128 s=16", label)
        if name == "lr_sample" and m:
            shapes.add((int(m[1]), int(m[2])))
            assert headline == ((int(m[1]), int(m[2])) == (63, 30))
    assert shapes <= buckets
    by_t = sorted(buckets)
    assert by_t[0] in shapes and by_t[-1] in shapes
    assert any(by_t[0] < sh < by_t[-1] for sh in shapes)


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
