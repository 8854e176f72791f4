"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``: skipped without a CUDA card. Imports neither jax nor repro,
so it runs on a machine without JAX:

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances as in tests/test_kernels.py (f64 1e-12, f32 1e-5, bf16 5e-2,
bf16 accumulating in f32), relative to the largest |plain output|; each
check must also reject a planted fault (one rank or one j term dropped).
The rounding kernels run in f64 and f32: ``batched_qr`` is held to the
same gate on Q and R, ``small_svd`` to ten times it on the sorted singular
values and on the reconstruction ``U diag(s) V^T`` (its U and V columns of
nearly equal singular values rotate freely under rounding; see
chip_smoke.py).
"""

import pytest
import torch

from repro_torch.kernels import batched_gemm as tbg
from repro_torch.kernels import batched_qr as tqr
from repro_torch.kernels import lr_sample as tlr
from repro_torch.kernels import ops
from repro_torch.kernels import small_svd as tsvd
from repro_torch.kernels import tlr_matvec as ttc


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
def test_cuda_kernels_match_plain(cuda_device, dtype):
    """On the card: each kernel against its plain version, ragged shapes."""
    tol = {torch.float64: 1e-12, torch.float32: 1e-5,
           torch.bfloat16: 5e-2}[dtype]
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    def err(got, want):
        return float((got.double() - want.double()).abs().max())

    ops.reset_launch_counts()
    A, B = rnd(5, 96, 24), rnd(5, 24, 20)
    ranks = torch.randint(1, 25, (5,), generator=g, device=cuda_device,
                          dtype=torch.int32)
    U, V, X = rnd(3, 96, 24), rnd(3, 96, 24), rnd(3, 96, 70)
    Ui, Vi, W2 = rnd(5, 2, 96, 24), rnd(5, 2, 96, 24), rnd(2, 96, 20)
    for got, want, fault in (
            (ops.batched_gemm(A, B, ranks),
             tbg.batched_gemm_plain(A, B, ranks),
             tbg.batched_gemm_plain(A, B, ranks - 1)),
            (ops.tile_chain(U, V, X, width=17),
             ttc.tile_chain_plain(U, V, X, width=17),
             ttc.tile_chain_plain(U, V, X, width=16)),
            (ops.lr_sample(Ui, Vi, W2), tlr.lr_sample_plain(Ui, Vi, W2),
             tlr.lr_sample_plain(Ui[:, :1].contiguous(),
                                 Vi[:, :1].contiguous(),
                                 W2[:1].contiguous()))):
        atol = tol * float(want.double().abs().max())
        assert err(got, want) <= atol
        assert err(fault, want) > atol
    assert ops.launch_counts() == {"batched_gemm": 1, "tile_chain": 1,
                                   "lr_sample": 1, "batched_qr": 0,
                                   "small_svd": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_rounding_kernels_match_plain(cuda_device, dtype):
    """On the card: batched_qr and small_svd against their plain versions,
    with the working matrix in shared memory and, for the larger shapes, in
    the device scratch."""
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}[dtype]
    g = torch.Generator(device=cuda_device).manual_seed(1)

    def rnd(*shape):
        x = torch.randn(shape, generator=g, device=cuda_device,
                        dtype=torch.float64)
        return (x / shape[-1] ** 0.5).to(dtype)

    def err(got, want):
        return float((got.double() - want.double()).abs().max())

    def allowed(want, t):
        return t * float(want.double().abs().max())

    ops.reset_launch_counts()
    for Y in (rnd(5, 96, 24), rnd(2, 1024, 40)):
        Y[0, :, 3] = 2.0 * Y[0, :, 1] - Y[0, :, 0]    # a dead column
        Q, R = ops.batched_qr(Y)
        Qp, Rp = tqr.batched_qr_plain(Y)
        Yf = Y.clone()
        Yf[:, :, -1] = 0.0                            # one live column dropped
        Qf, Rf = tqr.batched_qr_plain(Yf)
        assert float(Q[0, :, 3].abs().max()) == 0.0
        assert err(Q, Qp) <= allowed(Qp, tol)
        assert err(R, Rp) <= allowed(Rp, tol)
        assert err(Qf, Qp) > allowed(Qp, tol) and err(Rf, Rp) > allowed(Rp, tol)

    def rec(U, s, V):
        return (U * s[:, None, :]) @ V.transpose(1, 2)

    for M in (rnd(3, 20, 13), rnd(2, 200, 150)):
        U, s, V = ops.small_svd(M)
        Up, sp, Vp = tsvd.small_svd_plain(M)
        sp_sorted = sp.sort(dim=-1, descending=True).values
        assert err(s, sp_sorted) <= allowed(sp, 10 * tol)
        assert err(rec(U, s, V), rec(Up, sp, Vp)) <= allowed(M, 10 * tol)
        _, s1, _ = tsvd.small_svd_plain(M, sweeps=1)  # seven sweeps dropped
        s1 = s1.sort(dim=-1, descending=True).values
        assert err(s1, sp_sorted) > allowed(sp, 10 * tol)
    assert ops.launch_counts() == {"batched_gemm": 0, "tile_chain": 0,
                                   "lr_sample": 0, "batched_qr": 2,
                                   "small_svd": 2}
