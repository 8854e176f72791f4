"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``: skipped without a CUDA card. Imports neither jax nor repro,
so it runs on a machine without JAX:

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances as in tests/test_kernels.py (f64 1e-12, f32 1e-5, bf16 5e-2,
bf16 accumulating in f32), relative to the largest |plain output|; each
check must also reject a planted fault (one rank or one j term dropped).
The f64 paths of ``tile_chain`` with s > 16 and of ``lr_sample`` have
their own ragged cases: the tensor-core kernels (r <= 128) and the FMA
kernels past them.
The rounding kernels run in f64 and f32: ``batched_qr`` is held to the
same gate on Q and R, ``small_svd`` to ten times it on the sorted singular
values and on the reconstruction ``U diag(s) V^T`` (its U and V columns of
nearly equal singular values rotate freely under rounding; see
chip_smoke.py).
"""

import pytest
import torch

from repro_torch.kernels import batched_gemm as tbg
from repro_torch.kernels import build
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
@pytest.mark.parametrize("ldr,width,s,cfg", [
    (128, None, 17, ttc.DMMA), (128, None, 128, ttc.DMMA),
    (128, None, 200, ttc.DMMA), (128, 37, 17, ttc.DMMA),
    (128, 37, 128, ttc.DMMA), (128, 37, 200, ttc.DMMA),
    (160, None, 70, ttc.WIDE), (160, 129, 70, ttc.WIDE),
])
def test_cuda_tile_chain_f64_tensor_cores(cuda_device, ldr, width, s, cfg):
    """On the card: the f64 paths of tile_chain with s > 16 against their
    plain version, at b = 100 (not a multiple of the 16-row slices). The
    tensor-core kernel takes all 128 factor columns or 37 of them by
    ``width=``, at s = 17, 128 and 200 (two 128-column chunks); r = 160 and
    129 go past it, to the FMA kernel with 64-column chunks."""
    T, b = 3, 100
    r = ldr if width is None else width
    assert ttc._config(torch.float64, r, s) == cfg
    g = torch.Generator(device=cuda_device).manual_seed(2)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device,
                           dtype=torch.float64)

    U, V, X = rnd(T, b, ldr), rnd(T, b, ldr), rnd(T, b, s)
    ops.reset_launch_counts()
    got = ops.tile_chain(U, V, X, width=width)
    want = ttc.tile_chain_plain(U, V, X, width=width)
    fault = ttc.tile_chain_plain(U, V, X, width=r - 1)
    atol = 1e-12 * float(want.abs().max())
    assert float((got - want).abs().max()) <= atol
    assert float((fault - want).abs().max()) > atol
    assert ops.launch_counts()["tile_chain"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,r,s,cfg", [
    (torch.float64, 128, 128, ttc.DMMA),    # sample_t's projection chains
    (torch.float64, 37, 17, ttc.DMMA),
    (torch.float64, 128, 16, ttc.NARROW),   # the W2 hoist
    (torch.float64, 129, 128, ttc.WIDE),    # r past the tensor-core kernel's W
    (torch.float64, 321, 128, ttc.NARROW),
    (torch.float32, 128, 128, ttc.WIDE),
    (torch.bfloat16, 128, 16, ttc.NARROW),
])
def test_cuda_tile_chain_config_by_shape(cuda_device, dtype, r, s, cfg):
    """tile_chain's kernel configuration comes from the shapes alone, as
    csrc/tile_chain.cu decides before any launch: the f64 tensor-core
    kernel for s > 16 and r <= 128, the FMA kernel otherwise."""
    assert ttc._config(dtype, r, s) == cfg


@pytest.mark.gpu
def test_cuda_tile_chain_rejects_a_width_too_large(cuda_device):
    """A width whose intermediate fits no configuration raises before any
    launch, and a launch with another configuration than the source's is
    refused."""
    with pytest.raises(ValueError, match="too large"):
        ttc._config(torch.float64, 1281, 128)
    x = torch.zeros((1, 8, 32), device=cuda_device, dtype=torch.float64)
    fn = build.entry("tile_chain", torch.float64)
    err = fn(x.data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(),
             1, 8, 32, 32, 32, ttc.WIDE, build.stream_handle(x))
    assert err != 0


@pytest.mark.gpu
def test_cuda_tile_chain_f64_eight_byte_copies(cuda_device):
    """The tensor-core path with 8-byte copies: U and V of odd row stride
    (127) and X one element past a 16-byte boundary."""
    T, b, ldr, s = 3, 100, 127, 128
    g = torch.Generator(device=cuda_device).manual_seed(3)

    def rnd(n):
        return torch.randn(n, generator=g, device=cuda_device,
                           dtype=torch.float64)

    U, V = rnd(T * b * ldr).view(T, b, ldr), rnd(T * b * ldr).view(T, b, ldr)
    X = rnd(T * b * s + 1)[1:].view(T, b, s)
    assert X.is_contiguous() and X.data_ptr() % 16 == 8
    got = ops.tile_chain(U, V, X)
    want = ttc.tile_chain_plain(U, V, X)
    fault = ttc.tile_chain_plain(U, V, X, width=ldr - 1)
    atol = 1e-12 * float(want.abs().max())
    assert float((got - want).abs().max()) <= atol
    assert float((fault - want).abs().max()) > atol


@pytest.mark.gpu
@pytest.mark.parametrize("s", [16, 17, 20])
@pytest.mark.parametrize("T,J", [(1, 1), (1, 62), (3, 5), (63, 30)])
def test_cuda_lr_sample_f64_tensor_cores(cuda_device, T, J, s):
    """On the card: the f64 tensor-core kernel of lr_sample against its
    plain version at b = 100 (not a multiple of its slices), 37 of 128
    factor columns by ``width=``, s = 16, 17 and 20 (one or two 16-column
    chunks), and J from 1 to 62 (one group of j, or partials added over
    several); the gate rejects the last j term dropped."""
    b, ldr, width = 100, 128, 37
    assert tlr._config(torch.float64, width, s) == tlr.DMMA
    g = torch.Generator(device=cuda_device).manual_seed(4)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device,
                           dtype=torch.float64)

    Ui, Vi, W2 = rnd(T, J, b, ldr), rnd(T, J, b, ldr), rnd(J, b, s)
    ops.reset_launch_counts()
    got = ops.lr_sample(Ui, Vi, W2, width=width)
    want = tlr.lr_sample_plain(Ui, Vi, W2, width=width)
    fault = tlr.lr_sample_plain(Ui[:, :-1].contiguous(),
                                Vi[:, :-1].contiguous(),
                                W2[:-1].contiguous(), width=width)
    atol = 1e-12 * float(want.abs().max())
    assert float((got - want).abs().max()) <= atol
    assert float((fault - want).abs().max()) > atol
    assert ops.launch_counts()["lr_sample"] == 1
    assert tlr.SHAPES == {(T, J): 1}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,r,cfg", [
    (torch.float64, 128, tlr.DMMA),     # the main path
    (torch.float64, 37, tlr.DMMA),
    (torch.float64, 129, tlr.FMA),      # r past the tensor-core kernel
    (torch.float32, 128, tlr.FMA),
    (torch.bfloat16, 128, tlr.FMA),
])
def test_cuda_lr_sample_config_by_shape(cuda_device, dtype, r, cfg):
    """lr_sample's kernel configuration comes from the shapes alone, as
    csrc/lr_sample.cu decides before any launch: the f64 tensor-core
    kernel for r <= 128, the FMA kernel otherwise."""
    assert tlr._config(dtype, r, 16) == cfg


@pytest.mark.gpu
def test_cuda_lr_sample_rejects_a_width_too_large(cuda_device):
    """A width whose intermediate fits no configuration raises before any
    launch, and a launch with another configuration than the source's is
    refused."""
    with pytest.raises(ValueError, match="too large"):
        tlr._config(torch.float64, 1281, 16)
    x = torch.zeros((1, 1, 8, 32), device=cuda_device, dtype=torch.float64)
    fn = build.entry("lr_sample", torch.float64)
    err = fn(x.data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(), None,
             1, 1, 8, 32, 32, 32, tlr.FMA, build.stream_handle(x))
    assert err != 0


@pytest.mark.gpu
def test_cuda_lr_sample_bitwise_deterministic(cuda_device):
    """Two calls on the same inputs give bitwise-equal Y, at a column bucket
    of the main path whose j is split into groups whose partials are added
    in a second pass (T = 8, J = 58, b = 512, r = 128, s = 16)."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    T, J, b, r, s = 8, 58, 512, 128, 16

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device,
                           dtype=torch.float64)

    Ui, Vi, W2 = rnd(T, J, b, r), rnd(T, J, b, r), rnd(J, b, s)
    assert build.query("lr_sample", "workspace", torch.float64,
                       T, J, b, r, s) > 0
    first = ops.lr_sample(Ui, Vi, W2)
    for _ in range(3):
        assert torch.equal(ops.lr_sample(Ui, Vi, W2), first)
    want = tlr.lr_sample_plain(Ui, Vi, W2)
    assert float((first - want).abs().max()) <= \
        1e-12 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("ldr,w2_offset", [(127, 0), (128, 1)])
def test_cuda_lr_sample_f64_eight_byte_copies(cuda_device, ldr, w2_offset):
    """The tensor-core path with 8-byte copies: U and V of odd row stride
    (127), or W2 one element past a 16-byte boundary."""
    T, J, b, s = 3, 5, 100, 16
    g = torch.Generator(device=cuda_device).manual_seed(6)

    def rnd(n):
        return torch.randn(n, generator=g, device=cuda_device,
                           dtype=torch.float64)

    Ui = rnd(T * J * b * ldr).view(T, J, b, ldr)
    Vi = rnd(T * J * b * ldr).view(T, J, b, ldr)
    W2 = rnd(J * b * s + w2_offset)[w2_offset:].view(J, b, s)
    assert W2.is_contiguous() and W2.data_ptr() % 16 == 8 * w2_offset
    got = ops.lr_sample(Ui, Vi, W2)
    want = tlr.lr_sample_plain(Ui, Vi, W2)
    fault = tlr.lr_sample_plain(Ui[:, :-1].contiguous(),
                                Vi[:, :-1].contiguous(), W2[:-1].contiguous())
    atol = 1e-12 * float(want.abs().max())
    assert float((got - want).abs().max()) <= atol
    assert float((fault - want).abs().max()) > atol


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
