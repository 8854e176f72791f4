"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``: skipped without a CUDA card. Imports neither jax nor repro,
so it runs on a machine without JAX:

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances as in tests/test_kernels.py (f64 1e-12, f32 1e-5, bf16 5e-2,
bf16 accumulating in f32), relative to the largest |plain output|; each
check must also reject a planted fault (one rank or one j term dropped).
The f64 paths of ``tile_chain`` with s > 16, of ``lr_sample`` and of
``batched_gemm`` have their own ragged cases: the tensor-core kernels (r <=
128, and for the two sampling kernels 128 < r <= 512) and the FMA kernels
past them; bitwise repeats and each kernel's configuration by shape;
``batched_gemm`` also with garbage past each rank.
The rounding kernels run in f64 and f32: ``batched_qr`` is held to the
same gate on Q and R, ``small_svd`` to ten times it on the sorted singular
values and on the reconstruction ``U diag(s) V^T`` (its U and V columns of
nearly equal singular values rotate freely under rounding; see
chip_smoke.py). The persistent ``small_svd`` kernel (m <= 128) has its own
cases: the plain version's rotations (unsorted factors elementwise), graded
R factors, exact zero columns, T = 1 / 133 / 2016, bitwise repeats and the
path by shape.
"""

import importlib.util
from pathlib import Path

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
    (160, None, 70, ttc.DMMA_WIDE), (160, 129, 70, ttc.DMMA_WIDE),
    (256, None, 70, ttc.DMMA_WIDE), (259, 256, 200, ttc.DMMA_WIDE),
    (512, 384, 70, ttc.DMMA_WIDE), (512, None, 33, ttc.DMMA_WIDE),
    (515, 512, 17, ttc.DMMA_WIDE), (640, 513, 70, ttc.NARROW),
])
def test_cuda_tile_chain_f64_tensor_cores(cuda_device, ldr, width, s, cfg):
    """On the card: the f64 paths of tile_chain with s > 16 against their
    plain version, at b = 100 (not a multiple of the slices). The r <= 128
    tensor-core kernel takes all 128 factor columns or 37 of them by
    ``width=``, at s = 17, 128 and 200 (two 128-column chunks); its
    clusters of two or four blocks (128 < r <= 512) widths 129, 160, 256,
    384 and 512 (odd row strides 259 and 515: 8-byte copies) at s from 17 to
    200; r = 513 goes past them, to the FMA kernel with 16-column chunks."""
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
    (torch.float64, 256, 16, ttc.NARROW),   # the W2 hoist past r = 128
    (torch.float64, 129, 128, ttc.DMMA_WIDE),   # W in shared memory
    (torch.float64, 321, 128, ttc.DMMA_WIDE),
    (torch.float64, 512, 17, ttc.DMMA_WIDE),
    (torch.float64, 513, 128, ttc.NARROW),  # past the tensor-core kernels
    (torch.float32, 128, 128, ttc.WIDE),
    (torch.float32, 256, 128, ttc.WIDE),
    (torch.bfloat16, 128, 16, ttc.NARROW),
])
def test_cuda_tile_chain_config_by_shape(cuda_device, dtype, r, s, cfg):
    """tile_chain's kernel configuration comes from the shapes alone, as
    csrc/tile_chain.cu decides before any launch: the f64 tensor-core
    kernels for s > 16 and r <= 128 or 128 < r <= 512, the FMA kernel
    otherwise."""
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
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("r", [129, 256, 384, 512])
def test_cuda_lr_sample_fma_widths(cuda_device, r, dtype):
    """On the card: lr_sample at factor widths past 128 (a left Cholesky
    whose L ranks pass 128, as the fractional-diffusion path's at eps 1e-4):
    f64 on the tensor-core kernel of 128 < r <= 512 (RMAX 256 and 512), f32
    on the FMA kernel; the gate rejects the last j term dropped."""
    T, J, b, s = 3, 4, 512, 16
    assert tlr._config(dtype, r, s) == (tlr.DMMA_WIDE if dtype == torch.float64
                                        else tlr.FMA)
    g = torch.Generator(device=cuda_device).manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device,
                           dtype=dtype)

    Ui, Vi, W2 = rnd(T, J, b, r), rnd(T, J, b, r), rnd(J, b, s)
    got = ops.lr_sample(Ui, Vi, W2)
    want = tlr.lr_sample_plain(Ui, Vi, W2)
    fault = tlr.lr_sample_plain(Ui[:, :-1].contiguous(),
                                Vi[:, :-1].contiguous(),
                                W2[:-1].contiguous())
    atol = (1e-12 if dtype == torch.float64 else 1e-5) * float(
        want.abs().max())
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
    assert tlr.SHAPES == {(T, J, width): 1}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,r,cfg", [
    (torch.float64, 128, tlr.DMMA),     # the main path
    (torch.float64, 37, tlr.DMMA),
    (torch.float64, 129, tlr.DMMA_WIDE),    # r past 128
    (torch.float64, 512, tlr.DMMA_WIDE),
    (torch.float64, 513, tlr.FMA),      # r past the tensor-core kernels
    (torch.float32, 128, tlr.FMA),
    (torch.float32, 256, tlr.FMA),
    (torch.bfloat16, 128, tlr.FMA),
])
def test_cuda_lr_sample_config_by_shape(cuda_device, dtype, r, cfg):
    """lr_sample's kernel configuration comes from the shapes alone, as
    csrc/lr_sample.cu decides before any launch: the f64 tensor-core
    kernels for r <= 128 and 128 < r <= 512, the FMA kernel otherwise."""
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
@pytest.mark.parametrize("T,J,b,ldr,width,s", [
    (1, 1, 100, 160, 129, 16), (3, 5, 100, 256, None, 20),
    (63, 2, 500, 259, 256, 17), (2, 30, 300, 512, 384, 33),
    (4, 3, 1000, 515, 512, 16), (8, 26, 512, 512, None, 16),
])
def test_cuda_lr_sample_f64_tensor_cores_wide(cuda_device, T, J, b, ldr,
                                              width, s):
    """On the card: the f64 tensor-core kernel of lr_sample past r = 128
    against its plain version at widths 129, 256, 384 and 512: ragged b
    (100, 300, 500; 1000, two 512-row blocks), s = 16, 17, 20 and 33 (one to
    three 16-column chunks), ``width=`` slices of wider rows (odd strides 259
    and 515: 8-byte copies), J from 1 to 30 (one group of j, or partials
    added over several); the gate rejects the last j term dropped."""
    r = ldr if width is None else width
    assert tlr._config(torch.float64, r, s) == tlr.DMMA_WIDE
    g = torch.Generator(device=cuda_device).manual_seed(7)

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
    assert tlr.SHAPES == {(T, J, r): 1}


@pytest.mark.gpu
@pytest.mark.parametrize("r", [256, 512])
def test_cuda_lr_sample_wide_bitwise_deterministic(cuda_device, r):
    """Two calls of the tensor-core kernel past r = 128 give bitwise-equal
    Y, at a column bucket of the fractional-diffusion path whose j is split
    into groups whose partials are added in a second pass (T = 8, J = 26,
    b = 512, s = 16)."""
    g = torch.Generator(device=cuda_device).manual_seed(8)
    T, J, b, s = 8, 26, 512, 16

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device,
                           dtype=torch.float64)

    Ui, Vi, W2 = rnd(T, J, b, r), rnd(T, J, b, r), rnd(J, b, s)
    assert tlr._config(torch.float64, r, s) == tlr.DMMA_WIDE
    assert build.query("lr_sample", "workspace", torch.float64,
                       T, J, b, r, s) > 0
    first = ops.lr_sample(Ui, Vi, W2)
    for _ in range(3):
        assert torch.equal(ops.lr_sample(Ui, Vi, W2), first)
    want = tlr.lr_sample_plain(Ui, Vi, W2)
    assert float((first - want).abs().max()) <= \
        1e-12 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("r", [256, 512])
def test_cuda_tile_chain_wide_bitwise_deterministic(cuda_device, r):
    """Two calls of tile_chain's tensor-core kernel past r = 128 give
    bitwise-equal output (its clusters add their partial outputs in a fixed
    order), at the fractional-diffusion path's projection chains (T = 112,
    b = 512, s = 256)."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    T, b, s = 112, 512, 256

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device,
                           dtype=torch.float64)

    U, V, X = rnd(T, b, r), rnd(T, b, r), rnd(T, b, s)
    assert ttc._config(torch.float64, r, s) == ttc.DMMA_WIDE
    first = ops.tile_chain(U, V, X)
    for _ in range(3):
        assert torch.equal(ops.tile_chain(U, V, X), first)
    want = ttc.tile_chain_plain(U, V, X)
    assert float((first - want).abs().max()) <= \
        1e-12 * float(want.abs().max())


# batched_gemm's shapes on the ported paths, (T, m, k, n): the left
# factorization's sample and sample_t, the right driver's flush densify and
# truncation and its trailing SYRK.
GEMM_SHAPES = {"sample": (63, 512, 128, 16), "sample_t": (63, 512, 128, 128),
               "flush densify": (2016, 128, 384, 128),
               "truncation": (2016, 128, 128, 128),
               "SYRK": (1953, 128, 128, 128)}
GEMM_TOL = {torch.float64: 1e-12, torch.float32: 1e-5, torch.bfloat16: 5e-2}


def _gemm_inputs(T, m, k, n, ranks, dtype, device, seed, offset=0):
    """A (T, m, k) and B (T, k, n), B scaled by 1/sqrt(k), with +-1e6 in A's
    columns and B's rows past each rank (the kernel must never read them);
    ``offset`` starts both one element past a 16-byte boundary."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        x = torch.randn(shape[0] * shape[1] * shape[2] + offset, generator=g,
                        device=device, dtype=torch.float64)
        return x[offset:].view(shape)

    dead = torch.arange(k, device=device)[None, :] >= ranks[:, None]
    A = rnd(T, m, k).masked_fill_(dead[:, None, :], 1e6)
    B = rnd(T, k, n).div_(k ** 0.5).masked_fill_(dead[:, :, None], -1e6)
    if dtype != torch.float64:
        A, B = A.to(dtype), B.to(dtype)
    return A, B


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(GEMM_SHAPES))
def test_cuda_batched_gemm_config_by_shape(cuda_device, shape, dtype):
    """batched_gemm's configuration comes from the dtype and n alone, as
    csrc/batched_gemm.cu decides before any launch: the f64 tensor-core
    kernel (16-wide tiles for n <= 16, 128-wide otherwise) at every shape
    of the ported paths, the FMA kernel in f32 and bf16."""
    n = GEMM_SHAPES[shape][3]
    want = {torch.float64: (tbg.DMMA_NARROW, tbg.DMMA_WIDE)}.get(
        dtype, (tbg.NARROW, tbg.WIDE))[n > 16]
    assert tbg._config(dtype, n) == want


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("T,m,k,n", [
    (4, 40, 27, 20),     # odd k: 8-byte copies; ragged m and n
    (5, 96, 24, 20),
    (3, 200, 128, 16),   # narrow tiles, two 128-row chunks
    (3, 33, 17, 5),      # narrow tiles, odd k and n
    (3, 130, 384, 128),  # the flush densify's depth, a ragged row chunk
    (2, 128, 128, 129),  # two column chunks, odd n
    (2, 300, 40, 136),
])
def test_cuda_batched_gemm_masked_ranks(cuda_device, T, m, k, n, dtype):
    """On the card, small T: batched_gemm against its plain version on
    ragged shapes with garbage (+-1e6) past each rank and ranks 0, k, above
    k, negative and between; a rank-0 tile gives exact zeros, the gate
    rejects one rank dropped, and two calls are bitwise equal."""
    ranks = torch.tensor([0, k, k + 5, -3, k // 2 + 1][:T] + [0] * (T - 5),
                         dtype=torch.int32, device=cuda_device)
    A, B = _gemm_inputs(T, m, k, n, ranks, dtype, cuda_device, 7)
    ops.reset_launch_counts()
    got = ops.batched_gemm(A, B, ranks)
    want = tbg.batched_gemm_plain(A, B, ranks)
    fault = tbg.batched_gemm_plain(A, B, (ranks - 1).clamp(min=0))
    atol = GEMM_TOL[dtype] * float(want.double().abs().max())
    assert float((got.double() - want.double()).abs().max()) <= atol
    assert float((fault.double() - want.double()).abs().max()) > atol
    assert (got[ranks <= 0] == 0).all()
    assert torch.equal(tbg.batched_gemm_cuda(A, B, ranks), got)
    assert ops.launch_counts()["batched_gemm"] == 2
    assert tbg.SHAPES == {(T, m, k, n): 2}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["sample", "flush densify"])
def test_cuda_batched_gemm_f64_eight_byte_copies(cuda_device, shape):
    """The tensor-core paths with 8-byte copies: A and B one element past a
    16-byte boundary, at a path's shape (T cut to 5)."""
    _, m, k, n = GEMM_SHAPES[shape]
    ranks = torch.tensor([k, 1, 13, 0, k - 1], dtype=torch.int32,
                         device=cuda_device)
    A, B = _gemm_inputs(5, m, k, n, ranks, torch.float64, cuda_device, 8,
                        offset=1)
    assert A.data_ptr() % 16 == 8 and B.data_ptr() % 16 == 8
    got = tbg.batched_gemm_cuda(A, B, ranks)
    want = tbg.batched_gemm_plain(A, B, ranks)
    atol = 1e-12 * float(want.abs().max())
    assert float((got - want).abs().max()) <= atol
    assert torch.equal(tbg.batched_gemm_cuda(A, B, ranks), got)


@pytest.mark.gpu
def test_cuda_batched_gemm_rejects_a_mismatched_config(cuda_device):
    """A launch with another configuration than the source's for its dtype
    and n is refused: the FMA kernels in f64, the tensor-core kernel of the
    other width, or any tensor-core kernel in f32."""
    x = torch.zeros((1, 32, 32), device=cuda_device, dtype=torch.float64)
    r = torch.ones(1, device=cuda_device, dtype=torch.int32)
    fn = build.entry("batched_gemm", torch.float64)
    for n, cfg in ((32, tbg.WIDE), (32, tbg.DMMA_NARROW), (16, tbg.NARROW),
                   (16, tbg.DMMA_WIDE)):
        assert fn(x.data_ptr(), x.data_ptr(), r.data_ptr(), x.data_ptr(),
                  1, 32, 32, n, cfg, build.stream_handle(x)) != 0
    x32 = x.float()
    fn = build.entry("batched_gemm", torch.float32)
    assert fn(x32.data_ptr(), x32.data_ptr(), r.data_ptr(), x32.data_ptr(),
              1, 32, 32, 32, tbg.DMMA_WIDE, build.stream_handle(x32)) != 0
    assert fn(x32.data_ptr(), x32.data_ptr(), r.data_ptr(), x32.data_ptr(),
              1, 32, 32, 32, tbg.WIDE, build.stream_handle(x32)) == 0


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


# -- small_svd: the persistent shared-memory kernel (m <= 128) ---------------

SVD_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# Unsorted s, U and V against the plain version, elementwise after matching
# column signs (the values of chip_smoke.SAME_ROTATIONS_ATOL: a swap of two
# converged columns takes the sign of a rounding-level gamma).
SAME_ROTATIONS_ATOL = {torch.float64: 1e-10, torch.float32: 2e-4}


def _svd_close(M, got, want, tol):
    """The smoke's gate: sorted s and U diag(s) V^T within 10 tol times
    the largest |s| and |M|."""
    (U, s, V), (Up, sp, Vp) = got, want

    def rec(U, s, V):
        return (U * s[:, None, :]) @ V.transpose(1, 2)

    s_err = float((s.sort(dim=-1).values
                   - sp.sort(dim=-1).values).abs().max())
    r_err = float((rec(U, s, V) - rec(Up, sp, Vp)).abs().max())
    return (s_err <= 10 * tol * float(sp.abs().max())
            and r_err <= 10 * tol * float(M.abs().max()))


def _check_svd(M, tol):
    """Kernel against plain version; the planted fault (seven of the
    eight sweeps dropped) must fail the same gate."""
    got = tsvd.small_svd_cuda(M)
    assert _svd_close(M, got, tsvd.small_svd_plain(M), tol)
    assert not _svd_close(M, tsvd.small_svd_plain(M, sweeps=1),
                          tsvd.small_svd_plain(M), tol)
    return got


def _rand_cores(T, n, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn((T, n, n), generator=g, device=device,
                        dtype=torch.float64) / n ** 0.5).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_small_svd_same_rotations(cuda_device, dtype):
    """The kernel runs the plain version's rotations: on a well-separated
    spectrum (singular values 3 .. 0.1, 0.023 apart) the unsorted s, U and
    V agree elementwise once each column pair has the sign that makes V's
    largest entry positive."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    n = 128
    Qa, Qb = (torch.linalg.qr(torch.randn((4, n, n), generator=g,
                                          device=cuda_device,
                                          dtype=torch.float64)).Q
              for _ in range(2))
    sig = torch.linspace(3.0, 0.1, n, device=cuda_device, dtype=torch.float64)
    M = ((Qa * sig) @ Qb).to(dtype)

    def canonical(out):
        U, s, V = out
        top = V.abs().argmax(dim=1, keepdim=True)
        sign = torch.sign(torch.take_along_dim(V, top, dim=1))
        return s, U * sign, V * sign

    atol = SAME_ROTATIONS_ATOL[dtype]
    want = canonical(tsvd.small_svd_plain(M))
    got = canonical(tsvd.small_svd_cuda(M))
    fault = canonical(tsvd.small_svd_plain(M, sweeps=1))
    assert all(float((a - b).abs().max()) <= atol for a, b in zip(got, want))
    assert float((fault[0] - want[0]).abs().max()) > atol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_small_svd_graded_r(cuda_device, dtype):
    """Graded upper-triangular input, as the right-looking driver gives
    it: R of ``batched_qr`` of exponential-covariance tiles between two
    clusters of 128 points (singular values falling to rounding level).
    The gate holds, and the ranks at 1e-6 of the largest value agree."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    pa = torch.rand((8, 128, 2), generator=g, device=cuda_device,
                    dtype=torch.float64) * 0.5
    pb = pa.new_empty(pa.shape).uniform_(0.5, 1.0, generator=g)
    K = torch.exp(-torch.cdist(pa, pb) / 0.1).to(dtype).contiguous()
    _, R = tqr.batched_qr(K)
    R = R.contiguous()
    U, s, V = _check_svd(R, SVD_TOL[dtype])
    _, sp, _ = tsvd.small_svd_plain(R)
    ranks = (s > 1e-6 * s.amax(dim=1, keepdim=True)).sum(dim=1)
    ranks_p = (sp > 1e-6 * sp.amax(dim=1, keepdim=True)).sum(dim=1)
    assert torch.equal(ranks, ranks_p)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_small_svd_skip_rule(cuda_device, dtype):
    """Exact zero columns: every rotation with one is skipped (|gamma| <=
    tiny), so its singular value and U column are exactly 0 and its V
    column stays the unit vector, as in the plain version."""
    M = _rand_cores(3, 128, dtype, cuda_device, 7)
    M[:, :, 5] = 0.0
    M[:, :, 77] = 0.0
    M[1, :, 0] = 0.0
    U, s, V = _check_svd(M, SVD_TOL[dtype])
    Up, sp, Vp = tsvd.small_svd_plain(M)
    for t, j in ((0, 5), (1, 77), (2, 5), (1, 0)):
        assert float(s[t, j]) == 0.0 and float(sp[t, j]) == 0.0
        assert float(U[t, :, j].abs().max()) == 0.0
        e = torch.zeros(128, dtype=dtype, device=cuda_device)
        e[j] = 1.0
        assert torch.equal(V[t, :, j], e) and torch.equal(Vp[t, :, j], e)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 133, 2016])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_small_svd_persistent_loop(cuda_device, T, dtype):
    """One tile, one tile more than the card's SMs, and the headline's
    2016 tiles; the rotation logs scale with the grid, not with T."""
    M = _rand_cores(T, 128, dtype, cuda_device, 8)
    _check_svd(M, SVD_TOL[dtype])
    per_tile = 2 * 8 * 128 * 127 // 2  # (c, s) words of a tile's log
    words = build.query("small_svd", "workspace", dtype, T, 128, 128, 8)
    slots = build.query("small_svd", "workspace", dtype, 8064, 128, 128,
                        8) // per_tile  # the grid: resident blocks x SMs
    assert words == per_tile * min(T, slots)
    assert slots < 2016


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_small_svd_repeatable(cuda_device, dtype):
    """Two calls on the same cores are bitwise equal."""
    M = _rand_cores(133, 128, dtype, cuda_device, 9)
    a, b = tsvd.small_svd_cuda(M), tsvd.small_svd_cuda(M)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_cuda_small_svd_path_by_shape(cuda_device):
    """The source's choice, as the workspace it asks for shows it: the
    persistent kernel's rotation logs for m <= 128, none for the first
    design with A in shared memory while m n words fit in 200 KB, else a
    device scratch of m n words a tile."""
    def words(dtype, m, n):
        return build.query("small_svd", "workspace", dtype, 3, m, n, 8)
    for dtype, m, n in ((torch.float64, 128, 128), (torch.float32, 128, 128),
                        (torch.float64, 20, 13)):
        assert words(dtype, m, n) == 3 * 2 * 8 * n * (n - 1) // 2
    for dtype, m, n in ((torch.float64, 200, 100), (torch.float32, 200, 150)):
        assert words(dtype, m, n) == 0
    for dtype, m, n in ((torch.float64, 200, 150), (torch.float64, 300, 200)):
        assert words(dtype, m, n) == 3 * m * n


# -- batched_qr: the blocked kernels (b <= 512, r <= 128) --------------------

QR_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _qr_inputs(T, b, r, dtype, device, seed, shift=0.0):
    """Random (T, b, r) panels with columns of norm ~1, plus shift * I
    (a square panel's Q is then well conditioned); tile 0 gets a dead
    column (column 3 = 2 column 1 - column 0)."""
    g = torch.Generator(device=device).manual_seed(seed)
    Y = torch.randn((T, b, r), generator=g, device=device,
                    dtype=torch.float64) / b ** 0.5
    if shift:
        Y += shift * torch.eye(b, r, device=device, dtype=Y.dtype)
    Y[0, :, 3] = 2.0 * Y[0, :, 1] - Y[0, :, 0]
    return Y.to(dtype)


def _qr_close(got, want, tol):
    """Q and R each within tol times the largest |plain entry|."""
    return all(float((x.double() - w.double()).abs().max())
               <= tol * float(w.double().abs().max())
               for x, w in zip(got, want))


def _qr_fault(Y):
    """The plain version with the last column dropped: the gate must
    reject it."""
    Yf = Y.clone()
    Yf[:, :, -1] = 0.0
    return tqr.batched_qr_plain(Yf)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("T,b,r,shift,cfg", [
    (1, 128, 128, 3.0, tqr.SMEM), (63, 128, 128, 3.0, tqr.SMEM),
    (133, 128, 128, 3.0, tqr.SMEM), (2016, 128, 128, 3.0, tqr.SMEM),
    (4, 512, 128, 0.0, tqr.STREAM), (2, 300, 37, 0.0, tqr.STREAM),
])
def test_cuda_batched_qr_blocked(cuda_device, T, b, r, shift, cfg, dtype):
    """The blocked kernels against the plain MGS2, Q and R elementwise:
    the right driver's (T, 128, 128) densified tiles at one tile, a panel
    rounding's 63, one tile more than the card's SMs and a flush's 2016
    (+3I); op.round's b = 512 factor stacks; ragged b and odd r (one-word
    copies). The dead column comes out exactly zero, and the
    planted fault (the last column dropped) is rejected."""
    assert build.query("batched_qr", "config", dtype, b, r) == cfg
    assert build.query("batched_qr", "scratch", dtype, b, r) == 0
    Y = _qr_inputs(T, b, r, dtype, cuda_device, 10, shift)
    ops.reset_launch_counts()
    got = ops.batched_qr(Y)
    want = tqr.batched_qr_plain(Y)
    assert ops.launch_counts()["batched_qr"] == 1
    assert tqr.SHAPES == {(T, b, r): 1}
    assert float(got[0][0, :, 3].abs().max()) == 0.0
    assert _qr_close(got, want, QR_TOL[dtype])
    assert not _qr_close(_qr_fault(Y), want, QR_TOL[dtype])


def _graded_tiles(T, dtype, device, seed):
    """(T, 128, 128) exponential-covariance tiles between two clusters of
    128 points (l = 0.1), as the right-looking driver densifies them:
    singular values falling from ~10 to rounding level, about a quarter of
    the columns live at the drop tolerance."""
    g = torch.Generator(device=device).manual_seed(seed)
    pa = torch.rand((T, 128, 2), generator=g, device=device,
                    dtype=torch.float64) * 0.5
    pb = pa.new_empty(pa.shape).uniform_(0.5, 1.0, generator=g)
    return torch.exp(-torch.cdist(pa, pb) / 0.1).to(dtype).contiguous()


def _smoke():
    """chip_smoke.py, for its QR contract gate (``qr_graded_gate``)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_batched_qr_graded_contract(cuda_device, dtype):
    """On graded tiles Q elementwise is no gate for any summation order
    (reordering the plain version's rows moves Q by 1e-8 in f64), so the
    kernel is held to the QR contract of chip_smoke.qr_graded_gate: the
    same dead columns but for columns at the cut, R within max(tol, 10x
    the plain version's row-permutation spread) per tile, and the
    reconstruction and orthogonality errors within 10x the plain
    version's; the planted fault (the last column dropped) fails it."""
    Y = _graded_tiles(2016, dtype, cuda_device, 11)
    gate = _smoke().qr_graded_gate(Y, QR_TOL[dtype])
    want = tqr.batched_qr_plain(Y)
    ok, info = gate(tqr.batched_qr_cuda(Y), want)
    assert ok, info
    assert 0 < info["live"] < info["columns"]
    assert not gate(_qr_fault(Y), want)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("b", [128, 512])
def test_cuda_batched_qr_repeatable(cuda_device, b, dtype):
    """Two calls on the same panels are bitwise equal."""
    Y = _qr_inputs(133, b, 128, dtype, cuda_device, 12, 3.0 if b == 128 else 0.0)
    a, c = tqr.batched_qr_cuda(Y), tqr.batched_qr_cuda(Y)
    assert torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])


@pytest.mark.gpu
def test_cuda_batched_qr_config_by_shape(cuda_device):
    """The source's choice: the shared-memory kernel for b <= 128, the
    streaming kernel for 128 < b <= 512 with r <= 128, the first design
    (with its device scratch where its panel does not fit) otherwise."""
    for dtype in (torch.float64, torch.float32):
        def cfg(b, r):
            return build.query("batched_qr", "config", dtype, b, r)
        assert cfg(128, 128) == cfg(96, 24) == cfg(16, 1) == tqr.SMEM
        assert cfg(512, 128) == cfg(129, 128) == cfg(300, 37) == tqr.STREAM
        assert cfg(512, 129) == cfg(1024, 40) == cfg(513, 16) == tqr.FIRST
    assert build.query("batched_qr", "scratch", torch.float64, 1024, 40) \
        == 1024 * 40


@pytest.mark.gpu
def test_cuda_tlr_newton_solve_matches_cpu(cuda_device):
    """TLR-KFAC's curvature factor at n = 128, tile 32 (the TLR branch of
    ``_make_solver``) on the card: its solve agrees with the CPU's at 1e-4
    relative (each factor is accurate to eps_tlr = 1e-6 on a curvature of
    condition ~1e4; the card's ARA probes differ from the CPU's), and the
    factorization launched the three sampling kernels."""
    from repro_torch.optim import AdamWConfig, TLRNewtonConfig
    from repro_torch.optim import tlr_newton_init, tlr_newton_update

    g = torch.Generator().manual_seed(1)
    n = 128
    U, _ = torch.linalg.qr(torch.randn(n, n, generator=g,
                                       dtype=torch.float64))
    cov = (U * torch.logspace(0, -2, n, dtype=torch.float64)) @ U.T
    X = torch.randn(512, n, generator=g, dtype=torch.float64) @ cov
    G = torch.randn(n, n, generator=g, dtype=torch.float64)
    B = torch.randn(n, 3, generator=g, dtype=torch.float64)
    ncfg = TLRNewtonConfig(tile=32, beta=0.0,
                           grafting=AdamWConfig(lr=3e-2, weight_decay=0.0))
    out = {}
    for dev in ("cpu", cuda_device):
        params = {"w": torch.zeros((n, n), dtype=torch.float64, device=dev)}
        ops.reset_launch_counts()
        new, st = tlr_newton_update({"w": G.to(dev)},
                                    tlr_newton_init(params, ncfg), params,
                                    ncfg, curvature={"w": (X.to(dev), None)})
        solve = st.facts["w"]["A"]
        assert solve.__self__.L.nb == n // 32
        out[str(dev)] = (solve(B.to(dev)).cpu(), new["w"].cpu(),
                         ops.launch_counts())
    (x_cpu, w_cpu, _), (x_gpu, w_gpu, launches) = out.values()
    assert float((x_gpu - x_cpu).abs().max() / x_cpu.abs().max()) <= 1e-4
    assert float((w_gpu - w_cpu).abs().max() / w_cpu.abs().max()) <= 1e-4
    for name in ("lr_sample", "tile_chain", "batched_gemm"):
        assert launches[name] > 0, launches
