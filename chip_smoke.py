#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, then
drives three paths, each with the kernels' launch counts set to 0 just
before it and read just after:

1. the main path at full width: a 2-D exponential covariance (N = 32768,
   tile 512) built on the card, ``TLROperator.compress`` (batched SVD, no
   rank may reach r_max) -> ``cholesky`` (left-looking dynamic ARA) ->
   solve / logdet / sample / matvec, gated on the randomized factor
   residual ``||K z - L (L^T z)|| / ||K z|| <= 100 eps``; it also times the
   batched SVD of one tile column by each cuSOLVER driver;
2. the rounding pass on the same operator: ``op.round(1e-6)`` (batched QR
   of the factors, SVD of the cores), gated on no rank rising and the
   rounded matvec within 1e-5 of ``K x``;
3. the right-looking driver: the same covariance at N = 8192, tile 128,
   ``cholesky`` and ``ldlt`` with ``algo="right"``, gated on the same
   residual and finite solves; it logs ``small_svd``'s launches per
   (T, m, n), ``batched_qr``'s per (T, b, r) and ``batched_gemm``'s per
   (T, m, k, n) with their mean live rank and, timed apart, launches x
   kernel ms against the bound per shape (the main and round paths log
   their launches per shape too).

Then it holds each kernel against its plain PyTorch version on the card
(f64, f32 and bf16; f64 and f32 for the QR and SVD) at the paths' shapes
(``lr_sample`` at each of the main path's column buckets, ``batched_gemm``
at the right driver's and the rounding pass's shapes and with garbage past
each rank, ``small_svd`` and
``batched_qr`` at the right driver's panel shapes, ``small_svd`` on a
spectrum whose unsorted factors must match the plain version's rotations,
``batched_qr`` on graded tiles like the right driver's densified ones under
the QR contract), checks that each gate rejects a planted fault and that
two kernel calls agree bit for bit, and checks a small end-to-end run on
the card against the same run on the CPU. Kernel times are CUDA events
over back-to-back calls; a sampling kernel's case under DISPATCH_MS is
also timed from a CUDA graph (``graph_ms`` and its kin beside ``ms``),
since the host's dispatch sets the pace of back-to-back calls there.

Run from the root of a checkout:  python3 chip_smoke.py
(``--n`` cuts the main path's size for a quick look;
``--profile DIR`` adds torch.profiler tables of the left-looking and the
right-looking Cholesky.)

Exits non-zero, printing no result, without a CUDA card or outside a
checkout. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): FP64 tensor core 67 TFLOP/s,
# FP32 67 TFLOP/s outside the tensor cores (TF32 is off), BF16 989 TFLOP/s;
# HBM3 3.35 TB/s.
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
# The main path's configuration: tile 512, compression at eps 1e-8 with
# ranks up to R_MAX, factorization at EPS.
TILE, R_MAX, EPS = 512, 128, 1e-6
# The right-looking path's configuration: N = 8192 at tile 128 (the
# right-looking benchmark's, benchmarks/bench_tlr.py:312; nb = 64, the main
# path's 2016 tiles), r_max 128, same eps.
N_RIGHT, TILE_RIGHT = 8192, 128
# Kernel against plain version: max abs error <= TOL * max |plain output|
# (the tolerances of tests/test_kernels.py, relative to the output's scale),
# for every output of the kernel. small_svd is held at TOL_SCALE = 10 times
# that on its sorted singular values and its reconstruction U diag(s) V^T:
# 8 sweeps of rotations, each rounded, sit between input and output, and
# tests/test_kernels.py gives the SVD 100 times the kernel tolerance.
TOL = {"float64": 1e-12, "float32": 1e-5, "bfloat16": 5e-2}
TOL_SCALE = {"small_svd": 10.0}
# small_svd's "same rotations" case: unsorted s, U and V elementwise against
# the plain version, whose rotation sequence the kernel keeps, after each
# column pair of U and V is given the sign that makes V's largest entry
# positive: a rotation of two converged columns with alpha < beta swaps
# them, taking the sign of a rounding-level gamma (the plain version on the
# CPU and on the card differ so in 2 of 512 f64 columns of one input, and
# in about 30 % of f32 columns). On the CPU, reordering M's rows (which changes
# only the dot products' summation order) moves the matched factors by
# 4e-14 in f64 and 2.4e-5 in f32.
SAME_ROTATIONS_ATOL = {"float64": 1e-10, "float32": 2e-4}
SAME_ROTATIONS = "same rotations T=4 m=128 n=128"
# batched_qr's graded case: on such tiles Q elementwise is no gate for any
# summation order, nor R at 1e-12 (the plain version with Y's rows permuted
# moves R by 4.7e-12 per tile, relative, at T = 2016 in f64 on an NVIDIA
# H100 80GB HBM3), so it is held to the QR contract (``qr_graded_gate``).
QR_GRADED = "right densified graded T=2016 b=128 r=128"
# Cases held to an absolute tolerance per dtype name, in place of the
# gate's relative one: (kernel, shape label) -> {dtype name: atol}.
CASE_ATOL = {("small_svd", SAME_ROTATIONS): SAME_ROTATIONS_ATOL}
KERNELS = ("batched_gemm", "tile_chain", "lr_sample", "batched_qr",
           "small_svd")
# Below DISPATCH_MS a sampling kernel's mean over back-to-back calls
# (``event_ms``) is the host's dispatch rate, not the kernel: such cases are
# also timed as GRAPH_CALLS calls replayed from a CUDA graph (``graph_ms``).
DISPATCH_MS, GRAPH_CALLS = 0.1, 50
MAIN_KERNELS = ("batched_gemm", "tile_chain", "lr_sample")
ROUND_KERNELS = ("batched_gemm", "batched_qr", "small_svd")
REPLACES = {
    "batched_gemm": "src/repro/kernels/batched_gemm.py:41",
    "tile_chain": "src/repro/kernels/tlr_matvec.py:35",
    "lr_sample": "src/repro/kernels/lr_sample.py:57",
    "batched_qr": "src/repro/kernels/batched_qr.py:68",
    "small_svd": "src/repro/kernels/small_svd.py:70",
}
SOURCES = {name: f"src/repro_torch/kernels/csrc/{name}.cu"
           for name in KERNELS}
# The (T, J) shapes of the main path's lr_sample calls: the left-looking
# factorization's column buckets, _column_buckets(64, k, _bucket_ladder(63)) for k < 63
# (src/repro_torch/core/buckets.py; tests/test_torch_kernels.py checks it).
LR_BUCKETS = ((63, 30), (32, 46), (16, 54), (8, 58), (4, 60), (2, 61),
              (1, 62))


def log(msg: str) -> None:
    print(msg, flush=True)


def sync_time(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def graph_ms(fn, replays: int = 5) -> float:
    """Mean device time of ``fn`` with the host's dispatch taken out:
    GRAPH_CALLS calls captured in one CUDA graph (after two warm calls on
    the capturing stream), the graph replayed ``replays`` times between
    CUDA events. Inputs stay in L2 from one call to the next when they
    fit."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (GRAPH_CALLS * replays)
    del graph
    return ms


def event_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# -- phase 1/2: device and build ---------------------------------------------------


def device_line() -> dict:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    dev = {"name": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "nvidia_smi": smi}
    log(f"device: {dev['name']} x{dev['count']}")
    return dev


def build_kernels() -> None:
    from repro_torch.kernels import build
    info = build.build_all()
    log(f"build: {info['seconds']:.1f} s for {info['built'] or 'nothing'} "
        f"(cached libraries reused otherwise)")
    for name, text in info["ptxas"].items():
        regs = [int(w.split()[0]) for w in text.split("Used")[1:]]
        spills = [int(line.split("bytes spill stores")[0].split(",")[-1])
                  for line in text.splitlines() if "spill stores" in line]
        log(f"  ptxas {name}: {len(regs)} kernels, registers "
            f"{min(regs, default=0)}-{max(regs, default=0)}, "
            f"spill stores max {max(spills, default=0)} B")
        if name in ("small_svd", "batched_qr"):
            # each kernel: its entry, then registers and spills
            for line in text.splitlines():
                if "Compiling entry" in line or "spill stores" in line \
                        or "Used" in line:
                    log(f"    {line.strip()}")


# -- phase 3: kernels against their plain versions ------------------------------------


def kernel_cases(torch, ranks_a, device="cuda"):
    """(name, shape label, headline, make(dtype) -> (kernel, plain, fault,
    library, bytes_needed, flops_needed, post[, gate])) at the paths' shapes
    (``CASE_ATOL`` gives some cases an absolute tolerance; a case with its
    own ``gate(out, want) -> (ok, info)`` is held to that instead).

    Main path: N=32768, tile 512, r_max 128, bs 16 (``lr_sample`` at each
    (T, J) column bucket of ``LR_BUCKETS``); ``ranks_a`` are the A-tile
    ranks the main path's first column gives ``batched_gemm``. Rounding pass on that operator:
    ``batched_qr`` of (2016, 512, 128) factor panels, ``small_svd`` of
    (2016, 128, 128) cores. Right-looking path (tile 128): ``batched_qr``
    and ``small_svd`` of (T <= 2016, 128, 128) densified tiles, (63, 128,
    128) and (1, 128, 128) at a panel rounding. Inputs are
    scaled so that outputs are O(1); the square QR inputs are shifted by
    3 I so that Q is well conditioned (a random square panel's Q moves by
    cond x rounding); ``QR_GRADED`` takes graded covariance tiles under
    the QR contract instead. ``fault`` is the plain version with one rank
    (``batched_gemm``), one factor column (``tile_chain``: ``width`` one
    less), the last j term (``lr_sample``), the
    last column (``batched_qr``) or seven of the eight sweeps
    (``small_svd``) dropped: a result the gate must reject. The
    "same rotations" case holds the unsorted s, U and V of a well-separated
    spectrum elementwise, column signs matched as ``SAME_ROTATIONS_ATOL``
    says. ``post`` maps a
    raw result to the outputs that are gated (None: the result itself);
    timing runs the raw calls. ``headline`` marks the shape that takes most
    of the kernel's time on its path; its numbers go into the kernels
    line."""
    g = torch.Generator(device=device).manual_seed(0)
    from repro_torch.kernels import batched_gemm as bg
    from repro_torch.kernels import batched_qr as qr
    from repro_torch.kernels import lr_sample as lr
    from repro_torch.kernels import small_svd as svd
    from repro_torch.kernels import tlr_matvec as tc

    def randn(shape, dtype, scale=1.0):
        x = torch.randn(shape, generator=g, device=device,
                        dtype=torch.float32) * scale
        return x.to(dtype)

    def bgemm(m, k, n, ranks, garbage=False):
        # garbage: A's columns and B's rows past each rank hold +-1e6, which
        # the plain version masks by multiplication and the kernel must
        # never read
        def make(dtype):
            T = ranks.shape[0]
            A = randn((T, m, k), dtype)
            B = randn((T, k, n), dtype, 1 / math.sqrt(k))
            if garbage:
                dead = (torch.arange(k, device=device)[None, :]
                        >= ranks[:, None])
                A = A.masked_fill(dead[:, None, :], 1e6)
                B = B.masked_fill(dead[:, :, None], -1e6)
            rs = int(ranks.clamp(0, k).sum())
            isz = A.element_size()
            mask = (torch.arange(k, device=device)[None, :]
                    < ranks[:, None]).to(dtype)
            return (lambda: bg.batched_gemm_cuda(A, B, ranks),
                    lambda: bg.batched_gemm_plain(A, B, ranks),
                    lambda: bg.batched_gemm_plain(A, B, (ranks - 1).clamp(0)),
                    lambda: torch.einsum("tmk,tk,tkn->tmn", A, mask, B),
                    (m * rs + n * rs + T * m * n) * isz + 4 * T,
                    2.0 * m * n * rs, None)
        return make

    def chain(T, b, r, s, width=None):
        # factors of row stride r read at ``width`` columns (all r if None)
        w = r if width is None else width

        def make(dtype):
            U = randn((T, b, r), dtype, 1 / math.sqrt(w))
            V = randn((T, b, r), dtype, 1 / math.sqrt(b))
            X = randn((T, b, s), dtype)
            isz = U.element_size()
            return (lambda: tc.tile_chain_cuda(U, V, X, width=width),
                    lambda: tc.tile_chain_plain(U, V, X, width=width),
                    lambda: tc.tile_chain_plain(U, V, X, width=w - 1),
                    lambda: torch.einsum("tbr,tcr,tcs->tbs", U[..., :w],
                                         V[..., :w], X),
                    (2 * T * b * w + 2 * T * b * s) * isz,
                    4.0 * T * b * w * s, None)
        return make

    def lrs(T, k, b, r, s, width=None):
        # factors of row stride r read at ``width`` columns (all r if None)
        w = r if width is None else width

        def make(dtype):
            Ui = randn((T, k, b, r), dtype, 1 / math.sqrt(w * k))
            Vi = randn((T, k, b, r), dtype, 1 / math.sqrt(b))
            W2 = randn((k, b, s), dtype)
            isz = Ui.element_size()
            return (lambda: lr.lr_sample_cuda(Ui, Vi, W2, width=width),
                    lambda: lr.lr_sample_plain(Ui, Vi, W2, width=width),
                    lambda: lr.lr_sample_plain(Ui[:, :-1].contiguous(),
                                               Vi[:, :-1].contiguous(),
                                               W2[:-1].contiguous(),
                                               width=width),
                    lambda: torch.einsum("tjbr,tjcr,jcs->tbs", Ui[..., :w],
                                         Vi[..., :w], W2),
                    (2 * T * k * b * w + k * b * s + T * b * s) * isz,
                    4.0 * T * k * b * w * s, None)
        return make

    def mgs(T, b, r, shift=0.0, dead=False):
        # MGS2 with R = Q^T Y: 2 sweeps x 2 b r^2 + 2 b r^2 = 6 b r^2 a tile.
        def make(dtype):
            Y = randn((T, b, r), torch.float64, 1 / math.sqrt(b))
            if shift:
                Y += shift * torch.eye(b, r, device=device, dtype=Y.dtype)
            if dead:
                Y[0, :, 3] = 2.0 * Y[0, :, 1] - Y[0, :, 0]
            Y = Y.to(dtype)
            Yf = Y.clone()
            Yf[:, :, -1] = 0.0
            isz = Y.element_size()
            return (lambda: qr.batched_qr_cuda(Y),
                    lambda: qr.batched_qr_plain(Y),
                    lambda: qr.batched_qr_plain(Yf),
                    lambda: torch.linalg.qr(Y),
                    (2 * T * b * r + T * r * r) * isz,
                    6.0 * T * b * r * r, None)
        return make

    def graded(T):
        # exponential-covariance tiles between two clusters of 128 points
        # (l = 0.1), as the right driver densifies them: graded, about a
        # quarter of the columns live at the drop tolerance
        def make(dtype):
            Y = graded_tiles(torch, T, g, device).to(dtype)
            Yf = Y.clone()
            Yf[:, :, -1] = 0.0
            isz = Y.element_size()
            return (lambda: qr.batched_qr_cuda(Y),
                    lambda: qr.batched_qr_plain(Y),
                    lambda: qr.batched_qr_plain(Yf),
                    lambda: torch.linalg.qr(Y),
                    (2 * T * 128 * 128 + T * 128 * 128) * isz,
                    6.0 * T * 128 ** 3, None, qr_graded_gate(Y, TOL[
                        str(dtype).removeprefix("torch.")]))
        return make

    def jacobi(T, m, n):
        # 8 sweeps of n(n-1)/2 rotations at 12 m + 6 n FLOPs each, skipped
        # rotations included (the Pallas kernel does their arithmetic too).
        def make(dtype):
            M = randn((T, m, n), dtype, 1 / math.sqrt(m))
            isz = M.element_size()

            def post(out):
                U, s, V = out
                return (s.sort(dim=-1, descending=True).values,
                        (U * s[:, None, :]) @ V.transpose(1, 2))
            return (lambda: svd.small_svd_cuda(M),
                    lambda: svd.small_svd_plain(M),
                    lambda: svd.small_svd_plain(M, sweeps=1),
                    lambda: torch.linalg.svd(M, full_matrices=False),
                    (2 * T * m * n + T * n + T * n * n) * isz,
                    8.0 * T * n * (n - 1) / 2 * (12 * m + 6 * n), post)
        return make

    def same_rotations(T, n):
        # M = Qa diag(linspace(3, 0.1)) Qb: singular values 0.023 apart
        def make(dtype):
            Qa = torch.linalg.qr(randn((T, n, n), torch.float64)).Q
            Qb = torch.linalg.qr(randn((T, n, n), torch.float64)).Q
            sig = torch.linspace(3.0, 0.1, n, device=device,
                                 dtype=torch.float64)
            M = ((Qa * sig) @ Qb).to(dtype)
            isz = M.element_size()

            def post(out):
                U, s, V = out
                sign = svd_column_signs(V)
                return s, U * sign, V * sign
            return (lambda: svd.small_svd_cuda(M),
                    lambda: svd.small_svd_plain(M),
                    lambda: svd.small_svd_plain(M, sweeps=1),
                    lambda: torch.linalg.svd(M, full_matrices=False),
                    (2 * T * n * n + T * n + T * n * n) * isz,
                    8.0 * T * n * (n - 1) / 2 * (18 * n), post)
        return make

    T = ranks_a.shape[0]
    ragged = torch.randint(1, 25, (5,), generator=g, device=device,
                           dtype=torch.int32)
    # ranks of the right path's batched_gemm calls (their own generator, so
    # that the other cases keep their inputs): full rank at the flushes'
    # densify (k = w_acc = 384) and truncation; L's ranks at the trailing
    # SYRK (cov2d-8k-right: mean 8.19, max 39); ranks from -2 to k + 3 with
    # garbage past them
    gr = torch.Generator(device=device).manual_seed(1)

    def full(T, k):
        return torch.full((T,), k, device=device, dtype=torch.int32)
    syrk = (-8.7 * torch.log(torch.rand((1953,), generator=gr, device=device,
                                        dtype=torch.float64))).floor()
    syrk = syrk.clamp(0, 39).to(torch.int32)
    syrk[:2] = torch.tensor([39, 0], dtype=torch.int32)
    wild = torch.randint(-2, 388, (100,), generator=gr, device=device,
                         dtype=torch.int32)
    return [
        ("batched_gemm", f"sample T={T} m=512 k=128 n=16", True,
         bgemm(512, 128, 16, ranks_a)),
        ("batched_gemm", f"sample_t T={T} m=512 k=128 n=128", False,
         bgemm(512, 128, 128, ranks_a)),
        ("batched_gemm", "ragged T=5 m=96 k=24 n=20", False,
         bgemm(96, 24, 20, ragged)),
        ("batched_gemm", "flush densify T=2016 m=128 k=384 n=128", False,
         bgemm(128, 384, 128, full(2016, 384))),
        ("batched_gemm", "truncation T=2016 m=128 k=128 n=128", False,
         bgemm(128, 128, 128, full(2016, 128))),
        ("batched_gemm", "SYRK T=1953 m=128 k=128 n=128 (L ranks)", False,
         bgemm(128, 128, 128, syrk)),
        ("batched_gemm", "op.round T=2016 m=512 k=128 n=128", False,
         bgemm(512, 128, 128, full(2016, 128))),
        ("batched_gemm", f"garbage tail T={T} m=512 k=128 n=16", False,
         bgemm(512, 128, 16, ranks_a, garbage=True)),
        ("batched_gemm", "garbage tail T=100 m=128 k=384 n=128 ranks -2..387",
         False, bgemm(128, 384, 128, wild, garbage=True)),
        ("tile_chain", "W2 hoist T=30 b=512 r=128 s=16", False,
         chain(30, 512, 128, 16)),
        ("tile_chain", "sample_t T*J=1890 b=512 r=128 s=128", True,
         chain(1890, 512, 128, 128)),
        ("tile_chain", "ragged T=3 b=96 r=24 s=70", False,
         chain(3, 96, 24, 70)),
        ("tile_chain", "ragged T*J=1891 b=500 ldr=128 width=100 s=128", False,
         chain(1891, 500, 128, 128, width=100)),
        ("tile_chain", "FMA past the tensor cores T=3 b=100 ldr=160 width=129 s=70",
         False, chain(3, 100, 160, 70, width=129)),
        *[("lr_sample", f"T={Tb} J={Jb} b=512 r=128 s=16", Tb == 63,
           lrs(Tb, Jb, 512, 128, 16)) for Tb, Jb in LR_BUCKETS],
        ("lr_sample", "ragged T=5 J=2 b=96 r=24 s=20", False,
         lrs(5, 2, 96, 24, 20)),
        ("lr_sample", "two 16-column chunks T=3 J=5 b=100 ldr=128 width=37 "
         "s=20", False, lrs(3, 5, 100, 128, 20, width=37)),
        ("lr_sample", "one j T=63 J=1 b=512 r=128 s=16", False,
         lrs(63, 1, 512, 128, 16)),
        ("lr_sample", "8-byte copies T=5 J=3 b=100 ldr=127 s=16", False,
         lrs(5, 3, 100, 127, 16)),
        ("lr_sample", "rows past 512 T=4 J=3 b=1000 r=128 s=16", False,
         lrs(4, 3, 1000, 128, 16)),
        ("batched_qr", "op.round T=2016 b=512 r=128", True,
         mgs(2016, 512, 128)),
        ("batched_qr", "right T=2016 b=128 r=128 (+3I)", False,
         mgs(2016, 128, 128, shift=3.0)),
        ("batched_qr", "panel T=63 b=128 r=128 (+3I)", False,
         mgs(63, 128, 128, shift=3.0)),
        ("batched_qr", "one tile T=1 b=128 r=128 (+3I)", False,
         mgs(1, 128, 128, shift=3.0)),
        ("batched_qr", QR_GRADED, False, graded(2016)),
        ("batched_qr", "ragged T=5 b=96 r=24 dead column", False,
         mgs(5, 96, 24, dead=True)),
        ("small_svd", "core T=2016 m=128 n=128", True,
         jacobi(2016, 128, 128)),
        ("small_svd", "panel T=63 m=128 n=128", False, jacobi(63, 128, 128)),
        ("small_svd", "one tile T=1 m=128 n=128", False,
         jacobi(1, 128, 128)),
        ("small_svd", SAME_ROTATIONS, False, same_rotations(4, 128)),
        ("small_svd", "ragged T=3 m=20 n=13", False, jacobi(3, 20, 13)),
        ("small_svd", "scratch T=2 m=300 n=200", False, jacobi(2, 300, 200)),
    ]


def gate(got, want, tol: float, atol: float | None = None
         ) -> tuple[float, float]:
    """(max abs error, allowed) of the output closest to failing: ``got``
    passes when, for every output, its largest deviation from ``want`` is
    at most ``tol`` times the largest |want| of that output (at most
    ``atol``, if given)."""
    if not isinstance(want, (tuple, list)):
        got, want = (got,), (want,)
    worst, worst_ratio = (0.0, 0.0), -1.0
    for x, w in zip(got, want):
        w = w.double()
        err = float((x.double() - w).abs().max())
        allowed = atol if atol is not None else tol * float(w.abs().max())
        ratio = err / allowed if allowed > 0 else (math.inf if err else 0.0)
        if ratio > worst_ratio:
            worst, worst_ratio = (err, allowed), ratio
    return worst


def svd_column_signs(V):
    """(T, 1, n): the sign of each column's largest |entry| of V."""
    import torch
    top = V.abs().argmax(dim=1, keepdim=True)
    return torch.sign(torch.take_along_dim(V, top, dim=1))


def graded_tiles(torch, T, g, device="cuda"):
    """(T, 128, 128) f64 exponential-covariance tiles (l = 0.1) between two
    clusters of 128 points, in [0, 0.5]^2 and [0.5, 1]^2."""
    pa = torch.rand((T, 128, 2), generator=g, device=device,
                    dtype=torch.float64) * 0.5
    pb = pa.new_empty(pa.shape).uniform_(0.5, 1.0, generator=g)
    return torch.exp(-torch.cdist(pa, pb) / 0.1).contiguous()


def qr_graded_gate(Y, tol: float):
    """The QR contract on graded tiles, as a gate ``(out, want) -> (ok,
    info)`` against the plain version:

    - the same dead columns, except at the cut: a column that one version
      keeps and the other drops must have, in the version that keeps it,
      |R[j, j]| (its residual norm) at most twice the first sweep's
      tolerance rel * max_j |y_j| (f32 puts a few of 2016 x 128 columns
      within rounding of it);
    - R, over the tiles without such a column, within max(tol, 10x the
      plain version's own move when Y's rows are permuted) per tile
      (relative Frobenius; a row permutation changes only the summation
      order, and moves R by 4.7e-12 at T = 2016 in f64 on an H100);
    - ||Q R - Y|| / ||Y|| and ||Q_live^T Q_live - I||, over all tiles,
      within 10x the plain version's."""
    import torch
    from repro_torch.kernels import batched_qr as qr
    Yd = Y.double()
    tol1 = qr.REL[Y.dtype] * Yd.norm(dim=1).amax(dim=1, keepdim=True)

    def contract(Q, R):
        Q, R = Q.double(), R.double()
        dead = Q.abs().amax(dim=1) == 0
        res = ((Q @ R - Yd).norm(dim=(1, 2)) / Yd.norm(dim=(1, 2))).max()
        gram = Q.transpose(1, 2) @ Q - torch.diag_embed((~dead).double())
        return dead, float(res), float(gram.norm(dim=(1, 2)).max())

    def flips(dead, R, dead_p, Rp):
        """Columns decided differently, and each one's kept |R[j, j]| /
        tol1 (0 elsewhere)."""
        flipped = dead != dead_p
        kept = torch.where(dead_p, R.diagonal(dim1=1, dim2=2),
                           Rp.diagonal(dim1=1, dim2=2)).double().abs()
        return flipped, torch.where(flipped, kept / tol1,
                                    torch.zeros_like(kept))

    def r_rel(R, Rp, tiles):
        R, Rp = R[tiles].double(), Rp[tiles].double()
        if R.shape[0] == 0:
            return 0.0
        return float(((R - Rp).norm(dim=(1, 2))
                      / Rp.norm(dim=(1, 2))).max())

    perm = torch.randperm(Y.shape[1], generator=torch.Generator().manual_seed(
        0)).to(Y.device)
    Qq, Rq = qr.batched_qr_plain(Y[:, perm].contiguous())

    def check(out, want):
        (Q, R), (Qp, Rp) = out, want
        dead, res, orth = contract(Q, R)
        dead_p, res_p, orth_p = contract(Qp, Rp)
        flipped, ratio = flips(dead, R, dead_p, Rp)
        flipped_q, _ = flips(Qq.abs().amax(dim=1) == 0, Rq, dead_p, Rp)
        spread = r_rel(Rq, Rp, ~flipped_q.any(dim=1))
        info = {"r_rel_err": r_rel(R, Rp, ~flipped.any(dim=1)),
                "r_allowed": max(tol, 10 * spread),
                "r_spread_row_permuted": spread,
                "dead_differ": int(flipped.sum()),
                "dead_differ_max_rjj_over_tol": float(ratio.max()),
                "dead_differ_row_permuted": int(flipped_q.sum()),
                "live": int((~dead_p).sum()), "columns": dead_p.numel(),
                "residual": res, "residual_plain": res_p,
                "orthogonality": orth, "orthogonality_plain": orth_p}
        ok = (info["dead_differ_max_rjj_over_tol"] <= 2.0
              and info["r_rel_err"] <= info["r_allowed"]
              and res <= 10 * res_p and orth <= 10 * orth_p)
        return ok, info
    return check


def bitwise_equal(a, b) -> bool:
    """Whether two kernel results (a tensor or a tuple of them) are equal
    bit for bit."""
    import torch
    if not isinstance(a, (tuple, list)):
        a, b = (a,), (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def check_kernels(ranks_a, only=None) -> dict:
    """Every case of ``kernel_cases`` (those of the kernels named in
    ``only``, if given): gate, planted fault, two calls bitwise equal, and
    timings."""
    import torch
    all_dtypes = (torch.float64, torch.float32, torch.bfloat16)
    results = {}
    for name, label, headline, make in kernel_cases(torch, ranks_a):
        if only is not None and name not in only:
            continue
        for dtype in (all_dtypes[:2] if name in ("batched_qr", "small_svd")
                      else all_dtypes):
            dn = str(dtype).removeprefix("torch.")
            tol = TOL[dn] * TOL_SCALE.get(name, 1.0)
            abs_tol = CASE_ATOL.get((name, label), {}).get(dn)
            case = make(dtype)
            kernel, plain, fault, library, nbytes, flops, post = case[:7]
            post = post or (lambda out: out)
            raw = plain()
            want = post(raw)
            got = kernel()
            rec = {"kernel": name, "shape": label, "dtype": dn}
            if len(case) > 7:   # the case's own gate
                ok, info = case[7](got, raw)
                fault_ok, fault_info = case[7](fault(), raw)
                err, atol = info["r_rel_err"], info["r_allowed"]
                fault_err, fault_atol = (fault_info["r_rel_err"],
                                         fault_info["r_allowed"])
                rec.update(contract=info, planted_fault_contract=fault_info)
            else:
                err, atol = gate(post(got), want, tol, abs_tol)
                fault_err, fault_atol = gate(post(fault()), want, tol,
                                             abs_tol)
                ok, fault_ok = err <= atol, fault_err <= fault_atol
            same = bitwise_equal(got, kernel())
            rec.update({"max_abs_err": err, "atol": atol, "ok": ok,
                        "planted_fault_err": fault_err,
                        "planted_fault_atol": fault_atol,
                        "deterministic": same})
            if label == SAME_ROTATIONS:
                # columns whose sign the kernel and the plain version differ in
                rec["sign_flips"] = int((svd_column_signs(got[2]) !=
                                         svd_column_signs(raw[2])).sum())
            if dtype == torch.float64 or headline:
                # the plain SVD is ~3000 small launches and cuSOLVER's SVD
                # loops over the batch: time the costly calls once, after
                # one warm call (cuSOLVER's first call sets up its handle)
                slow = flops > 1e11
                reps = 3 if flops > 5e10 else 10
                rec["ms"] = event_ms(kernel, reps)
                rec["plain_ms"] = event_ms(plain, 1 if slow else reps,
                                           1 if slow else 2)
                rec["library_ms"] = event_ms(library, 1 if slow else reps,
                                             1 if slow else 2)
                if name in MAIN_KERNELS and rec["ms"] < DISPATCH_MS:
                    # back-to-back calls time the host's dispatch here:
                    # replay them from a CUDA graph for the device time
                    rec["graph_ms"] = graph_ms(kernel)
                    rec["graph_plain_ms"] = graph_ms(plain)
                    rec["graph_library_ms"] = graph_ms(library)
                rec["bound_ms"] = 1e3 * max(nbytes / PEAK_BYTES,
                                            flops / PEAK_FLOPS[dn])
                rec["bound_by"] = ("bytes" if nbytes / PEAK_BYTES
                                   >= flops / PEAK_FLOPS[dn] else "operations")
            log(json.dumps(rec))
            if not ok:
                raise AssertionError(f"{name} {label} {dn}: kernel disagrees "
                                     f"with its plain version "
                                     f"(max abs err {err:.3e} > {atol:.3e})")
            if fault_ok:
                raise AssertionError(f"{name} {label} {dn}: the gate let a "
                                     f"planted fault through (err "
                                     f"{fault_err:.3e} <= {fault_atol:.3e})")
            if not same:
                raise AssertionError(f"{name} {label} {dn}: two kernel calls "
                                     f"on the same inputs differ")
            results[(name, label, dn)] = dict(rec, headline=headline,
                                              own_gate=len(case) > 7)
            del want, got, kernel, plain, fault, library
        torch.cuda.empty_cache()
    return results


# -- phase 4: small end-to-end run, card against CPU ---------------------------------------


def small_parity() -> None:
    import torch
    from repro_torch import CholOptions, TLROperator, covariance_problem
    from repro_torch.convert import operator_from_numpy

    n, tile, eps = 2048, 256, 1e-6
    _, K = covariance_problem(n, 2, tile, device="cuda")
    op_gpu = TLROperator.compress(K, tile, r_max=128, eps=1e-8)
    op_cpu = operator_from_numpy(*(t.cpu().numpy() for t in (
        op_gpu.A.D, op_gpu.A.U, op_gpu.A.V, op_gpu.A.ranks)), device="cpu")
    opts = CholOptions(eps=eps, bs=16, mode="dynamic", batching="flat")
    f_gpu = op_gpu.cholesky(opts)
    f_cpu = op_cpu.cholesky(opts)
    rg, rc = f_gpu.L.ranks.cpu(), f_cpu.L.ranks
    assert torch.equal(rg, rc), f"ranks differ in {(rg != rc).sum()} tiles"
    Lg = torch.tril(f_gpu.L.to_dense().cpu())
    Lc = torch.tril(f_cpu.L.to_dense())
    rel = float((Lg - Lc).norm() / Lc.norm())
    y = torch.randn((n, 4), generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    xg, xc = f_gpu.solve(y.cuda()).cpu(), f_cpu.solve(y)
    rel_x = float((xg - xc).norm() / xc.norm())
    log(f"small parity n={n} tile={tile}: ranks equal, "
        f"||L_gpu - L_cpu||/||L_cpu|| = {rel:.3e}, solve rel diff "
        f"{rel_x:.3e}")
    assert rel <= 1e-8 and rel_x <= 1e-8, "card and CPU runs disagree"


# -- phase 5: the main path at full width --------------------------------------------------


def _dev_us(event) -> float:
    """Self device time of a device-side profiler event (kernel, memcpy,
    memset); 0 for host-side ops, whose "self device time" repeats the
    kernels they launched, and for the profiler's own buffer events."""
    if not str(getattr(event, "device_type", "")).endswith("CUDA") or \
            "Buffer" in event.key:
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return getattr(event, attr)
    return 0.0


def timed(fn, profile: str | None, name: str):
    """``sync_time(fn)``; with ``profile`` set, under torch.profiler as
    well: its table goes to ``<profile>/<name>_profile.txt`` and the device
    busy time, idle share and top kernels to the log."""
    if not profile:
        return sync_time(fn)
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        out, sec = sync_time(fn)
    path = Path(profile) / f"{name}_profile.txt"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(prof.key_averages().table(row_limit=60))
    evs = [e for e in prof.key_averages() if _dev_us(e) > 0]
    busy_us = sum(_dev_us(e) for e in evs)
    log(f"profile {name}: device busy {busy_us / 1e6:.3f} s of {sec:.3f} s "
        f"wall (idle share {1 - busy_us / 1e6 / sec:.3f}); table in {path}")
    top = sorted(evs, key=lambda e: -_dev_us(e))
    # the twelve largest, then every other kernel of the port (templates
    # are named with their return type, plain functions without)
    for e in top[:12] + [e for e in top[12:] if e.key.removeprefix(
            "void ").removeprefix("(anonymous namespace)::").startswith(
            ("bgemm", "tile_chain", "lr_sample", "mgs_qr", "jacobi_svd"))]:
        log(f"  {_dev_us(e) / 1e3:10.1f} ms {e.count:7d}x  {e.key[:90]}")
    return out, sec


def svd_drivers(K, tile: int) -> None:
    """Seconds of one batched ``torch.linalg.svd`` of the first tile
    column's nb - 1 tiles by each cuSOLVER driver, with the ranks each
    gives at the compression's 1e-8 against gesvd's and the worst relative
    reconstruction error. (gesvda fails to converge on these tiles.)"""
    import torch
    nb = K.shape[0] // tile
    tiles = K[tile:, :tile].reshape(nb - 1, tile, tile)
    ref = None
    for driver in ("gesvd", None, "gesvdj"):
        (U, s, Vh), sec = sync_time(lambda: torch.linalg.svd(
            tiles, full_matrices=False, driver=driver))
        ranks = (s > 1e-8).sum(dim=1)
        ref = ranks if ref is None else ref
        rec = torch.linalg.matrix_norm((U * s[:, None, :]) @ Vh - tiles)
        rel = float((rec / torch.linalg.matrix_norm(tiles)).max())
        log(f"svd driver {driver or 'default'}: {nb - 1} tiles of {tile}^2 "
            f"in {sec:.3f} s; ranks at 1e-8 differ from gesvd's in "
            f"{int((ranks != ref).sum())} tiles (max |diff| "
            f"{int((ranks - ref).abs().max())}); max rel reconstruction "
            f"error {rel:.2e}")
        del U, s, Vh


def main_path(n: int, profile: str | None) -> dict:
    import torch
    from repro_torch import CholOptions, TLROperator, covariance_problem
    from repro_torch.kernels import batched_gemm as bg
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import lr_sample as lr

    tile, r_max, eps = TILE, R_MAX, EPS

    torch.cuda.reset_peak_memory_stats()
    phases = {}
    (pts, K), phases["covariance"] = sync_time(
        lambda: covariance_problem(n, 2, tile, device="cuda"))
    log(f"main path: 2-D exp covariance N={n} tile={tile} "
        f"(nb={n // tile}), K on {K.device}; compress method=svd "
        f"eps=1e-8 r_max={r_max}")

    ops.reset_launch_counts()
    op, phases["compress"] = sync_time(
        lambda: TLROperator.compress(K, tile, r_max=r_max, eps=1e-8,
                                     method="svd", bs=16))
    opts = CholOptions(eps=eps, bs=16, mode="dynamic", batching="flat")
    fact, phases["factor"] = timed(lambda: op.cholesky(opts), profile,
                                   "factor")
    g = torch.Generator(device="cuda").manual_seed(0)
    x_true = torch.randn((n,), generator=g, device="cuda", dtype=K.dtype)
    y = K @ x_true
    Y4 = K @ torch.randn((n, 4), generator=g, device="cuda", dtype=K.dtype)
    x, phases["solve_1"] = sync_time(lambda: fact.solve(y))
    X4, phases["solve_4"] = sync_time(lambda: fact.solve(Y4))
    ld, phases["logdet"] = sync_time(lambda: fact.logdet())
    S, phases["sample_2"] = sync_time(lambda: fact.sample(2, generator=g))
    Ax, phases["matvec"] = sync_time(lambda: op @ x)
    launches = ops.launch_counts()
    lr_shapes = sorted(lr.SHAPES.items(), reverse=True)
    log(f"launches on the main path: {json.dumps(launches)}")
    log("batched_gemm launches per (T, m, k, n) on the main path: "
        + shapes_line(bg.SHAPES))
    log("lr_sample launches per (T, J) on the main path: "
        + ", ".join(f"({t}, {j}) {c}" for (t, j), c in lr_shapes))
    # the source's j split at those shapes: groups of j per row tile (the
    # partials' workspace holds groups x T x b x s words when groups > 1)
    groups = {(t, j): max(1, build.query("lr_sample", "workspace", K.dtype,
                                         t, j, tile, r_max, 16)
                          // (t * tile * 16)) for (t, j), _ in lr_shapes}
    log("lr_sample j groups (blocks) per (T, J): " + ", ".join(
        f"({t}, {j}) {gr} ({t * gr})" for (t, j), gr in groups.items()))

    ra, rl = op.A.ranks.float(), fact.L.ranks.float()
    log(f"phase seconds: {json.dumps({k: round(v, 4) for k, v in phases.items()})}")
    log(f"A ranks: max {int(ra.max())} mean {float(ra.mean()):.2f}; "
        f"L ranks: max {int(rl.max())} mean {float(rl.mean()):.2f} "
        f"(r_max {r_max})")
    assert int(ra.max()) < r_max, \
        f"A's max rank reached r_max={r_max}: compression clipped; raise R_MAX"
    mem = torch.cuda.max_memory_allocated()
    log(f"max_memory_allocated: {mem / 2**30:.2f} GiB")
    st = fact.stats
    log(f"factor: {sum(st['column_iters'])} ARA block iterations over "
        f"{len(st['column_iters'])} columns, modified_chol "
        f"{st['modified_chol']}, safety_valve {st['safety_valve']}, "
        f"stage seconds {json.dumps({k: round(v, 3) for k, v in st['schedule']['kind_seconds'].items()})}")

    # Gates: every kernel of the path ran, outputs finite, randomized factor
    # residual.
    for name in MAIN_KERNELS:
        assert launches[name] > 0, \
            f"kernel {name} was not launched on the main path"
    for name, t in (("solve_1", x), ("solve_4", X4), ("sample", S),
                    ("matvec", Ax), ("logdet", ld)):
        assert bool(torch.isfinite(t).all()), f"{name} has non-finite values"
    assert S.shape == (n, 2) and X4.shape == (n, 4)
    Z = torch.randn((n, 3), generator=g, device="cuda", dtype=K.dtype)
    KZ = K @ Z
    LLZ = fact.tri_matvec(fact.tri_matvec(Z, trans=True))
    resid = float(((KZ - LLZ).norm(dim=0) / KZ.norm(dim=0)).max())
    solve_err = float((x - x_true).norm() / x_true.norm())
    mv_err = float((Ax - y).norm() / y.norm())
    log(f"factor residual max_z ||Kz - L L^T z||/||Kz|| = {resid:.3e} "
        f"(gate {100 * eps:.0e}); solve rel err {solve_err:.3e}; "
        f"matvec rel err {mv_err:.3e}")
    assert resid <= 100 * eps, "factor residual above 100 eps"
    assert mv_err <= 1e-6, "TLR matvec disagrees with the dense K"
    round_launches = rounding_phase(op, K, g)
    # The A-tile ranks batched_gemm gets in the first column (rows 1..nb-1).
    nb = n // tile
    rows = torch.arange(1, nb, device="cuda")
    ranks_a = op.A.ranks[rows * (rows - 1) // 2].contiguous()
    log(f"A ranks of the first column (batched_gemm's shape check): max "
        f"{int(ranks_a.max())} mean {float(ranks_a.float().mean()):.2f}")
    del op, fact, X4, S, Y4, LLZ, KZ, Z
    torch.cuda.empty_cache()
    svd_drivers(K, tile)
    Ld, t_dense = sync_time(lambda: torch.linalg.cholesky(K))
    ld_dense = float(2 * torch.log(torch.diagonal(Ld)).sum())
    log(f"logdet: TLR {float(ld):.6f}, dense cholesky {ld_dense:.6f} "
        f"(rel diff {abs(float(ld) - ld_dense) / abs(ld_dense):.2e}; dense "
        f"check {t_dense:.2f} s)")
    return {"launches": launches, "phases": phases, "ranks_a": ranks_a,
            "round_launches": round_launches}


# -- phase 6: the rounding pass on the main path's operator -------------------------------


def rounding_phase(op, K, g, eps: float = 1e-6) -> dict:
    """``op.round(eps)`` on the compressed main-path operator: the factored
    branch (batched QR of the (nt, b, r_max) factor stacks, SVD of the
    (nt, r_max, r_max) cores). Gates: the QR and SVD kernels ran, no tile's
    rank rose, and the rounded operator's matvec is within 1e-5 (relative)
    of the dense ``K x``."""
    import torch
    from repro_torch.kernels import batched_gemm as bg
    from repro_torch.kernels import batched_qr as qr
    from repro_torch.kernels import ops
    from repro_torch.kernels import small_svd as svd

    ops.reset_launch_counts()
    rop, sec = sync_time(lambda: op.round(eps))
    launches = ops.launch_counts()
    log(f"small_svd launches per (T, m, n) on the round path: "
        f"{shapes_line(svd.SHAPES)}")
    log(f"batched_qr launches per (T, b, r) on the round path: "
        f"{shapes_line(qr.SHAPES)}")
    log(f"batched_gemm launches per (T, m, k, n) on the round path: "
        f"{shapes_line(bg.SHAPES)}")
    r0, r1 = op.A.ranks, rop.A.ranks
    x = torch.randn((K.shape[0],), generator=g, device="cuda", dtype=K.dtype)
    y = K @ x
    mv_err = float((rop @ x - y).norm() / y.norm())
    log(f"rounding phase: op.round({eps:g}) in {sec:.3f} s; launches "
        f"{json.dumps(launches)}; ranks max {int(r0.max())} -> "
        f"{int(r1.max())}, mean {float(r0.float().mean()):.2f} -> "
        f"{float(r1.float().mean()):.2f}, {int((r1 < r0).sum())} of "
        f"{r0.numel()} tiles lower; matvec rel err {mv_err:.3e} (gate 1e-5)")
    for name in ("batched_qr", "small_svd"):
        assert launches[name] > 0, f"{name} not launched by op.round"
    assert bool((r1 <= r0).all()), "op.round raised a tile's rank"
    assert mv_err <= 1e-5, "rounded operator's matvec disagrees with K"
    del rop
    return launches


# -- phase 7: the right-looking driver ----------------------------------------------------


def shapes_line(shapes: dict) -> str:
    return ", ".join(f"{shape} {c}" for shape, c in
                     sorted(shapes.items(), reverse=True))


@contextlib.contextmanager
def gemm_rank_log():
    """While open, records every ``ops.batched_gemm`` call of the paths:
    yields a dict (T, m, k, n) -> list of the calls' rank tensors (copied
    on the card, no host sync). Only the smoke installs it, around the
    right-looking driver, whose shapes ``shape_times`` then times at those
    ranks."""
    from repro_torch.kernels import ops
    calls, inner = {}, ops.batched_gemm

    def recording(A, B, ranks):
        if ranks.numel():
            calls.setdefault((*A.shape, B.shape[-1]), []).append(
                ranks.clone())
        return inner(A, B, ranks)
    ops.batched_gemm = recording
    try:
        yield calls
    finally:
        ops.batched_gemm = inner


def gemm_shapes(calls: dict) -> dict:
    """(T, m, k, n) -> (launches, per-t mean live rank min(max(rank, 0), k)
    over them) from a ``gemm_rank_log``."""
    import torch
    return {(T, m, k, n): (len(rs), torch.stack(rs).clamp(0, k).double()
                           .mean(dim=0))
            for (T, m, k, n), rs in calls.items()}


def gemm_shapes_line(shapes: dict) -> str:
    return ", ".join(
        f"{shape} {c} (live rank mean {float(r.mean()):.2f}, max "
        f"{float(r.max()):.0f})"
        for shape, (c, r) in sorted(shapes.items(), reverse=True))


def shape_times(name: str, shapes: dict, dtype_name: str = "float64"
                ) -> float:
    """Times ``small_svd`` (shapes (T, m, n)), ``batched_qr`` ((T, b, r))
    or ``batched_gemm`` ((T, m, k, n), from ``gemm_shapes``: at that
    shape's per-t mean live ranks, rounded) at each shape a path launched it
    with (random inputs, the square QR panels shifted by 3 I; CUDA events,
    and a CUDA graph too under DISPATCH_MS) and logs launches x kernel ms
    against launches x bound ms per shape (``batched_gemm`` also its
    library call, ``torch.einsum`` of the masked product); returns the
    summed kernel seconds (the graph's time where taken), the path's time
    in that kernel as these shapes give it."""
    import torch
    from repro_torch.kernels import batched_gemm as bg
    from repro_torch.kernels import batched_qr as qr
    from repro_torch.kernels import small_svd as svd
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(3)
    total_ms = total_bound = 0.0
    for shape, count in sorted(shapes.items(), reverse=True):
        T, m, n = shape[0], shape[1], shape[-1]
        X = torch.randn((T, m, shape[2]), generator=g, device="cuda",
                        dtype=torch.float64) / math.sqrt(m)
        if name == "batched_qr" and m == n:
            X += 3.0 * torch.eye(m, device="cuda", dtype=X.dtype)
        X = X.to(dtype)
        library, note = None, ""
        if name == "batched_gemm":
            count, mean = count
            k = shape[2]
            B = (torch.randn((T, k, n), generator=g, device="cuda",
                             dtype=torch.float64) / math.sqrt(k)).to(dtype)
            ranks = mean.round().to(torch.int32)
            mask = (torch.arange(k, device="cuda")[None, :]
                    < ranks[:, None]).to(dtype)
            rs = int(ranks.clamp(0, k).sum())
            call = functools.partial(bg.batched_gemm_cuda, X, B, ranks)
            library = functools.partial(torch.einsum, "tmk,tk,tkn->tmn", X,
                                        mask, B)
            flops = 2.0 * m * n * rs
            words = m * rs + n * rs + T * m * n
            note = f", live rank mean {rs / T:.2f}"
        elif name == "small_svd":
            call = functools.partial(svd.small_svd_cuda, X)
            flops = 8.0 * T * n * (n - 1) / 2 * (12 * m + 6 * n)
            words = 2 * T * m * n + T * n + T * n * n
        else:
            call = functools.partial(qr.batched_qr_cuda, X)
            flops = 6.0 * T * m * n * n
            words = 2 * T * m * n + T * n * n
        reps = 3 if T > 500 else 10
        ms = event_ms(call, reps)
        timing = f"{ms:.4f} ms"
        if library is not None:
            note += f"; library {event_ms(library, reps):.4f} ms"
        if ms < DISPATCH_MS:
            ms = graph_ms(call)
            timing += f" by events, {ms:.4f} ms by graph"
            if library is not None:
                note += f", {graph_ms(library):.4f} ms by graph"
        bound = 1e3 * max(words * X.element_size() / PEAK_BYTES,
                          flops / PEAK_FLOPS[dtype_name])
        total_ms += count * ms
        total_bound += count * bound
        log(f"  {name} {shape} {dtype_name}: {count} launches x {timing} = "
            f"{count * ms:.1f} ms (bound {bound:.4f} ms, x {count} = "
            f"{count * bound:.1f} ms{note})")
        del X
    log(f"  {name} all shapes: {total_ms:.1f} ms (bound "
        f"{total_bound:.1f} ms)")
    return total_ms / 1e3


def right_phase(n: int, profile: str | None) -> dict:
    """The 2-D exponential covariance at N = ``n``, tile 128, compressed at
    1e-8 with r_max 128, factored by the right-looking driver (Cholesky,
    then LDL^T, flat batching). Gates per factorization: the QR, SVD and
    GEMM kernels ran, the randomized residual ``||K z - L D L^T z|| /
    ||K z|| <= 100 eps`` holds and a solve is finite. Logs ``small_svd``'s,
    ``batched_qr``'s and ``batched_gemm``'s launches per shape and, after
    both, their times per shape."""
    import torch
    from repro_torch import CholOptions, TLROperator, covariance_problem
    from repro_torch.kernels import batched_qr as qr
    from repro_torch.kernels import ops
    from repro_torch.kernels import small_svd as svd

    tile, eps = TILE_RIGHT, EPS
    torch.cuda.reset_peak_memory_stats()
    _, K = covariance_problem(n, 2, tile, device="cuda")
    op, t_comp = sync_time(lambda: TLROperator.compress(
        K, tile, r_max=R_MAX, eps=1e-8, method="svd"))
    ra = op.A.ranks.float()
    log(f"right phase: 2-D exp covariance N={n} tile={tile} "
        f"(nb={n // tile}, nt={op.A.U.shape[0]}); compress {t_comp:.2f} s, "
        f"A ranks max {int(ra.max())} mean {float(ra.mean()):.2f}")
    g = torch.Generator(device="cuda").manual_seed(2)
    Z = torch.randn((n, 3), generator=g, device="cuda", dtype=K.dtype)
    KZ = K @ Z
    y = K @ torch.randn((n,), generator=g, device="cuda", dtype=K.dtype)
    out = {}
    for kind in ("cholesky", "ldlt"):
        opts = CholOptions(eps=eps, algo="right", batching="flat")
        ops.reset_launch_counts()
        with gemm_rank_log() as gemm_calls:
            fact, sec = timed(lambda: getattr(op, kind)(opts),
                              profile if kind == "cholesky" else None,
                              "right_cholesky")
        launches = ops.launch_counts()
        shapes = {"small_svd": dict(svd.SHAPES),
                  "batched_qr": dict(qr.SHAPES),
                  "batched_gemm": gemm_shapes(gemm_calls)}
        LtZ = fact.tri_matvec(Z, trans=True)
        if fact.d is not None:
            LtZ = LtZ * fact.d.reshape(-1, 1)
        resid = float(((KZ - fact.tri_matvec(LtZ)).norm(dim=0)
                       / KZ.norm(dim=0)).max())
        x, t_solve = sync_time(lambda: fact.solve(y))
        st = fact.stats
        rl = fact.L.ranks.float()
        log(f"right {kind}: factor {sec:.3f} s, {st['flushes']} flushes, "
            f"acc_width {st['acc_width']}, L ranks max {int(rl.max())} mean "
            f"{float(rl.mean()):.2f}, modified_chol {st['modified_chol']}, "
            f"stage seconds "
            f"{json.dumps({k: round(v, 3) for k, v in st['schedule']['kind_seconds'].items()})}; "
            f"residual {resid:.3e} (gate {100 * eps:.0e}); solve "
            f"{t_solve:.3f} s; launches {json.dumps(launches)}")
        for name in ROUND_KERNELS:
            assert launches[name] > 0, \
                f"kernel {name} was not launched by the right-looking {kind}"
        assert resid <= 100 * eps, f"right {kind}: residual above 100 eps"
        assert bool(torch.isfinite(x).all()), f"right {kind}: solve not finite"
        out[f"right_{kind}"] = launches
        out[f"right_{kind}_seconds"] = sec
        out[f"right_{kind}_shapes"] = shapes
        log(f"right {kind}: small_svd launches per (T, m, n): "
            f"{shapes_line(shapes['small_svd'])}; batched_qr per (T, b, r): "
            f"{shapes_line(shapes['batched_qr'])}")
        log(f"right {kind}: batched_gemm launches per (T, m, k, n): "
            f"{gemm_shapes_line(shapes['batched_gemm'])}")
        del fact, LtZ, x, gemm_calls
    log(f"right phase max_memory_allocated: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del op, K, KZ, Z
    torch.cuda.empty_cache()
    for kind in ("cholesky", "ldlt"):
        for name in ("small_svd", "batched_qr", "batched_gemm"):
            log(f"right {kind}: {name} per shape (f64, timed apart from "
                f"the path):")
            sec = shape_times(name, out[f"right_{kind}_shapes"][name])
            log(f"right {kind}: {name} {sec:.3f} s of the factorization's "
                f"{out[f'right_{kind}_seconds']:.3f} s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=32768)
    ap.add_argument("--profile", default=None, metavar="DIR")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    dev = device_line()
    build_kernels()
    main = main_path(args.n, args.profile)
    right = right_phase(N_RIGHT, args.profile)
    results = check_kernels(main["ranks_a"])
    small_parity()

    by_path = {"main": main["launches"], "round": main["round_launches"],
               "right_cholesky": right["right_cholesky"],
               "right_ldlt": right["right_ldlt"]}
    kernels = []
    for name in KERNELS:
        head = next(r for (k, _, d), r in results.items()
                    if k == name and d == "float64" and r["headline"])
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            # the count on the kernel's own path: the main path for the
            # sampling kernels, the right-looking Cholesky for QR and SVD
            "launches": by_path["main" if name in MAIN_KERNELS
                                else "right_cholesky"][name],
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            # the elementwise gates' largest error (a case with its own
            # gate logs its numbers in its line)
            "max_abs_err": max(r["max_abs_err"] for (k, _, d), r in
                               results.items() if k == name and
                               d == "float64" and not r["own_gate"]),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            # device time of a headline under DISPATCH_MS (CUDA graph of
            # GRAPH_CALLS calls, inputs warm in L2)
            **{k: head[k] for k in ("graph_ms", "graph_plain_ms",
                                    "graph_library_ms") if k in head},
            "shape": head["shape"], "dtype": "float64",
            "checked": sorted({f"{lbl} {d}" for (k, lbl, d) in results
                               if k == name}),
        })
    log(f"total seconds: {time.perf_counter() - t_start:.1f}")
    log(dev["nvidia_smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
