#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, then
drives these paths, each with the kernels' launch counts set to 0 just
before it and read just after:

1. the main path at full width: a 2-D exponential covariance (N = 32768,
   tile 512) built on the card, ``TLROperator.compress`` (batched SVD, no
   rank may reach r_max) -> ``cholesky`` (left-looking dynamic ARA, the
   default ``batching="auto"``, whose decision it logs) -> solve / logdet
   / sample / matvec, gated on the randomized factor residual
   ``||K z - L (L^T z)|| / ||K z|| <= 100 eps``; then the same compressed
   operator factored with the other ``batching`` value under the same
   gate, so that flat and rank-bucketed batching both run (each logs its
   ranks, the gather widths wA / wL and projection widths wQ of the ranked
   run, and its launches per shape); it also times the batched SVD of one
   tile column by each cuSOLVER driver;
2. the rounding pass on the same operator: ``op.round(1e-6)`` flat and
   ranked (batched QR of the factors, SVD of the cores; per rank bucket
   when ranked), each gated on no rank rising and the rounded matvec
   within 1e-5 of ``K x``;
3. the right-looking driver: the same covariance at N = 8192, tile 128,
   ``cholesky`` and ``ldlt`` with ``algo="right"``, flat and ranked,
   gated on the same residual and finite solves; it logs flushes, append
   widths, peak memory, ``small_svd``'s launches per (T, m, n),
   ``batched_qr``'s per (T, b, r) and ``batched_gemm``'s per (T, m, k, n)
   with their mean live rank and, timed apart, launches x kernel ms
   against the bound per shape;
4. the fractional-diffusion PCG path (paper section 6.2): the 3-D
   operator at N = 32768, tile 512 built on the card, compressed at 1e-10,
   ``tlr_add_diag(op.A, eps)`` factored by the left-looking Cholesky at
   eps = 1e-2 and 1e-4, each used by ``pcg`` as the preconditioner of the
   compressed operator, then unpreconditioned ``pcg``; gated on the final
   relative residual (< 1e-6), ``||K x - b|| / ||b|| < 1e-5`` against the
   dense K, and fewer iterations at 1e-2 than without, no more at 1e-4;
5. the Newton-Schulz path: the same generator at N = 8192, tile 128,
   ``tlr_newton_schulz`` (norm scaling, eps 1e-8) after 4 and 8
   iterations, and ranked after 8; gated on fewer PCG iterations than
   plain CG, the residual, ranked within 1e-8 of flat, and one
   ``op.compose(op, 1e-8)`` within 1e-6 of the dense ``K @ K``;
6. inter-tile pivoting (Algorithm 9) on the main path's compressed operator:
   the left Cholesky with ``pivot="frobenius"`` and ``pivot="power"``,
   gated on the randomized residual of ``P K P^T`` (100 eps) and a finite
   solve, logging the pivot sequence and the time against the unpivoted
   factorization; then ``check=True`` on the default left Cholesky, gated
   within 1e-12 of the unchecked factor with no health event (its bitwise
   status and the clean-path overhead logged);
7. the right driver's lookahead schedule on the right path's operator:
   Cholesky and LDL^T, flat and ranked, each after the sequential run of
   the same options, gated within 1e-12 of it, on the right phase's
   residual, a finite solve and the second CUDA stream, logging both times,
   the bitwise status, peak memory, flushes, append widths and the first
   stages of the order;
8. the fault matrix of tests/test_health.py on the same operator with
   ``check=True``: an indefinite diagonal tile near the end recovers (left,
   right, right with lookahead; at column 2 the right driver must end with
   finite factors or a breakdown), a rank spike under ``r_max_out``
   recovers on the left and is accepted on the right, a NaN diagonal tile
   and a NaN panel raise ``FactorizationBreakdown`` with the expected
   reason and column (left, right).
9. the TLR inference server (``repro_torch.serve``), twice, on residents
   the paths above already built (no further compression): the main
   path's factor with its operator, ``fact.serve(operator=op, slots=8,
   check_every=4)``, draining 64 requests that cycle through solve /
   logdet / sample / pcg_solve (one solve column poisoned by a
   ``serve.solve`` fault), gated on each solve within 1e-10 of
   ``fact.solve``, each sample within 1e-10 of ``fact.sample(z=draw)``,
   logdet equal to the memoized value, each pcg_solve at ``||K x - b|| /
   ||b|| < 1e-5``, the poisoned request a ``nonfinite_result``; and
   path 4's operator with its eps = 1e-2 Cholesky as preconditioner
   (factored again once path 4's counts are read, so that no earlier
   phase holds two factors at once), draining 16 pcg_solve requests (tol 1e-6) through 8 slots, gated on
   convergence, the residual against K, the first two within 2 iterations
   of scalar ``pcg`` and occupancy >= 0.8. Both gate on every request
   completing once and on no new dispatch shape after warmup
   (``trace_counts_diff``), and log warmup seconds, ticks, occupancy,
   requests/s, p50 / p99 per kind, peak memory, the kernels' launches
   during the drain (none: the read paths are stock torch products) and
   whether batched and sequential results agree bit for bit;
10. the telemetry layer (``repro_torch.obs``) on residents the paths above
    built: the main path's left Cholesky with telemetry off and on (the
    factor, the launches and the dispatch shapes unchanged, ``chol.diag``
    / ``chol.panel`` once a column, the enabled run within 1.25x + 0.1 s),
    its Chrome trace held to the schema check of tests/test_obs.py, the
    same run under torch.profiler (every ``lr_sample`` and ``tile_chain``
    kernel launched inside a ``chol.panel`` user range; device ms per span
    name logged), the serve cov2d-32k drain recorded (a ``serve.tick`` span
    and an ``occupancy`` sample a tick, no kernel launch), and the ranked
    right Cholesky, sequential and with lookahead, and the flat one on path
    3's operator (its spans, one ``chol.flush`` per flush, the factor
    bitwise as with telemetry off); it logs the cost of a disabled span;
11. mixed-precision storage (the paper's section 7) on path 3's K:
    ``TLROperator.compress(..., store_dtype=torch.float32)``, gated on half
    the logical low-rank bytes, the matvec within 1e-4 of ``K x`` and the
    default left Cholesky at eps 1e-5 (residual 100 eps, solve error
    1e-2), its kernels running in f64 on the promoted factors.

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
the card against the same run on the CPU (flat and ranked; and both
fractional-diffusion preconditioners at n = 512, tile 64). The kernels
are also held at the rank-bucket widths of ranked batching (width 1 to
128, zero-tile count padding), at each kernel's widest bucket on its
ranked path and at each kernel's widest shape on the two
fractional-diffusion paths. Kernel times are CUDA events
over back-to-back calls; a sampling kernel's case under DISPATCH_MS is
also timed from a CUDA graph (``graph_ms`` and its kin beside ``ms``),
since the host's dispatch sets the pace of back-to-back calls there.

Run from the root of a checkout:  python3 chip_smoke.py
(``--n`` cuts the main path's size for a quick look;
``--profile DIR`` adds torch.profiler tables of the left-looking and the
right-looking Cholesky, the fractional-diffusion Cholesky at eps 1e-2 and
the 8-iteration Newton-Schulz build.)

Exits non-zero, printing no result, without a CUDA card or outside a
checkout. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import collections
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
# The fractional-diffusion PCG path (paper section 6.2, Figs. 9/10): the 3-D
# operator of ``fractional_diffusion_problem`` on the full 32^3 grid (the
# largest power-of-two cube whose dense f64 K, 8.6 GB, sits on the card
# beside the compression's workspace; the paper's N = 2^17 needs 137 GB),
# s = 0.75, tile 512, compressed at 1e-10 with r_max = tile; PCG to 1e-6
# preconditioned by the TLR Cholesky of K + eps I at each eps of FRAC_EPS.
FRAC_N, FRAC_TILE, FRAC_S, FRAC_EPS = 32768, 512, 0.75, (1e-2, 1e-4)
# The Newton-Schulz path: the same generator at N = 8192, tile 128 (nb = 64;
# at tile 512 every tlr_gemm output tile is a dense 512^2 SVD), compressed
# at 1e-10; the inverse at eps 1e-8 with norm scaling after each iteration
# count of NS_ITERS (the example's defaults).
NS_N, NS_TILE, NS_EPS, NS_ITERS = 8192, 128, 1e-8, (4, 8)
# The server (phase 9): SERVE_SLOTS columns, a PCG window of SERVE_CHECK
# iterations a tick (``fact.serve``'s defaults); SERVE_REQUESTS mixed
# requests on the main path's resident, FRAC_SERVE_REQUESTS pcg_solve
# requests on the fractional-diffusion one (twice the slots, so columns
# refill mid-flight).
SERVE_SLOTS, SERVE_CHECK, SERVE_REQUESTS, FRAC_SERVE_REQUESTS = 8, 4, 64, 16
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
# Label prefix of the kernel cases at the widest rank bucket a ranked path
# gave each kernel (``widest_bucket``).
RANKED_HEAD = "ranked widest bucket"


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


def kernel_cases(torch, ranks_a, device="cuda", ranked=None):
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
    (``batched_gemm``; one term of a K-reduction), one factor column
    (``tile_chain``: ``width`` one less), the last j term (``lr_sample``),
    the last column (``batched_qr``) or seven of the eight sweeps
    (``small_svd``) dropped: a result the gate must reject. The
    "same rotations" case holds the unsorted s, U and V of a well-separated
    spectrum elementwise, column signs matched as ``SAME_ROTATIONS_ATOL``
    says. ``post`` maps a
    raw result to the outputs that are gated (None: the result itself);
    timing runs the raw calls. ``headline`` marks the shape that takes most
    of the kernel's time on its path; its numbers go into the kernels
    line.

    Ranked batching runs every kernel at rank-bucket widths: ``lr_sample``
    and ``tile_chain`` at the left driver's gather widths (1 to 128, the
    factors gathered at that width, so an odd width is an odd row stride),
    ``batched_qr`` at (bucket count, b, w), ``small_svd`` at (count, w, w)
    (no rotation at all for w = 1), ``batched_gemm`` at k = w; a bucket's
    count is padded with all-zero tiles, which must come out at rank 0 with
    no NaN. ``ranked`` maps a kernel to a list of ``(path, shape, ranks)``,
    the widest-bucket shape each ranked path gave it (``widest_bucket``),
    with ``batched_gemm``'s live ranks there (None: full rank): such a
    case's label starts with ``RANKED_HEAD`` and its times go into the
    kernels line beside the headline's."""
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

    def bgemm(m, k, n, ranks, garbage=False, drop=1):
        # garbage: A's columns and B's rows past each rank hold +-1e6, which
        # the plain version masks by multiplication and the kernel must
        # never read; drop: the columns of each rank the fault leaves out
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
                    lambda: bg.batched_gemm_plain(A, B,
                                                  (ranks - drop).clamp(0)),
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

    def mgs(T, b, r, shift=0.0, dead=False, zero_tail=0):
        # MGS2 with R = Q^T Y: 2 sweeps x 2 b r^2 + 2 b r^2 = 6 b r^2 a tile.
        # zero_tail: the last tiles all zero, as a rank bucket's count padding
        def make(dtype):
            Y = randn((T, b, r), torch.float64, 1 / math.sqrt(b))
            if shift:
                Y += shift * torch.eye(b, r, device=device, dtype=Y.dtype)
            if dead:
                Y[0, :, 3] = 2.0 * Y[0, :, 1] - Y[0, :, 0]
            if zero_tail:
                Y[T - zero_tail:] = 0.0
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

    def jacobi(T, m, n, zero_tail=0):
        # 8 sweeps of n(n-1)/2 rotations at 12 m + 6 n FLOPs each, skipped
        # rotations included (the Pallas kernel does their arithmetic too).
        # For n <= 2 one sweep already converges, so the planted fault drops
        # the last column instead. zero_tail: the last tiles all zero.
        def make(dtype):
            M = randn((T, m, n), dtype, 1 / math.sqrt(m))
            if zero_tail:
                M[T - zero_tail:] = 0.0
            Mf = M.clone()
            Mf[:, :, -1] = 0.0
            isz = M.element_size()

            def post(out):
                U, s, V = out
                return (s.sort(dim=-1, descending=True).values,
                        (U * s[:, None, :]) @ V.transpose(1, 2))
            return (lambda: svd.small_svd_cuda(M),
                    lambda: svd.small_svd_plain(M),
                    (lambda: svd.small_svd_plain(Mf)) if n <= 2 else
                    (lambda: svd.small_svd_plain(M, sweeps=1)),
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

    def ranked_cases(shapes):
        """The widest-bucket case of each kernel on each ranked path."""
        out = []
        for name, path, shape, ranks in sorted(
                (name, *case) for name, cases in shapes.items()
                for case in cases):
            label = f"{RANKED_HEAD} on {path} {shape}"
            if ranks is not None:
                label += (f" live ranks {int(ranks.min())}.."
                          f"{int(ranks.max())}")
            if name == "lr_sample":
                Tr, J, r = shape
                out.append((name, label, False, lrs(Tr, J, TILE, r, 16)))
            elif name == "tile_chain":
                Tr, b, r, sc = shape
                out.append((name, label, False, chain(Tr, b, r, sc)))
            elif name == "batched_gemm":
                # On frac_ns a call wider than the own-term assembly (k >
                # m + n) is tlr_gemm's K-reduction over concatenated terms of
                # n columns: its fault drops the last term, since one column
                # of 8064 hides inside bf16's tolerance.
                Tr, m, k, n = shape
                drop = n if path == "frac_ns" and k > m + n else 1
                out.append((name, label, False, bgemm(
                    m, k, n, full(Tr, k) if ranks is None else ranks,
                    drop=drop)))
            elif name == "batched_qr":
                Tr, b, r = shape
                out.append((name, label, False,
                            mgs(Tr, b, r, shift=3.0 if b == r else 0.0)))
            else:
                Tr, m, n = shape
                out.append((name, label, False, jacobi(Tr, m, n)))
        return out

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
        # rank-bucket widths (ranked batching)
        *[("lr_sample", f"bucket T=63 J=30 b=512 r={w} s=16", False,
           lrs(63, 30, 512, w, 16)) for w in (1, 8, 32)],
        *[("tile_chain", f"bucket T*J=1890 b=512 r={w} s=128", False,
           chain(1890, 512, w, 128)) for w in (2, 16)],
        ("tile_chain", "odd stride T=63 b=512 ldr=5 width=3 s=128", False,
         chain(63, 512, 5, 128, width=3)),
        *[("batched_qr", f"bucket T=64 b={b} r={w}", False, mgs(64, b, w))
          for b in (128, 512) for w in (1, 4, 32)],
        ("batched_qr", "bucket T=64 b=128 r=4, 21 zero tiles", False,
         mgs(64, 128, 4, zero_tail=21)),
        *[("small_svd", f"bucket core T=64 m={w} n={w}", False,
           jacobi(64, w, w)) for w in (1, 2, 8, 64)],
        ("small_svd", "bucket core T=64 m=4 n=4, 21 zero tiles", False,
         jacobi(64, 4, 4, zero_tail=21)),
        *[("batched_gemm", f"bucket truncation T=64 m=128 k={w} n={w}", False,
           bgemm(128, w, w, full(64, w))) for w in (1, 4, 32)],
        ("batched_gemm", "bucket core T=64 m=2 k=2 n=2", False,
         bgemm(2, 2, 2, full(64, 2))),
        ("batched_gemm", "bucket densify T=64 m=128 k=256 n=128 ranks 129..256",
         False, bgemm(128, 256, 128, torch.randint(
             129, 257, (64,), generator=gr, device=device,
             dtype=torch.int32))),
        *[("batched_gemm", f"A-term T=63 m=512 k={w} n=16", False,
           bgemm(512, w, 16, ranks_a.clamp(max=w))) for w in (1, 4)],
        *ranked_cases(ranked or {}),
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


def check_kernels(ranks_a, only=None, ranked=None) -> dict:
    """Every case of ``kernel_cases`` (those of the kernels named in
    ``only``, if given; ``ranked`` as ``kernel_cases`` takes it): gate,
    planted fault, two calls bitwise equal, and timings."""
    import torch
    all_dtypes = (torch.float64, torch.float32, torch.bfloat16)
    results = {}
    for name, label, headline, make in kernel_cases(torch, ranks_a,
                                                     ranked=ranked):
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
            if dtype == torch.float64 or headline or \
                    label.startswith(RANKED_HEAD):
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
    """The same factorization on the card and on the CPU (n = 2048, tile
    256), with flat and with ranked batching: equal ranks, factors and
    solves within 1e-8."""
    import torch
    from repro_torch import CholOptions, TLROperator, covariance_problem
    from repro_torch.convert import operator_from_numpy

    n, tile, eps = 2048, 256, 1e-6
    _, K = covariance_problem(n, 2, tile, device="cuda")
    op_gpu = TLROperator.compress(K, tile, r_max=128, eps=1e-8)
    op_cpu = operator_from_numpy(*(t.cpu().numpy() for t in (
        op_gpu.A.D, op_gpu.A.U, op_gpu.A.V, op_gpu.A.ranks)), device="cpu")
    y = torch.randn((n, 4), generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    for batching in ("flat", "ranked"):
        opts = CholOptions(eps=eps, bs=16, mode="dynamic", batching=batching)
        f_gpu = op_gpu.cholesky(opts)
        f_cpu = op_cpu.cholesky(opts)
        rg, rc = f_gpu.L.ranks.cpu(), f_cpu.L.ranks
        assert torch.equal(rg, rc), \
            f"{batching}: ranks differ in {(rg != rc).sum()} tiles"
        Lg = torch.tril(f_gpu.L.to_dense().cpu())
        Lc = torch.tril(f_cpu.L.to_dense())
        rel = float((Lg - Lc).norm() / Lc.norm())
        xg, xc = f_gpu.solve(y.cuda()).cpu(), f_cpu.solve(y)
        rel_x = float((xg - xc).norm() / xc.norm())
        log(f"small parity n={n} tile={tile} batching={batching}: ranks "
            f"equal, ||L_gpu - L_cpu||/||L_cpu|| = {rel:.3e}, solve rel "
            f"diff {rel_x:.3e}")
        assert rel <= 1e-8 and rel_x <= 1e-8, \
            f"{batching}: card and CPU runs disagree"
    frac_parity()


def frac_parity() -> None:
    """Both fractional-diffusion preconditioners on the card and on the CPU
    (n = 512, tile 64, the same compressed operator): the loose-eps
    Cholesky of ``tlr_add_diag(op.A, 1e-2)`` and two Newton-Schulz
    iterations (norm scaling, eps 1e-8; the CPU runs the plain Jacobi SVD,
    which sets the count). Gates: equal PCG iterations with each, and the
    Newton-Schulz X within 1e-10 (relative, Frobenius)."""
    import numpy as np
    import torch
    from repro_torch import CholOptions, TLROperator, pcg, tlr_newton_schulz
    from repro_torch.convert import operator_from_numpy
    from repro_torch.core import (fractional_diffusion_matrix,
                                  fractional_diffusion_points, tlr_add_diag)

    n, tile, eps = 512, 64, 1e-2
    K = fractional_diffusion_matrix(fractional_diffusion_points(n, tile),
                                    device="cuda")
    op = {"cuda": TLROperator.compress(K, tile, eps=1e-10)}
    op["cpu"] = operator_from_numpy(*(t.cpu().numpy() for t in (
        op["cuda"].A.D, op["cuda"].A.U, op["cuda"].A.V, op["cuda"].A.ranks)),
        device="cpu")
    rhs = torch.as_tensor(np.random.default_rng(0).standard_normal(n))
    it, X = {}, {}
    for dev, o in op.items():
        b = rhs.to(dev)
        fact = TLROperator(tlr_add_diag(o.A, eps)).cholesky(
            CholOptions(eps=eps, bs=16))
        Xop, _ = tlr_newton_schulz(o, iters=2, eps=1e-8, scale="norm")
        it[dev] = (pcg(o, b, precond=fact, tol=1e-6, maxiter=300)[1],
                   pcg(o, b, precond=Xop, tol=1e-6, maxiter=300)[1])
        X[dev] = Xop.to_dense().cpu()
    rel = float((X["cuda"] - X["cpu"]).norm() / X["cpu"].norm())
    log(f"small parity frac n={n} tile={tile}: pcg iterations (Cholesky "
        f"eps={eps:g}, Newton-Schulz) card {it['cuda']}, CPU {it['cpu']}; "
        f"Newton-Schulz X card vs CPU rel {rel:.3e} (gate 1e-10)")
    assert it["cuda"] == it["cpu"] and rel <= 1e-10, \
        "frac: card and CPU preconditioners disagree"


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


def path_shapes() -> dict:
    """Launches per shape of each kernel since the last reset."""
    from repro_torch.kernels import ops
    return {name: dict(mod.SHAPES) for name, mod in ops.KERNELS.items()}


def widest_bucket(shapes: dict, width_axis: int = 2):
    """The shape of ``shapes`` (launches per shape) at the widest rank
    bucket, the largest batch among those; None if there is none."""
    if not shapes:
        return None
    return max(shapes, key=lambda sh: (sh[width_axis], sh[-1], sh[0]))


def left_summary(fact, label: str, r_max: int) -> None:
    """Logs a left-looking factorization's batching decision, ranks and
    widths: the policy record, wA, the wL ladder the driver reached and
    each column's projection width wQ."""
    st = fact.stats
    rl = fact.L.ranks.float()
    ev = st["column_events"]
    ladder = []
    for e in ev:
        if e["wL"] is not None and (not ladder or ladder[-1] != e["wL"]):
            ladder.append(e["wL"])
    log(f"{label}: batching {st['batching']}, policy "
        f"{json.dumps(st['policy'])}")
    log(f"{label}: L ranks max {int(rl.max())} mean {float(rl.mean()):.2f} "
        f"(r_max {r_max}); wA {ev[0]['wA'] if ev else None}, wL ladder {ladder or None}, wQ "
        f"per column {[e['wQ'] for e in ev] if ladder else None}; "
        f"{sum(st['column_iters'])} ARA block iterations over "
        f"{len(st['column_iters'])} columns, modified_chol "
        f"{st['modified_chol']}, safety_valve {st['safety_valve']}, stage "
        f"seconds {json.dumps({k: round(v, 3) for k, v in st['schedule']['kind_seconds'].items()})}")


def log_shapes(label: str, shapes: dict) -> None:
    for name in ("lr_sample", "tile_chain", "batched_gemm", "batched_qr",
                 "small_svd"):
        if shapes.get(name):
            log(f"{label}: {name} launches per shape: "
                f"{shapes_line(shapes[name])}")


def left_residual(K, fact, Z) -> float:
    """max_z ||P K P^T z - L (L^T z)|| / ||P K P^T z|| over the columns of
    Z, for the factorization's tile permutation P (the identity unless it
    pivoted): P K P^T z is (K w)[e] with w[e] = z, e the element
    permutation of ``fact.perm``."""
    import torch
    from repro_torch.core import tile_perm_to_element_perm
    e = torch.as_tensor(tile_perm_to_element_perm(fact.perm, fact.L.b),
                        device=Z.device)
    W = torch.zeros_like(Z)
    W[e] = Z
    KZ = (K @ W)[e]
    LLZ = fact.tri_matvec(fact.tri_matvec(Z, trans=True))
    return float(((KZ - LLZ).norm(dim=0) / KZ.norm(dim=0)).max())


def main_path(n: int, profile: str | None) -> dict:
    import dataclasses

    import torch
    from repro_torch import CholOptions, TLROperator, covariance_problem
    from repro_torch.kernels import build, ops

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
    opts = CholOptions(eps=eps, bs=16, mode="dynamic")   # batching "auto"
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
    shapes = path_shapes()
    batching = fact.stats["batching"]
    log(f"launches on the main path (batching auto -> {batching}): "
        f"{json.dumps(launches)}")
    log_shapes("main path", shapes)
    # the source's j split at the lr_sample shapes: groups of j per row tile
    # (the partials' workspace holds groups x T x b x s words when groups > 1)
    groups = {sh: max(1, build.query("lr_sample", "workspace", K.dtype,
                                     sh[0], sh[1], tile, sh[2], 16)
                      // (sh[0] * tile * 16)) for sh in shapes["lr_sample"]}
    log("lr_sample j groups (blocks) per (T, J, r): " + ", ".join(
        f"{sh} {gr} ({sh[0] * gr})" for sh, gr in sorted(groups.items(),
                                                         reverse=True)))

    ra = op.A.ranks.float()
    log(f"phase seconds: {json.dumps({k: round(v, 4) for k, v in phases.items()})}")
    log(f"A ranks: max {int(ra.max())} mean {float(ra.mean()):.2f} median "
        f"of the positive {op.plan().median_rank} (r_max {r_max})")
    assert int(ra.max()) < r_max, \
        f"A's max rank reached r_max={r_max}: compression clipped; raise R_MAX"
    mem = torch.cuda.max_memory_allocated()
    log(f"max_memory_allocated: {mem / 2**30:.2f} GiB")
    left_summary(fact, f"main path ({batching})", r_max)

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
    resid = left_residual(K, fact, Z)
    solve_err = float((x - x_true).norm() / x_true.norm())
    mv_err = float((Ax - y).norm() / y.norm())
    log(f"factor residual max_z ||Kz - L L^T z||/||Kz|| = {resid:.3e} "
        f"(gate {100 * eps:.0e}); solve rel err {solve_err:.3e}; "
        f"matvec rel err {mv_err:.3e}")
    assert resid <= 100 * eps, "factor residual above 100 eps"
    assert mv_err <= 1e-6, "TLR matvec disagrees with the dense K"
    del X4, S, Y4

    # The same compressed operator factored with the other batching value,
    # so that flat and ranked both run at full size.
    other = "flat" if batching == "ranked" else "ranked"
    ops.reset_launch_counts()
    fact2, sec2 = sync_time(lambda: op.cholesky(
        dataclasses.replace(opts, batching=other)))
    launches2 = ops.launch_counts()
    shapes2 = path_shapes()
    resid2 = left_residual(K, fact2, Z)
    differ = int((fact2.L.ranks != fact.L.ranks).sum())
    log(f"main path, batching={other}: factor {sec2:.3f} s (the {batching} "
        f"factorization: {phases['factor']:.3f} s); launches "
        f"{json.dumps(launches2)}; residual {resid2:.3e} (gate "
        f"{100 * eps:.0e}); L ranks differ from the {batching} factor's in "
        f"{differ} of {fact.L.ranks.numel()} tiles")
    log_shapes(f"main path ({other})", shapes2)
    left_summary(fact2, f"main path ({other})", r_max)
    for name in MAIN_KERNELS:
        assert launches2[name] > 0, \
            f"kernel {name} was not launched by the {other} factorization"
    assert resid2 <= 100 * eps, f"{other} factor residual above 100 eps"
    del fact2
    # The run's first factorization also pays the kernels' module loading:
    # time the default once more, warm, beside the other value's run.
    _, sec_warm = sync_time(lambda: op.cholesky(opts))
    phases["factor_warm"] = sec_warm
    log(f"main path factorization seconds, warm: {batching} {sec_warm:.3f}, "
        f"{other} {sec2:.3f} (the first, cold: {batching} "
        f"{phases['factor']:.3f})")

    reads = read_paths(op, fact, g)
    rounding = rounding_phase(op, K, g)
    pivots = pivot_phase(op, K, Z, y, x_true, opts, sec_warm)
    checked = check_phase(op, fact, opts, sec_warm)
    served = serve_main_phase(op, fact, K)
    telem = telemetry_phase(op, fact, opts)
    # The A-tile ranks batched_gemm gets in the first column (rows 1..nb-1).
    nb = n // tile
    rows = torch.arange(1, nb, device="cuda")
    ranks_a = op.A.ranks[rows * (rows - 1) // 2].contiguous()
    log(f"A ranks of the first column (batched_gemm's shape check): max "
        f"{int(ranks_a.max())} mean {float(ranks_a.float().mean()):.2f}")
    del op, fact
    torch.cuda.empty_cache()
    svd_drivers(K, tile)
    Ld, t_dense = sync_time(lambda: torch.linalg.cholesky(K))
    ld_dense = float(2 * torch.log(torch.diagonal(Ld)).sum())
    log(f"logdet: TLR {float(ld):.6f}, dense cholesky {ld_dense:.6f} "
        f"(rel diff {abs(float(ld) - ld_dense) / abs(ld_dense):.2e}; dense "
        f"check {t_dense:.2f} s)")
    by_batching = {batching: (launches, shapes), other: (launches2, shapes2)}
    return {"launches": launches, "batching": batching,
            "flat": by_batching["flat"], "ranked": by_batching["ranked"],
            "phases": phases, "ranks_a": ranks_a, "reads": reads,
            **rounding, **pivots, **checked, **served, **telem}


def read_paths(op, fact, g, reps: int = 20) -> dict:
    """The read paths on the main path's operator and factor, flat beside
    ranked: ``op.matvec``, the factor's ``tri_matvec`` (L and L^T) and the
    two triangular solves of ``solve`` (``tri_solve`` forward, then
    transposed), on 1 and 4 right-hand sides. Each is timed warm by CUDA
    events over ``reps`` back-to-back calls (the host's dispatch and index
    work included, as a caller pays it). Gate: ranked agrees with flat to
    1e-12 (products) or 1e-9 (solves), relative."""
    import torch
    n = op.n
    out = {}
    for m in (1, 4):
        x = torch.randn((n, m), generator=g, device=op.device,
                        dtype=op.dtype)[:, 0 if m == 1 else slice(None)]
        calls = {
            "matvec": lambda b: op.matvec(x, batching=b),
            "tri_matvec": lambda b: fact.tri_matvec(x, batching=b),
            "tri_matvec_t": lambda b: fact.tri_matvec(x, trans=True,
                                                      batching=b),
            "solve": lambda b: fact.tri_solve(
                fact.tri_solve(x, batching=b), trans=True, batching=b),
        }
        for name, call in calls.items():
            got = {b: call(b) for b in ("flat", "ranked")}
            rel = float((got["ranked"] - got["flat"]).norm()
                        / got["flat"].norm())
            ms = {b: event_ms(lambda: call(b), reps)
                  for b in ("flat", "ranked")}
            tol = 1e-9 if name == "solve" else 1e-12
            log(f"read path {name} ({m} rhs): flat {ms['flat']:.4f} ms, "
                f"ranked {ms['ranked']:.4f} ms (x "
                f"{ms['ranked'] / ms['flat']:.2f}); ranked vs flat rel "
                f"{rel:.2e} (gate {tol:.0e})")
            assert rel <= tol, f"read path {name}: ranked disagrees with flat"
            out[f"{name}_{m}"] = ms
    return out


# -- phase 6: the rounding pass on the main path's operator -------------------------------


def rounding_phase(op, K, g, eps: float = 1e-6) -> dict:
    """``op.round(eps)`` on the compressed main-path operator, flat (one
    r_max-wide batch: QR of the (nt, b, r_max) factor stacks, SVD of the
    (nt, r_max, r_max) cores) and ranked (the same per rank bucket at its
    width), each timed on its second call. Gates for each: the QR and SVD
    kernels ran, no tile's rank rose, and the rounded operator's matvec is
    within 1e-5 (relative) of the dense ``K x``."""
    import torch
    from repro_torch.kernels import ops

    x = torch.randn((K.shape[0],), generator=g, device="cuda", dtype=K.dtype)
    y = K @ x
    out, ranks = {}, {}
    r0 = op.A.ranks
    for batching in ("flat", "ranked"):
        op.round(eps, batching=batching)     # warm: module loading
        ops.reset_launch_counts()
        rop, sec = sync_time(lambda: op.round(eps, batching=batching))
        launches = ops.launch_counts()
        shapes = path_shapes()
        log_shapes(f"round path ({batching})", shapes)
        r1 = ranks[batching] = rop.A.ranks
        mv_err = float((rop @ x - y).norm() / y.norm())
        log(f"rounding phase ({batching}): op.round({eps:g}) in {sec:.3f} "
            f"s; launches {json.dumps(launches)}; ranks max {int(r0.max())} "
            f"-> {int(r1.max())}, mean {float(r0.float().mean()):.2f} -> "
            f"{float(r1.float().mean()):.2f}, {int((r1 < r0).sum())} of "
            f"{r0.numel()} tiles lower; matvec rel err {mv_err:.3e} (gate "
            f"1e-5)")
        for name in ("batched_qr", "small_svd"):
            assert launches[name] > 0, \
                f"{name} not launched by op.round ({batching})"
        assert bool((r1 <= r0).all()), f"op.round ({batching}) raised a rank"
        assert mv_err <= 1e-5, \
            f"rounded operator's matvec ({batching}) disagrees with K"
        out[f"round_{batching}"] = (launches, shapes)
        del rop
    log(f"rounding phase: ranks flat vs ranked differ in "
        f"{int((ranks['flat'] != ranks['ranked']).sum())} of {r0.numel()} "
        f"tiles (max |diff| "
        f"{int((ranks['flat'] - ranks['ranked']).abs().max())})")
    return out


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
    over them, the live ranks of the call with the most live columns) from
    a ``gemm_rank_log``."""
    import torch
    out = {}
    for (T, m, k, n), rs in calls.items():
        live = torch.stack(rs).clamp(0, k)
        out[(T, m, k, n)] = (len(rs), live.double().mean(dim=0),
                             live[int(live.sum(dim=1).argmax())])
    return out


def gemm_shapes_line(shapes: dict) -> str:
    return ", ".join(
        f"{shape} {c} (live rank mean {float(r.mean()):.2f}, max "
        f"{float(r.max()):.0f})"
        for shape, (c, r, _) in sorted(shapes.items(), reverse=True))


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
            count, mean, _ = count
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
    1e-8 with r_max 128, factored by the right-looking driver: Cholesky and
    LDL^T, each with flat and with ranked batching, and the ranked Cholesky
    again at accumulation cadences (``right_flush``) 2 and 4. Gates per
    factorization: the QR, SVD and GEMM kernels ran, the randomized
    residual ``||K z - L D L^T z|| / ||K z|| <= 100 eps`` holds and a solve
    is finite. Logs flushes, append widths, peak memory and
    ``small_svd``'s, ``batched_qr``'s and ``batched_gemm``'s launches per
    shape and, after all four, their times per shape."""
    import dataclasses

    import torch
    from repro_torch import CholOptions, TLROperator, covariance_problem
    from repro_torch.kernels import ops

    tile, eps = TILE_RIGHT, EPS
    _, K = covariance_problem(n, 2, tile, device="cuda")
    op, t_comp = sync_time(lambda: TLROperator.compress(
        K, tile, r_max=R_MAX, eps=1e-8, method="svd"))
    ra = op.A.ranks.float()
    log(f"right phase: 2-D exp covariance N={n} tile={tile} "
        f"(nb={n // tile}, nt={op.A.U.shape[0]}); compress {t_comp:.2f} s, "
        f"A ranks max {int(ra.max())} mean {float(ra.mean()):.2f} median of "
        f"the positive {op.plan().median_rank}")
    g = torch.Generator(device="cuda").manual_seed(2)
    Z = torch.randn((n, 3), generator=g, device="cuda", dtype=K.dtype)
    KZ = K @ Z
    y = K @ torch.randn((n,), generator=g, device="cuda", dtype=K.dtype)
    out = {}
    base = CholOptions(eps=eps, algo="right")
    # (kind, batching, right_flush; 0 is the policy's cadence): the ranked
    # Cholesky also at cadences 2 and 4, for its time against peak memory
    runs = [(kind, b, 0) for kind in ("cholesky", "ldlt")
            for b in ("flat", "ranked")]
    runs += [("cholesky", "ranked", f) for f in (2, 4)]
    for kind, batching, flush in runs:
        key = (f"right_{kind}" + ("" if batching == "flat" else "_ranked")
               + (f"_flush{flush}" if flush else ""))
        opts = dataclasses.replace(base, batching=batching,
                                   right_flush=flush)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        with gemm_rank_log() as gemm_calls:
            fact, sec = timed(lambda: getattr(op, kind)(opts),
                              profile if kind == "cholesky" and not flush
                              else None,
                              key)
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        shapes = {"small_svd": path_shapes()["small_svd"],
                  "batched_qr": path_shapes()["batched_qr"],
                  "batched_gemm": gemm_shapes(gemm_calls)}
        resid = right_residual(fact, Z, KZ)
        x, t_solve = sync_time(lambda: fact.solve(y))
        st = fact.stats
        rl = fact.L.ranks.float()
        aw = st["append_widths"]
        log(f"{key}: factor {sec:.3f} s, batching {st['batching']}, policy "
            f"right_flush {st['policy']['right_flush']}, {st['flushes']} "
            f"flushes, acc_width {st['acc_width']}, append widths "
            f"{dict(sorted(collections.Counter(aw).items())) or None}, peak "
            f"memory {peak / 2**30:.2f} GiB, L ranks max {int(rl.max())} "
            f"mean {float(rl.mean()):.2f}, modified_chol "
            f"{st['modified_chol']}, stage seconds "
            f"{json.dumps({k: round(v, 3) for k, v in st['schedule']['kind_seconds'].items()})}; "
            f"residual {resid:.3e} (gate {100 * eps:.0e}); solve "
            f"{t_solve:.3f} s; launches {json.dumps(launches)}")
        for name in ROUND_KERNELS:
            assert launches[name] > 0, \
                f"kernel {name} was not launched by {key}"
        assert resid <= 100 * eps, f"{key}: residual above 100 eps"
        assert bool(torch.isfinite(x).all()), f"{key}: solve not finite"
        out[key] = launches
        out[f"{key}_seconds"] = sec
        out[f"{key}_shapes"] = shapes
        out[f"{key}_max_rank"] = int(rl.max())
        log(f"{key}: small_svd launches per (T, m, n): "
            f"{shapes_line(shapes['small_svd'])}; batched_qr per (T, b, r): "
            f"{shapes_line(shapes['batched_qr'])}")
        log(f"{key}: batched_gemm launches per (T, m, k, n): "
            f"{gemm_shapes_line(shapes['batched_gemm'])}")
        del fact, x, gemm_calls
    out.update(lookahead_phase(op, Z, KZ, y))
    out.update(telemetry_right_phase(op))
    out.update(fault_phase(op, out["right_cholesky_max_rank"]))
    out.update(mixed_phase(op, K, Z))
    del op, K, KZ, Z
    torch.cuda.empty_cache()
    for kind, batching, flush in runs:
        if flush:
            continue
        key = f"right_{kind}" + ("" if batching == "flat" else "_ranked")
        for name in ("small_svd", "batched_qr", "batched_gemm"):
            log(f"{key}: {name} per shape (f64, timed apart from the "
                f"path):")
            sec = shape_times(name, out[f"{key}_shapes"][name])
            log(f"{key}: {name} {sec:.3f} s of the factorization's "
                f"{out[f'{key}_seconds']:.3f} s")
    return out


# -- phase 8: the fractional-diffusion PCG path (paper section 6.2) ---------------


def rank_histogram(ranks, cap: int) -> str:
    """Tiles per rank range: 0, 1-16, 17-32, 33-64, ... up to ``cap``."""
    r = ranks.cpu()
    edges = [0, 1, 17]
    while edges[-1] <= cap:
        edges.append(2 * edges[-1] - 1)
    parts = []
    for lo, hi in zip(edges, edges[1:]):
        count = int(((r >= lo) & (r < hi)).sum())
        if count:
            parts.append(f"{lo}" + (f"-{min(hi - 1, cap)}" if hi - 1 > lo
                                    else "") + f": {count}")
    return ", ".join(parts)


def frac_pcg_phase(profile: str | None = None) -> dict:
    """The 3-D fractional-diffusion operator (``FRAC_N``, tile
    ``FRAC_TILE``) built on the card and compressed at 1e-10 with r_max =
    tile; for each eps of ``FRAC_EPS``, ``tlr_add_diag(op.A, eps)`` factored
    by the left-looking Cholesky (``CholOptions(eps=eps, bs=16)``, batching
    "auto"; a diagonal shift leaves every off-diagonal tile as it is, so
    this is exactly the compression of K + eps I) and used by ``pcg`` as
    the preconditioner of the compressed operator; then ``pcg`` without
    one. Gates: final relative residual below 1e-6 and ``||K x - b|| /
    ||b|| < 1e-5`` with the dense K for each preconditioned solve; fewer
    iterations at 1e-2 than without, no more at 1e-4 than at 1e-2. With
    ``profile``, the factorization at the first eps runs under
    torch.profiler (``timed``)."""
    import numpy as np
    import torch
    from repro_torch import CholOptions, TLROperator, pcg
    from repro_torch.core import (fractional_diffusion_matrix,
                                  fractional_diffusion_points, tlr_add_diag)
    from repro_torch.kernels import ops

    n, tile = FRAC_N, FRAC_TILE
    pts = fractional_diffusion_points(n, tile)
    torch.cuda.reset_peak_memory_stats()
    K, t_build = sync_time(lambda: fractional_diffusion_matrix(
        pts, s=FRAC_S, device="cuda"))
    log(f"frac pcg: 3-D fractional diffusion N={n} s={FRAC_S} tile={tile} "
        f"(nb={n // tile}) built on the card in {t_build:.2f} s (peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
    ops.reset_launch_counts()
    with gemm_rank_log() as gemm_calls:
        op, t_comp = sync_time(lambda: TLROperator.compress(K, tile,
                                                            eps=1e-10))
        ra = op.A.ranks
        log(f"frac pcg: compress eps=1e-10 r_max={op.r_max} in {t_comp:.2f} "
            f"s; A ranks max {int(ra.max())} mean "
            f"{float(ra.float().mean()):.2f}, histogram "
            f"{rank_histogram(ra, op.r_max)}")
        assert int(ra.max()) < op.r_max, "frac pcg: compression clipped"
        rhs = torch.as_tensor(np.random.default_rng(0).standard_normal(n),
                              device="cuda")
        bnorm = float(rhs.norm())
        iters = {}
        for eps in FRAC_EPS:
            torch.cuda.reset_peak_memory_stats()
            op_eps = TLROperator(tlr_add_diag(op.A, eps))
            fact, t_fact = timed(lambda: op_eps.cholesky(
                CholOptions(eps=eps, bs=16)),
                profile if eps == FRAC_EPS[0] else None, "frac_factor")
            peak = torch.cuda.max_memory_allocated()
            (x, it, hist), t_pcg = sync_time(lambda: pcg(
                op, rhs, precond=fact, tol=1e-6, maxiter=300))
            true = float((K @ x - rhs).norm()) / bnorm
            left_summary(fact, f"frac pcg eps={eps:g}", op.r_max)
            log(f"frac pcg eps={eps:g}: factor {t_fact:.3f} s (peak "
                f"{peak / 2**30:.2f} GiB), batching {fact.stats['batching']}"
                f"; pcg {it} iterations in {t_pcg:.3f} s, relative "
                f"residual {hist[-1]:.3e} (gate 1e-6), ||K x - b||/||b|| "
                f"{true:.3e} (gate 1e-5), breakdown {hist.breakdown}")
            assert hist.breakdown is None and hist[-1] < 1e-6, \
                f"frac pcg eps={eps:g}: pcg did not converge"
            assert true < 1e-5, f"frac pcg eps={eps:g}: K x far from b"
            iters[eps] = it
            del fact, op_eps, x
        (x, it_plain, hist), t_plain = sync_time(lambda: pcg(
            op, rhs, tol=1e-6, maxiter=300))
    launches = ops.launch_counts()
    shapes = path_shapes()
    shapes["batched_gemm"] = gemm_shapes(gemm_calls)
    log(f"frac pcg: unpreconditioned pcg {it_plain} iterations in "
        f"{t_plain:.3f} s, relative residual {hist[-1]:.3e}; iterations "
        f"{json.dumps({f'{e:g}': i for e, i in iters.items()})}; launches "
        f"{json.dumps(launches)}")
    for name in ("lr_sample", "tile_chain"):
        log(f"frac pcg: {name} launches per shape: "
            f"{shapes_line(shapes[name])}")
    log(f"frac pcg: batched_gemm launches per (T, m, k, n): "
        f"{gemm_shapes_line(shapes['batched_gemm'])}")
    for name in MAIN_KERNELS:
        assert launches[name] > 0, f"frac pcg: {name} was not launched"
    e1, e2 = FRAC_EPS
    assert iters[e1] < it_plain, \
        f"frac pcg: eps={e1:g} took {iters[e1]} iterations, plain {it_plain}"
    assert iters[e2] <= iters[e1], \
        f"frac pcg: eps={e2:g} took more iterations than eps={e1:g}"
    del x
    served = serve_frac_phase(op, K, FRAC_EPS[0])
    del op, K
    torch.cuda.empty_cache()
    return {"launches": launches, "shapes": shapes, **served}


# -- phase 9: the Newton-Schulz TLR inverse as preconditioner --------------------


def frac_ns_phase(profile: str | None = None) -> dict:
    """The fractional-diffusion operator at ``NS_N``, tile ``NS_TILE``,
    compressed at 1e-10; ``tlr_newton_schulz(op, iters, eps=NS_EPS,
    scale="norm")`` for each count of ``NS_ITERS`` (flat, the default) and
    ranked at the last, each used by ``pcg``; one ``op.compose(op,
    NS_EPS)``. Gates: each Newton-Schulz PCG ends below 1e-6, and the best
    takes fewer iterations than plain PCG (the example's ``--check``); ranked X within 1e-8 of flat (relative,
    Frobenius); the composed product within 1e-6 of the dense ``K @ K``
    (relative, Frobenius). The product is compressed at NS_EPS: the
    threshold is absolute and per tile, and the tiles of K @ K keep
    singular values above 1e-6 far down their spectra, so at 1e-6 the
    truncation alone would leave more than 1e-6 of ||K @ K||. With
    ``profile``, the
    flat build at the last iteration count runs under torch.profiler."""
    import numpy as np
    import torch
    from repro_torch import TLROperator, pcg, tlr_newton_schulz
    from repro_torch.core import (fractional_diffusion_matrix,
                                  fractional_diffusion_points)
    from repro_torch.core.algebra import gemm_chunks
    from repro_torch.kernels import ops

    n, tile = NS_N, NS_TILE
    K = fractional_diffusion_matrix(fractional_diffusion_points(n, tile),
                                    s=FRAC_S, device="cuda")
    ops.reset_launch_counts()
    with gemm_rank_log() as gemm_calls:
        op, t_comp = sync_time(lambda: TLROperator.compress(K, tile,
                                                            eps=1e-10))
        ra = op.A.ranks
        log(f"frac ns: 3-D fractional diffusion N={n} tile={tile} "
            f"(nb={op.nb}); compress eps=1e-10 in {t_comp:.2f} s, A ranks "
            f"max {int(ra.max())} mean {float(ra.float().mean()):.2f} "
            f"(r_max {op.r_max}); tlr_gemm middle terms in "
            f"{gemm_chunks(op.nb, tile, op.r_max, op.r_max)} chunks of "
            f"output tiles (flat)")
        assert int(ra.max()) < op.r_max, "frac ns: compression clipped"
        rhs = torch.as_tensor(np.random.default_rng(0).standard_normal(n),
                              device="cuda")
        (_, it_plain, hist), t_plain = sync_time(lambda: pcg(
            op, rhs, tol=1e-6, maxiter=300))
        log(f"frac ns: unpreconditioned pcg {it_plain} iterations in "
            f"{t_plain:.3f} s, relative residual {hist[-1]:.3e}")
        X, best = {}, it_plain
        for iters, batching in [(i, "flat") for i in NS_ITERS] + [
                (NS_ITERS[-1], "ranked")]:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            (Xop, info), t_build = timed(lambda: tlr_newton_schulz(
                op, iters=iters, eps=NS_EPS, scale="norm",
                batching=batching), profile if (iters, batching) == (
                    NS_ITERS[-1], "flat") else None, "frac_ns_build")
            peak = torch.cuda.max_memory_allocated()
            (x, it, hist), t_pcg = sync_time(lambda: pcg(
                op, rhs, precond=Xop, tol=1e-6, maxiter=300))
            log(f"frac ns iters={iters} {batching}: build {t_build:.3f} s "
                f"(peak {peak / 2**30:.2f} GiB), alpha {info.alpha:.6e}, X "
                f"ranks mean {info.avg_rank:.2f} max {info.max_rank}; pcg "
                f"{it} iterations in {t_pcg:.3f} s (plain {it_plain}), "
                f"relative residual {hist[-1]:.3e}")
            assert hist.breakdown is None and hist[-1] < 1e-6, \
                f"frac ns iters={iters} {batching}: pcg did not converge"
            best = min(best, it)
            X[(iters, batching)] = Xop.to_dense()
            del Xop, x
        Xf, Xr = X[(NS_ITERS[-1], "flat")], X[(NS_ITERS[-1], "ranked")]
        rel_x = float((Xr - Xf).norm() / Xf.norm())
        del X, Xf, Xr
        C, t_comp2 = sync_time(lambda: op.compose(op, NS_EPS))
        KK = K @ K
        rel_c = float((C.to_dense() - KK).norm() / KK.norm())
    launches = ops.launch_counts()
    shapes = path_shapes()
    shapes["batched_gemm"] = gemm_shapes(gemm_calls)
    cr = C.ranks.float()
    log(f"frac ns: ranked X vs flat rel {rel_x:.3e} (gate 1e-8); "
        f"op.compose(op, {NS_EPS:g}) in {t_comp2:.3f} s, ranks max "
        f"{int(cr.max())} mean {float(cr.mean()):.2f}, vs dense K @ K rel "
        f"{rel_c:.3e} (gate 1e-6); launches {json.dumps(launches)}")
    for name in ("batched_qr", "small_svd"):
        log(f"frac ns: {name} launches per shape: "
            f"{shapes_line(shapes[name])}")
    log(f"frac ns: batched_gemm launches per (T, m, k, n): "
        f"{gemm_shapes_line(shapes['batched_gemm'])}")
    for name in ROUND_KERNELS:
        assert launches[name] > 0, f"frac ns: {name} was not launched"
    assert best < it_plain, \
        f"frac ns: Newton-Schulz pcg took {best} iterations, plain {it_plain}"
    assert rel_x <= 1e-8, "frac ns: ranked Newton-Schulz differs from flat"
    assert rel_c <= 1e-6, "frac ns: op.compose(op) differs from K @ K"
    del op, K, KK, C
    torch.cuda.empty_cache()
    return {"launches": launches, "shapes": shapes}


# -- phase 10: the right driver's lookahead schedule ---------------------------------


def factor_diff(a, b) -> tuple[float, bool]:
    """Max over L.D, L.U, L.V (and d) of max |a - b| / max |b|, and whether
    every one of them is bitwise equal."""
    import torch
    pairs = [(a.L.D, b.L.D), (a.L.U, b.L.U), (a.L.V, b.L.V)]
    if b.d is not None:
        pairs.append((a.d, b.d))
    rel = max(float((x - y).abs().max() / y.abs().max()) for x, y in pairs)
    same = all(torch.equal(x, y) for x, y in pairs) and \
        torch.equal(a.L.ranks, b.L.ranks)
    return rel, same


def right_residual(fact, Z, KZ) -> float:
    """max_z ||K z - L D L^T z|| / ||K z|| over the columns of Z."""
    LtZ = fact.tri_matvec(Z, trans=True)
    if fact.d is not None:
        LtZ = LtZ * fact.d.reshape(-1, 1)
    return float(((KZ - fact.tri_matvec(LtZ)).norm(dim=0)
                  / KZ.norm(dim=0)).max())


def lookahead_phase(op, Z, KZ, y) -> dict:
    """The right-looking driver under ``lookahead=True`` on the
    cov2d-8k-right operator: Cholesky and LDL^T, flat and ranked, each
    beside the sequential run of the same options (sequential first, then
    lookahead). Gates: the lookahead factor within 1e-12 of the sequential
    one (max abs over L.D, L.U, L.V and d, relative to the sequential
    array's max), the right phase's residual gate, a finite solve, the QR,
    SVD and GEMM kernels launched and the second CUDA stream in use. Logs
    both wall times, the bitwise status, peak memory, flushes, append
    widths and the first 8 stages of the executed order."""
    import dataclasses

    import torch
    from repro_torch import CholOptions
    from repro_torch.kernels import ops

    out = {}
    for kind in ("cholesky", "ldlt"):
        for batching in ("flat", "ranked"):
            key = f"right_{kind}_{batching}_lookahead"
            opts = CholOptions(eps=EPS, algo="right", batching=batching)
            seq, t_seq = sync_time(lambda: getattr(op, kind)(opts))
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            la, t_la = sync_time(lambda: getattr(op, kind)(
                dataclasses.replace(opts, lookahead=True)))
            launches = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            rel, same = factor_diff(la, seq)
            resid = right_residual(la, Z, KZ)
            x = la.solve(y)
            st, sched = la.stats, la.stats["schedule"]
            aw = st["append_widths"]
            log(f"{key}: factor {t_la:.3f} s (sequential {t_seq:.3f} s, "
                f"ratio {t_la / t_seq:.3f}); against sequential max rel "
                f"diff {rel:.3e} (gate 1e-12), bitwise "
                f"{'yes' if same else 'no'}; peak memory "
                f"{peak / 2**30:.2f} GiB; {st['flushes']} flushes "
                f"(sequential {seq.stats['flushes']}), append widths "
                f"{dict(sorted(collections.Counter(aw).items())) or None}; "
                f"schedule {sched['name']}, streams {sched['streams']}, "
                f"first stages {sched['order'][:8]}; stage seconds "
                f"{json.dumps({k: round(v, 3) for k, v in sched['kind_seconds'].items()})}; "
                f"residual {resid:.3e} (gate {100 * EPS:.0e}); launches "
                f"{json.dumps(launches)}")
            for name in ROUND_KERNELS:
                assert launches[name] > 0, \
                    f"kernel {name} was not launched by {key}"
            assert sched["name"] == "lookahead" and sched["streams"] == 2, \
                f"{key}: the tail updates did not run on a second stream"
            assert rel <= 1e-12, f"{key}: lookahead factor differs from " \
                f"the sequential one by {rel:.3e}"
            assert st["flushes"] == seq.stats["flushes"]
            assert resid <= 100 * EPS, f"{key}: residual above 100 eps"
            assert bool(torch.isfinite(x).all()), f"{key}: solve not finite"
            out[key] = launches
            out[f"{key}_seconds"] = (t_seq, t_la)
            del seq, la, x
    return out


# -- phase 11: inter-tile pivoting (Algorithm 9) on the main path's operator -----


def pivot_phase(op, K, Z, y, x_true, opts, t_plain: float) -> dict:
    """The left-looking Cholesky of the main path's compressed operator
    with ``pivot="frobenius"`` and ``pivot="power"``. Gates: the sampling
    kernels launched, the randomized residual of ``P K P^T`` within 100
    eps, a finite solve. Logs the pivot sequence, the columns that swapped
    and the time against the unpivoted factorization's (warm)."""
    import dataclasses

    import torch
    from repro_torch.kernels import ops

    out = {}
    for pivot in ("frobenius", "power"):
        key = f"main_pivot_{pivot}"
        ops.reset_launch_counts()
        fact, sec = sync_time(lambda: op.cholesky(
            dataclasses.replace(opts, pivot=pivot)))
        launches = ops.launch_counts()
        resid = left_residual(K, fact, Z)
        x = fact.solve(y)
        err = float((x - x_true).norm() / x_true.norm())
        piv = fact.stats["pivots"]
        swapped = sum(int(p != k) for k, p in enumerate(piv))
        log(f"{key}: factor {sec:.3f} s (unpivoted, warm: {t_plain:.3f} s, "
            f"ratio {sec / t_plain:.3f}); pivots {piv}; {swapped} of "
            f"{len(piv)} columns swapped; perm {fact.perm.tolist()}; "
            f"residual of P K P^T {resid:.3e} (gate {100 * EPS:.0e}); "
            f"solve rel err {err:.3e}; batching {fact.stats['batching']}; "
            f"launches {json.dumps(launches)}")
        for name in MAIN_KERNELS:
            assert launches[name] > 0, \
                f"kernel {name} was not launched by {key}"
        assert len(piv) == op.nb and \
            sorted(fact.perm.tolist()) == list(range(op.nb))
        assert resid <= 100 * EPS, f"{key}: residual above 100 eps"
        assert bool(torch.isfinite(x).all()), f"{key}: solve not finite"
        out[key] = launches
        del fact, x
    return out


# -- phase 12: health checks on the main path ------------------------------------------


def check_phase(op, fact, opts, t_plain: float) -> dict:
    """``check=True`` on the main path's default left Cholesky: the factor
    within 1e-12 of the unchecked one (``fact``), no health event, every
    column checked. Logs the bitwise status and the clean-path overhead
    against the unchecked factorization's warm time."""
    import dataclasses

    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    fc, sec = sync_time(lambda: op.cholesky(
        dataclasses.replace(opts, check=True)))
    launches = ops.launch_counts()
    rel, same = factor_diff(fc, fact)
    h = fc.stats["health"]
    log(f"main_check: factor {sec:.3f} s (unchecked, warm: {t_plain:.3f} s; "
        f"overhead {sec - t_plain:+.3f} s); against check=False max rel "
        f"diff {rel:.3e} (gate 1e-12), bitwise {'yes' if same else 'no'}; "
        f"columns_checked {h['columns_checked']}, events {h['events']}, "
        f"check seconds {fc.stats['schedule']['kind_seconds'].get('check', 0):.3f}; "
        f"launches {json.dumps(launches)}")
    for name in MAIN_KERNELS:
        assert launches[name] > 0, f"kernel {name} was not launched by " \
            "main_check"
    assert rel <= 1e-12, f"main_check: factor differs by {rel:.3e}"
    assert h["events"] == [] and h["columns_checked"] == op.nb
    return {"main_check": launches}


# -- phase 13: the TLR inference server -----------------------------------------


def rel_err(a, b) -> float:
    """||a - b|| / ||b|| of two host arrays."""
    import numpy as np
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def drive_server(label: str, srv, reqs, t_warm: float, faults_=()) -> dict:
    """Submit ``reqs`` to the warm server ``srv`` and drain it, with the
    kernels' launch counts set to 0 just before and read just after, and
    the ``trace_counts`` registry snapshot taken after warmup. Gates: every
    rid completes exactly once and no new dispatch shape appears. Logs
    warmup seconds, ticks, occupancy, requests/s, p50 / p99 per kind, peak
    memory and the kernels' launches during the drain."""
    import torch
    from repro_torch import faults
    from repro_torch.core import trace_counts, trace_counts_diff
    from repro_torch.kernels import ops
    from repro_torch.serve import KINDS

    snap = trace_counts()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [srv.submit(r) for r in reqs]
    with (faults.inject(*faults_) if faults_ else contextlib.nullcontext()):
        results = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    new_shapes = trace_counts_diff(snap)
    st = srv.stats
    summ = st.summary()
    lat = {k: summ[f"latency_{k}"] for k in KINDS if f"latency_{k}" in summ}
    log(f"{label}: warmup {t_warm:.3f} s; {st.completed} requests in "
        f"{st.ticks} ticks, drain {wall:.3f} s ({st.completed / wall:.1f} "
        f"requests/s; tick seconds {summ['wall_s']:.3f}, "
        f"{summ['requests_per_s']:.1f} requests/s), occupancy "
        f"{st.occupancy():.4f}, slots active per tick {st.tick_active}")
    log(f"{label}: latency ms p50 / p99 per kind: " + ", ".join(
        f"{k} {v['p50_s'] * 1e3:.2f} / {v['p99_s'] * 1e3:.2f} "
        f"({v['count']})" for k, v in lat.items()))
    log(f"{label}: peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB; health {json.dumps(summ['health'])}; kernel launches during "
        f"the drain {json.dumps(launches)}; trace registry "
        f"{json.dumps(trace_counts())}, new shapes {json.dumps(new_shapes)}")
    assert sorted(results) == sorted(rids) == list(range(len(reqs))), \
        f"{label}: not every request completed"
    assert st.completed == len(reqs), f"{label}: a request completed twice"
    assert new_shapes == {}, f"{label}: new dispatch shapes {new_shapes}"
    return {"results": results, "launches": launches, "wall": wall,
            "stats": summ}


def serve_main_phase(op, fact, K) -> dict:
    """The server on the main path's operator and factor:
    ``fact.serve(operator=op, slots=SERVE_SLOTS, check_every=4)``, the 64
    requests of ``serve_requests``, one solve column poisoned by a
    ``serve.solve`` fault. Gates: each solve within 1e-10 of
    ``fact.solve`` on its column, each sample within 1e-10
    of ``fact.sample(z=draw)``, logdet equal to the memoized value, each
    pcg_solve converged with ``||K x - b|| / ||b|| < 1e-5``, the poisoned
    rid a ``nonfinite_result``, and ``drive_server``'s. Logs whether the
    batched solves and the first pcg_solve equal their sequential runs bit
    for bit."""
    import numpy as np
    import torch
    from repro_torch import faults, pcg
    from repro_torch.serve import KINDS

    n = fact.n
    torch.cuda.reset_peak_memory_stats()
    srv, t_warm = sync_time(lambda: fact.serve(
        operator=op, slots=SERVE_SLOTS, check_every=SERVE_CHECK))
    reqs = serve_requests(n)
    poisoned = len(KINDS)           # the second solve request's rid
    out = drive_server("serve cov2d-32k", srv, reqs, t_warm, (faults.Fault(
        site="serve.solve", rid=poisoned),))
    results = out["results"]
    bad = results[poisoned]
    assert not bad.ok and bad.error == "nonfinite_result", \
        f"serve: poisoned rid {poisoned} ended as {bad.error}"
    memo = srv._residents["default"].logdet
    errs = {k: 0.0 for k in KINDS}
    bitwise = {"solve": True}
    for r in reqs:
        res = results[r.rid]
        if r.rid == poisoned:
            continue
        assert res.ok, f"serve: rid {r.rid} ({r.kind}) failed: {res.error}"
        if r.kind == "solve":
            want = fact.solve(torch.as_tensor(r.rhs, device="cuda")).cpu()
            errs["solve"] = max(errs["solve"], rel_err(res.value,
                                                       want.numpy()))
            bitwise["solve"] &= bool(np.array_equal(res.value, want.numpy()))
        elif r.kind == "sample":
            z = torch.randn((n, 1), generator=r.sample_generator(),
                            dtype=fact.dtype)
            want = fact.sample(z=z.to("cuda")).cpu().numpy()
            errs["sample"] = max(errs["sample"], rel_err(res.value, want))
        elif r.kind == "logdet":
            assert res.value == memo, "serve: logdet differs from the memo"
        else:
            assert res.converged and res.breakdown is None, \
                f"serve: pcg_solve rid {r.rid} did not converge"
            x = torch.as_tensor(res.value, device="cuda")
            b = torch.as_tensor(r.rhs, device="cuda")
            errs["pcg_solve"] = max(errs["pcg_solve"], float(
                (K @ x - b).norm() / b.norm()))
    first = next(r for r in reqs if r.kind == "pcg_solve")
    xs, its, _ = pcg(op, torch.as_tensor(first.rhs, device="cuda"),
                     precond=fact, tol=first.tol, maxiter=first.maxiter,
                     check_every=SERVE_CHECK)
    bitwise["pcg_solve"] = bool(np.array_equal(results[first.rid].value,
                                               xs.cpu().numpy()))
    iters = sorted(results[r.rid].iterations for r in reqs
                   if r.kind == "pcg_solve")
    logdet_now = float(fact.logdet())
    log(f"serve cov2d-32k: solve max rel err {errs['solve']:.3e} (gate "
        f"1e-10), sample {errs['sample']:.3e} (gate 1e-10), logdet memo "
        f"{memo!r} (a fresh fact.logdet() {logdet_now!r}), pcg_solve "
        f"iterations {iters}, max ||Kx - b||/||b|| {errs['pcg_solve']:.3e} "
        f"(gate 1e-5); poisoned rid {poisoned}: {bad.error}, every other "
        f"request ok; batched vs sequential bit for bit: solve "
        f"{'yes' if bitwise['solve'] else 'no'}, pcg_solve rid {first.rid} "
        f"{'yes' if bitwise['pcg_solve'] else 'no'} (scalar {its} "
        f"iterations, batched {results[first.rid].iterations})")
    assert errs["solve"] <= 1e-10, "serve: a solve differs from fact.solve"
    assert errs["sample"] <= 1e-10, "serve: a sample differs from fact.sample"
    assert errs["pcg_solve"] < 1e-5, "serve: a pcg_solve is far from K^-1 b"
    del srv
    return {"serve": out["launches"]}


def serve_frac_phase(op, K, eps: float) -> dict:
    """The server on frac3d-32k-pcg's compressed operator with the loose
    Cholesky of ``tlr_add_diag(op.A, eps)`` as preconditioner, factored
    here again (as frac3d-32k-pcg factors it, after its launch counts were
    read, so that no earlier phase holds two factors at once;
    benchmarks/bench_tlr.py::bench_serve's shape at the paper's section
    6.2 size): FRAC_SERVE_REQUESTS pcg_solve requests (tol 1e-6, maxiter
    300, rhs from ``default_rng(1)``) into SERVE_SLOTS slots, so columns
    refill mid-flight. Gates: every request converges with ``||K x - b|| /
    ||b|| < 1e-5``, the first two within 2 iterations of scalar ``pcg`` on
    the same rhs, occupancy >= 0.8, and ``drive_server``'s. Logs whether
    the batched and scalar iterates agree bit for bit."""
    import numpy as np
    import torch
    from repro_torch import CholOptions, TLROperator, pcg
    from repro_torch.core import tlr_add_diag
    from repro_torch.serve import ServeRequest

    n = op.n
    torch.cuda.reset_peak_memory_stats()
    fact, t_fact = sync_time(lambda: TLROperator(
        tlr_add_diag(op.A, eps)).cholesky(CholOptions(eps=eps, bs=16)))
    log(f"serve frac3d-32k: resident Cholesky at eps={eps:g} in "
        f"{t_fact:.3f} s")
    srv, t_warm = sync_time(lambda: fact.serve(
        operator=op, slots=SERVE_SLOTS, check_every=SERVE_CHECK))
    rng = np.random.default_rng(1)
    reqs = [ServeRequest("pcg_solve", rhs=rng.standard_normal(n), tol=1e-6,
                         maxiter=300) for _ in range(FRAC_SERVE_REQUESTS)]
    out = drive_server("serve frac3d-32k", srv, reqs, t_warm)
    results = out["results"]
    worst = 0.0
    for r in reqs:
        res = results[r.rid]
        assert res.ok and res.converged, \
            f"serve frac: rid {r.rid} did not converge ({res.breakdown})"
        x = torch.as_tensor(res.value, device="cuda")
        b = torch.as_tensor(r.rhs, device="cuda")
        worst = max(worst, float((K @ x - b).norm() / b.norm()))
    scalar = []
    for r in reqs[:2]:
        (xs, its, _), t_s = sync_time(lambda: pcg(
            op, torch.as_tensor(r.rhs, device="cuda"), precond=fact,
            tol=r.tol, maxiter=r.maxiter, check_every=SERVE_CHECK))
        res = results[r.rid]
        scalar.append((its, res.iterations, t_s, bool(np.array_equal(
            res.value, xs.cpu().numpy())), rel_err(res.value,
                                                   xs.cpu().numpy())))
    iters = [results[r.rid].iterations for r in reqs]
    occ = out["stats"]["occupancy"]
    log(f"serve frac3d-32k: pcg_solve iterations {iters}, max "
        f"||Kx - b||/||b|| {worst:.3e} (gate 1e-5), occupancy {occ:.4f} "
        f"(gate 0.8); first two against scalar pcg (iterations scalar / "
        f"batched, scalar seconds, bit for bit, rel diff): " + "; ".join(
            f"{a} / {b}, {t:.3f} s, {'yes' if same else 'no'}, {d:.3e}"
            for a, b, t, same, d in scalar))
    assert worst < 1e-5, "serve frac: a pcg_solve is far from K^-1 b"
    for its, it_b, *_ in scalar:
        assert abs(its - it_b) <= 2, \
            f"serve frac: batched {it_b} iterations, scalar {its}"
    assert occ >= 0.8, f"serve frac: occupancy {occ:.3f} < 0.8"
    del srv
    return {"frac_serve": out["launches"]}


# -- phase 14: the fault matrix ------------------------------------------------------


def spike_scale(b: int, r: int, R: int, seed: int) -> tuple[float, float]:
    """The ``scale`` of ``faults.spike_rank(..., seed=seed)`` (an r-wide
    factor pair on a b-row tile) that puts the spike's (R+1)-th singular
    value at 2e-6 -- over eps = 1e-6, so a factorization capped at rank R
    overflows there -- and the norm of its singular values past R at that
    scale (within the policy's eps floor, 1.6e-5, so a remedy can accept
    it). The pair is numpy's draw, as the mutator makes it."""
    import numpy as np
    rng = np.random.default_rng(seed)
    Us, Vs = rng.standard_normal((b, r)), rng.standard_normal((b, r))
    s = np.linalg.svd(Us @ Vs.T, compute_uv=False)
    scale = math.sqrt(2e-6 / s[R])
    return scale, float(np.sqrt((s[R:] ** 2).sum())) * scale ** 2


def fault_phase(op, natural_rank: int) -> dict:
    """The fault matrix of tests/test_health.py on the cov2d-8k-right
    operator, ``check=True``, each case on the drivers the JAX package's
    test runs it on: an indefinite diagonal tile at column nb - 2 recovers
    (left, right, right with lookahead) with spd_breakdown events at its
    column and finite factors (at column 2 the right driver either ends
    with finite factors or raises a breakdown: logged); a rank spike under ``r_max_out`` recovers on the left
    (an eps_loosen remedy) and is accepted on the right; a NaN diagonal
    tile raises ``FactorizationBreakdown(spd_breakdown)`` at its column and
    a NaN panel ``FactorizationBreakdown(nonfinite_panel)`` at its column
    (left, right). A breakdown that does not come, or comes with another
    reason or column, fails the run. The cap ``r_max_out`` is the operator's
    natural L rank rounded up past 16 more (a multiple of bs = 16), and the
    spike at tile (4, 0) -- the first panel sees it bare -- is scaled by
    ``spike_scale``."""
    import torch
    from repro_torch import CholOptions, faults
    from repro_torch.core import FactorizationBreakdown, tlr_cholesky
    from repro_torch.kernels import ops

    A = op.A
    drivers = {"left": dict(algo="left"), "right": dict(algo="right"),
               "right-lookahead": dict(algo="right", lookahead=True)}
    R = 16 * math.ceil((natural_rank + 17) / 16)
    scale, tail = spike_scale(A.b, A.r_max, R, seed=3)
    log(f"fault phase: natural L rank {natural_rank}, cap r_max_out {R}; "
        f"spike at tile (4, 0) scale {scale:.4e}: singular value {R + 1} "
        f"2e-6, norm past {R} {tail:.3e} (eps floor 1.6e-05)")
    assert R < A.r_max and tail <= 1.6e-5 / 2
    ops.reset_launch_counts()
    t0 = time.perf_counter()

    def finite(fact):
        return all(bool(torch.isfinite(x).all())
                   for x in (fact.L.D, fact.L.U, fact.L.V))

    def summary(events):
        return [(e["kind"], e["column"], e["stage"], e["remedy"],
                 e["attempt"]) for e in events]

    k_ind = A.nb - 2
    bad = faults.make_diag_indefinite(A, k_ind, magnitude=4.0)
    for name, kw in drivers.items():
        fact, sec = sync_time(lambda: tlr_cholesky(
            bad, CholOptions(eps=EPS, check=True, **kw)))
        ev = fact.stats["health"]["events"]
        log(f"fault indefinite diag {k_ind}, {name}: recovered in "
            f"{sec:.3f} s, events {summary(ev)}")
        spd = [e for e in ev if e["kind"] == "spd_breakdown"]
        assert finite(fact) and spd \
            and any(e["column"] == k_ind for e in spd) \
            and all(e["remedy"] in ("clamp", "jitter") for e in spd), \
            f"indefinite diagonal, {name}: not recovered as expected"
        del fact
    # The same fault at column 2: the clamp leaves L(2,2) with eps-sized
    # singular values, so L(i,2) and every later Schur update grow by
    # ~1/eps a clamped column, and each later diagonal tile is clamped in
    # turn. Either the run ends with finite factors or it raises a
    # structured breakdown -- never non-finite factors.
    try:
        fact, sec = sync_time(lambda: tlr_cholesky(
            faults.make_diag_indefinite(A, 2, magnitude=4.0),
            CholOptions(eps=EPS, check=True, algo="right")))
    except FactorizationBreakdown as e:
        rep = e.report
        log(f"fault indefinite diag 2, right: breakdown {rep.reason} at "
            f"column {rep.column} ({rep.stage}), remedies {rep.remedies}")
    else:
        clamps = sum(e["remedy"] == "clamp"
                     for e in fact.stats["health"]["events"])
        log(f"fault indefinite diag 2, right: finite factors in {sec:.3f} s "
            f"after {clamps} clamped diagonal tiles")
        assert finite(fact)
        del fact
    spiked = faults.spike_rank(A, 4, 0, seed=3, scale=scale)
    for name, want in (("left", {"eps_loosen"}), ("right", {"accept"})):
        fact, sec = sync_time(lambda: tlr_cholesky(spiked, CholOptions(
            eps=EPS, r_max_out=R, check=True, **drivers[name])))
        over = [e for e in fact.stats["health"]["events"]
                if e["kind"] == "rank_overflow"]
        log(f"fault rank spike (4, 0), {name}: {sec:.3f} s, rank_overflow "
            f"events {summary(over)}, rows "
            f"{[e['detail'].get('rows') for e in over]}")
        assert finite(fact) and over and any(e["column"] == 0 for e in over)
        if name == "left":
            assert want <= {e["remedy"] for e in over}
        else:
            assert {e["remedy"] for e in over} == want
        del fact
    for site, column, reason in (("chol.diag", 2, "spd_breakdown"),
                                 ("chol.panel", 1, "nonfinite_panel")):
        for name in ("left", "right"):
            fault = faults.Fault(site=site, kind="nan", column=column)
            try:
                with faults.inject(fault):
                    tlr_cholesky(A, CholOptions(eps=EPS, check=True,
                                                **drivers[name]))
            except FactorizationBreakdown as e:
                rep = e.report
            else:
                raise AssertionError(f"NaN {site} at column {column}, "
                                     f"{name}: no breakdown raised")
            log(f"fault NaN {site} column {column}, {name}: breakdown "
                f"{rep.reason} at column {rep.column} ({rep.stage}), "
                f"remedies {rep.remedies}")
            assert (rep.reason, rep.column) == (reason, column), \
                f"NaN {site}, {name}: breakdown {rep.reason} at column " \
                f"{rep.column}, expected {reason} at {column}"
            if site == "chol.diag":
                assert "jitter" in rep.remedies
    launches = ops.launch_counts()
    log(f"fault phase: {time.perf_counter() - t0:.1f} s; launches "
        f"{json.dumps(launches)}")
    for name in KERNELS:
        assert launches[name] > 0, f"kernel {name} was not launched by " \
            "the fault matrix"
    return {"faults": launches}


# -- phase 15: telemetry (repro_torch.obs) -----------------------------------------


def chrome_trace_schema(obj) -> None:
    """The schema check of tests/test_obs.py (the part of the Trace Event
    Format Perfetto validates): the object form, ph / pid / tid / name on
    every event, ts + dur on complete events, JSON throughout."""
    assert isinstance(obj, dict) and isinstance(obj["traceEvents"], list)
    json.dumps(obj)
    for ev in obj["traceEvents"]:
        assert ev["ph"] in ("X", "C", "M")
        assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)
        assert isinstance(ev["name"], str)
        if ev["ph"] == "X":
            assert ev["ts"] >= 0 and ev["dur"] >= 0
        if ev["ph"] == "M":
            assert ev["name"] in ("process_name", "thread_name")
            assert isinstance(ev["args"]["name"], str)


# The port's kernels by the prefix of their device function names
# (templates are named with their return type, plain functions without).
KERNEL_PREFIXES = {"bgemm": "batched_gemm", "tile_chain": "tile_chain",
                   "lr_sample": "lr_sample", "mgs_qr": "batched_qr",
                   "jacobi_svd": "small_svd"}


def kernel_family(name: str) -> str | None:
    key = name.removeprefix("void ").removeprefix("(anonymous namespace)::")
    for prefix, family in KERNEL_PREFIXES.items():
        if key.startswith(prefix):
            return family
    return None


def profile_spans(fn) -> tuple:
    """Runs ``fn`` under torch.profiler (CPU and CUDA activities) and reads
    its Chrome trace: every device kernel, with the host time of the
    runtime call that launched it (matched by correlation id), against the
    span user ranges (``record_function``) on the host timeline. Returns
    ``(out, seconds, spans, kernels)``: span name -> sorted host
    intervals, and (kernel name, host launch time or None, device us) per
    kernel."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out, sec = sync_time(fn)
        t1 = time.perf_counter()
        path = Path(tmp) / "profile.json"
        prof.export_chrome_trace(str(path))
        size = path.stat().st_size
        t2 = time.perf_counter()
        events = json.loads(path.read_text())["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X"]
    log(f"profile trace: {size} bytes; profiled run and stop "
        f"{t1 - t0:.3f} s, export {t2 - t1:.3f} s, read "
        f"{time.perf_counter() - t2:.3f} s; events per category "
        + json.dumps(dict(collections.Counter(
            e.get("cat") for e in xs).most_common())))
    spans = collections.defaultdict(list)
    for e in xs:
        if e.get("cat") == "user_annotation":
            spans[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in xs
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    kernels = [(e["name"], launch_ts.get(e.get("args", {}).get(
        "correlation")), e["dur"]) for e in xs if e.get("cat") == "kernel"]
    for v in spans.values():
        v.sort()
    return out, sec, dict(spans), kernels


def inside(t: float, intervals: list) -> bool:
    """Whether host time ``t`` falls in one of the sorted ``intervals``."""
    import bisect
    i = bisect.bisect_right(intervals, (t, math.inf)) - 1
    return i >= 0 and intervals[i][0] <= t <= intervals[i][1]


def serve_requests(n: int) -> list:
    """SERVE_REQUESTS requests cycling through ``KINDS`` (rhs from
    ``default_rng(0)``, pcg_solve tol 10^-U{4..8}, maxiter 100, as
    examples/serve_gp.py)."""
    import numpy as np
    from repro_torch.serve import KINDS, ServeRequest
    rng = np.random.default_rng(0)
    reqs = []
    for u in range(SERVE_REQUESTS):
        kind = KINDS[u % len(KINDS)]
        y = rng.standard_normal(n) if kind in ("solve", "pcg_solve") else None
        reqs.append(ServeRequest(kind, rhs=y, tol=10.0 ** -rng.integers(4, 9),
                                 maxiter=100, seed=u))
    return reqs


def telemetry_phase(op, fact, opts) -> dict:
    """The telemetry layer on the main path's operator (cov2d-32k).

    1. The default left Cholesky with telemetry off, then on (the same
       probe seed). Gates: L's D, U, V and ranks bitwise equal, equal
       kernel launches, no new dispatch shape, ``chol.diag`` nb times and
       ``chol.panel`` nb - 1 times in ``stats["telemetry"]``, and the
       enabled run within 1.25x the disabled one + 0.1 s.
    2. The recording exported as a Chrome trace (a temporary file), held
       to the schema check of tests/test_obs.py.
    3. The enabled factorization once more under torch.profiler: the span
       user ranges ``chol.factorize`` and ``chol.panel`` appear, and every
       ``lr_sample`` and ``tile_chain`` kernel was launched inside a
       ``chol.panel`` range on the host timeline. Logs the device ms of
       the kernels launched inside each span name.
    4. The serve cov2d-32k drain (no fault) with telemetry on: one
       ``serve.tick`` span a tick, the ``occupancy`` counter,
       ``summary()["telemetry"]``, no kernel launch and no new dispatch
       shape.
    5. The cost of one disabled span on this host."""
    import tempfile

    import torch
    from repro_torch import obs
    from repro_torch.core import trace_counts, trace_counts_diff
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    nb = op.nb
    ops.reset_launch_counts()
    off, t_off = sync_time(lambda: op.cholesky(opts))
    launches_off = ops.launch_counts()
    snap = trace_counts()
    ops.reset_launch_counts()
    obs.enable()
    on, t_on = sync_time(lambda: op.cholesky(opts))
    tel = obs.disable()
    launches = ops.launch_counts()
    new_shapes = trace_counts_diff(snap)
    rel, same = factor_diff(on, off)
    snap_on = on.stats["telemetry"]
    ph = snap_on["phases"]
    log(f"telemetry cov2d-32k: left Cholesky off {t_off:.3f} s, on "
        f"{t_on:.3f} s (x{t_on / t_off:.3f}; gate 1.25x + 0.1 s); "
        f"{len(tel.spans)} spans ({snap_on['spans']} under chol.factorize), "
        f"per name " + json.dumps({k: v["count"] for k, v in ph.items()})
        + f"; bitwise {'yes' if same else 'no'} (max rel {rel:.3e}); "
        f"launches off {json.dumps(launches_off)}, on {json.dumps(launches)}"
        f"; new dispatch shapes {json.dumps(new_shapes)}")
    log("telemetry cov2d-32k: span seconds per name (host) " + json.dumps(
        {k: round(v["seconds"], 4) for k, v in ph.items()}))
    assert same, "telemetry changed the left factor"
    assert launches == launches_off, "telemetry changed the kernel launches"
    assert new_shapes == {}, f"telemetry added dispatch shapes {new_shapes}"
    assert ph["chol.diag"]["count"] == nb \
        and ph["chol.panel"]["count"] == nb - 1, "span counts"
    assert t_on <= 1.25 * t_off + 0.1, "telemetry overhead above its gate"
    del off

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "telemetry.json"
        obj = obs.export_chrome_trace(str(path), tel)
        size = path.stat().st_size
    chrome_trace_schema(obj)
    log(f"telemetry cov2d-32k: Chrome trace {len(obj['traceEvents'])} "
        f"events, {size} bytes; schema check held")

    obs.enable()
    prof_fact, t_prof, ranges, kernels = profile_spans(
        lambda: op.cholesky(opts))
    obs.disable()
    assert {"chol.factorize", "chol.panel"} <= set(ranges), \
        f"span user ranges missing from the profile: {sorted(ranges)}"
    ms_by_span = {name: 0.0 for name in ranges}
    ms_by_family = collections.Counter()
    outside, unmatched, sampled = [], 0, 0
    for name, t_launch, dur in kernels:
        fam = kernel_family(name)
        if fam:
            ms_by_family[fam] += dur / 1e3
        if t_launch is None:
            unmatched += 1
            if fam in ("lr_sample", "tile_chain"):
                outside.append(name)
            continue
        for span, iv in ranges.items():
            if inside(t_launch, iv):
                ms_by_span[span] += dur / 1e3
        if fam in ("lr_sample", "tile_chain"):
            sampled += 1
            if not inside(t_launch, ranges["chol.panel"]):
                outside.append(name)
    log(f"telemetry cov2d-32k profile: {t_prof:.3f} s under the profiler, "
        f"{len(kernels)} device kernels ({unmatched} without a launch "
        f"record), user ranges " + json.dumps(
            {k: len(v) for k, v in sorted(ranges.items())})
        + f"; lr_sample + tile_chain launches {sampled}, outside chol.panel "
        f"{len(outside)}")
    log("telemetry cov2d-32k profile: device ms of the kernels launched "
        "inside each span name (nested names overlap) " + json.dumps(
            {k: round(v, 3) for k, v in sorted(ms_by_span.items())})
        + "; the port's kernels " + json.dumps(
            {k: round(v, 3) for k, v in sorted(ms_by_family.items())}))
    assert sampled > 0 and not outside, \
        f"{len(outside)} sampling kernels outside chol.panel ranges"
    del prof_fact

    srv, t_warm = sync_time(lambda: fact.serve(
        operator=op, slots=SERVE_SLOTS, check_every=SERVE_CHECK))
    obs.enable()
    out = drive_server("telemetry serve cov2d-32k", srv,
                       serve_requests(fact.n), t_warm)
    stel = obs.disable()
    summ = out["stats"]
    ticks = sum(s.name == "serve.tick" for s in stel.spans)
    occ = [c for c in stel.counters if c[0] == "occupancy"]
    log(f"telemetry serve cov2d-32k: {ticks} serve.tick spans for "
        f"{summ['ticks']} ticks, {len(occ)} occupancy samples; serve span "
        f"seconds " + json.dumps({k: round(v["seconds"], 4) for k, v in
                                  summ["telemetry"]["phases"].items()}))
    assert ticks == summ["ticks"] and len(occ) == summ["ticks"]
    assert "telemetry" in summ
    assert all(v == 0 for v in out["launches"].values()), \
        "the serve drain launched kernels"
    del srv

    reps = 200_000
    t0 = time.perf_counter()
    for _ in range(reps):
        with obs.span("x", cat="factor"):
            pass
    per = (time.perf_counter() - t0) / reps
    log(f"telemetry: one disabled span costs {per * 1e9:.1f} ns on this host "
        f"(over {reps} spans); phase {time.perf_counter() - t_phase:.1f} s")
    return {"telemetry": launches, "telemetry_serve": out["launches"]}


def telemetry_right_phase(op) -> dict:
    """Telemetry on the right path's operator (cov2d-8k-right): the ranked
    right Cholesky, sequential and with ``lookahead=True``, and the flat
    sequential one, each with telemetry off and then on. Gates: the
    ``chol.flush``, ``chol.syrk`` and ``algebra.syrk_column`` spans appear,
    ``round.bucket`` on the ranked runs and ``algebra.round_tiles`` on the
    flat one (the ranked path rounds through the bucket cores, in both
    packages), one ``chol.flush`` span per flush, and the factor bitwise
    equal to the run with telemetry off."""
    import dataclasses

    from repro_torch import CholOptions, obs
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    out = {}
    base = CholOptions(eps=EPS, algo="right", batching="ranked")
    for key, opts, want in (
            ("ranked", base, "round.bucket"),
            ("ranked_lookahead", dataclasses.replace(base, lookahead=True),
             "round.bucket"),
            ("flat", dataclasses.replace(base, batching="flat"),
             "algebra.round_tiles")):
        off, t_off = sync_time(lambda: op.cholesky(opts))
        ops.reset_launch_counts()
        obs.enable()
        on, t_on = sync_time(lambda: op.cholesky(opts))
        tel = obs.disable()
        launches = ops.launch_counts()
        counts = collections.Counter(s.name for s in tel.spans)
        rel, same = factor_diff(on, off)
        log(f"telemetry right {key}: off {t_off:.3f} s, on {t_on:.3f} s; "
            f"spans {json.dumps(dict(sorted(counts.items())))}; flushes "
            f"{on.stats['flushes']}; bitwise {'yes' if same else 'no'} (max "
            f"rel {rel:.3e}); launches {json.dumps(launches)}")
        assert {"chol.flush", "chol.syrk", "algebra.syrk_column",
                want} <= set(counts), f"telemetry right {key}: spans"
        assert counts["chol.flush"] == on.stats["flushes"]
        assert same, f"telemetry right {key}: factor differs"
        out[f"telemetry_right_{key}"] = launches
        del off, on
    log(f"telemetry right: phase {time.perf_counter() - t_phase:.1f} s")
    return out


# -- phase 16: mixed-precision storage (compress(store_dtype=)) ------------------


@contextlib.contextmanager
def dtype_log():
    """While open, counts the sampling and rounding kernels' calls per
    (kernel, dtype) of their first operand (installed by the smoke only)."""
    from repro_torch.kernels import ops
    counts = collections.Counter()
    names = ("batched_gemm", "tile_chain", "lr_sample", "batched_qr")
    inner = {name: getattr(ops, name) for name in names}

    def wrap(name):
        def call(*args, **kw):
            counts[(name, str(args[0].dtype).removeprefix("torch."))] += 1
            return inner[name](*args, **kw)
        return call
    for name in names:
        setattr(ops, name, wrap(name))
    try:
        yield counts
    finally:
        for name in names:
            setattr(ops, name, inner[name])


def mixed_phase(op, K, Z) -> dict:
    """The paper's section 7 mixed-precision storage on the right path's K
    (N = 8192, tile 128): ``TLROperator.compress(K, 128, 128, 1e-8,
    store_dtype=torch.float32)``. Gates (tests/test_mixed_precision.py):
    the logical low-rank bytes half those of the f64 operator ``op`` (the
    same compression in f64), ``op @ x`` within 1e-4 of ``K x``
    (relative), and the default left Cholesky at eps 1e-5, bs 8 meets the
    randomized residual gate (100 eps) with a solve error below 1e-2. Logs
    the compress and factor seconds and the kernels' launches per dtype:
    they run in f64 on the promoted factors."""
    import torch
    from repro_torch import CholOptions, TLROperator
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    eps = 1e-5
    ops.reset_launch_counts()
    with dtype_log() as by_dtype:
        op32, t_comp = sync_time(lambda: TLROperator.compress(
            K, TILE_RIGHT, TILE_RIGHT, 1e-8, store_dtype=torch.float32))
        fact, t_fact = sync_time(lambda: op32.cholesky(
            CholOptions(eps=eps, bs=8)))
    launches = ops.launch_counts()
    m32, m64 = op32.memory_stats(), op.memory_stats()
    g = torch.Generator(device=K.device).manual_seed(5)
    x = torch.randn((op.n,), generator=g, device=K.device, dtype=K.dtype)
    Kx = K @ x
    mv = float((op32 @ x - Kx).norm() / Kx.norm())
    resid = left_residual(K, fact, Z)
    sol = float((fact.solve(Kx) - x).norm() / x.norm())
    log(f"mixed f32 storage: compress {t_comp:.3f} s (U/V "
        f"{m32['store_dtype']}, D {m32['compute_dtype']}), low-rank bytes "
        f"{m32['lowrank_bytes_logical']} against f64 "
        f"{m64['lowrank_bytes_logical']}, ranks equal "
        f"{'yes' if torch.equal(op32.ranks, op.ranks) else 'no'}; matvec rel "
        f"err {mv:.3e} (gate 1e-4); left Cholesky eps {eps:g} bs 8 in "
        f"{t_fact:.3f} s, L {str(fact.L.U.dtype).removeprefix('torch.')}, "
        f"residual {resid:.3e} (gate {100 * eps:.0e}), solve rel err "
        f"{sol:.3e} (gate 1e-2); kernel calls per dtype "
        + json.dumps({f"{k} {d}": c for (k, d), c in sorted(
            by_dtype.items())}) + f"; launches {json.dumps(launches)}")
    assert 2 * m32["lowrank_bytes_logical"] == m64["lowrank_bytes_logical"]
    assert mv <= 1e-4, "mixed matvec disagrees with K"
    assert resid <= 100 * eps, "mixed factor residual above 100 eps"
    assert sol < 1e-2, "mixed solve error"
    for name in MAIN_KERNELS:
        assert launches[name] > 0, f"kernel {name} not launched (mixed)"
    assert all(d == "float64" for _, d in by_dtype), \
        "a kernel ran below the working precision"
    log(f"mixed f32 storage: phase {time.perf_counter() - t_phase:.1f} s")
    return {"mixed": launches}


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
    frac_pcg = frac_pcg_phase(args.profile)
    frac_ns = frac_ns_phase(args.profile)
    # each kernel's widest rank bucket on the ranked paths that launch it:
    # the sampling kernels' on the ranked main path, QR's, SVD's and
    # batched_gemm's (at that call's live ranks) on the ranked
    # right-looking Cholesky
    ranked = {name: [] for name in KERNELS}
    for name in MAIN_KERNELS:
        shape = widest_bucket(main["ranked"][1][name])
        if shape:
            ranked[name].append(("main", shape, None))
    right_shapes = right["right_cholesky_ranked_shapes"]
    for name in ROUND_KERNELS:
        shape = widest_bucket(right_shapes[name])
        if shape:
            ranks = (right_shapes[name][shape][2]
                     if name == "batched_gemm" else None)
            ranked[name].append(("right_cholesky_ranked", shape, ranks))
    # each kernel's widest shape on the fractional-diffusion paths (the
    # sampling kernels' at wA > 128 on frac_pcg; on frac_ns the K-reduction
    # of batched_gemm and its widest call over all no = nb (nb - 1) output
    # tiles, QR and SVD at T = no), at batched_gemm's live ranks
    no = (NS_N // NS_TILE) * (NS_N // NS_TILE - 1)
    for path, res, names in (("frac_pcg", frac_pcg, MAIN_KERNELS),
                             ("frac_ns", frac_ns, ROUND_KERNELS)):
        for name in names:
            sh = res["shapes"][name]
            picks = {widest_bucket(sh)}
            if name == "batched_gemm" and path == "frac_ns":
                picks.add(max((k for k in sh if k[0] == no),
                              key=lambda k: k[2]))
            for shape in sorted(picks):
                ranked[name].append((path, shape, sh[shape][2]
                                     if name == "batched_gemm" else None))
    log("widest rank buckets on the ranked paths: " + json.dumps(
        {name: [(path, shape) for path, shape, _ in cases]
         for name, cases in ranked.items()}))
    results = check_kernels(main["ranks_a"], ranked=ranked)
    small_parity()

    other = "flat" if main["batching"] == "ranked" else "ranked"
    by_path = {"main": main["launches"],
               f"main_{other}": main[other][0],
               "round_flat": main["round_flat"][0],
               "round_ranked": main["round_ranked"][0],
               **{key: right[key] for key in (
                   "right_cholesky", "right_ldlt", "right_cholesky_ranked",
                   "right_ldlt_ranked")},
               "frac_pcg": frac_pcg["launches"],
               "serve": main["serve"], "frac_serve": frac_pcg["frac_serve"],
               "frac_ns": frac_ns["launches"],
               **{key: right[key] for key in (
                   "right_cholesky_flat_lookahead",
                   "right_cholesky_ranked_lookahead",
                   "right_ldlt_flat_lookahead",
                   "right_ldlt_ranked_lookahead", "faults")},
               **{key: main[key] for key in (
                   "main_pivot_frobenius", "main_pivot_power",
                   "main_check", "telemetry", "telemetry_serve")},
               **{key: right[key] for key in (
                   "telemetry_right_ranked",
                   "telemetry_right_ranked_lookahead",
                   "telemetry_right_flat", "mixed")}}
    log(f"main path batching: auto -> {main['batching']} (main_{other}: "
        f"the same operator factored with batching={other})")
    kernels = []
    for name in KERNELS:
        head = next(r for (k, _, d), r in results.items()
                    if k == name and d == "float64" and r["headline"])
        rheads = [r for (k, lbl, d), r in results.items()
                  if k == name and d == "float64"
                  and lbl.startswith(RANKED_HEAD)]
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
            # the same numbers at the widest rank bucket of each ranked
            # path that launches it (the path is in the shape label)
            "ranked": [{k: r[k] for k in ("shape", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms", "graph_ms")
                        if k in r} for r in rheads],
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
