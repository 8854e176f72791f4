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
   residual and finite solves.

Then it holds each kernel against its plain PyTorch version on the card
(f64, f32 and bf16; f64 and f32 for the QR and SVD) at the paths' shapes,
checks that each gate rejects a planted fault, and checks a small
end-to-end run on the card against the same run on the CPU.

Run from the root of a checkout:  python3 chip_smoke.py
(``--n`` cuts the main path's size for a quick look;
``--profile DIR`` adds torch.profiler tables of the left-looking and the
right-looking Cholesky.)

Exits non-zero, printing no result, without a CUDA card or outside a
checkout. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
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
KERNELS = ("batched_gemm", "tile_chain", "lr_sample", "batched_qr",
           "small_svd")
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


def log(msg: str) -> None:
    print(msg, flush=True)


def sync_time(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


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


# -- phase 3: kernels against their plain versions ------------------------------------


def kernel_cases(torch, ranks_a, device="cuda"):
    """(name, shape label, headline, make(dtype) -> (kernel, plain, fault,
    library, bytes_needed, flops_needed, post)) at the paths' shapes.

    Main path: N=32768, tile 512, r_max 128, bs 16 (T = 63 row tiles,
    Jb = 30 / 46 buckets); ``ranks_a`` are the A-tile ranks the main path's
    first column gives ``batched_gemm``. Rounding pass on that operator:
    ``batched_qr`` of (2016, 512, 128) factor panels, ``small_svd`` of
    (2016, 128, 128) cores. Right-looking path (tile 128): ``batched_qr``
    and ``small_svd`` of (T <= 2016, 128, 128) densified tiles. Inputs are
    scaled so that outputs are O(1); the square QR inputs are shifted by
    3 I so that Q is well conditioned (a random square panel's Q moves by
    cond x rounding). ``fault`` is the plain version with one rank
    (``batched_gemm``, ``tile_chain``), the last j term (``lr_sample``), the
    last column (``batched_qr``) or seven of the eight sweeps
    (``small_svd``) dropped: a result the gate must reject. ``post`` maps a
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

    def bgemm(m, k, n, ranks):
        def make(dtype):
            T = ranks.shape[0]
            A = randn((T, m, k), dtype)
            B = randn((T, k, n), dtype, 1 / math.sqrt(k))
            rs = int(ranks.sum())
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

    def chain(T, b, r, s):
        def make(dtype):
            U = randn((T, b, r), dtype, 1 / math.sqrt(r))
            V = randn((T, b, r), dtype, 1 / math.sqrt(b))
            X = randn((T, b, s), dtype)
            isz = U.element_size()
            return (lambda: tc.tile_chain_cuda(U, V, X),
                    lambda: tc.tile_chain_plain(U, V, X),
                    lambda: tc.tile_chain_plain(U, V, X, width=r - 1),
                    lambda: torch.einsum("tbr,tcr,tcs->tbs", U, V, X),
                    (2 * T * b * r + 2 * T * b * s) * isz,
                    4.0 * T * b * r * s, None)
        return make

    def lrs(T, k, b, r, s):
        def make(dtype):
            Ui = randn((T, k, b, r), dtype, 1 / math.sqrt(r * k))
            Vi = randn((T, k, b, r), dtype, 1 / math.sqrt(b))
            W2 = randn((k, b, s), dtype)
            isz = Ui.element_size()
            return (lambda: lr.lr_sample_cuda(Ui, Vi, W2),
                    lambda: lr.lr_sample_plain(Ui, Vi, W2),
                    lambda: lr.lr_sample_plain(Ui[:, :-1].contiguous(),
                                               Vi[:, :-1].contiguous(),
                                               W2[:-1].contiguous()),
                    lambda: torch.einsum("tjbr,tjcr,jcs->tbs", Ui, Vi, W2),
                    (2 * T * k * b * r + k * b * s + T * b * s) * isz,
                    4.0 * T * k * b * r * s, None)
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

    T = ranks_a.shape[0]
    ragged = torch.randint(1, 25, (5,), generator=g, device=device,
                           dtype=torch.int32)
    return [
        ("batched_gemm", f"sample T={T} m=512 k=128 n=16", True,
         bgemm(512, 128, 16, ranks_a)),
        ("batched_gemm", f"sample_t T={T} m=512 k=128 n=128", False,
         bgemm(512, 128, 128, ranks_a)),
        ("batched_gemm", "ragged T=5 m=96 k=24 n=20", False,
         bgemm(96, 24, 20, ragged)),
        ("tile_chain", "W2 hoist T=30 b=512 r=128 s=16", False,
         chain(30, 512, 128, 16)),
        ("tile_chain", "sample_t T*J=1890 b=512 r=128 s=128", True,
         chain(1890, 512, 128, 128)),
        ("tile_chain", "ragged T=3 b=96 r=24 s=70", False,
         chain(3, 96, 24, 70)),
        ("lr_sample", "T=63 J=30 b=512 r=128 s=16", True,
         lrs(63, 30, 512, 128, 16)),
        ("lr_sample", "T=32 J=46 b=512 r=128 s=16", False,
         lrs(32, 46, 512, 128, 16)),
        ("lr_sample", "ragged T=5 J=2 b=96 r=24 s=20", False,
         lrs(5, 2, 96, 24, 20)),
        ("batched_qr", "op.round T=2016 b=512 r=128", True,
         mgs(2016, 512, 128)),
        ("batched_qr", "right T=2016 b=128 r=128 (+3I)", False,
         mgs(2016, 128, 128, shift=3.0)),
        ("batched_qr", "ragged T=5 b=96 r=24 dead column", False,
         mgs(5, 96, 24, dead=True)),
        ("small_svd", "core T=2016 m=128 n=128", True,
         jacobi(2016, 128, 128)),
        ("small_svd", "ragged T=3 m=20 n=13", False, jacobi(3, 20, 13)),
        ("small_svd", "scratch T=2 m=300 n=200", False, jacobi(2, 300, 200)),
    ]


def gate(got, want, tol: float) -> tuple[float, float]:
    """(max abs error, allowed) of the output closest to failing: ``got``
    passes when, for every output, its largest deviation from ``want`` is
    at most ``tol`` times the largest |want| of that output."""
    if not isinstance(want, (tuple, list)):
        got, want = (got,), (want,)
    worst, worst_ratio = (0.0, 0.0), -1.0
    for x, w in zip(got, want):
        w = w.double()
        err = float((x.double() - w).abs().max())
        allowed = tol * float(w.abs().max())
        ratio = err / allowed if allowed > 0 else (math.inf if err else 0.0)
        if ratio > worst_ratio:
            worst, worst_ratio = (err, allowed), ratio
    return worst


def check_kernels(ranks_a) -> dict:
    import torch
    all_dtypes = (torch.float64, torch.float32, torch.bfloat16)
    results = {}
    for name, label, headline, make in kernel_cases(torch, ranks_a):
        for dtype in (all_dtypes[:2] if name in ("batched_qr", "small_svd")
                      else all_dtypes):
            dn = str(dtype).removeprefix("torch.")
            tol = TOL[dn] * TOL_SCALE.get(name, 1.0)
            kernel, plain, fault, library, nbytes, flops, post = make(dtype)
            post = post or (lambda out: out)
            want = post(plain())
            err, atol = gate(post(kernel()), want, tol)
            fault_err, fault_atol = gate(post(fault()), want, tol)
            ok = err <= atol
            rec = {"kernel": name, "shape": label, "dtype": dn,
                   "max_abs_err": err, "atol": atol, "ok": ok,
                   "planted_fault_err": fault_err,
                   "planted_fault_atol": fault_atol}
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
                rec["bound_ms"] = 1e3 * max(nbytes / PEAK_BYTES,
                                            flops / PEAK_FLOPS[dn])
                rec["bound_by"] = ("bytes" if nbytes / PEAK_BYTES
                                   >= flops / PEAK_FLOPS[dn] else "operations")
            log(json.dumps(rec))
            if not ok:
                raise AssertionError(f"{name} {label} {dn}: kernel disagrees "
                                     f"with its plain version "
                                     f"(max abs err {err:.3e} > {atol:.3e})")
            if fault_err <= fault_atol:
                raise AssertionError(f"{name} {label} {dn}: the gate let a "
                                     f"planted fault through (err "
                                     f"{fault_err:.3e} <= {fault_atol:.3e})")
            results[(name, label, dn)] = dict(rec, headline=headline)
            del want, kernel, plain, fault, library
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
    for e in sorted(evs, key=lambda e: -_dev_us(e))[:12]:
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
    from repro_torch.kernels import ops

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
    log(f"launches on the main path: {json.dumps(launches)}")

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
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    rop, sec = sync_time(lambda: op.round(eps))
    launches = ops.launch_counts()
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


def right_phase(n: int, profile: str | None) -> dict:
    """The 2-D exponential covariance at N = ``n``, tile 128, compressed at
    1e-8 with r_max 128, factored by the right-looking driver (Cholesky,
    then LDL^T, flat batching). Gates per factorization: the QR, SVD and
    GEMM kernels ran, the randomized residual ``||K z - L D L^T z|| /
    ||K z|| <= 100 eps`` holds and a solve is finite."""
    import torch
    from repro_torch import CholOptions, TLROperator, covariance_problem
    from repro_torch.kernels import ops

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
        fact, sec = timed(lambda: getattr(op, kind)(opts),
                          profile if kind == "cholesky" else None,
                          "right_cholesky")
        launches = ops.launch_counts()
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
        del fact, LtZ, x
    log(f"right phase max_memory_allocated: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del op, K, KZ, Z
    torch.cuda.empty_cache()
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
            "max_abs_err": max(r["max_abs_err"] for (k, _, d), r in
                               results.items() if k == name and
                               d == "float64"),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
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
