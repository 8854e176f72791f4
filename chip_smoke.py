#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, then
drives the main path at full width: a 2-D exponential covariance
(N = 32768, tile 512) built on the card, ``TLROperator.compress`` (batched
SVD, no rank may reach r_max) -> ``cholesky`` (left-looking dynamic ARA) ->
solve / logdet / sample / matvec, gated on the randomized factor residual
``||K z - L (L^T z)|| / ||K z|| <= 100 eps``, and times the batched SVD of
one tile column by each cuSOLVER driver. Then it holds each kernel against
its plain PyTorch version on the card in f64, f32 and bf16 at the main
path's shapes (and checks that the gate rejects a planted fault), and
checks a small end-to-end run on the card against the same run on the CPU.

Run from the root of a checkout:  python3 chip_smoke.py
(``--n`` cuts the main path's size for a quick look;
``--profile DIR`` adds a torch.profiler table of the factorization.)

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
# Kernel against plain version: max abs error <= TOL * max |plain output|
# (the tolerances of tests/test_kernels.py, relative to the output's scale).
TOL = {"float64": 1e-12, "float32": 1e-5, "bfloat16": 5e-2}
REPLACES = {
    "batched_gemm": "src/repro/kernels/batched_gemm.py:41",
    "tile_chain": "src/repro/kernels/tlr_matvec.py:35",
    "lr_sample": "src/repro/kernels/lr_sample.py:57",
}
SOURCES = {
    "batched_gemm": "src/repro_torch/kernels/csrc/batched_gemm.cu",
    "tile_chain": "src/repro_torch/kernels/csrc/tile_chain.cu",
    "lr_sample": "src/repro_torch/kernels/csrc/lr_sample.cu",
}


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
    library, bytes_needed, flops_needed)) at the main path's shapes:
    N=32768, tile 512, r_max 128, bs 16 (T = 63 row tiles, Jb = 30 / 46
    buckets). ``ranks_a`` are the A-tile ranks the main path's first column
    gives ``batched_gemm``. Inputs are scaled so that outputs are O(1).
    ``fault`` is the plain version with one rank (``batched_gemm``,
    ``tile_chain``) or the last j term (``lr_sample``) dropped: a result the
    gate must reject. ``headline`` marks the shape that takes most of the
    kernel's main-path time; its numbers go into the kernels line."""
    g = torch.Generator(device=device).manual_seed(0)
    from repro_torch.kernels import batched_gemm as bg
    from repro_torch.kernels import lr_sample as lr
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
                    2.0 * m * n * rs)
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
                    4.0 * T * b * r * s)
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
                    4.0 * T * k * b * r * s)
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
    ]


def gate(got, want, tol: float) -> tuple[float, float]:
    """(max abs error, allowed): ``got`` passes when its largest deviation
    from ``want`` is at most ``tol`` times the largest |want|."""
    want = want.double()
    err = float((got.double() - want).abs().max())
    return err, tol * float(want.abs().max())


def check_kernels(ranks_a) -> dict:
    import torch
    results = {}
    for name, label, headline, make in kernel_cases(torch, ranks_a):
        for dtype in (torch.float64, torch.float32, torch.bfloat16):
            dn = str(dtype).removeprefix("torch.")
            kernel, plain, fault, library, nbytes, flops = make(dtype)
            want = plain()
            err, atol = gate(kernel(), want, TOL[dn])
            fault_err, _ = gate(fault(), want, TOL[dn])
            ok = err <= atol
            rec = {"kernel": name, "shape": label, "dtype": dn,
                   "max_abs_err": err, "atol": atol, "ok": ok,
                   "planted_fault_err": fault_err}
            if dtype == torch.float64 or headline:
                reps = 3 if flops > 5e10 else 10
                rec["ms"] = event_ms(kernel, reps)
                rec["plain_ms"] = event_ms(plain, reps)
                rec["library_ms"] = event_ms(library, reps)
                rec["bound_ms"] = 1e3 * max(nbytes / PEAK_BYTES,
                                            flops / PEAK_FLOPS[dn])
                rec["bound_by"] = ("bytes" if nbytes / PEAK_BYTES
                                   >= flops / PEAK_FLOPS[dn] else "operations")
            log(json.dumps(rec))
            if not ok:
                raise AssertionError(f"{name} {label} {dn}: kernel disagrees "
                                     f"with its plain version "
                                     f"(max abs err {err:.3e} > {atol:.3e})")
            if fault_err <= atol:
                raise AssertionError(f"{name} {label} {dn}: the gate let a "
                                     f"planted fault through (err "
                                     f"{fault_err:.3e} <= {atol:.3e})")
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
    if profile:
        from torch.profiler import ProfilerActivity, profile as tprofile
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            fact, phases["factor"] = sync_time(lambda: op.cholesky(opts))
    else:
        fact, phases["factor"] = sync_time(lambda: op.cholesky(opts))
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

    # Gates: every kernel ran, outputs finite, randomized factor residual.
    for name, c in launches.items():
        assert c > 0, f"kernel {name} was not launched on the main path"
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
    if profile:
        out = Path(profile)
        out.mkdir(parents=True, exist_ok=True)
        table = prof.key_averages().table(row_limit=60)
        (out / "factor_profile.txt").write_text(table)
        evs = [e for e in prof.key_averages() if _dev_us(e) > 0]
        busy_us = sum(_dev_us(e) for e in evs)
        log(f"profile: device busy {busy_us / 1e6:.3f} s of "
            f"{phases['factor']:.3f} s factor wall "
            f"(idle share {1 - busy_us / 1e6 / phases['factor']:.3f}); "
            f"table in {out / 'factor_profile.txt'}")
        for e in sorted(evs, key=lambda e: -_dev_us(e))[:12]:
            log(f"  {_dev_us(e) / 1e3:10.1f} ms "
                f"{e.count:7d}x  {e.key[:90]}")
    return {"launches": launches, "phases": phases, "ranks_a": ranks_a}


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
    results = check_kernels(main["ranks_a"])
    small_parity()

    kernels = []
    for name in ("batched_gemm", "tile_chain", "lr_sample"):
        head = next(r for (k, _, d), r in results.items()
                    if k == name and d == "float64" and r["headline"])
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": main["launches"][name],
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
