#!/usr/bin/env python3
"""The fractional-diffusion path's factorizations with two builds of the
sampling kernels, in turns, on one card.

Builds the package's kernels and those of another source tree (``--old
DIR``, a ``csrc/`` directory with all five sources and ``common.cuh``: an
earlier commit's, unpacked into a git-ignored directory), compresses
``chip_smoke.py``'s frac3d-16k operator once (``FRAC_N``, ``FRAC_TILE``,
1e-10, r_max = tile), then runs the left Cholesky of ``tlr_add_diag(op.A,
eps)`` at each eps of ``FRAC_EPS`` (and ``pcg`` with it) with the old, new,
new and old ``tile_chain`` / ``lr_sample`` libraries (every other kernel is
the package's), and logs each factorization's seconds and PCG iterations.
For the first run of each build it times both sampling kernels at that
run's launches per shape (``chip_smoke.shape_times``: launches x kernel ms
against launches x bound ms, all shapes and those past width 128).

Run from the root of a checkout, on a machine with the card:

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/old
    python3 tools/sampling_ab.py --old build/old/src/repro_torch/kernels/csrc
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SAMPLING = ("tile_chain", "lr_sample")


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=Path,
                    help="csrc/ directory of the other build")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("sampling_ab: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch import CholOptions, TLROperator, pcg
    from repro_torch.core import (fractional_diffusion_matrix,
                                  fractional_diffusion_points, tlr_add_diag)
    from repro_torch.kernels import build, ops

    cs.device_line()
    libs = {}
    for label, csrc in (("old", args.old.resolve()), ("new", build.CSRC)):
        build._LIBS.clear()
        build.CSRC = csrc
        info = build.build_all()
        cs.log(f"build {label} ({csrc}): {info['seconds']:.1f} s")
        libs[label] = {name: build.library(name) for name in SAMPLING}

    pts = fractional_diffusion_points(cs.FRAC_N, cs.FRAC_TILE)
    K = fractional_diffusion_matrix(pts, s=cs.FRAC_S, device="cuda")
    op, t_comp = cs.sync_time(lambda: TLROperator.compress(
        K, cs.FRAC_TILE, eps=1e-10))
    cs.log(f"compress N={cs.FRAC_N} tile={cs.FRAC_TILE}: {t_comp:.2f} s, A "
           f"ranks max {int(op.A.ranks.max())}")
    rhs = torch.as_tensor(np.random.default_rng(0).standard_normal(
        cs.FRAC_N), device="cuda")
    timed = set()
    for run, label in enumerate(("old", "new", "new", "old")):
        build._LIBS.update(libs[label])
        ops.reset_launch_counts()
        seconds = {}
        for eps in cs.FRAC_EPS:
            op_eps = TLROperator(tlr_add_diag(op.A, eps))
            fact, seconds[eps] = cs.sync_time(lambda: op_eps.cholesky(
                CholOptions(eps=eps, bs=16)))
            _, it, hist = pcg(op, rhs, precond=fact, tol=1e-6, maxiter=300)
            cs.log(f"run {run} {label}: eps={eps:g} factor "
                   f"{seconds[eps]:.3f} s, pcg {it} iterations "
                   f"(residual {hist[-1]:.3e})")
            del fact, op_eps
        shapes = cs.path_shapes()
        cs.log(f"run {run} {label}: factorizations "
               f"{sum(seconds.values()):.3f} s; launches "
               f"{ {n: sum(shapes[n].values()) for n in SAMPLING} }")
        if label not in timed:
            timed.add(label)
            total = {"all": [0.0, 0.0], "wide": [0.0, 0.0]}
            for name in SAMPLING:
                for key, (sec, bound) in cs.shape_times(
                        name, shapes[name], bs=(cs.FRAC_TILE, 16)).items():
                    total[key][0] += sec
                    total[key][1] += bound
            cs.log(f"run {run} {label}: lr_sample + tile_chain "
                   f"{total['all'][0]:.4f} s (bound {total['all'][1]:.4f} s) "
                   f"over all shapes, {total['wide'][0]:.4f} s (bound "
                   f"{total['wide'][1]:.4f} s) past width {cs.R_MAX}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
