#!/usr/bin/env python3
"""Times ``tlr_syrk_column``'s append with a scalar and a per-tile offset.

The right-looking driver appends each column's Schur update to the
trailing tiles' accumulation buffers: at one first-free column for every
tile under flat batching (a scalar ``used``), at each tile's own content
width under ranked batching (an (nt,) host array). This runs every column
of one flat factorization's updates at its shapes (N = 8192, tile 128:
nb = 64, nt = 2016, r_max 128, accumulation width 384, panels of width
128 at ranks drawn up to 39) once with the scalar offset and once with the
same offset as ``np.full(nt, used)``, checks the two buffers are bitwise
equal, and prints each pass's wall seconds (host work and launches
included, synchronized once per pass) in the order scalar, per-tile,
per-tile, scalar.

Run from the root of a checkout, on a machine with the card:

    python3 tools/syrk_append.py [--reps 3]

Exits non-zero without a CUDA card or when the two passes differ.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("syrk_append: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    chip_smoke.device_line()
    chip_smoke.build_kernels()
    from repro_torch.core.algebra import tlr_syrk_column

    nb, b, r_max, flush = 64, 128, 128, 2
    nt, w_acc = nb * (nb - 1) // 2, r_max + flush * r_max
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda",
                           dtype=torch.float64) / b

    panels = []
    for k in range(nb - 1):
        T = nb - 1 - k
        ranks = torch.randint(0, 40, (T,), generator=g, device="cuda",
                              dtype=torch.int32)
        cols = torch.arange(r_max, device="cuda")
        live = (cols[None, :] < ranks[:, None])[:, None, :]
        panels.append((randn(T, b, r_max) * live, randn(T, b, r_max) * live,
                       ranks))
    accU0, accV0 = randn(nt, b, w_acc), randn(nt, b, w_acc)
    D0 = randn(nb, b, b)

    def one_pass(per_tile: bool):
        accU, accV, D = accU0.clone(), accV0.clone(), D0.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        used = r_max
        for k, (Up, Vn, ranks) in enumerate(panels):
            if used + r_max > w_acc:
                used = b       # a flush's reset, without the rounding
            off = np.full(nt, used, np.int64) if per_tile else used
            tlr_syrk_column(accU, accV, off, D, Up, Vn, ranks, None, k)
            used += r_max
        torch.cuda.synchronize()
        return time.perf_counter() - t0, (accU, accV, D)

    one_pass(False)
    one_pass(True)       # warm: module loading, index memos
    secs = {"scalar": [], "per-tile": []}
    out = {}
    for _ in range(args.reps):
        for name in ("scalar", "per-tile", "per-tile", "scalar"):
            sec, out[name] = one_pass(name == "per-tile")
            secs[name].append(sec)
    same = all(torch.equal(a, c) for a, c in zip(out["scalar"],
                                                 out["per-tile"]))
    for name, s in secs.items():
        print(f"syrk_append {name}: {nb - 1} columns, seconds "
              f"{' '.join(f'{x:.4f}' for x in s)} (min {min(s):.4f}, "
              f"median {float(np.median(s)):.4f})", flush=True)
    print(f"syrk_append: scalar and per-tile buffers bitwise equal: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
