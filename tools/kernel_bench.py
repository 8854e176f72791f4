#!/usr/bin/env python3
"""Kernel-only check and timing of the port's CUDA kernels on one card.

Runs ``chip_smoke.py``'s kernel cases for the kernels named on the command
line: each kernel against its plain version at the paths' shapes, the
planted-fault gate, two calls bitwise equal, and the kernel / plain /
library / bound times, as the smoke prints them, without the smoke's end-to-end paths (seconds instead
of minutes). ``batched_gemm``'s cases take the main path's A-tile ranks in
the smoke; here they are drawn from a seed.

Run from the root of a checkout, on a machine with the card:

    python3 tools/kernel_bench.py tile_chain [lr_sample small_svd ...]

The smoke's build step prints each source's registers and spills (for
``small_svd`` and ``batched_qr``, every kernel's ptxas lines) first.

Exits non-zero without a CUDA card or when a gate fails.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernels", nargs="*", choices=chip_smoke.KERNELS,
                    help="kernels to check (default: all five)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA card", file=sys.stderr)
        return 2
    chip_smoke.device_line()
    chip_smoke.build_kernels()
    g = torch.Generator(device="cuda").manual_seed(0)
    ranks_a = torch.randint(1, 29, (63,), generator=g, device="cuda",
                            dtype=torch.int32)
    chip_smoke.check_kernels(ranks_a, only=tuple(args.kernels) or None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
