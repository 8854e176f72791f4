"""Runs path 15 of ``chip_smoke.py`` alone on the card (model sharding and
the dry run, ``model_sharding_phase``), with its gates, and prints the
card's name and power limit first:

    python3 tools/path15.py

No kernel is built. Exits 2 without a CUDA card.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("path15: no CUDA card", file=sys.stderr)
        return 2
    chip_smoke.device_line()
    t0 = time.perf_counter()
    chip_smoke.model_sharding_phase()
    print(f"path15: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
