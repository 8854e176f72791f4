#!/usr/bin/env python3
"""Time compiled variants of ``csrc/batched_qr.cu`` on one card.

Each argument names a variant and its extra ``nvcc`` flags, ``name=flags``
(``base`` alone builds the source as it is). Every variant is compiled in
parallel into ``build/variants/`` with the package's flags, loaded with
ctypes, and its kernel time (CUDA events, mean of 5 after one warm call)
printed at the right-looking driver's shapes and at op.round's, in f64 and
f32, beside each kernel's ptxas registers. The inputs are random panels
with columns of norm ~1, from a fixed seed; nothing is checked against the
plain version (``tools/kernel_bench.py batched_qr`` does that).

Run from the root of a checkout, on a machine with the card:

    python3 tools/qr_variants.py base "wide=-DSOME_MACRO=1"
"""

from __future__ import annotations

import concurrent.futures as cf
import ctypes
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((2016, 128, 128), (63, 128, 128), (2016, 512, 128))


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("qr_variants: no CUDA card", file=sys.stderr)
        return 2
    variants = dict(a.split("=", 1) if "=" in a else (a, "")
                    for a in sys.argv[1:] or ["base"])
    out_dir = build.BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)

    def compile_one(item):
        name, flags = item
        lib = out_dir / f"libqr_{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, *flags.split(), "-o",
               str(lib), str(build.CSRC / "batched_qr.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}"
                               f"{proc.stderr}")
        regs = [int(line.split("Used")[1].split()[0])
                for line in (proc.stdout + proc.stderr).splitlines()
                if "Used" in line]
        return name, lib, regs

    with cf.ThreadPoolExecutor(len(variants)) as ex:
        libs = list(ex.map(compile_one, variants.items()))
    g = torch.Generator(device="cuda").manual_seed(0)
    inputs = {s: torch.randn(s, generator=g, device="cuda",
                             dtype=torch.float64) / math.sqrt(s[1])
              for s in SHAPES}
    stream = torch.cuda.current_stream().cuda_stream
    for name, lib, regs in libs:
        cdll = ctypes.CDLL(str(lib))
        times = []
        for dtype in (torch.float64, torch.float32):
            fn = getattr(cdll, f"repro_batched_qr_{build.SUFFIX[dtype]}")
            fn.argtypes = build._SIGNATURES["batched_qr"]
            fn.restype = ctypes.c_int
            for (T, b, r), Y64 in inputs.items():
                Y = Y64.to(dtype)
                Q, R = torch.empty_like(Y), Y.new_empty((T, r, r))

                def call():
                    return fn(Y.data_ptr(), Q.data_ptr(), R.data_ptr(), None,
                              T, b, r, 2, stream)
                build.check(f"batched_qr variant {name}", call())
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(5):
                    call()
                stop.record()
                torch.cuda.synchronize()
                times.append(f"{str(dtype)[6:]} {(T, b, r)} "
                             f"{start.elapsed_time(stop) / 5:.4f} ms")
        print(f"{name}: registers {regs}; " + "; ".join(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
