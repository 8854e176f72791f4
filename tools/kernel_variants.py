#!/usr/bin/env python3
"""Time compiled variants of one kernel source (``csrc/<kernel>.cu``) on one
card.

The first argument names the kernel (``batched_qr``, ``batched_gemm``,
``tile_chain`` or ``lr_sample``);
each further argument names a variant and its extra ``nvcc`` flags,
``name=flags`` (``base`` alone builds the source as it is), and may name
another source file of the same kernel, ``name@path=flags`` (for example
an earlier commit's, unpacked into a git-ignored directory; the package's
``csrc/`` stays on the include path). Every variant is compiled in
parallel into ``build/variants/`` with the package's flags, loaded with
ctypes, and its kernel time (CUDA events, mean of 5 after one warm call)
printed at the paths' shapes beside each kernel's ptxas registers and
spill stores: ``batched_qr`` at the right-looking driver's shapes and at
op.round's, in f64 and f32, on random panels with columns of norm ~1;
``batched_gemm`` in f64 at the main path's ``sample`` and ``sample_t``
(ranks 1-28, as ``tools/kernel_bench.py`` draws them), the right driver's
flush densify, truncation and trailing SYRK (ranks drawn like L's: mean
~8, max 39), a panel densify, one tile, and op.round's truncation, on
random operands, each timed by CUDA events over 10 back-to-back calls and
as calls replayed from a CUDA graph (``chip_smoke.graph_ms``);
``tile_chain`` in f64 at the fractional-diffusion path's projection chains
past r = 128 and the main path's ``sample_t``, ``lr_sample`` in f64 at the
fractional-diffusion path's column buckets past r = 128, one at r = 512
and the main path's headline (random operands, CUDA events over 5
calls). A
``batched_gemm`` source without the ``config`` query (the FMA-only
kernel of earlier commits)
is launched through its own entry, which takes no configuration. Inputs
come from a fixed seed; nothing is checked against the plain version
(``tools/kernel_bench.py`` does that).

Run from the root of a checkout, on a machine with the card:

    python3 tools/kernel_variants.py batched_gemm base "w16=-DSOME_MACRO=16"
    python3 tools/kernel_variants.py batched_gemm base old@build/old/batched_gemm.cu
"""

from __future__ import annotations

import concurrent.futures as cf
import ctypes
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
QR_SHAPES = ((2016, 128, 128), (63, 128, 128), (2016, 512, 128))
# (T, m, k, n, ranks): "full" for rank k in every tile, "L" for L-like
# ranks, "A" for ranks 1-28
GEMM_SHAPES = ((63, 512, 128, 16, "A"), (63, 512, 128, 128, "A"),
               (2016, 128, 384, 128, "full"), (2016, 128, 128, 128, "full"),
               (1953, 128, 128, 128, "L"), (63, 128, 384, 128, "full"),
               (1, 128, 128, 128, "full"), (2016, 512, 128, 128, "full"))
# (T, b, r, s): frac3d-16k-pcg's widest chains, a width-512 one, sample_t
CHAIN_SHAPES = ((434, 512, 256, 256), (352, 512, 256, 256),
                (434, 512, 256, 128), (112, 512, 512, 256),
                (1890, 512, 128, 128))
# (T, J, b, r, s): frac3d-16k-pcg's buckets past 128, r = 512, the headline
LR_SHAPES = ((31, 14, 512, 256, 16), (16, 22, 512, 256, 16),
             (8, 26, 512, 256, 16), (1, 30, 512, 256, 16),
             (8, 6, 512, 512, 16), (63, 30, 512, 128, 16))


def _event_ms(call, reps: int = 5) -> float:
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def qr_times(cdll, name: str, stream: int) -> list[str]:
    import torch
    from repro_torch.kernels import build
    g = torch.Generator(device="cuda").manual_seed(0)
    inputs = {s: torch.randn(s, generator=g, device="cuda",
                             dtype=torch.float64) / math.sqrt(s[1])
              for s in QR_SHAPES}
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
            times.append(f"{str(dtype)[6:]} {(T, b, r)} "
                         f"{_event_ms(call):.4f} ms")
    return times


def gemm_times(cdll, name: str, stream: int) -> list[str]:
    import torch
    from chip_smoke import graph_ms
    from repro_torch.kernels import build
    g = torch.Generator(device="cuda").manual_seed(0)
    fn = cdll.repro_batched_gemm_f64
    fn.restype = ctypes.c_int
    signature = list(build._SIGNATURES["batched_gemm"])
    if hasattr(cdll, "repro_batched_gemm_config_f64"):
        config = cdll.repro_batched_gemm_config_f64
        config.argtypes, config.restype = [ctypes.c_int], ctypes.c_int
    else:   # an FMA-only source: no configuration argument
        config = None
        del signature[-2]
    fn.argtypes = signature
    times = []
    for T, m, k, n, kind in GEMM_SHAPES:
        A = torch.randn((T, m, k), generator=g, device="cuda",
                        dtype=torch.float64)
        B = torch.randn((T, k, n), generator=g, device="cuda",
                        dtype=torch.float64) / math.sqrt(k)
        C = A.new_empty((T, m, n))
        if kind == "full":
            ranks = torch.full((T,), k, dtype=torch.int32, device="cuda")
        elif kind == "A":
            ranks = torch.randint(1, 29, (T,), generator=g, device="cuda",
                                  dtype=torch.int32)
        else:
            u = torch.rand((T,), generator=g, device="cuda",
                           dtype=torch.float64)
            ranks = (-8.7 * torch.log(u)).floor().clamp(0, 39).to(torch.int32)
        dims = (T, m, k, n) if config is None else (T, m, k, n, config(n))

        def call():
            # the current stream, which a graph capture replaces
            return fn(A.data_ptr(), B.data_ptr(), ranks.data_ptr(),
                      C.data_ptr(), *dims,
                      torch.cuda.current_stream().cuda_stream)
        build.check(f"batched_gemm variant {name}", call())
        times.append(f"{(T, m, k, n)} {kind} ranks {_event_ms(call, 10):.4f} "
                     f"ms events, {graph_ms(call):.4f} ms graph")
    return times


def chain_times(cdll, name: str, stream: int) -> list[str]:
    import torch
    g = torch.Generator(device="cuda").manual_seed(0)
    fn = cdll.repro_tile_chain_f64
    fn.restype = ctypes.c_int
    config = cdll.repro_tile_chain_config_f64
    config.argtypes, config.restype = [ctypes.c_int] * 2, ctypes.c_int
    from repro_torch.kernels import build
    fn.argtypes = build._SIGNATURES["tile_chain"]
    times = []
    for T, b, r, s in CHAIN_SHAPES:
        U, V = (torch.randn((T, b, r), generator=g, device="cuda",
                            dtype=torch.float64) for _ in range(2))
        X = torch.randn((T, b, s), generator=g, device="cuda",
                        dtype=torch.float64)
        out = torch.empty_like(X)
        cfg = config(r, s)

        def call():
            return fn(U.data_ptr(), V.data_ptr(), X.data_ptr(),
                      out.data_ptr(), T, b, r, r, s, cfg, stream)
        build.check(f"tile_chain variant {name}", call())
        times.append(f"{(T, b, r, s)} {_event_ms(call):.4f} ms")
        del U, V, X, out
    return times


def lr_times(cdll, name: str, stream: int) -> list[str]:
    import torch
    from repro_torch.kernels import build
    g = torch.Generator(device="cuda").manual_seed(0)
    fn = cdll.repro_lr_sample_f64
    fn.restype = ctypes.c_int
    fn.argtypes = build._SIGNATURES["lr_sample"]
    config = cdll.repro_lr_sample_config_f64
    config.argtypes, config.restype = [ctypes.c_int] * 2, ctypes.c_int
    workspace = cdll.repro_lr_sample_workspace_f64
    workspace.argtypes = [ctypes.c_int] * 5
    workspace.restype = ctypes.c_longlong
    times = []
    for T, J, b, r, s in LR_SHAPES:
        Ui, Vi = (torch.randn((T, J, b, r), generator=g, device="cuda",
                              dtype=torch.float64) for _ in range(2))
        W2 = torch.randn((J, b, s), generator=g, device="cuda",
                         dtype=torch.float64)
        Y = W2.new_empty((T, b, s))
        words = workspace(T, J, b, r, s)
        work = W2.new_empty(max(words, 1))
        cfg = config(r, s)

        def call():
            return fn(Ui.data_ptr(), Vi.data_ptr(), W2.data_ptr(),
                      Y.data_ptr(), work.data_ptr() if words else None, T,
                      J, b, r, r, s, cfg, stream)
        build.check(f"lr_sample variant {name}", call())
        times.append(f"{(T, J, b, r, s)} {_event_ms(call):.4f} ms")
        del Ui, Vi, W2, Y, work
    return times


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA card", file=sys.stderr)
        return 2
    kernel = sys.argv[1] if len(sys.argv) > 1 else ""
    timer = {"batched_qr": qr_times, "batched_gemm": gemm_times,
             "tile_chain": chain_times, "lr_sample": lr_times}.get(kernel)
    if timer is None:
        print("kernel_variants: name batched_qr, batched_gemm, tile_chain or "
              "lr_sample first", file=sys.stderr)
        return 2
    variants = dict(a.split("=", 1) if "=" in a else (a, "")
                    for a in sys.argv[2:] or ["base"])
    sources = {}
    for key in list(variants):
        name, _, source = key.partition("@")
        sources[name] = (ROOT / source if source
                         else build.CSRC / f"{kernel}.cu")
        variants[name] = variants.pop(key)
    out_dir = build.BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)

    def compile_one(item):
        name, flags = item
        lib = out_dir / f"lib{kernel}_{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}",
               *flags.split(), "-o", str(lib), str(sources[name])]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}"
                               f"{proc.stderr}")
        lines = (proc.stdout + proc.stderr).splitlines()
        regs = [int(line.split("Used")[1].split()[0])
                for line in lines if "Used" in line]
        spills = [int(line.split("bytes spill stores")[0].split(",")[-1])
                  for line in lines if "spill stores" in line]
        return name, lib, regs, spills

    with cf.ThreadPoolExecutor(len(variants)) as ex:
        libs = list(ex.map(compile_one, variants.items()))
    stream = torch.cuda.current_stream().cuda_stream
    for name, lib, regs, spills in libs:
        times = timer(ctypes.CDLL(str(lib)), name, stream)
        print(f"{name}: registers {regs}, spill stores {spills}; "
              + "; ".join(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
