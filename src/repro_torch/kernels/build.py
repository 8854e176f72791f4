"""Compiles and loads the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface, and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). The first call to :func:`library` builds every
source at once, one ``nvcc`` process per source started together, into
``build/repro_torch_kernels/`` at the root of the checkout. Libraries are
named by a hash of their sources and flags, so an edited source rebuilds
and an unchanged one is reused.

Nothing here runs at import time: the CPU tests import every module of the
package on machines without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("batched_gemm", "tile_chain", "lr_sample", "batched_qr",
           "small_svd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of every exported entry point, one per (kernel, dtype suffix).
_SIGNATURES = {
    "batched_gemm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "tile_chain": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "lr_sample": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "batched_qr": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "small_svd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}
SUFFIX = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16"}
# dtypes each kernel is built for (the JAX package's tests sweep QR and SVD
# in f64 and f32 only).
DTYPES = {name: tuple(SUFFIX) for name in SOURCES}
DTYPES.update(batched_qr=(torch.float64, torch.float32),
              small_svd=(torch.float64, torch.float32))
# Shape queries that kernels also export, ``repro_<name>_<query>_<suffix>(dim,
# ...)``, with their return types and numbers of int arguments: "scratch",
# the words of device scratch a tile needs (0 when it works in shared
# memory); "config", the kernel configuration the source chooses for the
# shapes (-1: none fits); "workspace", the words of device workspace a call
# needs (lr_sample's partial sums over groups of j, small_svd's rotation
# logs or working matrices).
QUERIES = {"batched_gemm": {"config": (ctypes.c_int, 1)},
           "batched_qr": {"scratch": (ctypes.c_longlong, 2),
                          "config": (ctypes.c_int, 2)},
           "small_svd": {"workspace": (ctypes.c_longlong, 4)},
           "tile_chain": {"config": (ctypes.c_int, 2)},
           "lr_sample": {"config": (ctypes.c_int, 2),
                         "workspace": (ctypes.c_longlong, 5)}}

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_INFO: dict = {}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built on the machine with the card")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every source that has no up-to-date library, in parallel.

    Returns ``{"seconds": wall time, "built": [...], "ptxas": {name: log}}``
    and raises with the compiler's output if any build fails.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA card; this process "
                           "sees none (torch.cuda.is_available() is False)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in SOURCES:
        lib = _lib_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    logs, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, lib)
    if failed:
        msg = "\n".join(f"--- {n} ---\n{logs[n]}" for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{msg}")
    BUILD_INFO.update(seconds=time.perf_counter() - t0, built=sorted(procs),
                      ptxas=logs)
    return dict(BUILD_INFO)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building all sources first
    if needed. Sets ``argtypes``/``restype`` of every entry point."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        for dtype in DTYPES[name]:
            fn = getattr(lib, f"repro_{name}_{SUFFIX[dtype]}")
            fn.argtypes = _SIGNATURES[name]
            fn.restype = ctypes.c_int
            for query, (restype, nargs) in QUERIES.get(name, {}).items():
                fn = getattr(lib, f"repro_{name}_{query}_{SUFFIX[dtype]}")
                fn.argtypes = [_I] * nargs
                fn.restype = restype
        _LIBS[name] = lib
    return lib


def entry(name: str, dtype: torch.dtype):
    """The C entry point of kernel ``name`` for ``dtype``."""
    if dtype not in DTYPES[name]:
        raise TypeError(f"{name}: dtype {dtype} not supported "
                        f"({', '.join(str(d) for d in DTYPES[name])})")
    return getattr(library(name), f"repro_{name}_{SUFFIX[dtype]}")


def query(name: str, query: str, dtype: torch.dtype, *dims: int) -> int:
    """The answer of kernel ``name``'s source to shape query ``query`` (see
    ``QUERIES``) at ``dims``."""
    entry(name, dtype)  # checks the dtype, builds and loads the library
    return int(getattr(library(name),
                       f"repro_{name}_{query}_{SUFFIX[dtype]}")(*dims))


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
