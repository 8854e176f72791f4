"""One rank of ``tests/test_torch_multidevice.py``: the cases of
``tests/test_multidevice.py`` on a (2, 2) ``("data", "model")`` mesh of
gloo CPU ranks, run by the port.

    python tests/torch_mesh_ranks.py RANK WORLD STORE OPS OUT

``STORE`` is the ``file://`` rendezvous of the process group, ``OPS`` an
``.npz`` of the operators' tiles (the parent's, so that the factors here
and the parent's JAX reference start from the same tiles), ``OUT`` the
pickle this rank writes its results to: its share of the factors without
a mesh (the references, dealt over the ranks), then the factors with the
mesh installed, as numpy arrays, the messages of the expected errors and
the counters the test asserts on. Imports neither jax nor the JAX
package.
"""

from __future__ import annotations

import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.convert import operator_from_numpy
from repro_torch.core import (CholOptions, batching_trace_count,
                              pad_tile_batch, set_tile_mesh,
                              shard_tile_batch, tile_dp_size, trace_counts,
                              trace_counts_diff)
from repro_torch.launch.mesh import make_test_mesh

# The right-looking parity cases: (batching, lookahead).
RIGHT_CASES = [(b, la) for b in ("flat", "ranked") for la in (False, True)]
EPS = 1e-6


def factor_arrays(fact) -> dict:
    return {"D": fact.L.D.numpy(), "U": fact.L.U.numpy(),
            "V": fact.L.V.numpy(), "ranks": fact.L.ranks.numpy()}


def error_of(fn) -> str | None:
    """The message of the ValueError ``fn`` raises (None if it returns)."""
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return None


def references(rank: int, world: int, op8, op4, op5) -> dict:
    """This rank's share of the factors without a mesh (the bitwise
    references), the jobs dealt round-robin over the ranks."""
    jobs = [(("right", b, la), op8, CholOptions(eps=EPS, algo="right",
                                                  batching=b, lookahead=la))
            for b, la in RIGHT_CASES]
    jobs += [("left", op4, CholOptions(eps=EPS, algo="left")),
             ("nb5", op5, CholOptions(eps=EPS, algo="right"))]
    return {key: factor_arrays(op.cholesky(opts))
            for key, op, opts in jobs[rank::world]}


def run(ops: dict, mesh, rank: int, world: int) -> dict:
    op8, op4, op5 = (operator_from_numpy(*(ops[f"{k}{nb}"] for k in "DUVr"),
                                         device="cpu") for nb in (8, 4, 5))
    out: dict = {"ref": references(rank, world, op8, op4, op5)}
    set_tile_mesh(mesh)
    # -- the right driver, sharded: parity, solve, accumulator bytes
    for batching, lookahead in RIGHT_CASES:
        f = op8.cholesky(CholOptions(eps=EPS, algo="right",
                                     batching=batching, lookahead=lookahead))
        out[("right", batching, lookahead)] = {
            **factor_arrays(f), "schedule": f.stats["schedule"]["name"],
            "flushes": f.stats["flushes"], "acc_width": f.stats["acc_width"],
            "acc_bytes": f.stats["acc_bytes"],
            "tile_rows": f.stats["tile_rows"],
            "column_traces": f.stats["column_traces"]}
        if batching == "flat" and lookahead:
            x = np.random.default_rng(0).standard_normal(op8.n)
            y = f.solve(torch.from_numpy(ops["K8"] @ x)).numpy()
            out["solve_err"] = float(np.linalg.norm(y - x)
                                     / np.linalg.norm(x))
    # -- the last case again, warm: no new dispatch shape, the batching
    # count unchanged
    snap, b0 = trace_counts(), batching_trace_count()
    f = op8.cholesky(CholOptions(eps=EPS, algo="right", batching=batching,
                                 lookahead=lookahead))
    out["warm"] = {"diff": trace_counts_diff(snap),
                   "batching": batching_trace_count() - b0,
                   "column_traces": (
                       out[("right", batching, lookahead)]["column_traces"],
                       f.stats["column_traces"])}
    # -- the left driver on the mesh, and the root span's mesh attributes
    tel = obs.enable()
    try:
        out["left"] = factor_arrays(op4.cholesky(CholOptions(eps=EPS,
                                                             algo="left")))
    finally:
        obs.disable()
    root = next(sp for sp in tel.spans if sp.name == "chol.factorize")
    out["span"] = {k: root.args[k] for k in ("devices", "mesh")}
    # -- pad mode on a bare batch
    x = torch.ones((7, 4, 4), dtype=torch.float64)
    y = shard_tile_batch(x)
    yp = shard_tile_batch(x, preserve_shape=True)
    out["pad"] = {"dp": tile_dp_size(), "pad7": pad_tile_batch(7),
                  "pad8": pad_tile_batch(8), "shape": tuple(y.shape),
                  "local": tuple(y.to_local().shape),
                  "full": y.full_tensor().numpy(),
                  "preserve_shape": tuple(yp.shape),
                  "preserve_full": yp.full_tensor().numpy(),
                  "preserve_local": tuple(yp.to_local().shape)}
    # -- the indivisible grid (nb = 5: nt = 10 divides, the diagonal stack
    # does not) under "pad"; the single-device factor comes from the parent
    out["nb5_pad"] = factor_arrays(op5.cholesky(CholOptions(eps=EPS,
                                                            algo="right")))
    # -- error mode
    set_tile_mesh(mesh, on_indivisible="error")
    out["error"] = {
        "pad": error_of(lambda: shard_tile_batch(x)),
        "preserve": error_of(lambda: shard_tile_batch(x, preserve_shape=True)),
        "divisible_shape": tuple(shard_tile_batch(
            torch.ones((8, 4, 4), dtype=torch.float64)).shape),
        "nb5": error_of(lambda: op5.cholesky(CholOptions(eps=EPS,
                                                         algo="right")))}
    out["invalid_mode"] = error_of(
        lambda: set_tile_mesh(mesh, on_indivisible="ignore"))
    set_tile_mesh(None)
    return out


def main(rank: int, world: int, store: str, ops_path: str,
         out_path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = make_test_mesh((2, 2), ("data", "model"), device_type="cpu")
        with np.load(ops_path) as z:
            ops = dict(z)
        out = run(ops, mesh, rank, world)
        with open(out_path, "wb") as fh:
            pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
