"""The port's multi-device tile sharding, mirroring every case of
tests/test_multidevice.py on four gloo CPU ranks.

One module-scoped fixture compresses the operators (the port, on the
CPU) and starts four ranks of ``tests/torch_mesh_ranks.py`` on a (2, 2)
``("data", "model")`` mesh (a ``file://`` rendezvous under the test's
temporary directory, so parallel test workers share no port). The ranks
first factor the tiles without a mesh, the jobs dealt over them (the
port's bitwise references), then with it; meanwhile the fixture factors
the same tiles with the JAX package (the reference the JAX test pins its
sharded factor to bit for bit). Each case then reads its part of the
results.

Sizes: nb = 8 at tile 16 for the right driver (nt = 28 divides the data
size 2; the JAX test takes tile 32, whose plain Jacobi SVDs would take
this file past its time budget), nb = 4 for the left driver, nb = 5 for
the indivisible grid.
"""

import contextlib
import os
import pickle
import re
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CholOptions as JCholOptions
from repro.core import TLRMatrix as JTLRMatrix
from repro.core import TLROperator as JOperator
from repro_torch.convert import tlr_from_numpy
from repro_torch.core import (TLROperator, covariance_problem, pad_tile_batch,
                              shard_tile_batch, tile_dp_size, tile_mesh)

ROOT = Path(__file__).resolve().parents[1]
RANK_SCRIPT = ROOT / "tests" / "torch_mesh_ranks.py"
WORLD = 4
B, EPS = 16, 1e-6
RIGHT_CASES = [(b, la) for b in ("flat", "ranked") for la in (False, True)]
# The port against the JAX package's single-device right factor: the dense
# lower factors within 1e-8 relative, tests/test_torch_rightlook.py's
# tolerance (MGS2 and Jacobi against Householder and LAPACK; measured
# ~3e-15 here).
JAX_RTOL = 1e-8
RANK_TIMEOUT = 300


def _tiles(nb: int) -> dict:
    """K and the port's compressed tiles of the test covariance (the JAX
    package's factor below runs on these tiles too)."""
    _, K = covariance_problem(nb * B, 3, B, device="cpu")
    A = TLROperator.compress(K, B, B, 1e-9).A
    return {"K": K.numpy(), "D": A.D.numpy(), "U": A.U.numpy(),
            "V": A.V.numpy(), "r": A.ranks.numpy()}


def _assert_factors_equal(got: dict, want: dict) -> None:
    for key in ("D", "U", "V", "ranks"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _dense_lower(f: dict) -> np.ndarray:
    L = tlr_from_numpy(f["D"], f["U"], f["V"], f["ranks"], device="cpu")
    return np.tril(L.to_dense().numpy())


@contextlib.contextmanager
def _one_thread():
    """The plain QR and Jacobi versions run thousands of small ops a call;
    beside the suite's other workers one intra-op thread is fastest (as in
    tests/test_torch_rightlook.py). Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Every case's results: the four ranks' pickles, the port's factors
    without a mesh (from the ranks) and the JAX package's single-device
    right factor."""
    tmp = tmp_path_factory.mktemp("mesh")
    with _one_thread():
        ops = {f"{k}{nb}": v for nb in (8, 4, 5)
               for k, v in _tiles(nb).items()}
    np.savez(tmp / "ops.npz", **ops)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = []
    try:
        for r in range(WORLD):
            with open(tmp / f"rank{r}.log", "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(RANK_SCRIPT), str(r), str(WORLD),
                     str(tmp / "store"), str(tmp / "ops.npz"),
                     str(tmp / f"rank{r}.pkl")],
                    env=env, stdout=log, stderr=subprocess.STDOUT))
        # meanwhile, the JAX package's factor of the same tiles
        jop8 = JOperator(A=JTLRMatrix(*(jnp.asarray(ops[f"{k}8"])
                                        for k in "DUVr")))
        jf = jop8.cholesky(JCholOptions(eps=EPS, algo="right",
                                        batching="flat"))
        jax_ref = {"L": np.tril(np.asarray(jf.L.to_dense())),
                   "ranks": np.asarray(jf.L.ranks)}
        # A rank that fails leaves the others waiting in a collective: stop
        # at the first failure (or the deadline) and kill the rest.
        deadline = time.monotonic() + RANK_TIMEOUT
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if None not in codes or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, \
            f"rank {r} failed:\n{(tmp / f'rank{r}.log').read_text()}"
    ranks = [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
             for r in range(WORLD)]
    ref = {k: v for res in ranks for k, v in res.pop("ref").items()}
    return {"ranks": ranks, "ref": ref, "jax": jax_ref}


# -- end-to-end sharded factorization -----------------------------------------


@pytest.mark.parametrize("lookahead", [False, True])
@pytest.mark.parametrize("batching", ["flat", "ranked"])
def test_right_factorization_sharded_parity(mesh_run, lookahead, batching):
    """Full right-looking Cholesky on the mesh == the unsharded port's
    factor bit for bit, on every rank, and within JAX_RTOL of the JAX
    package's single-device factor (its flat one: the JAX test holds its
    ranked and lookahead factors to it bit for bit or to rounding, and
    tests/test_torch_batching.py holds the port's ranked driver to JAX's)."""
    key = ("right", batching, lookahead)
    got = [r[key] for r in mesh_run["ranks"]]
    for g in got:
        _assert_factors_equal(g, mesh_run["ref"][key])
    assert got[0]["schedule"] == ("lookahead" if lookahead
                                  else "sequential")
    L = _dense_lower(got[0])
    Lj = mesh_run["jax"]["L"]
    assert np.linalg.norm(L - Lj) / np.linalg.norm(Lj) <= JAX_RTOL
    if batching == "flat":
        np.testing.assert_array_equal(got[0]["ranks"],
                                      mesh_run["jax"]["ranks"])


def test_accumulators_split_over_the_data_ranks(mesh_run):
    """Each rank holds its half of the accumulation tiles: rows [0, 14) on
    data coordinate 0, [14, 28) on 1, whatever the model coordinate (rank
    r sits at data r // 2), and exactly half the bytes of one device's."""
    nt = 8 * 7 // 2
    for r, res in enumerate(mesh_run["ranks"]):
        for case in RIGHT_CASES:
            st = res[("right", *case)]
            lo = (r // 2) * nt // 2
            assert st["tile_rows"] == [lo, lo + nt // 2, nt]
            assert st["acc_bytes"] == nt // 2 * B * st["acc_width"] * 8


def test_sharded_factorization_solves(mesh_run):
    for res in mesh_run["ranks"]:
        assert res["solve_err"] < 1e-4


def test_left_factorization_sharded_parity(mesh_run):
    """The left driver runs replicated on the mesh: its factor is the one
    without a mesh, on every rank."""
    for res in mesh_run["ranks"]:
        _assert_factors_equal(res["left"], mesh_run["ref"]["left"])


def test_mesh_in_the_factorization_span(mesh_run):
    """The ``chol.factorize`` span reports the mesh, as the JAX package's
    does (``devices`` = its size, ``mesh`` = its axes)."""
    for res in mesh_run["ranks"]:
        assert res["span"] == {"devices": 4,
                               "mesh": str({"data": 2, "model": 2})}


def test_compile_counts_stable_on_mesh(mesh_run):
    """The dispatch-shape contract survives sharding: a warm sharded
    factorization (the ranked lookahead case again) adds no dispatch
    shape (the port's counterpart of no retrace) and the same column
    shapes as the run before it."""
    for res in mesh_run["ranks"]:
        warm = res["warm"]
        assert warm["diff"] == {}
        assert warm["batching"] == 0
        assert warm["column_traces"][0] == warm["column_traces"][1]


# -- indivisibility modes -----------------------------------------------------


def test_pad_mode_pads_batch_axis(mesh_run):
    for res in mesh_run["ranks"]:
        pad = res["pad"]
        assert pad["dp"] == 2
        assert pad["pad7"] == 8 and pad["pad8"] == 8
        assert pad["shape"] == (8, 4, 4)       # zero-padded to the quantum
        assert pad["local"] == (4, 4, 4)       # this rank's rows
        assert float(np.abs(pad["full"][7]).max()) == 0.0
        np.testing.assert_array_equal(pad["full"][:7], np.ones((7, 4, 4)))


def test_pad_mode_preserve_shape_replicates(mesh_run):
    for res in mesh_run["ranks"]:
        pad = res["pad"]
        assert pad["preserve_shape"] == (7, 4, 4)   # caller-visible shape
        assert pad["preserve_local"] == (7, 4, 4)   # every rank: all rows
        np.testing.assert_array_equal(pad["preserve_full"],
                                      np.ones((7, 4, 4)))


def test_error_mode_raises_with_sizes(mesh_run):
    for res in mesh_run["ranks"]:
        err = res["error"]
        assert re.search(r"size 7.*divide.*2", err["pad"])
        assert "divide" in err["preserve"]
        # divisible batches still shard fine under "error"
        assert err["divisible_shape"] == (8, 4, 4)


def test_error_mode_fails_factorization_on_indivisible_grid(mesh_run):
    """nb=5 -> nt=10 divides dp=2, but the nb=5 diagonal stack does not:
    "error" fails the factorization loudly, while "pad" gives the factor
    without a mesh bit for bit."""
    for res in mesh_run["ranks"]:
        assert "divide" in res["error"]["nb5"]
        _assert_factors_equal(res["nb5_pad"], mesh_run["ref"]["nb5"])


def test_invalid_mode_rejected(mesh_run):
    for res in mesh_run["ranks"]:
        assert res["invalid_mode"] is not None
        assert "on_indivisible" in res["invalid_mode"]


def test_no_mesh_is_identity():
    """Without a mesh every hook is the identity, as in the JAX package."""
    assert tile_mesh() is None
    assert tile_dp_size() == 1
    assert pad_tile_batch(7) == 7 and pad_tile_batch(0) == 0
    x = torch.ones((7, 4, 4))
    assert shard_tile_batch(x) is x
    a, b = shard_tile_batch(x, x[:3], preserve_shape=True)
    assert a is x and b.shape == (3, 4, 4)
