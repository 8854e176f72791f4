"""The port's examples on the CPU at a small n (``--device cpu``):
examples/quickstart_torch.py, examples/gaussian_process_torch.py and
examples/serve_gp_torch.py, each through its ``main(argv)``. The
quickstart's memory line must equal what the JAX package's compression of
the same matrix reports, and its logdet the dense one; every ``--trace``
file must pass the Chrome-trace schema check of tests/test_obs.py.
(tests/test_torch_slice.py holds ``examples/*_torch.py`` to the import
rule.)"""

import importlib.util
import json
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TLROperator as JOperator
from repro.core import covariance_problem as jax_covariance_problem
from repro_torch import obs
from test_torch_obs import assert_chrome_trace_schema

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many small torch ops a call: one intra-op thread beside the suite's
    other workers. Restored after, with telemetry off."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    obs.disable()


def _example(name: str):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_matches_jax_compression(capsys):
    n, tile, eps = 512, 64, 1e-6
    _example("quickstart_torch").main(["--n", str(n), "--tile", str(tile),
                                       "--eps", str(eps), "--device", "cpu"])
    out = capsys.readouterr().out
    _, K = jax_covariance_problem(n, 3, tile)
    mem = JOperator.compress(jnp.asarray(K), tile, eps=eps * 1e-2) \
        .memory_stats()
    assert (f"TLR memory: {mem['total_bytes_logical']/2**20:.1f} MiB "
            f"(dense {mem['full_dense_bytes']/2**20:.1f} MiB = "
            f"{mem['dense_equivalent_gb']:.3f} GiB, "
            f"compression {mem['compression_ratio']:.1f}x, "
            f"avg rank {mem['avg_rank']:.1f})") in out
    tlr, dense = map(float, re.search(
        r"logdet: (\S+) \(dense (\S+)\)", out).groups())
    assert dense == pytest.approx(np.linalg.slogdet(K)[1], abs=1e-4)
    assert tlr == pytest.approx(dense, abs=1e-3)
    err = float(re.search(r"solve relative error: (\S+)", out).group(1))
    assert err < 1e-5
    assert "batched solve: rhs (512, 4) -> (512, 4)" in out
    assert "MVN samples: shape (512, 2)" in out


def test_gaussian_process_traces(capsys, tmp_path):
    path = tmp_path / "gp.json"
    _example("gaussian_process_torch").main(
        ["--n", "256", "--tile", "64", "--device", "cpu", "--trace",
         str(path)])
    out = capsys.readouterr().out
    diff = float(re.search(r"abs diff: (\S+)", out).group(1))
    assert diff < 1e-3
    assert len(re.findall(r"^ +0\.\d+ +-?\d+\.\d\d$", out, re.M)) == 4
    obj = json.loads(path.read_text())
    assert_chrome_trace_schema(obj)
    names = {e["name"] for e in obj["traceEvents"] if e["ph"] == "X"}
    assert {"chol.factorize", "chol.panel", "trsm.sweep"} <= names
    assert f"wrote {path}" in out and not obs.enabled()


def test_serve_gp_traces(capsys, tmp_path):
    path = tmp_path / "serve.json"
    _example("serve_gp_torch").main(
        ["--n", "256", "--tile", "64", "--requests", "16", "--device", "cpu",
         "--trace", str(path)])
    out = capsys.readouterr().out
    assert "drained 16 requests" in out and "new dispatch shapes none" in out
    obj = json.loads(path.read_text())
    assert_chrome_trace_schema(obj)
    ticks = int(re.search(r"(\d+) ticks", out).group(1))
    evs = obj["traceEvents"]
    assert sum(e["name"] == "serve.tick" for e in evs if e["ph"] == "X") \
        == ticks
    assert re.search(rf"serve spans over {ticks} ticks", out)
    assert any(e["ph"] == "C" and e["name"] == "occupancy" for e in evs)
