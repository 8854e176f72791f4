"""Shared set-up of the benchmark's own tests (``python -m pytest
tlrbench/tests`` from the repository's root): the checkout's root and
``src/`` on the path, torch on few threads, and a throwaway checkout with
tiny cells built from files alone."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

torch.set_num_threads(2)

TINY = {"n": 1024, "tile": 128, "compress_chunk": 64, "warm_n": 512}


def tiny_config(name: str, **extra) -> dict:
    cfg = json.loads((ROOT / "tlrbench" / "configs" / f"{name}.json")
                     .read_text())
    cfg.update(TINY, r_max=min(cfg["r_max"], 128), **extra)
    return cfg


@pytest.fixture
def tiny_cfg():
    """:func:`tiny_config`, for tests."""
    return tiny_config


@pytest.fixture
def tiny_root(tmp_path: Path) -> Path:
    """A checkout in ``tmp_path`` with two tiny cells, ``tiny-cov.chol8``
    (the covariance at eps 1e-8) and ``tiny-frac.pcg``, their limits, and
    copies of the benchmark's metric readers."""
    bench = tmp_path / "tlrbench"
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True)
    shutil.copytree(ROOT / "tlrbench" / "metrics", bench / "metrics")
    (bench / "configs" / "tiny-cov.json").write_text(
        json.dumps(tiny_config("cov2d-64k")))
    (bench / "configs" / "tiny-frac.json").write_text(
        json.dumps(tiny_config("frac3d-32k")))
    (bench / "traffic" / "chol8.json").write_text(
        json.dumps({"step": "cholesky", "eps": 1e-8, "bs": 16}))
    shutil.copy(ROOT / "tlrbench" / "traffic" / "pcg-1e-4.json",
                bench / "traffic" / "pcg.json")
    (bench / "limits" / "tiny-cov.chol8.json").write_text(
        json.dumps({"diag_resid": 50.0, "offdiag_resid": 50.0}))
    (bench / "limits" / "tiny-frac.pcg.json").write_text(
        json.dumps({"x_resid": 1e-6}))
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {"tiny-cov.chol8": "factor_s", "tiny-frac.pcg": "solution_s"}
    e2e = [dict(m, workloads=[c for c, rate in cells.items()
                              if rate == m["name"]])
           if m["name"] in cells.values() else m
           for m in real["end_to_end"]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        **real,
        "configs": [
            {"name": "tiny-cov", "source": "test",
             "file": "tlrbench/configs/tiny-cov.json", "reduced": ["n"],
             "why": "test"},
            {"name": "tiny-frac", "source": "test",
             "file": "tlrbench/configs/tiny-frac.json", "reduced": ["n"],
             "why": "test"}],
        "workloads": [
            {"name": "tiny-cov.chol8", "config": "tiny-cov",
             "traffic": "chol8", "chips": 1, "why": "test"},
            {"name": "tiny-frac.pcg", "config": "tiny-frac",
             "traffic": "pcg", "chips": 1, "why": "test"}],
        "end_to_end": e2e, "per_layer": []}))
    return tmp_path
