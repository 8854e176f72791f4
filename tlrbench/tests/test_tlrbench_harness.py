"""Whole runs of tiny cells on the CPU, past the look for a card: a cell
made of new files alone is found and measured; the control (the float32
reference in the program's place) and planted faults of the timed path
come out not correct."""

from __future__ import annotations

import json
import time

import pytest
import torch

from tlrbench import control, harness


def run(root, cell, seed=2**40 + 11, seconds=0.3):
    return harness.run_cell(root, cell, seed, seconds, False, "cpu",
                            time.perf_counter(), log=lambda msg: None)


@pytest.mark.parametrize("cell", ["tiny-cov.chol8", "tiny-frac.pcg"])
def test_sound_run_is_correct(tiny_root, cell):
    res = run(tiny_root, cell)
    assert res["correct"], json.dumps(res)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks" and res["checks"]
    rate = "factor_s" if "cov" in cell else "solution_s"
    assert set(res["metrics"]) == {rate, "setup_s"}


def test_a_new_cell_is_found_from_files_alone(tiny_root):
    """A throwaway configuration, traffic mix, metric and cell, added as
    files and entries only, run without an edit to any existing file."""
    bench = tiny_root / "tlrbench"
    cfg = json.loads((bench / "configs" / "tiny-cov.json").read_text())
    cfg.update(ell=0.05, n=512)
    (bench / "configs" / "tiny-cov-b.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "chol7.json").write_text(
        json.dumps({"step": "cholesky", "eps": 1e-7, "bs": 8}))
    (bench / "limits" / "tiny-cov-b.chol7.json").write_text(
        json.dumps({"diag_resid": 50.0}))
    (bench / "metrics" / "steps_done.py").write_text(
        "def read(record):\n    return float(len(record['steps']))\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-cov-b", "source": "test",
                            "file": "tlrbench/configs/tiny-cov-b.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny-cov-b.chol7",
                              "config": "tiny-cov-b", "traffic": "chol7",
                              "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "steps_done", "unit": "count",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["tiny-cov-b.chol7"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    res = run(tiny_root, "tiny-cov-b.chol7")
    assert res["correct"], json.dumps(res)
    assert res["metrics"]["steps_done"]["value"] == res["attempted"]
    assert set(res["checks"]) == {"diag_resid"}
    assert "factor_s" not in res["metrics"]


@pytest.mark.parametrize("cell", ["tiny-cov.chol8", "tiny-frac.pcg"])
def test_control_is_not_correct(tiny_root, cell):
    with control.float32_in_place(block=256):
        res = run(tiny_root, cell)
    assert not res["correct"], json.dumps(res)


def _break_factor(monkeypatch, how: str):
    from repro_torch import TLROperator
    real = TLROperator.cholesky

    def broken(self, opts=None):
        fact = real(self, opts)
        L = fact.L
        if how == "unchanged":       # the step hands back its input
            L.D.copy_(self.A.D)
            L.U[:, :, :self.A.r_max].copy_(self.A.U)
            L.V[:, :, :self.A.r_max].copy_(self.A.V)
            L.ranks.copy_(self.A.ranks)
        elif how == "half":          # every other tile left out
            L.ranks[::2] = 0
        elif how == "altered":       # one answer altered where produced
            L.D[1, 3, 2] += 1e-3
        return fact

    monkeypatch.setattr(TLROperator, "cholesky", broken)


def _break_solution(monkeypatch, how: str):
    import repro_torch
    real = repro_torch.pcg

    def broken(*args, **kw):
        x, it, hist = real(*args, **kw)
        if how == "unchanged":
            x = torch.zeros_like(x)
        elif how == "half":
            x = x.clone()
            x[1::2] = 0.0
        elif how == "altered":
            x = x.clone()
            x[7] += 1.0
        return x, it, hist

    monkeypatch.setattr(repro_torch, "pcg", broken)


@pytest.mark.parametrize("how", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", ["tiny-cov.chol8", "tiny-frac.pcg"])
def test_fault_in_the_timed_path_is_not_correct(tiny_root, monkeypatch,
                                                cell, how):
    if "cov" in cell:
        _break_factor(monkeypatch, how)
    else:
        _break_solution(monkeypatch, how)
    res = run(tiny_root, cell)
    assert not res["correct"], json.dumps(res)
    assert res["failed"] >= 1
