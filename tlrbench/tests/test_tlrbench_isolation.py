"""The benchmark imports neither JAX nor the JAX package, its reference
imports nothing of the program, and the command prints no result without a
card or without the program."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from tlrbench import harness

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(BENCH)): sorted(top_level_imports(p)
                                               & FORBIDDEN)
             for p in BENCH.rglob("*.py")}
    assert len(found) > 20
    assert {p: n for p, n in found.items() if n} == {}


def test_reference_modules_import_nothing_of_the_program():
    frozen = list((BENCH / "frozen").rglob("*.py"))
    assert len(frozen) >= 7
    for p in frozen:
        assert "repro_torch" not in top_level_imports(p), p


def test_whole_names_tell_the_port_from_the_jax_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core_fake", sys)
    assert harness.forbidden_modules() == ["repro.core_fake"]


def _run(cwd: Path, env_extra: dict):
    env = dict(os.environ, **env_extra)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "tlrbench/run.py", "--workload", "cov2d-64k.chol",
         "--seed", str(2**40 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _has_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if "correct" in json.loads(line):
                return True
        except (ValueError, TypeError):
            pass
    return False


def test_command_exits_nonzero_without_a_card():
    proc = _run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert not _has_result(proc.stdout)
    assert "no CUDA card" in proc.stderr


def test_a_run_fails_in_a_checkout_without_the_program(tmp_path):
    """Past the look for a card, a checkout of BENCHMARK.json and the
    benchmark's files alone cannot run a cell: it has no program."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "tlrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; from pathlib import Path; "
            "sys.path[0:0] = [str(Path.cwd())]; "
            "from tlrbench import harness; "
            "harness.run_cell(Path.cwd(), 'cov2d-64k.chol', 1, 1.0, False, "
            "'cpu', time.perf_counter())")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "repro_torch" in proc.stderr
    assert not _has_result(proc.stdout)


@pytest.mark.parametrize("entry", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_every_file_the_benchmark_names_exists(entry):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for item in bench[entry]:
        if entry == "configs":
            assert (ROOT / item["file"]).is_file()
        elif entry == "workloads":
            assert (BENCH / "traffic" / f"{item['traffic']}.json").is_file()
            assert (BENCH / "limits" / f"{item['name']}.json").is_file()
        else:
            assert (BENCH / "metrics" / f"{item['name']}.py").is_file()
