"""The port's export surface against the JAX package's: every public name of
``repro.core`` imports from ``repro_torch.core``, or is on one of two named
lists -- still to port (with its ROADMAP Queue 1 item) or JAX-only."""

import ast
from pathlib import Path

import repro_torch.core as port_core

ROOT = Path(__file__).resolve().parents[1]

# Names the port does not have yet, with the ROADMAP Queue 1 item that
# brings each.
TO_PORT: dict[str, int] = {}
# Names that exist only because of JAX: the compile-count views of jitted
# cores and the deprecated ``from_dense`` shim.
JAX_ONLY = {"algebra_trace_count", "trsm_trace_count", "from_dense"}


def _jax_core_names() -> list[str]:
    """The names ``repro/core/__init__.py`` imports (its public surface),
    read from the source."""
    tree = ast.parse((ROOT / "src" / "repro" / "core" /
                      "__init__.py").read_text())
    return [a.asname or a.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for a in node.names]


def test_lists_are_disjoint_and_current():
    names = set(_jax_core_names())
    assert len(names) == 90
    assert not TO_PORT.keys() & JAX_ONLY
    assert (TO_PORT.keys() | JAX_ONLY) <= names
    # a name the port gained leaves its list
    for name in TO_PORT.keys() | JAX_ONLY:
        assert not hasattr(port_core, name), name


def test_every_jax_core_name_is_ported_or_listed():
    missing = [n for n in _jax_core_names()
               if n not in TO_PORT and n not in JAX_ONLY
               and not (hasattr(port_core, n) and n in port_core.__all__)]
    assert missing == [], f"repro_torch.core does not export {missing}"


# -- the LM half: models, optim, train, data, checkpoint, configs ------------------

LM_PACKAGES = ("models", "optim", "train", "data", "checkpoint", "configs")
# JAX modules of those packages the port does not have yet, and public
# names of ported modules it lacks. None is left.
LM_DEFERRED_MODULES: set[str] = set()
LM_DEFERRED_NAMES: dict[str, set[str]] = {}


def _public_names(path: Path) -> list[str]:
    """Names a module defines at top level (a package's ``__init__``: also
    the names it imports), not private ones."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            names += [a.asname or a.name for a in node.names
                      if a.name != "annotations"]
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    return [n for n in names if not n.startswith("_")]


def test_lm_packages_export_jax_s_names():
    import importlib
    for pkg in LM_PACKAGES:
        port = importlib.import_module(f"repro_torch.{pkg}")
        names = _public_names(ROOT / "src" / "repro" / pkg / "__init__.py")
        assert names, pkg
        missing = [n for n in names if not hasattr(port, n)]
        assert missing == [], f"repro_torch.{pkg} lacks {missing}"


def test_lm_modules_are_ported_or_listed():
    import importlib
    src = ROOT / "src" / "repro"
    for pkg in LM_PACKAGES:
        for path in sorted((src / pkg).glob("*.py")):
            rel = f"{pkg}/{path.name}"
            port_path = ROOT / "src" / "repro_torch" / pkg / path.name
            if rel in LM_DEFERRED_MODULES:
                assert not port_path.exists(), f"{rel} is ported: unlist it"
                continue
            assert port_path.exists(), f"repro_torch/{rel} is missing"
            mod = importlib.import_module(
                f"repro_torch.{pkg}.{path.stem}".replace(".__init__", ""))
            deferred = LM_DEFERRED_NAMES.get(rel, set())
            for name in _public_names(path):
                if name in deferred:
                    assert not hasattr(mod, name), f"{rel}:{name} unlist it"
                else:
                    assert hasattr(mod, name), f"repro_torch/{rel}: {name}"


# -- launch: meshes, sharding, cost model, dry run, roofline, report ---------------

# Public names of ``repro/launch/*.py`` that exist only because of XLA or
# of the JAX package's files, each with the port's counterpart.
LAUNCH_JAX_ONLY = {
    "costmodel.py": {
        # the jaxpr walker: the port counts an eager step's aten ops
        "jaxpr_cost": "costmodel.step_cost",
        # HLO parsing with while-loop trips: an eager step runs every trip,
        # and its collectives are ops that CommDebugMode counts
        "parse_collectives_trips": "CommDebugMode + costmodel.CostMode",
    },
    "dryrun.py": {
        "parse_collectives": "CommDebugMode + costmodel.CostMode",
    },
    "roofline.py": {
        # one ICI rate for every collective: the port takes a rate per link
        "ICI_BW": "roofline.LINK_BW",
    },
    "report.py": {
        # the repo root, where JAX's report rewrites EXPERIMENTS.md: the
        # port prints its tables or writes them to the path given
        "ROOT": "report.main(--out)",
    },
}


def test_launch_modules_are_ported_or_listed():
    import importlib
    src = ROOT / "src" / "repro" / "launch"
    paths = sorted(p for p in src.glob("*.py") if p.name != "__init__.py")
    assert [p.name for p in paths] == [
        "costmodel.py", "dryrun.py", "mesh.py", "report.py", "roofline.py",
        "serve.py", "sharding.py", "train.py"]
    for path in paths:
        port_path = ROOT / "src" / "repro_torch" / "launch" / path.name
        assert port_path.exists(), f"repro_torch/launch/{path.name}"
        mod = importlib.import_module(f"repro_torch.launch.{path.stem}")
        jax_only = LAUNCH_JAX_ONLY.get(path.name, {})
        for name in _public_names(path):
            if name in jax_only:
                assert not hasattr(mod, name), f"{path.name}:{name} unlist it"
                for ref in jax_only[name].split(" + "):
                    owner, _, attr = ref.partition(".")
                    if attr:        # the port's counterpart exists
                        cmod = importlib.import_module(
                            f"repro_torch.launch.{owner}")
                        assert hasattr(cmod, attr.split("(")[0]), ref
            else:
                assert hasattr(mod, name), f"repro_torch/launch/{path.name}: {name}"
    from torch.distributed.tensor.debug import CommDebugMode  # noqa: F401
