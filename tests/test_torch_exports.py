"""The port's export surface against the JAX package's: every public name of
``repro.core`` imports from ``repro_torch.core``, or is on one of two named
lists -- still to port (with its ROADMAP Queue 1 item) or JAX-only."""

import ast
from pathlib import Path

import repro_torch.core as port_core

ROOT = Path(__file__).resolve().parents[1]

# Names the port does not have yet, with the ROADMAP Queue 1 item that
# brings each.
TO_PORT = {
    "set_tile_mesh": 8, "tile_mesh": 8, "tile_dp_size": 8,
    "pad_tile_batch": 8, "shard_tile_batch": 8,
}
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
