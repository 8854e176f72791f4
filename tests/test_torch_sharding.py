"""The port's model sharding against the JAX package's: placements of every
parameter, input and decode cache (``repro_torch.launch.sharding`` against
``repro/launch/sharding.py``), the activation hook
(``models/pshard.make_mesh_hook``), which block each rank holds, and a
sharded train step and decode tick on four gloo CPU ranks against the
unsharded port.

The JAX side runs on ``jax.sharding.AbstractMesh`` (no devices); the port's
on a ``fake`` process group of the mesh's size in this process
(``launch.dryrun.fake_world``), destroyed at the end of each test. The
sharded execution starts four ranks of ``tests/torch_model_ranks.py`` on a
(2, 2) ``("data", "model")`` mesh (a ``file://`` rendezvous in the test's
temporary directory) on the JAX package's weights; meanwhile this process
runs the same step unsharded.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jget_config
from repro.launch.sharding import _path_str
from repro.launch.sharding import caches_shardings as jcaches_shardings
from repro.launch.sharding import inputs_shardings as jinputs_shardings
from repro.launch.sharding import param_spec as jparam_spec
from repro.models import abstract_params as jabstract_params
from repro.models import init_model as jinit_model
from repro.models import input_specs as jinput_specs
from repro.models.pshard import make_mesh_hook as jmake_mesh_hook
from repro_torch.configs import ARCHS, get_config, supported_shapes
from repro_torch.convert import model_from_numpy
from repro_torch.launch.dryrun import fake_world, train_step_fn
from repro_torch.launch.mesh import dp_axes, make_test_mesh
from repro_torch.launch.sharding import (_at, caches_shardings,
                                         inputs_shardings, params_shardings,
                                         placements, spec_axes)
from repro_torch.models import (abstract_params, build_serve_step,
                                init_decode_caches, input_specs, pshard)
from repro_torch.optim.adamw import adamw_init
from repro_torch.tree import flatten_with_path, leaves, path_str, tree_map

ROOT = Path(__file__).resolve().parents[1]
RANK_SCRIPT = ROOT / "tests" / "torch_model_ranks.py"
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
RANK_TIMEOUT = 300
# The sharded step against the unsharded one on the same weights: loss and
# updated parameters within 1e-5 of the largest parameter (the tolerance
# of tests/test_torch_training.py::test_trainer_step_matches_jax: AdamW's
# first step is lr g / (|g| + eps), which turns a rounding-level
# difference of a small gradient into up to ~1e-3 of lr), AdamW's moments
# within 1e-5 of their largest, logits within 1e-5 of their largest.
TOL = 1e-5


def jax_axes(spec, ndim: int) -> tuple:
    """A JAX PartitionSpec as the port's per-dim tuples of axis names."""
    out = []
    for entry in tuple(spec) + (None,) * (ndim - len(spec)):
        out.append(() if entry is None else
                   (entry,) if isinstance(entry, str) else tuple(entry))
    return tuple(out)


@pytest.fixture(scope="module")
def trees():
    """Per arch at its published width: the JAX package's abstract
    parameters and input specs of every supported shape (decode also with
    an int8 KV cache), and the port's on the meta device."""
    out = {}
    for arch in ARCHS:
        jcfg, cfg = jget_config(arch), get_config(arch)
        ins = {}
        for shape in supported_shapes(cfg):
            ins[shape] = (jinput_specs(jcfg, shape), input_specs(cfg, shape))
        ins["decode_32k_int8"] = (
            jinput_specs(dataclasses.replace(jcfg, kv_cache_dtype="int8"),
                         "decode_32k"),
            input_specs(dataclasses.replace(cfg, kv_cache_dtype="int8"),
                        "decode_32k"))
        out[arch] = {"params": (jabstract_params(jcfg),
                                abstract_params(cfg)),
                     "inputs": ins}
    return out


def _jax_leaves(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {_path_str(p): x for p, x in flat}


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_placements_match_jax(trees, mesh_name):
    """Every parameter leaf (fsdp on and off), every input leaf of every
    supported shape, and the decode caches (by ``inputs_shardings`` and
    by ``caches_shardings``, int8 too) of every arch at its published
    width: the port's axes equal JAX's PartitionSpec exactly."""
    shape, axes = MESHES[mesh_name]
    amesh = AbstractMesh(shape, axes)
    n_checked = 0
    with fake_world(int(np.prod(shape))):
        mesh = make_test_mesh(shape, axes, device_type="cpu")
        for arch, t in trees.items():
            jparams, params = t["params"]
            jflat = _jax_leaves(jparams)
            flat = {path_str(p, "/"): x for p, x in flatten_with_path(params)}
            assert jflat.keys() == flat.keys(), arch
            for fsdp in (True, False):
                placed = params_shardings(params, mesh, fsdp=fsdp)
                for p, x in flatten_with_path(params):
                    ps = path_str(p, "/")
                    want = jax_axes(jparam_spec(ps, tuple(x.shape), amesh,
                                                fsdp), x.dim())
                    got = spec_axes(_at(placed, p), x.dim(), mesh)
                    assert got == want, (arch, ps, fsdp, got, want)
                    assert tuple(jflat[ps].shape) == tuple(x.shape)
                    n_checked += 1
            for shape_name, (jspecs, specs) in t["inputs"].items():
                is_sds = lambda x: isinstance(x, jax.ShapeDtypeStruct)  # noqa: E731
                jsh = _jax_leaves(jinputs_shardings(jspecs, amesh),
                                  is_leaf=lambda x: hasattr(x, "spec"))
                placed = inputs_shardings(specs, mesh)
                flat = flatten_with_path(specs)
                assert {path_str(p, "/") for p, _ in flat} == \
                    set(_jax_leaves(jspecs, is_leaf=is_sds)), \
                    (arch, shape_name)
                for p, x in flat:
                    ps = path_str(p, "/")
                    got = spec_axes(_at(placed, p), x.dim(), mesh)
                    assert got == jax_axes(jsh[ps].spec, x.dim()), \
                        (arch, shape_name, ps)
                    n_checked += 1
                if "caches" in specs:
                    jc = _jax_leaves(jcaches_shardings(jspecs["caches"],
                                                       amesh),
                                     is_leaf=lambda x: hasattr(x, "spec"))
                    placed = caches_shardings(specs["caches"], mesh)
                    for p, x in flatten_with_path(specs["caches"]):
                        got = spec_axes(_at(placed, p), x.dim(), mesh)
                        assert got == jax_axes(jc[path_str(p, "/")].spec,
                                               x.dim())
                        n_checked += 1
    assert n_checked > 800


BLOCK_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
cases = json.loads(sys.argv[1])
out = []
for mesh_shape, axes, shape, spec in cases:
    mesh = jax.make_mesh(tuple(mesh_shape), tuple(axes))
    spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    m = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
    out.append({d.id: [[s.start or 0, s.stop if s.stop is not None else n]
                       for s, n in zip(idx, shape)]
                for d, idx in m.items()})
print(json.dumps(out))
"""


def test_each_rank_holds_jax_device_block():
    """Rank r's block of a tensor placed by the port is the block JAX's
    device r holds under the same spec (on 8 forced host devices): a dim
    over ("pod", "data") splits pod-major, as DTensor's Shard on both
    mesh dims does."""
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset

    cases = [
        ((2, 4), ("data", "model"), (8, 16, 12), [None, "data", "model"]),
        ((2, 4), ("data", "model"), (8, 12), ["model", "data"]),
        ((2, 2, 2), ("pod", "data", "model"), (8, 6, 4),
         [["pod", "data"], None, "model"]),
        ((2, 2, 2), ("pod", "data", "model"), (4, 8, 2, 4, 6),
         [None, ["pod", "data"], None, "model", None]),
        ((2, 2, 2), ("pod", "data", "model"), (6, 8),
         [None, ["pod", "data", "model"]]),
    ]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-c", BLOCK_SCRIPT,
                          json.dumps(cases)], capture_output=True, text=True,
                         env=env, timeout=120)
    assert run.returncode == 0, run.stderr[-3000:]
    jax_blocks = json.loads(run.stdout.strip().splitlines()[-1])

    class Names:          # placements() reads only the axis names
        def __init__(self, names):
            self.mesh_dim_names = names

    for (mshape, axes, shape, spec), want in zip(cases, jax_blocks):
        places = placements(spec, Names(axes))
        for r in range(int(np.prod(mshape))):
            coord = [int(c) for c in np.unravel_index(r, mshape)]
            lshape, off = _compute_local_shape_and_global_offset(
                shape, mshape, coord, places)
            got = [[o, o + n] for o, n in zip(off, lshape)]
            assert got == want[str(r)], (mshape, spec, r, got, want[str(r)])


HOOK_CASES = [
    ((8, 64, 32), ("dp", "model", None)),
    ((8, 64, 4, 16), ("dp", None, "model", None)),
    ((8, 64, 2, 16), ("dp", None, "model", None)),     # 2 heads: not on 4
    ((8, 64, 256), ("dp", None, "model")),
    ((1, 64, 32), ("dp", "model", None)),              # batch 1
    ((4, 8, 5, 16, 32), ("dp", "model", None, None, None)),
    ((6, 4), ("dp", None)),
    ((8, 64), ("dp", None, "model")),                  # ndim mismatch
]


@pytest.mark.parametrize("mesh_name", ["2x4", "2x2x2", "16x16"])
def test_hook_matches_jax(mesh_name):
    """The hook's placements equal JAX's ``make_mesh_hook`` constraint (read
    from the traced program's ``sharding_constraint``) for every case; a
    DTensor comes back at those placements, a plain tensor and an ndim
    mismatch as they were."""
    from torch.distributed.tensor import DTensor, Replicate

    shape, axes = MESHES[mesh_name]
    amesh = AbstractMesh(shape, axes)
    jhook = jmake_mesh_hook(amesh, tuple(a for a in axes
                                         if a in ("pod", "data")))
    with fake_world(int(np.prod(shape))):
        mesh = make_test_mesh(shape, axes, device_type="cpu")
        hook = pshard.make_mesh_hook(mesh, dp_axes(mesh))
        for xshape, names in HOOK_CASES:
            x = torch.zeros(xshape)
            assert hook(x, names) is x
            d = DTensor.from_local(x, mesh, [Replicate()] * len(shape),
                                   run_check=False)
            got_t = hook(d, names)
            jaxpr = jax.make_jaxpr(lambda a: jhook(a, names))(
                jax.ShapeDtypeStruct(xshape, np.float32))
            cons = [e for e in jaxpr.jaxpr.eqns
                    if e.primitive.name == "sharding_constraint"]
            if len(xshape) != len(names):
                assert got_t is d and not cons
                continue
            want = jax_axes(cons[0].params["sharding"].spec, len(xshape))
            got = spec_axes(placements(hook.spec_of(xshape, names), mesh),
                            len(xshape), mesh)
            assert got == want, (xshape, names, got, want)
            assert spec_axes(got_t.placements, len(xshape), mesh) == want


# -- sharded execution on four gloo ranks ----------------------------------------

ARCHES_RUN = ("qwen1_5_0_5b", "granite_moe_3b_a800m")
B, S, MAX_LEN, CACHE_LEN = 4, 32, 16, 5


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    out = {}
    for arch in ARCHES_RUN:
        jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
        jp = jinit_model(jax.random.PRNGKey(0), jcfg)
        V = cfg.vocab_size
        out[arch] = {
            "params": jax.tree.map(np.asarray, jp),
            "batch": {"tokens": rng.integers(0, V, (B, S), dtype=np.int32),
                      "labels": rng.integers(0, V, (B, S), dtype=np.int32)},
            "caches": tree_map(lambda x: (rng.standard_normal(tuple(x.shape))
                                          * 0.5).astype(np.float32),
                               init_decode_caches(cfg, B, MAX_LEN,
                                                  device="meta")),
            "token": rng.integers(0, V, (B, 1), dtype=np.int32),
            "cache_len": CACHE_LEN}
    return out


@pytest.fixture(scope="module")
def sharded_run(tmp_path_factory):
    """The four ranks' results, and the unsharded port's on the same
    inputs (computed while the ranks run)."""
    tmp = tmp_path_factory.mktemp("model_mesh")
    inputs = _inputs()
    with open(tmp / "in.pkl", "wb") as fh:
        pickle.dump(inputs, fh)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for r in range(4):
            with open(tmp / f"rank{r}.log", "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(RANK_SCRIPT), str(r), "4",
                     str(tmp / "store"), str(tmp / "in.pkl"),
                     str(tmp / f"rank{r}.pkl")],
                    env=env, stdout=log, stderr=subprocess.STDOUT))
        ref = {}
        for arch, inp in inputs.items():
            cfg = get_config(arch, smoke=True)
            params = model_from_numpy(inp["params"], "cpu")
            fn, ocfg = train_step_fn(cfg)
            loss, new, state = fn(params, adamw_init(params, ocfg),
                                  {k: torch.as_tensor(v)
                                   for k, v in inp["batch"].items()})
            logits, _ = build_serve_step(cfg)(
                params, tree_map(torch.as_tensor, inp["caches"]),
                torch.as_tensor(inp["token"]), CACHE_LEN)
            ref[arch] = {"loss": float(loss), "params": new,
                         "m": state.m, "v": state.v, "logits": logits,
                         "tree": params}
        deadline = time.monotonic() + RANK_TIMEOUT
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if None not in codes or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.1)
    finally:
        torch.set_num_threads(threads)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, \
            f"rank {r} failed:\n{(tmp / f'rank{r}.log').read_text()[-6000:]}"
    ranks = [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
             for r in range(4)]
    return {"ranks": ranks, "ref": ref}


def _max_err(got, want) -> tuple[float, float]:
    err = max(float(np.abs(a - b.numpy()).max())
              for a, b in zip(leaves(got), leaves(want)))
    return err, max(float(b.abs().max()) for b in leaves(want))


@pytest.mark.parametrize("arch", ARCHES_RUN)
def test_sharded_train_step_matches_unsharded(sharded_run, arch):
    """One AdamW step with the parameters placed by ``params_shardings`` and
    the hook installed, on every rank, against the unsharded port on the
    JAX package's weights: loss, parameters and moments at TOL."""
    ref = sharded_run["ref"][arch]
    for res in sharded_run["ranks"]:
        got = res[arch]
        assert abs(got["loss"] - ref["loss"]) <= TOL * abs(ref["loss"])
        for key in ("params", "m", "v"):
            err, scale = _max_err(got[key], ref[key])
            assert err <= TOL * scale, (key, err, scale)


@pytest.mark.parametrize("arch", ARCHES_RUN)
def test_sharded_decode_tick_matches_unsharded(sharded_run, arch):
    ref = sharded_run["ref"][arch]["logits"].numpy()
    for res in sharded_run["ranks"]:
        got = res[arch]["logits"]
        assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


@pytest.mark.parametrize("arch", ARCHES_RUN)
def test_each_rank_holds_its_share_of_the_parameters(sharded_run, arch):
    """Each rank's parameter bytes are the sum of the local blocks JAX's
    specs imply on the (2, 2) mesh (a dim split over axes of total size n
    holds 1/n of it)."""
    amesh = AbstractMesh((2, 2), ("data", "model"))
    want = 0
    for p, x in flatten_with_path(sharded_run["ref"][arch]["tree"]):
        spec = jax_axes(jparam_spec(path_str(p, "/"), tuple(x.shape),
                                    amesh), x.dim())
        n = x.numel() // int(np.prod([2 ** len(a) for a in spec]))
        want += n * x.element_size()
    for res in sharded_run["ranks"]:
        assert res[arch]["param_bytes"] == want
