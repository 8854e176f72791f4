"""Launch-side helpers of the port: device meshes, the sharding rules of
tile batches and of models, the cost model, the dry run, the roofline and
its report, and the train / serve launchers (``python -m
repro_torch.launch.<module>``)."""

from .costmodel import tile_batch_cost
from .mesh import dp_axes, make_production_mesh, make_test_mesh, model_axis
from .sharding import (batch_spec, cache_spec, caches_shardings,
                       distribute_tree, inputs_shardings, param_spec,
                       params_shardings, tile_batch_sharding,
                       tile_batch_spec)

__all__ = ["batch_spec", "cache_spec", "caches_shardings", "distribute_tree",
           "dp_axes", "inputs_shardings", "make_production_mesh",
           "make_test_mesh", "model_axis", "param_spec", "params_shardings",
           "tile_batch_cost", "tile_batch_sharding", "tile_batch_spec"]
