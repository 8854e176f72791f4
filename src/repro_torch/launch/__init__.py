"""Launch-side helpers of the port: the cost model, device meshes and the
placement of tile batches on them."""

from .costmodel import tile_batch_cost
from .mesh import dp_axes, make_test_mesh
from .sharding import tile_batch_sharding, tile_batch_spec

__all__ = ["dp_axes", "make_test_mesh", "tile_batch_cost",
           "tile_batch_sharding", "tile_batch_spec"]
