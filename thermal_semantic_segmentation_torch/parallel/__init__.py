"""Process groups and meshes: data parallel across ranks or local cards,
and the (data, spatial) grid.

The JAX names in ``LEFT_OUT`` have no counterpart, each for the reason
given.
"""

from .mesh import (image_sharding, init_distributed, label_sharding,
                   make_mesh, make_mesh_2d, replicate)

LEFT_OUT = {
    "DATA_AXIS": "TPU rewrite: a jax.sharding mesh axis name",
    "SPATIAL_AXIS": "TPU rewrite: a jax.sharding mesh axis name",
    "batch_sharding": "TPU rewrite: a jax.sharding NamedSharding",
    "replicated": "TPU rewrite: a jax.sharding NamedSharding",
    "put_sharded": "TPU rewrite: device_put of a global batch across "
                   "processes",
    "shard_batch": "TPU rewrite: device_put of a batch onto the mesh",
    "spans_processes": "not needed in torch: a jax.sharding helper",
}

__all__ = ["image_sharding", "init_distributed", "label_sharding",
           "make_mesh", "make_mesh_2d", "replicate"]
