"""Sharding over a device mesh (quake_tpu/parallel): `mesh` places the store,
`sharded` searches it and runs data-parallel k-means."""

from quake_tpu_torch.parallel.mesh import SHARD_AXIS, make_mesh, shard_store_state
from quake_tpu_torch.parallel.sharded import (sharded_flat_search, sharded_ivf_search,
                                              sharded_kmeans_step)

__all__ = [
    "make_mesh",
    "shard_store_state",
    "SHARD_AXIS",
    "sharded_flat_search",
    "sharded_ivf_search",
    "sharded_kmeans_step",
]
