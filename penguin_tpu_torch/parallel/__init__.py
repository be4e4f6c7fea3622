from .sharding import make_grid_mesh, grid_sharding, shard_pytree

__all__ = ["make_grid_mesh", "grid_sharding", "shard_pytree"]
