"""Multi-device sharding of the interpolation step (jax.sharding / shard_map)."""
