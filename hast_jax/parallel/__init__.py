"""Device-mesh sharding, distributed counting, cross-shard merges."""

from hast_jax.parallel import merge, mesh  # noqa: F401
