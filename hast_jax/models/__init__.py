"""End-to-end pipeline objects ("model families") of the framework.

- trio.TrioBinningPipeline: the HAST.sh-equivalent trio-binning run
  (markers -> classify -> 10X conversion -> Supernova -> re-phase).
"""

from hast_jax.models.trio import TrioBinningPipeline  # noqa: F401
