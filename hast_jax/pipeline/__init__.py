"""Pipeline stages 00-03 (markers, classify, 10X conversion, re-phase)."""

from hast_jax.pipeline import (classify, markers, partition,  # noqa: F401
                               rephase, tenx)
