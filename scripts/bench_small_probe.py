#!/usr/bin/env python
"""Measure the 2-gather probe pattern vs table row count.

Decides the quotient-table design: if 2x 16B-row gathers on a 2^19-row
(8MB) table are ~2x faster than on the 2^21-row (32MB) production
table, shrinking slots to 4B (quotient encoding) is the win.
Speed depends only on the access pattern, so garbage content is fine.
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from hast_jax.ops import hashtable as H

ITERS = 6
REPS = 3


def main():
    rng = np.random.default_rng(0)
    Q = 6 * 1024 * 1024
    q_hi = jnp.asarray(rng.integers(0, 1 << 30, Q).astype(np.uint32))
    q_lo = jnp.asarray(rng.integers(0, 1 << 32, Q).astype(np.uint32))

    for rows_log2 in (18, 19, 20, 21):
        data = jnp.asarray(rng.integers(
            0, 2**32, (1 << rows_log2, 4), dtype=np.uint32))

        @jax.jit
        def probe2(data, q_hi, q_lo):
            res = H.probe(data, q_hi, q_lo, 2)
            return jnp.sum(res, dtype=jnp.int32)

        out = probe2(data, q_hi, q_lo)
        _ = int(np.asarray(out))
        best = 1e9
        for _ in range(REPS):
            t0 = time.perf_counter()
            for _ in range(ITERS):
                out = probe2(data, q_hi, q_lo)
            _ = int(np.asarray(out))
            best = min(best, (time.perf_counter() - t0) / ITERS)
        mb = (1 << rows_log2) * 16 / 2**20
        print(f"2x16B probe rows=2^{rows_log2} ({mb:5.0f} MB): "
              f"{Q/best/1e6:7.1f} Mprobe/s", flush=True)


if __name__ == "__main__":
    main()
