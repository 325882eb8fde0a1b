#!/usr/bin/env python
"""Measure cold-compile time of the stage-01 device functions.

Breaks the cold start of a classify run down per jitted function and
per shape, so that bounding the shape set can be verified.  Run with an
EMPTY compilation cache:

    rm -rf .hast_work/empty_cache
    JAX_COMPILATION_CACHE_DIR=.hast_work/empty_cache \
        python scripts/bench_compile.py
"""

import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_log_compiles", True)
    from hast_jax.ops import hashtable as H
    from hast_jax.pipeline import classify as C

    rng = np.random.default_rng(0)
    n = 2_000_000
    hi = rng.integers(0, 1 << 30, n, dtype=np.uint32)
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    pay = rng.integers(1, 3, n, dtype=np.uint32)
    t0 = time.perf_counter()
    table = H.build_table(hi, lo, pay, 21, load=0.7, set_sizes=(n // 2, n // 2))
    log(f"table build (host): {time.perf_counter()-t0:.2f}s "
        f"({table.n_buckets} buckets)")
    data = jnp.asarray(table.data)

    S, B, Lp = 2, 1 << 15, 28  # bench shapes: 100bp reads -> 112/4
    packed = jnp.asarray(rng.integers(0, 256, (S, B, Lp), dtype=np.uint8))
    lengths = jnp.full((S, B), 100, jnp.int32)
    ids = jnp.asarray(rng.integers(0, 1 << 20, (S, B), dtype=np.int32))
    has_n = jnp.zeros((S, B), jnp.uint8)
    acc = jnp.zeros((1 << 20, 3), jnp.int32)

    t0 = time.perf_counter()
    acc = C.tally_step(data, acc, packed, lengths, ids, has_n, 21, 2)
    jax.block_until_ready(acc)
    log(f"tally_step first call (compile+run): {time.perf_counter()-t0:.2f}s")

    t0 = time.perf_counter()
    acc = C.tally_step(data, acc, packed, lengths, ids, has_n, 21, 2)
    jax.block_until_ready(acc)
    log(f"tally_step warm: {time.perf_counter()-t0:.3f}s")

    t0 = time.perf_counter()
    out = C._fetch_acc(acc)
    log(f"_pack_acc+fetch first: {time.perf_counter()-t0:.2f}s "
        f"(sum={out.sum()})")

    t0 = time.perf_counter()
    acc2 = C._grow_acc(acc, jnp.zeros((1 << 20, 3), jnp.int32))
    jax.block_until_ready(acc2)
    log(f"_grow_acc first: {time.perf_counter()-t0:.2f}s")


if __name__ == "__main__":
    main()
