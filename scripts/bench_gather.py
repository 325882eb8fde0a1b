#!/usr/bin/env python
"""Microbenchmark: random-gather ceilings on the device.

The stage-01 probe is gather-bound (ops/hashtable.py does 2 row-gathers
per k-mer window).  This script measures the actual ceilings that bound
any probe design:

  1. XLA gather rate vs table size (cache-resident vs HBM-resident)
     and row width (8/16/32/64 B).
  2. Gather rate with sorted vs random indices.
  3. A fori_loop-chained variant to check dispatch overhead.

Timing rule: each measured iteration is
data-dependent on the previous one (the gathered sum feeds the next
call's indices), and the clock stops on a host fetch of the final
scalar — nothing can be hidden by async dispatch.

Results feed PERF.md.  Run on the GPU: python scripts/bench_gather.py
"""

import functools
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

ITERS = 8


def timed_chain(step, *args):
    """step(carry, *args) -> carry; returns seconds/iter, forced."""
    carry = jnp.uint32(0)
    out = step(carry, *args)          # compile + 1 run
    _ = int(np.asarray(out))
    t0 = time.perf_counter()
    carry = jnp.uint32(1)
    for _ in range(ITERS):
        carry = step(carry, *args)
    _ = int(np.asarray(carry))        # fetch = hard barrier
    return (time.perf_counter() - t0) / ITERS


def main():
    dev = jax.devices()[0]
    print(f"device: {dev}", file=sys.stderr)
    rng = np.random.default_rng(0)
    Q = 1 << 22  # 4M queries per dispatch

    print("== gather rate vs (table_rows, row_u32s) ==", flush=True)
    for n_rows_log2 in (14, 17, 20, 23, 25):
        n_rows = 1 << n_rows_log2
        for row_u32 in (2, 4, 8, 16):
            table = jnp.asarray(
                rng.integers(0, 2**32, (n_rows, row_u32), dtype=np.uint32))
            idx = jnp.asarray(rng.integers(0, n_rows, Q, dtype=np.int32))

            @jax.jit
            def g(carry, table, idx):
                # perturb indices with the carry so no two iterations
                # are identical, then gather and fold to a scalar
                ix = (idx + carry.astype(jnp.int32)) & (table.shape[0] - 1)
                rows = jnp.take(table, ix, axis=0)
                return jnp.sum(rows, dtype=jnp.uint32) | (carry & 1)

            dt = timed_chain(g, table, idx)
            mb = n_rows * row_u32 * 4 / (1 << 20)
            print(f"rows=2^{n_rows_log2} ({mb:8.1f} MB) row={4*row_u32:3d}B: "
                  f"{Q/dt/1e6:8.1f} Mgather/s  "
                  f"{Q*row_u32*4/dt/2**30:7.2f} GiB/s", flush=True)

    print("== sorted vs random indices (16B rows, 64MB table) ==", flush=True)
    n_rows = 1 << 22
    table = jnp.asarray(
        rng.integers(0, 2**32, (n_rows, 4), dtype=np.uint32))
    idx_np = rng.integers(0, n_rows, Q, dtype=np.int32)
    for name, ix, hint in (("random", idx_np, False),
                           ("sorted", np.sort(idx_np), True)):
        idx = jnp.asarray(ix)

        @functools.partial(jax.jit, static_argnames=("hint",))
        def g(carry, table, idx, hint=hint):
            ix = idx | (carry.astype(jnp.int32) & 0)
            rows = jnp.take(table, ix, axis=0, indices_are_sorted=hint)
            return jnp.sum(rows, dtype=jnp.uint32) | (carry & 1)

        dt = timed_chain(g, table, idx)
        print(f"{name:12s}: {Q/dt/1e6:8.1f} Mgather/s", flush=True)

    print("== two dependent 16B gathers (the production probe shape) ==",
          flush=True)

    @jax.jit
    def g2(carry, table, idx):
        ix = (idx + carry.astype(jnp.int32)) & (table.shape[0] - 1)
        rows1 = jnp.take(table, ix, axis=0)
        ix2 = (ix ^ 0x5BD1) & (table.shape[0] - 1)
        rows2 = jnp.take(table, ix2, axis=0)
        return (jnp.sum(rows1, dtype=jnp.uint32)
                + jnp.sum(rows2, dtype=jnp.uint32)) | (carry & 1)

    dt = timed_chain(g2, table, jnp.asarray(idx_np))
    print(f"2x16B gathers: {Q/dt/1e6:8.1f} Mquery/s "
          f"({2*Q/dt/1e6:.1f} Mgather/s)", flush=True)

    print("== 32B-row single gather (paired-bucket design) ==", flush=True)
    table32 = jnp.asarray(
        rng.integers(0, 2**32, (n_rows // 2, 8), dtype=np.uint32))

    @jax.jit
    def g3(carry, table, idx):
        ix = (idx + carry.astype(jnp.int32)) & (table.shape[0] - 1)
        rows = jnp.take(table, ix, axis=0)
        return jnp.sum(rows, dtype=jnp.uint32) | (carry & 1)

    dt = timed_chain(g3, table32, jnp.asarray(idx_np & (n_rows // 2 - 1)))
    print(f"1x32B gather: {Q/dt/1e6:8.1f} Mquery/s", flush=True)


if __name__ == "__main__":
    main()
