#!/usr/bin/env python
"""Measure host-side probe-table build at human marker scale.

At ~2-4e8 markers the 2-choice placement + cuckoo walk
(ops/hashtable.build_table) and the .probetable.npz snapshot are a
one-time but potentially minutes-long serial host cost; the reference's
analogous cost is the unordered_set load
(01.classify_stlfr_reads/classify.cpp:30-46).  This script times the
build, the snapshot save and its load.

Usage: python scripts/measure_table_build.py [n_keys]
  n_keys default 2e8.
"""

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    n = int(float(sys.argv[1])) if len(sys.argv) > 1 else 200_000_000
    k = 21
    from hast_jax.ops import hashtable as H

    rng = np.random.default_rng(0)
    # uniform random 2k-bit canonical-looking keys are the right model:
    # build cost depends only on key count and hash mixing, not on
    # biological structure
    print(f"generating {n:,} random keys ...", flush=True)
    hi = rng.integers(0, 1 << (2 * k - 32), n, dtype=np.uint64) \
        .astype(np.uint32)
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    pay = rng.integers(1, 3, n).astype(np.uint32)

    t0 = time.perf_counter()
    table = H.build_table(hi, lo, pay, k)
    build_s = time.perf_counter() - t0
    print(f"build_table: {build_s:.1f}s for {table.n_keys:,} distinct "
          f"keys -> fmt={table.fmt} n_buckets={table.n_buckets:,} "
          f"table={table.data.nbytes / 1e9:.2f} GB "
          f"({table.n_keys / build_s / 1e6:.1f} Mkeys/s)", flush=True)

    with tempfile.TemporaryDirectory() as td:
        snap = os.path.join(td, "t.npz")
        t0 = time.perf_counter()
        np.savez(snap, data=table.data, n_buckets=table.n_buckets,
                 max_probe=table.max_probe, k=table.k,
                 n_keys=table.n_keys,
                 set_sizes=np.asarray(table.set_sizes))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        z = np.load(snap, allow_pickle=False)
        _ = z["data"][:]
        load_s = time.perf_counter() - t0
        print(f"snapshot save: {save_s:.1f}s  load: {load_s:.1f}s",
              flush=True)

    print(f"SUMMARY n={n:,} build={build_s:.1f}s save={save_s:.1f}s "
          f"load={load_s:.1f}s")


if __name__ == "__main__":
    main()
