#!/usr/bin/env python
"""A/B the probe-table formats on the GPU: same 1M-read classify,
quot (4B slots) vs full (8B slots), N warm runs each, phase timers.
Uses bench.py's inputs (run bench.py first)."""

import os
import pathlib
import sys
import time

CACHE = pathlib.Path(__file__).resolve().parents[1] / ".hast_work" / "bench"
RUNS = int(os.environ.get("AB_RUNS", "4"))


def main():
    sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
    from hast_jax.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import numpy as np
    from hast_jax.ops import encode as E
    from hast_jax.ops import hashtable as H
    from hast_jax.pipeline import classify as C

    hap0, hap1 = str(CACHE / "hap0.mer"), str(CACHE / "hap1.mer")
    reads = str(CACHE / "reads.fq")
    h0_hi, h0_lo, k = E.load_mer_file(hap0)
    h1_hi, h1_lo, _ = E.load_mer_file(hap1, k_expect=k)
    hi = np.concatenate([h0_hi, h1_hi])
    lo = np.concatenate([h0_lo, h1_lo])
    pay = np.concatenate([np.ones(h0_hi.size, np.uint32),
                          np.full(h1_hi.size, 2, np.uint32)])

    for fmt in ("quot", "full"):
        t0 = time.perf_counter()
        table = H.build_table(hi, lo, pay, k, load=0.7,
                              set_sizes=(h0_hi.size, h1_hi.size), fmt=fmt)
        print(f"{fmt}: build {time.perf_counter()-t0:.1f}s  "
              f"{table.n_buckets} buckets  "
              f"{table.data.nbytes/2**20:.0f} MB", file=sys.stderr)
        C.erase_adaptors(table)
        table.device_put()
        times = []
        for r in range(RUNS):
            t0 = time.perf_counter()
            tally = C.classify_fastqs(table, [reads])
            names, counts = tally.finalize()
            dt = time.perf_counter() - t0
            times.append(dt)
            print(f"  run {r}: {dt:.2f}s  ({1e6/dt:,.0f} reads/s)  "
                  f"checksum={int(counts.sum())}", flush=True)
        print(f"{fmt}: best {min(times):.2f}s -> "
              f"{1e6/min(times):,.0f} reads/s", flush=True)


if __name__ == "__main__":
    main()
