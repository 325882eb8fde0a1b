#!/usr/bin/env python
"""Profile the stage-01 classify phase components on the live device.

Separates: native reader throughput, host->device transfer, device vote
kernel, and the overlapped end-to-end run — so perf work targets the
actual bottleneck.  Uses bench.py's inputs (run bench.py first).  Progress prints are
unbuffered (stderr).
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".hast_work", "bench")
READS = os.path.join(CACHE, "reads.fq")
HAP0 = os.path.join(CACHE, "hap0.mer")
HAP1 = os.path.join(CACHE, "hap1.mer")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp
    from hast_jax.io import native as N
    from hast_jax.pipeline import classify as C

    from hast_jax.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    log(f"devices: {jax.devices()}")

    batch_size = 1 << 15
    S = 2

    # 1. reader only
    for trial in range(2):
        t0 = time.perf_counter()
        reader = N.NativeFastqReader(READS, batch_size, len_cap=1024,
                                     packed=True)
        nreads = 0
        for b in reader:
            nreads += b.n
        names = reader.barcodes_array()
        reader.close()
        dt = time.perf_counter() - t0
        log(f"reader only [{trial}]: {dt:.3f}s  {nreads/dt/1e6:.2f} "
            f"M reads/s  ({nreads} reads, {names.size} barcodes)")

    # 2. table load + upload
    t0 = time.perf_counter()
    table = C.load_marker_table(HAP0, HAP1)
    C.erase_adaptors(table)
    t1 = time.perf_counter()
    C._device_table(table, C.ADAPTOR_F, C.ADAPTOR_R)
    jax.block_until_ready(table.data)
    t2 = time.perf_counter()
    log(f"table: load {t1-t0:.3f}s  upload {t2-t1:.3f}s  "
        f"({table.n_buckets} buckets, {table.data.nbytes/1e6:.0f} MB)")
    data = table.data
    k, mp = table.k, table.max_probe

    # 3. device-side measurements on a subset of super-batches
    NSUB = 8
    reader = N.NativeFastqReader(READS, batch_size, len_cap=1024,
                                 packed=True)
    batches = []
    buf = []
    for b in reader:
        buf.append((b.seqs.copy(), b.lengths.copy()))
        if len(buf) == S:
            Lp = max(x[0].shape[1] for x in buf)
            seqs = np.zeros((S, batch_size, Lp), np.uint8)
            lengths = np.zeros((S, batch_size), np.int32)
            for s, (sq, ln) in enumerate(buf):
                seqs[s, :, :sq.shape[1]] = sq
                lengths[s] = ln
            batches.append((seqs, lengths))
            buf = []
        if len(batches) >= NSUB:
            break
    reader.close()
    nsub_reads = len(batches) * S * batch_size
    v = C.vote_kernel_packed(data, jnp.asarray(batches[0][0]),
                             jnp.asarray(batches[0][1]), k, mp)
    jax.block_until_ready(v)
    log("compile warm done")

    t0 = time.perf_counter()
    devbatches = [(jax.device_put(s), jax.device_put(l))
                  for s, l in batches]
    jax.block_until_ready(devbatches)
    dt = time.perf_counter() - t0
    nbytes = sum(s.nbytes + l.nbytes for s, l in batches)
    log(f"h2d transfer: {dt:.3f}s  {nbytes/dt/1e6:.0f} MB/s "
        f"({nbytes/1e6:.0f} MB, {nsub_reads} reads -> "
        f"{nsub_reads/dt/1e6:.2f} M reads/s if serial)")

    for trial in range(2):
        t0 = time.perf_counter()
        outs = [C.vote_kernel_packed(data, s, l, k, mp)
                for s, l in devbatches]
        jax.block_until_ready(outs)
        dt = time.perf_counter() - t0
        log(f"device kernel (resident) [{trial}]: {dt:.3f}s  "
            f"{nsub_reads/dt/1e6:.2f} M reads/s")

    t0 = time.perf_counter()
    outs = [C.vote_kernel_packed(data, jnp.asarray(s), jnp.asarray(l),
                                 k, mp) for s, l in batches]
    jax.block_until_ready(outs)
    dt = time.perf_counter() - t0
    log(f"device kernel+h2d: {dt:.3f}s  {nsub_reads/dt/1e6:.2f} M reads/s")

    t0 = time.perf_counter()
    outs = [C.vote_kernel_packed(data, jnp.asarray(s), jnp.asarray(l),
                                 k, mp) for s, l in batches]
    outs = [np.asarray(o) for o in outs]
    dt = time.perf_counter() - t0
    log(f"device kernel+h2d+d2h: {dt:.3f}s  "
        f"{nsub_reads/dt/1e6:.2f} M reads/s")

    # 4. full classify (overlapped)
    for trial in range(2):
        t0 = time.perf_counter()
        tally = C.classify_fastqs(table, [READS], batch_size)
        names, _ = tally.finalize()
        dt = time.perf_counter() - t0
        log(f"classify_fastqs [{trial}]: {dt:.3f}s  "
            f"({names.size} barcodes)")


if __name__ == "__main__":
    main()
