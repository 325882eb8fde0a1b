#!/usr/bin/env python
"""Human-marker-scale classify bench.

The reference's real operating point is ~2e8 markers/parent loaded
into the probe sets (classify.cpp:27-46).  This script proves that
point on-chip: it generates 2e8 distinct canonical 21-mers per
haplotype (4e8 keys -> a 2^28-bucket quotient table, 4.29 GB), builds
the native quot table, classifies 1M planted stLFR reads end-to-end
(cold + N warm runs in ONE process — the 4.3 GB table upload is paid
once and reused via the module-level device-table slot) and measures
the raw gather ceiling at 2^28 rows.  The table is built on the host,
which takes minutes at this size.

Artifacts cache under .hast_work/human (~14 GB disk).

Usage:
  python scripts/bench_human_scale.py
  HAST_HUMAN_MARKERS=50000000 ... (scaling-curve points)
"""

import json
import os
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CACHE = pathlib.Path(__file__).resolve().parents[1] / ".hast_work" / "human"
N_MARKERS = int(float(os.environ.get("HAST_HUMAN_MARKERS", 200_000_000)))
N_READS = int(float(os.environ.get("HAST_HUMAN_READS", 1_000_000)))
N_WARM = int(os.environ.get("HAST_HUMAN_WARM", 3))
K = 21


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# --- numeric canonicalization (vectorized, no per-row python) ---------

_COMP_MASK = np.uint64(sum(0b10 << (2 * i) for i in range(K)))
_M2 = np.uint64(0x3333333333333333)
_M4 = np.uint64(0x0F0F0F0F0F0F0F0F)


def canonical_words(w: np.ndarray) -> np.ndarray:
    """min(fwd, revcomp) on packed 42-bit k-mer words (HAST encoding:
    base^2 complement, groups of 2 bits, base j at 2*(k-1-j))."""
    c = w ^ _COMP_MASK
    # reverse 2-bit groups within 64 bits, then shift down to 42
    c = ((c & _M2) << np.uint64(2)) | ((c >> np.uint64(2)) & _M2)
    c = ((c & _M4) << np.uint64(4)) | ((c >> np.uint64(4)) & _M4)
    c = c.byteswap()
    rc = c >> np.uint64(64 - 2 * K)
    return np.minimum(w, rc)


def _self_test():
    from hast_jax.ops import encode as E
    rng = np.random.default_rng(7)
    w = rng.integers(0, 1 << (2 * K), 10000, dtype=np.uint64)
    got = canonical_words(w)
    codes = np.zeros((w.size, K), np.int32)
    for j in range(K):
        codes[:, j] = ((w >> np.uint64(2 * (K - 1 - j)))
                       & np.uint64(3)).astype(np.int32)
    hi, lo = E.canonical_kmers_np(codes, K)
    want = (hi[:, 0].astype(np.uint64) << np.uint64(32)) \
        | lo[:, 0].astype(np.uint64)
    assert np.array_equal(got, want), "canonical_words mismatch"


def ensure_markers():
    CACHE.mkdir(parents=True, exist_ok=True)
    h0, h1 = CACHE / "hap0.mer", CACHE / "hap1.mer"
    wpath = CACHE / "words.npy"
    stamp = CACHE / f"markers_{N_MARKERS}"
    if stamp.exists():
        return str(h0), str(h1), wpath
    _self_test()
    from hast_jax.ops import kmer_count as KC
    rng = np.random.default_rng(42)
    need = 2 * N_MARKERS
    log(f"generating {need:,} distinct canonical {K}-mers ...")
    t0 = time.perf_counter()
    cand = rng.integers(0, 1 << (2 * K), int(need * 1.3), dtype=np.uint64)
    words = np.unique(canonical_words(cand))
    del cand
    assert words.size >= need, (words.size, need)
    rng.shuffle(words)
    words = words[:need]
    log(f"  {words.size:,} words in {time.perf_counter() - t0:.0f}s")
    np.save(wpath, words)
    t0 = time.perf_counter()
    chunk = 1 << 24
    for path, lo_i in ((h0, 0), (h1, N_MARKERS)):
        with open(path, "wb", buffering=1 << 24) as f:
            for s in range(lo_i, lo_i + N_MARKERS, chunk):
                part = KC.words_to_strings(
                    words[s:min(s + chunk, lo_i + N_MARKERS)], K)
                f.write(b"\n".join(part.tolist()) + b"\n")
    log(f"  marker text written in {time.perf_counter() - t0:.0f}s "
        f"({2 * (K + 1) * N_MARKERS / 1e9:.1f} GB)")
    stamp.touch()
    return str(h0), str(h1), wpath


def ensure_reads(wpath):
    reads = CACHE / "reads.fq"
    stamp = CACHE / f"reads_{N_MARKERS}_{N_READS}"
    if stamp.exists():
        return str(reads)
    from hast_jax.ops import kmer_count as KC
    words = np.load(wpath, mmap_mode="r")
    rng = np.random.default_rng(123)
    L = 100
    B = np.frombuffer(b"ACGT", np.uint8)
    n = N_READS
    log(f"generating {n:,} reads ...")
    t0 = time.perf_counter()
    seq_arr = B[rng.integers(0, 4, (n, L))]
    which = rng.random(n)
    m0 = KC.words_to_strings(
        np.asarray(words[rng.integers(0, N_MARKERS, n)]), K)
    m1 = KC.words_to_strings(
        np.asarray(words[N_MARKERS + rng.integers(0, N_MARKERS, n)]), K)
    pos = rng.integers(0, L - K + 1, n)
    cols = pos[:, None] + np.arange(K)
    sel0 = np.flatnonzero(which < 0.15)
    sel1 = np.flatnonzero((which >= 0.15) & (which < 0.30))
    seln = np.flatnonzero((which >= 0.30) & (which < 0.32))
    seq_arr[sel0[:, None], cols[sel0]] = \
        m0[sel0].view(np.uint8).reshape(-1, K)
    seq_arr[sel1[:, None], cols[sel1]] = \
        m1[sel1].view(np.uint8).reshape(-1, K)
    seq_arr[seln, pos[seln]] = ord("N")
    bcs = rng.integers(1, 1500, (n, 3))
    qual = b"F" * L
    with open(reads, "wb", buffering=1 << 22) as f:
        chunk = 1 << 18
        for lo_i in range(0, n, chunk):
            hi_i = min(n, lo_i + chunk)
            parts = []
            rows = seq_arr[lo_i:hi_i]
            for off, i in enumerate(range(lo_i, hi_i)):
                parts.append(b"@V100%08d#%d_%d_%d/1\n" % (
                    i, bcs[i, 0], bcs[i, 1], bcs[i, 2]))
                parts.append(rows[off].tobytes())
                parts.append(b"\n+\n" + qual + b"\n")
            f.write(b"".join(parts))
    log(f"  reads written in {time.perf_counter() - t0:.0f}s")
    stamp.touch()
    return str(reads)


def run_ours(h0, h1, reads, out_name, phases):
    from hast_jax.pipeline import classify as C
    from hast_jax.utils.profiling import PhaseTimer
    timer = PhaseTimer()
    t0 = time.perf_counter()
    with open(CACHE / out_name, "wb") as out:
        C.run_classify(h0, h1, [reads], out, w0=1.04, timer=timer)
    dt = time.perf_counter() - t0
    phases.append({k: round(v, 3) for k, v in timer.phases.items()})
    return dt


def gather_bench():
    """Raw row-gather rate on the resident 2^28-row quot table; uses
    the already-uploaded classify table."""
    import jax
    import jax.numpy as jnp
    from hast_jax.pipeline import classify as C
    data = C._DEVICE_TABLE.get("data")
    if data is None:
        return None
    n_rows = data.shape[0]
    rng = np.random.default_rng(0)
    Q = 1 << 22
    idx = jnp.asarray(rng.integers(0, n_rows, Q, dtype=np.int32))

    @jax.jit
    def g(carry, table, idx):
        ix = (idx + carry.astype(jnp.int32)) & (table.shape[0] - 1)
        rows = jnp.take(table, ix, axis=0)
        return jnp.sum(rows, dtype=jnp.uint32) | (carry & 1)

    carry = jnp.uint32(0)
    carry = g(carry, data, idx)
    _ = int(np.asarray(carry))
    ITERS = 8
    t0 = time.perf_counter()
    carry = jnp.uint32(1)
    for _ in range(ITERS):
        carry = g(carry, data, idx)
    _ = int(np.asarray(carry))
    dt = (time.perf_counter() - t0) / ITERS
    return {"rows_log2": int(np.log2(n_rows)),
            "row_bytes": int(data.shape[1] * 4),
            "mgather_per_s": round(Q / dt / 1e6, 1)}


def main():
    h0, h1, wpath = ensure_markers()
    reads = ensure_reads(wpath)

    import jax

    from hast_jax.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    log(f"devices: {jax.devices()}")

    phases = []
    cold = run_ours(h0, h1, reads, "ours.phased", phases)
    log(f"ours cold (incl table build/upload): {cold:.1f}s "
        f"phases={phases[-1]}")
    warm = []
    for i in range(N_WARM):
        warm.append(run_ours(h0, h1, reads, "ours.phased", phases))
        log(f"ours warm {i + 1}: {warm[-1]:.2f}s phases={phases[-1]}")
    best = min(warm) if warm else cold
    try:
        ms = jax.devices()[0].memory_stats() or {}
        mem = {"bytes_in_use": int(ms.get("bytes_in_use", 0)),
               "bytes_limit": int(ms.get("bytes_limit", 0))}
    except Exception:
        mem = None
    g = gather_bench()
    log(f"gather at 2^{g['rows_log2']} rows: {g['mgather_per_s']} M/s"
        if g else "gather bench skipped")

    result = {
        "n_markers_per_hap": N_MARKERS,
        "n_reads": N_READS,
        "cold_s": round(cold, 1),
        "warm_s": [round(w, 2) for w in warm],
        "best_reads_per_s": round(N_READS / best),
        "phases": phases,
        "gather": g,
        "memory": mem,
    }
    print(json.dumps(result))
    (CACHE / f"result_{N_MARKERS}.json").write_text(json.dumps(result))


if __name__ == "__main__":
    main()
