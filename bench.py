#!/usr/bin/env python
"""Benchmark: stage-01 classify and stage-00 marker build on one GPU.

Prints ONE JSON line on stdout with the device it ran on, classify
throughput (reads/s, best and median of the warm samples, plus the cold
run) and the stage-00 end-to-end time (cold and warm, k-mers/s).
Outputs are checked on every sample: classify against the numpy
reference (hast_jax/reference.py), stage 00 against the host engine.
Any mismatch raises.  Without a GPU it exits non-zero before measuring.

Progress/details go to stderr.  Synthetic inputs are generated from a
fixed seed under .hast_work/bench (listed in .gitignore).
"""

import hashlib
import json
import os
import pathlib
import shutil
import statistics
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
CACHE = HERE / ".hast_work" / "bench"
N_MARKERS = int(os.environ.get("HAST_BENCH_MARKERS", 1_000_000))
# 1M reads / ~1M distinct barcodes: in this generator barcode count
# scales with reads (~1 read/barcode — the worst case for per-barcode
# costs).  Override with HAST_BENCH_READS.
N_READS = int(os.environ.get("HAST_BENCH_READS", 1_000_000))
N_WARM = int(os.environ.get("HAST_BENCH_WARM_SAMPLES", "5"))
K = 21


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def ensure_inputs():
    CACHE.mkdir(parents=True, exist_ok=True)
    stamp = CACHE / f"stamp_{N_MARKERS}_{N_READS}"
    hap0, hap1 = CACHE / "hap0.mer", CACHE / "hap1.mer"
    reads = CACHE / "reads.fq"
    if stamp.exists():
        return str(hap0), str(hap1), str(reads)
    log(f"generating {N_MARKERS} markers/hap + {N_READS} reads ...")
    import numpy as np
    from hast_jax.ops import encode as E
    from hast_jax.ops import kmer_count as KC

    rng = np.random.default_rng(123)
    # fast marker generation: random canonical words, dedup across haps
    seqs = rng.integers(0, 4, size=(int(N_MARKERS * 2.2), K),
                        dtype=np.int32)
    hi, lo = E.canonical_kmers_np(seqs, K)
    words = (hi[:, 0].astype(np.uint64) << np.uint64(32)) | lo[:, 0]
    words = np.unique(words)
    rng.shuffle(words)
    assert words.size >= 2 * N_MARKERS
    s0 = KC.words_to_strings(words[:N_MARKERS], K)
    s1 = KC.words_to_strings(words[N_MARKERS:2 * N_MARKERS], K)
    with open(hap0, "wb") as f:
        f.write(b"\n".join(s0.tolist()) + b"\n")
    with open(hap1, "wb") as f:
        f.write(b"\n".join(s1.tolist()) + b"\n")

    # reads: 100bp, ~30% carry a planted marker, some N reads
    # (all plants/edits vectorized: 4M reads generate in seconds)
    L = 100
    B = np.frombuffer(b"ACGT", np.uint8)
    n = N_READS
    seq_arr = B[rng.integers(0, 4, (n, L))]
    which = rng.random(n)
    m0 = KC.words_to_strings(words[rng.integers(0, N_MARKERS, n)], K)
    m1 = KC.words_to_strings(
        words[N_MARKERS + rng.integers(0, N_MARKERS, n)], K)
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
    stamp.touch()
    return str(hap0), str(hap1), str(reads)


def run_ours(hap0, hap1, reads, want: bytes, phases: list) -> float:
    from hast_jax.pipeline import classify as C
    from hast_jax.utils.profiling import PhaseTimer

    timer = PhaseTimer()
    t0 = time.perf_counter()
    with open(CACHE / "ours.phased", "wb") as out:
        C.run_classify(hap0, hap1, [reads], out, w0=1.04, timer=timer)
    dt = time.perf_counter() - t0
    if (CACHE / "ours.phased").read_bytes() != want:
        raise AssertionError("classify output differs from the reference")
    phases.append(dict(timer.phases))
    return dt


def device_fields() -> dict:
    import jax
    d = jax.devices()[0]
    if d.platform != "gpu":
        sys.exit(f"bench.py: needs a GPU; JAX found {d.platform} only")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def main():
    device = device_fields()
    from hast_jax import reference as R
    from hast_jax.utils.compile_cache import enable_compile_cache
    log(f"device: {device}; compile cache: {enable_compile_cache()}")

    hap0, hap1, reads = ensure_inputs()
    want = R.classify(hap0, hap1, [reads], w0=1.04)
    phases: list = []
    cold_s = run_ours(hap0, hap1, reads, want, phases)
    log(f"classify (cold, incl compile): {cold_s:.3f}s")
    samples = []
    for i in range(N_WARM):
        samples.append(run_ours(hap0, hap1, reads, want, phases))
        log(f"classify (warm {i + 1}): {samples[-1]:.3f}s "
            f"phases={phases[-1]}")
    best_s = min(samples)
    fields = {
        "metric": "classify_reads_per_s",
        "value": N_READS / best_s,
        "unit": "reads/s",
        "device": device,
        "median_reads_per_s": N_READS / statistics.median(samples),
        "samples_s": samples,
        "cold_s": cold_s,
        "phases_best_s": phases[1 + samples.index(best_s)],
    }
    fields.update(measure_stage00())
    print(json.dumps(fields))


GENOME_LEN = int(os.environ.get("HAST_BENCH_GENOME", 3_000_000))
COVERAGE = float(os.environ.get("HAST_BENCH_COVERAGE", 33.0))
ERR_RATE = 0.002
READ_LEN = 100


def ensure_parent_inputs():
    """Two parents' shotgun fasta (shared backbone + het SNPs), sized so
    each parent is ~1M reads at default settings."""
    CACHE.mkdir(parents=True, exist_ok=True)
    pat_fa = CACHE / "pat_parent.fa"
    mat_fa = CACHE / "mat_parent.fa"
    stamp = CACHE / f"parents_{GENOME_LEN}_{COVERAGE}"
    if stamp.exists():
        return str(pat_fa), str(mat_fa)
    log(f"generating 2 parents: {GENOME_LEN} bp genome, "
        f"{COVERAGE}x coverage ...")
    from hast_jax.utils.synthetic import (make_parent_reads_vectorized,
                                          make_trio_genomes)
    pat_g, mat_g = make_trio_genomes(77, GENOME_LEN, het_rate=0.001)
    for seed, g_bytes, path in ((1, pat_g, pat_fa), (2, mat_g, mat_fa)):
        make_parent_reads_vectorized(seed, g_bytes, str(path), COVERAGE,
                                     READ_LEN, ERR_RATE)
    stamp.touch()
    return str(pat_fa), str(mat_fa)


def _markers_digest(path):
    lines = sorted(open(path, "rb").read().split())
    return hashlib.sha256(b"\n".join(lines)).hexdigest(), len(lines)


def run_stage00(pat_fa, mat_fa, tag, engine):
    from hast_jax.pipeline import markers as M
    workdir = CACHE / f"stage00_{tag}"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir()
    t0 = time.perf_counter()
    paths = M.build_unshared_markers(
        [pat_fa], [mat_fa], out_dir=str(workdir), auto_bounds=True,
        engine=engine)
    dt = time.perf_counter() - t0
    return dt, {p: _markers_digest(paths[p])
                for p in ("paternal", "maternal")}


def measure_stage00():
    """Stage 00 end to end on the device engine, checked against the
    host engine (numpy set algebra) on the same parent reads."""
    pat_fa, mat_fa = ensure_parent_inputs()
    n_reads = int(GENOME_LEN * COVERAGE / READ_LEN)
    kmers = 2 * n_reads * (READ_LEN - K + 1)
    _, want = run_stage00(pat_fa, mat_fa, "host", "host")
    cold_s, got = run_stage00(pat_fa, mat_fa, "cold", "device")
    warm_s, got_warm = run_stage00(pat_fa, mat_fa, "warm", "device")
    if got != want or got_warm != want:
        raise AssertionError(f"stage00 markers differ from the host "
                             f"engine: {got} / {got_warm} vs {want}")
    log(f"stage00 device: cold {cold_s:.3f}s, warm {warm_s:.3f}s -> "
        f"{kmers / warm_s:,.0f} kmers/s")
    return {"count_kmers_per_s": kmers / warm_s,
            "count_scope": "stage00_e2e",
            "count_cold_s": cold_s,
            "count_warm_s": warm_s}


if __name__ == "__main__":
    main()
