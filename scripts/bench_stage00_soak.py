#!/usr/bin/env python
"""Human-scale stage-00 soak.

Exercises the counting engines at >= 1e9 total k-mers — the regime
`count_batches_partitioned` and the 2-sweep device engine exist for
(the reference's analog: jellyfish's 10 GB hash at 30x human,
build_unshared_kmers.sh:188-221) — and proves the partitioned path
produces byte-identical markers to the single-pass resident engine:

  phase A: resident device engine (n_parts=1): both parents' distinct
           sets live in HBM simultaneously for the marker algebra.
  phase B: 2-sweep partitioned engine (n_parts=P): quantile key ranges,
           input re-streamed per pass; per-pass distinct counts show
           the quantile balance of the strided boundary sampler.

Default scale: 100 Mb genome x 30x coverage x 2 parents = 4.8e9 total
k-mers (2.4e9/parent), ~2.3e8 distinct/parent (genome + error tail).
Inputs cache under .hast_work/soak (~6 GB disk).

Usage: python scripts/bench_stage00_soak.py [--parts P]
Env: HAST_SOAK_GENOME (bp), HAST_SOAK_COV.
"""

import io
import json
import os
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CACHE = pathlib.Path(__file__).resolve().parents[1] / ".hast_work" / "soak"
GENOME = int(float(os.environ.get("HAST_SOAK_GENOME", 100_000_000)))
COV = float(os.environ.get("HAST_SOAK_COV", 30.0))
READ_LEN = 100
ERR = 0.002
K = 21


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def write_parent_chunked(seed: int, genome: np.ndarray, path: str,
                         n_reads: int, chunk: int = 1 << 21) -> None:
    """Chunked shotgun generator (the vectorized one allocates a
    (n, read_len) float error mask — 24 GB at 30M reads)."""
    rng = np.random.default_rng(seed)
    BASES = np.frombuffer(b"ACGT", np.uint8)
    comp = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    head = np.frombuffer(b">r\n", np.uint8)
    with open(path, "wb", buffering=1 << 24) as f:
        for s in range(0, n_reads, chunk):
            n = min(chunk, n_reads - s)
            pos = rng.integers(0, genome.size - READ_LEN + 1, n)
            reads = genome[pos[:, None] + np.arange(READ_LEN)]
            err = rng.random((n, READ_LEN)) < ERR
            reads = np.where(err, BASES[rng.integers(0, 4, (n, READ_LEN))],
                             reads)
            flip = rng.integers(0, 2, n).astype(bool)
            reads[flip] = comp[reads[flip][:, ::-1]]
            block = np.concatenate(
                [np.broadcast_to(head, (n, 3)), reads,
                 np.full((n, 1), ord("\n"), np.uint8)], axis=1)
            f.write(block.tobytes())


def ensure_inputs():
    CACHE.mkdir(parents=True, exist_ok=True)
    pat, mat = CACHE / "pat.fa", CACHE / "mat.fa"
    stamp = CACHE / f"parents_{GENOME}_{COV}"
    n_reads = int(GENOME * COV / READ_LEN)
    if stamp.exists():
        return str(pat), str(mat), n_reads
    from hast_jax.utils.synthetic import make_trio_genomes
    log(f"generating trio genomes ({GENOME / 1e6:.0f} Mb) ...")
    t0 = time.perf_counter()
    pat_g, mat_g = make_trio_genomes(77, GENOME, het_rate=0.001)
    log(f"  genomes in {time.perf_counter() - t0:.0f}s")
    for seed, g, path in ((1, pat_g, pat), (2, mat_g, mat)):
        t0 = time.perf_counter()
        write_parent_chunked(seed, np.frombuffer(g, np.uint8), str(path),
                             n_reads)
        log(f"  {path.name}: {n_reads:,} reads in "
            f"{time.perf_counter() - t0:.0f}s")
    stamp.touch()
    return str(pat), str(mat), n_reads


class Tee(io.TextIOBase):
    def __init__(self):
        self.lines: list[str] = []

    def write(self, s):
        self.lines.append(s)
        sys.stderr.write(s)
        sys.stderr.flush()
        return len(s)


def run_engine(pat, mat, out_tag, n_parts):
    import shutil
    from hast_jax.pipeline import markers as M
    d = CACHE / f"out_{out_tag}"
    if d.exists():
        shutil.rmtree(d)
    d.mkdir()
    tee = Tee()
    t0 = time.perf_counter()
    paths = M.build_unshared_markers(
        [pat], [mat], out_dir=str(d), auto_bounds=True,
        engine="device", n_parts=n_parts, log=tee)
    dt = time.perf_counter() - t0
    return dt, paths, tee.lines


def main():
    n_parts = 4
    if "--parts" in sys.argv:
        n_parts = int(sys.argv[sys.argv.index("--parts") + 1])
    pat, mat, n_reads = ensure_inputs()
    kmers_total = 2 * n_reads * (READ_LEN - K + 1)

    import jax

    from hast_jax.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    log(f"devices: {jax.devices()}; total k-mers {kmers_total / 1e9:.2f}e9")

    result = {"genome_bp": GENOME, "coverage": COV,
              "kmers_total": kmers_total, "n_parts": n_parts}

    # Phase A: resident single-pass, when the marker-algebra
    # transient fits the device.  Analytic residency envelope:
    # distinct/parent ~= genome + error tail; the algebra sorts the
    # 2-parent concat padded to a power of two with in+out copies of
    # (hi, lo, counts, tag) -> ~16 B/row x 2 x padded rows transient.
    # The envelope is 7/8 of the device's bytes_limit (the rest is
    # working set).  Past it, or on OOM, fall back to a
    # cross-partitioning equality check (P vs 2P ranges: identical
    # output reachable via two independent key splits).
    limit = (jax.devices()[0].memory_stats() or {}).get("bytes_limit")
    if limit is None:
        sys.exit("device reports no bytes_limit; run on a GPU")
    envelope = limit * 7 // 8
    est_distinct = int(GENOME + GENOME * COV * ERR * K)
    pad = 1 << (2 * est_distinct - 1).bit_length()
    algebra_bytes = 2 * pad * 16
    result["est_distinct_per_parent"] = est_distinct
    result["est_algebra_transient_gb"] = round(algebra_bytes / 1e9, 1)
    result["envelope_gb"] = round(envelope / 1e9, 1)
    if algebra_bytes > envelope:
        log(f"resident single-pass skipped: estimated algebra transient "
            f"{algebra_bytes / 1e9:.0f} GB exceeds the "
            f"{envelope / 1e9:.0f} GB envelope — this scale is the "
            f"partitioned engine's regime")
        result["resident_s"] = None
        result["resident_oom"] = True
        paths_res = None
    else:
        try:
            t_res, paths_res, _ = run_engine(pat, mat, "resident", 1)
            log(f"resident single-pass: {t_res:.0f}s "
                f"({kmers_total / t_res / 1e6:.0f}M kmers/s e2e)")
            result["resident_s"] = round(t_res, 1)
            result["resident_kmers_per_s"] = round(kmers_total / t_res)
        except Exception as e:
            if "RESOURCE_EXHAUSTED" not in str(e):
                raise
            log("resident single-pass: RESOURCE_EXHAUSTED — using "
                "cross-partitioning check")
            result["resident_s"] = None
            result["resident_oom"] = True
            paths_res = None

    t_part, paths_part, lines_part = run_engine(pat, mat, "parts", n_parts)
    log(f"partitioned ({n_parts} ranges, 2 sweeps): {t_part:.0f}s "
        f"({kmers_total / t_part / 1e6:.0f}M kmers/s e2e)")
    result["partitioned_s"] = round(t_part, 1)
    result["partitioned_kmers_per_s"] = round(kmers_total / t_part)
    # per-pass distinct counts (quantile balance of the strided sampler)
    result["pass_log"] = [ln.strip() for ln in "".join(lines_part).split("\n")
                          if "count pass" in ln or "marker pass" in ln
                          or "distinct" in ln]

    if paths_res is None:
        t2, paths_res, lines2 = run_engine(pat, mat, "parts2x",
                                           2 * n_parts)
        log(f"partitioned ({2 * n_parts} ranges): {t2:.0f}s")
        result["partitioned_2x_s"] = round(t2, 1)
        cmp_name = "equal_across_partitionings"
    else:
        cmp_name = "partitioned_equals_resident"

    same = True
    for p in ("paternal", "maternal"):
        a = pathlib.Path(paths_res[p]).read_bytes()
        b = pathlib.Path(paths_part[p]).read_bytes()
        n_lines = a.count(b"\n")
        result[f"{p}_markers"] = n_lines
        if a != b:
            same = False
            log(f"MISMATCH: {p} markers differ between engines!")
    result[cmp_name] = same
    print(json.dumps(result))
    (CACHE / "result.json").write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
