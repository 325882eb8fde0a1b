#!/usr/bin/env python
"""Drive the trio-binning main path once on a GPU and check every output.

    python chip_smoke.py [--seed N]      # one GPU
    python chip_smoke.py --four          # the mesh paths on four GPUs

Everything runs in this one process through ``hast_jax.cli.main``, the
entry point a user calls; inputs are generated from ``--seed`` under
``.hast_work/`` (listed in .gitignore) and deleted after a clean run.

One GPU:
  device    platform, kind, memory limit, card name and power limit;
  goldens   classify, build-markers + classify-reads and build-markers
            on the committed reference-binary fixtures, byte for byte;
  trio      a seeded 12 Mb trio at yeast scale through ``cli run``:
            both parents at 30x, 10^6 gzipped stLFR read pairs; marker
            files equal the host engine's, phased.barcodes equals the
            numpy reference (hast_jax/reference.py);
  beyond_l2 ``cli classify`` against 2x10^7 markers per haplotype (a
            probe table far larger than the GPU's L2) and 10^6 reads,
            equal to the numpy reference.
--four: ``classify --mesh 4x1`` and ``2x2`` on beyond_l2 inputs with a
quarter of the markers (5x10^6 per haplotype, a 64 MiB table),
``build-markers --mesh 4`` on the trio parents, and
``__graft_entry__.dryrun_multichip(4)``, each against its reference.

The last stdout line is one JSON object, {"ok": true, "device": ...};
any mismatch or error raises and exits non-zero.  Without a GPU the
script exits non-zero before any phase runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

from hast_jax.utils.compile_cache import enable_compile_cache

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "tests", "golden")
K = 21
READ_LEN = 100


@dataclasses.dataclass(frozen=True)
class Sizes:
    genome: int = 12_000_000       # trio genome (BASELINE configs 2/3)
    parent_cov: float = 30.0
    child_pairs: int = 1_000_000
    markers: int = 20_000_000      # per haplotype (BASELINE config 4)
    reads: int = 1_000_000


FULL = Sizes()
TINY = Sizes(genome=60_000, parent_cov=12.0, child_pairs=4_000,
             markers=20_000, reads=6_000)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def cli(*argv) -> float:
    """One in-process CLI call; returns its wall seconds."""
    from hast_jax.cli import main as cli_main
    t0 = time.perf_counter()
    cli_main([str(a) for a in argv])
    return time.perf_counter() - t0


def same_bytes(ours: str, want: str) -> None:
    a, b = open(ours, "rb").read(), open(want, "rb").read()
    if a != b:
        raise AssertionError(f"{ours} differs from {want} "
                             f"({len(a)} vs {len(b)} bytes)")


def sorted_digest(path: str) -> tuple[str, int]:
    lines = sorted(open(path, "rb").read().split())
    return hashlib.sha256(b"\n".join(lines)).hexdigest(), len(lines)


class Probe:
    """Counts calls into the code paths the smoke run must exercise,
    and keeps every PhaseTimer report, by wrapping module attributes."""

    def __init__(self):
        from hast_jax.ops import kmer_count as KC
        from hast_jax.pipeline import classify as C
        from hast_jax.utils import profiling as P
        self.calls: dict[str, int] = {}
        self.phases: list[dict] = []
        self._undo = []
        self._count(C, "_classify_fastqs_device_tally")
        self._count(C, "tally_step")
        self._count(KC, "count_file_native", must_return=True)
        report = P.PhaseTimer.report
        probe = self

        def keep(timer):
            out = report(timer)
            probe.phases.append(out)
            return out
        P.PhaseTimer.report = keep
        self._undo.append(lambda: setattr(P.PhaseTimer, "report", report))

    def _count(self, mod, name, must_return=False):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            if must_return and out is None:
                raise AssertionError(f"{name} fell back to the python reader")
            self.calls[name] = self.calls.get(name, 0) + 1
            return out
        setattr(mod, name, wrapped)
        self._undo.append(lambda: setattr(mod, name, fn))

    def require(self, *names) -> None:
        for name in names:
            if not self.calls.get(name):
                raise AssertionError(f"{name} never ran")

    def take_phases(self) -> dict:
        merged: dict = {}
        for rep in self.phases:
            for name, row in rep.items():
                merged[name] = round(merged.get(name, 0.0)
                                     + row["seconds"], 3)
        self.phases = []
        return merged

    def close(self) -> None:
        for undo in reversed(self._undo):
            undo()


# ---------------------------------------------------------------------------
# seeded inputs
# ---------------------------------------------------------------------------

_ASCII = np.frombuffer(b"ACTG", np.uint8)     # 2-bit code -> base


def _revcomp_words(w: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of 2k-bit words (code ^ 2 is the complement)."""
    x = w ^ np.uint64(sum(2 << (2 * i) for i in range(k)))
    for shift, mask in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                        (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF)):
        m, s = np.uint64(mask), np.uint64(shift)
        x = ((x >> s) & m) | ((x & m) << s)
    x = (x >> np.uint64(32)) | (x << np.uint64(32))
    return x >> np.uint64(64 - 2 * k)


def _words_to_ascii(w: np.ndarray, k: int) -> np.ndarray:
    out = np.empty((w.size, k), np.uint8)
    for i in range(k):
        shift = np.uint64(2 * (k - 1 - i))
        out[:, i] = _ASCII[((w >> shift) & np.uint64(3)).astype(np.uint8)]
    return out


def make_markers(rng, n: int, k: int, hap0: str, hap1: str):
    """2n distinct canonical k-mers, split into two marker files.
    Returns both as (n, k) ASCII arrays for planting into reads.
    Works in blocks of 2^20 words so that temporaries stay small."""
    block = 1 << 20
    w = rng.integers(0, 1 << (2 * k), int(2.2 * n) + 64, dtype=np.uint64)
    for s in range(0, w.size, block):
        part = w[s:s + block]
        np.minimum(part, _revcomp_words(part, k), out=part)
    w = np.unique(w)
    rng.shuffle(w)
    sets = []
    for i, path in enumerate((hap0, hap1)):
        text = np.empty((n, k + 1), np.uint8)
        text[:, k] = ord("\n")
        for s in range(0, n, block):
            text[s:s + block, :k] = _words_to_ascii(
                w[i * n + s:i * n + min(n, s + block)], k)
        with open(path, "wb") as f:
            f.write(text.tobytes())
        sets.append(text[:, :k])
    return sets


def barcode_sizes(rng, n_reads: int) -> np.ndarray:
    """Heavy-tailed reads per barcode (Lomax, shape 1.5), mean ~20."""
    sizes = np.minimum(1 + (rng.pareto(1.5, n_reads) * 10).astype(np.int64),
                       3000)
    cut = int(np.searchsorted(np.cumsum(sizes), n_reads)) + 1
    sizes = sizes[:cut]
    sizes[-1] -= sizes.sum() - n_reads
    return sizes


def barcode_names(n: int) -> list[bytes]:
    i = np.arange(n)
    return [b"%d_%d_%d" % t for t in zip((i % 1536 + 1).tolist(),
                                         (i // 1536 % 1536 + 1).tolist(),
                                         (i // 1536 ** 2 + 1).tolist())]


def _reads_to_fastq(heads: list[bytes], seqs: np.ndarray) -> bytes:
    n = seqs.shape[1]
    flat = seqs.tobytes()
    qual = b"\n+\n" + b"F" * n + b"\n"
    return b"".join(b"%s\n%s%s" % (h, flat[i * n:(i + 1) * n], qual)
                    for i, h in enumerate(heads))


def _substitute(rng, seqs: np.ndarray, rate: float) -> None:
    err = rng.random(seqs.shape, dtype=np.float32) < rate
    seqs[err] = _ASCII[rng.integers(0, 4, int(err.sum()))]


def make_classify_reads(rng, n: int, sets, path: str) -> None:
    """n random 100 bp reads: 15% carry a hap0 marker, 15% a hap1
    marker (half of them reverse-complemented), 2% an N; barcodes of
    heavy-tailed size, some of them null."""
    seqs = _ASCII[rng.integers(0, 4, (n, READ_LEN))]
    kind = rng.random(n)
    pos = rng.integers(0, READ_LEN - K + 1, n)
    comp = np.zeros(256, np.uint8)
    comp[_ASCII] = np.frombuffer(b"TGAC", np.uint8)
    for hap, lo, hi in ((0, 0.0, 0.15), (1, 0.15, 0.30)):
        sel = np.flatnonzero((kind >= lo) & (kind < hi))
        mers = sets[hap][rng.integers(0, len(sets[hap]), sel.size)]
        flip = rng.random(sel.size) < 0.5
        mers[flip] = comp[mers[flip][:, ::-1]]
        seqs[sel[:, None], pos[sel, None] + np.arange(K)] = mers
    with_n = np.flatnonzero(rng.random(n) < 0.02)
    seqs[with_n, rng.integers(0, READ_LEN, with_n.size)] = ord("N")
    sizes = barcode_sizes(rng, n)
    names = barcode_names(sizes.size)
    for i in rng.choice(sizes.size, max(1, sizes.size // 200), replace=False):
        names[i] = b"0_0_0"
    owner = rng.permutation(np.repeat(np.arange(sizes.size), sizes))
    heads = [b"@V300017823L1C001R%09d#%s/1" % (i, names[b])
             for i, b in enumerate(owner.tolist())]
    with open(path, "wb") as f:
        f.write(_reads_to_fastq(heads, seqs))


def make_trio(seed: int, sizes: Sizes, d: str):
    """Parents' shotgun fasta and the child's gzipped stLFR pairs."""
    from hast_jax.utils.synthetic import (make_parent_reads_vectorized,
                                          make_trio_genomes)
    genomes = make_trio_genomes(seed, sizes.genome, het_rate=0.001)
    parents = {}
    for i, (name, g) in enumerate(zip(("paternal", "maternal"), genomes)):
        parents[name] = os.path.join(d, f"{name}.fa")
        n = make_parent_reads_vectorized(seed + 1 + i, g, parents[name],
                                         sizes.parent_cov, READ_LEN, 0.002)
        parents[name + "_reads"] = n
    return genomes, parents


def make_child(rng, genomes, n_pairs: int, r1: str, r2: str) -> None:
    """stLFR pairs: each barcode is one long fragment of one parental
    haplotype; pairs are 300-500 bp inserts inside it."""
    g = [np.frombuffer(x, np.uint8) for x in genomes]
    glen = g[0].size
    frag = min(50_000, glen // 4)
    sizes = barcode_sizes(rng, n_pairs)
    hap = rng.integers(0, 2, sizes.size)
    start = rng.integers(0, glen - frag, sizes.size)
    owner = rng.permutation(np.repeat(np.arange(sizes.size), sizes))
    ins = rng.integers(300, 501, n_pairs)
    s = start[owner] + rng.integers(0, frag - 500, n_pairs)
    comp = np.zeros(256, np.uint8)
    comp[_ASCII] = np.frombuffer(b"TGAC", np.uint8)
    cols = np.arange(READ_LEN)
    names = barcode_names(sizes.size)
    for end, path in ((1, r1), (2, r2)):
        a = s if end == 1 else s + ins - READ_LEN
        seqs = np.empty((n_pairs, READ_LEN), np.uint8)
        for h in (0, 1):
            sel = np.flatnonzero(hap[owner] == h)
            seqs[sel] = g[h][a[sel, None] + cols]
        if end == 2:
            seqs = comp[seqs[:, ::-1]]
        _substitute(rng, seqs, 0.002)
        heads = [b"@CL100%09d#%s/%d" % (i, names[b], end)
                 for i, b in enumerate(owner.tolist())]
        with gzip.open(path, "wb", compresslevel=1) as f:
            f.write(_reads_to_fastq(heads, seqs))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(require_gpu: bool, four: bool) -> dict:
    import jax
    devs = jax.devices()
    d0 = devs[0]
    if require_gpu and d0.platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU; JAX found {d0.platform} only")
    if four and len(devs) < 4:
        sys.exit(f"chip_smoke --four: needs 4 devices, found {len(devs)}")
    stats = d0.memory_stats() or {}
    log(f"device: {d0.platform} {d0.device_kind} x{len(devs)}, "
        f"bytes_limit {stats.get('bytes_limit', 'not reported')}, "
        f"jax {jax.__version__}")
    if require_gpu:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        print(smi, flush=True)
    return {"platform": d0.platform, "kind": d0.device_kind,
            "count": len(devs)}


def golden_classify(work: str) -> None:
    g1 = os.path.join(GOLD, "stage01")
    out = os.path.join(work, "golden.phased")
    cli("classify", "--hap0", f"{g1}/hap0.mer", "--hap1", f"{g1}/hap1.mer",
        "--read", f"{g1}/reads1.fq.gz", "--read", f"{g1}/reads2.fq",
        "--weight0", "1.04", "--output", out)
    same_bytes(out, f"{g1}/phased.barcodes.golden")


def golden_e2e(work: str) -> None:
    ge = os.path.join(GOLD, "e2e")
    d00, d01 = os.path.join(work, "e2e00"), os.path.join(work, "e2e01")
    os.makedirs(d00)
    os.makedirs(d01)
    cli("build-markers", "--out-dir", d00, "--auto_bounds",
        "--paternal", f"{ge}/paternal.fa.gz",
        "--maternal", f"{ge}/maternal.fa.gz", "--batch-size", "16384")
    cli("classify-reads",
        "--paternal_mer", f"{d00}/paternal.unique.filter.mer",
        "--maternal_mer", f"{d00}/maternal.unique.filter.mer",
        "--filial", f"{ge}/son.r1.fq.gz", "--filial", f"{ge}/son.r2.fq",
        "--workdir", d01, "--batch-size", "4096")
    for parent in ("paternal", "maternal"):
        assert sorted_digest(f"{d00}/{parent}.unique.filter.mer") == \
            sorted_digest(f"{ge}/{parent}.unique.filter.mer"), parent
    same_bytes(f"{d01}/phased.barcodes", f"{ge}/stage01/phased.barcodes")
    for r in (1, 2):
        for b in ("paternal", "maternal", "homozygous", "nobarcode"):
            name = f"son.r{r}.fq.{b}.fastq"
            want = os.path.join(ge, "stage01", name)
            if os.path.exists(want):
                same_bytes(os.path.join(d01, name), want)
            else:
                assert not os.path.exists(os.path.join(d01, name)), name


def golden_stage00(work: str) -> None:
    g0 = os.path.join(GOLD, "stage00")
    d = os.path.join(work, "stage00")
    os.makedirs(d)
    cli("build-markers", "--out-dir", d, "--auto_bounds",
        "--paternal", f"{g0}/paternal.reads.fa.gz",
        "--maternal", f"{g0}/maternal.reads.fa.gz", "--batch-size", "16384")
    for parent in ("paternal", "maternal"):
        assert sorted_digest(f"{d}/{parent}.unique.filter.mer") == \
            sorted_digest(f"{g0}/{parent}.unique.filter.mer"), parent
        same_bytes(f"{d}/{parent}.kmercount.histo", f"{g0}/{parent}.histo")
        same_bytes(f"{d}/{parent}.bounds.txt", f"{g0}/{parent}.bounds.txt")


def phase_goldens(work: str) -> None:
    golden_classify(work)
    golden_e2e(work)
    golden_stage00(work)
    log("goldens: classify, e2e stage 00+01, stage 00 byte-identical")


def host_markers(parents: dict, d: str) -> dict:
    """Marker digests from the host engine (set algebra in numpy)."""
    from hast_jax.pipeline import markers as M
    os.makedirs(d)
    paths = M.build_unshared_markers(
        [parents["paternal"]], [parents["maternal"]], out_dir=d,
        auto_bounds=True, engine="host", log=open(os.devnull, "w"))
    return {p: sorted_digest(paths[p]) for p in ("paternal", "maternal")}


def phase_trio(rng, seed: int, sizes: Sizes, work: str, probe: Probe,
               dev) -> dict:
    from hast_jax import reference as R
    d = os.path.join(work, "trio")
    os.makedirs(d)
    t0 = time.perf_counter()
    genomes, parents = make_trio(seed, sizes, d)
    r1, r2 = os.path.join(d, "child.r1.fq.gz"), os.path.join(d,
                                                             "child.r2.fq.gz")
    make_child(rng, genomes, sizes.child_pairs, r1, r2)
    gen_s = time.perf_counter() - t0
    wd = os.path.join(d, "run")
    run_s = cli("run", "--paternal", parents["paternal"],
                "--maternal", parents["maternal"], "--read1", r1,
                "--read2", r2, "--workdir", wd)
    phases = probe.take_phases()
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use",
                                          "not reported")
    d00 = os.path.join(wd, "00.build_kmers")
    t0 = time.perf_counter()
    want = host_markers(parents, os.path.join(d, "host"))
    host_s = time.perf_counter() - t0
    probe.take_phases()
    for p in ("paternal", "maternal"):
        got = sorted_digest(os.path.join(d00, f"{p}.unique.filter.mer"))
        assert got == want[p], (p, got, want[p])
    t0 = time.perf_counter()
    ref = R.classify(os.path.join(d00, "paternal.unique.filter.mer"),
                     os.path.join(d00, "maternal.unique.filter.mer"),
                     [r1, r2], w0=1.04)
    ref_s = time.perf_counter() - t0
    phased = os.path.join(wd, "01.classify_reads", "phased.barcodes")
    assert open(phased, "rb").read() == ref, "phased.barcodes != reference"
    distinct = {}
    for p in ("paternal", "maternal"):
        rows = np.loadtxt(os.path.join(d00, f"{p}.kmercount.histo"),
                          dtype=np.int64, ndmin=2)
        distinct[p] = int(rows[:, 1].sum())
    out = {"kmers_counted": (parents["paternal_reads"]
                             + parents["maternal_reads"])
           * (READ_LEN - K + 1),
           "distinct": distinct,
           "markers": {p: want[p][1] for p in want},
           "barcodes": ref.count(b"\n"),
           "generate_s": round(gen_s, 3), "cli_run_s": round(run_s, 3),
           "phases_s": phases, "host_engine_s": round(host_s, 3),
           "reference_s": round(ref_s, 3), "peak_bytes_in_use": peak}
    log(f"trio: {json.dumps(out)}")
    return out


def beyond_l2_inputs(rng, sizes: Sizes, work: str):
    from hast_jax import reference as R
    d = os.path.join(work, "beyond_l2")
    os.makedirs(d)
    h0, h1 = os.path.join(d, "hap0.mer"), os.path.join(d, "hap1.mer")
    fq = os.path.join(d, "reads.fq")
    t0 = time.perf_counter()
    sets = make_markers(rng, sizes.markers, K, h0, h1)
    log(f"beyond_l2: markers generated in {time.perf_counter() - t0:.3f}s")
    make_classify_reads(rng, sizes.reads, sets, fq)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = R.classify(h0, h1, [fq], w0=1.04)
    ref_s = time.perf_counter() - t0
    return d, h0, h1, fq, ref, {"generate_s": round(gen_s, 3),
                                "reference_s": round(ref_s, 3)}


def phase_beyond_l2(rng, sizes: Sizes, work: str, probe: Probe) -> dict:
    from hast_jax.pipeline import classify as C
    d, h0, h1, fq, ref, info = beyond_l2_inputs(rng, sizes, work)
    out = os.path.join(d, "phased.barcodes")
    info["cli_classify_s"] = round(cli(
        "classify", "--hap0", h0, "--hap1", h1, "--read", fq,
        "--weight0", "1.04", "--output", out), 3)
    info["phases_s"] = probe.take_phases()
    assert open(out, "rb").read() == ref, "classify != reference"
    table = C._DEVICE_TABLE["table"]
    info.update(table_bytes=int(table.data.nbytes), table_fmt=table.fmt,
                barcodes=ref.count(b"\n"))
    log(f"beyond_l2: {json.dumps(info)}")
    return info


def phase_four(rng, seed: int, sizes: Sizes, work: str) -> None:
    import jax

    import __graft_entry__
    from hast_jax.parallel import mesh as PM
    devs = jax.devices()[:4]

    def peaks():
        return [(x.memory_stats() or {}).get("peak_bytes_in_use", 0)
                for x in devs]

    d = os.path.join(work, "four_trio")
    os.makedirs(d)
    _, parents = make_trio(seed, sizes, d)
    os.makedirs(os.path.join(d, "mesh"))
    secs = cli("build-markers", "--mesh", "4", "--auto_bounds",
               "--out-dir", os.path.join(d, "mesh"),
               "--paternal", parents["paternal"],
               "--maternal", parents["maternal"])
    pk = peaks()
    want = host_markers(parents, os.path.join(d, "host"))
    for p in ("paternal", "maternal"):
        got = sorted_digest(os.path.join(d, "mesh",
                                         f"{p}.unique.filter.mer"))
        assert got == want[p], (p, got, want[p])
    log(f"four: build-markers --mesh 4 {secs:.3f}s, markers "
        f"{[want[p][1] for p in want]}, peak bytes per device {pk}")
    if devs[0].platform == "gpu":
        assert min(pk) > 0.1 * max(pk), f"mesh left devices idle: {pk}"

    # a quarter of the markers: a 64 MiB table, still far larger than
    # L2, keeps the four-card run short
    sizes = dataclasses.replace(sizes, markers=sizes.markers // 4)
    shards = []
    shard_table = PM.shard_table

    def record(mesh, table):
        arr = shard_table(mesh, table)
        shards.append((table.data.shape[0],
                       sorted((s.device.id, s.data.shape[0])
                              for s in arr.addressable_shards)))
        return arr
    PM.shard_table = record
    try:
        _, h0, h1, fq, ref, info = beyond_l2_inputs(rng, sizes, work)
        for spec, tp in (("4x1", 1), ("2x2", 2)):
            out = os.path.join(work, f"mesh_{spec}.phased")
            secs = cli("classify", "--hap0", h0, "--hap1", h1, "--read", fq,
                       "--weight0", "1.04", "--mesh", spec, "--output", out)
            assert open(out, "rb").read() == ref, f"--mesh {spec} != ref"
            full, placed = shards.pop()
            assert len({dev for dev, _ in placed}) == 4, placed
            assert all(n == full // tp for _, n in placed), (full, placed)
            log(f"four: classify --mesh {spec} {secs:.3f}s, table shards "
                f"(device, rows) {placed}, peak bytes per device {peaks()}")
    finally:
        PM.shard_table = shard_table
    __graft_entry__.dryrun_multichip(4)


def main(argv=None, sizes: Sizes = FULL, require_gpu: bool = True,
         work: str | None = None) -> None:
    """The script's entry; tests rehearse it on the CPU backend with
    small `sizes`, require_gpu=False and their own `work` directory."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--four", action="store_true",
                    help="run only the mesh phases, on four devices")
    args = ap.parse_args(argv)
    device = phase_device(require_gpu, args.four)

    import jax
    log(f"compile cache: {enable_compile_cache()}")
    work = work or os.path.join(HERE, ".hast_work", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    if args.four:
        phase_four(rng, args.seed, sizes, work)
    else:
        probe = Probe()
        try:
            phase_goldens(work)
            probe.require("_classify_fastqs_device_tally", "tally_step",
                          "count_file_native")
            probe.take_phases()
            phase_trio(rng, args.seed, sizes, work, probe, jax.devices()[0])
            phase_beyond_l2(rng, sizes, work, probe)
        finally:
            probe.close()
    log(f"all phases passed in {time.perf_counter() - t0:.3f}s")
    shutil.rmtree(work)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
