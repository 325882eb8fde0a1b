"""Deterministic synthetic trio fixtures for tests and benchmarks.

Generates stLFR-style filial fastq plus parental unique-marker files in
the shapes the reference pipeline consumes.  Everything is seeded so
golden files regenerate bit-identically.
"""

from __future__ import annotations

import gzip

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)


def _rand_seq(rng, n) -> bytes:
    return BASES[rng.integers(0, 4, n)].tobytes()


def make_genome(rng, length: int) -> bytes:
    return _rand_seq(rng, length)


def make_trio_genomes(seed: int, length: int, het_rate: float = 0.01):
    """A child diploid: shared backbone + per-haplotype SNPs.

    Returns (paternal, maternal) genome byte strings.
    """
    rng = np.random.default_rng(seed)
    base = np.frombuffer(make_genome(rng, length), np.uint8).copy()
    pat, mat = base.copy(), base.copy()
    n_snp = int(length * het_rate)
    pos = rng.choice(length, size=n_snp, replace=False)
    for p in pos:
        cur = pat[p]
        alt = BASES[rng.integers(0, 4)]
        while alt == cur:
            alt = BASES[rng.integers(0, 4)]
        if rng.integers(0, 2):
            pat[p] = alt
        else:
            mat[p] = alt
    return pat.tobytes(), mat.tobytes()


def make_marker_files(seed: int, n_markers: int, k: int,
                      hap0_path: str, hap1_path: str,
                      plant_adaptor: bool = True):
    """Two disjoint random marker lists (+ optionally adaptor k-mers).

    Adaptor k-mers planted into the sets exercise the reference's
    InitAdaptor erasure path.  Markers are emitted AS-IS (not
    necessarily canonical), matching jellyfish dump text.
    """
    rng = np.random.default_rng(seed)
    sets: list[list[bytes]] = [[], []]
    from hast_jax.ops.encode import str_to_kmer
    canon_seen: set[tuple[int, int]] = set()
    for h in (0, 1):
        while len(sets[h]) < n_markers:
            m = _rand_seq(rng, k)
            c = str_to_kmer(m.decode())
            if c in canon_seen:
                continue
            canon_seen.add(c)
            sets[h].append(m)
    if plant_adaptor:
        from hast_jax.pipeline.classify import ADAPTOR_F, ADAPTOR_R
        for h, ad in ((0, ADAPTOR_F), (1, ADAPTOR_R)):
            for i in (0, 5, len(ad) - k):
                sets[h].append(ad[i:i + k].encode())
    for path, rows in ((hap0_path, sets[0]), (hap1_path, sets[1])):
        with open(path, "wb") as f:
            f.write(b"\n".join(rows) + b"\n")
    return sets


def make_classify_fastq(seed: int, path: str, markers0: list[bytes],
                        markers1: list[bytes], n_reads: int,
                        read_len: int = 100, n_barcodes: int = 200):
    """stLFR fastq exercising the classify decision space.

    Includes: reads with planted hap0/hap1 marker k-mers (forward and
    revcomp), pure-random reads, N reads, null barcodes, degenerate
    IUPAC letters (which the reference encodes as garbage), heads with
    extra '#' and '/' characters, and missing-barcode heads.
    """
    rng = np.random.default_rng(seed)
    comp = bytes.maketrans(b"ACGT", b"TGCA")

    def revcomp(s: bytes) -> bytes:
        return s.translate(comp)[::-1]

    barcodes = [b"%d_%d_%d" % (rng.integers(1, 1500), rng.integers(1, 1500),
                               rng.integers(1, 1500))
                for _ in range(n_barcodes)]
    barcodes += [b"0_0_0", b"0_0", b"0"]

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        for i in range(n_reads):
            bc = barcodes[int(rng.integers(0, len(barcodes)))]
            seq = bytearray(_rand_seq(rng, read_len))
            mode = int(rng.integers(0, 10))
            if mode < 3:  # plant hap0 markers
                for _ in range(int(rng.integers(1, 4))):
                    m = markers0[int(rng.integers(0, len(markers0)))]
                    if rng.integers(0, 2):
                        m = revcomp(m)
                    p = int(rng.integers(0, read_len - len(m) + 1))
                    seq[p:p + len(m)] = m
            elif mode < 6:  # plant hap1 markers
                for _ in range(int(rng.integers(1, 4))):
                    m = markers1[int(rng.integers(0, len(markers1)))]
                    if rng.integers(0, 2):
                        m = revcomp(m)
                    p = int(rng.integers(0, read_len - len(m) + 1))
                    seq[p:p + len(m)] = m
            elif mode == 6:  # both haps -> contested barcode
                m0 = markers0[int(rng.integers(0, len(markers0)))]
                m1 = markers1[int(rng.integers(0, len(markers1)))]
                seq[0:len(m0)] = m0
                seq[len(m0) + 2:len(m0) + 2 + len(m1)] = m1
            if mode == 7:  # N read
                seq[int(rng.integers(0, read_len))] = ord("N")
            if mode == 8:  # degenerate letters (reference encodes garbage)
                seq[int(rng.integers(0, read_len))] = b"YRWSKMn"[
                    int(rng.integers(0, 7))]
            style = int(rng.integers(0, 12))
            if style == 0:
                head = b"@weird#extra#%s/1" % bc
            elif style == 1:
                head = b"@slash/inside#%s/2" % bc
            elif style == 2:
                head = b"@nobarcode_read_%d" % i
            else:
                head = b"@V300017823L1C001R%08d#%s/%d" % (
                    i, bc, 1 + (i & 1))
            qual = bytes([33 + int(rng.integers(0, 40))
                          for _ in range(read_len)])
            f.write(head + b"\n" + bytes(seq) + b"\n+\n" + qual + b"\n")


def make_parent_reads(seed: int, genome: bytes, path: str, coverage: float,
                      read_len: int = 100, err_rate: float = 0.0):
    """Shotgun fasta reads from a genome (for stage-00 counting tests)."""
    rng = np.random.default_rng(seed)
    g = np.frombuffer(genome, np.uint8)
    n_reads = int(len(genome) * coverage / read_len)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        for i in range(n_reads):
            p = int(rng.integers(0, len(genome) - read_len + 1))
            seq = g[p:p + read_len].copy()
            if err_rate > 0:
                n_err = rng.binomial(read_len, err_rate)
                for _ in range(n_err):
                    seq[int(rng.integers(0, read_len))] = BASES[
                        int(rng.integers(0, 4))]
            s = seq.tobytes()
            if rng.integers(0, 2):
                s = s.translate(comp)[::-1]
            f.write(b">r%d\n%s\n" % (i, s))


def make_parent_reads_vectorized(seed: int, genome: bytes, path: str,
                                 coverage: float, read_len: int = 100,
                                 err_rate: float = 0.0):
    """Vectorized twin of :func:`make_parent_reads` for bench-scale
    inputs (1M+ reads in seconds; the per-read loop above is kept
    as-is because golden fixtures pin its exact RNG stream).

    Conventions differ deliberately: anonymous ">r" headers, per-base
    i.i.d. substitution errors, and an independent reverse-complement
    coin per read — equivalent shotgun statistics, not byte-equal
    output.
    """
    rng = np.random.default_rng(seed)
    g = np.frombuffer(genome, np.uint8)
    n = int(len(genome) * coverage / read_len)
    comp = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    pos = rng.integers(0, len(genome) - read_len + 1, n)
    reads = g[pos[:, None] + np.arange(read_len)]
    if err_rate > 0:
        err = rng.random((n, read_len)) < err_rate
        reads = np.where(err, BASES[rng.integers(0, 4, (n, read_len))],
                         reads)
    flip = rng.integers(0, 2, n).astype(bool)
    reads[flip] = comp[reads[flip][:, ::-1]]
    with open(path, "wb", buffering=1 << 22) as f:
        head = np.frombuffer(b">r\n", np.uint8)
        chunk = 1 << 18
        for s in range(0, n, chunk):
            e = min(n, s + chunk)
            block = np.concatenate(
                [np.broadcast_to(head, (e - s, 3)), reads[s:e],
                 np.full((e - s, 1), ord("\n"), np.uint8)], axis=1)
            f.write(block.tobytes())
    return n
