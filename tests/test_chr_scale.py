"""Chr-scale trio run (BASELINE.json config 4 shape), env-gated.

Default is a 5 MB genome so table growth, DeviceCounter folds and
accumulator growth are actually exercised in CI; set HAST_CHR_SCALE_MB
to shrink (fast smoke) or stress a larger synthetic chromosome.
Exercises: counting -> auto bounds -> markers -> sharded-table classify
on the 8-device CPU mesh -> merge parity between the sharded run and
the single-device run.
"""

import os
import pathlib

import numpy as np
import pytest

import jax

from hast_jax.pipeline import classify as C
from hast_jax.pipeline import markers as M
from hast_jax.parallel import mesh as PM
from hast_jax.utils import synthetic as S


SCALE_MB = float(os.environ.get("HAST_CHR_SCALE_MB", "5"))


@pytest.mark.slow
def test_chr_scale_sharded_vs_single(tmp_path):
    length = int(SCALE_MB * 1_000_000)
    pat_g, mat_g = S.make_trio_genomes(seed=5150, length=length,
                                       het_rate=0.004)
    pat_fa = tmp_path / "pat.fa.gz"
    mat_fa = tmp_path / "mat.fa.gz"
    S.make_parent_reads(51, pat_g, str(pat_fa), coverage=25.0,
                        err_rate=0.002)
    S.make_parent_reads(52, mat_g, str(mat_fa), coverage=25.0,
                        err_rate=0.002)

    paths = M.build_unshared_markers(
        [str(pat_fa)], [str(mat_fa)], str(tmp_path), auto_bounds=True,
        batch_size=8192)
    n_markers = sum(1 for _ in open(paths["paternal"]))
    assert n_markers > 50, n_markers

    # filial reads from both haplotypes
    import gzip
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    rng = np.random.default_rng(53)
    genomes = [np.frombuffer(pat_g, np.uint8),
               np.frombuffer(mat_g, np.uint8)]
    fq = tmp_path / "son.fq"
    n_reads = max(2000, length // 50)
    with open(fq, "wb") as f:
        for i in range(n_reads):
            hap = int(rng.integers(0, 2))
            p = int(rng.integers(0, length - 100))
            s = genomes[hap][p:p + 100].tobytes()
            if rng.integers(0, 2):
                s = s.translate(comp)[::-1]
            bc = b"%d_%d_%d" % tuple(rng.integers(1, 999, 3))
            f.write(b"@C%08d#%s/1\n%s\n+\n%s\n" % (i, bc, s, b"F" * 100))

    table = C.load_marker_table(paths["paternal"], paths["maternal"])
    C.erase_adaptors(table)

    import io
    single = C.classify_fastqs(table, [str(fq)], batch_size=2048)
    out1 = io.BytesIO()
    C.write_phased_barcodes(single, table, out1, w0=1.04)

    mesh = PM.make_mesh(8, tp=2)
    sharded = C.classify_fastqs_mesh(mesh, table, [str(fq)],
                                     batch_size=2048)
    out2 = io.BytesIO()
    C.write_phased_barcodes(sharded, table, out2, w0=1.04)
    assert out1.getvalue() == out2.getvalue()

    # sanity: the trio signal assigns a meaningful share of barcodes
    # (most 100bp reads don't overlap a het marker at 0.4% SNP rate)
    rows = out1.getvalue().splitlines()
    haps = [r.split(b"\t")[1] for r in rows]
    classified = sum(1 for h in haps if h in (b"0", b"1"))
    assert classified > len(rows) * 0.05
    assert b"0" in haps and b"1" in haps


@pytest.mark.slow
def test_partitioned_count_at_scale(tmp_path):
    """HBM-bounded multi-pass counting on a larger genome at coverage.

    Default input is sized by HAST_PART_SCALE_MB (2 MB in CI — table
    growth + 4 passes still run); set it to 50 for the full gated run
    (a ~50 MB genome at 30x counted on one chip without OOM).
    """
    import os
    mb = float(os.environ.get("HAST_PART_SCALE_MB", "2"))
    from hast_jax.utils import synthetic as S
    import numpy as np
    rng = np.random.default_rng(11)
    genome = S.make_genome(rng, int(mb * 1e6))
    reads = tmp_path / "reads.fa"
    S.make_parent_reads(5, genome, str(reads), coverage=30.0 if mb >= 50
                        else 6.0, read_len=100)
    from hast_jax.pipeline import markers as M
    got = M.count_files([str(reads)], 21, batch_size=16384, n_parts=4)
    assert got.n_distinct > 0
    assert np.all(np.diff(got.words.astype(np.uint64)) > 0)
    if mb < 10:  # cross-check against the one-pass counter when cheap
        want = M.count_files([str(reads)], 21, batch_size=16384)
        np.testing.assert_array_equal(got.words, want.words)
        np.testing.assert_array_equal(got.counts, want.counts)
