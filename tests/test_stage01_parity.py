"""Bit-parity of stage 01 against the reference binaries' golden output.

Golden fixtures in tests/golden/stage01 were produced by the REFERENCE
classify binary (weight0=1.04, as the reference driver uses) and the
reference quartering awk (see scripts/make_golden_stage01.py).
"""

import io
import pathlib

import pytest

from hast_jax.pipeline import classify as C
from hast_jax.pipeline import partition as P

GOLD = pathlib.Path(__file__).parent / "golden" / "stage01"


@pytest.fixture(scope="module")
def phased_output(tmp_path_factory):
    out = io.BytesIO()
    C.run_classify(
        str(GOLD / "hap0.mer"), str(GOLD / "hap1.mer"),
        [str(GOLD / "reads1.fq.gz"), str(GOLD / "reads2.fq")],
        out, w0=1.04, batch_size=4096)
    return out.getvalue()


def test_phased_barcodes_bit_identical(phased_output):
    golden = (GOLD / "phased.barcodes.golden").read_bytes()
    assert phased_output == golden


def test_barcode_splits(phased_output, tmp_path):
    phased = tmp_path / "phased.barcodes"
    phased.write_bytes(phased_output)
    P.split_barcodes(str(phased), out_prefix=str(tmp_path) + "/")
    for name in ("paternal", "maternal", "homozygous"):
        ours = (tmp_path / f"{name}.unique.barcodes").read_bytes()
        golden = (GOLD / f"{name}.unique.barcodes.golden").read_bytes()
        assert ours == golden, name


def test_quartering_bit_identical(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    err = io.StringIO()
    P.quarter_fastq(
        str(GOLD / "reads2.fq"),
        str(GOLD / "paternal.unique.barcodes.golden"),
        str(GOLD / "maternal.unique.barcodes.golden"),
        str(GOLD / "homozygous.unique.barcodes.golden"),
        err=err)
    for name in ("paternal", "maternal", "homozygous", "nobarcode"):
        f = tmp_path / f"reads2.fq.{name}.fastq"
        golden_f = GOLD / "quarter" / f"reads2.fq.{name}.fastq"
        if golden_f.exists():
            assert f.read_bytes() == golden_f.read_bytes(), name
        else:
            assert not f.exists(), name
    # stats block of filter_reads.log (skip the FILENAME first line —
    # the golden was produced with an absolute path)
    ours = (tmp_path / "filter_reads.log").read_bytes().split(b"\n")[1:]
    golden = (GOLD / "quarter" / "filter_reads.log").read_bytes().split(
        b"\n")[1:]
    assert ours == golden
    # unknown-barcode stderr lines match the reference awk's
    golden_err = (GOLD / "quarter" / "quarter.stderr").read_text()
    assert err.getvalue() == golden_err


def test_edge_marker_files_bit_identical():
    """Duplicate lines, reverse-complement duplicates and k-mers shared
    between both marker files (reference keeps them in both sets and a
    hit votes for both haplotypes)."""
    out = io.BytesIO()
    C.run_classify(str(GOLD / "edge.hap0.mer"), str(GOLD / "edge.hap1.mer"),
                   [str(GOLD / "edge.fq")], out, w0=1.04, batch_size=4096)
    assert out.getvalue() == (GOLD / "edge.phased.golden").read_bytes()


def test_k31_bit_identical():
    """Maximum supported k (31): hi word uses all 30 payload-free bits."""
    out = io.BytesIO()
    C.run_classify(str(GOLD / "k31.hap0.mer"), str(GOLD / "k31.hap1.mer"),
                   [str(GOLD / "k31.fq")], out, w0=1.04, batch_size=2048)
    assert out.getvalue() == (GOLD / "k31.phased.golden").read_bytes()


def test_k15_bit_identical():
    """Small k (15): hi word is all payload, lo carries the whole kmer."""
    out = io.BytesIO()
    C.run_classify(str(GOLD / "k15.hap0.mer"), str(GOLD / "k15.hap1.mer"),
                   [str(GOLD / "k15.fq")], out, w0=1.04, batch_size=2048)
    assert out.getvalue() == (GOLD / "k15.phased.golden").read_bytes()


def test_fetch_acc_packed_overflow():
    """_fetch_acc reconstructs int32 tallies exactly, including counts
    past the uint16 low half and the raw-int32 fallback path."""
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(7)
    acc = rng.integers(0, 200, (4096, 3)).astype(np.int32)
    # sprinkle large counts across both columns and rows
    rows = rng.integers(0, 4096, 50)
    acc[rows, rng.integers(0, 3, 50)] = rng.integers(
        1 << 16, 1 << 30, 50).astype(np.int32)
    got = C._fetch_acc(jnp.asarray(acc))
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, acc.astype(np.int64))

    # no overflow anywhere -> pure uint16 image path
    small = rng.integers(0, 60000, (4096, 3)).astype(np.int32)
    got = C._fetch_acc(jnp.asarray(small))
    np.testing.assert_array_equal(got, small.astype(np.int64))


def test_stride_budget_mixed_lengths(tmp_path):
    """Mixed read lengths past the stride budget still classify
    identically (coarse 128-base rounding only adds masked padding)."""
    import gzip
    import numpy as np
    from hast_jax.pipeline import classify as C

    # budget object behavior
    sb = C._StrideBudget(budget=2)
    assert sb.round(28) == 28 and sb.round(44) == 44      # exact
    assert sb.round(28) == 28                              # seen
    assert sb.round(50) == 64                              # coarse 32-mult
    assert sb.round(64) == 64

    table = C.load_marker_table(str(GOLD / "hap0.mer"),
                                str(GOLD / "hap1.mer"))
    C.erase_adaptors(table)
    table.device_put()

    # build a mixed-length fastq from the golden reads: truncate to
    # varying lengths so many distinct strides appear
    rng = np.random.default_rng(5)
    out = tmp_path / "mixed.fq"
    with gzip.open(GOLD / "reads1.fq.gz", "rb") as f, \
            open(out, "wb") as w:
        rec = []
        for line in f:
            rec.append(line.rstrip(b"\n"))
            if len(rec) == 4:
                L = int(rng.integers(40, len(rec[1]) + 1))
                w.write(rec[0] + b"\n" + rec[1][:L] + b"\n+\n"
                        + rec[3][:L] + b"\n")
                rec = []
    import io
    a = io.BytesIO()
    t1 = C.classify_fastqs(table, [str(out)], batch_size=512)
    C.write_phased_barcodes(t1, table, a, w0=1.04)
    b = io.BytesIO()
    t2 = C.classify_fastqs(table, [str(out)], batch_size=4096,
                           engine="python")
    C.write_phased_barcodes(t2, table, b, w0=1.04)
    assert a.getvalue() == b.getvalue()
