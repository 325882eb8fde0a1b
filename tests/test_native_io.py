"""Native hastio reader vs the pure-python reader (must be identical)."""

import pathlib

import numpy as np
import pytest

from hast_jax.io import fastq as FQ

GOLD = pathlib.Path(__file__).parent / "golden" / "stage01"


def _native():
    from hast_jax.io import native as N
    N.get_lib()
    return N


@pytest.mark.parametrize("name", ["reads1.fq.gz", "reads2.fq"])
def test_native_matches_python(name):
    N = _native()
    path = str(GOLD / name)
    reader = N.NativeFastqReader(path, batch_size=512, len_cap=256)
    nat = []
    for b in reader:
        for i in range(b.n):
            L = int(b.lengths[i])
            nat.append((b.seqs[i, :L].tobytes(), bool(b.has_n[i]),
                        int(b.barcode_ids[i])))
    barcodes = reader.barcodes()
    reader.close()

    py = []
    py_bc = {}
    for head, seq, _, _ in FQ.fastq_records(path):
        bc = FQ.parse_barcode(head)
        if bc not in py_bc:
            py_bc[bc] = len(py_bc)
        py.append((seq, b"N" in seq, py_bc[bc]))

    assert len(nat) == len(py)
    for a, b in zip(nat, py):
        assert a == b
    assert barcodes == list(py_bc)


def test_native_long_reads_truncate():
    N = _native()
    import tempfile, os
    with tempfile.NamedTemporaryFile("wb", suffix=".fq", delete=False) as f:
        f.write(b"@r#1_2_3/1\n" + b"A" * 3000 + b"\n+\n" + b"F" * 3000 + b"\n")
        path = f.name
    reader = N.NativeFastqReader(path, batch_size=4, len_cap=1024)
    with pytest.raises(RuntimeError):
        list(reader)  # truncation now fails fast instead of silently
    os.unlink(path)
    # a large-enough cap handles the same read fine
    with tempfile.NamedTemporaryFile("wb", suffix=".fq",
                                     delete=False) as f:
        f.write(b"@r#1_2_3/1\n" + b"A" * 3000 + b"\n+\n"
                + b"F" * 3000 + b"\n")
        path2 = f.name
    reader3 = N.NativeFastqReader(path2, batch_size=4, len_cap=4096)
    batches = list(reader3)
    os.unlink(path2)
    assert batches[0].lengths[0] == 3000


def test_sequence_batches_fallback_no_double_count(tmp_path):
    """A >len_cap read mid-file must not re-yield earlier records.

    sequence_batches uses the native reader (len_cap=8192); when the
    over-long read trips hastio_truncated mid-stream, the python
    fallback must resume after the records already yielded, not restart
    the file (regression for the round-2 double-count finding).
    """
    _native()
    path = tmp_path / "long.fq"
    with open(path, "wb") as f:
        for i in range(40):
            f.write(b"@a%d#1_2_3/1\nACGTACGTACGT\n+\nFFFFFFFFFFFF\n" % i)
        f.write(b"@big#9_9_9/1\n" + b"C" * 9000 + b"\n+\n" + b"F" * 9000
                + b"\n")
        for i in range(40):
            f.write(b"@b%d#4_5_6/1\nTTTTGGGGCCCC\n+\nFFFFFFFFFFFF\n" % i)

    got = []
    for batch in FQ.sequence_batches(str(path), k=5, batch_size=8):
        for i in range(batch.n):
            L = int(batch.lengths[i])
            got.append(batch.seqs[i, :L].tobytes())
    want = [seq for _, seq, _, _ in FQ.fastq_records(str(path))]
    assert got == want


def test_native_quarter_matches_python(tmp_path, monkeypatch):
    N = _native()
    import io
    from hast_jax.pipeline import partition as P
    monkeypatch.chdir(tmp_path)
    (tmp_path / "py").mkdir()
    (tmp_path / "nat").mkdir()
    args = (str(GOLD / "reads2.fq"),
            str(GOLD / "paternal.unique.barcodes.golden"),
            str(GOLD / "maternal.unique.barcodes.golden"),
            str(GOLD / "homozygous.unique.barcodes.golden"))
    monkeypatch.chdir(tmp_path / "py")
    s1 = P.quarter_fastq(*args, err=io.StringIO())  # python path
    monkeypatch.chdir(tmp_path / "nat")
    s2 = N.native_quarter(args[0], "reads2.fq", *args[1:],
                          log_path="filter_reads.log")
    assert s1 == s2
    for name in ("paternal", "maternal", "homozygous", "nobarcode"):
        f = f"reads2.fq.{name}.fastq"
        a = (tmp_path / "py" / f)
        b = (tmp_path / "nat" / f)
        assert a.exists() == b.exists(), name
        if a.exists():
            assert a.read_bytes() == b.read_bytes(), name
    assert (tmp_path / "py" / "filter_reads.log").read_bytes() == \
        (tmp_path / "nat" / "filter_reads.log").read_bytes()


@pytest.mark.parametrize("name", ["reads1.fq.gz", "reads2.fq"])
def test_native_packed_matches_host_pack(name):
    """packed=True rows == pack_codes_np(ASCII rows), bit-for-bit."""
    from hast_jax.ops.encode import pack_codes_np
    N = _native()
    path = str(GOLD / name)
    plain = list(N.NativeFastqReader(path, batch_size=512, len_cap=256))
    packed = list(N.NativeFastqReader(path, batch_size=512, len_cap=256,
                                      packed=True))
    assert len(plain) == len(packed)
    for a, b in zip(plain, packed):
        assert a.n == b.n
        assert np.array_equal(a.lengths, b.lengths)
        assert np.array_equal(a.has_n, b.has_n)
        assert np.array_equal(a.barcode_ids, b.barcode_ids)
        # ASCII rows are zero-padded; (0>>1)&3 == 0, so packing the
        # padded row matches the padded packed row exactly
        assert np.array_equal(pack_codes_np(a.seqs), b.seqs)


def test_native_count_clean_and_dirty_parity(tmp_path):
    """The clean-batch fast path (validity derived from lengths, no
    good-mask upload) and the dirty path (N-containing reads) must both
    match the python counting engine exactly."""
    import numpy as np

    from hast_jax.ops import kmer_count as KC
    from hast_jax.io import fastq as FQ

    rng = np.random.default_rng(23)
    B = np.frombuffer(b"ACGT", np.uint8)
    k = 21

    def reads(n, with_n):
        out = []
        for i in range(n):
            s = bytearray(B[rng.integers(0, 4, 80)].tobytes())
            if with_n and i % 7 == 0:
                s[int(rng.integers(0, 80))] = ord("N")
            out.append(bytes(s))
        return out

    for tag, with_n in (("clean", False), ("dirty", True)):
        path = tmp_path / f"{tag}.fq"
        with open(path, "wb") as f:
            for i, s in enumerate(reads(300, with_n)):
                f.write(b"@r%d#1_1_1/1\n%s\n+\n%s\n"
                        % (i, s, b"F" * len(s)))
        native = KC.count_file_native(str(path), k, batch_size=64)
        assert native is not None, tag
        want = KC.count_batches(
            FQ.sequence_batches(str(path), k, 64), k)
        np.testing.assert_array_equal(native.words, want.words, tag)
        np.testing.assert_array_equal(native.counts, want.counts, tag)
