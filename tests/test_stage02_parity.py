"""Stage-02 parity: barcode freq table and fake-10X rewriting."""

import gzip
import pathlib

from hast_jax.pipeline import tenx as T

GOLD = pathlib.Path(__file__).parent / "golden" / "stage02"


def test_barcode_freq_matches_awk():
    freq = T.barcode_freq([str(GOLD / "bin.r1.fq.gz")])
    golden = {}
    for line in (GOLD / "barcode_freq.golden").read_bytes().splitlines():
        bc, n = line.split(b"\t")
        golden[bc] = int(n)
    assert freq == golden


def test_fake_10x_bit_identical(tmp_path):
    mapping = {}
    for line in (GOLD / "merge.txt").read_bytes().splitlines():
        cols = line.split(b"\t")
        mapping[cols[0]] = cols[1]
    total, used = T.fake_10x(str(GOLD / "bin.r1.fq.gz"),
                             str(GOLD / "bin.r2.fq.gz"), mapping,
                             out_dir=str(tmp_path))
    assert total == 800
    for which in (1, 2):
        with gzip.open(tmp_path / f"SampleName_S1_L001_R{which}_001.fastq.gz") as f:
            ours = f.read()
        golden = (GOLD / f"R{which}.fastq.golden").read_bytes()
        assert ours == golden, which


def test_merge_barcodes_semantics(tmp_path):
    freq = {b"1_1_1": 5, b"2_2_2": 3, b"0_0_0": 9, b"3_3_3": 1,
            b"barcode_str": 4, b"4_4_4": 2}
    wl = tmp_path / "wl.txt"
    wl.write_bytes(b"AAAA\nCCCC\n")
    mapping = T.merge_barcodes(freq, str(wl), str(tmp_path / "merge.txt"),
                               min_rp=2)
    # 3 valid barcodes (freq>=2, non-null), 2 whitelist -> ratio 2
    assert len(mapping) == 3
    assert list(mapping.values()) == [b"AAAA", b"AAAA", b"CCCC"]
