"""Smoke tests: every CLI subcommand parses and runs on tiny inputs."""

import contextlib
import io
import pathlib
import sys

import pytest

from hast_jax.cli import main

GOLD = pathlib.Path(__file__).parent / "golden"


def run_cli(argv, stdout_bytes=False):
    buf = io.BytesIO()

    class W:
        buffer = buf

        def write(self, s):
            buf.write(s.encode())

        def flush(self):
            pass

    old = sys.stdout
    sys.stdout = W()
    try:
        main(argv)
    finally:
        sys.stdout = old
    return buf.getvalue()


def test_help_all_subcommands():
    import argparse
    for cmd in ("build-markers", "classify", "classify-reads",
                "merge-results", "prepare-10x", "assemble", "mkoutput",
                "classify-segments", "run", "mark-library", "classify-hic",
                "vcf-snp-only", "vcf-calc-hd", "draw-heatalign", "get-n",
                "check-genes", "plot-bounds", "filter-fastq-by-barcodes"):
        with pytest.raises(SystemExit):
            main([cmd, "--help"])


def test_vcf_subcommands_run():
    child = str(GOLD / "vcfqc" / "child.vcf")
    out = run_cli(["vcf-snp-info", child])
    assert out.count(b"\n") > 100


def test_mark_library_cli():
    fq = GOLD / "stage01" / "reads2.fq"
    out = run_cli(["mark-library", str(fq), "3"])
    assert b"#lib3_" in out


def test_filter_barcodes_cli(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the stats log appends to cwd
    bl = tmp_path / "list.txt"
    # grab a real barcode from the golden splits
    bc = (GOLD / "stage01" / "paternal.unique.barcodes.golden"
          ).read_bytes().splitlines()[0]
    bl.write_bytes(bc + b"\n")
    out = run_cli(["filter-fastq-by-barcodes",
                   str(GOLD / "stage01" / "reads2.fq"), str(bl)])
    assert bc in out


def test_heatalign_cli():
    ha = GOLD / "heatalign"
    out = run_cli(["draw-heatalign", "1100000",
                   "-i", str(ha / "H1.align.txt"), "--preset", "KIR"])
    assert out.startswith(b"<?xml") and b"</svg>" in out


def test_checkgenes_cli():
    ha = GOLD / "heatalign"
    out = run_cli(["check-genes", str(ha / "H1.align.txt"),
                   str(ha / "cg.genes.txt")])
    assert out.count(b"\n") == 3  # g1 deduped


def test_cli_classify_mesh_golden(tmp_path):
    """`classify --mesh DPxTP` through the CLI == the golden output."""
    import pathlib
    from hast_jax import cli

    gold = pathlib.Path(__file__).parent / "golden" / "stage01"
    out = tmp_path / "phased.mesh"
    cli.main([
        "classify", "--hap0", str(gold / "hap0.mer"),
        "--hap1", str(gold / "hap1.mer"),
        "--read", str(gold / "reads1.fq.gz"),
        "--read", str(gold / "reads2.fq"),
        "--weight0", "1.04", "--mesh", "4x2",
        "--batch-size", "4096", "--output", str(out),
    ])
    assert out.read_bytes() == (gold / "phased.barcodes.golden").read_bytes()


def test_cli_warmup_smoke(capsys):
    """`warmup` compiles and runs the production-path programs on tiny
    synthetic inputs without error and reports the cache dir."""
    from hast_jax import cli

    cli.main(["warmup", "--markers", "3000", "--reads", "256"])
    outerr = capsys.readouterr()
    assert "warm:" in outerr.out


def test_cli_build_markers_mesh_golden(tmp_path):
    """`build-markers --mesh auto` through the CLI matches the golden
    marker sets."""
    import pathlib
    from hast_jax import cli

    gold = pathlib.Path(__file__).parent / "golden" / "stage00"
    cli.main([
        "build-markers",
        "--paternal", str(gold / "paternal.reads.fa.gz"),
        "--maternal", str(gold / "maternal.reads.fa.gz"),
        "--auto_bounds", "--out-dir", str(tmp_path),
        "--batch-size", "4096", "--mesh", "auto",
    ])
    for p in ("paternal", "maternal"):
        ours = sorted((tmp_path / f"{p}.unique.filter.mer")
                      .read_bytes().split())
        want = sorted((gold / f"{p}.unique.filter.mer")
                      .read_bytes().split())
        assert ours == want, p


def test_cli_classify_reads_mesh_golden(tmp_path):
    """`classify-reads --mesh DPxTP` (stage-01 driver on a device mesh)
    == the golden phased.barcodes."""
    import pathlib
    from hast_jax import cli

    gold = pathlib.Path(__file__).parent / "golden" / "stage01"
    cli.main([
        "classify-reads",
        "--paternal_mer", str(gold / "hap0.mer"),
        "--maternal_mer", str(gold / "hap1.mer"),
        "--filial", str(gold / "reads1.fq.gz"),
        "--filial", str(gold / "reads2.fq"),
        "--workdir", str(tmp_path),
        "--batch-size", "4096", "--mesh", "4x2",
    ])
    assert (tmp_path / "phased.barcodes").read_bytes() == \
        (gold / "phased.barcodes.golden").read_bytes()


def test_cli_build_markers_mesh_rejects_tp(tmp_path, capsys):
    """'--mesh 4x2' used to silently run dp=4 ignoring the
    tp component; it must now be a clear error."""
    import pytest
    from hast_jax import cli

    with pytest.raises(SystemExit) as ei:
        cli.main(["build-markers", "--paternal", "x.fa",
                  "--maternal", "y.fa", "--mesh", "4x2",
                  "--out-dir", str(tmp_path)])
    assert "DP only" in str(ei.value)
