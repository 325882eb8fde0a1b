"""End-to-end synthetic trio: our stage00+stage01 chain vs reference.

The golden chain ran the reference jellyfish pipeline and classify
binary on the same inputs (scripts/make_golden_e2e.py); here the full
pipeline (orchestrated through the CLI like a user would) must
reproduce the final phased.barcodes, barcode lists, and partitioned
fastq bins byte-for-byte.
"""

import os
import pathlib

import pytest

from hast_jax.cli import main as cli_main

GOLD = pathlib.Path(__file__).parent / "golden" / "e2e"


@pytest.fixture(scope="module")
def pipeline_run(tmp_path_factory):
    wd = tmp_path_factory.mktemp("e2e")
    d00, d01 = wd / "00", wd / "01"
    d00.mkdir(), d01.mkdir()
    cli_main(["build-markers", "--out-dir", str(d00), "--auto_bounds",
              "--paternal", str(GOLD / "paternal.fa.gz"),
              "--maternal", str(GOLD / "maternal.fa.gz"),
              "--batch-size", "16384"])
    cli_main(["classify-reads",
              "--paternal_mer", str(d00 / "paternal.unique.filter.mer"),
              "--maternal_mer", str(d00 / "maternal.unique.filter.mer"),
              "--filial", str(GOLD / "son.r1.fq.gz"),
              "--filial", str(GOLD / "son.r2.fq"),
              "--workdir", str(d01), "--batch-size", "4096"])
    return d00, d01


def test_markers_match(pipeline_run):
    d00, _ = pipeline_run
    for parent in ("paternal", "maternal"):
        ours = sorted((d00 / f"{parent}.unique.filter.mer")
                      .read_bytes().split())
        golden = sorted((GOLD / f"{parent}.unique.filter.mer")
                        .read_bytes().split())
        assert ours == golden, parent


def test_phased_barcodes_match(pipeline_run):
    _, d01 = pipeline_run
    assert (d01 / "phased.barcodes").read_bytes() == \
        (GOLD / "stage01" / "phased.barcodes").read_bytes()


def test_partitioned_fastqs_match(pipeline_run):
    _, d01 = pipeline_run
    for r in (1, 2):
        for bin_name in ("paternal", "maternal", "homozygous", "nobarcode"):
            name = f"son.r{r}.fq.{bin_name}.fastq"
            golden = GOLD / "stage01" / name
            ours = d01 / name
            if golden.exists():
                assert ours.read_bytes() == golden.read_bytes(), name
            else:
                assert not ours.exists(), name


def test_checkpoint_markers_written(pipeline_run):
    d00, d01 = pipeline_run
    assert (d00 / "step_00_markers_done").exists()
    for s in ("9", "10", "11"):
        assert (d01 / f"step_{s}_done").exists()


def test_rerun_skips_completed_steps(pipeline_run):
    """step_NN_done markers make reruns no-ops (reference resume
    contract, classify_stlfr_reads.sh:146-190)."""
    import os
    _, d01 = pipeline_run
    phased = d01 / "phased.barcodes"
    before = os.stat(phased).st_mtime_ns
    cli_main(["classify-reads",
              "--paternal_mer", "unused.mer", "--maternal_mer", "unused.mer",
              "--filial", "also-unused.fq", "--workdir", str(d01)])
    assert os.stat(phased).st_mtime_ns == before
