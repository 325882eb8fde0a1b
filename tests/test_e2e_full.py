"""Mock-Supernova end-to-end: `hast_jax run` chains 00→01→02→03.

stages 02/03 were only golden-tested in isolation.  A
fake `supernova` executable (emitting the golden pseudohap2 assembly,
which carries the e2e trio's marker k-mers) lets one `run` invocation
exercise the whole HAST.sh contract (HAST.sh:138-259): markers, bins,
fake-10X conversion, both assemblies, both re-phasing runs.  Final
fastas must be byte-identical to the reference stage-03 flow run on
the same assembly + mer files (scripts/make_golden_e2e_full.py).
"""

import os
import pathlib
import stat

import pytest

from hast_jax.cli import main as cli_main

GOLD = pathlib.Path(__file__).parent / "golden" / "e2e"
WHITELIST = pathlib.Path(__file__).parent / "golden" / "stage02" / \
    "whitelist.txt"

FAKE_SUPERNOVA = """#!/bin/bash
# fake Supernova: `run` makes the outs tree, `mkoutput` emits the
# golden pseudohap2 assembly (fasta.gz + idx) like the real
# `supernova mkoutput --style=pseudohap2 --index` would.
set -e
cmd="$1"; shift
case "$cmd" in
  run)
    mkdir -p haplotype/outs/assembly
    ;;
  mkoutput)
    prefix=output
    for a in "$@"; do
      case "$a" in --outprefix=*) prefix="${a#--outprefix=}";; esac
    done
    for w in 1 2; do
      gzip -c "%(asm)s/output.$w.fasta" > "$prefix.$w.fasta.gz"
      cp "%(asm)s/output.$w.idx" "$prefix.$w.idx"
    done
    ;;
  *) echo "fake supernova: unknown subcommand $cmd" >&2; exit 1;;
esac
"""


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    wd = tmp_path_factory.mktemp("e2e_full")
    # fake supernova install: executable + the whitelist path the
    # drivers glob for (assemble_by_supernova.sh:97)
    sn = wd / "supernova_install"
    bcdir = sn / "supernova-cs" / "2.1.1" / "tenkit" / "lib" / "python" / \
        "tenkit" / "barcodes"
    bcdir.mkdir(parents=True)
    (bcdir / "4M-with-alts-february-2016.txt").write_bytes(
        WHITELIST.read_bytes())
    exe = sn / "supernova"
    exe.write_text(FAKE_SUPERNOVA % {"asm": GOLD / "assembly"})
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)

    run_dir = wd / "run"
    run_dir.mkdir()
    cli_main(["run", "--paternal", str(GOLD / "paternal.fa.gz"),
              "--maternal", str(GOLD / "maternal.fa.gz"),
              "--read1", str(GOLD / "son.r1.fq.gz"),
              "--read2", str(GOLD / "son.r2.fq"),
              "--supernova", str(sn), "--workdir", str(run_dir)])
    return run_dir


def test_final_fastas_bit_identical(full_run):
    for parent, fa in (("paternal", "father"), ("maternal", "mother")):
        d03 = full_run / f"03.{parent}_output"
        want = GOLD / f"stage03_{parent}"
        for name in (f"output.{fa}.fa", f"output.{fa}.idx",
                     "output.supplement.fa"):
            assert (d03 / name).read_bytes() == \
                (want / name).read_bytes(), (parent, name)


def test_stage02_artifacts_produced(full_run):
    for parent in ("maternal", "paternal"):
        d02 = full_run / f"02.{parent}_assembly"
        for name in ("barcode_freq.txt", "merge.txt",
                     "SampleName_S1_L001_R1_001.fastq.gz",
                     "SampleName_S1_L001_R2_001.fastq.gz",
                     "output.1.fasta", "output.2.fasta",
                     "output.1.idx", "output.2.idx"):
            assert (d02 / name).exists(), (parent, name)


def test_stage01_bins_match_golden(full_run):
    d01 = full_run / "01.classify_reads"
    assert (d01 / "phased.barcodes").read_bytes() == \
        (GOLD / "stage01" / "phased.barcodes").read_bytes()
