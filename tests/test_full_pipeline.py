"""Full HAST.sh-equivalent orchestration with a mock Supernova.

Stages 00-01 run for real on the e2e fixtures; a stub `supernova`
binary emits the stage-03 golden pseudohap2 assembly, so stage 02's
conversion glue and stage 03's re-phasing run end-to-end through the
orchestrator exactly as HAST.sh would drive them.  The paternal stage-03
outputs must equal the stage-03 goldens (same assembly + marker files).
"""

import gzip
import os
import pathlib
import shutil
import stat

import pytest

from hast_jax.models.trio import TrioBinningPipeline

E2E = pathlib.Path(__file__).parent / "golden" / "e2e"
S03 = pathlib.Path(__file__).parent / "golden" / "stage03"


def make_mock_supernova(root: pathlib.Path) -> str:
    """A supernova install whose mkoutput emits the golden assembly."""
    sn_dir = root / "supernova_home"
    wl = (sn_dir / "supernova-cs" / "1.0" / "tenkit" / "lib" / "python"
          / "tenkit" / "barcodes")
    wl.mkdir(parents=True)
    # tiny whitelist: enough 16bp barcodes for the fixture
    with open(wl / "4M-with-alts-february-2016.txt", "w") as f:
        bases = "ACGT"
        for i in range(512):
            s = "".join(bases[(i >> (2 * j)) & 3] for j in range(8))
            f.write(s + s[::-1] + "\n")
    script = sn_dir / "supernova"
    script.write_text(f"""#!/bin/bash
# mock supernova: `run` makes the asm dir; `mkoutput` copies the golden
# pseudohap2 fixture (gzipped) to --outprefix
cmd="$1"; shift
if [ "$cmd" = run ]; then
    mkdir -p haplotype/outs/assembly
    exit 0
fi
prefix=output
for a in "$@"; do case "$a" in --outprefix=*) prefix="${{a#--outprefix=}}";; esac; done
for i in 1 2; do
    gzip -c {S03}/assembly/output.$i.fasta > "$prefix.$i.fasta.gz"
    cp {S03}/assembly/output.$i.idx "$prefix.$i.idx"
done
""")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(sn_dir)


@pytest.mark.slow
def test_full_run_with_mock_supernova(tmp_path):
    sn = make_mock_supernova(tmp_path)
    wd = tmp_path / "wd"
    wd.mkdir()
    result = TrioBinningPipeline(
        paternal=[str(E2E / "paternal.fa.gz")],
        maternal=[str(E2E / "maternal.fa.gz")],
        read1=[str(E2E / "son.r1.fq.gz")],
        read2=[str(E2E / "son.r2.fq")],
        supernova=sn, workdir=str(wd), batch_size=4096).run()

    # stage 02 produced fake-10X inputs in both assembly dirs
    for parent in ("maternal", "paternal"):
        d02 = wd / f"02.{parent}_assembly"
        assert (d02 / "SampleName_S1_L001_R1_001.fastq.gz").exists()
        assert (d02 / "merge.txt").exists()
        assert (d02 / "output.1.fasta").exists()  # gunzipped by wrapper

    # stage 03 paternal outputs equal the stage-03 goldens (the mock
    # assembly and the marker files are the stage-03 fixtures)
    d03 = wd / "03.paternal_output"
    # markers differ from stage-03 fixture ones, so compare structure
    # files that depend only on the assembly:
    for name in ("output.phb.1.fa", "output.phb.2.fa", "output.homo.fa"):
        assert (d03 / name).read_bytes() == (S03 / name).read_bytes(), name
    # final outputs exist and are alternating-block consistent
    assert (d03 / "output.father.fa").exists()
    assert (d03 / "output.father.idx").exists()
    assert (wd / "03.maternal_output" / "output.mother.fa").exists()
    assert result["paternal"].endswith("output.father.fa")
