"""Tool parity tests — run the reference awk/shell directly (no goldens)."""

import io
import pathlib
import subprocess

import pytest

from hast_jax.tools.mark_library import mark_library
from hast_jax.tools import hic

REF_TOOLS = pathlib.Path("/root/reference/tools")

FASTQ = (b"@V300017823L1C001R051096800#203_1533_1069/1\nACGT\n+\nFFFF\n"
         b"@V300017823L1C001R051096801#0_0_0/1\nTTTT\n+\nFFFF\n"
         b"@plainhead\nGGGG\n+\nFFFF\n"
         b"@odd#fields#1_2_3/2\nCCCC\n+\nFFFF\n")


def test_mark_library_matches_awk(tmp_path):
    fq = tmp_path / "in.fq"
    fq.write_bytes(FASTQ)
    ref = subprocess.run(
        ["awk", "-F", "#|/", "-v", "lib_id=2",
         '{if(NR%4==1&&NF>1&&$2!="0_0_0"){printf("%s#lib%s_%s/%s\\n",'
         '$1,lib_id,$2,$3);}else print $0; }', str(fq)],
        capture_output=True, check=True).stdout
    out = io.BytesIO()
    mark_library(str(fq), 2, out)
    assert out.getvalue() == ref


SAM = """\
@HD\tVN:1.6
r1\t16\tc1\t100\t60\t50M\t*\t0\t0\tAAAA\tFFFF\tNM:i:2
r1\t272\tc1\t200\t60\t40M2D10M\t*\t0\t0\tAAAA\tFFFF\tNM:i:4
r2\t0\tc1\t300\t60\t30M\t*\t0\t0\tAAAA\tFFFF\tNM:i:0
r3\t16\tc2\t400\t60\t25M1I24M\t*\t0\t0\tAAAA\tFFFF\tNM:i:3
r4\t16\tc2\t500\t60\t50M\t*\t0\t0\tAAAA\tFFFF\tNM:i:1
"""

SAM2 = """\
@HD\tVN:1.6
r1\t16\tc1\t100\t60\t50M\t*\t0\t0\tAAAA\tFFFF\tNM:i:0
r2\t16\tc1\t300\t60\t30M\t*\t0\t0\tAAAA\tFFFF\tNM:i:1
r3\t4\t*\t0\t0\t*\t*\t0\t0\tAAAA\tFFFF
r4\t16\tc2\t500\t60\t50M\t*\t0\t0\tAAAA\tFFFF\tNM:i:1
"""


def test_hic_matches_reference_script(tmp_path):
    (tmp_path / "pat.sam").write_text(SAM)
    (tmp_path / "mat.sam").write_text(SAM2)
    subprocess.run(
        ["bash", str(REF_TOOLS / "classify_hic_reads.sh"),
         "pat.sam", "mat.sam"],
        cwd=tmp_path, check=True, capture_output=True)
    ref = {}
    for name in ("paternal", "maternal", "homo"):
        p = tmp_path / f"{name}.reads"
        ref[name] = sorted(p.read_text().split()) if p.exists() else []

    out = tmp_path / "ours"
    out.mkdir()
    hic.classify_hic_reads(str(tmp_path / "pat.sam"),
                           str(tmp_path / "mat.sam"), str(out))
    for name in ("paternal", "maternal", "homo"):
        ours = sorted((out / f"{name}.reads").read_text().split())
        assert ours == ref[name], name


def test_hic_get_infos_golden():
    # idy for 40M2D10M with NM:i:4: m=50,g=2,o=1 -> 1-(4-2+1)/51
    import tempfile, os
    with tempfile.NamedTemporaryFile("w", suffix=".sam", delete=False) as f:
        f.write("x\t16\tc\t1\t60\t40M2D10M\t*\t0\t0\tA\tF\tNM:i:4\n")
        path = f.name
    (name, flag, idy, exact, total) = next(hic.get_infos(path))
    os.unlink(path)
    assert name == "x" and flag == 16
    assert total == 51 and exact == 51 - 3
    assert abs(idy - (1 - 3 / 51)) < 1e-12


def test_filter_fq_by_barcodes_matches_awk(tmp_path):
    gold = pathlib.Path(__file__).parent / "golden" / "stage01"
    barcodes = tmp_path / "keep.txt"
    names = (gold / "paternal.unique.barcodes.golden").read_bytes()
    barcodes.write_bytes(b"\n".join(names.splitlines()[:40]) + b"\n")
    ref = subprocess.run(
        ["awk", "-F", "#|/", "-f",
         "/root/reference/01.classify_stlfr_reads/filter_fq_by_barcodes.awk",
         str(barcodes), str(gold / "reads2.fq")],
        capture_output=True, check=True, cwd=tmp_path).stdout
    ref_log = (tmp_path / "filter_reads.log").read_bytes()
    import io as _io
    from hast_jax.pipeline.partition import filter_fastq_by_barcodes
    out = _io.BytesIO()
    log2 = tmp_path / "ours.log"
    filter_fastq_by_barcodes(str(gold / "reads2.fq"), str(barcodes), out,
                             log_path=str(log2))
    assert out.getvalue() == ref
    assert log2.read_bytes() == ref_log
