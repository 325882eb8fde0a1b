"""VCF QC suite parity vs the reference self_vcftools binaries."""

import io
import pathlib

import pytest

from hast_jax.tools import vcfqc as V

GOLD = pathlib.Path(__file__).parent / "golden" / "vcfqc"


def _run(fn, *args):
    out, err = io.StringIO(), io.StringIO()
    fn(*args, out, err)
    return out.getvalue()


CASES = [
    ("snponly.out", lambda o, e: V.get_snp_only(str(GOLD / "child.vcf"),
                                                o, e)),
    ("snpinfo.out", lambda o, e: V.get_snp_info(str(GOLD / "child.vcf"),
                                                o, e)),
    ("phasedsnp.out", lambda o, e: V.phased_snp(str(GOLD / "child.vcf"),
                                                o, e)),
    ("dipcall.out", lambda o, e: V.get_hapsnp_from_dipcall(
        str(GOLD / "child.vcf"), o, e)),
    ("mergehap.out", lambda o, e: V.merge_hap_snp(
        str(GOLD / "hap1.vcf"), str(GOLD / "hap2.vcf"), o, e)),
    ("hapinherit.out", lambda o, e: V.hap_inherit(
        str(GOLD / "father.vcf"), str(GOLD / "child.vcf"), o, e)),
    ("inherit3aa.out", lambda o, e: V.inherit_3aa(
        str(GOLD / "father.vcf"), str(GOLD / "mother.vcf"),
        str(GOLD / "child.vcf"), o, e)),
    ("solidsnp.out", lambda o, e: V.inherit_solid_snp(
        str(GOLD / "father.vcf"), str(GOLD / "mother.vcf"),
        str(GOLD / "child.vcf"), o, e)),
    ("phasesolid.out", lambda o, e: V.phase_inherit_solid_snp(
        str(GOLD / "father.vcf"), str(GOLD / "mother.vcf"),
        str(GOLD / "child.vcf"), o, e)),
]


@pytest.mark.parametrize("golden,run", CASES,
                         ids=[c[0] for c in CASES])
def test_stdout_bit_identical(golden, run):
    out, err = io.StringIO(), io.StringIO()
    run(out, err)
    assert out.getvalue() == (GOLD / golden).read_text(), golden


def test_calc_hd_matches_reference():
    err = io.StringIO()
    V.calc_hd(str(GOLD / "phasedsnp.out"), str(GOLD / "mergehap.out"), err)
    golden_err = (GOLD / "calchd.out.err").read_text()
    ours_scores = [l for l in err.getvalue().splitlines()
                   if l.startswith(" total")]
    golden_scores = [l for l in golden_err.splitlines()
                     if l.startswith(" total")]
    assert ours_scores == golden_scores


def test_calc_hd_overlapping(tmp_path):
    """Values cross-checked against the reference CalcHD binary."""
    std = tmp_path / "std.txt"
    tgt = tmp_path / "tgt.txt"
    std.write_text("chr1\t10\tA\tC\tb1\nchr1\t20\tG\tT\tb1\n"
                   "chr1\t30\tA\tG\tb1\nchr1\t40\tC\tT\tb1\n"
                   "chr2\t10\tA\tC\tb2\nchr2\t20\tG\tT\tb2\n")
    tgt.write_text("chr1\t10\tA\tC\nchr1\t20\tT\tG\nchr1\t30\tA\tG\n"
                   "chr1\t40\tA\tG\nchr2\t10\tC\tA\nchr2\t20\tT\tG\n")
    r = V.calc_hd(str(std), str(tgt), io.StringIO())
    assert (r["hamming_wrong"], r["hamming_total"]) == (1, 6)
    assert (r["switch_wrong"], r["switch_total"]) == (2, 5)
