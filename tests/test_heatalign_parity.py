"""Heat-align tool parity vs the reference KIR/MHC/getN/CheckGenes."""

import io
import pathlib

import pytest

from hast_jax.tools import heatalign as HA

GOLD = pathlib.Path(__file__).parent / "golden" / "heatalign"


@pytest.mark.parametrize("preset", ["KIR", "MHC"])
def test_svg_bit_identical(preset):
    out = io.StringIO()
    HA.draw_heatalign(
        1100000,
        [str(GOLD / "H1.align.txt"), str(GOLD / "H2.align.txt")],
        out, gene_file=str(GOLD / "genes.txt"), preset=preset,
        err=io.StringIO())
    golden = (GOLD / f"{preset.lower()}.svg.golden").read_text()
    assert out.getvalue() == golden


def test_getn_bit_identical():
    out = io.StringIO()
    with open(GOLD / "n.fa") as f:
        HA.get_n(f, out)
    assert out.getvalue() == (GOLD / "getn.out.golden").read_text()


def test_checkgenes_bit_identical():
    out = io.StringIO()
    HA.check_genes(str(GOLD / "H1.align.txt"),
                   str(GOLD / "cg.genes.txt"), out)
    assert out.getvalue() == (GOLD / "checkgenes.out.golden").read_text()
