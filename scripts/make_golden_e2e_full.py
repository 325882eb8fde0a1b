#!/usr/bin/env python
"""Golden for the 00→03 chained run (mock-Supernova e2e).

The e2e golden chain (make_golden_e2e.py) stops after stage 01; stages
02/03 were only golden-tested in isolation.  This script extends the
chain: it builds a synthetic Supernova pseudohap2 assembly whose bubbles
carry the *e2e* marker sets (tests/golden/e2e/*.unique.filter.mer — the
same markers our stage 00 reproduces bit-identically), then runs the
REFERENCE stage-03 flow (mkoutput_by_fabulous2.0.sh) twice with the mer
order rule of HAST.sh:220-256 (maternal-first run emits output.mother.fa,
paternal-first emits output.father.fa).  tests/test_e2e_full.py replays
the whole pipeline through `hast_jax run` with a fake supernova binary
that emits this assembly, and compares the final fastas byte-for-byte.
"""

import os
import pathlib
import shutil
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from make_golden_stage03 import BUILD, build_reference, make_assembly

GOLD = pathlib.Path(__file__).resolve().parents[1] / "tests/golden/e2e"


def main():
    import numpy as np

    build_reference()
    asm = GOLD / "assembly"
    asm.mkdir(exist_ok=True)

    markers_p = (GOLD / "paternal.unique.filter.mer").read_bytes().split()
    markers_m = (GOLD / "maternal.unique.filter.mer").read_bytes().split()
    rng = np.random.default_rng(99)
    make_assembly(rng, markers_p[:2000], markers_m[:2000], asm)

    for prefer, keep_fa in (("paternal", "father"), ("maternal", "mother")):
        work = pathlib.Path(f"/tmp/ref_run_e2e03_{prefer}")
        if work.exists():
            shutil.rmtree(work)
        work.mkdir()
        # HAST.sh:220-256 — the first mer flag selects the primary
        if prefer == "paternal":
            mers = ["--paternal_mer", str(GOLD / "paternal.unique.filter.mer"),
                    "--maternal_mer", str(GOLD / "maternal.unique.filter.mer")]
        else:
            mers = ["--maternal_mer", str(GOLD / "maternal.unique.filter.mer"),
                    "--paternal_mer", str(GOLD / "paternal.unique.filter.mer")]
        subprocess.run(
            ["bash", os.path.join(BUILD, "mkoutput_by_fabulous2.0.sh"),
             "--assembly_path", str(asm), *mers,
             "--prefix", "output", "--thread", "2"],
            cwd=work, check=True,
            stdout=open(work / "run.log", "w"), stderr=subprocess.STDOUT)
        dest = GOLD / f"stage03_{prefer}"
        dest.mkdir(exist_ok=True)
        for name in (f"output.{keep_fa}.fa", f"output.{keep_fa}.idx",
                     "output.supplement.fa"):
            shutil.copy(work / name, dest / name)
        print(f"{prefer}: kept {keep_fa} outputs in {dest}")


if __name__ == "__main__":
    main()
