#!/usr/bin/env python
"""Generate stage-03 golden fixtures from the REFERENCE binaries.

Builds the reference Split/classify/MergePhaseResult/GenSq out-of-tree
in /tmp (with a trivial missing-#include fix; no code enters this repo),
creates a synthetic Supernova pseudohap2 assembly (fasta + idx pairs)
with phased bubbles carrying parental markers, runs the full reference
mkoutput_by_fabulous2.0.sh flow, and stores inputs + outputs under
tests/golden/stage03/.
"""

import os
import pathlib
import shutil
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

REF = "/root/reference/03.mkoutput_by_fabulous2.0"
BUILD = "/tmp/ref_build_03"
GOLD = pathlib.Path(__file__).resolve().parents[1] / "tests/golden/stage03"


def build_reference():
    exe = os.path.join(BUILD, "bin", "GenSq")
    if os.path.exists(exe):
        return
    shutil.copytree(REF, BUILD, dirs_exist_ok=True)
    subprocess.run(
        ["sed", "-i",
         "s|#include <sys/time.h>|#include <sys/time.h>\\n#include <ctime>|",
         os.path.join(BUILD, "common/time/timetools.h")], check=True)
    subprocess.run(["make", "-C", os.path.join(BUILD, "src_main")],
                   check=True, capture_output=True)


def make_assembly(rng, markers0, markers1, outdir):
    """Synthetic pseudohap2: scaffolds of alternating homo/phased blocks."""
    import numpy as np
    BASES = np.frombuffer(b"ACGT", np.uint8)

    def rand_seq(n):
        return BASES[rng.integers(0, 4, n)].tobytes()

    def plant(seq, markers, count):
        seq = bytearray(seq)
        for _ in range(count):
            m = markers[int(rng.integers(0, len(markers)))]
            p = int(rng.integers(0, len(seq) - len(m) + 1))
            seq[p:p + len(m)] = m
        return bytes(seq)

    fa = {1: [], 2: []}
    idx = {1: [], 2: []}
    for sid in range(1, 13):
        n_phased = int(rng.integers(0, 4))  # 0..3 bubbles
        blocks1, blocks2 = [], []
        for b in range(2 * n_phased + 1):
            if b % 2 == 0:  # homo
                s = rand_seq(int(rng.integers(80, 400)))
                blocks1.append(s)
                blocks2.append(s)
            else:
                l1 = int(rng.integers(60, 300))
                l2 = int(rng.integers(60, 300))
                v1, v2 = rand_seq(l1), rand_seq(l2)
                mode = int(rng.integers(0, 6))
                if mode == 0:    # clear father/mother split
                    v1 = plant(v1, markers0, 3)
                    v2 = plant(v2, markers1, 3)
                elif mode == 1:  # swapped orientation
                    v1 = plant(v1, markers1, 3)
                    v2 = plant(v2, markers0, 3)
                elif mode == 2:  # one side ambiguous (no markers)
                    v1 = plant(v1, markers0, 2)
                elif mode == 3:  # both same verdict -> HOMO pairing
                    v1 = plant(v1, markers0, 2)
                    v2 = plant(v2, markers0, 2)
                # mode 4,5: both ambiguous with 0.0 weights ->
                # supernova-majority + final homo path
                blocks1.append(v1)
                blocks2.append(v2)
        for which, blocks in ((1, blocks1), (2, blocks2)):
            seq = b"".join(blocks)
            fa[which].append((sid, seq))
            coords = [0]
            for blk in blocks:
                coords.append(coords[-1] + len(blk))
            idx[which].append((sid, coords))

    for which in (1, 2):
        with open(outdir / f"output.{which}.fasta", "wb") as f:
            for sid, seq in fa[which]:
                f.write(b">%d pseudohap2 style=%d\n" % (sid, which))
                for p in range(0, len(seq), 60):
                    f.write(seq[p:p + 60] + b"\n")
        with open(outdir / f"output.{which}.idx", "w") as f:
            for sid, coords in idx[which]:
                f.write(str(sid) + "".join(f" {c}" for c in coords) + "\n")


def main():
    import numpy as np
    from hast_jax.utils import synthetic as S

    build_reference()
    GOLD.mkdir(parents=True, exist_ok=True)
    asm = GOLD / "assembly"
    asm.mkdir(exist_ok=True)

    rng = np.random.default_rng(77)
    sets = S.make_marker_files(78, 1500, 21, str(GOLD / "paternal.mer"),
                               str(GOLD / "maternal.mer"),
                               plant_adaptor=False)
    make_assembly(rng, sets[0], sets[1], asm)

    work = pathlib.Path("/tmp/ref_run_03")
    if work.exists():
        shutil.rmtree(work)
    work.mkdir()
    env = dict(os.environ)
    subprocess.run(
        ["bash", os.path.join(BUILD, "mkoutput_by_fabulous2.0.sh"),
         "--assembly_path", str(asm),
         "--paternal_mer", str(GOLD / "paternal.mer"),
         "--maternal_mer", str(GOLD / "maternal.mer"),
         "--prefix", "output", "--thread", "2"],
        cwd=work, check=True, env=env,
        stdout=open(work / "run.log", "w"), stderr=subprocess.STDOUT)

    keep = ["output.phb.1.fa", "output.phb.2.fa", "output.homo.fa",
            "phasing.out", "output.phb.12.father.idx",
            "output.phb.12.mother.idx", "output.phb.12.ambiguous.idx",
            "output.merge.father.ids", "output.merge.mother.ids",
            "output.merge.homo.ids", "output.father.fa", "output.father.idx",
            "output.supplement.fa", "phasing.log", "run.log"]
    for name in keep:
        if (work / name).exists():
            shutil.copy(work / name, GOLD / name)
    print("golden fixtures written to", GOLD)


if __name__ == "__main__":
    main()
