#!/usr/bin/env python
"""Generate stage-01 golden fixtures from the REFERENCE binaries.

Builds the reference `classify` out-of-tree in /tmp (the reference repo
itself is read-only and its code is never copied into this repo), runs
it plus the reference awk scripts on deterministic synthetic inputs,
and stores inputs + expected outputs under tests/golden/stage01/.

Run once; goldens are committed so CI never needs the reference.
"""

import os
import pathlib
import shutil
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

REF = "/root/reference/01.classify_stlfr_reads"
BUILD = "/tmp/ref_build_01"
GOLD = pathlib.Path(__file__).resolve().parents[1] / "tests/golden/stage01"


def build_reference() -> str:
    exe = os.path.join(BUILD, "classify")
    if os.path.exists(exe):
        return exe
    shutil.copytree(REF, BUILD, dirs_exist_ok=True)
    subprocess.run(["sed", "-i", "s/#include <map>/#include <map>\\n#include <array>/", os.path.join(BUILD, "classify.cpp")], check=True)
    subprocess.run(["make", "-C", BUILD], check=True, capture_output=True)
    return exe


def main():
    from hast_jax.utils import synthetic as S

    GOLD.mkdir(parents=True, exist_ok=True)
    exe = build_reference()

    k = 21
    sets = S.make_marker_files(11, 2000, k, str(GOLD / "hap0.mer"),
                               str(GOLD / "hap1.mer"))
    S.make_classify_fastq(12, str(GOLD / "reads1.fq.gz"), sets[0], sets[1],
                          n_reads=4000)
    S.make_classify_fastq(13, str(GOLD / "reads2.fq"), sets[0], sets[1],
                          n_reads=1000)

    # --- reference classify (two files, weight0=1.04 like the driver) ---
    with open(GOLD / "phased.barcodes.golden", "wb") as out, \
         open(GOLD / "phased.log", "wb") as err:
        subprocess.run(
            [exe, "--hap0", str(GOLD / "hap0.mer"),
             "--hap1", str(GOLD / "hap1.mer"),
             "--read", str(GOLD / "reads1.fq.gz"),
             "--read", str(GOLD / "reads2.fq"),
             "--thread", "4", "--weight0", "1.04"],
            stdout=out, stderr=err, check=True)

    # --- barcode splits (classify_stlfr_reads.sh:156-165) ---
    import re
    for hap, name in (("0", "paternal"), ("1", "maternal"),
                      ("-1", "homozygous")):
        with open(GOLD / "phased.barcodes.golden", "rb") as f, \
             open(GOLD / f"{name}.unique.barcodes.golden", "wb") as o:
            for line in f:
                cols = line.split(b"\t")
                if cols[1].decode() == hap:
                    o.write(cols[0] + b"\n")

    # --- reference quartering awk on the plain fastq ---
    qdir = GOLD / "quarter"
    if qdir.exists():
        shutil.rmtree(qdir)
    qdir.mkdir()
    for name in ("paternal", "maternal", "homozygous"):
        shutil.copy(GOLD / f"{name}.unique.barcodes.golden",
                    qdir / f"{name}.unique.barcodes")
    subprocess.run(
        ["awk", "-v", "prefix=reads2.fq", "-F", "#|/", "-f",
         os.path.join(REF, "quartering_fastq.awk"),
         "paternal.unique.barcodes", "maternal.unique.barcodes",
         "homozygous.unique.barcodes", str(GOLD / "reads2.fq")],
        cwd=qdir, check=True,
        stderr=open(qdir / "quarter.stderr", "wb"))
    for name in ("paternal", "maternal", "homozygous"):
        os.unlink(qdir / f"{name}.unique.barcodes")
    print("golden fixtures written to", GOLD)


if __name__ == "__main__":
    main()
