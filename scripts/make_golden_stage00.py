#!/usr/bin/env python
"""Generate stage-00 golden fixtures by RUNNING the reference pipeline.

Executes /root/reference/00.build_unshare_kmers_by_jellyfish/
build_unshared_kmers.sh (jellyfish binary included) in a /tmp workdir on
deterministic synthetic parent reads, then stores inputs + outputs under
tests/golden/stage00/.  No reference code is copied into this repo.
"""

import pathlib
import shutil
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

REF_SH = ("/root/reference/00.build_unshare_kmers_by_jellyfish/"
          "build_unshared_kmers.sh")
WORK = pathlib.Path("/tmp/ref_run_00")
GOLD = pathlib.Path(__file__).resolve().parents[1] / "tests/golden/stage00"


def main():
    from hast_jax.utils import synthetic as S

    GOLD.mkdir(parents=True, exist_ok=True)
    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir(parents=True)

    # child haplotype genomes double as parent genomes for marker
    # construction (markers only care about parent-vs-parent k-mers)
    pat_g, mat_g = S.make_trio_genomes(seed=21, length=150_000,
                                       het_rate=0.005)
    S.make_parent_reads(31, pat_g, str(GOLD / "paternal.reads.fa.gz"),
                        coverage=30.0, err_rate=0.002)
    S.make_parent_reads(32, mat_g, str(GOLD / "maternal.reads.fa.gz"),
                        coverage=30.0, err_rate=0.002)

    subprocess.run(
        ["bash", REF_SH,
         "--paternal", str(GOLD / "paternal.reads.fa.gz"),
         "--maternal", str(GOLD / "maternal.reads.fa.gz"),
         "--thread", "2", "--memory", "1", "--auto_bounds"],
        cwd=WORK, check=True,
        stdout=open(WORK / "run.log", "w"),
        stderr=subprocess.STDOUT)

    for name in ("paternal.unique.filter.mer", "maternal.unique.filter.mer",
                 "maternal.bounds.txt", "paternal.bounds.txt",
                 "maternal.histo", "paternal.histo"):
        shutil.copy(WORK / name, GOLD / name)
    shutil.copy(WORK / "run.log", GOLD / "reference_run.log")
    print("golden fixtures written to", GOLD)


if __name__ == "__main__":
    main()
