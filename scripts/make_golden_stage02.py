#!/usr/bin/env python
"""Generate stage-02 golden fixtures from the reference perl/awk glue.

merge_barcodes.pl iterates a perl hash (nondeterministic order), so its
merge.txt is captured as a *fixture input* for the fake_10x comparison
rather than a parity target; barcode_freq and fake_10x outputs are
deterministic given that mapping and are compared byte-for-byte
(decompressed).
"""

import gzip
import pathlib
import shutil
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

REF = "/root/reference/02.assemble_by_supernova"
GOLD = pathlib.Path(__file__).resolve().parents[1] / "tests/golden/stage02"
WORK = pathlib.Path("/tmp/ref_run_02")


def main():
    import numpy as np
    from hast_jax.utils import synthetic as S

    GOLD.mkdir(parents=True, exist_ok=True)
    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir()

    rng = np.random.default_rng(55)
    sets = S.make_marker_files(56, 200, 21, str(WORK / "h0.mer"),
                               str(WORK / "h1.mer"), plant_adaptor=False)
    S.make_classify_fastq(57, str(GOLD / "bin.r1.fq.gz"), sets[0], sets[1],
                          n_reads=800, n_barcodes=60)
    # r2 = same heads (paired), different seqs
    with gzip.open(GOLD / "bin.r1.fq.gz", "rb") as f, \
         gzip.open(GOLD / "bin.r2.fq.gz", "wb") as o:
        recs = f.read().split(b"\n")
        for i in range(0, len(recs) - 3, 4):
            head = recs[i].replace(b"/1", b"/2")
            seq = recs[i + 1][::-1]
            o.write(head + b"\n" + seq + b"\n+\n" + recs[i + 3] + b"\n")

    # synthetic 10X whitelist (16bp barcodes)
    bases = np.frombuffer(b"ACGT", np.uint8)
    with open(GOLD / "whitelist.txt", "wb") as f:
        for _ in range(50):
            f.write(bases[rng.integers(0, 4, 16)].tobytes() + b"\n")

    # reference barcode_freq awk (assemble_by_supernova.sh:134)
    with open(WORK / "barcode_freq.txt", "wb") as out:
        p1 = subprocess.Popen(["gzip", "-dc", str(GOLD / "bin.r1.fq.gz")],
                              stdout=subprocess.PIPE)
        subprocess.run(
            ["awk", "-F", "#|/",
             '{if(NR%4==1&&NF>1)t[$2]+=1}END{for(x in t ) '
             'printf("%s\\t%s\\n",x,t[x]);}'],
            stdin=p1.stdout, stdout=out, check=True)
        p1.wait()
    shutil.copy(WORK / "barcode_freq.txt", GOLD / "barcode_freq.golden")

    # reference merge_barcodes.pl (hash order — fixture, not parity)
    subprocess.run(
        ["perl", f"{REF}/merge_barcodes.pl", str(WORK / "barcode_freq.txt"),
         str(GOLD / "whitelist.txt"), str(GOLD / "merge.txt"), "1"],
        check=True, stdout=open(WORK / "merge.log", "wb"))

    # reference fake_10x.pl with that mapping
    subprocess.run(
        ["perl", f"{REF}/fake_10x.pl", str(GOLD / "bin.r1.fq.gz"),
         str(GOLD / "bin.r2.fq.gz"), str(GOLD / "merge.txt")],
        cwd=WORK, check=True, stdout=open(WORK / "fake.log", "wb"))
    for which in (1, 2):
        with gzip.open(WORK / f"SampleName_S1_L001_R{which}_001.fastq.gz") as f:
            (GOLD / f"R{which}.fastq.golden").write_bytes(f.read())
    print("golden fixtures written to", GOLD)


if __name__ == "__main__":
    main()
