#!/usr/bin/env python
"""End-to-end trio golden: reference stage00 -> stage01 chained.

Small synthetic trio (60kb genomes, stLFR-style filial reads whose
barcodes each cover a long single-haplotype fragment), processed by the
REFERENCE jellyfish pipeline + classify binary + quartering awk.
Inputs and final outputs are stored under tests/golden/e2e/.
"""

import gzip
import os
import pathlib
import shutil
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

REF00 = ("/root/reference/00.build_unshare_kmers_by_jellyfish/"
         "build_unshared_kmers.sh")
REF01 = "/root/reference/01.classify_stlfr_reads"
GOLD = pathlib.Path(__file__).resolve().parents[1] / "tests/golden/e2e"
WORK = pathlib.Path("/tmp/ref_run_e2e")


def make_filial_reads(rng, pat_g, mat_g, r1_path, r2_path, n_pairs=12000,
                      read_len=100, n_barcodes=400, frag_len=8000):
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    import numpy as np
    genomes = [np.frombuffer(pat_g, np.uint8), np.frombuffer(mat_g, np.uint8)]
    barcodes = []
    for i in range(n_barcodes):
        hap = int(rng.integers(0, 2))
        start = int(rng.integers(0, len(pat_g) - frag_len))
        barcodes.append((b"%d_%d_%d" % (rng.integers(1, 1500),
                                        rng.integers(1, 1500),
                                        rng.integers(1, 1500)), hap, start))
    with gzip.open(r1_path, "wb") as f1, open(r2_path, "wb") as f2:
        for i in range(n_pairs):
            bc, hap, start = barcodes[int(rng.integers(0, n_barcodes))]
            g = genomes[hap]
            p = start + int(rng.integers(0, frag_len - 2 * read_len))
            s1 = g[p:p + read_len].tobytes()
            s2 = g[p + read_len:p + 2 * read_len].tobytes()
            s2 = s2.translate(comp)[::-1]
            if rng.integers(0, 50) == 0:  # occasional N
                s1 = s1[:50] + b"N" + s1[51:]
            q = b"F" * read_len
            f1.write(b"@V300E2E%08dL1#%s/1\n%s\n+\n%s\n" % (i, bc, s1, q))
            f2.write(b"@V300E2E%08dL1#%s/2\n%s\n+\n%s\n" % (i, bc, s2, q))


def main():
    import numpy as np
    from hast_jax.utils import synthetic as S

    GOLD.mkdir(parents=True, exist_ok=True)
    if WORK.exists():
        shutil.rmtree(WORK)
    (WORK / "00").mkdir(parents=True)
    (WORK / "01").mkdir()

    pat_g, mat_g = S.make_trio_genomes(seed=321, length=60_000,
                                       het_rate=0.008)
    S.make_parent_reads(41, pat_g, str(GOLD / "paternal.fa.gz"),
                        coverage=30.0, err_rate=0.002)
    S.make_parent_reads(42, mat_g, str(GOLD / "maternal.fa.gz"),
                        coverage=30.0, err_rate=0.002)
    rng = np.random.default_rng(43)
    make_filial_reads(rng, pat_g, mat_g, str(GOLD / "son.r1.fq.gz"),
                      str(GOLD / "son.r2.fq"))

    # reference stage 00
    subprocess.run(
        ["bash", REF00, "--paternal", str(GOLD / "paternal.fa.gz"),
         "--maternal", str(GOLD / "maternal.fa.gz"),
         "--thread", "2", "--memory", "1", "--auto_bounds"],
        cwd=WORK / "00", check=True,
        stdout=open(WORK / "00" / "log", "w"), stderr=subprocess.STDOUT)

    # reference stage 01 (classify binary + splits + quartering awk),
    # replicating classify_stlfr_reads.sh with weight0=1.04
    exe = "/tmp/ref_build_01/classify"
    if not os.path.exists(exe):
        subprocess.run([sys.executable,
                        str(pathlib.Path(__file__).parent
                            / "make_golden_stage01.py")], check=True)
    d01 = WORK / "01"
    with open(d01 / "phased.barcodes", "wb") as out:
        subprocess.run(
            [exe, "--hap0", str(WORK / "00" / "paternal.unique.filter.mer"),
             "--hap1", str(WORK / "00" / "maternal.unique.filter.mer"),
             "--read", str(GOLD / "son.r1.fq.gz"),
             "--read", str(GOLD / "son.r2.fq"),
             "--thread", "2", "--weight0", "1.04"],
            stdout=out, stderr=open(d01 / "phased.log", "wb"), check=True)
    for hap, name in (("0", "paternal"), ("1", "maternal"),
                      ("-1", "homozygous")):
        with open(d01 / "phased.barcodes", "rb") as f, \
             open(d01 / f"{name}.unique.barcodes", "wb") as o:
            for line in f:
                cols = line.split(b"\t")
                if cols[1].decode() == hap:
                    o.write(cols[0] + b"\n")
    for reads, prefix in ((GOLD / "son.r1.fq.gz", "son.r1.fq"),
                          (GOLD / "son.r2.fq", "son.r2.fq")):
        if str(reads).endswith(".gz"):
            p1 = subprocess.Popen(["gzip", "-dc", str(reads)],
                                  stdout=subprocess.PIPE)
            subprocess.run(
                ["awk", "-v", f"prefix={prefix}", "-F", "#|/", "-f",
                 f"{REF01}/quartering_fastq.awk",
                 "paternal.unique.barcodes", "maternal.unique.barcodes",
                 "homozygous.unique.barcodes", "-"],
                stdin=p1.stdout, cwd=d01, check=True,
                stderr=subprocess.DEVNULL)
            p1.wait()
        else:
            subprocess.run(
                ["awk", "-v", f"prefix={prefix}", "-F", "#|/", "-f",
                 f"{REF01}/quartering_fastq.awk",
                 "paternal.unique.barcodes", "maternal.unique.barcodes",
                 "homozygous.unique.barcodes", str(reads)],
                cwd=d01, check=True, stderr=subprocess.DEVNULL)

    keep = ["phased.barcodes"]
    keep += [f"{n}.unique.barcodes" for n in
             ("paternal", "maternal", "homozygous")]
    keep += [f"son.r{i}.fq.{n}.fastq" for i in (1, 2)
             for n in ("paternal", "maternal", "homozygous", "nobarcode")
             if (d01 / f"son.r{i}.fq.{n}.fastq").exists()]
    outdir = GOLD / "stage01"
    outdir.mkdir(exist_ok=True)
    for name in keep:
        shutil.copy(d01 / name, outdir / name)
    for name in ("paternal.unique.filter.mer", "maternal.unique.filter.mer"):
        shutil.copy(WORK / "00" / name, GOLD / name)
    print("golden fixtures written to", GOLD)


if __name__ == "__main__":
    main()
