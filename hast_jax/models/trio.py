"""End-to-end trio-binning pipeline — the HAST.sh orchestrator.

Mirrors /root/reference/HAST.sh:138-259: stage 00 markers (auto
bounds), stage 01 classify + partition of both read files, stage 02
twice (maternal assembly = maternal+homozygous bins, paternal =
paternal+homozygous), stage 03 twice with mer order controlling the
primary output.  Stages 02/03 require an external Supernova install;
without one the pipeline completes through the classified fastq bins
(the part the paper's method actually contributes).
"""

from __future__ import annotations

import dataclasses
import glob
import os
import sys


@dataclasses.dataclass
class TrioBinningPipeline:
    paternal: list[str]
    maternal: list[str]
    read1: list[str]
    read2: list[str]
    supernova: str | None = None
    threads: int = 8
    memory_gb: int = 800
    workdir: str = "."
    k: int = 21
    batch_size: int = 1 << 16

    def _dir(self, name: str) -> str:
        d = os.path.join(self.workdir, name)
        os.makedirs(d, exist_ok=True)
        return d

    def run(self) -> dict[str, str]:
        from hast_jax.cli import main as cli_main

        paternal = [os.path.abspath(p) for p in self.paternal]
        maternal = [os.path.abspath(p) for p in self.maternal]
        read1 = [os.path.abspath(p) for p in self.read1]
        read2 = [os.path.abspath(p) for p in self.read2]

        # stage 00
        d00 = self._dir("00.build_kmers")
        args = ["build-markers", "--out-dir", d00, "--auto_bounds",
                "--mer", str(self.k), "--batch-size", str(self.batch_size)]
        for p in paternal:
            args += ["--paternal", p]
        for m in maternal:
            args += ["--maternal", m]
        cli_main(args)
        pat_mer = os.path.join(d00, "paternal.unique.filter.mer")
        mat_mer = os.path.join(d00, "maternal.unique.filter.mer")

        # stage 01
        d01 = self._dir("01.classify_reads")
        args = ["classify-reads", "--paternal_mer", pat_mer,
                "--maternal_mer", mat_mer, "--workdir", d01,
                "--batch-size", str(self.batch_size)]
        for f in read1 + read2:
            args += ["--filial", f]
        cli_main(args)

        result = {"classify_dir": d01}
        if not self.supernova:
            print("no --supernova given; stopping after stage 01 bins",
                  file=sys.stderr)
            return result

        # stage 02 (twice: maternal+homo, paternal+homo)
        for parent in ("maternal", "paternal"):
            d02 = self._dir(f"02.{parent}_assembly")
            r1 = sorted(glob.glob(os.path.join(d01, f"*r1*.{parent}.fastq"))) \
                + sorted(glob.glob(os.path.join(d01, "*r1*.homozygous.fastq")))
            r2 = sorted(glob.glob(os.path.join(d01, f"*r2*.{parent}.fastq"))) \
                + sorted(glob.glob(os.path.join(d01, "*r2*.homozygous.fastq")))
            args = ["assemble", "--supernova", self.supernova,
                    "--out-dir", d02, "--prefix", "output",
                    "--thread", str(self.threads),
                    "--memory", str(self.memory_gb)]
            for f in r1:
                args += ["--read1", f]
            for f in r2:
                args += ["--read2", f]
            cli_main(args)

        # stage 03 (twice; mer order picks the primary branch)
        for parent, first in (("maternal", "maternal"),
                              ("paternal", "paternal")):
            d03 = self._dir(f"03.{parent}_output")
            d02 = os.path.join(self.workdir, f"02.{parent}_assembly")
            args = ["mkoutput", "--assembly_path", d02, "--prefix", "output",
                    "--workdir", d03, "--paternal_mer", pat_mer,
                    "--maternal_mer", mat_mer, "--prefer", first]
            cli_main(args)
            result[parent] = os.path.join(
                d03, "output.father.fa" if parent == "paternal"
                else "output.mother.fa")
        return result
