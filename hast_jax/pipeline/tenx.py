"""Stage 02 — stLFR -> 10X raw-format conversion for Supernova.

Host-side streaming replacement for the reference's awk/perl glue
(/root/reference/02.assemble_by_supernova/): barcode frequency table,
stLFR-barcode -> 10X-whitelist mapping, and the fake-10X read rewriter.
Supernova itself is external and unportable; :func:`assemble` shells
out to it when a path is provided.

Parity notes:
  * barcode_freq mirrors assemble_by_supernova.sh:134 — header-line
    field 2 under -F '#|/', counted when NF>1 (null barcodes included;
    filtering happens in merge_barcodes).
  * merge_barcodes mirrors merge_barcodes.pl: drop header/null barcodes
    and freq < min_rp; ratio = ceil(n_valid / n_whitelist); assign
    `ratio` stLFR barcodes per 10X barcode.  The reference iterates a
    perl hash (arbitrary order); we use first-seen order — a documented
    determinism improvement with the same many-to-one semantics.
  * fake_10x mirrors fake_10x.pl:28-89: pairs with unmapped barcodes are
    skipped; heads become '@ST-E0:0:SIMULATE:8:0:0:N'; R1 seq gets the
    16bp 10X barcode + 'ATCGAGN' prepended with qual 22*'F'+'#'; '!'
    qualities become '#'.
"""

from __future__ import annotations

import gzip
import math
import re
import sys

from hast_jax.io import fastq as FQ

_SPLIT = re.compile(rb"[#/]")
_PAD = b"ATCGAGN"
_QUAL_PAD = b"F" * 22 + b"#"
_DROP = {b"barcode_str", b"Barcode_seq", b"0", b"0_0", b"0_0_0"}


def barcode_freq(fastq_paths: list[str]) -> dict[bytes, int]:
    """Barcode -> read count over R1 head lines (awk parity)."""
    freq: dict[bytes, int] = {}
    for path in fastq_paths:
        for head, _, _, _ in FQ.fastq_records(path):
            fields = _SPLIT.split(head)
            if len(fields) > 1:
                freq[fields[1]] = freq.get(fields[1], 0) + 1
    return freq


def write_barcode_freq(freq: dict[bytes, int], path: str) -> None:
    with open(path, "wb") as f:
        for bc, n in freq.items():
            f.write(b"%s\t%d\n" % (bc, n))


def load_barcode_freq(path: str) -> dict[bytes, int]:
    freq: dict[bytes, int] = {}
    with open(path, "rb") as f:
        for line in f:
            cols = line.rstrip(b"\n").split(b"\t")
            if len(cols) >= 2:
                freq[cols[0]] = int(cols[1])
    return freq


def merge_barcodes(freq: dict[bytes, int], whitelist_path: str,
                   out_path: str, min_rp: int = 1,
                   log=sys.stderr) -> dict[bytes, bytes]:
    """Many-to-one stLFR -> 10X whitelist barcode map (merge.txt)."""
    with open(whitelist_path, "rb") as f:
        whitelist = [line.rstrip(b"\r\n") for line in f if line.strip()]
    valid = {bc: n for bc, n in freq.items()
             if bc not in _DROP and n >= min_rp}
    print(f"Total {len(whitelist)} in white list of 10X is loaded",
          file=log)
    print(f"Load {len(valid)} valid-stlfr-barcode from total "
          f"{len(freq)} stlfr-barcode", file=log)
    ratio = math.ceil(len(valid) / max(1, len(whitelist)))
    print(f"the stLFR barcode : 10x barcode map true-ratio is {ratio} :1",
          file=log)
    mapping: dict[bytes, bytes] = {}
    used = total = 0
    with open(out_path, "wb") as out:
        for i, (bc, n) in enumerate(valid.items()):
            index = i // max(1, ratio)
            if index >= len(whitelist):
                break
            mapping[bc] = whitelist[index]
            out.write(b"%s\t%s\t%d\n" % (bc, whitelist[index], n))
            used += n
        total = sum(freq.values())
    print(f"Total {total} pairs and used {used} pairs", file=log)
    return mapping


def fake_10x(read1: str, read2: str, mapping: dict[bytes, bytes],
             out_dir: str = ".", sample: str = "SampleName") -> tuple[int, int]:
    """Rewrite an stLFR pair into 10X raw fastq.gz (fake_10x.pl parity).

    Returns (total_pairs, used_pairs).
    """
    out1 = gzip.open(f"{out_dir}/{sample}_S1_L001_R1_001.fastq.gz", "wb",
                     compresslevel=4)
    out2 = gzip.open(f"{out_dir}/{sample}_S1_L001_R2_001.fastq.gz", "wb",
                     compresslevel=4)
    n = total = 0
    it1, it2 = FQ.fastq_records(read1), FQ.fastq_records(read2)
    for rec1 in it1:
        rec2 = next(it2, None)
        if rec2 is None:
            break
        total += 1
        head = rec1[0].split(b"\t")[0]
        parts = head.split(b"#")
        if len(parts) < 2:
            continue
        bc_key = parts[1].split(b"/")[0]
        bc10x = mapping.get(bc_key)
        if bc10x is None:
            continue
        n += 1
        new = b"@ST-E0:0:SIMULATE:8:0:0:%d" % n
        out1.write(new + b" 1:N:0:NAAGTGCT\n")
        out1.write(bc10x + _PAD + rec1[1] + b"\n")
        out1.write(rec1[2] + b"\n")
        out1.write(_QUAL_PAD + rec1[3].replace(b"!", b"#") + b"\n")
        out2.write(new + b" 2:N:0:NAAGTGCT\n")
        out2.write(rec2[1] + b"\n")
        out2.write(rec2[2] + b"\n")
        out2.write(rec2[3].replace(b"!", b"#") + b"\n")
    out1.close()
    out2.close()
    return total, n


def prepare_10x(read1_bins: list[str], read2_bins: list[str],
                whitelist_path: str, out_dir: str = ".",
                min_rp: int = 1) -> tuple[int, int]:
    """Concatenate classified bins and produce fake-10X inputs.

    The reference first cats the bins into split_reads.{1,2}.fq.gz
    (assemble_by_supernova.sh:129-130); we stream the bins directly to
    avoid the extra disk roundtrip — same output reads.
    """
    import os


    freq = barcode_freq(read1_bins)
    write_barcode_freq(freq, os.path.join(out_dir, "barcode_freq.txt"))
    mapping = merge_barcodes(freq, whitelist_path,
                             os.path.join(out_dir, "merge.txt"), min_rp)

    # concatenate bins into temporary single streams (record order =
    # bin order, matching the reference's cat)
    def concat(paths: list[str], suffix: str) -> str:
        tmp = os.path.join(out_dir, f"split_reads.{suffix}.fq.gz")
        with gzip.open(tmp, "wb", compresslevel=1) as out:
            for p in paths:
                with FQ.open_text(p) as f:
                    while True:
                        chunk = f.read(1 << 20)
                        if not chunk:
                            break
                        out.write(chunk)
        return tmp

    r1 = concat(read1_bins, "1")
    r2 = concat(read2_bins, "2")
    return fake_10x(r1, r2, mapping, out_dir)


def assemble(supernova_path: str, out_dir: str, prefix: str = "output",
             threads: int = 30, memory_gb: int = 800) -> None:
    """Invoke external Supernova run + mkoutput (wrapper only)."""
    import subprocess
    sn = f"{supernova_path}/supernova"
    subprocess.run(
        [sn, "run", "--id=haplotype", "--maxreads=all",
         "--accept-extreme-coverage", f"--fastqs={out_dir}",
         f"--localcores={threads}", f"--localmem={memory_gb}",
         "--nopreflight"], cwd=out_dir, check=True)
    subprocess.run(
        [sn, "mkoutput", "--style=pseudohap2", "--index", "--headers=full",
         "--minsize=200", "--asmdir=haplotype/outs/assembly/",
         f"--outprefix={prefix}"], cwd=out_dir, check=True)
    subprocess.run(["gunzip", f"{prefix}.1.fasta.gz", f"{prefix}.2.fasta.gz"],
                   cwd=out_dir, check=False)
