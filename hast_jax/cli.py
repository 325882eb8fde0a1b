"""Command-line interface — the reference's bash drivers, one binary.

Subcommands map 1:1 onto the reference surface:

  build-markers     00.build_unshare_kmers (jellyfish/meryl pipelines)
  classify          01 `classify` binary (phased.barcodes on stdout)
  classify-reads    01 classify_stlfr_reads.sh driver (classify + barcode
                    splits + fastq quartering, step_9/10/11 checkpoints)
  merge-results     01 mergeResult (fixed semantics: matches single run)
  prepare-10x       02 barcode_freq + merge_barcodes + fake_10x
  assemble          02 supernova wrapper (external binary required)
  mkoutput          03 mkoutput_by_fabulous2.0 (Split->classify->merge->GenSq)
  classify-segments 03 `classify` fasta binary
  run               HAST.sh end-to-end orchestrator
  mark-library      tools/mark_library.sh
  classify-hic      tools/classify_hic_reads.sh

Usage: python -m hast_jax.cli <subcommand> --help
"""

from __future__ import annotations

import argparse
import os
import sys


def _split_paths(values):
    """Reference drivers accept quoted whitespace-separated file lists
    (HAST.sh:23-37); flatten those in every repeatable path flag."""
    out = []
    for v in values or []:
        out.extend(v.split())
    return out


def _add_build_markers(sub):
    p = sub.add_parser("build-markers", help="stage 00: unique marker mers")
    p.add_argument("--paternal", action="append", required=True)
    p.add_argument("--maternal", action="append", required=True)
    p.add_argument("--mer", type=int, default=21)
    p.add_argument("--auto_bounds", action="store_true")
    p.add_argument("--m-lower", type=int, default=9)
    p.add_argument("--m-upper", type=int, default=33)
    p.add_argument("--p-lower", type=int, default=9)
    p.add_argument("--p-upper", type=int, default=33)
    p.add_argument("--out-dir", default=".")
    p.add_argument("--batch-size", type=int, default=1 << 14)
    p.add_argument("--count-parts", type=int, default=None,
                   help="split the k-mer key space into N ranges counted "
                        "in N passes (memory-bounded counting for inputs "
                        "whose distinct set exceeds device memory); "
                        "default HAST_COUNT_PARTS or 1")
    p.add_argument("--engine", choices=("auto", "device", "host"),
                   default=None,
                   help="device: count tables stay on the device, set algebra "
                        "on device, only final markers fetched (one "
                        "all-or-nothing checkpoint); host: per-substep "
                        ".counts.npz snapshots + finer resume; auto "
                        "(default): device on an accelerator, host on "
                        "CPU.  HAST_STAGE00_ENGINE overrides.")
    p.add_argument("--mesh", default=None, metavar="DPx1|auto",
                   help="run stage 00 with count tables hash-range-"
                        "sharded across a device mesh (per-chip "
                        "residency = distinct/DP; auto = all devices)")
    p.add_argument("--thread", type=int, default=None,
                   help="accepted for reference compatibility (unused)")
    p.add_argument("--memory", type=int, default=None,
                   help="accepted for reference compatibility (unused)")

    def run(a):
        from hast_jax.pipeline import markers as M
        from hast_jax.utils.checkpoint import step
        # reference sanity bounds (build_unshared_kmers.sh:145-152)
        if a.mer < 11 or a.mer > 31:
            sys.exit("ERROR : arguments invalid ... exit!!! (11 <= mer <= 31)")
        if not (1 <= a.m_lower and a.m_upper <= 100000000
                and 1 <= a.p_lower and a.p_upper <= 100000000):
            sys.exit("ERROR : arguments invalid ... exit!!! ")
        with step("00_markers", a.out_dir) as todo:
            if todo:
                if a.mesh:
                    import jax

                    from hast_jax.parallel.distributed import \
                        build_unshared_markers_mesh
                    from hast_jax.parallel.mesh import make_mesh
                    if a.mesh == "auto":
                        dp = len(jax.devices())
                    else:
                        parts = a.mesh.lower().split("x")
                        dp = int(parts[0])
                        # stage 00 has no tp axis; reject a non-1 second
                        # component instead of silently ignoring it
                        if len(parts) > 1 and parts[1] not in ("", "1"):
                            sys.exit("ERROR: build-markers --mesh shards "
                                     "count tables over DP only; use "
                                     f"'{dp}' or '{dp}x1' (got {a.mesh})")
                    build_unshared_markers_mesh(
                        make_mesh(dp, tp=1),
                        _split_paths(a.paternal),
                        _split_paths(a.maternal),
                        a.out_dir, k=a.mer, auto_bounds=a.auto_bounds,
                        p_lower=a.p_lower, p_upper=a.p_upper,
                        m_lower=a.m_lower, m_upper=a.m_upper,
                        batch_size=a.batch_size)
                else:
                    M.build_unshared_markers(
                        _split_paths(a.paternal),
                        _split_paths(a.maternal),
                        a.out_dir, k=a.mer,
                        auto_bounds=a.auto_bounds,
                        p_lower=a.p_lower, p_upper=a.p_upper,
                        m_lower=a.m_lower, m_upper=a.m_upper,
                        batch_size=a.batch_size, n_parts=a.count_parts,
                        engine=a.engine)
    p.set_defaults(func=run)


def _add_classify(sub):
    p = sub.add_parser("classify", help="stage 01: classify stLFR reads")
    p.add_argument("--hap0", required=True)
    p.add_argument("--hap1", required=True)
    p.add_argument("--read", action="append", required=True)
    p.add_argument("--weight0", type=float, default=1.0)
    p.add_argument("--weight1", type=float, default=1.0)
    p.add_argument("--adaptor_f", default=None)
    p.add_argument("--adaptor_r", default=None)
    p.add_argument("--batch-size", type=int, default=1 << 15)
    p.add_argument("--thread", type=int, default=None,
                   help="accepted for reference compatibility (unused)")
    p.add_argument("--output", default="-")
    p.add_argument("--mesh", default=None, metavar="DPxTP",
                   help="shard over local devices: DPxTP (e.g. 4x2; table over tp, reads over dp) or 'auto'")

    def run(a):
        import os as _os
        if int(_os.environ.get("HAST_NUM_PROCESSES", "1")) > 1:
            # multi-host: jax.distributed first, before any backend use
            from hast_jax.parallel import distributed as D
            D.initialize()
            import jax
            from hast_jax.pipeline import classify as C
            table = C.load_marker_table(a.hap0, a.hap1)
            kw = {}
            if a.adaptor_f is not None:
                kw["adaptor_f"] = a.adaptor_f
            if a.adaptor_r is not None:
                kw["adaptor_r"] = a.adaptor_r
            C.erase_adaptors(table, **kw)
            tp = 1
            if a.mesh and a.mesh != "auto":
                _, tp = (int(x) for x in a.mesh.lower().split("x"))
            tally = D.classify_fastqs_multihost(
                table, _split_paths(a.read), batch_size=a.batch_size, tp=tp)
            if jax.process_index() == 0:
                out = sys.stdout.buffer if a.output == "-" \
                    else open(a.output, "wb")
                C.write_phased_barcodes(tally, table, out,
                                        a.weight0, a.weight1)
                if out is not sys.stdout.buffer:
                    out.close()
            return
        from hast_jax.pipeline import classify as C
        out = sys.stdout.buffer if a.output == "-" else open(a.output, "wb")
        kw = {}
        if a.adaptor_f is not None:
            kw["adaptor_f"] = a.adaptor_f
        if a.adaptor_r is not None:
            kw["adaptor_r"] = a.adaptor_r
        if a.mesh:
            import jax
            from hast_jax.parallel.mesh import make_mesh, choose_tp
            table = C.load_marker_table(a.hap0, a.hap1)
            C.erase_adaptors(table, **kw)
            if a.mesh == "auto":
                n = len(jax.devices())
                tp = choose_tp(table.data.nbytes, n)
                dp = n // tp
            else:
                dp, tp = (int(x) for x in a.mesh.lower().split("x"))
            mesh = make_mesh(dp * tp, tp=tp)
            tally = C.classify_fastqs_mesh(mesh, table, a.read,
                                           batch_size=a.batch_size)
            C.write_phased_barcodes(tally, table, out, a.weight0, a.weight1)
        else:
            C.run_classify(a.hap0, a.hap1, _split_paths(a.read), out,
                           w0=a.weight0, w1=a.weight1,
                           batch_size=a.batch_size, **kw)
        if out is not sys.stdout.buffer:
            out.close()
    p.set_defaults(func=run)


def _add_classify_reads(sub):
    p = sub.add_parser("classify-reads",
                       help="stage 01 driver: classify + split + quartering")
    p.add_argument("--paternal_mer", required=True)
    p.add_argument("--maternal_mer", required=True)
    p.add_argument("--filial", action="append", required=True)
    p.add_argument("--adaptor_f", default=None)
    p.add_argument("--adaptor_r", default=None)
    p.add_argument("--workdir", default=".")
    p.add_argument("--batch-size", type=int, default=1 << 15)
    p.add_argument("--thread", type=int, default=None,
                   help="accepted for reference compatibility (unused)")
    p.add_argument("--format", choices=("fasta", "fastq"), default="fastq",
                   help="accepted for reference compatibility")
    p.add_argument("--mesh", default=None, metavar="DPxTP|auto",
                   help="classify on a device mesh (reads dp-split, "
                        "marker table tp-sharded; auto = all devices, "
                        "tp=1)")

    def run(a):
        from hast_jax.pipeline import classify as C
        from hast_jax.pipeline import partition as P
        from hast_jax.utils.checkpoint import step
        wd = a.workdir
        kw = {}
        if a.mesh:
            import jax

            from hast_jax.parallel.mesh import make_mesh
            if a.mesh == "auto":
                dp, tp = len(jax.devices()), 1
            else:
                dp, tp = (int(x) for x in a.mesh.lower().split("x"))
            kw["mesh"] = make_mesh(dp * tp, tp=tp)
        if a.adaptor_f is not None:
            kw["adaptor_f"] = a.adaptor_f
        if a.adaptor_r is not None:
            kw["adaptor_r"] = a.adaptor_r
        filial = _split_paths(a.filial)
        phased = os.path.join(wd, "phased.barcodes")
        with step("9", wd) as todo:
            if todo:
                # driver parity: weight0=1.04 (classify_stlfr_reads.sh:148)
                with open(phased, "wb") as out:
                    C.run_classify(a.paternal_mer, a.maternal_mer, filial,
                                   out, w0=1.04,
                                   batch_size=a.batch_size, **kw)
        with step("10", wd) as todo:
            if todo:
                paths = P.split_barcodes(phased, out_prefix=wd + os.sep)
                for hap, name in (("0", "paternal"), ("1", "maternal"),
                                  ("-1", "homozygous")):
                    n = sum(1 for _ in open(paths[hap], "rb"))
                    print(f"final {name} barcodes : {n}")
        with step("11", wd) as todo:
            if todo:
                cwd = os.getcwd()
                os.chdir(wd)
                try:
                    for x in filial:
                        x = x if os.path.isabs(x) else os.path.join(cwd, x)
                        P.quarter_fastq(
                            x, "paternal.unique.barcodes",
                            "maternal.unique.barcodes",
                            "homozygous.unique.barcodes")
                finally:
                    os.chdir(cwd)
    p.set_defaults(func=run)


def _add_merge_results(sub):
    p = sub.add_parser("merge-results",
                       help="merge sharded phased.barcodes (fixed semantics)")
    p.add_argument("--input", action="append", required=True)
    p.add_argument("--size0", type=int, help="hap0 marker set size")
    p.add_argument("--size1", type=int, help="hap1 marker set size")
    p.add_argument("--hap0", help="recompute sizes from mer files")
    p.add_argument("--hap1")
    p.add_argument("--weight0", type=float, default=1.0)
    p.add_argument("--weight1", type=float, default=1.0)

    def run(a):
        from hast_jax.parallel import merge as PM
        size0, size1 = a.size0, a.size1
        if size0 is None or size1 is None:
            if not (a.hap0 and a.hap1):
                sys.exit("need --size0/--size1 or --hap0/--hap1")
            from hast_jax.pipeline import classify as C
            table = C.load_marker_table(a.hap0, a.hap1)
            C.erase_adaptors(table)
            size0, size1 = table.set_sizes
        PM.merge_phased_files(a.input, sys.stdout.buffer, size0, size1,
                              a.weight0, a.weight1)
    p.set_defaults(func=run)


def _add_prepare_10x(sub):
    p = sub.add_parser("prepare-10x", help="stage 02: fake-10X conversion")
    p.add_argument("--read1", action="append", required=True)
    p.add_argument("--read2", action="append", required=True)
    p.add_argument("--whitelist", required=True)
    p.add_argument("--min_rp", type=int, default=1)
    p.add_argument("--out-dir", default=".")

    def run(a):
        from hast_jax.pipeline import tenx as T
        total, used = T.prepare_10x(a.read1, a.read2, a.whitelist,
                                    a.out_dir, a.min_rp)
        print(f"Total {total} pairs and used {used} pairs")
    p.set_defaults(func=run)


def _add_assemble(sub):
    p = sub.add_parser("assemble", help="stage 02: run external Supernova")
    p.add_argument("--supernova", required=True)
    p.add_argument("--read1", action="append", required=True)
    p.add_argument("--read2", action="append", required=True)
    p.add_argument("--prefix", default="output")
    p.add_argument("--thread", type=int, default=30)
    p.add_argument("--memory", type=int, default=800)
    p.add_argument("--min_rp", type=int, default=1)
    p.add_argument("--out-dir", default=".")

    def run(a):
        import glob as _glob
        from hast_jax.pipeline import tenx as T
        wl = _glob.glob(os.path.join(
            a.supernova, "supernova-cs", "*", "tenkit", "lib", "python",
            "tenkit", "barcodes", "4M-with-alts-february-2016.txt"))
        if not wl:
            sys.exit(f"{a.supernova} is not a valid supernova path")
        T.prepare_10x(a.read1, a.read2, wl[0], a.out_dir, a.min_rp)
        T.assemble(a.supernova, a.out_dir, a.prefix, a.thread, a.memory)
    p.set_defaults(func=run)


def _add_mkoutput(sub):
    p = sub.add_parser("mkoutput", help="stage 03: re-phase pseudohap2")
    p.add_argument("--assembly_path", required=True)
    p.add_argument("--paternal_mer")
    p.add_argument("--maternal_mer")
    p.add_argument("--prefix", default="output")
    p.add_argument("--thread", type=int, default=None,
                   help="accepted for reference compatibility (unused)")
    p.add_argument("--prefer", choices=("paternal", "maternal"),
                   help="default: whichever mer flag came first "
                        "(reference order rule); fallback paternal")
    p.add_argument("--workdir", default=".")

    def run(a):
        from hast_jax.pipeline import rephase as R
        prefer = a.prefer
        if prefer is None:
            # reference rule: first --*_mer on the command line wins
            argv = sys.argv
            pi = argv.index("--paternal_mer") if "--paternal_mer" in argv \
                else 1 << 30
            mi = argv.index("--maternal_mer") if "--maternal_mer" in argv \
                else 1 << 30
            prefer = "paternal" if pi <= mi else "maternal"
        R.mkoutput(a.assembly_path, a.prefix, a.paternal_mer,
                   a.maternal_mer, prefer, a.workdir)
    p.set_defaults(func=run)


def _add_classify_segments(sub):
    p = sub.add_parser("classify-segments",
                       help="stage 03: per-sequence haplotype verdicts")
    p.add_argument("--hap", action="append", required=True)
    p.add_argument("--read", action="append", required=True)
    p.add_argument("--format", choices=("fasta", "fastq"), default="fasta")
    p.add_argument("--thread", type=int, default=None,
                   help="accepted for reference compatibility (unused)")

    def run(a):
        from hast_jax.pipeline import rephase as R
        R.classify_segments(a.hap, a.read, _stdout_text(), a.format)
    p.set_defaults(func=run)


def _add_run(sub):
    p = sub.add_parser("run", help="end-to-end HAST pipeline (HAST.sh)")
    p.add_argument("--paternal", action="append", required=True)
    p.add_argument("--maternal", action="append", required=True)
    p.add_argument("--read1", action="append", required=True)
    p.add_argument("--read2", action="append", required=True)
    p.add_argument("--supernova", help="optional; stops after stage 01 "
                                       "prep if absent")
    p.add_argument("--thread", type=int, default=8)
    p.add_argument("--memory", type=int, default=800)
    p.add_argument("--workdir", default=".")

    def run(a):
        from hast_jax.models.trio import TrioBinningPipeline
        TrioBinningPipeline(
            paternal=_split_paths(a.paternal),
            maternal=_split_paths(a.maternal),
            read1=_split_paths(a.read1), read2=_split_paths(a.read2),
            supernova=a.supernova,
            threads=a.thread, memory_gb=a.memory,
            workdir=a.workdir).run()
    p.set_defaults(func=run)


def _add_mark_library(sub):
    p = sub.add_parser("mark-library",
                       help="prefix barcodes with libN_ (tools/mark_library)")
    p.add_argument("input")
    p.add_argument("lib_id", type=int)

    def run(a):
        from hast_jax.tools.mark_library import mark_library
        if a.lib_id < 1:
            sys.exit(f"invalid lib_id : {a.lib_id}")
        mark_library(a.input, a.lib_id, sys.stdout.buffer)
    p.set_defaults(func=run)


def _add_classify_hic(sub):
    p = sub.add_parser("classify-hic",
                       help="trio-bin Hi-C reads from two SAMs")
    p.add_argument("pat_sam")
    p.add_argument("mat_sam")
    p.add_argument("--out-dir", default=".")

    def run(a):
        from hast_jax.tools.hic import classify_hic_reads
        classify_hic_reads(a.pat_sam, a.mat_sam, a.out_dir)
    p.set_defaults(func=run)


def _add_vcfqc(sub):
    """All ten self_vcftools programs as vcf-* subcommands."""

    def run_deferred(name, nargs, help_, fn_name):
        p = sub.add_parser(name, help=help_)
        for arg in nargs:
            p.add_argument(arg)

        def run(a):
            from hast_jax.tools import vcfqc as V
            fn = getattr(V, fn_name)
            fn(*[getattr(a, arg) for arg in nargs], _stdout_text())
        p.set_defaults(func=run)

    run_deferred("vcf-snp-only", ["vcf"],
                 "GetSNPOnly: echo SNP lines", "get_snp_only")
    run_deferred("vcf-snp-info", ["vcf"],
                 "GetSNPInfo: CHROM POS ALT1 ALT2", "get_snp_info")
    run_deferred("vcf-phased-snp", ["vcf"],
                 "PhasedSNP: phased het SNPs + PS blocks", "phased_snp")
    run_deferred("vcf-dipcall-hapsnp", ["vcf"],
                 "GetHapSNP_fromDipcall", "get_hapsnp_from_dipcall")
    run_deferred("vcf-merge-hap-snp", ["hap1_vcf", "hap2_vcf"],
                 "MergeHapSNP: pair SNPs across hap VCFs (chr1-22)",
                 "merge_hap_snp")
    run_deferred("vcf-hap-inherit", ["parent_vcf", "child_vcf"],
                 "HapInherit: inheritance typing vs one parent",
                 "hap_inherit")
    run_deferred("vcf-inherit-solid", ["p1_vcf", "p2_vcf", "f1_vcf"],
                 "InheritSolidSNP: trio-consistent solid SNPs",
                 "inherit_solid_snp")
    run_deferred("vcf-inherit-3aa", ["p1_vcf", "p2_vcf", "f1_vcf"],
                 "Inherit3Aa: both-parents-both-alleles SNPs",
                 "inherit_3aa")
    run_deferred("vcf-phase-inherit-solid", ["p1_vcf", "p2_vcf", "f1_vcf"],
                 "PhaseInheritSolidSNP (stats only, as shipped)",
                 "phase_inherit_solid_snp")

    p = sub.add_parser("vcf-calc-hd",
                       help="CalcHD: Hamming + switch error rate")
    p.add_argument("true_phased_blocks")
    p.add_argument("merged_snps")

    def run_hd(a):
        from hast_jax.tools import vcfqc as V
        V.calc_hd(a.true_phased_blocks, a.merged_snps)
    p.set_defaults(func=run_hd)


class _StdoutText:
    """Text shim over sys.stdout.buffer that never closes it."""

    def write(self, s):
        sys.stdout.buffer.write(s.encode())

    def flush(self):
        try:
            sys.stdout.buffer.flush()
        except Exception:
            pass


def _stdout_text():
    return _StdoutText()


def _add_heatalign(sub):
    p = sub.add_parser("draw-heatalign",
                       help="KIR/MHC alignment heat SVG to stdout")
    p.add_argument("ref_len", type=int)
    p.add_argument("-i", dest="aligns", action="append", required=True,
                   help="xxx.align.txt (repeatable)")
    p.add_argument("-g", dest="genes", default=None)
    p.add_argument("--preset", choices=("KIR", "MHC"), default="KIR")

    def run(a):
        from hast_jax.tools.heatalign import draw_heatalign
        draw_heatalign(a.ref_len, a.aligns, _stdout_text(),
                       gene_file=a.genes, preset=a.preset)
    p.set_defaults(func=run)

    p2 = sub.add_parser("get-n", help="report N runs in fasta (stdin)")

    def run_n(a):
        from hast_jax.tools.heatalign import get_n
        get_n(sys.stdin, _stdout_text())
    p2.set_defaults(func=run_n)

    p3 = sub.add_parser("check-genes",
                        help="per-gene alignment coverage fraction")
    p3.add_argument("align_txt")
    p3.add_argument("genes_txt")

    def run_g(a):
        from hast_jax.tools.heatalign import check_genes
        check_genes(a.align_txt, a.genes_txt, _stdout_text())
    p3.set_defaults(func=run_g)


def _add_plot_bounds(sub):
    p = sub.add_parser("plot-bounds",
                       help="k-mer depth histogram plot (draw_bounds.py)")
    p.add_argument("--workdir", default=".")
    p.add_argument("--out", default="test.png")

    def run(a):
        from hast_jax.utils.plot_bounds import plot_bounds
        path = plot_bounds(a.workdir, a.out)
        print(path if path else "matplotlib unavailable; skipped")
    p.set_defaults(func=run)


def _add_warmup(sub):
    p = sub.add_parser(
        "warmup",
        help="precompile the hot device programs into the persistent "
             "jit cache so production runs start hot (the reference "
             "binaries' ship-warm analog)")
    p.add_argument("--hap0", help="real marker file (compiles at the "
                                  "deployment table's exact shape)")
    p.add_argument("--hap1")
    p.add_argument("--markers", type=int, default=2_000_000,
                   help="synthetic marker count per hap when no real "
                        "files are given (sizes the probe table)")
    p.add_argument("--read-len", type=int, default=100,
                   help="typical read length (sets the device stride)")
    p.add_argument("--reads", type=int, default=1 << 17,
                   help="synthetic reads to stream (covers the "
                        "steady-state + tail batch shapes)")
    p.add_argument("--mer", type=int, default=21)

    def run(a):
        import tempfile
        import time

        import jax
        import numpy as np

        from hast_jax.ops import encode as E
        from hast_jax.ops import kmer_count as KC
        from hast_jax.pipeline import classify as C

        t0 = time.perf_counter()
        k = a.mer
        rng = np.random.default_rng(0)
        if a.hap0 and a.hap1:
            table = C.load_marker_table(a.hap0, a.hap1)
        else:
            seqs = rng.integers(0, 4, size=(2 * a.markers, k),
                                dtype=np.int32)
            hi, lo = E.canonical_kmers_np(seqs, k)
            pay = np.repeat(np.array([1, 2], np.uint32), a.markers)
            from hast_jax.ops import hashtable as H
            table = H.build_table(hi[:, 0], lo[:, 0], pay, k,
                                  set_sizes=(a.markers, a.markers))
        C.erase_adaptors(table)
        table.device_put()
        letters = np.frombuffer(b"ACGT", np.uint8)
        with tempfile.TemporaryDirectory() as td:
            fq = os.path.join(td, "warm.fq")
            n, L = a.reads, a.read_len
            arr = letters[rng.integers(0, 4, (n, L))]
            with open(fq, "wb", buffering=1 << 22) as f:
                qual = b"F" * L
                for i in range(n):
                    f.write(b"@w%d#%d_%d_%d/1\n%s\n+\n%s\n" % (
                        i, 1 + i % 97, 2, 3, arr[i].tobytes(), qual))
            # the real streaming classify: compiles tally_step /
            # vote kernels / _pack_acc at production shapes into the
            # persistent cache
            C.classify_fastqs(table, [fq])
            # stage-00 kernels at the counting batch shape
            from hast_jax.pipeline.markers import count_files_device
            t = count_files_device([fq], k)
            t.histo()
            KC.device_marker_algebra(t, t, 1, 2, 1, 2)
        print(f"warm: {time.perf_counter() - t0:.1f}s "
              f"(cache: {jax.config.jax_compilation_cache_dir})")
    p.set_defaults(func=run)


def _add_filter_barcodes(sub):
    p = sub.add_parser("filter-fastq-by-barcodes",
                       help="keep records whose barcode is listed "
                            "(filter_fq_by_barcodes.awk)")
    p.add_argument("fastq")
    p.add_argument("barcode_list")

    def run(a):
        from hast_jax.pipeline.partition import filter_fastq_by_barcodes
        filter_fastq_by_barcodes(a.fastq, a.barcode_list, sys.stdout.buffer)
    p.set_defaults(func=run)


def main(argv=None):
    from hast_jax.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    parser = argparse.ArgumentParser(
        prog="hast_jax", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)
    for add in (_add_build_markers, _add_classify, _add_classify_reads,
                _add_merge_results, _add_prepare_10x, _add_assemble,
                _add_mkoutput, _add_classify_segments, _add_run,
                _add_mark_library, _add_classify_hic, _add_vcfqc,
                _add_heatalign, _add_plot_bounds, _add_filter_barcodes,
                _add_warmup):
        add(sub)
    args = parser.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
