"""Stage 00 — parental unique-marker construction.

JAX replacement for the reference jellyfish pipeline
(/root/reference/00.build_unshare_kmers_by_jellyfish/build_unshared_kmers.sh):

  reference (disk-roundtripped jellyfish invocations)   ->  here
  ------------------------------------------------------------------
  count -C per parent              (:188-221)           count_file(s)
  histo + find_bounds.awk          (analysis_kmercount) histo_rows + find_bounds
  dump -L lo -U up                 (:257-268)           CountTable.filter_range
  2*mat.fa + 1*pat.fa count trick  (:271-283)           CountTable.difference
  unique∩filter re-count           (:285-298)           filter_range(unique)
  *.unique.filter.mer text dump    (:290-291)           dump_mer_text

The count trick and the set ops are algebraically identical: a k-mer of
parent A is "unique" iff absent from parent B's count table, and the
final marker set is unique(A) ∩ count-range(A).  The meryl variant
(00.dev_build_unshare_kmers_by_meryl) states the same algebra as
explicit set ops — this module is its array formulation.
"""

from __future__ import annotations

import os
import sys
from typing import Sequence


from hast_jax.io import fastq as FQ
from hast_jax.ops import kmer_count as KC

DEFAULT_K = 21
DEFAULT_LOWER = 9
DEFAULT_UPPER = 33


def count_files(paths: Sequence[str], k: int,
                batch_size: int = FQ.DEFAULT_BATCH,
                n_parts: int | None = None) -> KC.CountTable:
    """Count canonical k-mers over fasta/fastq files (jellyfish count -C).

    n_parts > 1 runs the HBM-bounded multi-pass partitioned counter
    (pass p keeps only key range p; input re-streamed per pass) for
    inputs whose distinct set exceeds one chip's HBM — SURVEY §7.3's
    human-scale plan.  Default comes from HAST_COUNT_PARTS (else 1).
    """
    if n_parts is None:
        n_parts = int(os.environ.get("HAST_COUNT_PARTS", "1"))
    if n_parts > 1:
        def source():
            for path in paths:
                yield from FQ.sequence_batches(path, k, batch_size)
        return KC.count_batches_partitioned(source, k, n_parts)
    counter = KC.Counter(k)
    for path in paths:
        t = KC.count_file_native(path, k, batch_size)
        if t is None:
            t = KC.count_batches(
                FQ.sequence_batches(path, k, batch_size), k)
        counter.add_table(t)
    return counter.finalize()


def count_files_device(paths: Sequence[str], k: int,
                       batch_size: int = FQ.DEFAULT_BATCH
                       ) -> KC.DeviceCountTable:
    """Count canonical k-mers keeping the table resident in HBM.

    Same engines as :func:`count_files` (native reader with python
    fallback) but nothing is fetched: multi-file runs union-sum via
    :meth:`DeviceCounter.merge_device` and the result stays on device
    for the stage-00 histogram/set algebra."""
    total = KC.DeviceCounter(k)
    for path in paths:
        dc = KC.count_file_native(path, k, batch_size, finalize=False)
        if dc is None:
            dc = KC.count_batches(
                FQ.sequence_batches(path, k, batch_size), k,
                finalize=False)
        total.merge_device(dc)
    return total.finalize_device()


def count_files_device_pair(a_paths: Sequence[str],
                            b_paths: Sequence[str], k: int,
                            batch_size: int = FQ.DEFAULT_BATCH):
    """Count BOTH parents with their host legs overlapped.

    The stage-00 count leg is expected to be host-bound (reader +
    super-batch assembly + h2d; not yet measured on the GPU), so the
    two parents' host legs overlap instead of counting serially.  Each
    parent's stream is unchanged and deterministic — they only
    interleave device dispatches, and the folds use separate
    accumulators — so tables are bit-identical to the serial path; one
    parent's reader threads and numpy assembly now run while the
    other's device folds drain.  Returns (a_table, b_table)."""
    import threading

    out: dict = {}

    def work(tag, paths):
        try:
            out[tag] = count_files_device(paths, k, batch_size)
        except BaseException as e:   # re-raised on the caller thread
            out[tag] = e

    KC.DeviceCounter.SYNC_FOLDS = True   # see DeviceCounter._FOLD_LOCK
    try:
        t = threading.Thread(target=work, args=("a", a_paths),
                             name="hast-count-a")
        t.start()
        work("b", b_paths)
        t.join()
    finally:
        KC.DeviceCounter.SYNC_FOLDS = False
    if isinstance(out["a"], BaseException):
        raise out["a"]
    if isinstance(out["b"], BaseException):
        raise out["b"]
    return out["a"], out["b"]


def histo_rows(table, high: int = 10000):
    """(count_value, n_kmers) rows exactly as `jellyfish histo` prints:
    non-zero bins only, counts > high lumped into the high+1 row."""
    h = table.histo(high=high)
    return [(int(v), int(h[v])) for v in range(1, high + 2) if h[v] > 0]


def find_bounds(rows) -> dict[str, int]:
    """Replicates find_bounds.awk byte-for-byte on jellyfish histo rows.

    (/root/reference/00.build_unshare_kmers_by_jellyfish/find_bounds.awk:
    state 0 walks down to the first local minimum — a row whose freq
    does not set a new minimum flips to state 1 *without* being
    considered for the max; state 1 then tracks the running maximum.
    LOWER = MIN_INDEX+1, UPPER = 3*MAX_INDEX - 2*MIN_INDEX - 1.)
    """
    MIN = MIN_INDEX = MAX = MAX_INDEX = 0
    state = 0
    for i, c in rows:
        if state == 0:
            if MIN == 0 or c < MIN:
                MIN, MIN_INDEX = c, i
            else:
                state = 1
        else:
            if MAX == 0 or c > MAX:
                MAX, MAX_INDEX = c, i
    up_bounds = 3 * MAX_INDEX - 2 * MIN_INDEX
    return {
        "MIN_INDEX": MIN_INDEX,
        "MAX_INDEX": MAX_INDEX,
        "LOWER_INDEX": MIN_INDEX + 1,
        "UPPER_INDEX": up_bounds - 1,
    }


def write_bounds(bounds: dict[str, int], path: str) -> None:
    """maternal.bounds.txt / paternal.bounds.txt format."""
    with open(path, "w") as f:
        for key in ("MIN_INDEX", "MAX_INDEX", "LOWER_INDEX", "UPPER_INDEX"):
            f.write(f"{key}={bounds[key]}\n")


def write_histo(rows, path: str) -> None:
    with open(path, "w") as f:
        for v, c in rows:
            f.write(f"{v} {c}\n")


def build_unshared_markers(
    paternal: Sequence[str], maternal: Sequence[str], out_dir: str = ".",
    k: int = DEFAULT_K, auto_bounds: bool = False,
    p_lower: int = DEFAULT_LOWER, p_upper: int = DEFAULT_UPPER,
    m_lower: int = DEFAULT_LOWER, m_upper: int = DEFAULT_UPPER,
    batch_size: int = FQ.DEFAULT_BATCH, log=sys.stderr,
    n_parts: int | None = None, engine: str | None = None,
) -> dict[str, str]:
    """Full stage 00: parent counting -> bounds -> unique.filter.mer files.

    Returns paths of the two marker files (the stage 00/01 interface).

    engine:
      "device" — both parents' count tables stay resident in HBM;
        histogram, set difference and range filter run as device
        kernels and only the final marker rows are fetched (~100x less
        device->host traffic than fetching the distinct sets).  One
        all-or-nothing checkpoint step.
      "host"  — tables are fetched and snapshotted per sub-step
        (.counts.npz), giving the reference's finer-grained
        step_NN_done resume (build_unshared_kmers.sh:167-298) at the
        cost of shipping every distinct k-mer to the host.
      None/"auto" — device when a non-CPU backend is attached and
        single-pass; host otherwise.  HAST_STAGE00_ENGINE overrides.
    """
    if engine is None:
        engine = os.environ.get("HAST_STAGE00_ENGINE", "auto")
    if engine == "auto":
        import jax
        engine = "device" if jax.default_backend() != "cpu" else "host"
    if engine == "device":
        return _build_unshared_markers_device(
            paternal, maternal, out_dir, k, auto_bounds,
            p_lower, p_upper, m_lower, m_upper, batch_size, log,
            n_parts=n_parts
            or int(os.environ.get("HAST_COUNT_PARTS", "1")))

    from hast_jax.utils.checkpoint import step
    from hast_jax.utils.profiling import PhaseTimer
    timer = PhaseTimer(log=log)
    j = lambda name: os.path.join(out_dir, name)
    print("extract unique mers (host set algebra) ...", file=log)

    # resumable sub-steps with on-disk count-table snapshots — the
    # reference guards each jellyfish invocation with step_NN_done and
    # keeps the .jf DBs between them (build_unshared_kmers.sh:167-298);
    # a crash after one parent's count no longer redoes it.
    mat = pat = None
    with step("00.1_count_maternal", out_dir, log=log) as todo:
        if todo:
            with timer.phase("count_maternal"):
                mat = count_files(maternal, k, batch_size, n_parts)
            timer.add_items("count_maternal", mat.total)
            mat.save(j("maternal.counts.npz"))
    if mat is None:
        mat = KC.CountTable.load(j("maternal.counts.npz"))
    with step("00.2_count_paternal", out_dir, log=log) as todo:
        if todo:
            with timer.phase("count_paternal"):
                pat = count_files(paternal, k, batch_size, n_parts)
            timer.add_items("count_paternal", pat.total)
            pat.save(j("paternal.counts.npz"))
    if pat is None:
        pat = KC.CountTable.load(j("paternal.counts.npz"))
    print(f"  maternal: {mat.n_distinct} distinct / {mat.total} total "
          f"{k}-mers", file=log)
    print(f"  paternal: {pat.n_distinct} distinct / {pat.total} total "
          f"{k}-mers", file=log)

    m_rows, p_rows = histo_rows(mat), histo_rows(pat)
    with step("00.3_bounds", out_dir, log=log) as todo:
        if todo:
            write_histo(m_rows, j("maternal.kmercount.histo"))
            write_histo(p_rows, j("paternal.kmercount.histo"))
            if auto_bounds:
                mb, pb = find_bounds(m_rows), find_bounds(p_rows)
                write_bounds(mb, j("maternal.bounds.txt"))
                write_bounds(pb, j("paternal.bounds.txt"))
    if auto_bounds:
        mb, pb = find_bounds(m_rows), find_bounds(p_rows)
        m_lower, m_upper = mb["LOWER_INDEX"], mb["UPPER_INDEX"]
        p_lower, p_upper = pb["LOWER_INDEX"], pb["UPPER_INDEX"]
    print(f"  the real used kmer-count bounds of maternal is "
          f"[ {m_lower} , {m_upper} ] ", file=log)
    print(f"  the real used kmer-count bounds of paternal is "
          f"[ {p_lower} , {p_upper} ] ", file=log)

    paths = {
        "paternal": j("paternal.unique.filter.mer"),
        "maternal": j("maternal.unique.filter.mer"),
    }
    with step("00.4_markers", out_dir, log=log) as todo:
        if todo:
            with timer.phase("marker_algebra"):
                pat_final = pat.difference(mat).filter_range(
                    p_lower, p_upper)
                mat_final = mat.difference(pat).filter_range(
                    m_lower, m_upper)
            n_p = pat_final.dump_mer_text(paths["paternal"])
            n_m = mat_final.dump_mer_text(paths["maternal"])
        else:
            with open(paths["paternal"], "rb") as fp:
                n_p = sum(1 for _ in fp)
            with open(paths["maternal"], "rb") as fm:
                n_m = sum(1 for _ in fm)
    print(f"final paternal unique kmer is : {n_p}", file=log)
    print(f"final maternal unique kmer is : {n_m}", file=log)
    timer.report()
    return paths


def _dump_words(words, k: int, path: str) -> int:
    s = KC.words_to_strings(words, k)
    with open(path, "wb") as f:
        if s.size:
            f.write(b"\n".join(s.tolist()) + b"\n")
    return int(s.size)


def _rows_from_hist(hist) -> list[tuple[int, int]]:
    """histo_rows semantics over a raw (high+2,) bin array."""
    return [(v, int(hist[v])) for v in range(1, len(hist)) if hist[v] > 0]


def _build_unshared_markers_device(
        paternal, maternal, out_dir, k, auto_bounds,
        p_lower, p_upper, m_lower, m_upper, batch_size, log,
        n_parts: int = 1,
) -> dict[str, str]:
    """Device-resident stage 00 (see build_unshared_markers docstring).

    Everything between reading input bytes and writing the final
    `.mer`/`.histo`/`.bounds.txt` text happens in HBM — the analog of
    jellyfish doing its whole count inside the in-memory -s hash, but
    extended over the ENTIRE stage: the reference round-trips every
    sub-step through dump files on disk
    (build_unshared_kmers.sh:229-298) while this fetches KB of
    histogram plus the final marker rows only.

    n_parts > 1 is the human-scale variant: the key space splits into
    quantile ranges (shared by both parents, so per-range algebra is
    complete) and runs as TWO sweeps of n_parts passes each — sweep A
    accumulates the global histograms (bounds need all ranges), sweep
    B recounts each range with both parents resident and fetches only
    that range's markers.  2x the counting of the host path, but the
    distinct sets never cross the device->host link (36 GB/parent at
    human scale).
    """
    from hast_jax.utils.checkpoint import step
    from hast_jax.utils.profiling import PhaseTimer
    import numpy as np
    timer = PhaseTimer(log=log)
    j = lambda name: os.path.join(out_dir, name)
    print("extract unique mers (device-resident count tables) ...",
          file=log)
    paths = {
        "paternal": j("paternal.unique.filter.mer"),
        "maternal": j("maternal.unique.filter.mer"),
    }
    with step("00.device_markers", out_dir, log=log) as todo:
        if todo and n_parts <= 1:
            with timer.phase("count_parents"):
                # both parents' host legs overlapped (reader/assembly
                # of one runs while the other's device folds drain);
                # tables bit-identical to serial counting
                mat, pat = count_files_device_pair(maternal, paternal,
                                                   k, batch_size)
            timer.add_items("count_parents", mat.total + pat.total)
            print(f"  maternal: {mat.n_distinct} distinct / {mat.total} "
                  f"total {k}-mers", file=log)
            print(f"  paternal: {pat.n_distinct} distinct / {pat.total} "
                  f"total {k}-mers", file=log)
            with timer.phase("bounds"):
                m_rows, p_rows = histo_rows(mat), histo_rows(pat)
                write_histo(m_rows, j("maternal.kmercount.histo"))
                write_histo(p_rows, j("paternal.kmercount.histo"))
                if auto_bounds:
                    mb, pb = find_bounds(m_rows), find_bounds(p_rows)
                    write_bounds(mb, j("maternal.bounds.txt"))
                    write_bounds(pb, j("paternal.bounds.txt"))
                    m_lower, m_upper = mb["LOWER_INDEX"], mb["UPPER_INDEX"]
                    p_lower, p_upper = pb["LOWER_INDEX"], pb["UPPER_INDEX"]
            print(f"  the real used kmer-count bounds of maternal is "
                  f"[ {m_lower} , {m_upper} ] ", file=log)
            print(f"  the real used kmer-count bounds of paternal is "
                  f"[ {p_lower} , {p_upper} ] ", file=log)
            with timer.phase("marker_algebra"):
                p_words, m_words = KC.device_marker_algebra(
                    pat, mat, p_lower, p_upper, m_lower, m_upper)
            n_p = _dump_words(p_words, k, paths["paternal"])
            n_m = _dump_words(m_words, k, paths["maternal"])
        elif todo:
            def mat_source():
                for path in maternal:
                    yield from FQ.sequence_batches(path, k, batch_size)

            # a range pass keeps only ~1/n_parts of the stream, so its
            # resident run is small — bigger, fewer folds fit the same
            # HBM (fold transient ~2x the concat; 192M elems x 12 B x 2
            # = 4.6 GB, plus distinct/n_parts run).  Sized before the
            # GPU; not measured on it.
            _fold_above = min(192_000_000, 48_000_000 * max(1, n_parts))

            def count_range(paths, lo_b, hi_b) -> KC.DeviceCountTable:
                """One key-range pass over a parent's files: native
                reader when it can take the file, python fallback."""
                total = KC.DeviceCounter(k, fold_above=_fold_above)
                for path in paths:
                    dc = KC.count_file_native(path, k, batch_size,
                                              finalize=False,
                                              key_range=(lo_b, hi_b),
                                              fold_above=_fold_above)
                    if dc is None:
                        dc = KC.count_pass_device(
                            lambda p=path: FQ.sequence_batches(
                                p, k, batch_size), k, lo_b, hi_b,
                            fold_above=_fold_above)
                    total.merge_device(dc)
                return total.finalize_device()

            boundaries = KC.sample_boundaries(mat_source, k, n_parts)
            high = 10000
            hists = {"maternal": np.zeros(high + 2, np.int64),
                     "paternal": np.zeros(high + 2, np.int64)}
            stats = {"maternal": [0, 0], "paternal": [0, 0]}
            with timer.phase("histo_sweep"):
                import time as _time
                for p in range(n_parts):
                    for name, files in (("maternal", maternal),
                                        ("paternal", paternal)):
                        _t0 = _time.perf_counter()
                        t = count_range(files, boundaries[p],
                                        boundaries[p + 1])
                        hists[name] += t.histo(high=high)
                        stats[name][0] += t.n_distinct
                        stats[name][1] += t.total
                        # per-pass residency + wall clock: quantile
                        # balance of sample_boundaries is visible here
                        print(f"  count pass {p + 1}/{n_parts} {name}: "
                              f"{t.n_distinct} distinct resident, "
                              f"{_time.perf_counter() - _t0:.1f}s",
                              file=log)
                        del t
            for name in ("maternal", "paternal"):
                print(f"  {name}: {stats[name][0]} distinct / "
                      f"{stats[name][1]} total {k}-mers", file=log)
            with timer.phase("bounds"):
                m_rows = _rows_from_hist(hists["maternal"])
                p_rows = _rows_from_hist(hists["paternal"])
                write_histo(m_rows, j("maternal.kmercount.histo"))
                write_histo(p_rows, j("paternal.kmercount.histo"))
                if auto_bounds:
                    mb, pb = find_bounds(m_rows), find_bounds(p_rows)
                    write_bounds(mb, j("maternal.bounds.txt"))
                    write_bounds(pb, j("paternal.bounds.txt"))
                    m_lower, m_upper = mb["LOWER_INDEX"], mb["UPPER_INDEX"]
                    p_lower, p_upper = pb["LOWER_INDEX"], pb["UPPER_INDEX"]
            print(f"  the real used kmer-count bounds of maternal is "
                  f"[ {m_lower} , {m_upper} ] ", file=log)
            print(f"  the real used kmer-count bounds of paternal is "
                  f"[ {p_lower} , {p_upper} ] ", file=log)
            p_parts, m_parts = [], []
            with timer.phase("marker_sweep"):
                for p in range(n_parts):
                    dmat = count_range(maternal, boundaries[p],
                                       boundaries[p + 1])
                    dpat = count_range(paternal, boundaries[p],
                                       boundaries[p + 1])
                    pw, mw = KC.device_marker_algebra(
                        dpat, dmat, p_lower, p_upper, m_lower, m_upper)
                    print(f"  marker pass {p + 1}/{n_parts}: "
                          f"{pw.size}+{mw.size} markers", file=log)
                    p_parts.append(pw)
                    m_parts.append(mw)
                    del dmat, dpat
            n_p = _dump_words(np.concatenate(p_parts), k,
                              paths["paternal"])
            n_m = _dump_words(np.concatenate(m_parts), k,
                              paths["maternal"])
        else:
            with open(paths["paternal"], "rb") as fp:
                n_p = sum(1 for _ in fp)
            with open(paths["maternal"], "rb") as fm:
                n_m = sum(1 for _ in fm)
    print(f"final paternal unique kmer is : {n_p}", file=log)
    print(f"final maternal unique kmer is : {n_m}", file=log)
    timer.report()
    return paths
