"""Parity of stage 00 against the reference jellyfish pipeline's output.

Goldens in tests/golden/stage00 come from actually running the
reference build_unshared_kmers.sh (see scripts/make_golden_stage00.py).
"""

import pathlib

import numpy as np
import pytest

from hast_jax.ops import encode as E
from hast_jax.pipeline import markers as M

GOLD = pathlib.Path(__file__).parent / "golden" / "stage00"


@pytest.fixture(scope="module",
                params=["host", "device", "device-parts"])
def built(tmp_path_factory, request):
    """All stage-00 engines must produce identical text artifacts:
    "host" fetches + snapshots per sub-step, "device" keeps the count
    tables in HBM and fetches only final markers, "device-parts" is
    the human-scale 2-sweep key-range-partitioned device path."""
    out = tmp_path_factory.mktemp(
        f"stage00_{request.param.replace('-', '_')}")
    engine = "device" if request.param == "device-parts" \
        else request.param
    n_parts = 3 if request.param == "device-parts" else None
    paths = M.build_unshared_markers(
        paternal=[str(GOLD / "paternal.reads.fa.gz")],
        maternal=[str(GOLD / "maternal.reads.fa.gz")],
        out_dir=str(out), auto_bounds=True, batch_size=16384,
        engine=engine, n_parts=n_parts)
    return out, paths


def test_histo_rows_match_jellyfish(built):
    out, _ = built
    for parent in ("maternal", "paternal"):
        ours = (out / f"{parent}.kmercount.histo").read_text().splitlines()
        golden = (GOLD / f"{parent}.histo").read_text().splitlines()
        assert ours == golden, parent


def test_auto_bounds_match_awk(built):
    out, _ = built
    for parent in ("maternal", "paternal"):
        ours = (out / f"{parent}.bounds.txt").read_text()
        golden = (GOLD / f"{parent}.bounds.txt").read_text()
        assert ours == golden, parent


def test_marker_files_same_strings(built):
    """Same k-mer strings as jellyfish dump (we emit jellyfish-style
    canonical representatives), order-insensitive."""
    _, paths = built
    for parent in ("maternal", "paternal"):
        ours = sorted(open(paths[parent], "rb").read().split())
        golden = sorted(
            (GOLD / f"{parent}.unique.filter.mer").read_bytes().split())
        assert ours == golden, parent


def test_marker_files_same_canonical_sets(built):
    """Belt-and-braces: canonical (hi,lo) sets identical."""
    _, paths = built
    for parent in ("maternal", "paternal"):
        hi, lo, _ = E.load_mer_file(paths[parent])
        ghi, glo, _ = E.load_mer_file(str(GOLD / f"{parent}.unique.filter.mer"))
        ours = set(zip(hi.tolist(), lo.tolist()))
        gold = set(zip(ghi.tolist(), glo.tolist()))
        assert ours == gold, parent


def test_find_bounds_awk_quirks():
    # first row IS the running minimum; equal freq flips to max state
    rows = [(1, 100), (2, 50), (3, 50), (4, 80), (5, 200), (6, 90)]
    b = M.find_bounds(rows)
    assert b["MIN_INDEX"] == 2  # row 3 freq 50 is NOT < 50 -> flip
    assert b["MAX_INDEX"] == 5
    assert b["LOWER_INDEX"] == 3
    assert b["UPPER_INDEX"] == 3 * 5 - 2 * 2 - 1
    # monotonically falling histo: never leaves state 0
    b2 = M.find_bounds([(1, 10), (2, 5), (3, 1)])
    assert b2["MAX_INDEX"] == 0 and b2["MIN_INDEX"] == 3


def test_device_counter_matches_host_counter():
    """DeviceCounter (HBM-resident fold) == host Counter on the same
    batches, including duplicate-heavy input and sentinel pads."""
    import numpy as np
    from hast_jax.ops import kmer_count as KC

    rng = np.random.default_rng(11)
    B, L, k = 64, 64, 21
    letters = np.frombuffer(b"ACGTN", np.uint8)
    batches = []
    for _ in range(7):
        seqs = letters[rng.integers(0, 5, (B, L))]
        # heavy duplication: repeat a few rows many times
        seqs[1::3] = seqs[0]
        lengths = rng.integers(k, L + 1, B).astype(np.int32)
        batches.append(type("B", (), dict(seqs=seqs, lengths=lengths))())
    dev = KC.count_batches(batches, k, super_batch=2, engine="device")
    host = KC.count_batches(batches, k, super_batch=2, engine="host")
    np.testing.assert_array_equal(dev.words, host.words)
    np.testing.assert_array_equal(dev.counts, host.counts)
    assert dev.total == host.total and dev.total > 0


def test_plot_bounds_golden_semantics(tmp_path):
    """The rendered figure matches draw_bounds.py:50-76 semantics on the
    stage-00 golden histos: per parent 4 vlines at MIN/MAX/LOWER/UPPER
    with the reference's label text/linestyles, xlim (1,150), title."""
    matplotlib = pytest.importorskip("matplotlib")
    del matplotlib
    import shutil

    from hast_jax.utils.plot_bounds import render_bounds_figure, plot_bounds

    for parent in ("maternal", "paternal"):
        shutil.copy(GOLD / f"{parent}.histo",
                    tmp_path / f"{parent}.kmercount.histo")
        shutil.copy(GOLD / f"{parent}.bounds.txt",
                    tmp_path / f"{parent}.bounds.txt")

    fig = render_bounds_figure(str(tmp_path))
    assert len(fig.axes) == 2
    for ax, parent in zip(fig.axes, ("maternal", "paternal")):
        bounds = dict(
            line.strip().split("=")
            for line in open(GOLD / f"{parent}.bounds.txt"))
        want = [("MIN", "--", int(bounds["MIN_INDEX"])),
                ("MAX", "--", int(bounds["MAX_INDEX"])),
                ("LOWER", "-.", int(bounds["LOWER_INDEX"])),
                ("UPPER", "-.", int(bounds["UPPER_INDEX"]))]
        # line 0 is the histogram curve; 1..4 are the axvlines in order
        lines = ax.get_lines()
        assert len(lines) == 5, parent
        histo = np.loadtxt(GOLD / f"{parent}.histo", dtype=int, ndmin=2)
        np.testing.assert_array_equal(lines[0].get_xdata(), histo[:, 0])
        np.testing.assert_array_equal(lines[0].get_ydata(), histo[:, 1])
        for line, (name, ls, x) in zip(lines[1:], want):
            assert set(np.atleast_1d(line.get_xdata()).tolist()) == {x}, \
                (parent, name)
            assert line.get_linestyle() == ls, (parent, name)
            assert line.get_label() == f"{name} INDEX {x} ", (parent, name)
        assert ax.get_xlim() == (1.0, 150.0)
        assert ax.get_title() == f"{parent} kmer-depth count"
        assert ax.get_legend() is not None
    import matplotlib.pyplot as plt
    plt.close(fig)

    # the save wrapper produces a real png
    out = plot_bounds(str(tmp_path))
    assert out is not None and (tmp_path / "test.png").stat().st_size > 0


def test_device_table_matches_host_table():
    """DeviceCountTable (histo/total/fetch) == the host CountTable on
    the same input, and device_marker_algebra == the host
    difference+filter_range composition."""
    from hast_jax.ops import kmer_count as KC

    rng = np.random.default_rng(5)
    B, L, k = 96, 80, 21
    letters = np.frombuffer(b"ACGTN", np.uint8)

    def batches(seed):
        r = np.random.default_rng(seed)
        out = []
        for _ in range(5):
            seqs = letters[r.integers(0, 5, (B, L))]
            seqs[1::4] = seqs[0]          # duplicates -> counts > 1
            lengths = r.integers(k, L + 1, B).astype(np.int32)
            out.append(type("B", (), dict(seqs=seqs, lengths=lengths))())
        return out

    del rng
    mat_b, pat_b = batches(21), batches(22)
    dmat = KC.count_batches(mat_b, k, finalize=False).finalize_device()
    dpat = KC.count_batches(pat_b, k, finalize=False).finalize_device()
    hmat = KC.count_batches(batches(21), k)
    hpat = KC.count_batches(batches(22), k)

    assert dmat.n_distinct == hmat.n_distinct
    assert dmat.total == hmat.total
    np.testing.assert_array_equal(dmat.histo(), hmat.histo())
    f = dmat.fetch()
    np.testing.assert_array_equal(f.words, hmat.words)
    np.testing.assert_array_equal(f.counts, hmat.counts)

    for (pl, pu, ml, mu) in [(1, 3, 1, 3), (2, 10, 1, 1), (1, 10**6, 1, 10**6)]:
        p_words, m_words = KC.device_marker_algebra(dpat, dmat,
                                                    pl, pu, ml, mu)
        want_p = hpat.difference(hmat).filter_range(pl, pu)
        want_m = hmat.difference(hpat).filter_range(ml, mu)
        np.testing.assert_array_equal(p_words, want_p.words)
        np.testing.assert_array_equal(m_words, want_m.words)


def test_merge_device_union_sums():
    """merge_device across files == counting the concatenation."""
    from hast_jax.ops import kmer_count as KC

    k = 21
    letters = np.frombuffer(b"ACGT", np.uint8)
    r = np.random.default_rng(9)
    seqs = letters[r.integers(0, 4, (64, 60))]
    b1 = type("B", (), dict(seqs=seqs[:32],
                            lengths=np.full(32, 60, np.int32)))()
    b2 = type("B", (), dict(seqs=seqs[16:],
                            lengths=np.full(48, 60, np.int32)))()
    c1 = KC.count_batches([b1], k, finalize=False)
    c2 = KC.count_batches([b2], k, finalize=False)
    c1.merge_device(c2)
    got = c1.finalize_device().fetch()
    want = KC.count_batches([b1, b2], k)
    np.testing.assert_array_equal(got.words, want.words)
    np.testing.assert_array_equal(got.counts, want.counts)


def test_substep_resume_skips_finished_count(tmp_path, monkeypatch):
    """Crash after the maternal count; the rerun must NOT recount it.

    Mirrors the reference's step_NN_done + persistent .jf contract
    (build_unshared_kmers.sh:167-298): each parent count snapshots to
    <parent>.counts.npz guarded by its own marker.
    """
    mat = [str(GOLD / "maternal.reads.fa.gz")]
    pat = [str(GOLD / "paternal.reads.fa.gz")]
    real_count = M.count_files
    calls = []

    def crashing_count(paths, k, batch_size, n_parts=None):
        calls.append(tuple(paths))
        if paths == pat:
            raise KeyboardInterrupt("simulated crash mid-run")
        return real_count(paths, k, batch_size)

    monkeypatch.setattr(M, "count_files", crashing_count)
    with pytest.raises(KeyboardInterrupt):
        M.build_unshared_markers(paternal=pat, maternal=mat,
                                 out_dir=str(tmp_path), auto_bounds=True,
                                 batch_size=16384)
    assert (tmp_path / "step_00.1_count_maternal_done").exists()
    assert (tmp_path / "maternal.counts.npz").exists()
    assert not (tmp_path / "step_00.2_count_paternal_done").exists()

    def second_run_count(paths, k, batch_size, n_parts=None):
        assert paths != mat, "maternal count was redone after resume"
        calls.append(tuple(paths))
        return real_count(paths, k, batch_size)

    monkeypatch.setattr(M, "count_files", second_run_count)
    paths = M.build_unshared_markers(paternal=pat, maternal=mat,
                                     out_dir=str(tmp_path),
                                     auto_bounds=True, batch_size=16384)
    for p in paths.values():
        assert pathlib.Path(p).exists()
    # all four sub-step markers now present
    for s in ("00.1_count_maternal", "00.2_count_paternal",
              "00.3_bounds", "00.4_markers"):
        assert (tmp_path / f"step_{s}_done").exists()


def test_partitioned_count_matches_single():
    """Multi-pass key-range partitioned counting == one-pass tables."""
    paths = [str(GOLD / "maternal.reads.fa.gz")]
    want = M.count_files(paths, 21, batch_size=8192)
    got = M.count_files(paths, 21, batch_size=8192, n_parts=3)
    np.testing.assert_array_equal(got.words, want.words)
    np.testing.assert_array_equal(got.counts, want.counts)


def test_native_count_multiline_fasta_fallback(tmp_path):
    """Multi-line fasta must fall back to the python reader whole-file
    (the native counting parser is strictly 2-line records)."""
    from hast_jax.ops import kmer_count as KC
    seq = b"ACGTACGTGGCCATTAGCAT" * 10
    single = tmp_path / "single.fa"
    multi = tmp_path / "multi.fa"
    single.write_bytes(b">r1\n" + seq + b"\n>r2\n" + seq[5:] + b"\n")
    multi.write_bytes(b">r1\n" + seq[:100] + b"\n" + seq[100:] +
                      b"\n>r2\n" + seq[5:] + b"\n")
    native = KC.count_file_native(str(single), 21, batch_size=64)
    if native is not None:  # lib present: parity with the python path
        want = M.count_files([str(single)], 21, batch_size=64)
        np.testing.assert_array_equal(native.words, want.words)
        np.testing.assert_array_equal(native.counts, want.counts)
    assert KC.count_file_native(str(multi), 21, batch_size=64) is None
    # and the public entry point still counts the multi-line file right
    got = M.count_files([str(multi)], 21, batch_size=64)
    want = M.count_files([str(single)], 21, batch_size=64)
    np.testing.assert_array_equal(got.words, want.words)
    np.testing.assert_array_equal(got.counts, want.counts)


def test_estimate_boundaries_empty_sample_monotonic():
    """the empty-sample fallback computed p * 2^62 in
    uint64, wrapping for p >= 4 and silently dropping k-mers in
    wrapped ranges.  Bounds must be strictly ascending for any
    n_parts."""
    from hast_jax.ops import kmer_count as KC

    for n_parts in (2, 4, 8, 16):
        bounds = KC.estimate_boundaries([], 21, n_parts)
        assert bounds.size == n_parts + 1
        assert bounds[0] == 0
        assert bounds[-1] == np.uint64(0xFFFFFFFFFFFFFFFF)
        assert (bounds[1:] > bounds[:-1]).all(), n_parts


def test_sample_boundaries_strided_beyond_prefix():
    """boundary sampling read only the first 8
    batches of a locally-correlated stream.  The strided sampler must
    observe the whole scan window, so the median boundary of a stream
    whose keys ascend with batch index lands near the stream's middle,
    not the prefix's."""
    from hast_jax.ops import kmer_count as KC
    from hast_jax.ops import encode as E

    rng = np.random.default_rng(11)
    k = 21
    seqs = rng.integers(0, 4, size=(4096, k), dtype=np.int32)
    hi, lo = E.canonical_kmers_np(seqs, k)
    words = np.unique((hi[:, 0].astype(np.uint64) << np.uint64(32))
                      | lo[:, 0])
    n_batches = 64
    per = words.size // n_batches
    strs = KC.words_to_strings(words, k)

    def source():
        for i in range(n_batches):
            chunk = strs[i * per:(i + 1) * per]
            arr = np.frombuffer(b"".join(chunk.tolist()),
                                np.uint8).reshape(-1, k).copy()
            yield type("B", (), dict(
                seqs=arr, lengths=np.full(arr.shape[0], k, np.int32)))()

    bounds = KC.sample_boundaries(source, k, 2, n_sample=16, scan_cap=64)
    # old first-8-batches sampling would put the median near
    # words[4 * per]; strided sampling must see the stream's middle
    assert bounds[1] > words[16 * per]
    assert (bounds[1:] >= bounds[:-1]).all()


def test_unique_filter_sentinel_safe_at_lower0():
    """with lower=0 a lone sentinel pad row (no equal
    neighbor on one side) must not leak a 0xFFFF..FF key into the
    marker set — the kernel now masks sentinels explicitly."""
    import jax.numpy as jnp
    from hast_jax.ops import kmer_count as KC

    S = np.uint32(0xFFFFFFFF)
    # parent A: 2 real keys + ONE sentinel pad; parent B: 3 real keys,
    # NO pads — the lone A pad is the global max of the merge, has no
    # equal neighbor, and is excluded only by the explicit mask
    a_hi = jnp.asarray(np.array([0, 1, S], np.uint32))
    a_lo = jnp.asarray(np.array([5, 6, S], np.uint32))
    a_c = jnp.asarray(np.array([3, 2, 0], np.int32))
    b_hi = jnp.asarray(np.array([0, 2, 3], np.uint32))
    b_lo = jnp.asarray(np.array([5, 7, 8], np.uint32))
    b_c = jnp.asarray(np.array([4, 1, 1], np.int32))
    pat = KC.DeviceCountTable(a_hi, a_lo, a_c, 2, 21)
    mat = KC.DeviceCountTable(b_hi, b_lo, b_c, 3, 21)
    p, m = KC.device_marker_algebra(pat, mat, 0, 100, 0, 100)
    sent = np.uint64(0xFFFFFFFFFFFFFFFF)
    assert sent not in p and sent not in m
    # key (1,6) is unique to A and in range; key (0,5) is shared
    assert p.tolist() == [(1 << 32) | 6]
    assert m.tolist() == [(2 << 32) | 7, (3 << 32) | 8]
