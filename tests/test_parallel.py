"""Multi-device (8 fake CPU devices) tests for the sharded paths."""

import io
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hast_jax.ops import encode as E
from hast_jax.ops import hashtable as H
from hast_jax.ops import kmer_count as KC
from hast_jax.parallel import mesh as PM
from hast_jax.parallel import merge as PMerge
from hast_jax.pipeline import classify as C

GOLD = pathlib.Path(__file__).parent / "golden" / "stage01"


def _table(seed, n=4000, k=21, fmt="auto"):
    rng = np.random.default_rng(seed)
    seqs = rng.integers(0, 4, size=(n, k), dtype=np.int32)
    hi, lo = E.canonical_kmers_np(seqs, k)
    pay = rng.integers(1, 4, n).astype(np.uint32)
    return H.build_table(hi[:, 0], lo[:, 0], pay, k, set_sizes=(n, n),
                         fmt=fmt)


# every bench-scale table auto-selects "quot" (n_buckets >= 2^13 at
# k=21) while small fixtures stay "full", so both formats MUST be
# pinned on the sharded probe path — a quot-only bug was invisible
# to full-only tests
@pytest.mark.parametrize("fmt", ["full", "quot"])
@pytest.mark.parametrize("dp,tp", [(8, 1), (4, 2), (2, 4)])
def test_sharded_classify_matches_single_device(dp, tp, fmt):
    assert len(jax.devices()) >= dp * tp
    k = 21
    table = _table(1, k=k, fmt=fmt)
    assert table.fmt == fmt
    mesh = PM.make_mesh(dp * tp, tp=tp)
    tdata = PM.shard_table(mesh, table)

    rng = np.random.default_rng(2)
    B, L = 64, 128
    seqs = np.frombuffer(bytes(rng.integers(65, 91, B * L, dtype=np.uint8)),
                         np.uint8).reshape(B, L).copy()
    # plant some real marker kmers so there are hits
    key_rng = np.random.default_rng(1)  # same seed as _table(1)
    kseqs = key_rng.integers(0, 4, size=(4000, k), dtype=np.int32)
    khi, klo = E.canonical_kmers_np(kseqs, k)
    kwords = (khi[:, 0].astype(np.uint64) << np.uint64(32)) | klo[:, 0]
    real = KC.words_to_strings(kwords, k).tolist()[:50]
    for i, s in enumerate(real):
        r = i % B
        seqs[r, (i * 7) % (L - k):(i * 7) % (L - k) + k] = np.frombuffer(
            s, np.uint8)
    lengths = np.full(B, L, np.int32)
    lengths[::5] = 70
    has_n = np.zeros(B, bool)
    has_n[3] = True
    bids = rng.integers(0, 10, B).astype(np.int32)

    tally = np.asarray(PM.sharded_classify_step(
        mesh, tdata, jnp.asarray(seqs), jnp.asarray(lengths),
        jnp.asarray(bids), jnp.asarray(has_n), k, table.max_probe,
        table.n_buckets, 10, fmt=table.fmt))

    # single-device reference
    v0, v1 = C.vote_kernel(jnp.asarray(table.data), jnp.asarray(seqs),
                           jnp.asarray(lengths), k, table.max_probe,
                           table.fmt)
    v0 = np.where(has_n, 0, np.asarray(v0))
    v1 = np.where(has_n, 0, np.asarray(v1))
    unk = (has_n | ((v0 == 0) & (v1 == 0))).astype(np.int64)
    want = np.zeros((10, 3), np.int64)
    np.add.at(want[:, 0], bids, v0)
    np.add.at(want[:, 1], bids, v1)
    np.add.at(want[:, 2], bids, unk)
    np.testing.assert_array_equal(tally, want)
    assert want[:, :2].sum() > 0  # hits actually happened


def test_sharded_count_matches_single_device():
    k = 21
    mesh = PM.make_mesh(8, tp=1)
    rng = np.random.default_rng(3)
    B, L = 128, 128
    letters = np.frombuffer(b"ACGT", np.uint8)
    seqs = letters[rng.integers(0, 4, (B, L))]
    seqs[1, 4] = ord("N")
    lengths = np.full(B, L, np.int32)
    # duplicate some rows to create count > 1
    seqs[64:] = seqs[:64]

    rhi, rlo, dropped = PM.sharded_count_chunk(
        mesh, jnp.asarray(seqs), jnp.asarray(lengths), k)
    assert int(np.asarray(dropped).sum()) == 0
    counter = KC.Counter(k)
    for d in range(8):
        counter.add_sorted_chunk(np.asarray(rhi[d]), np.asarray(rlo[d]))
    ours = counter.finalize()

    want = KC.count_batches(
        [type("B", (), dict(seqs=seqs, lengths=lengths))()], k)
    np.testing.assert_array_equal(ours.words, want.words)
    np.testing.assert_array_equal(ours.counts, want.counts)


def test_merge_matches_single_run():
    """Shard-by-file classify + merge == the golden single run."""
    table = C.load_marker_table(str(GOLD / "hap0.mer"),
                                str(GOLD / "hap1.mer"))
    C.erase_adaptors(table)
    size0, size1 = table.set_sizes
    table.device_put()

    shard_outputs = []
    for reads in (["reads1.fq.gz"], ["reads2.fq"]):
        tally = C.classify_fastqs(table, [str(GOLD / r) for r in reads],
                                  batch_size=4096)
        out = io.BytesIO()
        C.write_phased_barcodes(tally, table, out, w0=1.04)
        shard_outputs.append(out.getvalue())

    import tempfile, os
    merged = io.BytesIO()
    with tempfile.TemporaryDirectory() as td:
        paths = []
        for i, data in enumerate(shard_outputs):
            p = os.path.join(td, f"s{i}.txt")
            open(p, "wb").write(data)
            paths.append(p)
        PMerge.merge_phased_files(paths, merged, size0, size1, w0=1.04)
    golden = (GOLD / "phased.barcodes.golden").read_bytes()
    assert merged.getvalue() == golden


def test_build_markers_mesh_matches_host(tmp_path):
    """Mesh-resident stage 00 (hash-range-sharded tables, per-shard
    algebra, psum histograms) must produce byte-identical artifacts to
    the host engine."""
    from hast_jax.parallel import distributed as D
    from hast_jax.pipeline import markers as M

    gold = pathlib.Path(__file__).parent / "golden" / "stage00"
    pat = [str(gold / "paternal.reads.fa.gz")]
    mat = [str(gold / "maternal.reads.fa.gz")]
    mesh_dir = tmp_path / "mesh"
    host_dir = tmp_path / "host"
    mesh_dir.mkdir()
    host_dir.mkdir()
    mesh = PM.make_mesh(8, tp=1)
    D.build_unshared_markers_mesh(mesh, pat, mat, out_dir=str(mesh_dir),
                                  auto_bounds=True, batch_size=4096)
    M.build_unshared_markers(paternal=pat, maternal=mat,
                             out_dir=str(host_dir), auto_bounds=True,
                             batch_size=16384, engine="host")
    for name in ("maternal.kmercount.histo", "paternal.kmercount.histo",
                 "maternal.bounds.txt", "paternal.bounds.txt",
                 "maternal.unique.filter.mer",
                 "paternal.unique.filter.mer"):
        assert (mesh_dir / name).read_bytes() == \
            (host_dir / name).read_bytes(), name


def test_count_files_sharded_matches_host(tmp_path):
    from hast_jax.parallel import distributed as D
    from hast_jax.pipeline import markers as M
    pathlib = __import__("pathlib")
    gold = pathlib.Path(__file__).parent / "golden" / "e2e"
    mesh = PM.make_mesh(8, tp=1)
    paths = [str(gold / "paternal.fa.gz")]
    ours = D.count_files_sharded(mesh, paths, 21, batch_size=4096)
    want = M.count_files(paths, 21, batch_size=4096)
    np.testing.assert_array_equal(ours.words, want.words)
    np.testing.assert_array_equal(ours.counts, want.counts)


@pytest.mark.parametrize("fmt", ["full", "quot"])
def test_classify_fastqs_mesh_matches_golden(fmt):
    """Streaming classify on a dp×tp mesh == the golden single run,
    for BOTH slot formats (bench-scale tables are always quot)."""
    mesh = PM.make_mesh(8, tp=2)
    table = C.load_marker_table(str(GOLD / "hap0.mer"),
                                str(GOLD / "hap1.mer"),
                                snapshot=False, fmt=fmt)
    assert table.fmt == fmt
    C.erase_adaptors(table)
    tally = C.classify_fastqs_mesh(
        mesh, table, [str(GOLD / "reads1.fq.gz"), str(GOLD / "reads2.fq")],
        batch_size=4096)
    out = io.BytesIO()
    C.write_phased_barcodes(tally, table, out, w0=1.04)
    assert out.getvalue() == (GOLD / "phased.barcodes.golden").read_bytes()


def test_mesh_count_table_stats_match_host():
    """MeshCountTable histo/total/n_distinct == the host CountTable
    (a dp-sharded out_spec on the psummed total once tiled the result
    and overcounted by dp)."""
    from hast_jax.parallel import distributed as D
    from hast_jax.pipeline import markers as M

    gold = pathlib.Path(__file__).parent / "golden" / "stage00"
    paths = [str(gold / "maternal.reads.fa.gz")]
    mesh = PM.make_mesh(8, tp=1)
    t = D.count_files_mesh_device(mesh, paths, 21, batch_size=4096)
    want = M.count_files(paths, 21, batch_size=4096)
    assert t.n_distinct == want.n_distinct
    assert t.total == want.total
    np.testing.assert_array_equal(t.histo(), want.histo())


def test_mesh_count_overflow_recovery(tmp_path):
    """Overflow-injection: a batch whose k-mers ALL
    hash to one destination overflows the 2x all_to_all slack; the
    mesh-resident counter must retry with doubled slack (halving can't
    fix systematic skew) and still produce the host engine's table."""
    from hast_jax.parallel import distributed as D
    from hast_jax.pipeline import markers as M

    # 64 identical reads: every canonical k-mer is identical, so every
    # key routes to a single hash-range owner
    seq = b"ACGTTACGGATCCATTAGCATACGTTACGGATCAATTAGCAT"
    fa = tmp_path / "skew.fa"
    fa.write_bytes(b"".join(b">r%d\n%s\n" % (i, seq) for i in range(64)))
    mesh = PM.make_mesh(8, tp=1)
    t = D.count_files_mesh_device(mesh, [str(fa)], 21, batch_size=4096)
    want = M.count_files([str(fa)], 21, batch_size=4096)
    assert t.n_distinct == want.n_distinct
    assert t.total == want.total
    got = sorted(
        (int(h) << 32) | int(l)
        for d in range(8)
        for h, l in zip(np.asarray(t.hi[d, :t.n_valid[d]]),
                        np.asarray(t.lo[d, :t.n_valid[d]])))
    assert got == [int(w) for w in want.words]
