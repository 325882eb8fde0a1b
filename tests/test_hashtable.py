"""Tests for the bucketized k-mer membership table."""

import numpy as np
import pytest
import jax.numpy as jnp

from hast_jax.ops import encode as E
from hast_jax.ops import hashtable as H


def _random_keys(n, k, seed):
    rng = np.random.default_rng(seed)
    seqs = rng.integers(0, 4, size=(n, k), dtype=np.int32)
    hi, lo = E.canonical_kmers_np(seqs, k)
    return hi[:, 0], lo[:, 0]


def test_build_and_probe_exact():
    k = 21
    hi, lo = _random_keys(5000, k, 0)
    pay = np.where(np.arange(hi.size) % 3 == 0, 1, 2).astype(np.uint32)
    t = H.build_table(hi, lo, pay, k)
    # all inserted keys found with right payload (dupes OR-merged)
    want = {}
    for h_, l_, p_ in zip(hi.tolist(), lo.tolist(), pay.tolist()):
        want[(h_, l_)] = want.get((h_, l_), 0) | p_
    got = H.probe_np(t, hi, lo)
    for i, (h_, l_) in enumerate(zip(hi.tolist(), lo.tolist())):
        assert got[i] == want[(h_, l_)]
    # misses return 0
    mhi, mlo = _random_keys(5000, k, 1)
    member = set(zip(hi.tolist(), lo.tolist()))
    got_m = H.probe_np(t, mhi, mlo)
    for i, key in enumerate(zip(mhi.tolist(), mlo.tolist())):
        assert got_m[i] == (want.get(key, 0) if key in member else 0)


def test_device_probe_matches_host():
    k = 21
    hi, lo = _random_keys(3000, k, 2)
    pay = np.full(hi.size, 3, np.uint32)
    t = H.build_table(hi, lo, pay, k)
    qhi = np.concatenate([hi[:500], _random_keys(500, k, 3)[0]])
    qlo = np.concatenate([lo[:500], _random_keys(500, k, 3)[1]])
    host = H.probe_np(t, qhi, qlo)
    dev = np.asarray(H.probe(jnp.asarray(t.data), jnp.asarray(qhi),
                             jnp.asarray(qlo), t.max_probe))
    np.testing.assert_array_equal(host, dev)


def test_high_load_and_dupes():
    k = 31
    hi, lo = _random_keys(20000, k, 4)
    hi = np.concatenate([hi, hi[:1000]])
    lo = np.concatenate([lo, lo[:1000]])
    pay = np.concatenate([np.ones(20000, np.uint32),
                          np.full(1000, 2, np.uint32)])
    t = H.build_table(hi, lo, pay, k, load=0.9)
    got = H.probe_np(t, hi[:1000], lo[:1000])
    assert (got == 3).all()
    got2 = H.probe_np(t, hi[1000:20000], lo[1000:20000])
    assert (got2 == 1).all()
    assert t.max_probe >= 1


def test_remove_keys_adaptor_erasure():
    k = 5
    hi = np.array([E.str_to_kmer("AGCTC")[0], E.str_to_kmer("AAAAA")[0]],
                  np.uint32)
    lo = np.array([E.str_to_kmer("AGCTC")[1], E.str_to_kmer("AAAAA")[1]],
                  np.uint32)
    t = H.build_table(hi, lo, np.array([3, 1], np.uint32), k,
                      set_sizes=(2, 1))
    cleared = H.remove_keys(t, hi[:1], lo[:1], payload_mask=1)
    assert len(cleared) == 1 and cleared[0][2] == 1
    assert t.set_sizes == (1, 1)
    got = H.probe_np(t, hi, lo)
    assert got.tolist() == [2, 1]


def test_build_deterministic_under_eviction():
    """Same keys -> byte-identical table, even through the cuckoo
    eviction path (rng is seeded from n_buckets)."""
    k = 21
    hi, lo = _random_keys(30000, k, 5)
    pay = np.ones(hi.size, np.uint32)
    t1 = H.build_table(hi, lo, pay, k, load=0.9)
    t2 = H.build_table(hi, lo, pay, k, load=0.9)
    assert t1.n_buckets == t2.n_buckets
    np.testing.assert_array_equal(t1.data, t2.data)


def test_quot_format_matches_full():
    """The 4B-quotient format answers identically to the full format."""
    import numpy as np
    from hast_jax.ops import encode as E
    from hast_jax.ops import hashtable as H

    rng = np.random.default_rng(7)
    k = 21
    n = 40000
    seqs = rng.integers(0, 4, size=(n, k), dtype=np.int32)
    hi, lo = E.canonical_kmers_np(seqs, k)
    hi, lo = hi[:, 0], lo[:, 0]
    pay = rng.integers(1, 4, n).astype(np.uint32)

    full = H.build_table(hi, lo, pay, k, load=0.7, fmt="full")
    quot = H.build_table(hi, lo, pay, k, load=0.7, fmt="quot")
    assert quot.fmt == "quot" and quot.data.shape[1] == H.QUOT_BUCKET

    # queries: every key + random non-keys
    q_hi = np.concatenate([hi, rng.integers(0, 1 << 20, n).astype(np.uint32)])
    q_lo = np.concatenate([lo, rng.integers(0, 1 << 32, n).astype(np.uint32)])
    want = H.probe_np(full, q_hi, q_lo)
    got = H.probe_np(quot, q_hi, q_lo)
    np.testing.assert_array_equal(got, want)

    # device probe agrees with host probe
    import jax.numpy as jnp
    dev = np.asarray(H.probe_quot(jnp.asarray(quot.data),
                                  jnp.asarray(q_hi), jnp.asarray(q_lo), k))
    np.testing.assert_array_equal(dev, want)

    # adaptor erasure clears the same keys in both formats
    sub = slice(0, 50)
    cf = H.remove_keys(full, hi[sub], lo[sub], payload_mask=3)
    cq = H.remove_keys(quot, hi[sub], lo[sub], payload_mask=3)
    assert sorted(cf) == sorted(cq)
    assert full.set_sizes == quot.set_sizes
    np.testing.assert_array_equal(H.probe_np(quot, q_hi, q_lo),
                                  H.probe_np(full, q_hi, q_lo))


def test_quot_auto_selected_for_default_k():
    """k=21 tables above ~2^13 buckets pick the quotient format."""
    import numpy as np
    from hast_jax.ops import encode as E
    from hast_jax.ops import hashtable as H

    rng = np.random.default_rng(8)
    seqs = rng.integers(0, 4, size=(60000, 21), dtype=np.int32)
    hi, lo = E.canonical_kmers_np(seqs, 21)
    t = H.build_table(hi[:, 0], lo[:, 0],
                      np.ones(60000, np.uint32), 21, load=0.7)
    assert t.fmt == "quot"
    # k=31 cannot fit a 29-bit quotient at this size -> full
    seqs31 = rng.integers(0, 4, size=(60000, 31), dtype=np.int32)
    h31, l31 = E.canonical_kmers_np(seqs31, 31)
    t31 = H.build_table(h31[:, 0], l31[:, 0],
                        np.ones(60000, np.uint32), 31, load=0.7)
    assert t31.fmt == "full"


def test_quot_bbits_edge():
    """Exact 29-bit quotient boundary: k where 2k - bbits == 29."""
    import numpy as np
    from hast_jax.ops import encode as E
    from hast_jax.ops import hashtable as H

    rng = np.random.default_rng(9)
    # force a 2^13-bucket table: n ~ 4*0.7*8192 ≈ 23k keys
    n = 20000
    for k in (21, 24):  # k=21 -> q=29 at 2^13 exactly; k=24 -> full
        seqs = rng.integers(0, 4, size=(n, k), dtype=np.int32)
        hi, lo = E.canonical_kmers_np(seqs, k)
        hi, lo = hi[:, 0], lo[:, 0]
        pay = rng.integers(1, 4, n).astype(np.uint32)
        t = H.build_table(hi, lo, pay, k, load=0.7)
        bbits = t.n_buckets.bit_length() - 1
        if t.fmt == "quot":
            assert 2 * k - bbits <= 29
        full = H.build_table(hi, lo, pay, k, load=0.7, fmt="full")
        q_hi = np.concatenate([hi, rng.integers(
            0, 1 << min(30, 2 * k - 32 if k > 16 else 1), n
        ).astype(np.uint32)]) if k > 16 else hi
        q_lo = np.concatenate([lo, rng.integers(
            0, 1 << 32, n).astype(np.uint32)]) if k > 16 else lo
        np.testing.assert_array_equal(H.probe_np(t, q_hi, q_lo),
                                      H.probe_np(full, q_hi, q_lo))


def test_native_build_matches_numpy_build(monkeypatch):
    """The fused native quot build (hastio_build_quot + sort_dedup_or)
    must probe identically to the pure-numpy path: same payloads for
    every stored key (duplicate payloads OR-merged), 0 for absent."""
    import numpy as np

    from hast_jax.io import native as N
    from hast_jax.ops import encode as E
    from hast_jax.ops import hashtable as H


    rng = np.random.default_rng(13)
    n, k = 30000, 21
    seqs = rng.integers(0, 4, size=(n, k), dtype=np.int32)
    hi, lo = E.canonical_kmers_np(seqs, k)
    hi, lo = hi[:, 0].copy(), lo[:, 0].copy()
    # plant duplicates with different payloads (must OR-merge)
    hi[n // 2:n // 2 + 100] = hi[:100]
    lo[n // 2:n // 2 + 100] = lo[:100]
    pay = rng.integers(1, 4, n).astype(np.uint32)

    t_native = H.build_table(hi, lo, pay, k, load=0.7)
    assert t_native.fmt == "quot"
    monkeypatch.setattr(N, "sort_dedup_or", lambda *a: None)
    monkeypatch.setattr(N, "build_quot", lambda *a, **kw: None)
    monkeypatch.setattr(N, "place2", lambda *a, **kw: None)
    t_numpy = H.build_table(hi, lo, pay, k, load=0.7)
    assert t_numpy.fmt == "quot"
    assert t_native.n_keys == t_numpy.n_keys
    assert t_native.n_buckets == t_numpy.n_buckets

    q2 = rng.integers(0, 4, (5000, k), dtype=np.int32)
    q2hi, q2lo = E.canonical_kmers_np(q2, k)
    q_hi = np.concatenate([hi, q2hi[:, 0]])
    q_lo = np.concatenate([lo, q2lo[:, 0]])
    np.testing.assert_array_equal(H.probe_np(t_native, q_hi, q_lo),
                                  H.probe_np(t_numpy, q_hi, q_lo))
    assert (H.probe_np(t_native, hi, lo) > 0).all()


def test_native_sort_dedup_multithreaded_path():
    """n > 65536 engages the threaded sort + pairwise merge (a merge
    bookkeeping bug here once looped forever); verify against numpy."""
    import numpy as np

    from hast_jax.io import native as N

    rng = np.random.default_rng(17)
    n = 300_000
    hi = rng.integers(0, 1 << 10, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 12, n, dtype=np.uint64).astype(np.uint32)
    pay = rng.integers(1, 4, n).astype(np.uint32)
    words = (hi.astype(np.uint64) << np.uint64(32)) | lo
    h2, l2, p2 = hi.copy(), lo.copy(), pay.copy()
    m = N.sort_dedup_or(h2, l2, p2)
    assert m is not None
    got_w = (h2[:m].astype(np.uint64) << np.uint64(32)) | l2[:m]
    order = np.argsort(words, kind="stable")
    sw = words[order]
    new = np.empty(n, bool)
    new[0] = True
    new[1:] = sw[1:] != sw[:-1]
    want_w = sw[new]
    want_p = np.bitwise_or.reduceat(pay[order], np.flatnonzero(new))
    np.testing.assert_array_equal(got_w, want_w)
    np.testing.assert_array_equal(p2[:m], want_p)


@pytest.mark.parametrize("k,n", [(6, 350), (8, 350)])
def test_native_build_quot_bbits_ge_k_branches(monkeypatch, k, n):
    """quot_key's bbits>k and bbits==k branches (k=6 -> bbits=8 > k;
    k=8 -> bbits=8 == k) must match numpy — production human-scale
    tables take bbits>k, which the 30k-key parity test never hits."""
    import numpy as np

    from hast_jax.io import native as N
    from hast_jax.ops import encode as E
    from hast_jax.ops import hashtable as H

    rng = np.random.default_rng(k)
    seqs = rng.integers(0, 4, size=(4 * n, k), dtype=np.int32)
    hi, lo = E.canonical_kmers_np(seqs, k)
    words = np.unique((hi[:, 0].astype(np.uint64) << np.uint64(32))
                      | lo[:, 0])
    words = words[:n]
    hi = (words >> np.uint64(32)).astype(np.uint32)
    lo = words.astype(np.uint32)
    pay = (1 + (np.arange(words.size) % 3)).astype(np.uint32)

    t_native = H.build_table(hi, lo, pay, k)
    assert t_native.fmt == "quot"
    bbits = t_native.n_buckets.bit_length() - 1
    assert (bbits > k) if k == 6 else (bbits == k), (k, bbits)
    monkeypatch.setattr(N, "sort_dedup_or", lambda *a: None)
    monkeypatch.setattr(N, "build_quot", lambda *a, **kw: None)
    monkeypatch.setattr(N, "place2", lambda *a, **kw: None)
    t_numpy = H.build_table(hi, lo, pay, k)
    assert t_numpy.n_buckets == t_native.n_buckets

    q2 = rng.integers(0, 4, (2000, k), dtype=np.int32)
    q2hi, q2lo = E.canonical_kmers_np(q2, k)
    q_hi = np.concatenate([hi, q2hi[:, 0]])
    q_lo = np.concatenate([lo, q2lo[:, 0]])
    np.testing.assert_array_equal(H.probe_np(t_native, q_hi, q_lo),
                                  H.probe_np(t_numpy, q_hi, q_lo))
    assert (H.probe_np(t_native, hi, lo) > 0).all()
