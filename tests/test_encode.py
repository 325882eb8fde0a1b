"""Golden tests for the 2-bit codec and canonical k-mer extraction.

Constants replicate the reference's startup self-test
(/root/reference/01.classify_stlfr_reads/classify.cpp:341-367 TestAll)
plus brute-force cross-checks against a straightforward python model.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from hast_jax.ops import encode as E


def codes_of(s):
    return E.encode_np(np.frombuffer(s.encode(), np.uint8))


def test_base_encoding_golden():
    # TestAll: AGCTC -> 0,3,1,2,1 ; GAGCT -> 3,0,3,1,2
    assert codes_of("AGCTC").tolist() == [0, 3, 1, 2, 1]
    assert codes_of("GAGCT").tolist() == [3, 0, 3, 1, 2]
    # reference applies (c&6)>>1 to ANY byte: N encodes as 3 (like G)
    assert codes_of("N").tolist() == [3]
    assert codes_of("acgt").tolist() == [0, 1, 3, 2]


def test_canonical_kmer_golden_5mer():
    # TestAll: canonical(AGCTC) == canonical(GAGCT) == 0xD9
    assert E.str_to_kmer("AGCTC") == (0, 0xD9)
    assert E.str_to_kmer("GAGCT") == (0, 0xD9)
    # chopRead2Kmer("GAGCTA") -> [0xD9, 0xD8]
    hi, lo = E.canonical_kmers_np(codes_of("GAGCTA")[None, :], 5)
    assert hi.tolist() == [[0, 0]]
    assert lo.tolist() == [[0xD9, 0xD8]]
    assert E.kmer_to_str(0, 0xD9, 5) == "AGCTC"
    assert E.kmer_to_str(0, 0xD8, 5) == "AGCTA"


def _py_canonical(s):
    """Independent python model: min(word, rc_word) as 2k-bit ints."""
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    rc = "".join(comp[c] for c in reversed(s))

    def word(x):
        v = 0
        for c in x:
            v = (v << 2) | {"A": 0, "C": 1, "T": 2, "G": 3}[c]
        return v

    return min(word(s), word(rc))


@pytest.mark.parametrize("k", [5, 16, 17, 21, 31])
def test_canonical_vs_python_model(k):
    rng = np.random.default_rng(42 + k)
    seq = "".join(rng.choice(list("ACGT"), size=200))
    hi, lo = E.canonical_kmers_np(codes_of(seq)[None, :], k)
    for p in range(0, 200 - k + 1, 7):
        want = _py_canonical(seq[p:p + k])
        got = (int(hi[0, p]) << 32) | int(lo[0, p])
        assert got == want, (k, p)


@pytest.mark.parametrize("k", [5, 21, 31])
def test_device_matches_numpy(k):
    rng = np.random.default_rng(7)
    batch = rng.integers(0, 4, size=(16, 120), dtype=np.int32)
    hi_np, lo_np = E.canonical_kmers_np(batch, k)
    hi_d, lo_d = E.canonical_kmers(jnp.asarray(batch), k)
    np.testing.assert_array_equal(np.asarray(hi_d), hi_np)
    np.testing.assert_array_equal(np.asarray(lo_d), lo_np)


def test_window_valid():
    L, k = 10, 4
    good = np.ones((2, L), bool)
    good[0, 5] = False  # one bad base
    lengths = np.array([10, 7], np.int32)
    v = np.asarray(E.window_valid(jnp.asarray(good), jnp.asarray(lengths), k))
    # read 0: windows 2..5 cover position 5
    assert v[0].tolist() == [True, True, False, False, False, False, True]
    # read 1: only starts 0..3 fit in length 7
    assert v[1].tolist() == [True, True, True, True, False, False, False]


def test_kmer_str_roundtrip():
    rng = np.random.default_rng(3)
    for k in (5, 21, 31):
        for _ in range(20):
            s = "".join(rng.choice(list("ACGT"), size=k))
            hi, lo = E.str_to_kmer(s)
            back = E.kmer_to_str(hi, lo, k)
            assert E.str_to_kmer(back) == (hi, lo)
            assert back in (s, _revcomp(s))


def _revcomp(s):
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    return "".join(comp[c] for c in reversed(s))
