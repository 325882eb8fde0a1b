"""Plain numpy reference of stage-01 classify (``classify.cpp``).

Independent of the code under test: it imports nothing from this
package and shares no code with it.  Marker sets are sorted uint64
canonical words and membership is ``np.searchsorted``.  Used by
``chip_smoke.py``, ``bench.py`` and the tests to check the device path
on inputs too large for committed goldens.

Semantics (the reference binary's):
  * base code ``(c >> 1) & 3`` on every byte (A=0 C=1 T=2 G=3); the
    canonical k-mer is min(forward, reverse complement) as a 2k-bit word.
  * k is the length of the first line of the hap0 marker file; adaptor
    k-mers are erased from both sets before the set sizes are taken
    (classify.cpp:314-339).
  * a read holding a literal 'N' casts no votes; otherwise each k-mer
    position votes for every set that holds its canonical k-mer.
  * barcode = text between the last '#' and the last '/' of the head
    line (to the end of line when '/' is missing or comes first).
  * per-barcode vote sums are decided by getHap (classify.cpp:66-86) and
    written one line per barcode in bytewise barcode order.
"""

from __future__ import annotations

import gzip

import numpy as np

ADAPTOR_F = b"CTGTCTCTTATACACATCTTAGGAAGACAAGCACTGACGACATGA"
ADAPTOR_R = b"TCTGCTGAGTCGAGAACGTCTCTGTGAGCCAAGGAGTTGCTCTGG"
NULL_BARCODES = (b"0", b"0_0", b"0_0_0")
# rows per block: keeps every temporary a few MB, so the loops reuse
# memory instead of faulting in fresh pages for each block
_CHUNK = 1 << 14


def canonical_words(rows: np.ndarray, k: int) -> np.ndarray:
    """(n, L) ASCII uint8 -> (n, L-k+1) uint64 canonical k-mer words,
    by a rolling forward and reverse-complement word per read."""
    n, length = rows.shape
    codes = (rows.T >> 1) & 3
    mask = np.uint64((1 << (2 * k)) - 1)
    top = np.uint64(2 * (k - 1))
    two = np.uint64(2)
    fwd = np.zeros(n, np.uint64)
    rc = np.zeros(n, np.uint64)
    out = np.empty((length - k + 1, n), np.uint64)
    for i in range(length):
        c = codes[i].astype(np.uint64)
        fwd = ((fwd << two) | c) & mask
        rc = (rc >> two) | ((c ^ two) << top)
        if i >= k - 1:
            np.minimum(fwd, rc, out=out[i - k + 1])
    return out.T


def read_marker_words(path: str) -> tuple[np.ndarray, int]:
    """A one-k-mer-per-line marker file -> (sorted unique words, k)."""
    with open(path, "rb") as f:
        data = f.read()
    k = data.index(b"\n")
    rows = np.frombuffer(data, np.uint8)
    if rows.size % (k + 1):
        raise ValueError(f"{path}: not {k}-mer lines")
    rows = rows.reshape(-1, k + 1)
    if not (rows[:, k] == ord("\n")).all():
        raise ValueError(f"{path}: not {k}-mer lines")
    words = [canonical_words(rows[s:s + _CHUNK, :k], k)[:, 0]
             for s in range(0, rows.shape[0], _CHUNK)]
    return np.unique(np.concatenate(words)), k


def marker_sets(hap0: str, hap1: str):
    """Both sets after adaptor erasure, and k."""
    s0, k = read_marker_words(hap0)
    s1, k1 = read_marker_words(hap1)
    if k1 != k:
        raise ValueError(f"k mismatch: {k} vs {k1}")
    for adaptor in (ADAPTOR_F, ADAPTOR_R):
        if len(adaptor) >= k:
            row = np.frombuffer(adaptor, np.uint8)[None, :]
            erase = canonical_words(row, k)[0]
            s0 = np.setdiff1d(s0, erase)
            s1 = np.setdiff1d(s1, erase)
    return s0, s1, k


def read_fastq(path: str) -> tuple[list[bytes], list[bytes]]:
    """(head lines, sequences) of a 4-line fastq (gzip by '.gz' suffix).
    A record cut after its sequence line still counts; one cut before
    it is dropped."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        lines = f.read().split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    n = len(lines) // 4 + (len(lines) % 4 >= 2)
    return lines[0::4][:n], lines[1::4][:n]


def barcode(head: bytes) -> bytes:
    s = head.rfind(b"#")
    e = head.rfind(b"/")
    return head[s + 1:e] if e > s else head[s + 1:]


def _hits(words: np.ndarray, sets) -> list[np.ndarray]:
    """Membership of every word in each sorted set (queries sorted
    once, so each binary search walks memory in order)."""
    flat = words.ravel()
    order = np.argsort(flat)
    q = flat[order]
    out = []
    for s in sets:
        hit = np.zeros(flat.size, bool)
        if s.size:
            pos = np.minimum(np.searchsorted(s, q), s.size - 1)
            hit[order] = s[pos] == q
        out.append(hit.reshape(words.shape))
    return out


def read_votes(seqs: list[bytes], s0, s1, k: int):
    """Per-read (v0, v1) int64 votes."""
    v = np.zeros((2, len(seqs)), np.int64)
    lens = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
    for length in np.unique(lens):
        if length < k:
            continue
        idx = np.flatnonzero(lens == length)
        for s in range(0, idx.size, _CHUNK):
            part = idx[s:s + _CHUNK]
            rows = np.frombuffer(b"".join(seqs[i] for i in part),
                                 np.uint8).reshape(part.size, length)
            ok = ~(rows == ord("N")).any(axis=1)
            h0, h1 = _hits(canonical_words(rows, k), (s0, s1))
            v[0, part] = h0.sum(axis=1) * ok
            v[1, part] = h1.sum(axis=1) * ok
    return v[0], v[1]


def decide(bcs: np.ndarray, c0: np.ndarray, c1: np.ndarray, size0: int,
           size1: int, w0: float, w1: float) -> np.ndarray:
    """getHap over arrays: 0, 1 or -1 per barcode."""
    with np.errstate(divide="ignore", invalid="ignore"):
        df0 = c0 / float(size0) * w0
        df1 = c1 / float(size1) * w1
    hap = np.full(bcs.shape, -1, np.int64)
    both = (c0 > 0) & (c1 > 0)
    hap[both & (df0 > df1)] = 0
    hap[both & (df1 > df0)] = 1
    hap[(c0 > 0) & (c1 == 0)] = 0
    hap[(c1 > 0) & (c0 == 0)] = 1
    hap[np.isin(bcs, np.array(NULL_BARCODES))] = -1
    return hap


def classify(hap0: str, hap1: str, reads: list[str], w0: float = 1.0,
             w1: float = 1.0) -> bytes:
    """The phased.barcodes bytes the reference classify writes."""
    s0, s1, k = marker_sets(hap0, hap1)
    names, v0s, v1s = [], [], []
    for path in reads:
        heads, seqs = read_fastq(path)
        v0, v1 = read_votes(seqs, s0, s1, k)
        names += [barcode(h) for h in heads]
        v0s.append(v0)
        v1s.append(v1)
    if not names:
        return b""
    bcs, inv = np.unique(np.array(names, dtype=bytes), return_inverse=True)
    c0 = np.bincount(inv, np.concatenate(v0s), bcs.size).astype(np.int64)
    c1 = np.bincount(inv, np.concatenate(v1s), bcs.size).astype(np.int64)
    hap = decide(bcs, c0, c1, s0.size, s1.size, w0, w1)
    return b"".join(b"%s\t%d\t%d\t%d\n" % row for row in
                    zip(bcs.tolist(), hap.tolist(), c0.tolist(), c1.tolist()))
