"""2-bit base codec and vectorized canonical k-mer extraction.

Behavior parity target: the reference's header-only k-mer kernel
(/root/reference/01.classify_stlfr_reads/kmer/kmer.h):

  * base encoding  ``(c & 0x06) >> 1``  => A=0, C=1, T=2, G=3
    (kmer.h:11-12); applied to *any* byte, exactly like the reference —
    degenerate IUPAC codes silently encode to garbage, and only a literal
    ``N`` triggers the read-level short-circuit in stage 01
    (classify.cpp:182-192).
  * complement     ``code ^ 0x02``                       (kmer.h:13)
  * canonical form: min(word, revcomp(word)) under (high, low)
    lexicographic u64-pair comparison (kmer.h:161-166, 169-194).  For
    k <= 31 the reference's ``high`` word is always zero, so the order
    reduces to comparing the low 2k bits — which we carry as a
    (hi, lo) uint32 pair (a single 64-bit key is an open refactor).

Everything here is shape-static jnp: a read batch is a padded
``(B, L)`` uint8 array of ASCII bases plus per-read lengths; k-mer
windows are materialized as ``(B, L-k+1)`` uint32 hi/lo pairs with a
validity mask.  k is limited to 31 (the reference is only safe for
k <= 31 as well: kmer.h:225-238 ``RightBitMove`` falls through for
dis < 64).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

MAX_K = 31

# uint32 sentinel pair that can never be a *canonical* k-mer:
# an all-ones bit pattern is poly-G, and canonical(poly-G) = poly-C
# (C=01 bit pairs), so (0xFFFFFFFF, 0xFFFFFFFF) is unreachable.
SENTINEL = np.uint32(0xFFFFFFFF)


def encode_bases(ascii_u8: jax.Array) -> jax.Array:
    """ASCII bases -> 2-bit codes, A=0 C=1 T=2 G=3 (applied to any byte)."""
    return (ascii_u8.astype(jnp.int32) >> 1) & 3


def _split_shift(pos: int) -> tuple[int, bool]:
    """bit position in the 2k-bit word -> (shift, is_high_word)."""
    return (pos - 32, True) if pos >= 32 else (pos, False)


@functools.partial(jax.jit, static_argnames=("k",))
def canonical_kmers(codes: jax.Array, k: int):
    """All canonical k-mers of each read in a batch.

    Args:
      codes: (B, L) int32 2-bit base codes (from :func:`encode_bases`).
      k: k-mer length, 1..31 (static).

    Returns:
      (hi, lo): each (B, L-k+1) uint32 — canonical k-mer bit words,
      hi = bits [32, 2k), lo = bits [0, 32).  Window validity (length,
      N handling) is the caller's concern; windows over pad bases
      produce garbage values that the caller must mask.
    """
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    L = codes.shape[-1]
    P = L - k + 1
    if P < 1:
        raise ValueError(f"reads of length {L} have no {k}-mers")
    c32 = codes.astype(jnp.uint32)
    zeros = jnp.zeros(codes.shape[:-1] + (P,), jnp.uint32)
    fwd_hi, fwd_lo, rc_hi, rc_lo = zeros, zeros, zeros, zeros
    for j in range(k):
        c = jax.lax.slice_in_dim(c32, j, j + P, axis=-1)
        # forward: base j of the window sits at bit 2*(k-1-j)
        sh, high = _split_shift(2 * (k - 1 - j))
        if high:
            fwd_hi = fwd_hi | (c << sh)
        else:
            fwd_lo = fwd_lo | (c << sh)
        # reverse complement: complemented base j sits at bit 2*j
        cc = c ^ 2
        sh, high = _split_shift(2 * j)
        if high:
            rc_hi = rc_hi | (cc << sh)
        else:
            rc_lo = rc_lo | (cc << sh)
    is_fwd = (fwd_hi < rc_hi) | ((fwd_hi == rc_hi) & (fwd_lo < rc_lo))
    hi = jnp.where(is_fwd, fwd_hi, rc_hi)
    lo = jnp.where(is_fwd, fwd_lo, rc_lo)
    return hi, lo


@functools.partial(jax.jit, static_argnames=("k",))
def window_valid(good_base: jax.Array, lengths: jax.Array, k: int):
    """(B, L) bool per-base validity + (B,) lengths -> (B, L-k+1) bool.

    A window is valid iff all k of its bases are good AND it lies fully
    within the read (start + k <= length).
    """
    L = good_base.shape[-1]
    P = L - k + 1
    bad = (~good_base).astype(jnp.int32)
    csum = jnp.cumsum(bad, axis=-1)
    # bad bases in window [p, p+k) = csum[p+k-1] - csum[p-1]
    hi = jax.lax.slice_in_dim(csum, k - 1, k - 1 + P, axis=-1)
    lo = jnp.concatenate(
        [jnp.zeros(csum.shape[:-1] + (1,), jnp.int32),
         jax.lax.slice_in_dim(csum, 0, P - 1, axis=-1)],
        axis=-1,
    )
    clean = (hi - lo) == 0
    return clean & window_in_read(lengths, L, k)


@functools.partial(jax.jit, static_argnames=("L", "k"))
def window_in_read(lengths: jax.Array, L: int, k: int):
    """(B,) lengths -> (B, L-k+1) bool: the window lies fully within
    the read.  The whole of :func:`window_valid` when every base is
    good — without its cumsum, which XLA would constant-fold at
    compile time over the full batch shape."""
    starts = jax.lax.broadcasted_iota(jnp.int32, (1, L - k + 1), 1)
    return starts + k <= lengths[:, None].astype(jnp.int32)


# ---------------------------------------------------------------------------
# host-side (numpy / python) helpers, used for table building and tests
# ---------------------------------------------------------------------------

_CODE = {"A": 0, "C": 1, "T": 2, "G": 3}
_BASE = "ACTG"


def encode_np(seq_bytes: np.ndarray) -> np.ndarray:
    """numpy twin of :func:`encode_bases` (any byte, (c>>1)&3)."""
    return (seq_bytes.astype(np.int32) >> 1) & 3


def canonical_kmers_np(codes: np.ndarray, k: int):
    """numpy twin of :func:`canonical_kmers` for host-side table builds.

    codes: (..., L) integer array of 2-bit codes.  Returns (hi, lo)
    uint32 arrays of shape (..., L-k+1).
    """
    L = codes.shape[-1]
    P = L - k + 1
    c32 = codes.astype(np.uint32)
    shp = codes.shape[:-1] + (P,)
    fwd_hi = np.zeros(shp, np.uint32)
    fwd_lo = np.zeros(shp, np.uint32)
    rc_hi = np.zeros(shp, np.uint32)
    rc_lo = np.zeros(shp, np.uint32)
    for j in range(k):
        c = c32[..., j:j + P]
        pos = 2 * (k - 1 - j)
        if pos >= 32:
            fwd_hi |= c << np.uint32(pos - 32)
        else:
            fwd_lo |= c << np.uint32(pos)
        cc = c ^ np.uint32(2)
        pos = 2 * j
        if pos >= 32:
            rc_hi |= cc << np.uint32(pos - 32)
        else:
            rc_lo |= cc << np.uint32(pos)
    is_fwd = (fwd_hi < rc_hi) | ((fwd_hi == rc_hi) & (fwd_lo < rc_lo))
    return np.where(is_fwd, fwd_hi, rc_hi), np.where(is_fwd, fwd_lo, rc_lo)


def str_to_kmer(s: str) -> tuple[int, int]:
    """ACTG string -> canonical (hi, lo). Mirrors Kmer::str2Kmer."""
    codes = np.frombuffer(s.encode(), np.uint8)
    hi, lo = canonical_kmers_np(encode_np(codes)[None, :], len(s))
    return int(hi[0, 0]), int(lo[0, 0])


def kmer_to_str(hi: int, lo: int, k: int) -> str:
    """canonical (hi, lo) -> ACTG string. Mirrors Kmer::ToBaseStr."""
    word = (int(hi) << 32) | int(lo)
    return "".join(_BASE[(word >> (2 * (k - 1 - i))) & 3] for i in range(k))


def load_mer_file(path: str, k_expect: int | None = None):
    """Load a one-kmer-per-line text marker file into canonical (hi, lo).

    Mirrors classify.cpp:30-46: k is inferred from the first line; every
    line is canonicalized; duplicates collapse when the caller puts the
    result into a set/table.  Returns (hi, lo, k) as uint32 arrays.
    """
    with open(path, "rb") as f:
        data = f.read()
    if not data:
        raise ValueError(f"empty marker file: {path}")
    k = data.index(b"\n") if b"\n" in data else len(data)
    if k_expect is not None and k != k_expect:
        raise ValueError(f"{path}: k={k}, expected {k_expect}")
    # fixed-width fast path: a well-formed .mer file is k+1 bytes per
    # line, so the whole file reshapes with no python-object split —
    # at human scale (2e8 lines, 4.4 GB) the split()-based path spends
    # minutes building 2e8 bytes objects
    flat = np.frombuffer(data, np.uint8)
    n_full = len(data) // (k + 1)
    if n_full and len(data) % (k + 1) in (0, k):  # maybe no final \n
        arr2 = flat[:n_full * (k + 1)].reshape(n_full, k + 1)
        if (arr2[:, k] == ord("\n")).all():
            tail = flat[n_full * (k + 1):]
            rows = [arr2[:, :k]]
            if tail.size == k:
                rows.append(tail[None, :])
            return _canonical_rows_chunked(rows, k) + (k,)
    lines = data.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    arr = np.frombuffer(b"".join(lines), np.uint8).reshape(len(lines), k)
    hi, lo = canonical_kmers_np(encode_np(arr), k)
    return hi[:, 0], lo[:, 0], k


def _canonical_rows_chunked(rows, k, chunk: int = 1 << 24):
    """Canonicalize (n, k) ASCII rows in bounded-memory chunks (the
    intermediate uint32 code array is 4*k bytes/row — 17 GB at 2e8
    rows if done in one shot)."""
    his, los = [], []
    for arr in rows:
        for s in range(0, arr.shape[0], chunk):
            h, l = canonical_kmers_np(encode_np(arr[s:s + chunk]), k)
            his.append(h[:, 0])
            los.append(l[:, 0])
    if len(his) == 1:
        return his[0], los[0]
    return np.concatenate(his), np.concatenate(los)


def pack_codes_np(seqs_u8: np.ndarray) -> np.ndarray:
    """(…, L) ASCII -> (…, L/4) 2-bit packed uint8, host side.

    Replicates the reference encoding on every byte ((c>>1)&3, so
    IUPAC garbage packs to the same garbage); L must be a multiple of
    4 (batch strides are multiples of 128).  Shrinks host->device
    transfers 4x.
    """
    codes = (seqs_u8 >> 1) & np.uint8(3)
    return (codes[..., 0::4] | (codes[..., 1::4] << np.uint8(2))
            | (codes[..., 2::4] << np.uint8(4))
            | (codes[..., 3::4] << np.uint8(6)))
