"""Sort-based canonical k-mer counting (stage-00 engine).

JAX replacement for jellyfish's lock-free counting hash
(/root/reference/00.build_unshare_kmers_by_jellyfish/build_unshared_kmers.sh:188):
instead of a concurrent hash table, read chunks are 2-bit packed, their
canonical k-mers extracted vectorized, and counted by device sort +
run-length encoding — the XLA-friendly formulation (no atomics).  Chunk
results merge on the host as sorted (uint64 key, count) runs, mirroring
meryl's shard -> count -> union-sum map-reduce
(/root/reference/00.dev_build_unshare_kmers_by_meryl/meryl-1.0/meryl.sh:6-24).

Canonicalization matches the reference classify kernel (A=0,C=1,T=2,G=3
order), NOT jellyfish's A<C<G<T order — the canonical *sets* are
identical, only the emitted representative strand may differ, which no
consumer observes (classify re-canonicalizes on load).  Text dumps use
jellyfish-style representatives (min(s, revcomp(s)) in ASCII order) for
easier eyeballing against jellyfish output.

Validity matches jellyfish: a k-mer window counts iff all its bases are
ACGT/acgt; anything else (N, IUPAC codes) breaks the window.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterable

import jax
import jax.numpy as jnp
import numpy as np

from hast_jax.ops import encode as E

_ACGT = np.zeros(256, bool)
for _c in b"ACGTacgt":
    _ACGT[_c] = True


@functools.partial(jax.jit, static_argnames=("k",))
def chunk_sorted_kmers(seqs_u8: jax.Array, lengths: jax.Array, k: int):
    """All valid canonical k-mers of a padded batch, sorted ascending.

    Invalid windows (non-ACGT base, out of read) become the SENTINEL
    pair so they sort to the end.  Returns (hi, lo) sorted by (hi, lo).
    """
    codes = E.encode_bases(seqs_u8)
    hi, lo = E.canonical_kmers(codes, k)
    good = jnp.asarray(_ACGT)[seqs_u8.astype(jnp.int32)]
    valid = E.window_valid(good, lengths, k)
    hi = jnp.where(valid, hi, jnp.uint32(0xFFFFFFFF)).reshape(-1)
    lo = jnp.where(valid, lo, jnp.uint32(0xFFFFFFFF)).reshape(-1)
    hi, lo = jax.lax.sort((hi, lo), num_keys=2)
    return hi, lo


@functools.partial(jax.jit, static_argnames=("k", "sort"))
def count_kernel_multi(packed: jax.Array, good_packed: jax.Array,
                       lengths: jax.Array, k: int, sort: bool = True):
    """Super-batched k-mer extraction over 2-bit packed reads.

    packed: (S, B, L/4) uint8 2-bit codes; good_packed: (S, B, L/8)
    uint8 bitmask of ACGT-validity per base (bit j of byte m = base
    m*8+j); lengths: (S, B).  Returns (S, B*(L-k+1)) hi/lo per slice —
    one device interaction covers S batches.  sort=True sorts each
    slice (the host Counter consumes sorted runs); the DeviceCounter
    path passes sort=False because its fold re-sorts the concatenation
    anyway — per-chunk sorting was pure wasted device time.
    """

    def one(args):
        p, g, lens = args
        b, lp = p.shape
        shifts = jnp.arange(4, dtype=jnp.int32) * 2
        codes = ((p.astype(jnp.int32)[:, :, None] >> shifts[None, None, :])
                 & 3).reshape(b, lp * 4)
        bit = jnp.arange(8, dtype=jnp.int32)
        good = (((g.astype(jnp.int32)[:, :, None] >> bit[None, None, :])
                 & 1) == 1).reshape(b, lp * 4)
        hi, lo = E.canonical_kmers(codes, k)
        valid = E.window_valid(good, lens, k)
        hi = jnp.where(valid, hi, jnp.uint32(0xFFFFFFFF)).reshape(-1)
        lo = jnp.where(valid, lo, jnp.uint32(0xFFFFFFFF)).reshape(-1)
        if sort:
            return jax.lax.sort((hi, lo), num_keys=2)
        return hi, lo

    return jax.lax.map(one, (packed, good_packed, lengths))


@functools.partial(jax.jit, static_argnames=("k", "sort"))
def count_kernel_multi_range(packed: jax.Array, good_packed: jax.Array,
                             lengths: jax.Array, k: int,
                             lo_hi: jax.Array, lo_lo: jax.Array,
                             hi_hi: jax.Array, hi_lo: jax.Array,
                             sort: bool = True):
    """:func:`count_kernel_multi` restricted to canonical keys in
    ``[(lo_hi, lo_lo), (hi_hi, hi_lo))`` — key-space bounds as uint32
    word pairs (traced scalars; x64 stays off).

    The multi-pass partitioned counter uses this to keep only one key
    range's k-mers per pass — out-of-range windows become sentinel pads
    exactly like invalid windows, so the sort/RLE path is unchanged.
    """

    def one(args):
        p, g, lens = args
        b, lp = p.shape
        shifts = jnp.arange(4, dtype=jnp.int32) * 2
        codes = ((p.astype(jnp.int32)[:, :, None] >> shifts[None, None, :])
                 & 3).reshape(b, lp * 4)
        bit = jnp.arange(8, dtype=jnp.int32)
        good = (((g.astype(jnp.int32)[:, :, None] >> bit[None, None, :])
                 & 1) == 1).reshape(b, lp * 4)
        hi, lo = E.canonical_kmers(codes, k)
        valid = E.window_valid(good, lens, k)
        ge_lo = (hi > lo_hi) | ((hi == lo_hi) & (lo >= lo_lo))
        lt_hi = (hi < hi_hi) | ((hi == hi_hi) & (lo < hi_lo))
        valid = valid & ge_lo & lt_hi
        hi = jnp.where(valid, hi, jnp.uint32(0xFFFFFFFF)).reshape(-1)
        lo = jnp.where(valid, lo, jnp.uint32(0xFFFFFFFF)).reshape(-1)
        if sort:
            return jax.lax.sort((hi, lo), num_keys=2)
        return hi, lo

    return jax.lax.map(one, (packed, good_packed, lengths))


@functools.partial(jax.jit, static_argnames=("k", "sort"))
def count_kernel_multi_clean(packed: jax.Array, lengths: jax.Array,
                             k: int, sort: bool = True):
    """:func:`count_kernel_multi` for CLEAN batches (every base ACGT):
    the validity mask is implied by lengths alone, so the good bitmask
    — a third of the upload bytes — never crosses the host->device
    link.  The counting reader proves cleanliness per batch by
    comparing its mask against the lengths-implied pattern."""

    def one(args):
        p, lens = args
        b, lp = p.shape
        shifts = jnp.arange(4, dtype=jnp.int32) * 2
        codes = ((p.astype(jnp.int32)[:, :, None] >> shifts[None, None, :])
                 & 3).reshape(b, lp * 4)
        hi, lo = E.canonical_kmers(codes, k)
        valid = E.window_in_read(lens, codes.shape[-1], k)
        hi = jnp.where(valid, hi, jnp.uint32(0xFFFFFFFF)).reshape(-1)
        lo = jnp.where(valid, lo, jnp.uint32(0xFFFFFFFF)).reshape(-1)
        if sort:
            return jax.lax.sort((hi, lo), num_keys=2)
        return hi, lo

    return jax.lax.map(one, (packed, lengths))


_POPCNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def batch_is_clean(good: np.ndarray, lengths: np.ndarray) -> bool:
    """True iff every in-length base is ACGT.

    Exact via popcount: the native reader only ever sets mask bits for
    positions < length (good_row, native/hastio.cpp), so the batch is
    clean iff the number of set bits equals the number of bases."""
    set_bits = int(_POPCNT8[good].sum(dtype=np.int64))
    return set_bits == int(np.minimum(
        lengths.astype(np.int64), good.shape[1] * 8).sum())


def pack_good_np(seqs_u8: np.ndarray) -> np.ndarray:
    """(…, L) ASCII -> (…, L/8) uint8 ACGT-validity bitmask."""
    good = _ACGT[seqs_u8].astype(np.uint8)
    out = good[..., 0::8]
    for j in range(1, 8):
        out = out | (good[..., j::8] << np.uint8(j))
    return out


def _rle_sorted(words: np.ndarray, weights: np.ndarray | None = None):
    """Run-length encode a sorted uint64 array -> (unique, counts)."""
    if words.size == 0:
        return words, np.zeros(0, np.int64)
    new = np.empty(words.size, bool)
    new[0] = True
    np.not_equal(words[1:], words[:-1], out=new[1:])
    idx = np.flatnonzero(new)
    if weights is None:
        counts = np.diff(np.append(idx, words.size)).astype(np.int64)
    else:
        csum = np.concatenate([[0], np.cumsum(weights, dtype=np.int64)])
        counts = csum[np.append(idx[1:], words.size)] - csum[idx]
    return words[idx], counts


@dataclasses.dataclass
class CountTable:
    """Sorted (canonical k-mer -> count) table, host resident.

    words: uint64 = (hi << 32) | lo, strictly ascending.
    """

    words: np.ndarray
    counts: np.ndarray
    k: int

    @property
    def n_distinct(self) -> int:
        return int(self.words.size)

    @property
    def total(self) -> int:
        return int(self.counts.sum())

    def histo(self, low: int = 1, high: int = 10000) -> np.ndarray:
        """jellyfish-histo bins: index v holds #kmers with count v for
        v in [low, high]; index high+1 lumps every count > high.
        Index 0..low-1 unused (jellyfish lumps < low into low-1; the
        reference never uses low > 1)."""
        clipped = np.clip(self.counts, 0, high + 1)
        return np.bincount(clipped, minlength=high + 2)

    def filter_range(self, lower: int, upper: int) -> "CountTable":
        """Keep counts in [lower, upper] inclusive (jellyfish dump -L -U)."""
        m = (self.counts >= lower) & (self.counts <= upper)
        return CountTable(self.words[m], self.counts[m], self.k)

    def difference(self, other: "CountTable") -> "CountTable":
        """Keys of self not present in other (meryl difference)."""
        m = ~np.isin(self.words, other.words, assume_unique=True)
        return CountTable(self.words[m], self.counts[m], self.k)

    def intersect_keys(self, other: "CountTable") -> "CountTable":
        m = np.isin(self.words, other.words, assume_unique=True)
        return CountTable(self.words[m], self.counts[m], self.k)

    def to_strings(self) -> np.ndarray:
        """Decode to jellyfish-style canonical strings ((n,) bytes)."""
        return words_to_strings(self.words, self.k)

    def dump_mer_text(self, path: str) -> int:
        """Write one-kmer-per-line text (the .mer interface file)."""
        s = self.to_strings()
        with open(path, "wb") as f:
            if s.size:
                f.write(b"\n".join(s.tolist()) + b"\n")
        return int(s.size)

    def save(self, path: str) -> None:
        """Binary snapshot (the jellyfish .jf / meryl DB analog):
        resumable stage-00 sub-steps reload this instead of recounting
        (build_unshared_kmers.sh:167-298 keeps .jf files the same way)."""
        np.savez(path, words=self.words, counts=self.counts,
                 k=np.int64(self.k))

    @classmethod
    def load(cls, path: str) -> "CountTable":
        z = np.load(path, allow_pickle=False)
        return cls(z["words"], z["counts"], int(z["k"]))


def words_to_strings(words: np.ndarray, k: int) -> np.ndarray:
    """uint64 canonical words -> jellyfish-representative byte strings."""
    n = words.size
    arr = np.empty((n, k), np.uint8)
    int2base = np.frombuffer(b"ACTG", np.uint8)  # HAST encoding order
    for i in range(k):
        arr[:, k - 1 - i] = int2base[
            (words >> np.uint64(2 * i)).astype(np.uint32) & 3]
    # jellyfish emits min(s, revcomp(s)) under ASCII (A<C<G<T) order
    comp = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    rc = comp[arr[:, ::-1]]
    fwd_b = np.ascontiguousarray(arr).view(f"S{k}").reshape(n)
    rc_b = np.ascontiguousarray(rc).view(f"S{k}").reshape(n)
    return np.where(fwd_b <= rc_b, fwd_b, rc_b)


class Counter:
    """Streaming counter: feed device-sorted chunks, finalize to a table.

    Keeps per-chunk RLE runs and merges them once at the end (single
    lexsort over distinct-per-chunk keys) — the union-sum reduce.
    """

    def __init__(self, k: int, compact_above: int = 200_000_000):
        self.k = k
        self._runs: list[tuple[np.ndarray, np.ndarray]] = []
        self._pending = 0
        # bound host memory: merge accumulated runs once they exceed
        # this many distinct-per-chunk entries (meryl's union-sum of
        # intermediate DBs, build_unshared_kmers.sh chunking analog)
        self._compact_above = compact_above

    def add_sorted_chunk(self, hi: np.ndarray, lo: np.ndarray) -> None:
        words = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
        # sentinel pads sort to the end; trim them
        n_valid = int(np.searchsorted(words, np.uint64(0xFFFFFFFFFFFFFFFF)))
        u, c = _rle_sorted(words[:n_valid])
        if u.size:
            self._runs.append((u, c))
            self._pending += u.size
            if self._pending > self._compact_above:
                self.finalize()
                self._pending = self._runs[0][0].size if self._runs else 0

    def merge(self, other: "Counter") -> None:
        self._runs.extend(other._runs)

    def add_table(self, table: "CountTable") -> None:
        """Union-sum a finalized table into this counter."""
        if table.words.size:
            self._runs.append((table.words, table.counts))

    def finalize(self) -> CountTable:
        if not self._runs:
            return CountTable(np.zeros(0, np.uint64), np.zeros(0, np.int64),
                              self.k)
        words = np.concatenate([u for u, _ in self._runs])
        counts = np.concatenate([c for _, c in self._runs])
        order = np.argsort(words, kind="stable")
        u, c = _rle_sorted(words[order], counts[order])
        self._runs = [(u, c)]
        return CountTable(u, c, self.k)


# plain numpy scalar: a module-level jnp constant would initialize the
# XLA backend at import time (breaking jax.distributed.initialize and
# any later platform selection)
_SENT = np.uint32(0xFFFFFFFF)


@jax.jit
def _merge_rle_kernel(hi: jax.Array, lo: jax.Array, counts: jax.Array):
    """Sort (hi, lo, counts) by key and sum counts of equal keys.

    Output keeps the input's physical size: slot g < n_groups holds
    group g's key/total, later slots hold (SENTINEL, 0).  Sentinel keys
    (invalid-window pads) collapse into one group whose count is forced
    to 0, and n_unique excludes it — callers shrink to a power-of-two
    prefix >= n_unique, so the host never sees pads.
    """
    hi, lo, counts = jax.lax.sort((hi, lo, counts), num_keys=2)
    is_sent = (hi == _SENT) & (lo == _SENT)
    counts = jnp.where(is_sent, 0, counts)
    new = jnp.concatenate([
        jnp.ones((1,), bool),
        (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])])
    tgt = jnp.cumsum(new.astype(jnp.int32)) - 1
    n = hi.shape[0]
    out_hi = jnp.full(n, _SENT).at[tgt].set(
        jnp.where(is_sent, _SENT, hi), indices_are_sorted=True)
    out_lo = jnp.full(n, _SENT).at[tgt].set(
        jnp.where(is_sent, _SENT, lo), indices_are_sorted=True)
    out_c = jnp.zeros(n, jnp.int32).at[tgt].add(
        counts, indices_are_sorted=True)
    n_unique = jnp.sum(new & ~is_sent, dtype=jnp.int32)
    return out_hi, out_lo, out_c, n_unique


@functools.partial(jax.jit, static_argnames=("n_pad",))
def _shrink(hi, lo, counts, n_pad: int):
    return hi[:n_pad], lo[:n_pad], counts[:n_pad]


class DeviceCounter:
    """Streaming counter whose table lives in device HBM.

    Where :class:`Counter` round-trips every sorted chunk through the
    host (8 bytes per k-mer position — ruinous on low-bandwidth
    device links, and the host merge fights the reader for CPU), this
    keeps chunks on device, folds them into one sorted run-length
    encoded run with on-device sort+segment-sum, and ships ONLY the
    distinct (k-mer, count) rows at finalize — a factor of
    total/distinct (~ coverage depth) less device->host traffic.
    The jellyfish "-s MEM in-memory hash" analog with XLA-native ops
    (build_unshared_kmers.sh:188); fold sizes are padded to powers of
    two so compile count stays logarithmic.
    """

    # folds allocate ~2x their concatenated input transiently (sort in
    # + out); when two counters stream concurrently (the stage-00
    # parent overlap) simultaneous fold transients can stack past HBM
    # at large distinct sets — one fold at a time bounds the peak to
    # max(transient) + other counters' resident runs.  SYNC_FOLDS
    # (set by count_files_device_pair) additionally blocks until the
    # fold's outputs materialize before releasing the lock, so the two
    # parents' fold transients can never be live simultaneously —
    # async dispatch alone would let thread B enqueue its fold while
    # A's buffers are still held.
    _FOLD_LOCK = __import__("threading").Lock()
    SYNC_FOLDS = False

    def __init__(self, k: int, fold_above: int = 48_000_000):
        self.k = k
        self._chunks: list = []      # (hi, lo, counts|None) device arrays
        self._chunk_elems = 0
        self._run = None             # (hi, lo, counts int32) RLE'd, padded
        self._run_valid = 0          # distinct keys in the run
        self._fold_above = fold_above

    def _fold_threshold(self) -> int:
        """Amortized fold trigger: as the resident run grows, folding
        every fold_above elements re-sorts run/fold_above rows per new
        row.  Let chunks accumulate up to ~run size (geometric
        growth — ~2 sorted rows per new row) while capping the fold's
        concat at 250M elements so the sort transient (in+out, 12 B
        each side) stays under ~6 GB.  Both sizes predate the GPU and
        have not been measured on it."""
        run = self._run_valid or 0
        cap = 250_000_000
        return max(self._fold_above, min(run, max(0, cap - run)))

    def add_sorted_chunk(self, hi: jax.Array, lo: jax.Array) -> None:
        hi = hi.reshape(-1)
        lo = lo.reshape(-1)
        self._chunks.append((hi, lo, None))
        self._chunk_elems += hi.shape[0]
        if self._chunk_elems >= self._fold_threshold():
            self._fold()

    def merge_device(self, other: "DeviceCounter") -> None:
        """Union-sum another DeviceCounter's folded run into this one
        without any device->host traffic (its RLE'd run enters the next
        fold as a weighted chunk)."""
        other._fold(final=True)
        if other._run is not None and other._run_valid:
            rhi, rlo, rc = other._run
            self._chunks.append((rhi, rlo, rc))
            self._chunk_elems += rhi.shape[0]
            other._run = None
            other._run_valid = 0
            if self._chunk_elems >= self._fold_threshold():
                self._fold()

    def _fold(self, final: bool = False) -> None:
        with self._FOLD_LOCK:
            self._fold_locked(final)

    def _fold_locked(self, final: bool = False) -> None:
        # settle the PREVIOUS fold's deferred shrink first: its
        # n_unique scalar has been computed long since (a fold's worth
        # of streaming happened), so the int() below is effectively
        # non-blocking, and the run we concatenate is the shrunk one —
        # without this the resident run grows by ~fold_above elements
        # per fold and the HBM bound is gone.
        self._settle()
        if not self._chunks and self._run is not None:
            return
        his = [h for h, _, _ in self._chunks]
        los = [l for _, l, _ in self._chunks]
        counts = [c if c is not None else jnp.ones(h.shape[0], jnp.int32)
                  for h, _, c in self._chunks]
        if self._run is not None:
            his.append(self._run[0])
            los.append(self._run[1])
            counts.append(self._run[2])
        self._chunks = []
        self._chunk_elems = 0
        if not his:
            return
        hi = jnp.concatenate(his) if len(his) > 1 else his[0]
        lo = jnp.concatenate(los) if len(los) > 1 else los[0]
        cn = jnp.concatenate(counts) if len(counts) > 1 else counts[0]
        rhi, rlo, rc, n_unique = _merge_rle_kernel(hi, lo, cn)
        # defer the scalar n_unique fetch to the NEXT fold (or
        # finalize): a blocking d2h here would serialize the whole
        # pipeline on every fold.
        # Until settled, the run stays at its padded (unshrunk) size —
        # one fold's worth of slack, bounded by fold_above.
        self._pending_n = n_unique
        self._run = (rhi, rlo, rc)
        if DeviceCounter.SYNC_FOLDS:
            jax.block_until_ready(rhi)
        if final:
            self._settle()

    def _settle(self) -> None:
        """Resolve the deferred n_unique and shrink the resident run."""
        if getattr(self, "_pending_n", None) is None:
            return
        n = int(np.asarray(self._pending_n))
        self._pending_n = None
        rhi, rlo, rc = self._run
        n_pad = 1 << max(16, (max(1, n) - 1).bit_length())
        if n_pad < rhi.shape[0]:
            rhi, rlo, rc = _shrink(rhi, rlo, rc, n_pad)
        self._run = (rhi, rlo, rc)
        self._run_valid = n

    def finalize_device(self) -> "DeviceCountTable":
        """Finish folding but keep the table in HBM (stage 00's
        device-resident path: histo / set algebra / range filter all
        happen on device and only final markers ever ship to the host).
        """
        self._fold(final=True)
        if self._run is None:
            z = jnp.zeros(0, jnp.uint32)
            return DeviceCountTable(z, z, jnp.zeros(0, jnp.int32), 0,
                                    self.k)
        rhi, rlo, rc = self._run
        return DeviceCountTable(rhi, rlo, rc, self._run_valid, self.k)

    def finalize(self) -> CountTable:
        self._fold(final=True)
        if self._run is None:
            return CountTable(np.zeros(0, np.uint64),
                              np.zeros(0, np.int64), self.k)
        rhi, rlo, rc = self._run
        n = self._run_valid
        # slice to the exact distinct count ON DEVICE before fetching:
        # np.asarray(rhi)[:n] would ship the whole pow2-padded arrays
        # (up to 2x the data; with low-coverage input distinct ~= total
        # and the padded fetch dominated the counting benchmark).
        # counts ship as uint16 (covers any sane coverage incl. most
        # repeat k-mers) with a scalar overflow escape to raw int32 —
        # same shape of trick as classify's _pack_acc, no nonzero.
        hi = np.asarray(rhi[:n]).astype(np.uint64)
        lo = np.asarray(rlo[:n]).astype(np.uint64)
        rc_n = rc[:n]
        c16 = np.asarray((rc_n & 0xFFFF).astype(jnp.uint16))
        if int(np.asarray(jnp.sum(rc_n > 0xFFFF, dtype=jnp.int32))):
            counts = np.asarray(rc_n).astype(np.int64)
        else:
            counts = c16.astype(np.int64)
        return CountTable((hi << np.uint64(32)) | lo, counts, self.k)



# ---------------------------------------------------------------------------
# device-resident count tables (stage-00 algebra without d2h round-trips)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("high",))
def _histo_kernel(counts: jax.Array, high: int):
    """Per-count-value histogram on device (pads have count 0 -> bin 0,
    which `histo_rows` never reads; counts > high lump into high+1)."""
    c = jnp.clip(counts, 0, high + 1)
    # pads carry count 0; bin 0 is not a real count value — zero it so
    # device and host histograms are bit-identical
    return jnp.bincount(c, length=high + 2).at[0].set(0)


@jax.jit
def _total_kernel(counts: jax.Array):
    """Exact total as two int32 limb arrays of 4096-segment partial
    sums (device int64 is unavailable with x64 off; 4096 * 2^14 and
    4096 * 2^17 both fit int32 comfortably).  Host combines exactly."""
    n = counts.shape[0]
    pad = (-n) % 4096
    c = jnp.concatenate([counts, jnp.zeros(pad, jnp.int32)]) if pad \
        else counts
    c = c.reshape(-1, 4096)
    lo = jnp.sum(c & 0x3FFF, axis=1, dtype=jnp.int32)
    hi = jnp.sum(c >> 14, axis=1, dtype=jnp.int32)
    return lo, hi


@jax.jit
def _unique_filter_kernel(a_hi, a_lo, a_c, b_hi, b_lo, b_c,
                          a_lower, a_upper, b_lower, b_upper):
    """keep masks of the stage-00 marker algebra for BOTH parents in one
    sorted merge: keep_x = (key unique to x) & count in x's bounds.

    Both inputs are distinct-key sorted runs (sentinel-padded).  One
    lax.sort of the concatenation with a source tag decides membership:
    an A-row equal to its successor (which sorts as the B copy, tags
    order A first) is shared; a B-row equal to its predecessor likewise.
    Sentinel pads match each other and self-eliminate (count 0 anyway).
    Bounds are traced scalars — no recompile per bounds choice.
    """
    na = a_hi.shape[0]
    nb = b_hi.shape[0]
    hi = jnp.concatenate([a_hi, b_hi])
    lo = jnp.concatenate([a_lo, b_lo])
    tag = jnp.concatenate([jnp.zeros(na, jnp.int32),
                           jnp.ones(nb, jnp.int32)])
    idx = jnp.concatenate([jnp.arange(na, dtype=jnp.int32),
                           jnp.arange(nb, dtype=jnp.int32)])
    hi_s, lo_s, tag_s, idx_s = jax.lax.sort((hi, lo, tag, idx),
                                            num_keys=3)
    eq_next = (hi_s[:-1] == hi_s[1:]) & (lo_s[:-1] == lo_s[1:])
    f = jnp.zeros(1, bool)
    a_shared_s = jnp.concatenate([eq_next, f]) & (tag_s == 0)
    b_shared_s = jnp.concatenate([f, eq_next]) & (tag_s == 1)
    a_shared = jnp.zeros(na, bool).at[
        jnp.where(tag_s == 0, idx_s, 0)].max(a_shared_s)
    b_shared = jnp.zeros(nb, bool).at[
        jnp.where(tag_s == 1, idx_s, 0)].max(b_shared_s)
    # mask sentinel pads explicitly: a lone first/last pad row has no
    # equal neighbor and would otherwise rely on count-0 being outside
    # the bounds — with lower=0 a 0xFFFF..FF pad key could leak into
    # the marker set.  This makes the kernel safe for ANY bounds.
    a_real = (a_hi != _SENT) | (a_lo != _SENT)
    b_real = (b_hi != _SENT) | (b_lo != _SENT)
    keep_a = (~a_shared) & a_real & (a_c >= a_lower) & (a_c <= a_upper)
    keep_b = (~b_shared) & b_real & (b_c >= b_lower) & (b_c <= b_upper)
    return keep_a, keep_b


@jax.jit
def _compact_kernel(hi, lo, keep):
    """Move kept keys to the front (ascending; dropped keys become
    sentinels and sort to the end) and count them."""
    hi_s, lo_s = jax.lax.sort(
        (jnp.where(keep, hi, _SENT), jnp.where(keep, lo, _SENT)),
        num_keys=2)
    return hi_s, lo_s, jnp.sum(keep, dtype=jnp.int32)


@dataclasses.dataclass
class DeviceCountTable:
    """Sorted (canonical k-mer -> count) table resident in device HBM.

    The d2h-free twin of :class:`CountTable`: histograms reduce on
    device to a (high+2,) vector, the marker set algebra
    (:func:`device_marker_algebra`) runs as device sorts, and only
    final marker rows are ever fetched.  hi/lo are sentinel-padded to
    the fold's power-of-two size; counts are 0 on pads.
    """

    hi: jax.Array
    lo: jax.Array
    counts: jax.Array
    n_valid: int
    k: int

    @property
    def n_distinct(self) -> int:
        return self.n_valid

    @property
    def total(self) -> int:
        lo, hi = _total_kernel(self.counts)
        return int(np.asarray(lo).astype(np.int64).sum()
                   + (np.asarray(hi).astype(np.int64).sum() << 14))

    def histo(self, low: int = 1, high: int = 10000) -> np.ndarray:
        # _histo_kernel's bins are int32: safe iff this table holds
        # < 2^31 rows.  HBM bounds a single-chip resident run to
        # ~1.3e9 keys today, but assert rather than inherit the margin
        # silently (a larger-HBM device or fold_above change would
        # otherwise wrap the count-1 bin negative).
        assert self.counts.shape[0] < 2**31, \
            "histogram bins are int32; shard or partition first"
        return np.asarray(_histo_kernel(self.counts, high)).astype(np.int64)

    def fetch(self) -> CountTable:
        """Full device->host fetch (tests / interop; NOT the hot path)."""
        n = self.n_valid
        hi = np.asarray(self.hi[:n]).astype(np.uint64)
        lo = np.asarray(self.lo[:n]).astype(np.uint64)
        counts = np.asarray(self.counts[:n]).astype(np.int64)
        return CountTable((hi << np.uint64(32)) | lo, counts, self.k)


def device_marker_algebra(pat: DeviceCountTable, mat: DeviceCountTable,
                          p_lower: int, p_upper: int,
                          m_lower: int, m_upper: int
                          ) -> tuple[np.ndarray, np.ndarray]:
    """unique(parent) ∩ count-range(parent) for both parents, on device.

    The whole reference stage-00 algebra
    (00.build_unshare_kmers_by_jellyfish/build_unshared_kmers.sh:257-298:
    dump -L/-U range filters + the 2*mat+1*pat mix-count uniqueness
    trick + the count==2 intersection) collapses to one sorted-merge
    kernel over the two HBM-resident tables; device->host then carries
    ONLY the final marker words (~100x smaller than the distinct sets).
    Returns (paternal_words, maternal_words) as sorted uint64 arrays.
    """
    keep_p, keep_m = _unique_filter_kernel(
        pat.hi, pat.lo, pat.counts, mat.hi, mat.lo, mat.counts,
        jnp.int32(p_lower), jnp.int32(p_upper),
        jnp.int32(m_lower), jnp.int32(m_upper))
    p_hi, p_lo, p_n = _compact_kernel(pat.hi, pat.lo, keep_p)
    m_hi, m_lo, m_n = _compact_kernel(mat.hi, mat.lo, keep_m)
    pn = int(np.asarray(p_n))
    mn = int(np.asarray(m_n))
    p_words = (np.asarray(p_hi[:pn]).astype(np.uint64) << np.uint64(32)) \
        | np.asarray(p_lo[:pn]).astype(np.uint64)
    m_words = (np.asarray(m_hi[:mn]).astype(np.uint64) << np.uint64(32)) \
        | np.asarray(m_lo[:mn]).astype(np.uint64)
    return p_words, m_words


def _assemble_ascii_super_batch(buf: list, S: int):
    """Zero-padded (S, B, L) super-batch from ASCII ReadBatches, packed
    for the device kernels.  Shared by the counting drivers (one place
    for stride/padding rules).  Returns (packed, good, lengths, n_used).
    """
    B = max(b.seqs.shape[0] for b in buf)
    L = max(b.seqs.shape[1] for b in buf)
    L = -(-L // 8) * 8   # pack_good_np packs 8 validity bits per byte
    seqs = np.zeros((S, B, L), np.uint8)
    lengths = np.zeros((S, B), np.int32)
    for s, b in enumerate(buf):
        seqs[s, :b.seqs.shape[0], :b.seqs.shape[1]] = b.seqs
        lengths[s, :b.lengths.shape[0]] = b.lengths
    return (jnp.asarray(E.pack_codes_np(seqs)),
            jnp.asarray(pack_good_np(seqs)),
            jnp.asarray(lengths), len(buf))


def count_batches(batches: Iterable, k: int,
                  super_batch: int = 8,
                  engine: str = "device",
                  finalize: bool = True) -> "CountTable | DeviceCounter":
    """Count canonical k-mers over an iterable of ReadBatches.

    Batches group into super-batches so each device interaction
    (packed upload + dispatch) covers super_batch batches.

    engine="device" (default): sorted chunks stay in HBM and fold via
    :class:`DeviceCounter`; the host receives only the distinct rows.
    engine="host": every sorted chunk is fetched and merged host-side
    (:class:`Counter`) — the fallback when device memory is tight.
    Identical tables either way.

    finalize=False (device engine only) returns the DeviceCounter
    itself, still HBM-resident — the stage-00 device-algebra path.
    """
    S = super_batch
    buf: list = []

    if engine == "device":
        dcounter = DeviceCounter(k)

        def sink(res, n_used):
            # trailing unused slices are all-sentinel; harmless to fold
            dcounter.add_sorted_chunk(res[0][:n_used], res[1][:n_used])

        def done():
            return dcounter if not finalize else dcounter.finalize()
    else:
        counter = Counter(k)
        pending: list = [None]

        def sink(res, n_used):
            if pending[0] is not None:
                p = pending[0]
                rhi, rlo = np.asarray(p[0]), np.asarray(p[1])
                for s in range(p[2]):
                    counter.add_sorted_chunk(rhi[s], rlo[s])
            pending[0] = (res[0], res[1], n_used)

        def done():
            if pending[0] is not None:
                p = pending[0]
                rhi, rlo = np.asarray(p[0]), np.asarray(p[1])
                for s in range(p[2]):
                    counter.add_sorted_chunk(rhi[s], rlo[s])
            return counter.finalize()

    def flush():
        nonlocal buf
        if not buf:
            return
        packed, good, lengths, n_used = _assemble_ascii_super_batch(buf, S)
        buf = []
        res = count_kernel_multi(packed, good, lengths, k,
                                 sort=(engine != "device"))
        sink(res, n_used)

    for batch in batches:
        buf.append(batch)
        if len(buf) >= S:
            flush()
    flush()
    return done()


def estimate_boundaries(batches_sample, k: int, n_parts: int) -> np.ndarray:
    """Key-space split points equalizing mass, from a sample's sorted
    canonical k-mers.  Canonical keys are NOT uniform over the 2^(2k)
    space (canonical = min(fwd, rc) skews low), so fixed even splits
    would unbalance passes badly; quantiles of a sample fix that.
    Returns (n_parts + 1,) uint64 ascending bounds, [0, 2^64) padded.
    """
    chunks = []
    for b in batches_sample:
        hi, lo = chunk_sorted_kmers(jnp.asarray(b.seqs),
                                    jnp.asarray(b.lengths), k)
        w = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) \
            | np.asarray(lo).astype(np.uint64)
        chunks.append(w[w != np.uint64(0xFFFFFFFFFFFFFFFF)])
    sample = np.sort(np.concatenate(chunks)) if chunks else \
        np.zeros(0, np.uint64)
    bounds = np.empty(n_parts + 1, np.uint64)
    bounds[0] = 0
    bounds[-1] = np.uint64(0xFFFFFFFFFFFFFFFF)
    for p in range(1, n_parts):
        if sample.size:
            bounds[p] = sample[min(sample.size - 1,
                                   sample.size * p // n_parts)]
        else:
            # python-int arithmetic: uint64 p*(2**62) wraps for p >= 4,
            # which would make bounds non-monotonic and silently drop
            # k-mers landing in wrapped ranges
            bounds[p] = np.uint64((p * 2**64) // n_parts)
    return bounds


def sample_boundaries(batch_source, k: int, n_parts: int,
                      n_sample: int = 16,
                      scan_cap: int = 512) -> np.ndarray:
    """Quantile key-space split points from a STRIDED batch sample.

    Genomic input is locally correlated (reads arrive roughly in
    library order), so the first-8-batches sample of rounds <=4 could
    systematically skew the quantiles.  Instead scan up to ``scan_cap``
    batches and keep every (scan_cap // n_sample)-th one — same device
    work (<= n_sample batches k-merized), a 64x wider observation
    window.  Per-pass distinct sizes are still logged by the pass
    drivers, so residual skew stays visible."""
    stride = max(1, scan_cap // n_sample)
    sample = []
    for i, b in enumerate(batch_source()):
        if i >= scan_cap:
            break
        if i % stride == 0:
            sample.append(b)
    return estimate_boundaries(sample, k, n_parts)


def count_pass_device(batch_source, k: int, lo_bound: np.uint64,
                      hi_bound: np.uint64,
                      super_batch: int = 8,
                      fold_above: int | None = None) -> DeviceCounter:
    """One key-range pass: stream the whole input, fold only canonical
    k-mers in [lo_bound, hi_bound) into an HBM-resident DeviceCounter.
    """
    lo_b = np.uint64(lo_bound)
    hi_b = np.uint64(hi_bound)
    args = (jnp.uint32(lo_b >> np.uint64(32)), jnp.uint32(lo_b),
            jnp.uint32(hi_b >> np.uint64(32)), jnp.uint32(hi_b))
    S = super_batch
    dcounter = DeviceCounter(k) if fold_above is None \
        else DeviceCounter(k, fold_above=fold_above)
    buf: list = []

    def flush():
        nonlocal buf
        if not buf:
            return
        packed, good, lengths, n_used = \
            _assemble_ascii_super_batch(buf, S)
        buf = []
        res = count_kernel_multi_range(packed, good, lengths, k,
                                       *args, sort=False)
        dcounter.add_sorted_chunk(res[0][:n_used], res[1][:n_used])

    for batch in batch_source():
        buf.append(batch)
        if len(buf) >= S:
            flush()
    flush()
    return dcounter


def count_batches_partitioned(batch_source, k: int, n_parts: int,
                              super_batch: int = 8,
                              boundaries: np.ndarray | None = None
                              ) -> CountTable:
    """Multi-pass HBM-bounded counting (SURVEY §7.3's human-scale plan).

    The key space splits into ``n_parts`` ranges; pass p streams the
    whole input but keeps only range p's canonical k-mers, folding them
    in a DeviceCounter whose resident run is ~1/n_parts of the distinct
    set.  Ranges are disjoint, so the final tables CONCATENATE — no
    cross-range merge.  This is meryl's 64-way sharded DB expressed as
    passes on one chip (meryl-1.0/README.md:13); multi-chip runs shard
    ranges over devices instead (parallel.mesh.sharded_count_chunk).

    batch_source: callable returning a fresh iterator of ReadBatches
    (the input is re-streamed once per pass).
    """
    import sys
    if boundaries is None:
        boundaries = sample_boundaries(batch_source, k, n_parts)
    parts: list[CountTable] = []
    for p in range(n_parts):
        dcounter = count_pass_device(batch_source, k, boundaries[p],
                                     boundaries[p + 1], super_batch)
        t = dcounter.finalize()
        print(f"  count pass {p + 1}/{n_parts}: {t.n_distinct} distinct "
              f"k-mers resident", file=sys.stderr)
        parts.append(t)
    words = np.concatenate([t.words for t in parts])
    counts = np.concatenate([t.counts for t in parts])
    assert np.all(words[1:] > words[:-1]), "ranges overlap"
    return CountTable(words, counts, k)


def count_file_native(path: str, k: int, batch_size: int = 1 << 14,
                      super_batch: int = 8,
                      finalize: bool = True,
                      key_range: tuple | None = None,
                      fold_above: int | None = None
                      ) -> "CountTable | DeviceCounter | None":
    """Count one fasta/fastq file via the native counting reader.

    The C++ threads decode, 2-bit pack and build the ACGT-validity
    bitmask off the GIL (the host-side numpy packing passes dominated
    stage-00 wall time).  Returns None when the reader can't take the
    file (reads beyond the length cap, or multi-line fasta) — callers
    fall back to the python reader, discarding nothing because the
    fold is abandoned whole.

    key_range=(lo, hi) uint64 restricts counting to canonical keys in
    [lo, hi) — one pass of the partitioned (HBM-bounded) counter.

    super_batch: batches per device interaction (not tuned on the
    GPU yet).  fold_above: DeviceCounter fold threshold; key-range
    passes pass a larger one (their resident run is only
    distinct/n_parts, so bigger, fewer folds fit the same HBM).
    """
    from hast_jax.io import fastq as FQ
    from hast_jax.io import native as N
    try:
        fmt = FQ.detect_format(path)
    except ValueError:
        return None
    reader = N.NativeCountReader(path, batch_size, fastq=(fmt == "fastq"))
    S = super_batch
    dcounter = DeviceCounter(k) if fold_above is None \
        else DeviceCounter(k, fold_above=fold_above)
    buf: list = []
    clean: list = []
    range_args = None
    if key_range is not None:
        lo_b, hi_b = np.uint64(key_range[0]), np.uint64(key_range[1])
        range_args = (jnp.uint32(lo_b >> np.uint64(32)), jnp.uint32(lo_b),
                      jnp.uint32(hi_b >> np.uint64(32)), jnp.uint32(hi_b))

    def flush():
        nonlocal buf, clean
        if not buf:
            return
        B = buf[0].packed.shape[0]
        sp = max(b.packed.shape[1] for b in buf)
        packed = np.zeros((S, B, sp), np.uint8)
        lengths = np.zeros((S, B), np.int32)
        for s, b in enumerate(buf):
            packed[s, :, :b.packed.shape[1]] = b.packed
            lengths[s] = b.lengths
        n_used = len(buf)
        # clean super-batch (every in-length base ACGT, the common
        # case): validity derives from lengths on device and the good
        # bitmask — a third of the upload bytes — is never sent
        all_clean = all(clean) and range_args is None
        if not all_clean:
            good = np.zeros((S, B, sp // 2), np.uint8)
            for s, b in enumerate(buf):
                good[s, :, :b.good.shape[1]] = b.good
        buf = []
        clean = []
        if all_clean:
            res = count_kernel_multi_clean(jnp.asarray(packed),
                                           jnp.asarray(lengths), k,
                                           sort=False)
        elif range_args is not None:
            res = count_kernel_multi_range(
                jnp.asarray(packed), jnp.asarray(good),
                jnp.asarray(lengths), k, *range_args, sort=False)
        else:
            res = count_kernel_multi(jnp.asarray(packed),
                                     jnp.asarray(good),
                                     jnp.asarray(lengths), k, sort=False)
        dcounter.add_sorted_chunk(res[0][:n_used], res[1][:n_used])

    # only reader errors (truncation / multi-line fasta) may trigger
    # the python fallback; device errors from flush() must propagate —
    # XlaRuntimeError subclasses RuntimeError and a silent fallback
    # would rerun the whole file on the slow path just to fail again
    it = iter(reader)
    while True:
        try:
            batch = next(it)
        except StopIteration:
            break
        except RuntimeError:
            reader.close()
            return None
        buf.append(batch)
        clean.append(range_args is None
                     and batch_is_clean(batch.good, batch.lengths))
        if len(buf) >= S:
            flush()
    flush()
    reader.close()
    return dcounter if not finalize else dcounter.finalize()
