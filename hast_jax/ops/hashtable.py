"""Static 2-choice bucketized k-mer membership table for device probing.

Replaces the reference's two ``std::unordered_set<Kmer>`` marker sets
(/root/reference/01.classify_stlfr_reads/classify.cpp:27,196-201) with a
single HBM-resident table: one table holds BOTH haplotypes' markers
with a 2-bit membership payload, so the inner loop does a fixed TWO
row-gathers per k-mer (the reference does ~2 hash probes per set, 4
chains total).

Two slot formats share the 2-choice placement (choice is static per
table):

"full" — slot = (hi_word, lo_word) 8 B, bucket row = 2 slots = 16 B.
  A slot's hi word packs the canonical k-mer's high 2k-32 bits
  (< 2**30 for k <= 31) plus the 2-bit payload at bits 30..31.  Empty
  slot = (0xFFFFFFFF, 0xFFFFFFFF), which no canonical k-mer can equal
  (poly-G is never canonical), so empty slots can never match a query.
  Works for every k <= 31.

"quot" — slot = 4 B quotient, bucket row = 4 slots = 16 B.  The 2k-bit
  key runs through an invertible unbalanced-Feistel permutation; the
  low ``bbits`` bits select the home bucket and the remaining
  ``2k - bbits`` bits are stored as the slot's quotient (lossless, so
  membership stays EXACT — no cuckoo-filter false positives).  The
  alternate bucket is ``b ^ (odd_mix(q))`` (partial-key cuckoo); a
  1-bit ``which`` flag per slot disambiguates home-vs-alternate so the
  stored key is uniquely reconstructible.  Slot bits: q (<= 29) |
  which << 29 | payload << 30; payload 0 marks an empty slot and
  contributes nothing to the probe OR, so no emptiness test is needed.
  Requires ``2k - log2(n_buckets) <= 29``; k = 21 default always fits.
  4x smaller than "full", which quadruples the human-scale HBM
  headroom and keeps more of a table in cache (the gain on the GPU
  has not been measured).

Lookups are exactly two row-gathers regardless of load (XLA unrolls
both; no data-dependent loop).  Insertion is host-side numpy on
precomputed (b1, b2) arrays: round 0 fills home buckets vectorized,
round 1 spills the overflow to the alternate bucket; the few
stragglers go through a cuckoo random-walk eviction loop, and only if
that fails does the table double and retry.  Build cost is one-time
and snapshot-cached (.probetable.npz).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

BUCKET = 2
PAYLOAD_SHIFT = np.uint32(30)
HI_MASK = np.uint32((1 << 30) - 1)
EMPTY = np.uint32(0xFFFFFFFF)

_M1 = np.uint32(0x85EBCA6B)
_M2 = np.uint32(0xC2B2AE35)
_GOLD = np.uint32(0x9E3779B9)
_GOLD2 = np.uint32(0xC2B2AE3D)


def _mix(h, xp):
    """murmur3 fmix32; identical semantics under numpy and jnp uint32."""
    h = h ^ (h >> xp.uint32(16))
    h = (h * _M1).astype(xp.uint32) if xp is np else h * _M1
    h = h ^ (h >> xp.uint32(13))
    h = (h * _M2).astype(xp.uint32) if xp is np else h * _M2
    h = h ^ (h >> xp.uint32(16))
    return h


def kmer_hash(hi, lo, xp=np):
    """uint32 hash #1 of a (hi, lo) k-mer pair (host & device agree)."""
    hi = xp.asarray(hi, xp.uint32)
    lo = xp.asarray(lo, xp.uint32)
    if xp is np:
        h = (lo + (hi * _GOLD).astype(np.uint32)).astype(np.uint32)
    else:
        h = lo + hi * _GOLD
    return _mix(h, xp)


def kmer_hash2(hi, lo, xp=np):
    """Independent uint32 hash #2 (the alternate bucket choice)."""
    hi = xp.asarray(hi, xp.uint32)
    lo = xp.asarray(lo, xp.uint32)
    if xp is np:
        h = ((lo ^ _GOLD2) + (hi * _M2).astype(np.uint32)).astype(np.uint32)
    else:
        h = (lo ^ _GOLD2) + hi * _M2
    return _mix(h ^ xp.uint32(0x5BD1E995), xp)


def _hash_round(rnd: int, hi, lo, xp=np):
    return kmer_hash(hi, lo, xp) if rnd == 0 else kmer_hash2(hi, lo, xp)


QUOT_BUCKET = 4                  # slots per bucket in the "quot" format
_WHICH_SHIFT = np.uint32(29)
_QMASK = np.uint32((1 << 29) - 1)


@dataclasses.dataclass
class KmerTable:
    """Host handle for a built table (device arrays + static metadata)."""

    data: np.ndarray          # (n_buckets, 2*BUCKET | QUOT_BUCKET) uint32
    n_buckets: int            # power of two
    max_probe: int            # hash choices scanned by lookups (== 2)
    k: int
    n_keys: int               # distinct canonical keys stored
    set_sizes: tuple[int, ...] = ()  # per-haplotype set size (for getHap)
    cache_key: tuple = ()     # snapshot identity (device-upload reuse)
    fmt: str = "full"         # "full" (8B slots) | "quot" (4B slots)

    def device_put(self, sharding=None):
        self.data = jax.device_put(jnp.asarray(self.data), sharding)
        return self


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


# ---------------------------------------------------------------------------
# "quot" format: invertible key permutation + quotient/bucket split
# ---------------------------------------------------------------------------

_FC = (np.uint32(0x9E3779B9), np.uint32(0x85EBCA6B),
       np.uint32(0xC2B2AE35), np.uint32(0x27D4EB2F))


def _feistel_halves(hi, lo, k: int, xp):
    """4-round balanced Feistel permutation of the 2k-bit key.

    Splits the key into two k-bit halves (A = top, B = bottom) and
    mixes with murmur fmix32 round functions.  A permutation by
    construction, so distinct keys keep distinct images — the quotient
    encoding stays lossless/exact.  Returns (A, B) uint32 halves.
    """
    kmask = xp.uint32((1 << k) - 1)
    hi = xp.asarray(hi, xp.uint32)
    lo = xp.asarray(lo, xp.uint32)
    if k == 32:
        raise ValueError("k <= 31 only")
    A = ((hi << xp.uint32(32 - k)) | (lo >> xp.uint32(k))) & kmask
    B = lo & kmask
    for i, c in enumerate(_FC):
        if xp is np:
            f = _mix((B * _M1).astype(np.uint32) + c, xp) & kmask \
                if i % 2 == 0 else \
                _mix((A * _M1).astype(np.uint32) + c, xp) & kmask
        else:
            f = _mix(B * _M1 + c, xp) & kmask if i % 2 == 0 else \
                _mix(A * _M1 + c, xp) & kmask
        if i % 2 == 0:
            A = A ^ f
        else:
            B = B ^ f
    return A, B


def _quot_bucket_q(hi, lo, k: int, bbits: int, xp=np):
    """(b1, q) of the quotient format: b1 = low bbits of the permuted
    key, q = the remaining 2k - bbits bits (must be <= 29)."""
    A, B = _feistel_halves(hi, lo, k, xp)
    if bbits <= k:
        b1 = B & xp.uint32((1 << bbits) - 1)
        if bbits == k:
            q = A
        else:
            q = (B >> xp.uint32(bbits)) | (A << xp.uint32(k - bbits))
    else:
        b1 = (B | (A << xp.uint32(k))) & xp.uint32((1 << bbits) - 1) \
            if bbits < 32 else (B | (A << xp.uint32(k)))
        q = A >> xp.uint32(bbits - k)
    return b1, q


def _quot_alt(b1, q, bbits: int, xp=np):
    """Alternate bucket: b1 ^ odd_mix(q) (partial-key cuckoo; the xor
    delta is forced odd so b2 != b1)."""
    mask = xp.uint32((1 << bbits) - 1)
    if xp is np:
        g = (_mix((q * _GOLD).astype(np.uint32), xp) | np.uint32(1)) & mask
    else:
        g = (_mix(q * _GOLD, xp) | xp.uint32(1)) & mask
    return b1 ^ g


# ---------------------------------------------------------------------------
# generic 2-choice placement on precomputed (b1, b2) arrays
# ---------------------------------------------------------------------------


def _assign(b1, b2, n_buckets: int, bucket: int):
    """Placement dispatch: the native single-pass greedy + cuckoo walk
    (hastio_place2 — O(n), no argsorts) when libhastio is present,
    else the vectorized numpy rounds.  Both are deterministic given
    (keys, n_buckets) and satisfy the same contract: (row, slot) or
    None when the caller must double the table.  The numpy fallback
    dominated build time at 2e8 keys (two argsorts of the key array
    per attempt); the native pass is pure sequential memory walking.
    """
    try:
        from hast_jax.io import native as N
        res = N.place2(np.asarray(b1, np.uint32),
                       np.asarray(b2, np.uint32),
                       n_buckets, bucket, seed=n_buckets)
    except Exception as e:
        from hast_jax.utils.profiling import notice_fallback
        notice_fallback("native place2", e)
        res = None
    if res == "failed":
        return None
    if res is not None:
        return res
    return _assign_2choice(b1, b2, n_buckets, bucket)


def _assign_2choice(b1, b2, n_buckets: int, bucket: int):
    """Place each key in bucket b1[i] or b2[i]; returns (row, slot)
    int64 arrays or None (caller doubles the table and retries).

    Round 0 fills home buckets vectorized, round 1 the alternates;
    stragglers go through a vectorized cuckoo random-walk (one actor
    per bucket per round evicts a random occupant, which re-enters
    headed for its other choice).  Deterministic (seeded by n_buckets).
    """
    n = b1.size
    row = np.full(n, -1, np.int64)
    slot = np.full(n, -1, np.int64)
    occ = np.full((n_buckets, bucket), -1, np.int64)   # occupant key idx
    occupancy = np.zeros(n_buckets, np.int64)
    pending = np.arange(n)
    for b_all in (b1, b2):
        if not pending.size:
            break
        bb = np.asarray(b_all[pending], np.int64)
        order = np.argsort(bb, kind="stable")
        pend_s, b_s = pending[order], bb[order]
        first = np.empty(b_s.size, bool)
        first[0] = True
        first[1:] = b_s[1:] != b_s[:-1]
        grp_start = np.maximum.accumulate(
            np.where(first, np.arange(b_s.size), 0))
        rank = np.arange(b_s.size) - grp_start
        free = bucket - occupancy[b_s]
        place = rank < free
        tslot = occupancy[b_s] + rank
        keys = pend_s[place]
        row[keys] = b_s[place]
        slot[keys] = tslot[place]
        occ[b_s[place], tslot[place]] = keys
        np.add.at(occupancy, b_s[place], 1)
        pending = pend_s[~place]
    if pending.size and not _walk_2choice(b1, b2, row, slot, occ,
                                          n_buckets, bucket, pending):
        return None
    return row, slot


def _walk_2choice(b1, b2, row, slot, occ, n_buckets: int, bucket: int,
                  pending, max_rounds: int = 4096) -> bool:
    rng = np.random.default_rng(n_buckets)  # deterministic builds
    cur = pending.copy()
    tgt = np.asarray(b2[cur], np.int64)      # greedy rounds tried b1 first
    for _ in range(max_rounds):
        if cur.size == 0:
            return True
        order = np.argsort(tgt, kind="stable")
        t_s = tgt[order]
        first = np.ones(t_s.size, bool)
        first[1:] = t_s[1:] != t_s[:-1]
        actors = order[first]
        ab = tgt[actors]
        free = occ[ab] < 0                   # (A, bucket)
        has_free = free.any(axis=1)
        sl = np.where(has_free, np.argmax(free, axis=1),
                      rng.integers(0, bucket, actors.size))
        victims = occ[ab, sl].copy()         # -1 where slot was free
        keys = cur[actors]
        occ[ab, sl] = keys
        row[keys] = ab
        slot[keys] = sl
        kicked = victims[~has_free]
        k_b1 = np.asarray(b1[kicked], np.int64)
        k_tgt = np.where(k_b1 == row[kicked],
                         np.asarray(b2[kicked], np.int64), k_b1)
        row[kicked] = -1
        slot[kicked] = -1
        keep = np.ones(cur.size, bool)
        keep[actors] = False
        # survivors flip to their other choice
        s_cur = cur[keep]
        s_tgt = np.where(tgt[keep] == np.asarray(b1[s_cur], np.int64),
                         np.asarray(b2[s_cur], np.int64),
                         np.asarray(b1[s_cur], np.int64))
        cur = np.concatenate([s_cur, kicked])
        tgt = np.concatenate([s_tgt, k_tgt])
    return False


def build_table(hi, lo, payload, k: int, load: float = 0.35,
                set_sizes: tuple[int, ...] = (),
                fmt: str = "auto") -> KmerTable:
    """Build a probe table from canonical k-mer arrays.

    Duplicate keys are merged by OR-ing payloads (a marker present in
    both haplotype sets gets payload 3 — the reference keeps it in both
    unordered_sets, which is the same observable behavior).

    fmt: "auto" picks "quot" (4B slots, 4x smaller)
    whenever the quotient fits a slot (2k - log2(n_buckets) <= 29),
    else "full"; pass "full"/"quot" to force.
    """
    hi = np.asarray(hi, np.uint32)
    lo = np.asarray(lo, np.uint32)
    payload = np.asarray(payload, np.uint32)
    if hi.size:
        # dedupe, OR payloads of duplicates.  Native single-call path
        # (threaded sort of (key, pay) structs + linear OR-compact)
        # replaces the numpy lexsort+permute+reduceat chain, which was
        # ~40% of human-scale build time.
        m = None
        try:
            from hast_jax.io import native as N
            # copies: the native sort compacts in place and the
            # caller's arrays must not be clobbered
            hi = hi.copy()
            lo = lo.copy()
            payload = payload.copy()
            m = N.sort_dedup_or(hi, lo, payload)
        except Exception as e:
            from hast_jax.utils.profiling import notice_fallback
            notice_fallback("native sort_dedup_or", e)
        if m is not None:
            hi, lo, payload = hi[:m], lo[:m], payload[:m]
        else:
            order = np.lexsort((lo, hi))
            hi, lo, payload = hi[order], lo[order], payload[order]
            new = np.empty(hi.size, bool)
            new[0] = True
            new[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
            # contiguous groups after the sort: reduceat ORs each run
            # (ufunc.at is a per-element python-speed loop at 2e8 keys)
            pay = np.bitwise_or.reduceat(payload, np.flatnonzero(new))
            hi, lo, payload = hi[new], lo[new], pay
    n = hi.size

    if fmt == "auto":
        nb_q = _next_pow2(max(1, int(np.ceil(n / (QUOT_BUCKET * load)))))
        fmt = "quot" if 2 * k - nb_q.bit_length() + 1 <= 29 else "full"

    if fmt == "quot":
        n_buckets = _next_pow2(max(1, int(np.ceil(n / (QUOT_BUCKET * load)))))
        while True:
            bbits = n_buckets.bit_length() - 1
            if 2 * k - bbits > 29:
                n_buckets *= 2
                continue
            # fused native build: feistel/quotient + placement + fill
            # in one call (the numpy feistel alone is ~30 array passes)
            data = None
            try:
                from hast_jax.io import native as N
                data = N.build_quot(np.ascontiguousarray(hi),
                                    np.ascontiguousarray(lo),
                                    np.ascontiguousarray(payload),
                                    k, bbits, seed=n_buckets)
            except Exception as e:
                from hast_jax.utils.profiling import notice_fallback
                notice_fallback("native build_quot", e)
                data = None
            if data is None:
                b1, q = _quot_bucket_q(hi, lo, k, bbits)
                b2 = _quot_alt(b1, q, bbits)
                asg = _assign(b1, b2, n_buckets, QUOT_BUCKET)
                if asg is None:
                    n_buckets *= 2
                    continue
                row, slot = asg
                data = np.zeros((n_buckets, QUOT_BUCKET), np.uint32)
                which = (row != np.asarray(b1, np.int64)).astype(np.uint32)
                data[row, slot] = (q & _QMASK) | (which << _WHICH_SHIFT) \
                    | (payload << PAYLOAD_SHIFT)
            elif isinstance(data, str):   # "failed": placement full
                n_buckets *= 2
                continue
            return KmerTable(data=data, n_buckets=n_buckets, max_probe=2,
                             k=k, n_keys=n, set_sizes=tuple(set_sizes),
                             fmt="quot")

    n_buckets = _next_pow2(max(1, int(np.ceil(n / (BUCKET * load)))))
    hi_packed = hi | (payload << PAYLOAD_SHIFT)
    while True:
        mask = np.uint32(n_buckets - 1)
        b1 = kmer_hash(hi, lo) & mask
        b2 = kmer_hash2(hi, lo) & mask
        asg = _assign(b1, b2, n_buckets, BUCKET)
        if asg is not None:
            break
        n_buckets *= 2
    row, slot = asg
    data = np.full((n_buckets, 2 * BUCKET), EMPTY, np.uint32)
    data[row, 2 * slot] = hi_packed
    data[row, 2 * slot + 1] = lo
    return KmerTable(data=data, n_buckets=n_buckets, max_probe=2,
                     k=k, n_keys=n, set_sizes=tuple(set_sizes))


@functools.partial(jax.jit, static_argnames=("max_probe",))
def probe(data: jax.Array, q_hi: jax.Array, q_lo: jax.Array,
          max_probe: int = 2) -> jax.Array:
    """Membership payload for each query k-mer (0 = not present).

    data: (n_buckets, 2*BUCKET) uint32;  q_hi/q_lo: any equal shape.
    Returns int32 payloads, same shape as q_hi.  Exactly two
    row-gathers per query (the 2-choice buckets).
    """
    n_buckets = data.shape[0]
    mask = jnp.uint32(n_buckets - 1)
    shape = q_hi.shape
    q_hi = q_hi.reshape(-1).astype(jnp.uint32)
    q_lo = q_lo.reshape(-1).astype(jnp.uint32)
    res = jnp.zeros(q_hi.shape, jnp.uint32)
    for rnd in range(max_probe):
        b = _hash_round(rnd, q_hi, q_lo, jnp) & mask
        rows = jnp.take(data, b.astype(jnp.int32), axis=0)  # (N, 2*BUCKET)
        slot_hi = rows[:, 0::2]
        slot_lo = rows[:, 1::2]
        hit = ((slot_hi & HI_MASK) == q_hi[:, None]) & (slot_lo == q_lo[:, None])
        pay = slot_hi >> PAYLOAD_SHIFT
        res = res | jnp.max(jnp.where(hit, pay, 0), axis=1)
    return res.astype(jnp.int32).reshape(shape)


@functools.partial(jax.jit, static_argnames=("k",))
def probe_quot(data: jax.Array, q_hi: jax.Array, q_lo: jax.Array,
               k: int) -> jax.Array:
    """Membership payload lookup in a "quot"-format table.

    Same two row-gathers as :func:`probe`; rows are 4 quotient slots.
    Exact: the quotient is the lossless remainder of the permuted key,
    and the which-bit pins home-vs-alternate placement, so a slot
    matches iff it stores precisely the queried k-mer.
    """
    n_buckets = data.shape[0]
    bbits = n_buckets.bit_length() - 1
    shape = q_hi.shape
    q_hi = q_hi.reshape(-1).astype(jnp.uint32)
    q_lo = q_lo.reshape(-1).astype(jnp.uint32)
    b1, q = _quot_bucket_q(q_hi, q_lo, k, bbits, jnp)
    b2 = _quot_alt(b1, q, bbits, jnp)
    res = jnp.zeros(q.shape, jnp.uint32)
    for rnd, b in enumerate((b1, b2)):
        rows = jnp.take(data, b.astype(jnp.int32), axis=0)  # (N, 4)
        qf = rows & _QMASK
        which = (rows >> _WHICH_SHIFT) & 1
        pay = rows >> PAYLOAD_SHIFT
        hit = (qf == q[:, None]) & (which == rnd)
        res = res | jnp.max(jnp.where(hit, pay, 0), axis=1)
    return res.astype(jnp.int32).reshape(shape)


def probe_table(data, q_hi, q_lo, k: int, fmt: str,
                max_probe: int = 2):
    """Format dispatch usable both standalone and inside other jits."""
    if fmt == "quot":
        return probe_quot(data, q_hi, q_lo, k)
    return probe(data, q_hi, q_lo, max_probe)


def probe_np(table: KmerTable, q_hi, q_lo):
    """Host-side twin of :func:`probe` (for tests and small inputs)."""
    q_hi = np.asarray(q_hi, np.uint32).reshape(-1)
    q_lo = np.asarray(q_lo, np.uint32).reshape(-1)
    if table.fmt == "quot":
        bbits = table.n_buckets.bit_length() - 1
        b1, q = _quot_bucket_q(q_hi, q_lo, table.k, bbits)
        b2 = _quot_alt(b1, q, bbits)
        res = np.zeros(q.shape, np.uint32)
        for rnd, b in enumerate((b1, b2)):
            rows = table.data[b.astype(np.int64)]
            qf = rows & _QMASK
            which = (rows >> _WHICH_SHIFT) & 1
            pay = rows >> PAYLOAD_SHIFT
            hit = (qf == q[:, None]) & (which == rnd)
            res |= np.max(np.where(hit, pay, 0), axis=1).astype(np.uint32)
        return res.astype(np.int32)
    mask = np.uint32(table.n_buckets - 1)
    res = np.zeros(q_hi.shape, np.uint32)
    for rnd in range(table.max_probe):
        b = (_hash_round(rnd, q_hi, q_lo) & mask).astype(np.int64)
        rows = table.data[b]
        slot_hi, slot_lo = rows[:, 0::2], rows[:, 1::2]
        hit = ((slot_hi & HI_MASK) == q_hi[:, None]) & (slot_lo == q_lo[:, None])
        pay = slot_hi >> PAYLOAD_SHIFT
        res |= np.max(np.where(hit, pay, 0), axis=1).astype(np.uint32)
    return res.astype(np.int32)


def remove_keys(table: KmerTable, hi, lo, payload_mask: int,
                set_sizes_delta: list[int] | None = None) -> list[tuple[int, int, int]]:
    """Clear payload bits of given keys in-place (adaptor erasure).

    Mirrors InitAdaptor (classify.cpp:314-339): adaptor k-mers are
    erased from the marker sets *and* the normalization set sizes
    shrink.  Returns [(hi, lo, cleared_bits)] for logging parity.
    A slot whose payload becomes 0 stays physically present (it can
    never be reported since its payload is 0).

    ADAPTOR-SCALE ONLY: this walks keys in scalar python (~50 adaptor
    k-mers per run).  It is the table's only mutation path by design —
    for bulk erasure rebuild the table from filtered key arrays
    instead; a per-key loop over millions of keys would take hours.
    """
    hi = np.asarray(hi, np.uint32).reshape(-1)
    lo = np.asarray(lo, np.uint32).reshape(-1)
    cleared = []
    sizes = list(table.set_sizes)
    seen = set()

    if table.fmt == "quot":
        bbits = table.n_buckets.bit_length() - 1
        b1a, qa = _quot_bucket_q(hi, lo, table.k, bbits)
        b2a = _quot_alt(b1a, qa, bbits)
        for i in range(hi.size):
            key = (int(hi[i]), int(lo[i]))
            if key in seen:
                continue
            seen.add(key)
            for rnd, b in enumerate((int(b1a[i]), int(b2a[i]))):
                row = table.data[b]
                for s in range(QUOT_BUCKET):
                    w = int(row[s])
                    if (w & int(_QMASK)) == int(qa[i]) and \
                            ((w >> int(_WHICH_SHIFT)) & 1) == rnd:
                        pay = w >> int(PAYLOAD_SHIFT)
                        bits = pay & payload_mask
                        if bits:
                            new_pay = pay & ~payload_mask
                            table.data[b, s] = np.uint32(
                                (w & 0x3FFFFFFF)
                                | (new_pay << int(PAYLOAD_SHIFT)))
                            cleared.append((key[0], key[1], bits))
                            for hap in range(len(sizes)):
                                if bits & (1 << hap):
                                    sizes[hap] -= 1
        table.set_sizes = tuple(sizes)
        return cleared

    mask = np.uint32(table.n_buckets - 1)
    for i in range(hi.size):
        key = (int(hi[i]), int(lo[i]))
        if key in seen:
            continue
        seen.add(key)
        for rnd in range(table.max_probe):
            b = int(_hash_round(rnd, hi[i:i + 1], lo[i:i + 1])[0] & mask)
            row = table.data[b]
            for s in range(BUCKET):
                if (int(row[2 * s]) & int(HI_MASK)) == key[0] and \
                        int(row[2 * s + 1]) == key[1]:
                    pay = int(row[2 * s]) >> int(PAYLOAD_SHIFT)
                    bits = pay & payload_mask
                    if bits:
                        new_pay = pay & ~payload_mask
                        table.data[b, 2 * s] = np.uint32(
                            key[0] | (new_pay << int(PAYLOAD_SHIFT)))
                        cleared.append((key[0], key[1], bits))
                        for hap in range(len(sizes)):
                            if bits & (1 << hap):
                                sizes[hap] -= 1
    table.set_sizes = tuple(sizes)
    return cleared
