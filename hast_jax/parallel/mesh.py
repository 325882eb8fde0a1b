"""Device-mesh sharding for the classify and counting paths.

The reference's concurrency is a single-node thread pool with a
commutative per-barcode counter merge (classify.cpp:129-236) plus an
offline file-shard reduce (mergeResult.cpp).  The mesh formulation:

  * mesh axes ("dp", "tp"): read batches are data-parallel over dp;
    the marker table is hash-sharded over tp (memory-capacity sharding
    for human-scale tables that exceed one chip's HBM).
  * probe: every (dp, tp) device probes its local read shard's k-mers
    against its table shard, masking keys whose home bucket lives on
    another shard; a psum over tp reassembles full payloads.  This
    avoids ragged all_to_all on the probe path entirely — one
    collective per batch.
  * votes: per-read reduction, then a segment-sum by barcode id and a
    psum over dp gives global per-barcode tallies on every device.

All code here is shard_map + jnp; it runs identically on a CPU
fake-device mesh (XLA_FLAGS=--xla_force_host_platform_device_count=N)
and on the GPUs of one host.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hast_jax.ops import encode as E
from hast_jax.ops import hashtable as H


def make_mesh(n_devices: int | None = None, tp: int = 1,
              devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = n_devices or len(devices)
    assert n % tp == 0, (n, tp)
    dev = np.asarray(devices[:n]).reshape(n // tp, tp)
    return Mesh(dev, ("dp", "tp"))


def choose_tp(table_bytes: int, n_devices: int,
              budget_bytes: int | None = None) -> int:
    """Replicated-vs-sharded probe autoswitch (SURVEY §7.2-5).

    Replicating the table on every device is fastest (no tp
    collectives); shard over tp only when the table would eat too much
    of each device's memory.  Returns the smallest power-of-two tp
    whose shard fits `budget_bytes`, by default a quarter of the
    device's ``bytes_limit``.  A device that reports no limit (the CPU
    backend) needs an explicit budget.
    """
    if budget_bytes is None:
        stats = jax.devices()[0].memory_stats() or {}
        if "bytes_limit" not in stats:
            raise ValueError(
                "device reports no bytes_limit; pass budget_bytes")
        budget_bytes = stats["bytes_limit"] // 4
    tp = 1
    while tp < n_devices and table_bytes // tp > budget_bytes:
        tp *= 2
    return tp


def shard_table(mesh: Mesh, table: H.KmerTable) -> jax.Array:
    """Place the (n_buckets, 2*BUCKET) table hash-sharded over tp.

    Bucket rows are already hash-ordered, so an even row split IS a
    hash shard; probing masks by bucket ownership.  n_buckets is a
    power of two and tp divides it for any sane config.
    """
    sharding = NamedSharding(mesh, P("tp", None))
    return jax.device_put(jnp.asarray(table.data), sharding)


def _probe_local(local_table, q_hi, q_lo, n_buckets_global, max_probe,
                 tp_index, buckets_per_shard, k=None, fmt="full"):
    """Probe only the keys whose 2-choice buckets live on this shard."""
    res = jnp.zeros(q_hi.shape, jnp.uint32)
    lo_bucket = tp_index * buckets_per_shard
    if fmt == "quot":
        bbits = n_buckets_global.bit_length() - 1
        qsh = q_hi.reshape(-1).astype(jnp.uint32)
        qsl = q_lo.reshape(-1).astype(jnp.uint32)
        b1, q = H._quot_bucket_q(qsh, qsl, k, bbits, jnp)
        b2 = H._quot_alt(b1, q, bbits, jnp)
        b1 = b1.reshape(q_hi.shape)
        b2 = b2.reshape(q_hi.shape)
        q = q.reshape(q_hi.shape)
        for rnd, b in enumerate((b1, b2)):
            local_b = b.astype(jnp.int32) - lo_bucket
            owned = (local_b >= 0) & (local_b < buckets_per_shard)
            safe_b = jnp.where(owned, local_b, 0)
            rows = jnp.take(local_table, safe_b, axis=0)
            qf = rows & H._QMASK
            which = (rows >> H._WHICH_SHIFT) & 1
            pay = rows >> H.PAYLOAD_SHIFT
            hit = (qf == q[..., None]) & (which == rnd) & owned[..., None]
            res = res | jnp.max(jnp.where(hit, pay, 0), axis=-1)
        return res
    mask = jnp.uint32(n_buckets_global - 1)
    for rnd in range(max_probe):
        b = H._hash_round(rnd, q_hi, q_lo, jnp) & mask
        local_b = b.astype(jnp.int32) - lo_bucket
        owned = (local_b >= 0) & (local_b < buckets_per_shard)
        safe_b = jnp.where(owned, local_b, 0)
        rows = jnp.take(local_table, safe_b, axis=0)
        slot_hi = rows[..., 0::2]
        slot_lo = rows[..., 1::2]
        hit = ((slot_hi & H.HI_MASK) == q_hi[..., None]) \
            & (slot_lo == q_lo[..., None]) & owned[..., None]
        pay = slot_hi >> H.PAYLOAD_SHIFT
        res = res | jnp.max(jnp.where(hit, pay, 0), axis=-1)
    return res


@functools.partial(
    jax.jit, static_argnames=("mesh", "k", "max_probe", "n_buckets",
                              "num_barcodes", "fmt"))
def sharded_classify_step(mesh: Mesh, table_sharded: jax.Array,
                          seqs_u8: jax.Array, lengths: jax.Array,
                          barcode_ids: jax.Array, has_n: jax.Array,
                          k: int, max_probe: int, n_buckets: int,
                          num_barcodes: int, fmt: str = "full"):
    """One full device step: probe + vote + per-barcode tally.

    seqs_u8 (B, L) / lengths (B,) / barcode_ids (B,) / has_n (B,) are
    dp-sharded on dim 0; table (n_buckets, 16) is tp-sharded on dim 0.
    Returns (num_barcodes, 3) int32 global tallies, replicated:
    columns = hap0 votes, hap1 votes, unknown(-1) counts.
    """
    tp = mesh.shape["tp"]
    buckets_per_shard = n_buckets // tp

    def step(table_local, seqs, lengths, bids, has_n):
        tp_index = jax.lax.axis_index("tp")
        codes = E.encode_bases(seqs)
        hi, lo = E.canonical_kmers(codes, k)
        valid = E.window_in_read(lengths, seqs.shape[-1], k)
        pay = _probe_local(table_local, hi, lo, n_buckets, max_probe,
                           tp_index, buckets_per_shard, k, fmt)
        pay = jax.lax.psum(jnp.where(valid, pay, 0), "tp")
        v0 = jnp.sum(pay & 1, axis=-1, dtype=jnp.int32)
        v1 = jnp.sum((pay >> 1) & 1, axis=-1, dtype=jnp.int32)
        v0 = jnp.where(has_n, 0, v0)
        v1 = jnp.where(has_n, 0, v1)
        unk = (has_n | ((v0 == 0) & (v1 == 0))).astype(jnp.int32)
        votes = jnp.stack([v0, v1, unk], axis=-1)
        tally = jax.ops.segment_sum(votes, bids, num_segments=num_barcodes)
        return jax.lax.psum(tally, "dp")

    return jax.shard_map(
        step, mesh=mesh,
        in_specs=(P("tp", None), P("dp", None), P("dp"), P("dp"), P("dp")),
        out_specs=P(),
    )(table_sharded, seqs_u8, lengths, barcode_ids, has_n)


@functools.partial(jax.jit, static_argnames=("mesh", "k", "max_probe",
                                              "n_buckets", "fmt"))
def sharded_vote_step(mesh: Mesh, table_sharded: jax.Array,
                      packed: jax.Array, lengths: jax.Array,
                      k: int, max_probe: int, n_buckets: int,
                      fmt: str = "full"):
    """Per-read votes on a dp×tp mesh: (S, B, L/4) packed -> (S, B, 2).

    Streaming-pipeline variant of :func:`sharded_classify_step`: the
    barcode reduction stays on the host (barcode ids are host-side
    dictionary state), so this only shards the probe — reads split
    over dp (dim 1), table over tp, psum over tp rebuilds payloads.
    """
    tp = mesh.shape["tp"]
    buckets_per_shard = n_buckets // tp

    def step(table_local, packed, lengths):
        tp_index = jax.lax.axis_index("tp")

        def one(args):
            p, lens = args
            b, lp = p.shape
            shifts = jnp.arange(4, dtype=jnp.int32) * 2
            codes = ((p.astype(jnp.int32)[:, :, None]
                      >> shifts[None, None, :]) & 3).reshape(b, lp * 4)
            hi, lo = E.canonical_kmers(codes, k)
            valid = E.window_in_read(lens, codes.shape[-1], k)
            pay = _probe_local(table_local, hi, lo, n_buckets, max_probe,
                               tp_index, buckets_per_shard, k, fmt)
            pay = jax.lax.psum(jnp.where(valid, pay, 0), "tp")
            v0 = jnp.sum(pay & 1, axis=-1, dtype=jnp.int32)
            v1 = jnp.sum((pay >> 1) & 1, axis=-1, dtype=jnp.int32)
            # uint16 halves vote fetch traffic (votes < 2^16, see
            # pipeline.classify.vote_kernel_packed)
            return jnp.stack([v0, v1], axis=-1).astype(jnp.uint16)

        return jax.lax.map(one, (packed, lengths))

    return jax.shard_map(
        step, mesh=mesh,
        in_specs=(P("tp", None), P(None, "dp", None), P(None, "dp")),
        out_specs=P(None, "dp", None),
    )(table_sharded, packed, lengths)


# ---------------------------------------------------------------------------
# mesh-sharded device-resident count tables (multi-chip stage 00)
# ---------------------------------------------------------------------------
#
# The single-chip DeviceCounter bounds HBM via key-range passes; on a
# mesh the same tables shard by HASH RANGE over dp instead (each
# device's resident run is distinct/dp — a human parent's ~36 GB
# distinct set fits a 16-chip slice with no extra input passes).  The
# fold/histogram/marker-algebra kernels are the single-chip ones run
# per-shard under shard_map: hash ranges are disjoint and identical
# for both parents (same routing), so the set algebra needs NO
# cross-device communication; only the global histogram psums over dp.


@jax.jit
def _ones_like_sharded(h):
    return (h ^ h).astype(jnp.int32) + 1


@functools.partial(jax.jit, static_argnames=("mesh",))
def _mesh_fold(mesh: Mesh, hi, lo, counts):
    """Per-shard sort+RLE fold: (dp, n) sharded arrays -> same shapes
    RLE'd per shard + (dp,) distinct counts."""
    from hast_jax.ops.kmer_count import _merge_rle_kernel

    def f(h, l, c):
        rh, rl, rc, nu = _merge_rle_kernel(h[0], l[0], c[0])
        return rh[None], rl[None], rc[None], nu[None]

    return jax.shard_map(
        f, mesh=mesh,
        in_specs=(P("dp", None), P("dp", None), P("dp", None)),
        out_specs=(P("dp", None), P("dp", None), P("dp", None), P("dp")),
    )(hi, lo, counts)


@functools.partial(jax.jit, static_argnames=("mesh", "high"))
def _mesh_histo(mesh: Mesh, counts, high: int):
    """PER-SHARD count histograms: (dp, high+2) int32, summed on the
    host in int64 by the caller.  A global psum here would overflow
    int32 in the count-1 bin at the module's advertised ~3e9-key scale
    (error k-mers alone can exceed 2^31 across a 16-chip slice); the
    per-shard vectors are each bounded by shard size < 2^31 and are
    only (high+2,) ints of d2h."""

    def f(c):
        h = jnp.bincount(jnp.clip(c[0], 0, high + 1), length=high + 2)
        return h.at[0].set(0)[None]

    return jax.shard_map(f, mesh=mesh, in_specs=(P("dp", None),),
                         out_specs=P("dp", None))(counts)


@functools.partial(jax.jit, static_argnames=("mesh",))
def _mesh_total(mesh: Mesh, counts):
    """Exact global total via the two-limb segment sums, psummed.

    Outputs are REPLICATED (out_specs=P()): a dp-sharded out_spec
    would tile the already-psummed vectors dp times and the host sum
    would overcount by a factor of dp.
    """
    from hast_jax.ops.kmer_count import _total_kernel

    def f(c):
        lo16, hi16 = _total_kernel(c[0])
        return (jax.lax.psum(lo16, "dp"), jax.lax.psum(hi16, "dp"))

    lo16, hi16 = jax.shard_map(f, mesh=mesh, in_specs=(P("dp", None),),
                               out_specs=(P(), P()))(counts)
    return lo16, hi16


@functools.partial(jax.jit, static_argnames=("mesh",))
def _mesh_unique_filter(mesh: Mesh, a_hi, a_lo, a_c, b_hi, b_lo, b_c,
                        a_lower, a_upper, b_lower, b_upper):
    """Per-shard marker algebra + compaction for BOTH parents.

    Shards hold identical hash ranges for a and b, so uniqueness is
    decidable locally.  Returns per-shard compacted (hi, lo) arrays +
    (dp,) kept-counts for each parent.
    """
    from hast_jax.ops.kmer_count import (_compact_kernel,
                                         _unique_filter_kernel)

    def f(ah, al, ac, bh, bl, bc):
        keep_a, keep_b = _unique_filter_kernel(
            ah[0], al[0], ac[0], bh[0], bl[0], bc[0],
            a_lower, a_upper, b_lower, b_upper)
        pah, pal, pan = _compact_kernel(ah[0], al[0], keep_a)
        pbh, pbl, pbn = _compact_kernel(bh[0], bl[0], keep_b)
        return (pah[None], pal[None], pan[None],
                pbh[None], pbl[None], pbn[None])

    specs = (P("dp", None),) * 3
    return jax.shard_map(
        f, mesh=mesh, in_specs=specs + specs,
        out_specs=(P("dp", None), P("dp", None), P("dp"),
                   P("dp", None), P("dp", None), P("dp")),
    )(a_hi, a_lo, a_c, b_hi, b_lo, b_c)


class MeshCountTable:
    """Hash-range-sharded (dp, n) count table resident across a mesh."""

    def __init__(self, mesh, hi, lo, counts, n_valid, k: int):
        self.mesh = mesh
        self.hi = hi
        self.lo = lo
        self.counts = counts
        self.n_valid = np.asarray(n_valid)   # (dp,) distinct per shard
        self.k = k

    @property
    def n_distinct(self) -> int:
        return int(self.n_valid.sum())

    @property
    def total(self) -> int:
        lo16, hi16 = _mesh_total(self.mesh, self.counts)
        return int(np.asarray(lo16).astype(np.int64).sum()
                   + (np.asarray(hi16).astype(np.int64).sum() << 14))

    def histo(self, low: int = 1, high: int = 10000) -> np.ndarray:
        per_shard = np.asarray(_mesh_histo(self.mesh, self.counts, high))
        return per_shard.astype(np.int64).sum(axis=0)


class MeshDeviceCounter:
    """Streaming mesh counter: feed sharded_count_chunk outputs, fold
    per shard in HBM, finalize to a :class:`MeshCountTable`.

    The multi-chip twin of ops.kmer_count.DeviceCounter — same deferred
    n_unique settling, same pow2 shrink, but state arrays carry a
    leading dp dim sharded over the mesh and every op is shard-local.
    """

    def __init__(self, mesh, k: int, fold_above: int = 48_000_000):
        self.mesh = mesh
        self.k = k
        self.dp = mesh.shape["dp"]
        self._chunks: list = []
        self._chunk_elems = 0          # per-shard elements
        self._run = None
        self._pending_n = None
        self._run_valid = None         # (dp,) numpy
        self._fold_above = fold_above

    def add_chunk(self, hi, lo) -> None:
        """hi/lo: (dp, m) sharded on dim 0, per-shard sorted + pads."""
        self._chunks.append((hi, lo, None))
        self._chunk_elems += hi.shape[1]
        if self._chunk_elems >= self._fold_above:
            self._fold()

    def _fold(self, final: bool = False) -> None:
        self._settle()
        if not self._chunks:
            return
        his = [h for h, _, _ in self._chunks]
        los = [l for _, l, _ in self._chunks]
        # ones built FROM the sharded array so the sharding propagates
        # (a plain jnp.ones would materialize replicated on every chip)
        counts = [c if c is not None else _ones_like_sharded(h)
                  for h, _, c in self._chunks]
        if self._run is not None:
            his.append(self._run[0])
            los.append(self._run[1])
            counts.append(self._run[2])
        self._chunks = []
        self._chunk_elems = 0
        hi = jnp.concatenate(his, axis=1) if len(his) > 1 else his[0]
        lo = jnp.concatenate(los, axis=1) if len(los) > 1 else los[0]
        cn = jnp.concatenate(counts, axis=1) if len(counts) > 1 \
            else counts[0]
        rhi, rlo, rc, n_unique = _mesh_fold(self.mesh, hi, lo, cn)
        self._pending_n = n_unique
        self._run = (rhi, rlo, rc)
        if final:
            self._settle()

    def _settle(self) -> None:
        if self._pending_n is None:
            return
        n = np.asarray(self._pending_n)
        self._pending_n = None
        rhi, rlo, rc = self._run
        n_pad = 1 << max(16, (max(1, int(n.max())) - 1).bit_length())
        if n_pad < rhi.shape[1]:
            rhi, rlo, rc = (rhi[:, :n_pad], rlo[:, :n_pad],
                            rc[:, :n_pad])
        self._run = (rhi, rlo, rc)
        self._run_valid = n

    def finalize_mesh(self) -> MeshCountTable:
        self._fold(final=True)
        if self._run is None:
            z = jnp.zeros((self.dp, 0), jnp.uint32)
            return MeshCountTable(self.mesh, z, z,
                                  jnp.zeros((self.dp, 0), jnp.int32),
                                  np.zeros(self.dp, np.int64), self.k)
        rhi, rlo, rc = self._run
        return MeshCountTable(self.mesh, rhi, rlo, rc,
                              self._run_valid, self.k)


def mesh_marker_algebra(pat: MeshCountTable, mat: MeshCountTable,
                        p_lower: int, p_upper: int,
                        m_lower: int, m_upper: int):
    """unique ∩ count-range per parent, per shard; fetches ONLY the
    final marker rows and returns two sorted uint64 host arrays.
    Shards are hash ranges (not key ranges), so the concatenated
    markers get one small host sort for the canonical ascending dump
    order."""
    # pad both parents' shards to a common width for the paired kernel
    pads = max(pat.hi.shape[1], mat.hi.shape[1])

    def padded(t):
        m = t.hi.shape[1]
        if m == pads:
            return t.hi, t.lo, t.counts
        ext = pads - m
        sent = jnp.full((t.hi.shape[0], ext), np.uint32(0xFFFFFFFF),
                        jnp.uint32)
        return (jnp.concatenate([t.hi, sent], axis=1),
                jnp.concatenate([t.lo, sent], axis=1),
                jnp.concatenate(
                    [t.counts, jnp.zeros((t.hi.shape[0], ext),
                                         jnp.int32)], axis=1))

    ah, al, ac = padded(pat)
    bh, bl, bc = padded(mat)
    pah, pal, pan, pbh, pbl, pbn = _mesh_unique_filter(
        pat.mesh, ah, al, ac, bh, bl, bc,
        jnp.int32(p_lower), jnp.int32(p_upper),
        jnp.int32(m_lower), jnp.int32(m_upper))
    pan = np.asarray(pan)
    pbn = np.asarray(pbn)

    def fetch(h, l, ns):
        words = []
        for d in range(ns.size):
            n = int(ns[d])
            if n:
                hh = np.asarray(h[d, :n]).astype(np.uint64)
                ll = np.asarray(l[d, :n]).astype(np.uint64)
                words.append((hh << np.uint64(32)) | ll)
        if not words:
            return np.zeros(0, np.uint64)
        return np.sort(np.concatenate(words))

    return fetch(pah, pal, pan), fetch(pbh, pbl, pbn)


@functools.partial(jax.jit, static_argnames=("mesh", "k", "slack"))
def sharded_count_chunk(mesh: Mesh, seqs_u8: jax.Array, lengths: jax.Array,
                        k: int, slack: int = 2):
    """Distributed k-mer counting step: dp-sharded reads -> per-device
    hash-range-sharded sorted k-mer streams via all_to_all over dp.

    Each dp shard extracts canonical k-mers, routes each to the device
    owning its hash range (equal fixed capacity per destination with
    sentinel padding — meryl's shard->count->union-sum over ICI), and
    locally sorts.  Returns (hi, lo) with shape (dp, cap) sharded on
    dim 0; sentinel entries pad the tail of each shard.

    slack: per-destination capacity multiplier (cap = n // dp * slack).
    2 is ample for hash-uniform keys; overflow recovery re-dispatches
    the SAME batch with doubled slack (halving cannot fix systematic
    skew — the cap scales with batch size, so a destination receiving
    a constant fraction of keys overflows at every size).  At
    slack >= dp, cap >= n and a drop is impossible.
    """
    dp = mesh.shape["dp"]
    from hast_jax.ops.kmer_count import _ACGT

    def step(seqs, lengths):
        codes = E.encode_bases(seqs)
        hi, lo = E.canonical_kmers(codes, k)
        good = jnp.asarray(_ACGT)[seqs.astype(jnp.int32)]
        valid = E.window_valid(good, lengths, k)
        hi = jnp.where(valid, hi, E.SENTINEL).reshape(-1)
        lo = jnp.where(valid, lo, E.SENTINEL).reshape(-1)
        n = hi.shape[0]
        # per-destination capacity; exactly n at full slack (n//dp*dp
        # can be n-1 when dp doesn't divide n, which could still drop)
        cap = n if slack >= dp else min(n, n // dp * slack)
        # destination shard by top hash bits (sentinel -> own shard)
        h = H.kmer_hash(hi, lo, jnp)
        if dp == 1:
            dest = jnp.zeros(h.shape, jnp.int32)
        else:
            # multiply-shift range partition of the hash space
            dest = ((h.astype(jnp.uint64) * jnp.uint64(dp))
                    >> jnp.uint64(32)).astype(jnp.int32) \
                if jax.config.jax_enable_x64 else \
                (h // jnp.uint32((1 << 32) // dp)).astype(jnp.int32)
            dest = jnp.minimum(dest, dp - 1)
        dest = jnp.where(hi == E.SENTINEL, jax.lax.axis_index("dp"), dest)
        # order by (dest, hi, lo): sentinels sort to the END of each
        # destination group, so capacity overflow sheds padding first
        # and never drops real k-mers
        dest_s, hi_s, lo_s = jax.lax.sort((dest, hi, lo), num_keys=3)
        pos = jnp.arange(n, dtype=jnp.int32)
        start = jnp.searchsorted(dest_s, jnp.arange(dp, dtype=jnp.int32))
        offset = pos - jnp.take(start, dest_s)
        keep = offset < cap
        # overflow keys get an out-of-bounds slot and are dropped
        slot = jnp.where(keep, dest_s * cap + offset, dp * cap)
        buf_hi = jnp.full((dp * cap,), E.SENTINEL, jnp.uint32)
        buf_lo = jnp.full((dp * cap,), E.SENTINEL, jnp.uint32)
        buf_hi = buf_hi.at[slot].set(hi_s, mode="drop")
        buf_lo = buf_lo.at[slot].set(lo_s, mode="drop")
        n_dropped = jnp.sum(~keep & (hi_s != E.SENTINEL))
        buf_hi = buf_hi.reshape(dp, cap)
        buf_lo = buf_lo.reshape(dp, cap)
        buf_hi = jax.lax.all_to_all(buf_hi, "dp", split_axis=0,
                                    concat_axis=0, tiled=False)
        buf_lo = jax.lax.all_to_all(buf_lo, "dp", split_axis=0,
                                    concat_axis=0, tiled=False)
        rhi = buf_hi.reshape(-1)
        rlo = buf_lo.reshape(-1)
        rhi, rlo = jax.lax.sort((rhi, rlo), num_keys=2)
        return rhi[None, :], rlo[None, :], n_dropped[None]

    return jax.shard_map(
        step, mesh=mesh,
        in_specs=(P("dp", None), P("dp")),
        out_specs=(P("dp", None), P("dp", None), P("dp")),
    )(seqs_u8, lengths)
