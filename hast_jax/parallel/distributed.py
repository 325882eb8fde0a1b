"""Multi-host bring-up and distributed stage-00 counting.

The reference's only "cluster" interface is the filesystem plus a user
manually running shards (SURVEY.md §5).  Here: `initialize()` wires
`jax.distributed` (ICI within a slice, DCN across hosts), and
`count_files_sharded` runs stage-00 counting over a device mesh — each
host streams its own input shard, canonical k-mers route to their
hash-range owner via all_to_all, and per-device sorted runs reduce into
one CountTable (meryl's shard -> count -> union-sum over the fabric).
"""

from __future__ import annotations

import os
from typing import Sequence

import jax
import numpy as np

from hast_jax.io import fastq as FQ
from hast_jax.ops import kmer_count as KC
from hast_jax.parallel import mesh as PM


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """jax.distributed bring-up with env fallbacks (no-op if single)."""
    coordinator_address = coordinator_address or os.environ.get(
        "HAST_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("HAST_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("HAST_PROCESS_ID", "0"))
    if num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)


def shard_paths(paths: Sequence[str]) -> list[str]:
    """Static input-file sharding across hosts (round-robin)."""
    n = jax.process_count()
    i = jax.process_index()
    return [p for j, p in enumerate(paths) if j % n == i]


def count_files_sharded(mesh, paths: Sequence[str], k: int,
                        batch_size: int = FQ.DEFAULT_BATCH) -> KC.CountTable:
    """Device-mesh k-mer counting (config 5 in BASELINE.json).

    Reads stream host-side in dp-sized slabs; the device step extracts,
    hash-routes (all_to_all over dp) and sorts; hosts RLE their local
    shard rows and union-sum at the end.  On a multi-host mesh each
    host only materializes its own devices' rows.

    Capacity overflow (a batch whose k-mers land too unevenly across
    hash ranges for the fixed all_to_all slots) is handled by retrying
    the batch split in halves — each half has twice the per-destination
    slack — rather than failing the whole count after the fact.
    """
    dp = mesh.shape["dp"]
    counter = KC.Counter(k)
    for path in paths:
        for batch in FQ.sequence_batches(path, k, batch_size):
            _count_batch_sharded(mesh, dp, counter, batch.seqs,
                                 batch.lengths, k)
    return counter.finalize()


def _count_batch_sharded(mesh, dp, counter, seqs, lengths, k,
                         depth: int = 0) -> None:
    import jax.numpy as jnp
    b = seqs.shape[0]
    rows = (b // dp) * dp
    if rows:
        rhi, rlo, dropped = PM.sharded_count_chunk(
            mesh, jnp.asarray(seqs[:rows]), jnp.asarray(lengths[:rows]), k)
        if int(np.asarray(dropped).sum()):
            # skewed hash split: halve the batch (doubles slack) and retry
            if depth >= 6 or rows <= dp:
                raise RuntimeError(
                    "k-mers dropped by all_to_all capacity even at "
                    f"batch of {rows} reads; pathological hash skew")
            half = ((rows // 2) // dp) * dp or dp
            _count_batch_sharded(mesh, dp, counter, seqs[:half],
                                 lengths[:half], k, depth + 1)
            _count_batch_sharded(mesh, dp, counter, seqs[half:rows],
                                 lengths[half:rows], k, depth + 1)
        else:
            rhi = np.asarray(rhi)
            rlo = np.asarray(rlo)
            for d in range(rhi.shape[0]):
                counter.add_sorted_chunk(rhi[d], rlo[d])
    # leftover rows (batch not divisible by dp) count host-side
    if rows < b:
        t = KC.count_batches([type("B", (), dict(
            seqs=seqs[rows:], lengths=lengths[rows:]))()], k)
        counter.add_table(t)


# ---------------------------------------------------------------------------
# multi-host (DCN) drivers
# ---------------------------------------------------------------------------
#
# The reference's scale-out story is shard-by-input-file plus an offline
# counter reduce (mergeResult.cpp:116-129; meryl.sh union-sum).  The
# device formulation keeps that shape because it is the RIGHT shape
# for a streaming, IO-bound reduction with a commutative merge:
#
#   * each host classifies/counts its own file shard on its OWN
#     addressable devices (tp-sharding the marker table across local
#     devices when it exceeds one chip's HBM) — no per-batch global
#     collective, so hosts never stall on the slowest reader and the
#     streaming path is identical to the single-host one;
#   * ONE cross-host reduce at the end over DCN
#     (multihost_utils.process_allgather of the per-host name/count
#     tables), after which every process holds the identical global
#     tally and process 0 emits the canonical output.
#
# A per-batch global dp mesh would force all hosts to step in lockstep
# over DCN for a reduction that is commutative anyway — strictly worse.
# Stage-00 counting at human scale (distinct set > one host) is the one
# case that needs a global shuffle; count_files_sharded runs hash-range
# all_to_all over whatever mesh it is given (ICI within a slice), and
# its host-side union-sum reduce composes with the same DCN allgather.


def _allgather_u8(arr: np.ndarray) -> list[np.ndarray]:
    """Allgather a per-process variable-length uint8 array over DCN."""
    from jax.experimental import multihost_utils as mh
    arr = np.ascontiguousarray(arr, np.uint8)
    sizes = np.asarray(mh.process_allgather(
        np.asarray(arr.size, np.int64))).reshape(-1)
    m = max(1, int(sizes.max()))
    buf = np.zeros(m, np.uint8)
    buf[:arr.size] = arr
    gathered = np.asarray(mh.process_allgather(buf))
    return [gathered[i, :int(sizes[i])] for i in range(sizes.size)]


def allgather_tally(tally) -> None:
    """Fold every process's BarcodeTally into every process (in place).

    The DCN analog of mergeResult's offline shard reduce — one
    allgather of (names, counts) at end-of-stream.  No-op when
    single-process.
    """
    if jax.process_count() == 1:
        return
    names, counts = tally.finalize()
    width = names.dtype.itemsize if names.size else 1
    header = np.asarray([names.size, width], np.int64).view(np.uint8)
    payload = np.concatenate([
        header, names.view(np.uint8).reshape(-1),
        np.ascontiguousarray(counts, np.int64).view(np.uint8).reshape(-1)])
    me = jax.process_index()
    for i, buf in enumerate(_allgather_u8(payload)):
        if i == me:
            continue
        n, w = (int(x) for x in buf[:16].view(np.int64))
        rnames = buf[16:16 + n * w].copy().view(f"S{w}")
        # copy before the int64 view: the slice offset may be unaligned
        rcounts = np.frombuffer(
            buf[16 + n * w:16 + n * w + n * 24].tobytes(),
            np.int64).reshape(n, 3)
        tally.merge_names(rnames, rcounts)


def allgather_count_table(table: KC.CountTable) -> KC.CountTable:
    """Union-sum every process's CountTable across DCN (meryl union-sum
    over the cluster).  Identity when single-process."""
    if jax.process_count() == 1:
        return table
    me = jax.process_index()
    payload = np.concatenate([
        np.asarray([table.words.size], np.int64).view(np.uint8),
        table.words.view(np.uint8).reshape(-1),
        np.ascontiguousarray(table.counts, np.int64).view(np.uint8).reshape(-1),
    ])
    counter = KC.Counter(table.k)
    counter.add_table(table)
    for i, buf in enumerate(_allgather_u8(payload)):
        if i == me:
            continue
        n = int(buf[:8].view(np.int64)[0])
        words = buf[8:8 + n * 8].view(np.uint64).copy()
        counts = buf[8 + n * 8:8 + n * 16].view(np.int64).copy()
        counter.add_table(KC.CountTable(words, counts, table.k))
    return counter.finalize()


def count_files_mesh_device(mesh, paths: Sequence[str], k: int,
                            batch_size: int = FQ.DEFAULT_BATCH,
                            check_lag: int = 4) -> PM.MeshCountTable:
    """Mesh-resident stage-00 counting: hash-range shards stay in each
    device's HBM (resident run = distinct/dp per chip); nothing but
    all_to_all routing crosses ICI and nothing crosses to the host.

    Capacity overflow (a batch whose k-mers land too unevenly for the
    fixed all_to_all slots, 2x slack) recovers per batch: a chunk is
    folded into the counter only after its drop-count scalar (checked
    ``check_lag`` batches later, by which point the device has long
    finished it — no hot-path sync) reads zero; an overflowed batch is
    re-dispatched whole with doubled slack until cap >= n, at which
    point a drop is impossible.  A skewed batch therefore costs one
    retry, not the entire streamed input."""
    import jax.numpy as jnp
    dp = mesh.shape["dp"]
    ctr = PM.MeshDeviceCounter(mesh, k)
    pending: list = []   # (dropped, seqs, lengths, rhi, rlo)

    def dispatch(seqs, lengths, slack):
        return PM.sharded_count_chunk(
            mesh, jnp.asarray(seqs), jnp.asarray(lengths), k, slack)

    def settle(entry):
        dropped, seqs, lengths, rhi, rlo = entry
        slack = 2
        while int(np.asarray(dropped).sum()):
            if slack >= dp:   # cap was >= n: a drop cannot happen
                raise AssertionError(
                    "k-mers dropped at full per-destination capacity")
            slack = min(2 * slack, dp)
            print(f"  [mesh count] all_to_all overflow: retrying batch "
                  f"with slack={slack}", file=__import__("sys").stderr)
            rhi, rlo, dropped = dispatch(seqs, lengths, slack)
        ctr.add_chunk(rhi, rlo)

    for path in paths:
        for batch in FQ.sequence_batches(path, k, batch_size):
            seqs, lengths = batch.seqs, batch.lengths
            b = seqs.shape[0]
            if b % dp:
                pad = dp - b % dp
                seqs = np.concatenate(
                    [seqs, np.zeros((pad, seqs.shape[1]), np.uint8)])
                lengths = np.concatenate(
                    [lengths, np.zeros(pad, np.int32)])
            rhi, rlo, dropped = dispatch(seqs, lengths, 2)
            pending.append((dropped, seqs, lengths, rhi, rlo))
            if len(pending) > check_lag:
                settle(pending.pop(0))
    for entry in pending:
        settle(entry)
    return ctr.finalize_mesh()


def build_unshared_markers_mesh(
        mesh, paternal: Sequence[str], maternal: Sequence[str],
        out_dir: str = ".", k: int = 21, auto_bounds: bool = False,
        p_lower: int = 9, p_upper: int = 33,
        m_lower: int = 9, m_upper: int = 33,
        batch_size: int = FQ.DEFAULT_BATCH, log=None) -> dict[str, str]:
    """Multi-chip device-resident stage 00 (SURVEY §2.8's meryl 64-way
    sharded DB, on ICI): both parents' count tables live hash-range-
    sharded across the mesh, the global histogram psums over dp, the
    unique∩filter algebra runs per shard with no communication (both
    parents share the routing), and only final markers reach the host.
    Produces the same histo/bounds/.mer artifacts as the single-chip
    engines, byte-for-byte.

    Single-controller meshes only (one process addressing every chip,
    e.g. one host with four GPUs): the marker fetch reads each shard's rows,
    which multi-controller jax cannot address across processes.
    Across HOSTS, shard the input files instead (count_files_multihost
    + the DCN union-sum), or give each host its own mesh build over a
    key-range split."""
    import sys

    from hast_jax.pipeline.markers import (_dump_words, _rows_from_hist,
                                           find_bounds, write_bounds,
                                           write_histo)
    log = log or sys.stderr
    j = lambda name: os.path.join(out_dir, name)
    print("extract unique mers (mesh-sharded device count tables) ...",
          file=log)
    mat = count_files_mesh_device(mesh, maternal, k, batch_size)
    pat = count_files_mesh_device(mesh, paternal, k, batch_size)
    print(f"  maternal: {mat.n_distinct} distinct / {mat.total} total "
          f"{k}-mers", file=log)
    print(f"  paternal: {pat.n_distinct} distinct / {pat.total} total "
          f"{k}-mers", file=log)
    m_rows = _rows_from_hist(mat.histo())
    p_rows = _rows_from_hist(pat.histo())
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
    p_words, m_words = PM.mesh_marker_algebra(
        pat, mat, p_lower, p_upper, m_lower, m_upper)
    paths = {
        "paternal": j("paternal.unique.filter.mer"),
        "maternal": j("maternal.unique.filter.mer"),
    }
    n_p = _dump_words(p_words, k, paths["paternal"])
    n_m = _dump_words(m_words, k, paths["maternal"])
    print(f"final paternal unique kmer is : {n_p}", file=log)
    print(f"final maternal unique kmer is : {n_m}", file=log)
    return paths


def local_mesh(tp: int = 1):
    """dp×tp mesh over THIS process's addressable devices."""
    return PM.make_mesh(devices=jax.local_devices(), tp=tp)


def classify_fastqs_multihost(table, paths: Sequence[str],
                              batch_size: int = FQ.DEFAULT_BATCH,
                              tp: int = 1):
    """Multi-host stage-01 classify: file shards over hosts, table
    replicated (tp=1) or tp-sharded across local devices, one DCN
    reduce at the end.  Every process returns the identical global
    tally; process 0 is the canonical writer.

    Single-process this is exactly classify_fastqs (+ a no-op reduce),
    so the same driver serves 1..N hosts.
    """
    from hast_jax.pipeline import classify as C

    local = shard_paths(list(paths))
    if tp > 1:
        tally = C.classify_fastqs_mesh(local_mesh(tp), table, local,
                                       batch_size=batch_size) \
            if local else C.BarcodeTally()
    else:
        tally = C.classify_fastqs(table, local, batch_size=batch_size) \
            if local else C.BarcodeTally()
    allgather_tally(tally)
    return tally


def count_files_multihost(paths: Sequence[str], k: int,
                          batch_size: int = FQ.DEFAULT_BATCH,
                          use_mesh: bool = False) -> KC.CountTable:
    """Multi-host stage-00 counting: per-host shard count (optionally
    hash-range sharded over the host's local devices), DCN union-sum.
    Identical tables on every process."""
    from hast_jax.pipeline import markers as M

    local = shard_paths(list(paths))
    if use_mesh and len(jax.local_devices()) > 1:
        table = count_files_sharded(local_mesh(), local, k, batch_size) \
            if local else KC.CountTable(
                np.zeros(0, np.uint64), np.zeros(0, np.int64), k)
    else:
        table = M.count_files(local, k, batch_size) if local else \
            KC.CountTable(np.zeros(0, np.uint64), np.zeros(0, np.int64), k)
    return allgather_count_table(table)
