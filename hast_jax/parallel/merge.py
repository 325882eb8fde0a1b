"""Cross-shard merge of classify results (mergeResult equivalent).

The reference ships `mergeResult`
(/root/reference/01.classify_stlfr_reads/mergeResult.cpp) to reduce
per-input-file `phased.barcodes` shards — but its AddLine adds BOTH hap
counts into hap 0 (mergeResult.cpp:28-29), so as shipped it mis-merges.
The real specification is classify's own single-run output, which this
module matches exactly: counts re-accumulate per barcode, and the
decision reuses the identical getHap with the marker set sizes and
weights of the original run (so merged output is bit-identical to a
single classify over the concatenated inputs).
"""

from __future__ import annotations

from hast_jax.pipeline.classify import get_hap


def load_phased_counts(path: str, into: dict[bytes, list[int]] | None = None
                       ) -> dict[bytes, list[int]]:
    """Accumulate barcode -> [c0, c1] from a phased.barcodes file."""
    counts = into if into is not None else {}
    with open(path, "rb") as f:
        for line in f:
            cols = line.rstrip(b"\n").split(b"\t")
            if len(cols) < 4:
                continue
            c = counts.setdefault(cols[0], [0, 0])
            c[0] += int(cols[2])
            c[1] += int(cols[3])
    return counts


def merge_phased_files(paths: list[str], out, size0: int, size1: int,
                       w0: float = 1.0, w1: float = 1.0) -> None:
    """Merge shard outputs and re-decide; matches single-run classify.

    size0/size1 must be the post-adaptor-erasure marker set sizes of
    the original runs (classify logs them; or recompute from the mer
    files via hast_jax.pipeline.classify.load_marker_table).
    """
    counts: dict[bytes, list[int]] = {}
    for p in paths:
        load_phased_counts(p, counts)
    for bc in sorted(counts):
        c0, c1 = counts[bc]
        hap = get_hap(bc, c0, c1, size0, size1, w0, w1)
        out.write(b"%s\t%d\t%d\t%d\n" % (bc, hap, c0, c1))
