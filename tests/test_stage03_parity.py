"""Bit-parity of stage 03 against the reference binaries' golden output.

Runs our Split -> classify -> route -> MergePhaseResult -> GenSq on the
same synthetic pseudohap2 assembly and compares every intermediate and
final file byte-for-byte (see scripts/make_golden_stage03.py).
"""

import pathlib

import pytest

from hast_jax.pipeline import rephase as R

GOLD = pathlib.Path(__file__).parent / "golden" / "stage03"

FILES = [
    "output.phb.1.fa", "output.phb.2.fa", "output.homo.fa",
    "phasing.out",
    "output.phb.12.father.idx", "output.phb.12.mother.idx",
    "output.phb.12.ambiguous.idx",
    "output.merge.father.ids", "output.merge.mother.ids",
    "output.merge.homo.ids",
    "output.father.fa", "output.father.idx", "output.supplement.fa",
]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("stage03")
    R.mkoutput(assembly_path=str(GOLD / "assembly"), prefix="output",
               paternal_mer=str(GOLD / "paternal.mer"),
               maternal_mer=str(GOLD / "maternal.mer"),
               prefer="paternal", workdir=str(out))
    return out


@pytest.mark.parametrize("name", FILES)
def test_file_bit_identical(run_dir, name):
    ours = (run_dir / name).read_bytes()
    golden = (GOLD / name).read_bytes()
    assert ours == golden, name


def test_symlinks(run_dir):
    """primary always; secondary when the opposite fa exists
    (mkoutput_by_fabulous2.0.sh:142-152)."""
    primary = run_dir / "output.primary.fa"
    assert primary.is_symlink()
    assert primary.resolve().name == "output.father.fa"
    # prefer=paternal run never wrote mother.fa -> no secondary
    assert not (run_dir / "output.secondary.fa").exists()


def test_secondary_symlink(tmp_path):
    """Re-running with the opposite prefer in the same dir creates the
    conditional secondary symlink like the reference driver."""
    args = dict(assembly_path=str(GOLD / "assembly"), prefix="output",
                paternal_mer=str(GOLD / "paternal.mer"),
                maternal_mer=str(GOLD / "maternal.mer"),
                workdir=str(tmp_path))
    R.mkoutput(prefer="maternal", **args)
    assert not (tmp_path / "output.secondary.fa").exists()
    res = R.mkoutput(prefer="paternal", **args)
    secondary = tmp_path / "output.secondary.fa"
    assert secondary.is_symlink()
    assert secondary.resolve().name == "output.mother.fa"
    assert res["secondary"].endswith("output.secondary.fa")
    # primary was created by the first (maternal) run and is not clobbered
    assert (tmp_path / "output.primary.fa").resolve().name == \
        "output.mother.fa"


def test_classify_segments_fastq_mode():
    import io
    from hast_jax.pipeline.rephase import classify_segments
    out = io.StringIO()
    classify_segments([str(GOLD / "paternal.mer"), str(GOLD / "maternal.mer")],
                      [str(GOLD / "fastq_mode.fq")], out, fmt="fastq")
    assert out.getvalue() == (GOLD / "fastq_mode.out").read_text()


def test_classify_segments_quot_format(tmp_path):
    """Regression: marker sets big enough for build_table to auto-pick
    the "quot" slot format (n_buckets >= 2^13 at k=21) must still hit.
    A full-format probe on quot data returns payload 0 for every key,
    which silently classified every segment as ambiguous 0.0."""
    import io

    import numpy as np

    from hast_jax.ops import encode as E
    from hast_jax.ops import kmer_count as KC

    rng = np.random.default_rng(7)
    K = 21
    seqs = rng.integers(0, 4, size=(50000, K), dtype=np.int32)
    hi, lo = E.canonical_kmers_np(seqs, K)
    words = np.unique(
        (hi[:, 0].astype(np.uint64) << np.uint64(32)) | lo[:, 0])
    rng.shuffle(words)
    n = 20000
    s0 = KC.words_to_strings(words[:n], K)
    s1 = KC.words_to_strings(words[n:2 * n], K)
    p0, p1 = tmp_path / "hap0.mer", tmp_path / "hap1.mer"
    p0.write_bytes(b"\n".join(s0.tolist()) + b"\n")
    p1.write_bytes(b"\n".join(s1.tolist()) + b"\n")

    table = R._build_segment_table([str(p0), str(p1)])
    assert table.fmt == "quot", \
        "fixture must trigger quot auto-selection to cover the bug"

    fa = tmp_path / "seg.fa"
    fa.write_bytes(b">1_1_1\n" + b"".join(s0[:50].tolist()) + b"\n")
    out = io.StringIO()
    R.classify_segments([str(p0), str(p1)], [str(fa)], out)
    line = out.getvalue().strip()
    name, verdict, weight = line.split("\t")
    assert verdict == "haplotype0", line
    assert float(weight) >= 50 / n


def test_segment_stream_incremental_and_equal():
    """classify_segments streams record chunks (constant memory like the
    reference's 10000/3000 watermark pool): the stream must yield before
    the input is exhausted AND produce byte-identical hit counts."""
    import numpy as np

    table = R._build_segment_table([str(GOLD / "paternal.mer"),
                                    str(GOLD / "maternal.mer")])
    rng = np.random.default_rng(3)
    B = np.frombuffer(b"ACGT", np.uint8)
    seqs = [B[rng.integers(0, 4, 9000)].tobytes() for _ in range(12)]

    consumed = []

    def gen():
        for i, s in enumerate(seqs):
            consumed.append(i)
            yield (b"%d_1_1" % i, s)

    stream = R._segment_hits_stream(table, gen(), target_pieces=4)
    names0, hits0 = next(stream)
    assert len(consumed) < len(seqs), "stream held the whole input"

    chunks = [hits0] + [h for _, h in stream]
    whole = R._segment_hits_batch(table, seqs)
    np.testing.assert_array_equal(np.concatenate(chunks), whole)


def test_mkoutput_symlinks_with_directory_prefix(tmp_path):
    """Symlink targets must be basenamed: with prefix 'sub/hap' a raw
    target 'sub/hap.father.fa' would resolve to 'sub/sub/...' and
    dangle (links resolve relative to the link's own directory)."""
    import os
    sub = tmp_path / "sub"
    sub.mkdir()
    fa = sub / "hap.father.fa"
    fa.write_text(">s\nACGT\n")
    # simulate what mkoutput does for the primary link
    primary = str(sub / "hap.primary.fa")
    os.symlink(os.path.basename(str(fa)), primary)
    assert os.path.exists(primary)  # resolves (would fail if dangling)
    assert open(primary).read().startswith(">s")
