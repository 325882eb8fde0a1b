"""Env-gated stage-00 soak tests.

The full soak (100 Mb x 30x, 4.8e9 k-mers, on a GPU) runs via
scripts/bench_stage00_soak.py.  This
env-gated test runs the same two-engine parity at a reduced scale so
the 2-sweep partitioned path stays exercised in CI-like runs:

    HAST_RUN_SOAK=1 python -m pytest tests/test_soak.py -q

Without HAST_RUN_SOAK it is skipped (it streams the input 2*(1+P)
times, too slow for the default suite).
"""

import os
import pathlib
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.skipif(
    not os.environ.get("HAST_RUN_SOAK"),
    reason="set HAST_RUN_SOAK=1 to run the soak parity test")


def test_partitioned_equals_resident(tmp_path):
    sys.path.insert(0, str(pathlib.Path(__file__).parents[1] / "scripts"))
    from bench_stage00_soak import write_parent_chunked
    from hast_jax.pipeline import markers as M
    from hast_jax.utils.synthetic import make_trio_genomes

    genome = 2_000_000
    cov = 20.0
    pat_g, mat_g = make_trio_genomes(77, genome, het_rate=0.001)
    pat, mat = tmp_path / "pat.fa", tmp_path / "mat.fa"
    n_reads = int(genome * cov / 100)
    write_parent_chunked(1, np.frombuffer(pat_g, np.uint8), str(pat),
                         n_reads)
    write_parent_chunked(2, np.frombuffer(mat_g, np.uint8), str(mat),
                         n_reads)

    outs = {}
    for tag, n_parts in (("res", 1), ("part", 3)):
        d = tmp_path / tag
        d.mkdir()
        outs[tag] = M.build_unshared_markers(
            [str(pat)], [str(mat)], out_dir=str(d), auto_bounds=True,
            engine="device", n_parts=n_parts)
    for p in ("paternal", "maternal"):
        a = pathlib.Path(outs["res"][p]).read_bytes()
        b = pathlib.Path(outs["part"][p]).read_bytes()
        assert a == b, p
        assert a.count(b"\n") > 0, p
