"""Real 2-process jax.distributed tests over the CPU backend.

The reference scales out by users manually running file shards and
reducing with mergeResult (mergeResult.cpp:116-129); these tests pin
the framework's automated equivalent: two OS processes bring up
jax.distributed, classify/count their own shards, reduce over the
coordination service, and the merged result is byte-identical to the
single-process golden.
"""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = pathlib.Path(__file__).parent
GOLD = HERE / "golden" / "stage01"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(mode: str, outdir: str, nprocs: int = 2,
                 timeout: float = 240.0, devices_per_proc: int = 1):
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count={devices_per_proc}"
    env["PYTHONPATH"] = str(HERE.parent) + os.pathsep + \
        env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(HERE / "multihost_worker.py"), mode,
             coordinator, str(nprocs), str(pid), outdir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(nprocs)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    return outs


@pytest.mark.slow
def test_two_process_classify_bit_identical(tmp_path):
    _run_workers("classify", str(tmp_path))
    merged = (tmp_path / "phased.merged").read_bytes()
    golden = (GOLD / "phased.barcodes.golden").read_bytes()
    assert merged == golden


@pytest.mark.slow
def test_two_process_count_matches_single(tmp_path):
    _run_workers("count", str(tmp_path))
    z = np.load(tmp_path / "count.npz")
    from hast_jax.pipeline import markers as M
    e2e = HERE / "golden" / "e2e"
    want = M.count_files([str(e2e / "paternal.fa.gz"),
                          str(e2e / "maternal.fa.gz")], 21, batch_size=4096)
    np.testing.assert_array_equal(z["words"], want.words)
    np.testing.assert_array_equal(z["counts"], want.counts)


@pytest.mark.slow
def test_two_process_classify_tp2_bit_identical(tmp_path):
    """2 processes × 4 fake devices, marker table tp=2-sharded per
    process."""
    _run_workers("classify_tp2", str(tmp_path), devices_per_proc=4)
    merged = (tmp_path / "phased.merged").read_bytes()
    golden = (GOLD / "phased.barcodes.golden").read_bytes()
    assert merged == golden


@pytest.mark.slow
def test_two_process_count_mesh_matches_single(tmp_path):
    """2-process stage 00 with per-host device-mesh hash-range sharding
    (count_files_multihost(use_mesh=True)) == the single-process table."""
    _run_workers("count_mesh", str(tmp_path), devices_per_proc=4)
    z = np.load(tmp_path / "count.npz")
    from hast_jax.pipeline import markers as M
    e2e = HERE / "golden" / "e2e"
    want = M.count_files([str(e2e / "paternal.fa.gz"),
                          str(e2e / "maternal.fa.gz")], 21, batch_size=4096)
    np.testing.assert_array_equal(z["words"], want.words)
    np.testing.assert_array_equal(z["counts"], want.counts)
