"""Subprocess worker for the 2-process DCN tests (test_multihost.py).

Runs one jax.distributed process on CPU: classifies its file shard of
the stage-01 golden reads, reduces tallies over the coordination
service, and (process 0) writes the merged phased.barcodes.  A second
mode does the same for stage-00 counting.

Invoked as:
  python tests/multihost_worker.py <mode> <coordinator> <nprocs> <pid> \
      <outdir>
"""

import os
import sys


def main():
    mode, coordinator, nprocs, pid, outdir = sys.argv[1:6]
    nprocs, pid = int(nprocs), int(pid)

    # distributed.initialize must run before ANYTHING touches the XLA
    # backend — importing hast_jax is safe, but do it after anyway
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=nprocs, process_id=pid)
    from hast_jax.parallel import distributed as D
    assert jax.process_count() == nprocs, jax.process_count()

    gold = os.path.join(os.path.dirname(__file__), "golden", "stage01")
    if mode == "classify":
        from hast_jax.pipeline import classify as C
        table = C.load_marker_table(os.path.join(gold, "hap0.mer"),
                                    os.path.join(gold, "hap1.mer"))
        C.erase_adaptors(table)
        paths = [os.path.join(gold, "reads1.fq.gz"),
                 os.path.join(gold, "reads2.fq")]
        tally = D.classify_fastqs_multihost(table, paths, batch_size=4096)
        if pid == 0:
            with open(os.path.join(outdir, "phased.merged"), "wb") as out:
                C.write_phased_barcodes(tally, table, out, w0=1.04)
    elif mode == "classify_tp2":
        # the tp>1 multihost path — 2 processes × 4
        # local fake devices, marker table tp=2-sharded per process
        from hast_jax.pipeline import classify as C
        assert len(jax.local_devices()) >= 4, jax.local_devices()
        table = C.load_marker_table(os.path.join(gold, "hap0.mer"),
                                    os.path.join(gold, "hap1.mer"))
        C.erase_adaptors(table)
        paths = [os.path.join(gold, "reads1.fq.gz"),
                 os.path.join(gold, "reads2.fq")]
        tally = D.classify_fastqs_multihost(table, paths, batch_size=4096,
                                            tp=2)
        if pid == 0:
            with open(os.path.join(outdir, "phased.merged"), "wb") as out:
                C.write_phased_barcodes(tally, table, out, w0=1.04)
    elif mode in ("count", "count_mesh"):
        e2e = os.path.join(os.path.dirname(__file__), "golden", "e2e")
        paths = [os.path.join(e2e, "paternal.fa.gz"),
                 os.path.join(e2e, "maternal.fa.gz")]
        table = D.count_files_multihost(paths, 21, batch_size=4096,
                                        use_mesh=(mode == "count_mesh"))
        if pid == 0:
            import numpy as np
            np.savez(os.path.join(outdir, "count.npz"),
                     words=table.words, counts=table.counts)
    else:
        raise SystemExit(f"unknown mode {mode}")
    print(f"worker {pid} ok", flush=True)


if __name__ == "__main__":
    main()
