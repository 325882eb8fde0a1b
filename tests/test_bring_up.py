"""CPU checks of what the GPU bring-up rests on: the numpy reference,
chip_smoke.py's phases at a tiny size, the compile-cache location,
choose_tp's memory budget and the native library build."""

import json
import os
import pathlib
import subprocess

import jax
import pytest

import chip_smoke
from hast_jax import reference as R
from hast_jax.io import native as N
from hast_jax.parallel.mesh import choose_tp
from hast_jax.utils import compile_cache as CC

GOLD = pathlib.Path(__file__).parent / "golden"
S1 = GOLD / "stage01"
E2E = GOLD / "e2e"


@pytest.mark.parametrize("hap0,hap1,reads,golden", [
    (S1 / "hap0.mer", S1 / "hap1.mer",
     [S1 / "reads1.fq.gz", S1 / "reads2.fq"], S1 / "phased.barcodes.golden"),
    (S1 / "edge.hap0.mer", S1 / "edge.hap1.mer", [S1 / "edge.fq"],
     S1 / "edge.phased.golden"),
    (S1 / "k15.hap0.mer", S1 / "k15.hap1.mer", [S1 / "k15.fq"],
     S1 / "k15.phased.golden"),
    (S1 / "k31.hap0.mer", S1 / "k31.hap1.mer", [S1 / "k31.fq"],
     S1 / "k31.phased.golden"),
    (E2E / "paternal.unique.filter.mer", E2E / "maternal.unique.filter.mer",
     [E2E / "son.r1.fq.gz", E2E / "son.r2.fq"],
     E2E / "stage01" / "phased.barcodes"),
], ids=["stage01", "edge", "k15", "k31", "e2e"])
def test_reference_classify_matches_golden(hap0, hap1, reads, golden):
    got = R.classify(str(hap0), str(hap1), [str(r) for r in reads], w0=1.04)
    assert got == golden.read_bytes()


def test_reference_canonical_words_match_generator():
    """chip_smoke's word generator and the reference agree on which
    strand is canonical."""
    import numpy as np
    rng = np.random.default_rng(0)
    w = rng.integers(0, 1 << 42, 1000, dtype=np.uint64)
    canon = np.minimum(w, chip_smoke._revcomp_words(w, 21))
    text = chip_smoke._words_to_ascii(canon, 21)
    assert (R.canonical_words(text, 21)[:, 0] == canon).all()


@pytest.mark.parametrize("argv", [["--seed", "3"], ["--four"]],
                         ids=["one_device", "four"])
def test_chip_smoke_rehearses_on_cpu(argv, tmp_path, capsys):
    chip_smoke.main(argv, sizes=chip_smoke.TINY, require_gpu=False,
                    work=str(tmp_path / "work"))
    last = capsys.readouterr().out.strip().splitlines()[-1]
    result = json.loads(last)
    assert result["ok"] is True
    assert result["device"] == {"platform": jax.devices()[0].platform,
                                "kind": jax.devices()[0].device_kind,
                                "count": len(jax.devices())}
    assert not (tmp_path / "work").exists()


def test_chip_smoke_refuses_without_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert CC.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = CC.enable_compile_cache()
        assert path == str(pathlib.Path(__file__).parents[1] / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("table_bytes,n_devices,budget,want", [
    (1 << 30, 4, 2 << 30, 1),
    (4 << 30, 4, 1 << 30, 4),
    (3 << 30, 8, 1 << 30, 4),
    (64 << 30, 2, 1 << 30, 2),
])
def test_choose_tp_with_budget(table_bytes, n_devices, budget, want):
    assert choose_tp(table_bytes, n_devices, budget) == want


def test_choose_tp_needs_budget_without_bytes_limit():
    if "bytes_limit" in (jax.devices()[0].memory_stats() or {}):
        pytest.skip("this device reports a bytes_limit")
    with pytest.raises(ValueError, match="bytes_limit"):
        choose_tp(1 << 30, 4)


def test_native_library_is_built_from_source():
    N.get_lib()
    native = pathlib.Path(N.__file__).parents[2] / "native"
    up_to_date = subprocess.run(["make", "-q", "-C", str(native)])
    assert up_to_date.returncode == 0
    assert os.path.getmtime(native / "libhastio.so") >= \
        os.path.getmtime(native / "hastio.cpp")
