"""ctypes binding for the native hastio reader.

The library is built from ``native/hastio.cpp`` by ``make -C native`` on
first use in each process; make's dependency rule rebuilds a stale
``libhastio.so``.  A library that cannot be built or loaded is an error.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from typing import Iterator

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libhastio.so")

_lib = None


def _build() -> None:
    """Run ``make -C native`` under a file lock, so that concurrent
    processes (test workers) do not race on the same output."""
    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        r = subprocess.run(["make", "-C", _NATIVE_DIR], capture_output=True,
                           text=True)
    if r.returncode:
        raise RuntimeError(f"building libhastio.so failed:\n{r.stderr}")


def get_lib():
    """Build (if stale) and load libhastio.so; raises if either fails."""
    global _lib
    if _lib is not None:
        return _lib
    _build()
    lib = ctypes.CDLL(_LIB_PATH)
    lib.hastio_open.restype = ctypes.c_void_p
    lib.hastio_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int]
    lib.hastio_open_packed.restype = ctypes.c_void_p
    lib.hastio_open_packed.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int]
    lib.hastio_next_batch.restype = ctypes.c_long
    lib.hastio_next_batch.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.POINTER(ctypes.c_int32)]
    lib.hastio_num_barcodes.restype = ctypes.c_long
    lib.hastio_num_barcodes.argtypes = [ctypes.c_void_p]
    lib.hastio_get_barcodes.restype = ctypes.c_long
    lib.hastio_get_barcodes.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_long]
    lib.hastio_close.argtypes = [ctypes.c_void_p]
    lib.hastio_max_barcode_len.restype = ctypes.c_long
    lib.hastio_max_barcode_len.argtypes = [ctypes.c_void_p]
    lib.hastio_get_barcodes_fixed.restype = ctypes.c_long
    lib.hastio_get_barcodes_fixed.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_int]
    lib.hastio_truncated.restype = ctypes.c_long
    lib.hastio_truncated.argtypes = [ctypes.c_void_p]
    lib.hastio_open_count.restype = ctypes.c_void_p
    lib.hastio_open_count.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int]
    lib.hastio_next_batch_count.restype = ctypes.c_long
    lib.hastio_next_batch_count.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.POINTER(ctypes.c_int32)]
    lib.hastio_bad_fasta.restype = ctypes.c_long
    lib.hastio_bad_fasta.argtypes = [ctypes.c_void_p]
    lib.hastio_place2.restype = ctypes.c_longlong
    lib.hastio_place2.argtypes = [
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_ulonglong,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")]
    lib.hastio_sort_dedup_or.restype = ctypes.c_longlong
    lib.hastio_sort_dedup_or.argtypes = [
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        ctypes.c_longlong]
    lib.hastio_build_quot.restype = ctypes.c_longlong
    lib.hastio_build_quot.argtypes = [
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_ulonglong,
        np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")]
    lib.hastio_quarter.restype = ctypes.c_int
    lib.hastio_quarter.argtypes = [ctypes.c_char_p] * 6 + [
        ctypes.POINTER(ctypes.c_long)]
    lib.hastio_sort_fixed.restype = ctypes.c_long
    lib.hastio_sort_fixed.argtypes = [
        np.ctypeslib.ndpointer(dtype=None, flags="C_CONTIGUOUS"),
        ctypes.c_long, ctypes.c_int,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")]
    lib.hastio_decide_format.restype = ctypes.c_long
    lib.hastio_decide_format.argtypes = [
        np.ctypeslib.ndpointer(dtype=None, flags="C_CONTIGUOUS"),
        ctypes.c_long, ctypes.c_int,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_long]
    _lib = lib
    return _lib


def argsort_fixed(keys_s: np.ndarray) -> np.ndarray | None:
    """Multithreaded bytewise argsort of an S-dtype array (width<=16);
    same order as np.argsort(kind='stable').  None for wider keys."""
    lib = get_lib()
    w = keys_s.dtype.itemsize
    if w > 16:
        return None
    order = np.empty(keys_s.shape[0], np.int64)
    got = lib.hastio_sort_fixed(np.ascontiguousarray(keys_s),
                                keys_s.shape[0], w, order)
    if got != keys_s.shape[0]:
        return None
    return order


def place2(b1: np.ndarray, b2: np.ndarray, n_buckets: int,
           bucket: int, seed: int):
    """Native greedy 2-choice placement + cuckoo walk.

    Returns (row int64, slot int64) on success, the string "failed"
    when some keys could not be placed (caller doubles the table, same
    contract as the numpy path returning None), or None when the
    native pass declines the input (caller falls back to numpy).
    """
    lib = get_lib()
    n = b1.shape[0]
    row = np.empty(n, np.int64)
    slot = np.empty(n, np.int8)
    failed = lib.hastio_place2(
        np.ascontiguousarray(b1, np.uint32),
        np.ascontiguousarray(b2, np.uint32),
        n, n_buckets, bucket, seed, row, slot)
    if failed < 0:
        return None
    if failed > 0:
        return "failed"
    return row, slot.astype(np.int64)


def sort_dedup_or(hi: np.ndarray, lo: np.ndarray, pay: np.ndarray):
    """In-place key sort + duplicate-payload OR; returns the distinct
    count m (arrays' first m entries are the result) or None."""
    lib = get_lib()
    m = lib.hastio_sort_dedup_or(hi, lo, pay, hi.shape[0])
    return None if m < 0 else int(m)


def build_quot(hi: np.ndarray, lo: np.ndarray, pay: np.ndarray,
               k: int, bbits: int, seed: int):
    """Fused native quot-table build; returns the filled
    (n_buckets, 4) uint32 data, "failed" when placement needs a bigger
    table, or None when the native build declines the input."""
    lib = get_lib()
    data = np.zeros(((1 << bbits), 4), np.uint32)
    rc = lib.hastio_build_quot(hi, lo, pay, hi.shape[0], k, bbits,
                               seed, data.reshape(-1))
    if rc == 0:
        return data
    if rc > 0:
        return "failed"
    return None


def decide_format_phased(bcs_s: np.ndarray, order: np.ndarray,
                         c0: np.ndarray, c1: np.ndarray,
                         size0: int, size1: int,
                         w0: float, w1: float) -> bytes | None:
    """Sort-order emit of phased.barcodes with the getHap decision done
    natively (double math identical to pipeline.classify.decide_haps).
    None if the output buffer estimate was too small."""
    lib = get_lib()
    n = bcs_s.shape[0]
    w = bcs_s.dtype.itemsize
    cap = n * (w + 3 * 21 + 4) + 16
    out = np.empty(cap, np.uint8)
    got = lib.hastio_decide_format(
        np.ascontiguousarray(bcs_s), n, w,
        np.ascontiguousarray(order, np.int64),
        np.ascontiguousarray(c0, np.int64),
        np.ascontiguousarray(c1, np.int64),
        float(size0), float(size1), float(w0), float(w1), out, cap)
    if got < 0:
        return None
    return out[:got].tobytes()


class NativeBatch:
    """View over one packed batch from the native reader."""

    __slots__ = ("seqs", "lengths", "has_n", "barcode_ids", "n")

    def __init__(self, seqs, lengths, has_n, barcode_ids, n):
        self.seqs = seqs
        self.lengths = lengths
        self.has_n = has_n
        self.barcode_ids = barcode_ids
        self.n = n


class NativeFastqReader:
    """Iterate batches; barcode strings available after drain.

    With packed=True the seqs rows are 2-bit packed (4 bases/byte,
    identical to ops/encode.pack_codes_np) with stride max_len/4 —
    the pack runs on the C++ prefetch thread, off the GIL.
    """

    def __init__(self, path: str, batch_size: int = 1 << 16,
                 len_cap: int = 1024, fastq: bool = True,
                 packed: bool = False):
        lib = get_lib()
        self._lib = lib
        self._h = lib.hastio_open_packed(path.encode(), batch_size,
                                         len_cap, 1 if fastq else 0,
                                         1 if packed else 0)
        if not self._h:
            raise FileNotFoundError(path)
        self._bs = batch_size
        # scratch covers the staging stride (round-128 of len_cap);
        # emitted batch strides are rounded to 16 bases
        self._cap = ((len_cap + 127) // 128) * 128
        self._packed = packed

    def __iter__(self) -> Iterator[NativeBatch]:
        lib, h, bs = self._lib, self._h, self._bs
        # one reusable cap-sized buffer; each batch yields a compact
        # copy of the used (bs, stride) region so large len_caps don't
        # cost a full-cap allocation per batch
        scratch = np.empty(bs * self._cap, np.uint8)
        div = 4 if self._packed else 1
        while True:
            lengths = np.empty(bs, np.int32)
            has_n = np.empty(bs, np.uint8)
            bids = np.empty(bs, np.int32)
            max_len = ctypes.c_int32()
            n = lib.hastio_next_batch(h, scratch, lengths, has_n, bids,
                                      ctypes.byref(max_len))
            if n <= 0:
                return
            if lib.hastio_truncated(h):
                raise RuntimeError(
                    "reads longer than len_cap encountered; rerun with a "
                    "larger len_cap or engine='python'")
            stride = max_len.value // div
            yield NativeBatch(
                scratch[:bs * stride].reshape(bs, stride).copy(),
                lengths, has_n.astype(bool), bids, int(n))

    def barcodes_array(self) -> np.ndarray:
        """Barcodes in id order as a numpy S-array (no python objects).

        ~10x cheaper than :meth:`barcodes` at millions of barcodes —
        the vectorized tally/merge/sort path consumes this directly.
        """
        width = max(1, int(self._lib.hastio_max_barcode_len(self._h)))
        n = int(self._lib.hastio_num_barcodes(self._h))
        buf = np.zeros(n * width, np.uint8)
        got = self._lib.hastio_get_barcodes_fixed(
            self._h, buf.ctypes.data_as(ctypes.c_char_p), buf.size, width)
        assert got == n, (got, n)
        return buf.view(f"S{width}")

    def barcodes(self) -> list[bytes]:
        need = self._lib.hastio_get_barcodes(self._h, None, 0)
        buf = ctypes.create_string_buffer(int(need))
        got = self._lib.hastio_get_barcodes(self._h, buf, need)
        assert got == need, (got, need)
        raw = buf.raw[:got]
        return raw.split(b"\n")[:-1] if raw else []

    def close(self):
        if self._h:
            self._lib.hastio_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def native_quarter(fastq_path: str, prefix: str, pat_list: str,
                   mat_list: str, homo_list: str,
                   log_path: str) -> dict[str, int] | None:
    """C++ quartering; returns the read-count stats dict."""
    lib = get_lib()
    stats = (ctypes.c_long * 6)()
    rc = lib.hastio_quarter(fastq_path.encode(), prefix.encode(),
                            pat_list.encode(), mat_list.encode(),
                            homo_list.encode(), log_path.encode(), stats)
    if rc != 0:
        raise RuntimeError(f"hastio_quarter failed with code {rc}")
    return dict(total=stats[0], no_reads=stats[1], pa_reads=stats[2],
                ma_reads=stats[3], ho_reads=stats[4], un_reads=stats[5])


class NativeCountBatch:
    """2-bit packed rows + ACGT-validity bitmask from the count reader."""

    __slots__ = ("packed", "good", "lengths", "n")

    def __init__(self, packed, good, lengths, n):
        self.packed = packed      # (B, stride/4) uint8
        self.good = good          # (B, stride/8) uint8 bitmask
        self.lengths = lengths    # (B,) int32
        self.n = n


class NativeCountReader:
    """Counting-mode reader: decode + 2-bit pack + validity bitmask all
    on the C++ threads (the host-side pack_codes_np/pack_good_np passes
    were the stage-00 bottleneck).  Raises RuntimeError mid-iteration
    on truncation or multi-line fasta — callers redo the file with the
    python reader."""

    def __init__(self, path: str, batch_size: int = 1 << 14,
                 len_cap: int = 8192, fastq: bool = True):
        lib = get_lib()
        self._lib = lib
        self._h = lib.hastio_open_count(path.encode(), batch_size,
                                        len_cap, 1 if fastq else 0)
        if not self._h:
            raise FileNotFoundError(path)
        self._bs = batch_size
        self._cap = ((len_cap + 127) // 128) * 128

    def __iter__(self):
        lib, h, bs = self._lib, self._h, self._bs
        scratch = np.empty(bs * (self._cap // 4), np.uint8)
        gscratch = np.empty(bs * (self._cap // 8), np.uint8)
        while True:
            lengths = np.empty(bs, np.int32)
            has_n = np.empty(bs, np.uint8)
            bids = np.empty(bs, np.int32)
            max_len = ctypes.c_int32()
            n = lib.hastio_next_batch_count(h, scratch, lengths, has_n,
                                            bids, gscratch,
                                            ctypes.byref(max_len))
            if n <= 0:
                return
            if lib.hastio_truncated(h) or lib.hastio_bad_fasta(h):
                raise RuntimeError("input needs the python reader "
                                   "(long read or multi-line fasta)")
            sp = max_len.value // 4
            sg = max_len.value // 8
            yield NativeCountBatch(
                scratch[:bs * sp].reshape(bs, sp).copy(),
                gscratch[:bs * sg].reshape(bs, sg).copy(),
                lengths, int(n))

    def close(self):
        if self._h:
            self._lib.hastio_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
