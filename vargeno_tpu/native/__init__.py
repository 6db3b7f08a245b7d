"""Native (C++) host runtime, loaded via ctypes with on-demand compilation.

Falls back cleanly when no compiler is available: every consumer checks
``available()`` and uses the numpy path otherwise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "fastio.cc")
# build output lives in the checkout's gitignored build/ tree
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "native")
_CMD = ("g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()
_lib = None
_tried = False


def cpu_model() -> str:
    """The host CPU's model name (``-march=native`` code is only valid on
    the CPU it was built for)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    import platform

    return platform.processor() or platform.machine()


def build_key(src: bytes, cmd=_CMD, cpu: str | None = None) -> str:
    """Hash of the source, the compile command and the CPU model: a library
    built from other source, flags or for another CPU never matches."""
    h = hashlib.sha256(src)
    h.update("\0".join(cmd).encode())
    h.update((cpu if cpu is not None else cpu_model()).encode())
    return h.hexdigest()[:16]


def lib_path() -> str:
    with open(_SRC, "rb") as f:
        key = build_key(f.read())
    return os.path.join(BUILD_DIR, f"libvgtfastio-{key}.so")


def _build(so: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run([*_CMD, "-o", tmp, _SRC], check=True,
                       capture_output=True)
        os.replace(tmp, so)   # atomic: a concurrent build never sees a
        return True           # partial file
    except (OSError, subprocess.CalledProcessError):
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = lib_path()
        if not os.path.exists(so) and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.vgt_fastq_batch.restype = ctypes.c_int64
        lib.vgt_fastq_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.vgt_encode_batch.restype = None
        lib.vgt_encode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8)]
        lib.vgt_rolling_kmers.restype = ctypes.c_int64
        lib.vgt_rolling_kmers.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint8)]
        lib.vgt_bf_set_bits.restype = None
        lib.vgt_bf_set_bits.argtypes = [
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64]
        lib.vgt_bf_test_bits.restype = None
        lib.vgt_bf_test_bits.argtypes = [
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.vgt_bf_mod_set.restype = None
        lib.vgt_bf_mod_set.argtypes = [
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
            ctypes.c_uint64]
        lib.vgt_radix_argsort_u64.restype = ctypes.c_int64
        lib.vgt_radix_argsort_u64.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32)]
        lib.vgt_radix_sort_kv_u64u32.restype = ctypes.c_int64
        lib.vgt_radix_sort_kv_u64u32.argtypes = [
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64]
        lib.vgt_revcomp_select.restype = None
        lib.vgt_revcomp_select.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8)]
        lib.vgt_ht_build.restype = ctypes.c_int64
        lib.vgt_ht_build.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint8)]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


CHUNK_BYTES = 256 << 20  # streamed read window (WGS FASTQs exceed RAM)


def fastq_batches(path: str, batch: int, L: int, K: int,
                  chunk_bytes: int = CHUNK_BYTES, skip_reads: int = 0):
    """Yield (codes(B,L)u8, n_kmers(B,)i32, qual(B,K)u8, n_valid) from a
    FASTQ file using the native parser, streaming the file in bounded
    windows (the parser stops at the last complete 4-line record in the
    window; the tail carries into the next read). ``skip_reads`` skips
    4*skip_reads leading lines at newline-count speed (checkpoint
    resume)."""
    lib = _load()
    assert lib is not None
    max_slen = ctypes.c_int64(0)
    qlen_mm = ctypes.c_int64(0)
    with open(path, "rb") as f:
        lines_left = 4 * skip_reads
        carry = b""
        while lines_left > 0:
            blk = f.read(1 << 22)
            if not blk:
                return
            n_nl = blk.count(b"\n")
            if n_nl < lines_left:
                lines_left -= n_nl
                continue
            # the skip boundary is inside this block
            off = -1
            for _ in range(lines_left):
                off = blk.index(b"\n", off + 1)
            carry = blk[off + 1:]
            lines_left = 0
        tail = carry
        eof = False
        while not eof:
            data = f.read(chunk_bytes)
            eof = len(data) < chunk_bytes
            data = tail + data
            if eof and data and not data.endswith(b"\n"):
                data += b"\n"   # unterminated final record
            n = len(data)
            cursor = ctypes.c_int64(0)
            buf = ctypes.c_char_p(data)
            while True:
                codes = np.empty((batch, L), np.uint8)
                n_kmers = np.empty(batch, np.int32)
                qual = np.empty((batch, K), np.uint8)
                got = lib.vgt_fastq_batch(
                    buf, n, ctypes.byref(cursor), batch, L, K,
                    codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    n_kmers.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    qual.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    ctypes.byref(max_slen), ctypes.byref(qlen_mm))
                if got == 0:
                    break
                if got < batch:
                    codes[got:] = 4
                    n_kmers[got:] = 0
                    qual[got:] = 0
                yield codes, n_kmers, qual, int(got)
                if got < batch:   # parser stopped short: window exhausted
                    break
            tail = data[cursor.value:]
    if tail.strip():
        from ..errors import FastqError

        raise FastqError(
            f"{path}: file ends mid-record -- {len(tail)} trailing bytes "
            f"do not form a complete 4-line FASTQ record (truncated "
            f"download or concatenation?): {tail[:60]!r}...")
    # truncation only diverges when it costs whole k-mers: the reference
    # itself floors reads to 32-base multiples (src/qv.cc:778-779), so a
    # read of length in (L, L+31] encodes identically; the K check covers
    # auto-sized slot caps below L//32 (io.fastq.autosize_shapes)
    from ..io.fastq import _warn_truncation, _warn_qual_mismatch

    _warn_truncation(max_slen.value, L, K)
    _warn_qual_mismatch(qlen_mm.value, path)


def encode_batch(codes: np.ndarray, n_kmers: np.ndarray, K: int):
    """(B, L) u8 codes -> (hi, lo) (B, K) u32 kmer words + kmer validity +
    read_ok, bit-identical to the device encode (engine/batch.py
    encode_batch). Used to pre-encode batches on host so dispatch ships
    ~1 MB of packed words instead of ~4 MB of base codes."""
    lib = _load()
    assert lib is not None
    codes = np.ascontiguousarray(codes, np.uint8)
    n_kmers = np.ascontiguousarray(n_kmers, np.int32)
    B, L = codes.shape
    hi = np.empty((B, K), np.uint32)
    lo = np.empty((B, K), np.uint32)
    kvalid = np.empty((B, K), np.uint8)
    read_ok = np.empty(B, np.uint8)
    lib.vgt_encode_batch(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n_kmers.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        B, L, K,
        hi.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        kvalid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        read_ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return hi, lo, kvalid.astype(bool), read_ok.astype(bool)


def bf_mod_set(words: np.ndarray, hashes: np.ndarray, mod: int) -> None:
    """words[(h % mod) >> 6] |= bit for every 64-bit hash value."""
    lib = _load()
    assert lib is not None
    hashes = np.ascontiguousarray(hashes, np.uint64)
    lib.vgt_bf_mod_set(
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        hashes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        hashes.shape[0], mod)


def ht_build(hi, lo, pos, flag, info, nb: int, slots: int):
    """Sequential-insertion bucketized hash-table build.

    Returns (table (nb, slots*4) uint32, chain bound). `info` may be None.
    """
    lib = _load()
    assert lib is not None
    n = hi.shape[0]
    table = np.zeros((nb, slots * 4), np.uint32)
    cap = np.zeros(nb, np.uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    hi = np.ascontiguousarray(hi, np.uint32)
    lo = np.ascontiguousarray(lo, np.uint32)
    pos = np.ascontiguousarray(pos, np.uint32)
    flag = np.ascontiguousarray(flag, np.uint8)
    info_p = None
    if info is not None:
        info = np.ascontiguousarray(info, np.uint8)
        info_p = info.ctypes.data_as(ctypes.c_void_p)
    chain = lib.vgt_ht_build(
        hi.ctypes.data_as(u32p), lo.ctypes.data_as(u32p),
        pos.ctypes.data_as(u32p), flag.ctypes.data_as(u8p),
        info_p, n, nb, slots,
        table.ctypes.data_as(u32p), cap.ctypes.data_as(u8p))
    return table, int(chain)


def radix_sort_kv(keys: np.ndarray, vals: np.ndarray) -> bool:
    """In-place stable ascending sort of (keys u64, vals u32) pairs.
    Returns False when unavailable (caller falls back to argsort+apply).
    Equivalent ordering to np.argsort(kind='stable') + fancy-indexing,
    with ~5x less peak memory (whole-genome index build requirement)."""
    lib = _load()
    if lib is None:
        return False
    assert keys.flags.c_contiguous and vals.flags.c_contiguous
    assert keys.dtype == np.uint64 and vals.dtype == np.uint32
    rc = lib.vgt_radix_sort_kv_u64u32(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        keys.shape[0])
    return rc == 0


def radix_argsort(keys: np.ndarray) -> np.ndarray:
    """Stable argsort of uint64 keys (threaded LSD radix, u32 indices).

    Same ordering contract as np.argsort(kind='stable'); callers fall back
    to numpy when the native library is unavailable or n >= 2^32."""
    lib = _load()
    assert lib is not None
    keys = np.ascontiguousarray(keys, np.uint64)
    n = keys.shape[0]
    idx = np.empty(n, np.uint32)
    rc = lib.vgt_radix_argsort_u64(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), n,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    if rc != 0:
        return np.argsort(keys, kind="stable")
    return idx


def bf_set_bits(words: np.ndarray, bit_idx: np.ndarray) -> None:
    lib = _load()
    assert lib is not None
    bit_idx = np.ascontiguousarray(bit_idx, np.uint64)
    lib.vgt_bf_set_bits(
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        bit_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        bit_idx.shape[0])


def rolling_kmers(codes: np.ndarray):
    """(kmers u64, valid bool) for all 32-windows of a uint8 code array."""
    lib = _load()
    assert lib is not None
    codes = np.ascontiguousarray(codes, np.uint8)
    n = codes.shape[0]
    nw = max(n - 31, 0)
    kmers = np.empty(nw, np.uint64)
    valid = np.empty(nw, np.uint8)
    if nw:
        lib.vgt_rolling_kmers(
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n,
            kmers.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return kmers, valid.astype(bool)


def revcomp_select(codes: np.ndarray, n_kmers: np.ndarray,
                   qual: np.ndarray, sel: np.ndarray):
    """Gather rows ``sel`` and reverse-complement their in-use bases
    (reference retry semantics, src/qv.cc:787-806; quality NOT reversed).
    Returns (codes(n_sel,L), n_kmers(n_sel,), qual(n_sel,K))."""
    lib = _load()
    assert lib is not None
    codes = np.ascontiguousarray(codes, np.uint8)
    n_kmers = np.ascontiguousarray(n_kmers, np.int32)
    qual = np.ascontiguousarray(qual, np.uint8)
    sel = np.ascontiguousarray(sel, np.int32)
    n_sel = sel.shape[0]
    L = codes.shape[1]
    K = qual.shape[1]
    oc = np.empty((n_sel, L), np.uint8)
    onk = np.empty(n_sel, np.int32)
    oq = np.empty((n_sel, K), np.uint8)
    if n_sel:
        lib.vgt_revcomp_select(
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n_kmers.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            qual.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            L, K,
            sel.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_sel,
            oc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            onk.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            oq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return oc, onk, oq
