"""FASTA/FASTQ ingest: native C++ batch parser with a pure-Python fallback.

The parser (native/fastx.cpp, ctypes C ABI) fills fixed-shape [B, L] uint8
batches padded with 'N' -- padding reuses the N machinery, so downstream
kernels need no ragged handling (SURVEY.md §7 "ragged reads").  Gzip input
(.fastq.gz / .fasta.gz) is decoded transparently on both paths: zlib gzFile
in the native parser, the gzip module (sniffed by magic bytes) here.

Long records (contigs, references) are split by the parser into rows with a
(k-1)-base overlap so every k-mer window of the original record appears in
exactly one row -- the single-host analog of the multi-chip halo exchange
(SURVEY.md §5.7).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterator, Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native"))
_SO_PATH = os.path.join(_NATIVE_DIR, "libfastx.so")

_lib = None
_build_error: Optional[str] = None

PAD = ord("N")


def _build_native() -> None:
    """Build libfastx.so from native/fastx.cpp.  The library is linked
    under a temporary name inside native/ and renamed into place, so
    processes that build at once (test workers) never load a half-written
    file: rename is atomic within one directory."""
    tmp_name = f".libfastx.{os.getpid()}.so"
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, f"TARGET={tmp_name}"],
                       check=True, capture_output=True, text=True,
                       timeout=300)
        os.replace(os.path.join(_NATIVE_DIR, tmp_name), _SO_PATH)
    finally:
        try:
            os.unlink(os.path.join(_NATIVE_DIR, tmp_name))
        except FileNotFoundError:
            pass


def _load_native() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    if not os.path.exists(_SO_PATH):
        try:
            _build_native()
        except (OSError, subprocess.SubprocessError) as e:
            _build_error = getattr(e, "stderr", None) or repr(e)
            return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError as e:
        _build_error = repr(e)
        return None
    lib.fastx_open.restype = ctypes.c_void_p
    lib.fastx_open.argtypes = [ctypes.c_char_p]
    for name in ("fastx_next_batch", "fastx_next_batch_chunked"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_longlong
    lib.fastx_next_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_longlong, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_longlong)]
    lib.fastx_next_batch_chunked.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_longlong)]
    lib.fastx_next_batch_chunked_packed.restype = ctypes.c_longlong
    lib.fastx_next_batch_chunked_packed.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_longlong)]
    lib.fastx_close.argtypes = [ctypes.c_void_p]
    lib.fastx_format.restype = ctypes.c_int
    lib.fastx_format.argtypes = [ctypes.c_void_p]
    lib.pack2bit.argtypes = [
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint64)]
    _lib = lib
    return lib


def native_available() -> bool:
    """Whether the native parser is loaded, building it on first use.
    When it is not, ingest falls back to the pure-Python parser and
    native_build_error() says why."""
    return _load_native() is not None


def native_build_error() -> Optional[str]:
    """The compiler's error output if building libfastx.so failed."""
    return _build_error


def _open_maybe_gz(path: str):
    """Binary handle; gzip-compressed files (1f 8b magic) are inflated
    transparently, matching the native parser's zlib gzFile behavior."""
    import gzip

    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def _py_records(path: str) -> Iterator[bytes]:
    """Pure-Python fallback parser (same record semantics as native)."""
    with _open_maybe_gz(path) as f:
        first = f.read(1)
        f.seek(0)
        if first == b">":
            seq = []
            for line in f:
                line = line.rstrip(b"\r\n")
                if line.startswith(b">"):
                    if seq is not None and seq:
                        yield b"".join(seq)
                    seq = []
                else:
                    seq.append(line)
            if seq:
                yield b"".join(seq)
        elif first == b"@":
            while True:
                header = f.readline()
                if not header:
                    return
                seq_parts = []
                line = f.readline()
                while line and not line.startswith(b"+"):
                    seq_parts.append(line.rstrip(b"\r\n"))
                    line = f.readline()
                seq = b"".join(seq_parts)
                qlen = 0
                while qlen < len(seq):
                    q = f.readline()
                    if not q:
                        break
                    qlen += len(q.rstrip(b"\r\n"))
                yield seq
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ")


def _native_batches(path, batch, length, chunked, overlap):
    lib = _load_native()
    handle = lib.fastx_open(path.encode())
    if not handle:
        raise ValueError(f"{path}: cannot open as FASTA/FASTQ")
    try:
        while True:
            buf = np.full((batch, length), PAD, dtype=np.uint8)
            lens = np.zeros(batch, dtype=np.int64)
            pbuf = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
            plen = lens.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))
            if chunked:
                n = lib.fastx_next_batch_chunked(
                    handle, pbuf, batch, length, overlap, plen)
            else:
                n = lib.fastx_next_batch(handle, pbuf, batch, length, plen)
            if n < 0:
                raise ValueError(f"{path}: malformed FASTA/FASTQ")
            if n == 0:
                break
            yield buf, lens, int(n)
    finally:
        lib.fastx_close(handle)


def read_records(path: str, batch: int, length: int,
                 force_python: bool = False
                 ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Batched records, one per row, padded with 'N'.  lengths hold TRUE
    record lengths (possibly > length; then the row holds the first `length`
    bases only -- use read_kmer_batches for lossless k-mer coverage)."""
    if not force_python and native_available():
        for buf, lens, n in _native_batches(path, batch, length, False, 0):
            yield buf[:n], lens[:n]
        return
    buf = np.full((batch, length), PAD, dtype=np.uint8)
    lens = np.zeros(batch, dtype=np.int64)
    n = 0
    for rec in _py_records(path):
        arr = np.frombuffer(rec, dtype=np.uint8)
        ncopy = min(len(arr), length)
        buf[n, :ncopy] = arr[:ncopy]
        lens[n] = len(arr)
        n += 1
        if n == batch:
            yield buf, lens
            buf = np.full((batch, length), PAD, dtype=np.uint8)
            lens = np.zeros(batch, dtype=np.int64)
            n = 0
    if n:
        yield buf[:n], lens[:n]


def read_kmer_batches(path: str, k: int, batch: int, length: int,
                      force_python: bool = False) -> Iterator[np.ndarray]:
    """Yield fixed-shape [batch, length] uint8 batches where every k-mer of
    every input record appears in exactly one row.

    Records longer than `length` are split into chunks with a (k-1)-base
    halo (native streaming chunker / python fallback).  The final batch is
    padded with all-'N' rows so the shape is static: one XLA compile.
    """
    assert length >= k >= 1
    if not force_python and native_available():
        for buf, _lens, n in _native_batches(path, batch, length, True, k - 1):
            yield buf  # rows past n are all-'N' padding
        return
    stride = length - (k - 1)
    out = np.full((batch, length), PAD, dtype=np.uint8)
    n = 0
    for rec in _py_records(path):
        arr = np.frombuffer(rec, dtype=np.uint8)
        pos = 0
        while True:
            piece = arr[pos:pos + length]
            out[n, :len(piece)] = piece
            n += 1
            if n == batch:
                yield out
                out = np.full((batch, length), PAD, dtype=np.uint8)
                n = 0
            if pos + length >= len(arr):
                break
            pos += stride
    if n:
        yield out


def pack_batch_np(rows: np.ndarray):
    """Numpy 2-bit pack of an ASCII [B, L] batch (L % 32 == 0): returns
    (words [B, L/16] uint32, validbits [B, L/32] uint32) in the same layout
    as the native fastx_next_batch_chunked_packed."""
    B, L = rows.shape
    assert L % 32 == 0, L
    a = rows.astype(np.uint32)
    lower = a | 0x20
    ok = ((lower == ord("a")) | (lower == ord("c")) |
          (lower == ord("g")) | (lower == ord("t")))
    internal = (a >> 1) & 3
    codes = np.where(ok, internal ^ (internal >> 1), 0).astype(np.uint32)
    sh16 = (np.arange(16, dtype=np.uint32) * 2)
    words = np.bitwise_or.reduce(
        codes.reshape(B, L // 16, 16) << sh16, axis=2).astype(np.uint32)
    sh32 = np.arange(32, dtype=np.uint32)
    validbits = np.bitwise_or.reduce(
        ok.astype(np.uint32).reshape(B, L // 32, 32) << sh32,
        axis=2).astype(np.uint32)
    return words, validbits


def read_packed_batches(path: str, k: int, batch: int, length: int,
                        force_python: bool = False
                        ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Packed-batch ingest: yield (words [batch, length/16] uint32,
    validbits [batch, length/32] uint32) with the same row semantics as
    read_kmer_batches (every k-mer in exactly one row, (k-1)-halo chunking,
    all-'N' = all-zero padding rows).  This is the device-upload path:
    0.375 B/base through the host->device link instead of 1 B/base ASCII.

    length must be a multiple of 32.
    """
    assert length % 32 == 0, "packed ingest needs length % 32 == 0"
    assert length >= k >= 1
    if not force_python and native_available():
        lib = _load_native()
        handle = lib.fastx_open(path.encode())
        if not handle:
            raise ValueError(f"{path}: cannot open as FASTA/FASTQ")
        try:
            wpr, vpr = length // 16, length // 32
            while True:
                words = np.zeros((batch, wpr), dtype=np.uint32)
                valid = np.zeros((batch, vpr), dtype=np.uint32)
                lens = np.zeros(batch, dtype=np.int64)
                n = lib.fastx_next_batch_chunked_packed(
                    handle,
                    words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                    valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                    batch, length, k - 1,
                    lens.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)))
                if n < 0:
                    raise ValueError(f"{path}: malformed FASTA/FASTQ")
                if n == 0:
                    break
                yield words, valid
        finally:
            lib.fastx_close(handle)
        return
    for rows in read_kmer_batches(path, k=k, batch=batch, length=length,
                                  force_python=True):
        yield pack_batch_np(rows)


def prefetch(it: Iterator, depth: int = 512) -> Iterator:
    """Run `it` in a background thread: the host parses/packs ahead while
    earlier batches upload/compute (VERDICT round 2 item 1).  Exceptions
    propagate.

    depth (default 512 batches) bounds the look-ahead: deep enough to
    decouple device uploads from parse wakeups (a 1-deep queue serialized
    the CLI on parse/upload hand-offs), but
    constant-memory for arbitrarily large files instead of O(packed file)
    -- an unbounded queue made host memory scale with the input and, when
    the consumer aborted mid-iteration (the auto-restart loop), left an
    abandoned worker parsing the WHOLE file into a queue nobody drains
    (ADVICE r3).  depth == 0 means unbounded (explicit opt-in).

    The worker also stops promptly when the generator is closed (GC,
    ``close()``, or an abandoning consumer): closing sets a stop event and
    drains the queue so a blocked ``put`` wakes and the thread exits."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    _END, _ERR = object(), object()

    def worker():
        try:
            for item in it:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(_END)
        except BaseException as e:  # noqa: BLE001 - re-raised on main thread
            if not stop.is_set():
                q.put((_ERR, e))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if (isinstance(item, tuple) and len(item) == 2
                    and item[0] is _ERR):
                raise item[1]
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


def pack2bit_native(ascii_bytes: bytes):
    """Host-side native 2-bit pack: returns (uint32 words, validity bitmap
    uint64 words).  Falls back to numpy when the .so is unavailable."""
    n = len(ascii_bytes)
    lib = _load_native()
    arr = np.frombuffer(ascii_bytes, dtype=np.uint8)
    if lib is None:
        from ..ops.seqvector import pack_ascii_to_words

        words = pack_ascii_to_words(arr)
        lower = arr | 0x20
        ok = ((lower == ord("a")) | (lower == ord("c")) |
              (lower == ord("g")) | (lower == ord("t")))
        bitmap = np.zeros((n + 63) // 64, dtype=np.uint64)
        idx = np.nonzero(ok)[0]
        np.bitwise_or.at(bitmap, idx // 64,
                         np.uint64(1) << (idx % 64).astype(np.uint64))
        return words, bitmap
    words = np.zeros((n + 15) // 16, dtype=np.uint32)
    bitmap = np.zeros((n + 63) // 64, dtype=np.uint64)
    lib.pack2bit(arr.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), n,
                 words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                 bitmap.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    return words, bitmap
