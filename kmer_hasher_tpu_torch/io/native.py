"""ctypes binding of the port's native FASTA/FASTQ parser
(``io/native/fastx.cpp``, the port's own copy of the JAX package's).

The parser is built with g++ at first use into
``kmer_hasher_tpu_torch/build/`` (a file named by a hash of the source) and
read through the same record format as the pure-Python reader. The rule is
"native where it builds, else pure Python, ``KMH_NATIVE_IO=0`` forces
Python", and never silently: :func:`available` keeps the compiler's message
(:func:`build_error`), :func:`reader_name` says which reader a call made
now would use, and the counting entries record it in
``store.timings["reader"]``.

Batches follow the port's padding rule, not the TPU's shape buckets: a
batch's rows are its reads, and its columns the multiple of 8 that holds the
longest read.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "native" / "fastx.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_error = ""


class _FastxResult(ctypes.Structure):
    _fields_ = [
        ("seq", ctypes.POINTER(ctypes.c_uint8)),
        ("qual", ctypes.POINTER(ctypes.c_uint8)),
        ("offsets", ctypes.POINTER(ctypes.c_int64)),
        ("qual_present", ctypes.POINTER(ctypes.c_uint8)),
        ("names", ctypes.c_char_p),
        ("n_records", ctypes.c_int64),
        ("names_len", ctypes.c_int64),
        ("error", ctypes.c_int),
    ]


_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_RESP = ctypes.POINTER(_FastxResult)
_I64 = ctypes.c_int64


def _compile(so: Path) -> None:
    """g++ the parser into ``so``; raises with the compiler's messages.
    zlib is linked as ``-lz``, or by the file name of the library the
    loader knows where the development symlink is missing."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    base = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o",
            str(tmp)]
    links = [["-lz"]]
    soname = ctypes.util.find_library("z")
    if soname:
        links.append([f"-l:{soname}"])
    log = ""
    try:
        for link in links:
            try:
                r = subprocess.run(base + link, capture_output=True,
                                   text=True, timeout=300)
            except OSError as e:  # no g++
                raise RuntimeError(f"{' '.join(base + link)}: {e}") from e
            log += f"$ {' '.join(base + link)}\n{r.stdout}{r.stderr}"
            if r.returncode == 0:
                os.replace(tmp, so)
                return
        raise RuntimeError(f"g++ failed:\n{log}")
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> ctypes.CDLL:
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"kmh_fastx-{tag}.so"
    if not so.is_file():
        _compile(so)
    lib = ctypes.CDLL(str(so))
    lib.fastx_read.restype = _RESP
    lib.fastx_read.argtypes = [ctypes.c_char_p, _I64]
    lib.fastx_free.argtypes = [_RESP]
    lib.fastx_open.restype = ctypes.c_void_p
    lib.fastx_open.argtypes = [ctypes.c_char_p]
    lib.fastx_open_range.restype = ctypes.c_void_p
    lib.fastx_open_range.argtypes = [ctypes.c_char_p, _I64, _I64]
    lib.fastx_handle_tell.restype = _I64
    lib.fastx_handle_tell.argtypes = [ctypes.c_void_p]
    lib.fastx_read_batch.restype = _RESP
    lib.fastx_read_batch.argtypes = [ctypes.c_void_p, _I64]
    lib.fastx_close.argtypes = [ctypes.c_void_p]
    lib.fastx_fill_padded.restype = None
    lib.fastx_fill_padded.argtypes = [
        _RESP, _I64, _I64, _I64, _I64, _U8P, _U8P, _I32P, _U8P]
    return lib


def available() -> bool:
    """Whether the native parser can be used now: it built (the build is
    tried once per process) and ``KMH_NATIVE_IO`` is not "0"."""
    global _lib, _tried, _error
    if os.environ.get("KMH_NATIVE_IO", "1") == "0":
        return False
    with _lock:
        if not _tried:
            _tried = True
            try:
                _lib = _load()
            except Exception as e:  # kept, not swallowed: see build_error()
                _lib, _error = None, f"{type(e).__name__}: {e}"
    return _lib is not None


def build_error() -> str:
    """Why the native parser is not available after a failed build (the
    compiler's messages), else ''."""
    return _error


def reader_name() -> str:
    """"native" or "python": the reader the file entries would use now."""
    return "native" if available() else "python"


def _need() -> ctypes.CDLL:
    if not available():
        raise RuntimeError(
            "native fastx parser unavailable"
            + (f": {_error}" if _error else " (KMH_NATIVE_IO=0)"))
    return _lib


def _raise_for(error: int, path) -> None:
    if error == 1:
        raise FileNotFoundError(path)
    if error == 2:
        raise ValueError(f"unrecognised fastx content in {path}")
    if error == 3:
        raise IOError(f"read error (corrupt stream?) in {path}")


def _view(ptr, n: int, dtype) -> np.ndarray:
    """A copy of the n elements at ``ptr``; empty for n == 0."""
    if not n:
        return np.zeros(0, dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).copy()


def _result_to_raw(lib, res, path):
    """Copy a FastxResult into numpy arrays and free it."""
    try:
        r = res.contents
        _raise_for(r.error, path)
        n = int(r.n_records)
        offsets = _view(r.offsets, n + 1, np.int64) if n else np.zeros(
            1, np.int64)
        total = int(offsets[-1])
        return (_view(r.seq, total, np.uint8), _view(r.qual, total, np.uint8),
                offsets, _view(r.qual_present, n, np.uint8).astype(bool))
    finally:
        lib.fastx_free(res)


def read_fastx_raw(path, max_records: Optional[int] = None):
    """The whole file as contiguous buffers, one bulk copy each:
    (seq_all, qual_all, offsets [n+1], qual_present [n])."""
    lib = _need()
    res = lib.fastx_read(os.fsencode(path),
                         -1 if max_records is None else int(max_records))
    return _result_to_raw(lib, res, path)


def iter_fastx_raw(path, batch_records: int = 4096,
                   max_records: Optional[int] = None):
    """Stream (seq_all, qual_all, offsets, qual_present) batches of up to
    ``batch_records`` records with constant memory."""
    lib = _need()
    h = lib.fastx_open(os.fsencode(path))
    if not h:
        raise FileNotFoundError(path)
    try:
        remaining = max_records
        while True:
            take = (batch_records if remaining is None
                    else min(batch_records, remaining))
            if take <= 0:
                return
            out = _result_to_raw(lib, lib.fastx_read_batch(h, take), path)
            n = len(out[3])
            if n == 0:
                return
            if remaining is not None:
                remaining -= n
            yield out
            if n < take:
                return
    finally:
        lib.fastx_close(h)


#: Per-process parse accounting: record bytes put into batch buffers by the
#: padded iterator below.
STATS = {"bytes_parsed": 0}


def padded_cols(lmax: int) -> int:
    """The port's column rule: the multiple of 8 that holds ``lmax``."""
    return max(8, -(-int(lmax) // 8) * 8)


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def iter_fastx_padded(path, batch_records: int = 4096,
                      max_records: Optional[int] = None, skip: int = 0,
                      byte_range: Optional[Tuple[int, int]] = None,
                      range_info: Optional[dict] = None) -> Iterator[tuple]:
    """Stream padded (seq, qual, lengths, has_qual) batches, the padding
    done by per-row memcpy in C++: uint8 [B, Lp] planes padded with 'N' and
    0, int32 lengths, bool has_qual. ``skip`` discards the first N records
    (mid-file resume); ``max_records`` limits what comes after the skip.

    ``byte_range=(start, end)`` restricts the stream to the records whose
    first byte falls in [start, end) (plain files; the opener re-synchronises
    to a record boundary; multi-line FASTQ is not range-safe, see
    ``fastx.is_fourline_fastq``). ``range_info`` receives the resolved
    boundaries: ``start`` at once, ``end`` when the iterator is exhausted;
    consecutive ranges' [start, end) tile the file exactly."""
    lib = _need()
    if byte_range is not None:
        if skip:
            raise ValueError("skip and byte_range are mutually exclusive")
        h = lib.fastx_open_range(os.fsencode(path), int(byte_range[0]),
                                 int(byte_range[1]))
    else:
        h = lib.fastx_open(os.fsencode(path))
    if not h:
        raise FileNotFoundError(path)
    if range_info is not None:
        range_info["start"] = int(lib.fastx_handle_tell(h))
    try:
        remaining = max_records
        to_skip = skip
        while True:
            take = (batch_records if remaining is None
                    else min(batch_records, remaining + to_skip))
            if take <= 0:
                return
            res = lib.fastx_read_batch(h, take)
            try:
                r = res.contents
                _raise_for(r.error, path)
                n = int(r.n_records)
                if n == 0:
                    return
                if to_skip >= n:
                    to_skip -= n
                    if n < take:
                        return
                    continue
                start, to_skip = to_skip, 0
                offs = np.ctypeslib.as_array(r.offsets, shape=(n + 1,))
                STATS["bytes_parsed"] += int(offs[n])
                B = n - start
                Lp = padded_cols((offs[start + 1:n + 1] - offs[start:n]).max())
                seq = np.empty((B, Lp), np.uint8)
                qual = np.empty((B, Lp), np.uint8)
                lengths = np.empty(B, np.int32)
                qpres = np.empty(B, np.uint8)
                lib.fastx_fill_padded(res, start, n, B, Lp, _ptr(seq, _U8P),
                                      _ptr(qual, _U8P), _ptr(lengths, _I32P),
                                      _ptr(qpres, _U8P))
            finally:
                lib.fastx_free(res)
            if remaining is not None:
                remaining -= B
            yield seq, qual, lengths, qpres.astype(bool)
            if n < take:
                return
    finally:
        if range_info is not None:
            range_info["end"] = int(lib.fastx_handle_tell(h))
        lib.fastx_close(h)


def read_fastx(path, max_records: Optional[int] = None
               ) -> List[Tuple[str, bytes, Optional[bytes]]]:
    """The records of a file as (name, seq, qual or None) tuples, as the
    pure-Python reader gives them."""
    lib = _need()
    res = lib.fastx_read(os.fsencode(path),
                         -1 if max_records is None else int(max_records))
    try:
        r = res.contents
        _raise_for(r.error, path)
        n = int(r.n_records)
        if n == 0:
            return []
        offsets = [r.offsets[i] for i in range(n + 1)]
        names = (ctypes.string_at(r.names, r.names_len).decode()
                 .split("\n")[:n] if r.names_len else [""] * n)
        total = offsets[-1]
        seq_all = ctypes.string_at(r.seq, total) if total else b""
        qual_all = ctypes.string_at(r.qual, total) if total else b""
        return [(names[i], seq_all[a:b],
                 qual_all[a:b] if r.qual_present[i] else None)
                for i, (a, b) in enumerate(zip(offsets, offsets[1:]))]
    finally:
        lib.fastx_free(res)
