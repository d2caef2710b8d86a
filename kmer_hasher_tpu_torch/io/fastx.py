"""FASTA / FASTQ (.gz) reading — the port's own pure-Python reader, a copy
of the portable path of ``kmer_hasher_tpu/io/fastx.py``.

The reference streams records with klib's ``kseq.h`` (src/kseq.h:176-219)
over zlib; this reader follows the same record grammar: the format is
taken from the first byte ('>' FASTA, '@' FASTQ), gzip from the magic
bytes, sequences and qualities may span lines. Records come out two ways:

* :func:`read_fastx` / :func:`iter_fastx` — (name, seq_bytes,
  qual_bytes|None) tuples, whole or in batches (FASTA records and FASTQ
  records whose quality line is missing or of the wrong length have no
  qualities);
* :func:`pad_records` — a dense batch: uint8 ASCII matrices ``seq`` and
  ``qual`` plus lengths. Padding is base 'N' / quality 0, so a padded tail
  can form no valid window on any filtering path; :func:`read_fastx_padded`
  is a whole file so.

The byte-range forms (:func:`find_record_boundary`,
:func:`iter_fastx_range`, gated by :func:`is_gzip` and
:func:`is_fourline_fastq`) slice a plain file among several readers so that
consecutive ranges partition its records exactly. The native C++ reader is
``io/native.py``; this module never calls it.
"""
from __future__ import annotations

import gzip
import io
import itertools
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

Record = Tuple[str, bytes, Optional[bytes]]


def _open(path):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.open(f, "rb")
    return f


def _name(header: bytes) -> str:
    """Record name: the header line's first word after its leader byte."""
    words = header[1:].split()
    return words[0].decode() if words else ""


def _iter_records(path) -> Iterator[Record]:
    with _open(path) as f:
        buf = f if isinstance(f, io.BufferedReader) else io.BufferedReader(f)
        first = buf.peek(1)[:1]
        if first == b">":
            name = None
            chunks: List[bytes] = []
            for line in buf:
                line = line.rstrip(b"\r\n")
                if line.startswith(b">"):
                    if name is not None:
                        yield (name, b"".join(chunks), None)
                    name = _name(line)
                    chunks = []
                else:
                    chunks.append(line)
            if name is not None:
                yield (name, b"".join(chunks), None)
        elif first == b"@":
            # multi-line FASTQ like kseq (src/kseq.h:195-218): the sequence
            # spans lines until the '+' separator; quality lines accumulate
            # until they reach the sequence's length, and at least one is
            # read, so an empty read takes its empty quality line
            while True:
                hdr = buf.readline()
                if not hdr:
                    return
                name = _name(hdr.rstrip(b"\r\n"))
                chunks = []
                line = b""
                for line in buf:
                    if line.startswith(b"+"):
                        break
                    chunks.append(line.rstrip(b"\r\n"))
                seq = b"".join(chunks)
                if not line.startswith(b"+"):  # truncated: FASTA-ish tail
                    yield (name, seq, None)
                    return
                qchunks: List[bytes] = []
                qlen = 0
                while True:
                    qline = buf.readline()
                    if not qline:
                        break
                    qchunks.append(qline.rstrip(b"\r\n"))
                    qlen += len(qchunks[-1])
                    if qlen >= len(seq):
                        break
                qual = b"".join(qchunks)
                yield (name, seq, qual if len(qual) == len(seq) else None)
        elif first:
            raise ValueError(
                f"unrecognised fastx leader byte {first!r} in {path}")


def read_fastx(path, max_records: Optional[int] = None) -> List[Record]:
    """Parse FASTA or FASTQ, optionally gzipped, into a list of records."""
    it = _iter_records(path)
    if max_records is None:
        return list(it)
    return list(itertools.islice(it, max_records))


def iter_fastx(path, batch_size: int = 4096,
               max_records: Optional[int] = None
               ) -> Iterator[List[Record]]:
    """Stream records in batches of ``batch_size`` with constant memory —
    a batch is the unit the device consumes."""
    batch: List[Record] = []
    n = 0
    for rec in _iter_records(path):
        batch.append(rec)
        n += 1
        if max_records is not None and n >= max_records:
            break
        if len(batch) >= batch_size:
            yield batch
            batch = []
    if batch:
        yield batch


def is_gzip(path) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


def find_record_boundary(path, start: int, end: int) -> int:
    """First record start at or after byte ``start`` and before ``end``
    (-1 if none): the pure-Python twin of the native range opener. Plain
    files only. FASTA boundaries ('>' line starts) are unambiguous; FASTQ
    '@' and '+' are legal quality bytes, so candidates are verified against
    two consecutive 4-line records (multi-line FASTQ is not supported in
    range mode)."""
    with open(path, "rb") as f:
        fmt = f.read(1)
        if start <= 0:
            return 0
        # seek to start-1 and drop a line: lands exactly on `start` when
        # the previous byte is '\n', so a record starting AT start is ours
        f.seek(start - 1)
        f.readline()
        if fmt == b">":
            while True:
                pos = f.tell()
                if pos >= end:
                    return -1
                line = f.readline()
                if not line:
                    return -1
                if line.startswith(b">"):
                    return pos
        lines: List[Tuple[int, bytes]] = []

        def have(i: int) -> bool:
            while len(lines) <= i:
                pos = f.tell()
                ln = f.readline()
                if not ln:
                    return False
                lines.append((pos, ln.rstrip(b"\r\n")))
            return True

        i = 0
        while True:
            if not have(i):
                return -1
            pos, ln = lines[i]
            if pos >= end:
                return -1
            if ln.startswith(b"@"):
                if have(i + 3):
                    ok = (lines[i + 2][1].startswith(b"+")
                          and len(lines[i + 3][1]) == len(lines[i + 1][1]))
                    if ok and have(i + 7):
                        ok = (lines[i + 4][1].startswith(b"@")
                              and lines[i + 6][1].startswith(b"+")
                              and len(lines[i + 7][1])
                              == len(lines[i + 5][1]))
                    elif ok and have(i + 4):
                        ok = lines[i + 4][1].startswith(b"@")
                else:
                    ok = have(i + 2) and lines[i + 2][1].startswith(b"+")
                if ok:
                    return pos
            i += 1


def _iter_records_range(path, start: int, end: int,
                        range_info: Optional[dict] = None
                        ) -> Iterator[Record]:
    """Records whose first byte falls in [start, end); see
    :func:`find_record_boundary`. The record grammar is the full parser's
    (multi-line FASTA and FASTQ), but the FASTQ boundary search is
    4-line-only: callers gate on :func:`is_fourline_fastq` and verify
    continuity through ``range_info`` (filled with the resolved ``start``
    and ``end`` record-boundary offsets)."""
    boundary = find_record_boundary(path, start, end)
    if boundary < 0:
        if range_info is not None:
            range_info["start"] = range_info["end"] = int(start)
        return
    if range_info is not None:
        range_info["start"] = int(boundary)
    with open(path, "rb") as f:
        fmt = f.read(1)
        f.seek(boundary)

        def done(pos):
            if range_info is not None:
                range_info["end"] = int(pos)

        if fmt == b">":
            name = None
            chunks: List[bytes] = []
            while True:
                pos = f.tell()
                line = f.readline()
                if not line:
                    break
                s = line.rstrip(b"\r\n")
                if s.startswith(b">"):
                    if name is not None:
                        yield (name, b"".join(chunks), None)
                        name = None
                    if pos >= end:
                        done(pos)
                        return
                    name = _name(s)
                    chunks = []
                else:
                    chunks.append(s)
            if name is not None:
                yield (name, b"".join(chunks), None)
            done(f.tell())
            return
        while True:
            pos = f.tell()
            hdr = f.readline()
            if not hdr or pos >= end:
                done(pos)
                return
            name = _name(hdr.rstrip(b"\r\n"))
            chunks = []
            line = b""
            while True:
                line = f.readline()
                if not line or line.startswith(b"+"):
                    break
                chunks.append(line.rstrip(b"\r\n"))
            seq = b"".join(chunks)
            if not line.startswith(b"+"):  # truncated: FASTA-ish tail
                yield (name, seq, None)
                done(f.tell())
                return
            qchunks: List[bytes] = []
            qlen = 0
            while True:  # at least one quality line, as above
                ql = f.readline()
                if not ql:
                    break
                qchunks.append(ql.rstrip(b"\r\n"))
                qlen += len(qchunks[-1])
                if qlen >= len(seq):
                    break
            qual = b"".join(qchunks)
            yield (name, seq, qual if len(qual) == len(seq) else None)


def iter_fastx_range(path, start: int, end: int, batch_size: int = 4096,
                     range_info: Optional[dict] = None
                     ) -> Iterator[List[Record]]:
    """Batches of the records that start in bytes [start, end)."""
    batch: List[Record] = []
    for rec in _iter_records_range(path, start, end, range_info):
        batch.append(rec)
        if len(batch) >= batch_size:
            yield batch
            batch = []
    if batch:
        yield batch


def is_fourline_fastq(path, n_records: int = 64) -> bool:
    """True when the file can be sliced by byte range: FASTA (multi-line is
    fine, '>' boundaries are unambiguous), or FASTQ whose first
    ``n_records`` are strict 4-line records."""
    with open(path, "rb") as f:
        first = f.read(1)
        if first != b"@":
            return True  # FASTA or empty; other content fails later
        f.seek(0)
        for _ in range(n_records):
            hdr = f.readline()
            if not hdr:
                return True
            if not hdr.startswith(b"@"):
                return False
            seq = f.readline().rstrip(b"\r\n")
            sep = f.readline()
            qual = f.readline().rstrip(b"\r\n")
            if not sep.startswith(b"+") or len(qual) != len(seq):
                return False
    return True


@dataclass
class PaddedReads:
    """Dense batch of variable-length reads."""

    seq: np.ndarray   # uint8 [n, max_len] ASCII codes, padded with ord('N')
    qual: np.ndarray  # uint8 [n, max_len], 0 where absent or padded
    lengths: np.ndarray  # int32 [n]
    has_qual: np.ndarray  # bool [n]

    @property
    def n_reads(self) -> int:
        return int(self.seq.shape[0])


def pad_records(records: List[Record], pad_to_multiple: int = 8
                ) -> PaddedReads:
    n = len(records)
    max_len = max((len(r[1]) for r in records), default=1)
    max_len = max(1, -(-max_len // pad_to_multiple) * pad_to_multiple)
    seq = np.full((n, max_len), ord("N"), dtype=np.uint8)
    qual = np.zeros((n, max_len), dtype=np.uint8)
    lengths = np.zeros(n, dtype=np.int32)
    has_qual = np.zeros(n, dtype=bool)
    for i, (_name_, s, q) in enumerate(records):
        ln = len(s)
        lengths[i] = ln
        seq[i, :ln] = np.frombuffer(s, dtype=np.uint8)
        if q is not None:
            qual[i, :ln] = np.frombuffer(q, dtype=np.uint8)
            has_qual[i] = True
    return PaddedReads(seq=seq, qual=qual, lengths=lengths, has_qual=has_qual)


def read_fastx_padded(path, max_records: Optional[int] = None
                      ) -> PaddedReads:
    """A whole file (at most ``max_records`` records) as one padded
    batch: :func:`pad_records` of :func:`read_fastx`."""
    return pad_records(read_fastx(path, max_records))
