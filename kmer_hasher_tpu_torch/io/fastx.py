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
  can form no valid window on any filtering path.

Byte-range slicing and the native C++ reader wait for a later change.
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
            # spans lines until the '+' separator; quality bytes accumulate
            # until they reach the sequence's length
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
                while qlen < len(seq):
                    qline = buf.readline()
                    if not qline:
                        break
                    qchunks.append(qline.rstrip(b"\r\n"))
                    qlen += len(qchunks[-1])
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
