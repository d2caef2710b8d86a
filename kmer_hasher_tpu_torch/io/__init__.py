"""Sequence file readers of the port: the pure-Python reader (``fastx``)
and the binding of the native C++ parser (``native``, built at first use)."""
from .fastx import (PaddedReads, Record, find_record_boundary, is_fourline_fastq,
                    is_gzip, iter_fastx, iter_fastx_range, pad_records,
                    read_fastx, read_fastx_padded)

__all__ = ["PaddedReads", "Record", "find_record_boundary",
           "is_fourline_fastq", "is_gzip", "iter_fastx", "iter_fastx_range",
           "pad_records", "read_fastx", "read_fastx_padded"]
