"""Sequence file readers of the port."""
from .fastx import (PaddedReads, Record, iter_fastx, pad_records,
                    read_fastx)

__all__ = ["PaddedReads", "Record", "iter_fastx", "pad_records",
           "read_fastx"]
