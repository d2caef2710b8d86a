"""Plain reference of the human 30x counting configuration: the same
semantics as ``wgs151_k21``'s (the float64 quality-likelihood filter,
canonical k-mers, their counts and the spectrum), in plain PyTorch. Spilling
and the ranged fold are the program's; the reference counts every read in
one table."""
from __future__ import annotations

from .wgs151_k21 import count_table, spectrum  # noqa: F401
