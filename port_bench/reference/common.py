"""Plain PyTorch pieces that the references share.

The semantics are those of lmjakt/kmer_hasheR (the C reference), as the
port's documentation states them: a base's 2-bit code is ``(byte >> 1) & 3``
(A 0, C 1, T 2, G 3, whatever its case), a window of k bases is packed first
base highest, its reverse complement takes the codes ``xor 2`` in reverse
order, and k-mers order as unsigned 2k-bit numbers. Nothing here imports
the program.
"""
from __future__ import annotations

import json
from pathlib import Path

import torch

SIGN = -(2 ** 63)


def q_to_ll() -> list:
    """The reference's phred+33 -> log-likelihood table, 256 doubles
    (src/Q_to_log_likelihood.h): a frozen copy, since the shipped constants
    differ from ``log(1 - 10 ** (-q / 10))`` in the last bits of 150 entries
    and the filter compares sums of them with one of them."""
    return json.loads((Path(__file__).with_name("q_to_ll.json")).read_text())


def codes(seq: torch.Tensor) -> torch.Tensor:
    return (seq.to(torch.int64) >> 1) & 3


def is_n(seq: torch.Tensor, soft_mask_as_n: bool = False) -> torch.Tensor:
    """N or n; with ``soft_mask_as_n`` every lowercase byte as well (the
    control that breaks the configuration's case rule)."""
    n = (seq | 0x20) == ord("n")
    return n | (seq >= ord("a")) if soft_mask_as_n else n


def forward_keys(c: torch.Tensor, k: int) -> torch.Tensor:
    """Packed k-mer of the window starting at each start of the last axis
    (int64, the k = 32 pattern wrapping into the sign bit)."""
    w = c.shape[-1] - k + 1
    key = torch.zeros(c.shape[:-1] + (w,), dtype=torch.int64, device=c.device)
    for i in range(k):
        key = (key << 2) | c[..., i: i + w]
    return key


def revcomp_keys(c: torch.Tensor, k: int) -> torch.Tensor:
    """Packed reverse complement of the window starting at each start."""
    w = c.shape[-1] - k + 1
    key = torch.zeros(c.shape[:-1] + (w,), dtype=torch.int64, device=c.device)
    for i in range(k):
        key = key | ((c[..., i: i + w] ^ 2) << (2 * i))
    return key


def unsigned_order(key: torch.Tensor) -> torch.Tensor:
    """An int64 whose signed order is the unsigned order of ``key``."""
    return key ^ SIGN


def windows(seq: torch.Tensor, k: int, soft_mask_as_n: bool = False):
    """(forward key, valid) for every window start of a 1-D sequence:
    valid where the window holds no N and is not the trailing-exact-k
    quirk's window (the last window, where it starts the sequence or
    follows an N, is dropped: src/kmer_pos.c:81-84)."""
    n = seq.shape[0]
    flag = is_n(seq, soft_mask_as_n)
    before = torch.zeros(n + 1, dtype=torch.int64, device=seq.device)
    before[1:] = torch.cumsum(flag.to(torch.int64), 0)
    w = n - k + 1
    valid = before[k: k + w] == before[:w]
    last = w - 1
    if last == 0 or bool(flag[last - 1]):
        valid[last] = False
    return forward_keys(codes(seq), k), valid
