"""Position-parallel k-mer encoding (PyTorch port of
``kmer_hasher_tpu/ops/encode.py``, index path).

Every window start computes its packed k-mer independently by a log2(k)
shift-OR doubling pyramid, as in the JAX package. This module is the plain
version: tensor ops that run on any device. :func:`encode_stream` sends
CUDA tensors through the hand-written kernel B1 (``ops/cuda_encode.py``).

Representation: a k-mer (k <= 32) is ONE int64 holding the raw 2k-bit
pattern, first base in the highest pair of bits — the JAX package's
``(hi << 32) | lo``. At k == 32 the pattern fills all 64 bits, so the sign
bit is a data bit: order and search through :func:`sortable_key`
(``raw ^ (1 << 63)``), whose signed order is the unsigned order of the raw
patterns. Right shifts of a raw pattern are arithmetic; mask after them.

Base encoding matches the reference: ``code(c) = (c >> 1) & 3`` maps A->0
C->1 T->2 G->3 for both cases; N detection is ``(c | 0x20) == 'n'``.
Functions work on the last axis and broadcast over a leading batch axis.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

SIGN = torch.iinfo(torch.int64).min  # the bit pattern 1 << 63 as an int64


def sortable_key(raw: torch.Tensor) -> torch.Tensor:
    """Raw 2k-bit patterns -> int64 keys whose signed order is the unsigned
    order of the patterns. The map is its own inverse."""
    return raw ^ SIGN


def split_hi_lo(raw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``(hi, lo)`` uint32 lanes of raw patterns, as int64
    tensors holding values in [0, 2^32)."""
    return (raw >> 32) & 0xFFFFFFFF, raw & 0xFFFFFFFF


def base_codes(ascii_u8: torch.Tensor) -> torch.Tensor:
    """ASCII bytes -> 2-bit codes, int64."""
    return (ascii_u8.to(torch.int64) >> 1) & 3


def n_flags(ascii_u8: torch.Tensor) -> torch.Tensor:
    """True where the byte is n/N."""
    return (ascii_u8 | 0x20) == ord("n")


def _advance(x: torch.Tensor, s: int) -> torch.Tensor:
    """out[..., i] = x[..., i+s], zero past the end of the last axis."""
    if s == 0:
        return x
    out = torch.zeros_like(x)
    L = x.shape[-1]
    if s < L:
        out[..., : L - s] = x[..., s:]
    return out


def _power_codes(codes: torch.Tensor, max_w: int) -> Dict[int, torch.Tensor]:
    """Doubling pyramid: pw[w][..., i] = codes[..., i..i+w-1] packed
    big-endian into the low 2w bits, for powers of two w <= max_w (<= 32:
    one int64 holds 32 bases). Past the end the codes read as 0."""
    pw = {1: codes}
    w = 1
    while w * 2 <= max_w:
        c = pw[w]
        pw[2 * w] = (c << (2 * w)) | _advance(c, w)
        w *= 2
    return pw


def _compose(pw: Dict[int, torch.Tensor], w: int) -> torch.Tensor:
    """out[..., i] = codes[..., i..i+w-1] packed, from the power pyramid."""
    acc = None
    off = 0
    for p in (32, 16, 8, 4, 2, 1):
        if w & p:
            part = pw[p]
            if acc is None:
                acc = part
            else:
                acc = (acc << (2 * p)) | _advance(part, off)
            off += p
    return acc


def encode_windows(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Raw forward k-mer (int64) starting at every position; windows that
    run past the end read zero codes there (mask with :func:`window_valid`).
    """
    if not 1 <= k <= 32:
        raise ValueError("k must be in 1..32")
    key = _compose(_power_codes(codes, k), k)
    if k < 32:
        key = key & ((1 << (2 * k)) - 1)
    return key


def window_any(flags: torch.Tensor, k: int) -> torch.Tensor:
    """out[..., i] = any(flags[..., i..i+k-1]) by OR-doubling (False past
    the end of the last axis)."""
    pw = {1: flags}
    w = 1
    while w * 2 <= k:
        f = pw[w]
        pw[2 * w] = f | _advance(f, w)
        w *= 2
    acc = None
    off = 0
    for p in (32, 16, 8, 4, 2, 1):
        if k & p:
            part = pw[p]
            acc = part if acc is None else acc | _advance(part, off)
            off += p
    return acc


def _lengths(true_len, like: torch.Tensor) -> torch.Tensor:
    """A scalar or per-row length as an int64 tensor broadcastable against
    the window axis of ``like``."""
    tl = torch.as_tensor(true_len, dtype=torch.int64, device=like.device)
    return tl.unsqueeze(-1) if tl.dim() else tl


def window_valid(ascii_u8: torch.Tensor, k: int, true_len,
                 drop_trailing_exact_k: bool = False) -> torch.Tensor:
    """Validity over window starts: no N in [i, i+k) and i + k <= true_len.

    ``drop_trailing_exact_k`` reproduces the reference quirk of the
    forward-streaming paths (position index, seq.kmer.pos): a window that
    ends exactly at the end of the sequence and starts a fresh valid region
    (preceded by N, or at position 0) is dropped (src/kmer_pos.c:81-84).
    """
    L = ascii_u8.shape[-1]
    nf = n_flags(ascii_u8)
    idx = torch.arange(L, dtype=torch.int64, device=ascii_u8.device)
    tl = _lengths(true_len, ascii_u8)
    valid = ~window_any(nf, k) & (idx + k <= tl)
    if drop_trailing_exact_k:
        prev_is_n = torch.ones_like(nf)
        prev_is_n[..., 1:] = nf[..., :-1]
        valid &= ~((idx + k == tl) & prev_is_n)
    return valid


def drop_trailing_mask(ascii_u8: torch.Tensor, k: int,
                       true_len) -> torch.Tensor:
    """False exactly at the window starts the trailing-exact-k quirk drops
    (see :func:`window_valid`), True elsewhere. 1-D with a scalar length or
    [B, L] with one length per row. Applied after the B1 kernel, which
    does not know the quirk."""
    L = ascii_u8.shape[-1]
    idx = torch.arange(L, dtype=torch.int64, device=ascii_u8.device)
    # a scalar from the host stays a host 0-d tensor: ops on the card take
    # it as an operand and indexing reads it on the host, so nothing is
    # uploaded and the host does not wait for the card
    host = ascii_u8.dim() == 1 and not isinstance(true_len, torch.Tensor)
    tl = torch.as_tensor(true_len, dtype=torch.int64,
                         device="cpu" if host else ascii_u8.device)
    a = (tl - k).clamp(0, L - 1)
    prev_at = (a - 1).clamp(0, L - 1)
    if ascii_u8.dim() == 1:
        prev = ascii_u8[prev_at]
    else:
        prev = ascii_u8.gather(-1, prev_at.unsqueeze(-1)).squeeze(-1)
        tl, a, prev = tl.unsqueeze(-1), a.unsqueeze(-1), prev.unsqueeze(-1)
    prev_is_n = (a == 0) | ((prev | 0x20) == ord("n"))
    return ~((idx == tl - k) & prev_is_n)


def _rev_groups(x: torch.Tensor) -> torch.Tensor:
    """Reverse the order of the thirty-two 2-bit groups of each int64.
    Right shifts are arithmetic, so every one is masked after shifting."""
    for s, m in ((32, 0x00000000FFFFFFFF), (16, 0x0000FFFF0000FFFF),
                 (8, 0x00FF00FF00FF00FF), (4, 0x0F0F0F0F0F0F0F0F),
                 (2, 0x3333333333333333)):
        x = ((x >> s) & m) | ((x & m) << s)
    return x


def revcomp_windows(raw: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of raw k-mer patterns, position-parallel:
    complement is xor 0b10 per 2-bit group, order is the full 64-bit group
    reversal, then a logical shift right by 64 - 2k (the reference keeps a
    second rolling register instead, src/kmer_util.h:9)."""
    r = _rev_groups(raw ^ -0x5555555555555556)  # the pattern 0xAAAA...AAAA
    if k == 32:
        return r
    return (r >> (64 - 2 * k)) & ((1 << (2 * k)) - 1)


def canonical_windows(fwd: torch.Tensor, rc: torch.Tensor) -> torch.Tensor:
    """min(fwd, rc) per window as unsigned 2k-bit numbers (the semantics of
    src/kmer_reader.c:30): compared through :func:`sortable_key`, because at
    k == 32 the raw int64 order is not the unsigned order."""
    return torch.where(sortable_key(fwd) <= sortable_key(rc), fwd, rc)


def encode_stream(ascii_u8: torch.Tensor, k: int, true_len,
                  canonical: bool = False,
                  drop_trailing_exact_k: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full encode: ASCII bytes -> (raw key int64, valid bool) per window
    start, for a 1-D sequence (scalar ``true_len``) or a [B, L] batch (one
    length per row). ``canonical`` gives min(forward, reverse complement).

    A CUDA tensor runs the B1 kernel, a CPU tensor its plain version (the
    functions above); the two are bitwise equal. The trailing-exact-k quirk
    is a mask applied afterwards, as in the JAX package.
    """
    from .cuda_encode import encode

    key, valid = encode(ascii_u8, k, true_len)
    if drop_trailing_exact_k:
        valid &= drop_trailing_mask(ascii_u8, k, true_len)
    if canonical:
        key = canonical_windows(key, revcomp_windows(key, k))
    return key, valid
