"""The quality-likelihood iterator as a batched finite-state scan (PyTorch
port of ``kmer_hasher_tpu/ops/scan_iter.py``, ``ll_scan`` part).

The reference walks each read with a stateful iterator whose accept/reject
decisions depend on data-dependent restarts (src/kmer_util.c:95-161): a
window is accepted iff its running log-likelihood beats ``min_ll``, with
two quirks kept bit for bit — the (k+1)-th base's ll pollutes the window
sum during builds (src/kmer_util.c:104), and the rolling update subtracts
the previous *new* base, not the base leaving the window, which telescopes
the sum to ``ll(first k-1 of last build) + ll(newest)``
(src/kmer_util.c:150). N is not checked on this path.

:func:`ll_scan` here is a Python loop over base positions on [B]-shaped
tensors. It is the **plain version of kernel B2** (``csrc/ll_scan.cu``,
wrapper ``ops/cuda_scan.py``): what CPU tensors run, and what the kernel is
held against on the card. Per position p it gives, for the window ending
at p: ``emit`` (bool) and the forward and reverse-complement registers as
raw int64 patterns (see ``ops/encode.py``), defined at every position —
where the FSM takes no base the registers keep their value. The RC
register is bottom-aligned: the new complement base enters at bit 2k-2.

Three precisions, as in the JAX package: ``"exact"`` gathers the f64
``Q_TO_LL`` table and reproduces the C double arithmetic; ``"fast"`` runs
in f32 over a 256-entry f32 table; ``"fast"`` with ``return_flags`` also
tracks two f32 error lanes and flags every read any of whose comparisons
fell within its tracked error bound of the threshold, so that re-running
only the flagged reads exactly reproduces the exact result (hybrid mode).

The f32 table is evaluated ONCE on the host with numpy float32
(``log1p(-exp(q * -ln10/10))``) and uploaded, so the card and the CPU use
the same bits; the JAX package evaluates the same formula on its backend.
The hybrid bound (:func:`_rel_bound`) and the ``q == min_q`` threshold
(:func:`fast_min_ll`) are derived from that very table. ``threshold_scan``
waits for a later change.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..qll import Q_TO_LL

_LN10_OVER_10 = 0.23025850929940458

# The reference's low-quality sentinel: Q_TO_LL['!' and below] = log(DBL_MIN)
# (src/Q_to_log_likelihood.h:8). The fast path uses the same value, so the
# sentinel contributes no table-vs-analytic error.
_LL_SENTINEL = float(Q_TO_LL[33])

_ABS0 = 2.0 ** -39  # absolute floor of the per-term error bound
_EPS32 = 2.0 ** -24


def analytic_ll_f32(qual_u8) -> np.ndarray:
    """Float32 log-likelihood computed arithmetically on the host:
    ``log1p(-10**(-(q-33)/10))`` in numpy float32, with the table's
    sentinel for phred <= 0 — the formula behind ``Q_TO_LL``."""
    q = np.asarray(qual_u8).astype(np.float32) - np.float32(33.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        raw = np.log1p(-np.exp(q * np.float32(-_LN10_OVER_10)))
    return np.where(q <= 0, np.float32(_LL_SENTINEL), raw).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _ll_table_bytes() -> bytes:
    return analytic_ll_f32(np.arange(256, dtype=np.uint8)).tobytes()


def ll_table_f32() -> np.ndarray:
    """The port's 256-entry f32 table, one value per quality character."""
    return np.frombuffer(_ll_table_bytes(), np.float32)


def _rel_bound_of(table32: np.ndarray) -> float:
    """RELATIVE error bound between the exact path's f64 table terms and
    the f32 terms of ``table32``: |t[q] - T[q]| <= rel*|t[q]| + _ABS0 for
    every non-sentinel q (sentinel terms are the same constant in both
    paths). All ll terms share a sign, so a partial sum's term error is
    bounded by rel*|sum|. Measured, then 2x margin + 2^-21; _ABS0 covers
    the table's exact-0.0 tail (q >~ 160).

    Also checks what the ``q == min_q`` exemptions of :func:`ll_scan` need:
    the f32 map must be monotone, and injective wherever the f64 table is,
    so that a term bitwise equal to the threshold implies q == min_q.
    """
    table = Q_TO_LL[34:]
    t = np.asarray(table32, np.float32)[34:].astype(np.float64)
    d = np.maximum(np.abs(table - t) - _ABS0 / 2, 0.0)
    den = np.maximum(np.maximum(np.abs(table), np.abs(t)), 1e-30)
    rel = float(np.max(d / den))
    d32 = np.diff(t)
    if (d32 < 0.0).any():
        i = int(np.argmax(d32 < 0.0))
        raise AssertionError(
            f"the f32 ll table is not monotone at q={34 + i}: the "
            "q == min_q bitwise-equality exemptions are not sound")
    collide = (np.diff(table) != 0.0) & (d32 == 0.0)
    if collide.any():
        i = int(np.argmax(collide))
        raise AssertionError(
            f"the f32 ll table collides distinct Q_TO_LL entries at "
            f"q={34 + i}/{35 + i}: the q == min_q bitwise-equality "
            "exemptions are not sound")
    return 2.0 * rel + 2.0 ** -21


@functools.lru_cache(maxsize=None)
def _rel_bound() -> float:
    """:func:`_rel_bound_of` the port's own table."""
    return _rel_bound_of(ll_table_f32())


def fast_min_ll(min_q_char: int) -> float:
    """The fast path's comparison threshold for ``min_q``: the f32 table's
    own entry for that character, so a base with q == min_q compares EQUAL
    (never accepted by the strict inequalities, src/kmer_util.c:104,116,
    153), as it does in the exact path. The f32 cast of the f64 table value
    differs from it by about an ulp and would make every such base
    borderline."""
    return float(ll_table_f32()[int(min_q_char)])


class ScanConsts(NamedTuple):
    """What one scan needs besides the reads: the ll table in the scan's
    float type, the threshold, and (flags only) the error-bound constants
    as f32 values."""
    table: np.ndarray  # [256] float64 or float32
    min_ll: float
    rel: float
    merr: float


def scan_consts(min_ll: float, precision: str, return_flags: bool,
                min_q_char: Optional[int], ll_table=None,
                rel_bound: Optional[float] = None) -> ScanConsts:
    """Resolve the constants of :func:`ll_scan` — shared with the B2
    wrapper so kernel and plain version see the same bits.

    ``ll_table`` / ``rel_bound`` replace the port's own f32 table and its
    bound (a test hands over the JAX package's values to compare bit for
    bit); the bound is derived from the given table unless stated."""
    if precision not in ("exact", "fast"):
        raise ValueError(f"unknown precision {precision!r}")
    if precision == "exact":
        if return_flags:
            raise ValueError("return_flags needs precision='fast'")
        return ScanConsts(Q_TO_LL, float(min_ll), 0.0, 0.0)
    f32 = np.float32
    table = ll_table_f32() if ll_table is None else np.asarray(ll_table, f32)
    if table.shape != (256,):
        raise ValueError("ll_table must hold 256 values")
    m32 = f32(min_ll) if min_q_char is None else table[int(min_q_char)]
    if not return_flags:
        return ScanConsts(table, float(m32), 0.0, 0.0)
    if rel_bound is None:
        rel_bound = _rel_bound() if ll_table is None else _rel_bound_of(table)
    rel, abs0 = f32(rel_bound), f32(_ABS0)
    # threshold error vs the exact path's f64 table value, in f32 step
    # order: the table threshold carries the per-term bound, a cast
    # threshold only the cast rounding
    if min_q_char is not None:
        merr = f32(f32(rel * np.abs(m32)) + abs0)
    else:
        merr = f32(f32(f32(_EPS32) * np.abs(m32)) + abs0)
    return ScanConsts(table, float(m32), float(rel), float(merr))


def ll_scan(ascii_u8: torch.Tensor, qual_u8: torch.Tensor,
            lengths: torch.Tensor, k: int, min_ll: float,
            precision: str = "exact", return_flags: bool = False,
            min_q_char: Optional[int] = None, ll_table=None,
            rel_bound: Optional[float] = None) -> Tuple[torch.Tensor, ...]:
    """Quality-likelihood iterator over a padded read batch, on any device.

    ascii_u8 / qual_u8: [B, L] uint8; lengths: [B]. Returns (emit bool
    [B, L], fwd int64 [B, L], rc int64 [B, L]) and, with ``return_flags``,
    the per-read borderline flag (bool [B]); column p describes the window
    ending at position p. Reads with length <= k emit nothing and positions
    past a read's end leave its state untouched.

    ``min_q_char``: when given (fast precision), the threshold becomes the
    f32 table's own entry for that quality character (:func:`fast_min_ll`)
    — pass it whenever ``min_ll`` is a ``Q_TO_LL`` entry; the flag's
    exemptions depend on it.

    The flag (see the JAX package's ``ll_scan`` for the derivation): the
    scan carries two f32 lanes ``aerr``/``eerr`` bounding |acc_f32 -
    acc_f64| and |emitC_f32 - emitC_f64| under the induction that every
    comparison so far agreed with the exact path. Every f32 add in the
    value path adds ``eps32 * |rounded result|`` to its lane; every table
    term entering a value adds ``rel*|term| + _ABS0``. A comparison value v
    flags the read iff ``|v - min_ll| <= err(v) + merr``. Each product and
    sum below is one rounded f32 operation, in this order; B2 repeats them
    one for one (its build turns multiply-add contraction off).
    """
    if ascii_u8.dim() != 2 or qual_u8.shape != ascii_u8.shape:
        raise ValueError("expected [B, L] bases and qualities of one shape")
    if not 1 <= k <= 32:
        raise ValueError("k must be in 1..32")
    B, L = ascii_u8.shape
    dev = ascii_u8.device
    cst = scan_consts(min_ll, precision, return_flags, min_q_char, ll_table,
                      rel_bound)
    fdt = torch.float64 if precision == "exact" else torch.float32
    table = torch.tensor(cst.table, device=dev)
    ll = table[qual_u8.long()]  # [B, L]
    thr = torch.tensor(cst.min_ll, dtype=fdt, device=dev)
    zero = torch.zeros((), dtype=fdt, device=dev)
    lengths = lengths.to(device=dev, dtype=torch.int64)
    pos = torch.arange(L, device=dev)
    ll_next = torch.zeros_like(ll)
    ll_next[:, :-1] = ll[:, 1:]
    ll_next = torch.where((pos + 1)[None, :] < lengths[:, None], ll_next,
                          zero)
    row_on = (lengths > k)[:, None] & (pos[None, :] < lengths[:, None])
    codes = (ascii_u8.to(torch.int64) >> 1) & 3
    mask = -1 if k == 32 else (1 << (2 * k)) - 1
    top = 2 * k - 2

    rolling = torch.zeros(B, dtype=torch.bool, device=dev)
    border = torch.zeros(B, dtype=torch.bool, device=dev)
    j = torch.zeros(B, dtype=torch.int64, device=dev)
    fwd = torch.zeros(B, dtype=torch.int64, device=dev)
    rc = torch.zeros(B, dtype=torch.int64, device=dev)
    acc = torch.zeros(B, dtype=fdt, device=dev)
    emitC = torch.zeros(B, dtype=fdt, device=dev)
    out_emit = torch.zeros((B, L), dtype=torch.bool, device=dev)
    out_fwd = torch.zeros((B, L), dtype=torch.int64, device=dev)
    out_rc = torch.zeros((B, L), dtype=torch.int64, device=dev)
    if return_flags:
        f32 = torch.float32
        eps = torch.tensor(_EPS32, dtype=f32, device=dev)
        rel = torch.tensor(cst.rel, dtype=f32, device=dev)
        abs0 = torch.tensor(_ABS0, dtype=f32, device=dev)
        merr = torch.tensor(cst.merr, dtype=f32, device=dev)
        aerr = torch.zeros(B, dtype=f32, device=dev)
        eerr = torch.zeros(B, dtype=f32, device=dev)

        def near(val, err):
            return (val - thr).abs() <= err + merr

    for p in range(L):
        c, llv, llnext, on = codes[:, p], ll[:, p], ll_next[:, p], row_on[:, p]

        # rolling mode (kmer_iterator_next, src/kmer_util.c:145-161)
        v = emitC + llv
        roll_ok = rolling & ~(v < thr)
        roll_fail = rolling & (v < thr)  # consume the base, restart at p+1
        # building mode (kmer_iterator_begin, src/kmer_util.c:95-128);
        # a failed attempt is reset and retries this base fresh
        building = ~rolling
        bv = acc + llv
        ok1 = building & (bv > thr)
        ok2 = building & ~ok1 & (llv > thr)
        b_ok = ok1 | ok2
        if return_flags:
            te = rel * llv.abs() + abs0
            verr = eerr + te + eps * v.abs()
            bverr = aerr + te + eps * bv.abs()
            # q == min_q exemptions: a term bitwise equal to the threshold
            # decides FALSE in both paths; acc == 0.0 certifies bv == llv
            eq_t = llv == thr
            border = border | (
                on & ((rolling & near(v, verr))
                      | (building
                         & ((near(bv, bverr) & ~((acc == 0.0) & eq_t))
                            | (~ok1 & near(llv, te) & ~eq_t)))))
        j_base = torch.where(ok1, j, 0)
        acc_base = torch.where(ok1, acc, zero)

        take = (roll_ok | b_ok) & on
        keep = ok1 | roll_ok
        src_f = torch.where(keep, fwd, 0)
        src_r = torch.where(keep, rc, 0)
        new_f = ((src_f << 2) | c) & mask
        # >> on int64 is arithmetic: mask the two vacated top groups
        new_r = (((src_r >> 2) & 0x3FFFFFFFFFFFFFFF)
                 | ((c ^ 2) << top)) & mask
        fwd = torch.where(take, new_f, fwd)
        rc = torch.where(take, new_r, rc)

        j_new = torch.where(b_ok, j_base + 1, torch.where(building, 0, j))
        acc_new = torch.where(b_ok, acc_base + llv,
                              torch.where(building, zero, acc))
        completed = building & b_ok & (j_new == k) & on
        emit = (completed | (roll_ok & rolling)) & on

        rolling_new = torch.where(on, (rolling & ~roll_fail) | completed,
                                  rolling)
        j_new = torch.where(on, torch.where(roll_fail, 0, j_new), j)
        acc_new = torch.where(on, torch.where(roll_fail, zero, acc_new), acc)
        emitC_new = torch.where(completed, acc_new - llv + llnext,
                                torch.where(roll_fail, zero, emitC))
        if return_flags:
            # the error lanes mirror the value updates op for op
            aerr_base = torch.where(ok1, aerr, 0.0)
            aerr_new = torch.where(
                b_ok, aerr_base + te + eps * (acc_base + llv).abs(),
                torch.where(building, 0.0, aerr))
            aerr_new = torch.where(on, torch.where(roll_fail, 0.0, aerr_new),
                                   aerr)
            ecand = acc_new - llv + llnext
            ecand_err = (aerr_new + te + (rel * llnext.abs() + abs0)
                         + eps * (acc_new.abs() + llv.abs() + ecand.abs()))
            eerr = torch.where(completed, ecand_err,
                               torch.where(roll_fail, 0.0, eerr))
            aerr = aerr_new
        rolling, j, acc, emitC = rolling_new, j_new, acc_new, emitC_new
        out_emit[:, p] = emit
        out_fwd[:, p] = fwd
        out_rc[:, p] = rc
    if return_flags:
        return out_emit, out_fwd, out_rc, border
    return out_emit, out_fwd, out_rc
