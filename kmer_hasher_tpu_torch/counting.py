"""High-level counting entries (PyTorch port of
``kmer_hasher_tpu/counting.py``) — analogues of the reference's
``count.kmers*`` R surface (kmer_hash.R:43-96, src/kmer_hash.c:548-857).

Reads stream through the quality-likelihood FSM (kernel B2 on the card,
``ops/cuda_scan.py``) or, where a record has no qualities, through the
position-parallel encoder (kernel B1), are canonicalised where the
reference canonicalises, and merge into a :class:`CountStore`.

Ported: ``count_kmers``, the flagship ``count_kmers_fq_sh_rp`` on one
device, the per-base-threshold entries ``count_kmers_fq`` (kmer_tree
store) and ``count_kmers_fq_sh`` over ``ops.scan_iter.threshold_scan``, and
``seq_kmer_depth`` in both semantics. Every store they fill merges its
tiers through kernel B3; a store made with ``spill_bytes`` spills and
rejoins its runs as the entries fill it, and ``count_kmers_fq`` takes
``budget_semantics="drop"``.

Every file entry reads through :func:`_iter_file_batches`: the native C++
parser where it builds (``io/native.py``), else the pure-Python reader, one
batch ahead in a producer thread; ``_device_batches`` stages the padded
byte planes through pinned buffers. Which reader ran, and what the reading
cost, is in ``store.timings`` (``reader``, ``parse_s``, ``wait_s``,
``copy_s``, ``h2d_bytes``, ``file_reads``, ``flagged_reads``).
``count_kmers_fq_sh_rp(mesh=)`` counts into a
``parallel.ShardedCountStore`` on a shard group's shards
(:func:`_count_rp_sharded`), through the same loop; over a group spread
over several devices of one process each batch's rows are dealt to the
devices (``ShardedCountStore.add_reads``); over a group that spans
processes, every rank parses its own part of the input (a share
of a file list, a byte range of one plain FASTQ) or, where neither can be
cut, its own rows of every batch, and the store's timings are the rank's
own.
"""
from __future__ import annotations

import os
import queue
import threading
import time
import warnings
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .index import count_store as cs
from .index.count_store import CountStore
from .index.position_index import as_sequence
from .io import native
from .io.fastx import (is_fourline_fastq, is_gzip, iter_fastx,
                       iter_fastx_range, pad_records)
from .ops import cuda_scan
from .ops import encode as enc
from .ops import scan_iter as si
from .qll import Q_TO_LL
from .utils.trace import span

MAX_K = 32
BATCH_ROWS = 1 << 15  # reads per batch of the file entries
_SWEEP_EVERY = 64  # batches between exact re-counts of flagged reads
_NA = -(2 ** 31)  # INT_MIN, R's NA_integer_
# the batch uploads' stream, one a card for the process: the caching
# allocator keeps a stream's freed blocks for that stream alone, so a new
# stream a call would allocate every batch anew
_COPY_STREAMS: dict = {}


def win_bucket(lmax: int, k: int) -> int:
    """Window-axis trim for a batch: the true max read length rounded up to
    a multiple of 16, minus the k-1 window offset — the JAX package's one
    definition, kept so both trim alike."""
    return max(1, -(-max(1, int(lmax)) // 16) * 16 - k + 1)


def derive_prefix_suffix_bits(k: int, prefix_bits: int) -> Tuple[int, int]:
    """Reader-pool bit split (src/kmer_reader.c:86-95), clamped sanely."""
    total = 2 * k
    prefix_bits = min(prefix_bits, 36, total)
    suffix_bits = total - prefix_bits
    if suffix_bits > 32:
        suffix_bits = 32
        prefix_bits = total - 32
    return prefix_bits, suffix_bits


def _normalize_paths(path) -> Optional[List[str]]:
    """None for a single path-like input; a non-empty list of str paths
    when the caller passed a sequence of files."""
    if isinstance(path, (str, bytes, os.PathLike)):
        return None
    paths = [os.fspath(p) for p in path]
    if not paths:
        raise ValueError("empty file list")
    return paths


def _prefetch(it: Iterator, depth: int, info: dict) -> Iterator:
    """``it`` run in one producer thread, ``depth`` items ahead: the parse
    of batch N+1 overlaps the device work on batch N (the C++ calls release
    the GIL). ``info["parse_s"]`` accumulates the seconds the producer spent
    making items, ``info["wait_s"]`` those the consumer spent waiting for
    one. An error in the producer is raised in the consumer; a consumer that
    stops early stops the producer. The thread is joined before return."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    item = done
                info["parse_s"] = info.get("parse_s", 0.0) + (
                    time.perf_counter() - t0)
                if not put(item) or item is done:
                    return
        except BaseException as e:  # raised again by the consumer
            put(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()  # a reader left half-way closes its file

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            t0 = time.perf_counter()
            with span("kmh.io.wait"):
                item = q.get()
            info["wait_s"] = info.get("wait_s", 0.0) + (
                time.perf_counter() - t0)
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join()


def _batch_rows(batch_rows: Optional[int]) -> int:
    """Reads per batch: ``batch_rows``, else ``KMH_BATCH_ROWS`` (read at
    call time), else :data:`BATCH_ROWS`."""
    if batch_rows is None:
        batch_rows = int(os.environ.get("KMH_BATCH_ROWS", BATCH_ROWS))
    return int(batch_rows)


def _iter_file_batches(path, max_reads: Optional[int], skip: int = 0,
                       batch_rows: Optional[int] = None,
                       info: Optional[dict] = None,
                       byte_range: Optional[Tuple[int, int]] = None,
                       range_info: Optional[dict] = None
                       ) -> Iterator[Tuple[np.ndarray, ...]]:
    """Host (seq, qual, lengths, has_qual) batches of a FASTA/FASTQ file,
    one batch ahead in a producer thread. A batch's rows are its reads; its
    columns the multiple of 8 that holds the longest. ``skip`` discards the
    first N records (mid-file resume); ``max_reads`` then limits the records
    yielded after the skip. ``batch_rows`` as :func:`_batch_rows` reads it.

    ``byte_range=(start, end)`` reads only the records whose first byte
    falls in [start, end) of a plain file (neither ``skip`` nor
    ``max_reads`` then); ``range_info`` receives the resolved record
    boundaries, ``start`` at once and ``end`` when the file is drained.

    The native parser pads the planes in C++; where it did not build, or
    with ``KMH_NATIVE_IO=0``, the pure-Python reader does. ``info`` receives
    ``reader`` ("native" or "python") and the producer's ``parse_s`` / the
    consumer's ``wait_s``."""
    if max_reads is not None and max_reads < 0:
        max_reads = None
    if byte_range is not None and (skip or max_reads is not None):
        raise ValueError("a byte range takes neither skip nor max_reads")
    batch_rows = _batch_rows(batch_rows)
    info = {} if info is None else info
    info["reader"] = native.reader_name()

    def produce():
        if info["reader"] == "native":
            yield from native.iter_fastx_padded(
                path, batch_rows, max_reads, skip, byte_range=byte_range,
                range_info=range_info)
            return
        if byte_range is not None:
            for recs in iter_fastx_range(path, *byte_range, batch_rows,
                                         range_info):
                padded = pad_records(recs, pad_to_multiple=8)
                yield (padded.seq, padded.qual, padded.lengths,
                       padded.has_qual)
            return
        limit = None if max_reads is None else skip + max_reads
        to_skip = skip
        for recs in iter_fastx(path, batch_size=batch_rows,
                               max_records=limit):
            if to_skip >= len(recs):
                to_skip -= len(recs)
                continue
            if to_skip:
                recs, to_skip = recs[to_skip:], 0
            padded = pad_records(recs, pad_to_multiple=8)
            yield padded.seq, padded.qual, padded.lengths, padded.has_qual

    yield from _prefetch(produce(), 2, info)


def _copy_stream(dev: torch.device) -> "torch.cuda.Stream":
    """The card's one copy stream, made on first use."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = _COPY_STREAMS.get(idx)
    if stream is None:
        stream = _COPY_STREAMS[idx] = torch.cuda.Stream(idx)
    return stream


def _device_batches(batches: Iterable, dev: torch.device,
                    stats: Optional[dict] = None):
    """Batches for the counting loop: each a (seq, qual, lengths, has_qual)
    tuple of host numpy arrays or of tensors, optionally with a fifth item,
    the records the batch stands for (over processes, every rank's; else
    its rows). Yields (the four as tensors on ``dev``, lengths and has_qual
    as host numpy arrays for control flow, the records).

    Host batches reach a card through pinned buffers on the card's copy
    stream (:func:`_copy_stream`), one batch ahead: the copy of batch N+1
    overlaps the device work on batch N.
    Two sets of pinned buffers are kept and reused in turn (one per batch
    in flight), each grown to the largest batch it has held. ``stats``
    accumulates ``h2d_bytes`` (bytes sent from the host) and ``copy_s`` (the
    host's seconds staging and enqueueing them).
    """
    def host_view(b):
        len_h, hq_h = (a.cpu().numpy() if isinstance(a, torch.Tensor)
                       else np.asarray(a) for a in (b[2], b[3]))
        return len_h, hq_h, int(b[4]) if len(b) > 4 else len(len_h)

    if dev.type != "cuda":
        for b in batches:
            with span("kmh.count.stage"):
                out = (tuple(torch.as_tensor(a).to(dev) for a in b[:4]),
                       *host_view(b))
            yield out
        return
    copy = _copy_stream(dev)
    slots = [{"bufs": {}, "done": None} for _ in range(2)]
    turn = 0

    def staged(slot, i, src):
        """``src`` copied into the slot's i-th pinned buffer."""
        buf = slot["bufs"].get(i)
        if buf is None or buf.dtype != src.dtype or buf.numel() < src.numel():
            buf = torch.empty(src.numel(), dtype=src.dtype, pin_memory=True)
            slot["bufs"][i] = buf
        out = buf[: src.numel()].view(src.shape)
        out.copy_(src)
        return out

    def ship(b):
        nonlocal turn
        with span("kmh.count.stage"):
            host = host_view(b)
            b = b[:4]
            if all(isinstance(a, torch.Tensor) and a.is_cuda for a in b):
                # staged on a card already ("cuda" names the current one)
                return tuple(a.to(dev) for a in b), None, host
            t0 = time.perf_counter()
            slot = slots[turn]
            turn ^= 1
            if slot["done"] is not None:
                slot["done"].synchronize()  # its last copy has left them
            with torch.cuda.stream(copy):
                out = tuple(staged(slot, i, torch.as_tensor(a))
                            .to(dev, non_blocking=True)
                            for i, a in enumerate(b))
                slot["done"] = torch.cuda.Event()
                slot["done"].record(copy)
            if stats is not None:
                stats["h2d_bytes"] = stats.get("h2d_bytes", 0) + sum(
                    t.numel() * t.element_size() for t in out)
                stats["copy_s"] = stats.get("copy_s", 0.0) + (
                    time.perf_counter() - t0)
            return out, slot["done"], host

    it = iter(batches)
    nxt = next(it, None)
    nxt = ship(nxt) if nxt is not None else None
    while nxt is not None:
        cur = nxt
        b = next(it, None)
        nxt = ship(b) if b is not None else None
        out, done, host = cur
        if done is not None:
            here = torch.cuda.current_stream(dev)
            here.wait_event(done)
            for t in out:
                t.record_stream(here)
        yield (out, *host)


def _fused_rp_batch(seq: torch.Tensor, qual: torch.Tensor,
                    lengths: torch.Tensor, has_qual: torch.Tensor, k: int,
                    counts_n: int, source: int, min_ll_f: float, fsm: str,
                    with_noq: bool = False,
                    min_q_char: Optional[int] = None,
                    n_win: Optional[int] = None):
    """The whole flagship batch pipeline on the tensors' device:
    quality-likelihood FSM (+ no-quality rows through the encoder) ->
    canonical min(fwd, rc) -> sort + segment-reduce -> LSM run.

    ``fsm`` is "exact" (f64), "fast" (f32) or "hybrid" (f32 with borderline
    flags: flagged reads contribute NOTHING here; the caller re-counts them
    exactly). Returns (run_keys, run_cnt, n_obs, flags, n_flag): a run as
    ``CountStore.add_run`` takes it, the number of observations in it, the
    per-read flags and their sum as a tensor (no sync for it here).

    ``n_win`` trims the window-start axis to the batch's true maximum:
    window starts past ``true_max_len - k`` can never emit.
    """
    if fsm not in ("exact", "fast", "hybrid"):
        raise ValueError(f"unknown fsm {fsm!r}")
    lens_q = torch.where(has_qual, lengths, 0)
    if fsm == "hybrid":
        emit, fwd, rc, flags = cuda_scan.scan(
            seq, qual, lens_q, k, min_ll_f, precision="fast",
            return_flags=True, min_q_char=min_q_char)
        emit = emit & ~flags[:, None]
    else:
        emit, fwd, rc = cuda_scan.scan(seq, qual, lens_q, k, min_ll_f,
                                       precision=fsm)
        flags = torch.zeros(seq.shape[0], dtype=torch.bool,
                            device=seq.device)
    key = enc.canonical_windows(fwd, rc)
    # FSM windows are END-aligned (column p = the window ending at p):
    # columns < k-1 hold no full window yet, and with ``n_win`` the columns
    # from the true max length on never emit — keep [k-1, n_win + k - 1),
    # whose column c is the window STARTING at c, like the encoder's
    end = emit.shape[1] if n_win is None else min(n_win + k - 1,
                                                   emit.shape[1])
    emit, key = emit[:, k - 1:end], key[:, k - 1:end]
    emit = emit & has_qual[:, None]
    if with_noq:
        no_q = ~has_qual & (lengths > k)
        key2, v2 = enc.encode_stream(seq, k, torch.where(no_q, lengths, 0),
                                     canonical=True)
        nw = emit.shape[1]
        key = torch.where(has_qual[:, None], key, key2[:, :nw])
        emit = emit | v2[:, :nw]
    obs = enc.sortable_key(key[emit])
    run_keys, run_cnt = cs.build_run(obs, counts_n, source)
    return run_keys, run_cnt, int(obs.shape[0]), flags, flags.sum()


def _compact_flagged(seq, qual, lengths, flags):
    """A batch's flagged rows as a small [n_flagged, L] batch, gathered on
    the device."""
    idx = torch.nonzero(flags).squeeze(1)
    return seq[idx], qual[idx], lengths[idx]


def _spans_processes(store) -> bool:
    """True for a sharded store whose group spans several processes: its
    every add is a collective."""
    mesh = getattr(store, "mesh", None)
    return mesh is not None and mesh.distributed


def _add_empty(store, source: int = 0) -> None:
    """An add of no rows: nothing for one process; over processes this
    rank's turn in an exchange every rank makes."""
    store.add_run(torch.empty(0, dtype=torch.int64, device=store.device),
                  torch.empty((0, store.counts_n), dtype=torch.int64,
                              device=store.device), 0, source=source)


def _host_ints(scalars: List[torch.Tensor]) -> List[int]:
    """Scalar tensors as host ints, one readback a device (the backlog of a
    store over several devices holds each device's blocks)."""
    out = [0] * len(scalars)
    by_dev: dict = {}
    for i, t in enumerate(scalars):
        by_dev.setdefault(t.device, []).append(i)
    for idx in by_dev.values():
        for i, v in zip(idx, torch.stack([scalars[i] for i in idx])
                        .cpu().tolist()):
            out[i] = v
    return out


def _sweep_backlog(store: CountStore, backlog: list, k: int, source: int,
                   min_ll_f: float) -> int:
    """Re-count the borderline-flagged reads exactly (f64), emptying
    ``backlog`` ([(seq, qual, lengths, flags, n_win, n_flag)] batches on
    the device); returns how many reads that were. One readback of the
    stacked per-batch flag counts decides what re-runs; each batch with
    flagged reads compacts them on the device and exact-scans only those.
    Hybrid thus stays bitwise equal to ``exact_ll=True``.

    For a store over several processes, where ranks flag reads in
    different batches, every sweep is one add on every rank: the flagged
    reads of all batches, padded to the widest, in one exact scan on the
    store's home device (or an empty add where the rank has none). In one
    process over several devices each device's blocks are re-counted on
    that device."""
    collective = _spans_processes(store)
    if not backlog and not collective:
        return 0
    n_flags = _host_ints([b[5] for b in backlog])
    picked = []
    for (seq_b, qual_b, len_b, f_b, n_win, _n), nf in zip(backlog, n_flags):
        if nf == 0:
            continue
        seq_c, qual_c, len_c = _compact_flagged(seq_b, qual_b, len_b, f_b)
        if collective:
            picked.append((seq_c, qual_c, len_c, n_win))
            continue
        r = _fused_rp_batch(seq_c, qual_c, len_c,
                            torch.ones_like(len_c, dtype=torch.bool), k,
                            store.counts_n, source, min_ll_f, "exact",
                            n_win=n_win)
        store.add_run(r[0], r[1], r[2], source=source)
    if collective:
        if picked:
            L = max(b[0].shape[1] for b in picked)
            dev = store.device  # a rank's blocks may lie on its devices
            seq_c = torch.cat([torch.nn.functional.pad(
                b[0].to(dev), (0, L - b[0].shape[1]), value=ord("N"))
                for b in picked])
            qual_c = torch.cat([torch.nn.functional.pad(
                b[1].to(dev), (0, L - b[1].shape[1])) for b in picked])
            len_c = torch.cat([b[2].to(dev) for b in picked])
            r = _fused_rp_batch(seq_c, qual_c, len_c,
                                torch.ones_like(len_c, dtype=torch.bool), k,
                                store.counts_n, source, min_ll_f, "exact",
                                n_win=max(b[3] for b in picked))
            store.add_run(r[0], r[1], r[2], source=source)
        else:
            _add_empty(store, source)
    backlog.clear()
    return sum(n_flags)


def count_kmers(seqs: Sequence[str], k: int, source: int = 0,
                source_n: int = 1, store: Optional[CountStore] = None,
                device="cuda") -> CountStore:
    """In-memory multi-source counting (``count.kmers``,
    src/kmer_hash.c:548-591): forward strand only (no canonicalisation), no
    quality, N-delimited windows with the trailing exactly-k drop;
    sequences of length <= k skipped. ``device`` places a new store; a
    given ``store`` keeps its own."""
    if not 1 <= k <= MAX_K:
        raise ValueError("k must be a positive integer less than 1+MAX_K")
    if source_n < 1 or source >= source_n:
        raise ValueError("source_n must be larger than 1 and larger than source")
    if store is None:
        store = CountStore(k, counts_n=source_n, mode="khash", device=device)
    if store.k != k:
        raise ValueError(
            "mismatch between specified k and that given in the store")
    if isinstance(seqs, (str, bytes)):
        seqs = [seqs]
    todo = [s for s in seqs if len(s) > k]
    if not todo:
        return store
    recs = [("", s.encode() if isinstance(s, str) else bytes(s), None)
            for s in todo]
    padded = pad_records(recs, pad_to_multiple=1)
    key, valid = enc.encode_stream(
        torch.from_numpy(padded.seq).to(store.device), k,
        torch.from_numpy(padded.lengths).to(store.device),
        drop_trailing_exact_k=True)
    store.add_kmers(key, valid, source=source)
    return store


def _progress(report_every: Optional[int], name: str):
    if not report_every:
        return None
    from .utils.metrics import ProgressMeter

    return ProgressMeter(name=name, report_every=report_every)


def _fsm_of(exact_ll) -> str:
    if isinstance(exact_ll, str):
        if exact_ll != "hybrid":
            raise ValueError(f"unknown exact_ll {exact_ll!r}")
        return "hybrid"
    return "exact" if exact_ll else "fast"


def count_batches(store: CountStore, batches: Iterable, k: int,
                  min_q: int = 20, source: int = 0, exact_ll=True,
                  meter=None, on_batch=None,
                  stats: Optional[dict] = None) -> CountStore:
    """The per-batch loop of :func:`count_kmers_fq_sh_rp`: every
    (seq, qual, lengths, has_qual) batch of ``batches`` — host numpy
    arrays, as the file reader gives them, or tensors already on the
    store's device — goes through :func:`_fused_rp_batch` into the store
    (a ``CountStore``; a ``ShardedCountStore`` takes the batch by
    ``add_reads``, which deals its rows to its devices and routes the
    runs);
    in hybrid mode flagged reads are re-counted exactly every
    ``_SWEEP_EVERY`` batches and at the end. Ends with a flush.

    ``on_batch(n_records, sweep)`` is called after each batch (the file
    entry checkpoints there; ``sweep()`` makes the store exact first).
    ``stats``, if given, receives ``flagged_reads``: how many reads hybrid
    mode flagged and re-counted (over processes, every rank's), and what
    :func:`_device_batches` counts (this rank's).

    A batch may carry a fifth item, the records it stands for (what
    ``on_batch`` and the meter get; its rows otherwise). A batch of no rows
    is an empty add: over processes, a rank whose input is drained still
    takes its turn in every exchange, and every rank sweeps after the same
    batches."""
    with span("kmh.count"):
        fsm = _fsm_of(exact_ll)
        min_ll_f = float(Q_TO_LL[33 + int(min_q)])
        min_q_char = 33 + int(min_q)
        backlog: list = []
        since_sweep = flagged = 0
        sharded = getattr(store, "mesh", None) is not None

        def sweep():
            nonlocal since_sweep, flagged
            since_sweep = 0
            if fsm == "hybrid":
                with span("kmh.count.sweep"):
                    flagged += _sweep_backlog(store, backlog, k, source,
                                              min_ll_f)

        for (seq, qual, lengths, has_qual), len_h, hq_h, n_recs in (
                _device_batches(batches, store.device, stats)):
            with span("kmh.count.batch"):
                if len_h.shape[0]:
                    with_noq = bool((~hq_h & (len_h > k)).any())
                    n_win = win_bucket(len_h.max(initial=1), k)
                    if sharded:  # the store deals the rows to its devices
                        store.add_reads(seq, qual, lengths, has_qual,
                                        min_ll_f, fsm, source, with_noq,
                                        min_q_char, n_win, backlog=backlog)
                    else:
                        run_keys, run_cnt, n_obs, flags, n_flag = (
                            _fused_rp_batch(
                                seq, qual, lengths, has_qual, k,
                                store.counts_n, source, min_ll_f, fsm,
                                with_noq, min_q_char=min_q_char,
                                n_win=n_win))
                        store.add_run(run_keys, run_cnt, n_obs,
                                      source=source)
                        if fsm == "hybrid":
                            backlog.append((seq, qual, lengths, flags,
                                            n_win, n_flag))
                else:
                    _add_empty(store, source)
            since_sweep += 1
            if since_sweep >= _SWEEP_EVERY:
                sweep()
            if on_batch is not None:
                on_batch(n_recs, sweep)
            if meter:
                meter.update(n_recs,
                             distinct_kmers=lambda: store.peek_n_unique())
        sweep()
        if stats is not None:
            if _spans_processes(store):
                flagged = int(store.mesh.all_sum([flagged])[0])
            stats["flagged_reads"] = stats.get("flagged_reads", 0) + flagged
        return store.flush()


def _fused_threshold_batch(seq: torch.Tensor, qual: torch.Tensor,
                           lengths: torch.Tensor, has_qual: torch.Tensor,
                           k: int, counts_n: int, min_q_char: int,
                           with_q: bool, with_noq: bool,
                           n_win: Optional[int] = None):
    """The batch pipeline of the per-base-threshold entries on the tensors'
    device: ``threshold_scan`` over the rows with qualities (``with_q``)
    and, ungated, over those without (``with_noq``) -> canonical
    min(fwd, rc) -> sort + segment-reduce -> (run_keys, run_cnt, n_obs) as
    ``CountStore.add_run`` takes them, source 0. ``n_win`` trims the
    window axis as in :func:`_fused_rp_batch`."""
    obs = []
    for wanted, gated, rows in ((with_q, True, has_qual),
                                (with_noq, False, ~has_qual)):
        if not wanted:
            continue
        emit, fwd, rc = si.threshold_scan(
            seq, qual, torch.where(rows, lengths, 0), k, min_q_char,
            has_qual=gated)
        # windows are END-aligned like ll_scan's: keep [k-1, k-1 + n_win)
        end = emit.shape[1] if n_win is None else k - 1 + max(
            1, min(n_win, emit.shape[1] - k + 1))
        emit = emit[:, k - 1:end] & rows[:, None]
        key = enc.canonical_windows(fwd, rc)[:, k - 1:end]
        obs.append(key[emit])
    keys = enc.sortable_key(torch.cat(obs))
    run_keys, run_cnt = cs.build_run(keys, counts_n, 0)
    return run_keys, run_cnt, int(keys.shape[0])


def _count_fastq_threshold(path, k: int, min_q: int, store: CountStore,
                           max_reads: Optional[int],
                           report_every: Optional[int] = None) -> CountStore:
    """Shared body of count.kmers.fq / count.kmers.fq.sh: per-base-threshold
    iterator, canonical min(fwd, rc) (src/kmer_hash.c:618-806)."""
    min_q_char = 33 + int(min_q)  # '!' + q, src/kmer_hash.c:633
    meter = _progress(report_every, f"count_fq[{path}]")
    info: dict = {}
    stats: dict = {}
    for (seq, qual, lengths, has_qual), len_h, hq_h, _n in _device_batches(
            _iter_file_batches(path, max_reads, info=info), store.device,
            stats):
        stats["file_reads"] = stats.get("file_reads", 0) + len(len_h)
        with_q = bool(hq_h.any())
        with_noq = bool((~hq_h & (len_h > 0)).any())
        if not (with_q or with_noq):
            continue
        run_keys, run_cnt, n_obs = _fused_threshold_batch(
            seq, qual, lengths, has_qual, k, store.counts_n, min_q_char,
            with_q, with_noq, n_win=win_bucket(len_h.max(initial=1), k))
        store.add_run(run_keys, run_cnt, n_obs)
        if meter:
            meter.update(int((len_h > 0).sum()),
                         distinct_kmers=lambda: store.peek_n_unique())
    _record_reading(store, info, stats)
    return store.flush()


def _record_reading(store: CountStore, info: dict, stats: dict) -> None:
    """What reading a file cost, into ``store.timings``: the reader's name
    (of the last file), and summed over files the producer's parse seconds,
    the consumer's seconds waiting for it, the staging seconds, the bytes
    sent to the device, the reads and the reads the hybrid filter flagged
    and re-counted (``count_batches``' ``flagged_reads``: over processes,
    every rank's; 0 where no read was flagged or the entry does not
    flag)."""
    tm = store.timings
    tm["reader"] = info["reader"]
    for key, src in (("parse_s", info), ("wait_s", info), ("copy_s", stats),
                     ("h2d_bytes", stats), ("file_reads", stats),
                     ("flagged_reads", stats)):
        tm[key] = tm.get(key, 0) + src.get(key, 0)


def count_kmers_fq(path, k: int, min_q: int = 0, prefix_bits: int = 16,
                   max_mem_gb: Optional[int] = None,
                   max_reads: Optional[int] = None,
                   store: Optional[CountStore] = None,
                   report_every: Optional[int] = None,
                   budget_semantics: str = "error",
                   device="cuda") -> CountStore:
    """``count.kmers.fq`` (src/kmer_hash.c:618-711): kmer_tree-backed
    canonical counting — spectra include the zero cells of allocated prefix
    blocks; optional soft memory budget (src/kmer_tree.c:57-67), which
    raises MemoryError past it. ``budget_semantics="drop"`` is the
    reference's silent-drop behaviour instead (src/kmer_tree.c:51-76): the
    first ``max_size // block_bytes`` distinct prefixes to appear get
    blocks, k-mers of later prefixes are dropped; it needs ``max_mem_gb``.
    ``device`` places a new store; a given ``store`` keeps its own."""
    if not 1 <= k <= MAX_K:
        raise ValueError("k must be a positive integer less than 1+MAX_K")
    if store is None:
        pb, sb = derive_prefix_suffix_bits(k, prefix_bits)
        store = CountStore(
            k, counts_n=1, prefix_bits=pb, suffix_bits=sb, mode="ktree",
            max_size_bytes=(max_mem_gb << 30) if max_mem_gb else None,
            budget_semantics=budget_semantics, device=device)
    return _count_fastq_threshold(path, k, min_q, store, max_reads,
                                  report_every)


def count_kmers_fq_sh(path, k: int, min_q: int = 0, prefix_bits: int = 16,
                      max_mem_gb: Optional[int] = None,
                      max_reads: Optional[int] = None,
                      store: Optional[CountStore] = None,
                      report_every: Optional[int] = None,
                      device="cuda") -> CountStore:
    """``count.kmers.fq.sh`` (src/kmer_hash.c:715-806): suffix_hash-backed
    variant — spectra over present k-mers only. ``max_mem_gb`` is accepted
    for API parity. ``device`` places a new store; a given ``store`` keeps
    its own."""
    if not 1 <= k <= MAX_K:
        raise ValueError("k must be a positive integer less than 1+MAX_K")
    if store is None:
        pb, sb = derive_prefix_suffix_bits(k, prefix_bits)
        store = CountStore(k, counts_n=1, prefix_bits=pb, suffix_bits=sb,
                           mode="sh", device=device)
    return _count_fastq_threshold(path, k, min_q, store, max_reads,
                                  report_every)


def count_kmers_fq_sh_rp(path, k: int, prefix_bits: int = 20,
                         min_q: int = 20, n_shards: int = 1,
                         max_reads: Optional[int] = None,
                         max_mem_gb: Optional[int] = None,
                         source_n: int = 1, source: int = 0,
                         store: Optional[CountStore] = None,
                         report_every: Optional[int] = None,
                         exact_ll=True, mesh=None, skip_reads: int = 0,
                         checkpoint_every: Optional[int] = None,
                         checkpoint_path: Optional[str] = None,
                         batch_rows: Optional[int] = None,
                         device="cuda") -> CountStore:
    """The flagship path ``count.kmers.fq.sh.rp`` (src/kmer_hash.c:810-857):
    quality-likelihood filtered, canonical, multi-source counting, on
    ``device`` (a given ``store`` keeps its own).

    ``n_shards`` mirrors the reference's thread_n parameter and
    ``max_mem_gb`` its memory hint; neither changes results and both are
    accepted for API parity.

    ``exact_ll=True`` runs the likelihood filter in float64;
    ``exact_ll=False`` in float32; ``exact_ll="hybrid"`` in float32 with
    borderline flagging, re-running only the flagged reads in float64 —
    bitwise equal to ``exact_ll=True``; see ``ops.scan_iter.ll_scan``.

    ``path`` may be a single file or a LIST of files. A list accumulates
    every file into one store (the reference's incremental multi-file
    pattern, src/kmer_hash.c:833-841). Cursor-level options (skip_reads,
    max_reads, checkpoint_every) require single-file calls.

    ``skip_reads`` discards the first N records before counting, and with
    ``checkpoint_every=N`` the store plus a progress record (file path,
    reads consumed) is written atomically to ``checkpoint_path`` every N
    reads — together they give mid-file resume (see
    ``utils.checkpoint.load_progress``). ``batch_rows`` is the reads per
    device batch (default: ``KMH_BATCH_ROWS``, else :data:`BATCH_ROWS`).

    ``mesh`` (a ``parallel.make_mesh`` shard group) counts into a
    ``ShardedCountStore`` on the group's devices instead: see
    :func:`_count_rp_sharded`. A given ``store`` must then be one of its
    size.
    """
    if checkpoint_every is not None and checkpoint_path is None:
        raise ValueError("checkpoint_every requires checkpoint_path")
    paths = _normalize_paths(path)
    if paths is not None and len(paths) == 1:
        path, paths = paths[0], None
    if paths is not None and (skip_reads or max_reads is not None
                              or checkpoint_every is not None):
        raise ValueError(
            "a file list supports neither skip_reads, max_reads nor "
            "checkpointing — make incremental per-file calls with store= "
            "for cursor-level control")
    if paths is not None and mesh is not None and mesh.distributed:
        _check_rp_args(k, source_n, source, exact_ll)
        return _count_rp_sharded(paths, k, min_q, None, source_n, source,
                                 store, mesh, exact_ll, report_every,
                                 batch_rows=batch_rows)
    if paths is not None:
        for p in paths:
            store = count_kmers_fq_sh_rp(
                p, k, prefix_bits, min_q, n_shards, None, max_mem_gb,
                source_n, source, store, report_every, exact_ll, mesh=mesh,
                batch_rows=batch_rows, device=device)
        return store
    _check_rp_args(k, source_n, source, exact_ll)
    if mesh is not None:
        return _count_rp_sharded(path, k, min_q, max_reads, source_n, source,
                                 store, mesh, exact_ll, report_every,
                                 skip_reads, checkpoint_every,
                                 checkpoint_path, batch_rows)
    if store is None:
        pb, sb = derive_prefix_suffix_bits(k, prefix_bits)
        store = CountStore(k, counts_n=source_n, prefix_bits=pb,
                           suffix_bits=sb, mode="sh", device=device)
    return _count_rp_file(path, k, min_q, max_reads, source, store,
                          exact_ll, report_every, skip_reads,
                          checkpoint_every, checkpoint_path, batch_rows)


def _check_rp_args(k: int, source_n: int, source: int, exact_ll) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError("k must be a positive integer less than 1+MAX_K")
    if not 1 <= source_n <= 4:
        raise ValueError("Source_n must be in the range 1 - 4")
    if source >= source_n:
        raise ValueError("source_i must be less than source_n")
    _fsm_of(exact_ll)


def _count_rp_sharded(path, k: int, min_q: int, max_reads: Optional[int],
                      source_n: int, source: int, store, mesh, exact_ll,
                      report_every: Optional[int], skip_reads: int = 0,
                      checkpoint_every: Optional[int] = None,
                      checkpoint_path: Optional[str] = None,
                      batch_rows: Optional[int] = None):
    """``count_kmers_fq_sh_rp(mesh=)``: a new ``ShardedCountStore`` over
    ``mesh`` (or the given one, of the group's size) filled by the single
    store's loop. Each batch's run is routed to its owner shards
    (``ShardedCountStore.add_run``); the hybrid sweep, ``skip_reads``,
    ``max_reads``, checkpoints with progress records and ``report_every``
    work as for one store.

    Over a group that spans processes (the JAX package's multi-process
    routes), every rank calls this with the same arguments and one of three
    routes is taken:

    (a) a file list, when ``KMH_FILE_PARTITION`` is not "0" and it is "1",
        or any file is gzip, or there are at least as many files as
        processes: the files are dealt to the ranks greedily by size
        (:func:`_count_rp_files`); a shorter list of plain files is counted
        file by file through (b) or (c);
    (b) one plain 4-line FASTQ (or FASTA) file, with no ``skip_reads``, no
        ``max_reads``, no checkpoints and ``KMH_HOST_SLICE`` not "0": rank
        p reads only the records that start in bytes [size*p/P,
        size*(p+1)/P) (:func:`_count_rp_sliced`);
    (c) otherwise, lockstep: every rank streams the whole file and counts
        its own contiguous block of every batch's rows, the batch padded
        with empty rows to a multiple of D (:func:`_count_rp_lockstep`); a
        lone gzip file comes here, with a warning (once a process), as
        gzip cannot be read from a byte offset.

    (a) and (b) read a different number of batches on each rank: a small
    allgather a batch keeps every rank's exchanges in step
    (:func:`_aligned_batches`)."""
    from .parallel.sharded import ShardedCountStore

    if store is None:
        store = ShardedCountStore(k, mesh, counts_n=source_n)
    if not isinstance(store, ShardedCountStore):
        raise ValueError("mesh= counts into a ShardedCountStore; the given "
                         "store is not one")
    if store.n_shards != mesh.size:
        raise ValueError(f"the store has {store.n_shards} shards; the mesh "
                         f"has {mesh.size}")
    if not mesh.distributed:
        return _count_rp_file(path, k, min_q, max_reads, source, store,
                              exact_ll, report_every, skip_reads,
                              checkpoint_every, checkpoint_path, batch_rows)
    if store.k != k:
        raise ValueError("Incompatible arguments: k does not match the store")
    if source >= store.counts_n:
        raise ValueError("Value of source is too large")
    if isinstance(path, list):
        fp = os.environ.get("KMH_FILE_PARTITION", "")
        if fp != "0" and (fp == "1" or any(is_gzip(p) for p in path)
                          or len(path) >= mesh.process_count):
            return _count_rp_files(path, k, min_q, source, store, exact_ll,
                                   report_every, batch_rows)
        for p in path:
            store = _count_rp_sharded(p, k, min_q, None, source_n, source,
                                      store, mesh, exact_ll, report_every,
                                      batch_rows=batch_rows)
        return store
    gz = is_gzip(path)
    if (not skip_reads and max_reads is None and checkpoint_every is None
            and not gz and is_fourline_fastq(path)
            and os.environ.get("KMH_HOST_SLICE", "1") != "0"):
        return _count_rp_sliced(path, k, min_q, source, store, exact_ll,
                                report_every, batch_rows)
    if gz and not _WARNED_GZIP_LOCKSTEP:
        _warn_gzip_lockstep(path)
    return _count_rp_file(path, k, min_q, max_reads, source, store,
                          exact_ll, report_every, skip_reads,
                          checkpoint_every, checkpoint_path, batch_rows)


_WARNED_GZIP_LOCKSTEP = False


def _warn_gzip_lockstep(path) -> None:
    global _WARNED_GZIP_LOCKSTEP
    _WARNED_GZIP_LOCKSTEP = True
    warnings.warn(
        f"{path} is gzip: a gzip stream cannot be read from a byte offset, "
        f"so every process parses all of it (lockstep); pass a list of "
        f"files to deal them to the processes instead", RuntimeWarning,
        stacklevel=3)


def _row_blocks(batch, shards: int, parts: int) -> List[tuple]:
    """A (seq, qual, lengths, has_qual) batch — host numpy arrays or
    tensors — padded with empty rows ('N', no length, no qualities) to a
    multiple of ``shards`` rows (the shards its rows are dealt over) and
    cut into ``parts`` contiguous blocks of one size (``parts`` divides
    ``shards``): the JAX package's rows a device, dealt to ranks (route
    (c): the D shards over P ranks) or to the devices of one rank (its
    D/P shards over its M devices). One part is the batch as it is,
    unpadded."""
    B = int(batch[2].shape[0])
    pad = -B % shards if parts > 1 else 0
    if pad:
        batch = tuple(_pad_rows(a, pad, fill)
                      for a, fill in zip(batch[:4], (ord("N"), 0, 0, False)))
    per = (B + pad) // parts
    return [tuple(a[i * per:(i + 1) * per] for a in batch[:4])
            for i in range(parts)]


def _pad_rows(a, pad: int, fill):
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a.new_full((pad, *a.shape[1:]), fill)])
    return np.concatenate([a, np.full((pad, *a.shape[1:]), fill, a.dtype)])


def _lockstep_rows(batches: Iterable, mesh) -> Iterator[tuple]:
    """Route (c): each whole-file batch padded with empty rows to a
    multiple of D, then this rank's contiguous block of its rows, with the
    batch's record count as the fifth item. The block is a multiple of the
    rank's D/P shards, so ``ShardedCountStore.add_reads`` cuts it into
    its M devices' blocks with no more padding: rank p's device i takes
    block p*M + i of the batch cut into P*M (for D = P*M, the rows the
    JAX mesh gives each chip)."""
    P, p = mesh.process_count, mesh.process_index
    for b in batches:
        yield (*_row_blocks(b, mesh.size, P)[p], int(b[2].shape[0]))


def _aligned_batches(batches: Iterable, mesh, mine: dict
                     ) -> Iterator[tuple]:
    """Routes (a) and (b): this rank's batches, each after one allgather of
    (live, reads) over the ranks, with every rank's reads as the fifth
    item; once this rank is drained, empty batches while any rank is not;
    the end when none is. ``mine["reads"]`` counts this rank's reads."""
    mine.setdefault("reads", 0)
    it = iter(batches)
    while True:
        b = next(it, None)
        n = 0 if b is None else int(b[2].shape[0])
        g = mesh.allgather([b is not None, n])
        if not g[:, 0].any():
            return
        mine["reads"] += n
        if b is None:
            b = (np.zeros((0, 8), np.uint8), np.zeros((0, 8), np.uint8),
                 np.zeros(0, np.int32), np.zeros(0, bool))
        yield (*b[:4], int(g[:, 1].sum()))


def _count_aligned(label: str, batches: Iterable, k: int, min_q: int,
                   source: int, store, exact_ll, report_every, info: dict
                   ) -> dict:
    """The loop of routes (a) and (b) over this rank's host batches; what
    the reading cost goes into ``store.timings`` (this rank's parse and
    reads). Returns ``{"reads": this rank's reads}``."""
    mine: dict = {}
    stats: dict = {}
    count_batches(store, _aligned_batches(batches, store.mesh, mine), k,
                  min_q, source, exact_ll,
                  meter=_progress(report_every, label), stats=stats)
    stats["file_reads"] = mine["reads"]
    _record_reading(store, info, stats)
    return mine


def _rows_per_rank(batch_rows: Optional[int], mesh) -> int:
    """Reads per batch on each rank of routes (a) and (b): a batch's reads
    over the ranks, so that a step of every rank reads about one batch."""
    return max(1, -(-_batch_rows(batch_rows) // mesh.process_count))


def _count_rp_sliced(path, k: int, min_q: int, source: int, store, exact_ll,
                     report_every, batch_rows: Optional[int]):
    """Route (b): this rank parses only the records whose first byte falls
    in its byte range (the readers re-synchronise to a record boundary),
    then the resolved ranges are checked to tile the file
    (:func:`_check_slice_continuity`)."""
    mesh = store.mesh
    P, p = mesh.process_count, mesh.process_index
    size = os.path.getsize(path)
    rng = (size * p // P, size * (p + 1) // P)
    range_info: dict = {}
    info: dict = {}
    it = _iter_file_batches(path, None, 0, _rows_per_rank(batch_rows, mesh),
                            info, byte_range=rng, range_info=range_info)
    mine = _count_aligned(f"count_rp_sliced[{path}]", it, k, min_q, source,
                          store, exact_ll, report_every, info)
    _check_slice_continuity(path, range_info, mine["reads"], mesh)
    return store


def _count_rp_files(paths: List[str], k: int, min_q: int, source: int,
                    store, exact_ll, report_every,
                    batch_rows: Optional[int]):
    """Route (a): the files dealt to the ranks greedily by size (largest
    first, each to the least loaded rank, ties to the lower index; where a
    file cannot be stat'ed, round robin), each rank parsing only its
    own."""
    mesh = store.mesh
    P, p = mesh.process_count, mesh.process_index
    try:
        sizes = [os.path.getsize(f) for f in paths]
    except OSError:
        mine = list(paths[p::P])
    else:
        loads = [0] * P
        assign: List[List[int]] = [[] for _ in range(P)]
        for i in sorted(range(len(paths)), key=lambda i: (-sizes[i], i)):
            j = min(range(P), key=lambda t: (loads[t], t))
            assign[j].append(i)
            loads[j] += sizes[i]
        mine = [paths[i] for i in sorted(assign[p])]
    rows = _rows_per_rank(batch_rows, mesh)
    info = {"reader": native.reader_name()}  # also where no file is mine

    def produce():
        for f in mine:
            yield from _iter_file_batches(f, None, 0, rows, info)

    _count_aligned(f"count_rp_files[{len(paths)} files, {len(mine)} mine]",
                   produce(), k, min_q, source, store, exact_ll,
                   report_every, info)
    return store


def _check_slice_continuity(path, range_info: dict, my_reads: int,
                            mesh) -> None:
    """The ranks' resolved record boundaries must tile the file: rank p's
    range ends where the next rank with reads starts, and the last ends at
    the file's end. Raises otherwise (a multi-line FASTQ past the 4-line
    check, a quality line that fooled the boundary search), where reads
    would have been dropped or counted twice."""
    g = mesh.allgather([1 if my_reads > 0 else 0,
                        range_info.get("start", -1),
                        range_info.get("end", -1)])
    chain = [(int(a), int(b)) for live, a, b in g if live]
    if not chain:
        return
    size = os.path.getsize(path)
    if not (all(chain[j][1] == chain[j + 1][0]
                for j in range(len(chain) - 1)) and chain[-1][1] == size):
        raise RuntimeError(
            f"the processes' input slices do not tile the file (resolved "
            f"boundaries {chain}, size {size}): records would be dropped "
            f"or counted twice. Is this a multi-line FASTQ past the 4-line "
            f"check? Count it with KMH_HOST_SLICE=0 (lockstep).")


def _count_rp_file(path, k: int, min_q: int, max_reads: Optional[int],
                   source: int, store, exact_ll,
                   report_every: Optional[int], skip_reads: int,
                   checkpoint_every: Optional[int],
                   checkpoint_path: Optional[str],
                   batch_rows: Optional[int]):
    """The per-file body of :func:`count_kmers_fq_sh_rp` for either store
    kind: a ``CountStore`` or a ``ShardedCountStore``; over processes, the
    lockstep route (c), where every rank reads every record and the
    progress record counts them all."""
    if store.k != k:
        raise ValueError("Incompatible arguments: k does not match the store")
    if source >= store.counts_n:
        raise ValueError("Value of source is too large")
    reads_done = int(skip_reads)
    since_ckpt = 0

    def on_batch(n_recs, sweep):
        nonlocal reads_done, since_ckpt
        reads_done += n_recs
        since_ckpt += n_recs
        if checkpoint_every is not None and since_ckpt >= checkpoint_every:
            since_ckpt = 0
            sweep()  # checkpointed state must be exact
            _checkpoint_progress(store, checkpoint_path, path, reads_done)

    info: dict = {}
    stats: dict = {}
    batches = _iter_file_batches(path, max_reads, skip_reads, batch_rows,
                                 info)
    if _spans_processes(store):
        batches = _lockstep_rows(batches, store.mesh)
    count_batches(store, batches, k, min_q, source, exact_ll,
                  meter=_progress(report_every, f"count_rp[{path}]"),
                  on_batch=on_batch, stats=stats)
    stats["file_reads"] = reads_done - int(skip_reads)
    _record_reading(store, info, stats)
    if checkpoint_every is not None:
        # done only when the file was exhausted (a max_reads-limited leg
        # may have more records left; resume continues from the cursor)
        consumed = reads_done - int(skip_reads)
        _checkpoint_progress(
            store, checkpoint_path, path, reads_done,
            done=max_reads is None or consumed < max_reads)
    return store


def _checkpoint_progress(store, ckpt_path, src_path, reads_done,
                         done: bool = False) -> None:
    """Atomically persist the store + resume cursor (write tmp, replace).
    Over processes the save is collective and rank 0 writes the file; it
    replaces the checkpoint once every rank is past the save, and every
    rank leaves only after that."""
    from .utils import checkpoint as ckpt

    tmp = str(ckpt_path) + ".tmp.npz"  # .npz so numpy doesn't re-suffix
    ckpt.save_count_store(
        store, tmp,
        progress={"path": str(src_path), "reads_done": int(reads_done),
                  "done": bool(done)})
    mesh = getattr(store, "mesh", None)
    if mesh is None or mesh.process_index == 0:
        os.replace(tmp, ckpt_path)
    if mesh is not None:
        mesh.barrier()


def seq_kmer_depth(store: CountStore, seq, k: int,
                   semantics: str = "intent") -> torch.Tensor:
    """``seq.kmer.depth.sh`` (src/kmer_reader.c:155-194): per-position
    canonical k-mer counts, int32 [counts_n, len(seq)] on the store's
    device, NA (INT_MIN) where no count was written.

    ``semantics="intent"`` deviates deliberately from the reference, as the
    JAX package's default does: windows overlapping N are NA, and counts
    are window-start-aligned. ``semantics="c"`` is the reference byte for
    byte: the one-column shift, the stale-register windows across N gaps
    after exactly-k regions, and the partial-window write at the end of the
    sequence (see :func:`_seq_kmer_depth_c`).

    The call is the span ``kmh.count.depth``; it adds its host seconds to
    ``store.timings["depth_s"]`` and the sequence's window starts
    (``len(seq) - k + 1``) to ``store.timings["depth_windows"]``."""
    if store.k != k:
        raise ValueError("Receieved error from seq_kmer_counts: k mismatch")
    if semantics not in ("intent", "c"):
        raise ValueError(f"unknown semantics {semantics!r}")
    t0 = time.perf_counter()
    with span("kmh.count.depth"):
        if semantics == "c":  # its planner reads the sequence on the host
            if isinstance(seq, torch.Tensor):
                seq = seq.cpu().numpy()
            seq = as_sequence(seq)
            L = int(seq.shape[0])
            out = _seq_kmer_depth_c(store, seq, k)
        else:
            if not isinstance(seq, torch.Tensor):
                seq = torch.from_numpy(as_sequence(seq))
            x = seq.to(store.device, torch.uint8).contiguous()
            if x.dim() != 1:
                raise ValueError("seq must be a single sequence")
            L = int(x.shape[0])
            out = torch.full((store.counts_n, L), _NA, dtype=torch.int32,
                             device=store.device)
            if L:
                key, valid = enc.encode_stream(x, k, L, canonical=True)
                rows = store.lookup(key)  # [L, counts_n]
                out = torch.where(valid[None, :], rows.T, out)
    # a sharded store's timings start without these keys
    tm = store.timings
    tm["depth_s"] = tm.get("depth_s", 0.0) + time.perf_counter() - t0
    tm["depth_windows"] = tm.get("depth_windows", 0) + max(L - k + 1, 0)
    return out


def _plan_depth_c(seq: np.ndarray, k: int):
    """The host planner of the exact-C depth track, O(#regions) numpy.

    The C loop is sequential, but its writes decompose by maximal non-N
    region into three sources:

    * a build-completing region (len >= k) writes column ``s`` = window(s),
      then roll-writes column ``c`` = window(c+1): plain windows of the
      sequence;
    * a region entered with a STALE register (the region right after an
      exactly-k build) mixes up to k-1 pre-gap bases into its first
      windows: the windows of a (previous k bases ++ this region) junction
      snippet;
    * an init() that runs off the end writes the partial register's count
      at column n-k.

    Returns (cols, src_o, jrow, jt, junctions, partial): per written column
    its source — ``jrow >= 0``: window ``jt`` of junction snippet ``jrow``;
    else ``src_o >= 0``: window ``src_o`` of the sequence; else
    (``src_o == -2``) the end-of-sequence partial k-mer ``partial`` (a raw
    pattern as a Python int, or None); ``junctions`` lists (previous
    region's start, this region's start, its length). Columns ascend, so
    none is written twice."""
    n = int(seq.shape[0])
    isn = (seq | np.uint8(0x20)) == np.uint8(ord("n"))
    d = np.diff((~isn).astype(np.int8), prepend=np.int8(0),
                append=np.int8(0))
    r_starts = np.flatnonzero(d == 1)
    r_ends = np.flatnonzero(d == -1)  # exclusive
    blocks: list = []  # (cols, src_o, jrow, jt) array blocks

    def emit(cols, src_o, jrow, jt):
        blocks.append(tuple(np.asarray(a, np.int64)
                            for a in (cols, src_o, jrow, jt)))

    junctions: list = []
    stale = False
    last_active_end = -1  # end of the last build/stale-rolled region
    last_active_r = -1
    m = len(r_starts)
    for r in range(m):
        s, e = int(r_starts[r]), int(r_ends[r])
        Lr = e - s
        if stale:
            stale = False
            last_active_end, last_active_r = e, r
            jrow = len(junctions)
            junctions.append((int(r_starts[r - 1]), s, Lr))
            t = np.arange(min(Lr, k - 1))  # mixed-register steps
            c = s + t - k
            keep = c >= 0
            nkeep = int(keep.sum())
            emit(c[keep], np.full(nkeep, -1), np.full(nkeep, jrow),
                 (t + 1)[keep])
            c = s + np.arange(k - 1, Lr) - k  # the register is pure again
            c = c[c >= 0]
            emit(c, c + 1, np.full(c.shape[0], -1), np.zeros(c.shape[0]))
            # the roll ended at N (or the end); the next region rebuilds
        elif Lr >= k:
            last_active_end, last_active_r = e, r
            if Lr == k:
                emit([s], [s], [-1], [0])  # the rebuild's write survives
                stale = True  # seq[s+k] is N (or the end)
            else:
                c = np.arange(s, s + Lr - k)  # roll: col c = window(c+1)
                emit(c, c + 1, np.full(c.shape[0], -1),
                     np.zeros(c.shape[0]))
        # else: a short region in init mode, consumed and reset: invisible

    partial = None
    if last_active_end == n:
        pass  # rolling or build ended exactly at the end: no write
    elif stale and last_active_r == m - 1:
        pass  # exactly-k build, then Ns to the end: skip_n leaves the loop
    else:
        # a rebuild's init scanned past last_active_end and hit the end:
        # its register holds the LAST region's bases (reset at each earlier
        # short region), or nothing if only Ns remain
        tail = seq[:0]
        if m and last_active_r < m - 1:
            tail = seq[int(r_starts[-1]): int(r_ends[-1])]
        off_f = off_r = 0
        for b in tail.tolist():
            code = (b >> 1) & 3
            off_f = ((off_f << 2) | code) & 0xFFFFFFFFFFFFFFFF
            off_r = (off_r >> 2) | (((code + 2) % 4) << 62)
        mask = (1 << (2 * k)) - 1
        partial = min(off_f & mask, off_r >> (64 - 2 * k))
        emit([n - k], [-2], [-1], [0])
    if not blocks:
        z = np.zeros(0, np.int64)
        return z, z, z, z, junctions, partial
    cols, src_o, jrow, jt = (np.concatenate(a) for a in zip(*blocks))
    return cols, src_o, jrow, jt, junctions, partial


def _seq_kmer_depth_c(store: CountStore, seq: np.ndarray, k: int
                      ) -> torch.Tensor:
    """Exact-C depth track (src/kmer_reader.c:155-194; bit parity with the
    JAX package's ``_seq_kmer_depth_c``): :func:`_plan_depth_c` on the
    host, then two batched encodes (the sequence's own windows and the
    [J, 2k-1] junction snippets; kernel B1 on the card), ONE
    ``store.lookup`` and one scatter on the store's device."""
    dev = store.device
    n = int(seq.shape[0])
    out = torch.full((store.counts_n, n), _NA, dtype=torch.int32, device=dev)
    if n < k:
        # the C underflows its output buffer here; this returns all-NA
        return out
    cols, src_o, jrow, jt, junctions, partial = _plan_depth_c(seq, k)
    if cols.size == 0:
        return out
    # a copy: the caller's array may be read-only (np.frombuffer)
    key_o, _v = enc.encode_stream(torch.from_numpy(seq.copy()).to(dev), k, n,
                                  canonical=True)
    q = torch.zeros(cols.shape[0], dtype=torch.int64, device=dev)
    mj = jrow >= 0
    if junctions:
        W = 2 * k - 1
        rows = np.full((len(junctions), W), ord("N"), np.uint8)
        for ji, (ps, cur, cl) in enumerate(junctions):
            rows[ji, :k] = seq[ps: ps + k]
            take = min(cl, k - 1)
            rows[ji, k: k + take] = seq[cur: cur + take]
        key_j, _v = enc.encode_stream(
            torch.from_numpy(rows).to(dev), k,
            torch.full((len(junctions),), W, dtype=torch.int64, device=dev),
            canonical=True)
        q[torch.from_numpy(mj).to(dev)] = key_j[
            torch.from_numpy(jrow[mj]).to(dev),
            torch.from_numpy(jt[mj]).to(dev)]
    mo = ~mj & (src_o >= 0)
    q[torch.from_numpy(mo).to(dev)] = key_o[
        torch.from_numpy(src_o[mo]).to(dev)]
    if partial is not None:  # the raw pattern as a signed int64
        q[torch.from_numpy(~mj & (src_o == -2)).to(dev)] = (
            partial - (1 << 64) if partial >= 1 << 63 else partial)
    out[:, torch.from_numpy(cols).to(dev)] = store.lookup(q).T
    return out
