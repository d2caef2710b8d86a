"""High-level counting entries (PyTorch port of
``kmer_hasher_tpu/counting.py``) — analogues of the reference's
``count.kmers*`` R surface (kmer_hash.R:43-96, src/kmer_hash.c:548-857).

Reads stream through the quality-likelihood FSM (kernel B2 on the card,
``ops/cuda_scan.py``) or, where a record has no qualities, through the
position-parallel encoder (kernel B1), are canonicalised where the
reference canonicalises, and merge into a :class:`CountStore`.

Ported: ``count_kmers``, the flagship ``count_kmers_fq_sh_rp`` on one
device and ``seq_kmer_depth(semantics="intent")``. Still to come: the
per-base-threshold entries (``count_kmers_fq``, ``count_kmers_fq_sh``),
``semantics="c"`` depth, the packed upload forms and ``mesh=``.
"""
from __future__ import annotations

import os
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .index import count_store as cs
from .index.count_store import CountStore
from .io.fastx import iter_fastx, pad_records
from .ops import cuda_scan
from .ops import encode as enc
from .qll import Q_TO_LL

MAX_K = 32
BATCH_ROWS = 1 << 15  # reads per batch of the file entries
_SWEEP_EVERY = 64  # batches between exact re-counts of flagged reads
_NA = -(2 ** 31)  # INT_MIN, R's NA_integer_


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


def _iter_file_batches(path, max_reads: Optional[int], skip: int = 0
                       ) -> Iterator[Tuple[np.ndarray, ...]]:
    """Host (seq, qual, lengths, has_qual) batches of a FASTA/FASTQ file,
    padded to the batch's longest read. ``skip`` discards the first N
    records (mid-file resume); ``max_reads`` then limits the records
    yielded after the skip."""
    if max_reads is not None and max_reads < 0:
        max_reads = None
    limit = None if max_reads is None else skip + max_reads
    to_skip = skip
    for recs in iter_fastx(path, batch_size=BATCH_ROWS, max_records=limit):
        if to_skip >= len(recs):
            to_skip -= len(recs)
            continue
        if to_skip:
            recs, to_skip = recs[to_skip:], 0
        padded = pad_records(recs, pad_to_multiple=1)
        yield padded.seq, padded.qual, padded.lengths, padded.has_qual


def _device_batches(batches: Iterable, dev: torch.device):
    """Batches for the counting loop: each a (seq, qual, lengths, has_qual)
    tuple of host numpy arrays or of tensors. Yields (the four as tensors
    on ``dev``, lengths and has_qual as host numpy arrays for control flow).

    Host batches reach a card through pinned buffers on a copy stream, one
    batch ahead: the copy of batch N+1 overlaps the device work on batch N.
    Two sets of pinned buffers are kept and reused in turn (one per batch
    in flight), each grown to the largest batch it has held.
    """
    def host_view(b):
        return tuple(a.cpu().numpy() if isinstance(a, torch.Tensor)
                     else np.asarray(a) for a in (b[2], b[3]))

    if dev.type != "cuda":
        for b in batches:
            yield (tuple(torch.as_tensor(a).to(dev) for a in b),
                   *host_view(b))
        return
    copy = torch.cuda.Stream(dev)
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
        if all(isinstance(a, torch.Tensor) and a.is_cuda for a in b):
            # staged on a card already ("cuda" names the current one)
            return tuple(a.to(dev) for a in b), None, host_view(b)
        slot = slots[turn]
        turn ^= 1
        if slot["done"] is not None:
            slot["done"].synchronize()  # its last copy has left the buffers
        with torch.cuda.stream(copy):
            out = tuple(staged(slot, i, torch.as_tensor(a))
                        .to(dev, non_blocking=True) for i, a in enumerate(b))
            slot["done"] = torch.cuda.Event()
            slot["done"].record(copy)
        return out, slot["done"], host_view(b)

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


def _sweep_backlog(store: CountStore, backlog: list, k: int, source: int,
                   min_ll_f: float) -> int:
    """Re-count the borderline-flagged reads exactly (f64), emptying
    ``backlog`` ([(seq, qual, lengths, flags, n_win, n_flag)] batches on
    the device); returns how many reads that were. One readback of the
    stacked per-batch flag counts decides what re-runs; each batch with
    flagged reads compacts them on the device and exact-scans only those.
    Hybrid thus stays bitwise equal to ``exact_ll=True``."""
    if not backlog:
        return 0
    n_flags = torch.stack([b[5] for b in backlog]).cpu().tolist()
    for (seq_b, qual_b, len_b, f_b, n_win, _n), nf in zip(backlog, n_flags):
        if nf == 0:
            continue
        seq_c, qual_c, len_c = _compact_flagged(seq_b, qual_b, len_b, f_b)
        r = _fused_rp_batch(seq_c, qual_c, len_c,
                            torch.ones_like(len_c, dtype=torch.bool), k,
                            store.counts_n, source, min_ll_f, "exact",
                            n_win=n_win)
        store.add_run(r[0], r[1], r[2], source=source)
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
    store's device — goes through :func:`_fused_rp_batch` into the store;
    in hybrid mode flagged reads are re-counted exactly every
    ``_SWEEP_EVERY`` batches and at the end. Ends with a flush.

    ``on_batch(n_records, sweep)`` is called after each batch (the file
    entry checkpoints there; ``sweep()`` makes the store exact first).
    ``stats``, if given, receives ``flagged_reads``: how many reads hybrid
    mode flagged and re-counted."""
    fsm = _fsm_of(exact_ll)
    min_ll_f = float(Q_TO_LL[33 + int(min_q)])
    min_q_char = 33 + int(min_q)
    backlog: list = []

    def sweep():
        n = _sweep_backlog(store, backlog, k, source, min_ll_f)
        if stats is not None:
            stats["flagged_reads"] = stats.get("flagged_reads", 0) + n

    for (seq, qual, lengths, has_qual), len_h, hq_h in _device_batches(
            batches, store.device):
        with_noq = bool((~hq_h & (len_h > k)).any())
        n_win = win_bucket(len_h.max(initial=1), k)
        run_keys, run_cnt, n_obs, flags, n_flag = _fused_rp_batch(
            seq, qual, lengths, has_qual, k, store.counts_n, source,
            min_ll_f, fsm, with_noq, min_q_char=min_q_char, n_win=n_win)
        store.add_run(run_keys, run_cnt, n_obs, source=source)
        if fsm == "hybrid":
            backlog.append((seq, qual, lengths, flags, n_win, n_flag))
            if len(backlog) >= _SWEEP_EVERY:
                sweep()
        n_recs = int(len_h.shape[0])
        if on_batch is not None:
            on_batch(n_recs, sweep)
        if meter:
            meter.update(n_recs,
                         distinct_kmers=lambda: store.peek_n_unique())
    sweep()
    return store.flush()


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
    ``utils.checkpoint.load_progress``).
    """
    if mesh is not None:
        raise NotImplementedError("multi-device counting (mesh=) is not "
                                  "ported yet")
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
    if paths is not None:
        for p in paths:
            store = count_kmers_fq_sh_rp(
                p, k, prefix_bits, min_q, n_shards, None, max_mem_gb,
                source_n, source, store, report_every, exact_ll,
                device=device)
        return store
    if not 1 <= k <= MAX_K:
        raise ValueError("k must be a positive integer less than 1+MAX_K")
    if not 1 <= source_n <= 4:
        raise ValueError("Source_n must be in the range 1 - 4")
    if source >= source_n:
        raise ValueError("source_i must be less than source_n")
    _fsm_of(exact_ll)
    if store is None:
        pb, sb = derive_prefix_suffix_bits(k, prefix_bits)
        store = CountStore(k, counts_n=source_n, prefix_bits=pb,
                           suffix_bits=sb, mode="sh", device=device)
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

    count_batches(store, _iter_file_batches(path, max_reads, skip_reads),
                  k, min_q, source, exact_ll,
                  meter=_progress(report_every, f"count_rp[{path}]"),
                  on_batch=on_batch)
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
    """Atomically persist the store + resume cursor (write tmp, replace)."""
    from .utils import checkpoint as ckpt

    tmp = str(ckpt_path) + ".tmp.npz"  # .npz so numpy doesn't re-suffix
    ckpt.save_count_store(
        store, tmp,
        progress={"path": str(src_path), "reads_done": int(reads_done),
                  "done": bool(done)})
    os.replace(tmp, ckpt_path)


def seq_kmer_depth(store: CountStore, seq, k: int,
                   semantics: str = "intent") -> torch.Tensor:
    """``seq.kmer.depth.sh`` (src/kmer_reader.c:155-194): per-position
    canonical k-mer counts, int32 [counts_n, len(seq)] on the store's
    device, NA (INT_MIN) where no count was written.

    ``semantics="intent"`` deviates deliberately from the reference, as the
    JAX package's default does: windows overlapping N are NA, and counts
    are window-start-aligned. ``semantics="c"`` (the reference byte for
    byte) is not ported yet."""
    if store.k != k:
        raise ValueError("Receieved error from seq_kmer_counts: k mismatch")
    if semantics == "c":
        raise NotImplementedError("semantics='c' depth is not ported yet")
    if semantics != "intent":
        raise ValueError(f"unknown semantics {semantics!r}")
    if isinstance(seq, str):
        seq = seq.encode()
    if isinstance(seq, (bytes, bytearray)):
        seq = np.frombuffer(bytes(seq), np.uint8).copy()
    if not isinstance(seq, torch.Tensor):
        seq = torch.from_numpy(np.asarray(seq, np.uint8))
    x = seq.to(store.device, torch.uint8).contiguous()
    if x.dim() != 1:
        raise ValueError("seq must be a single sequence")
    L = int(x.shape[0])
    out = torch.full((store.counts_n, L), _NA, dtype=torch.int32,
                     device=store.device)
    if L == 0:
        return out
    key, valid = enc.encode_stream(x, k, L, canonical=True)
    rows = store.lookup(key)  # [L, counts_n]
    return torch.where(valid[None, :], rows.T, out)
