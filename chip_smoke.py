#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: the position-index path
and the quality-filtered counting path, end to end.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printing its own lines; any failure raises and the exit code
is nonzero:

1. device  — needs torch.cuda; prints the card and its power limit;
2. build   — compiles kmer_hasher_tpu_torch/csrc/*.cu with nvcc (sm_90a);
3. kernels — B1 (encode) and B2 (quality-likelihood FSM, three
             instantiations) against their plain PyTorch versions on the
             card, bitwise, at the shapes the main paths launch them with;
4. main (index) — make_kmer_hash(k=32) of a 40,000,000-base sequence,
             kmer_pos(2|8), the full pair drain, then a k=21 index and
             seq_kmer_pos with a 1,000,000-base query, with checks;
5. main (counting) — 64 batches x 29,696 reads x 151 bases drawn on the
             card from a 4,000,000-base genome (both strands, 0.5%
             substitutions, NovaSeq-binned qualities), k=21, min_q=20,
             exact_ll="hybrid", through the loop the file entry uses; then
             flush, kmer_spectrum, seq_kmer_depth, with checks; then, as
             a path of its own, count_kmers_fq_sh_rp of a 50,000-read FASTQ
             file with a checkpoint round trip; then 4 full-width batches
             with stress qualities, where hybrid flags reads and re-scans
             them in f64, against exact. Kernel launches are counted per
             path (index, counting, file), set to 0 just before each and
             read just after;
6. card vs CPU — index tables for k in {16, 21, 32}; counting in all
             three likelihood modes and a two-source store, bitwise;
7. times   — B1 and B2 vs plain, build_index_arrays, the index path, and
             the counting rates E2E / FUSED / FSM with the share of tier
             merges, of the fold, and the device's idle share over the
             whole 64-batch loop.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Imports neither JAX nor kmer_hasher_tpu.
"""
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if not (ROOT / "kmer_hasher_tpu_torch" / "__init__.py").is_file():
    sys.exit("chip_smoke.py: kmer_hasher_tpu_torch/ is not beside this script")
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SEED = 20261016
SEQ_LEN = 40_000_000  # a ~40 Mbp chromosome (BASELINE.json config 4)
REPEAT_AT, UNIT, COPIES = 1_000_000, 5_000, 40
QUERY_AT, QUERY_LEN = 500_000, 1_000_000
PREFIX = 1 << 22
KS_KERNEL = (1, 4, 16, 17, 21, 31, 32)
# the counting cell: the device-side end-to-end configuration of the JAX
# package's tools/chip_probes/e2e_device_bench.py
N_BATCHES, ROWS, READ_LEN = 64, 29_696, 151
K_COUNT, MIN_Q = 21, 20
GENOME_LEN, SUB_RATE = 4_000_000, 0.005
QUAL_BINS, QUAL_P = b"F:,#", (0.88, 0.08, 0.02, 0.02)  # NovaSeq RTA3
DEPTH_AT, DEPTH_LEN = 1_000_000, 1_000_000
FILE_READS = 50_000
STRESS_BATCHES = 4
KS_SCAN = (5, 16, 17, 21, 31, 32)
VARIANTS = {  # B2's three instantiations, as cuda_scan.scan selects them
    "f32": dict(precision="fast"),
    "f32+flags": dict(precision="fast", return_flags=True,
                      min_q_char=33 + MIN_Q),
    "f64": dict(precision="exact"),
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
NA = -(2 ** 31)


def log(msg: str) -> None:
    print(msg, flush=True)


def make_sequence(rng, n: int) -> np.ndarray:
    """Mixed-case bases, N runs, and a planted tandem repeat (a 5,000-base
    unit 40 times) so the pair stream has real, multi-chunk work. The last
    k+1 bases stay N-free."""
    seq = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), size=n)
    for a in rng.integers(0, n - 200, size=n // 40_000):
        seq[a: a + int(rng.integers(1, 120))] = ord("N")
    unit = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=UNIT)
    seq[REPEAT_AT: REPEAT_AT + UNIT * COPIES] = np.tile(unit, COPIES)
    return seq


def valid_windows_np(seq: np.ndarray, k: int) -> np.ndarray:
    """Host oracle of window validity: N-free, inside the sequence, and the
    trailing-exact-k quirk (a last window that starts a fresh region)."""
    is_n = (seq | 0x20) == ord("n")
    c = np.concatenate([[0], np.cumsum(is_n, dtype=np.int64)])
    starts = np.arange(seq.shape[0] - k + 1)
    ok = c[starts + k] == c[starts]
    last = seq.shape[0] - k
    if ok[-1] and (last == 0 or is_n[last - 1]):
        ok[-1] = False
    return ok


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    diff = a != b
    if not bool(diff.any()):
        return 0.0
    return max(1.0, float((a[diff].double() - b[diff].double()).abs().max()))


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: "
                           "chip_smoke.py needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    log(f"[device] torch.cuda.get_device_name: {name}")
    log(f"[device] nvidia-smi name, power.limit: {card}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"{torch.cuda.device_count()} visible")
    return name, card


def phase_build():
    from kmer_hasher_tpu_torch.ops import _build

    cached = _build.library_path().is_file()
    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    secs = time.perf_counter() - t0
    log(f"[build] {path.relative_to(ROOT)} "
        f"{'(cached) ' if cached else ''}in {secs:.2f} s: "
        f"nvcc {' '.join(_build.NVCC_FLAGS)}")
    for line in _build.build_log().splitlines():
        if "ptxas info" in line and ("registers" in line or "Compiling" in line):
            log(f"[build] {line.strip()}")


def phase_kernels(rng):
    """B1 against its plain version on the same CUDA tensors, bitwise."""
    from kmer_hasher_tpu_torch.ops import cuda_encode as b1

    dev = torch.device("cuda")
    L = 1 << 26
    flat = make_sequence(rng, L)
    x = torch.from_numpy(flat).to(dev)
    tl = L - 12_345
    B, W = 256, 1 << 14
    xb = torch.from_numpy(make_sequence(rng, B * W).reshape(B, W)).to(dev)
    lengths = rng.integers(0, W + 1, size=B).astype(np.int32)
    lens = torch.from_numpy(lengths).to(dev)
    worst = 0.0
    for k in KS_KERNEL:
        lens[:3] = torch.tensor([W, 0, k], dtype=torch.int32)
        for inp, t in ((x, tl), (xb, lens)):
            key, valid = b1.encode(inp, k, t)
            pk, pv = b1.plain(inp, k, t)
            torch.cuda.synchronize()
            err = max(max_abs_err(key, pk), max_abs_err(valid, pv))
            worst = max(worst, err)
            if err or not bool(valid.any()):
                raise AssertionError(
                    f"B1 disagrees with its plain version: k={k}, "
                    f"shape={tuple(inp.shape)}, max_abs_err={err}")
        del key, valid, pk, pv
    log(f"[kernels] B1 == plain, bitwise, k in {list(KS_KERNEL)}, on "
        f"[2^26] (true_len 2^26-12345) and [256, 2^14] ragged "
        f"(max_abs_err {worst})")
    return worst


def check_index(idx, seq: np.ndarray, k: int) -> None:
    """Invariants of a built index against the host oracle."""
    want = int(valid_windows_np(seq, k).sum())
    if idx.n_valid != want:
        raise AssertionError(f"k={k}: n_valid {idx.n_valid} != {want}")
    nv = idx.n_valid
    key, pos = idx.s_key[:nv], idx.s_pos[:nv]
    same = key[1:] == key[:-1]
    if bool((key[1:] < key[:-1]).any()) or bool(
            (same & (pos[1:] <= pos[:-1])).any()):
        raise AssertionError(f"k={k}: keys or positions out of order")


def phase_main(seq: np.ndarray):
    """The user's path on the card: build, tables, pair drain, query."""
    from kmer_hasher_tpu_torch import api
    from kmer_hasher_tpu_torch.ops import cuda_encode as b1

    b1.encode.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = api.make_kmer_hash(seq, 32, device="cuda")
    tabs = api.kmer_pos(idx, 2 | 8)
    n_rows, n_chunks = 0, 0
    # every pair row joins two positions of one k-mer: check through a
    # position -> key map, chunk by chunk, on the card
    key_at = torch.empty(idx.s_key.shape[0] + 1, dtype=torch.int64,
                         device=idx.device)
    key_at[idx.s_pos[: idx.n_valid].long()] = idx.s_key[: idx.n_valid]
    bad = torch.zeros((), dtype=torch.int64, device=idx.device)
    for chunk in idx.iter_pair_chunks():
        x, y = chunk[:, 1].long(), chunk[:, 2].long()
        bad += ((x >= y) | (key_at[x] != key_at[y])).sum()
        n_rows += chunk.shape[0]
        n_chunks += 1
    torch.cuda.synchronize()
    t_k32 = time.perf_counter() - t0

    check_index(idx, seq, 32)
    counts = tabs["count"].long()
    if int(counts.sum()) != idx.n_valid:
        raise AssertionError("counts do not sum to n_valid")
    if tabs["pos"].shape != (idx.n_valid, 2):
        raise AssertionError(f"pos table shape {tuple(tabs['pos'].shape)}")
    want_pairs = int((counts * (counts - 1) // 2).sum())
    if n_rows != want_pairs or int(bad) or n_chunks < 2:
        raise AssertionError(
            f"pair drain: {n_rows} rows in {n_chunks} chunks, want "
            f"{want_pairs} in >= 2; {int(bad)} rows join different k-mers")
    log(f"[main] k=32 make_kmer_hash + kmer_pos(2|8) + pair drain of "
        f"{SEQ_LEN:,} bases on the card: n_valid {idx.n_valid:,}, "
        f"{idx.n_kmers:,} distinct, {n_rows:,} pair rows in {n_chunks} "
        f"chunks, {t_k32:.3f} s")
    del idx, tabs, key_at

    k = 21
    t0 = time.perf_counter()
    idx = api.make_kmer_hash(seq, k, device="cuda")
    query = seq[QUERY_AT: QUERY_AT + QUERY_LEN]
    rows = api.seq_kmer_pos(idx, query, k)
    torch.cuda.synchronize()
    t_k21 = time.perf_counter() - t0
    check_index(idx, seq, k)
    own = rows[:, 1].long() == rows[:, 0].long() - k + 1 + QUERY_AT
    want = int(valid_windows_np(query, k).sum())
    if int(own.sum()) != want:
        raise AssertionError(
            f"seq_kmer_pos: {int(own.sum())} query windows hit their own "
            f"position, want {want}")
    log(f"[main] k=21 make_kmer_hash + seq_kmer_pos of a {QUERY_LEN:,}-base "
        f"query: {rows.shape[0]:,} rows, all {want:,} valid query windows "
        f"hit their own position, {t_k21:.3f} s")
    launches = b1.encode.launches
    if launches < 1:
        raise AssertionError("the main path never launched B1")
    log(f"[main] B1 launches during the main path: {launches}")
    return launches, t_k32


def phase_card_vs_cpu(seq: np.ndarray) -> None:
    from kmer_hasher_tpu_torch import api

    pre = seq[:PREFIX]
    query = pre[REPEAT_AT - 100_000: REPEAT_AT + 300_000]
    for k in (16, 21, 32):
        g = api.make_kmer_hash(pre, k, device="cuda")
        c = api.make_kmer_hash(pre, k, device="cpu")
        if g.n_valid != c.n_valid:
            raise AssertionError(f"k={k}: n_valid {g.n_valid} != {c.n_valid}")
        for name in ("s_key", "s_pos", "starts"):
            if not torch.equal(getattr(g, name).cpu(), getattr(c, name)):
                raise AssertionError(f"k={k}: {name} differs card vs CPU")
        tg, tc = api.kmer_pos(g, 2 | 8), api.kmer_pos(c, 2 | 8)
        for f in ("pos", "count"):
            if not torch.equal(tg[f].cpu(), tc[f]):
                raise AssertionError(f"k={k}: {f} table differs")
        pg = torch.cat([ch.cpu() for ch in g.iter_pair_chunks()])
        pc = torch.cat(list(c.iter_pair_chunks()))
        if not torch.equal(pg, pc):
            raise AssertionError(f"k={k}: pair rows differ")
        extra = ""
        if k <= 31:
            qg = api.seq_kmer_pos(g, query, k).cpu()
            if not torch.equal(qg, api.seq_kmer_pos(c, query, k)):
                raise AssertionError(f"k={k}: seq_kmer_pos rows differ")
            extra = f", {qg.shape[0]:,} seq_kmer_pos rows"
        log(f"[card-vs-cpu] k={k} on 2^22 bases: s_key, s_pos, starts, "
            f"n_valid ({g.n_valid:,}), pos/count tables, {pg.shape[0]:,} "
            f"pair rows{extra} — bitwise equal")


def phase_times(seq: np.ndarray, card: str):
    from kmer_hasher_tpu_torch import api
    from kmer_hasher_tpu_torch.index.position_index import build_index_arrays
    from kmer_hasher_tpu_torch.ops import cuda_encode as b1

    L = 1 << 26
    x = torch.full((L,), ord("N"), dtype=torch.uint8)
    x[:SEQ_LEN] = torch.from_numpy(seq)
    x = x.cuda()
    k = 32
    ms = cuda_ms(lambda: b1.encode(x, k, SEQ_LEN))
    plain_ms = cuda_ms(lambda: b1.plain(x, k, SEQ_LEN))
    log(f"[times] B1 encode, k=32, 2^26 bytes: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms (CUDA events, mean of 20) | {card}")

    times = []
    build_index_arrays(x, k, SEQ_LEN)
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = build_index_arrays(x, k, SEQ_LEN)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    del out
    med = statistics.median(times)
    log(f"[times] build_index_arrays, k=32, 2^26 windows: median "
        f"{med * 1e3:.3f} ms of 5 = {L / med:,.0f} k-mers/s "
        f"(window axis / time) | {card}")

    t0 = time.perf_counter()
    idx = api.make_kmer_hash(seq, k, device="cuda")
    n = sum(ch.shape[0] for ch in idx.iter_pair_chunks())
    torch.cuda.synchronize()
    full = time.perf_counter() - t0
    log(f"[times] make_kmer_hash(k=32) of {SEQ_LEN:,} bases from host + "
        f"drain of {n:,} pair rows: {full:.3f} s (warm) | {card}")
    return ms, plain_ms


# -- the counting path ------------------------------------------------------

def scan_batch(rng, k: int, rows: int = 2048, quals: str = "binned"):
    """A ragged [rows, READ_LEN] read batch on the card: mixed-case bases
    with N; lengths 0, k, k+1, full and random; binned, stress or uniform
    qualities."""
    L = READ_LEN
    seq = rng.choice(np.frombuffer(b"ACGTacgtN", np.uint8), size=(rows, L))
    if quals == "binned":
        q = rng.choice(np.frombuffer(QUAL_BINS, np.uint8), size=(rows, L),
                       p=QUAL_P)
    elif quals == "stress":  # phred 30-40 with ~2% low-quality bases
        q = rng.integers(63, 74, size=(rows, L)).astype(np.uint8)
        low = rng.random((rows, L)) < 0.02
        q[low] = rng.integers(35, 53, size=int(low.sum())).astype(np.uint8)
    else:
        q = (33 + rng.integers(0, 42, size=(rows, L))).astype(np.uint8)
    lengths = rng.integers(0, L + 1, size=rows).astype(np.int32)
    lengths[:4] = (0, k, k + 1, L)
    return tuple(torch.from_numpy(a).cuda() for a in (seq, q, lengths))


def phase_kernels_scan(rng) -> float:
    """B2 against its plain version on the same CUDA tensors, bitwise:
    emit, both registers at every position, and the flag."""
    from kmer_hasher_tpu_torch.ops import cuda_scan as b2
    from kmer_hasher_tpu_torch.ops.scan_iter import ll_table_f32
    from kmer_hasher_tpu_torch.qll import Q_TO_LL

    worst = 0.0

    def compare(args, k, min_ll, kw, what):
        nonlocal worst
        got = b2.scan(*args, k, min_ll, **kw)
        want = b2.plain(*args, k, min_ll, **kw)
        torch.cuda.synchronize()
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        worst = max(worst, err)
        if err or len(got) != len(want):
            raise AssertionError(
                f"B2 disagrees with its plain version: {what}, "
                f"max_abs_err={err}")
        return got

    min_ll = float(Q_TO_LL[33 + MIN_Q])
    n_emit = n_flag = 0
    for k in KS_SCAN:
        for quals in ("binned", "stress", "uniform"):
            args = scan_batch(rng, k, quals=quals)
            for name, kw in VARIANTS.items():
                got = compare(args, k, min_ll, kw, f"{name}, k={k}, {quals}")
                n_emit += int(got[0].sum())
                n_flag += int(got[3].sum()) if len(got) > 3 else 0
    if not n_emit:
        raise AssertionError("B2 check: no window was emitted at all")
    # thresholds swept around achievable window sums, so comparisons land
    # inside the tracked error band and reads flag: low random qualities
    # (large |ll|, a wide band) and one constant quality (every window sum
    # sits on the threshold)
    k, B, L = 9, 2048, 40
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=(B, L))]
    lens = np.full(B, L, np.int32)
    swept = 0
    for qual in ((33 + rng.integers(2, 11, size=(B, L))).astype(np.uint8),
                 np.full((B, L), 33 + 40, np.uint8)):
        sums = np.sort(np.lib.stride_tricks.sliding_window_view(
            ll_table_f32()[qual].astype(np.float64), k + 1, axis=1
        ).sum(-1).ravel())
        args = tuple(torch.from_numpy(a).cuda() for a in (seq, qual, lens))
        for anchor in (sums[sums.size // 6], sums[sums.size // 2]):
            for off in (-3e-6, -2.5e-6, 0.0, 1.5e-6, 2e-6, 2.5e-6, 3e-6):
                got = compare(args, k, float(anchor + off),
                              dict(precision="fast", return_flags=True),
                              f"threshold sweep, {anchor} + {off}")
                swept += int(got[3].sum())
    if not swept:
        raise AssertionError("B2 threshold sweep flagged no read")
    # the shape the counting path launches: [ROWS, READ_LEN] full-length
    # reads, k=21 (232 blocks of 128 threads against 16 above)
    for quals in ("binned", "stress"):
        args = scan_batch(rng, K_COUNT, rows=ROWS, quals=quals)
        args[2][4:] = READ_LEN
        for name, kw in VARIANTS.items():
            got = compare(args, K_COUNT, min_ll, kw,
                          f"{name}, k={K_COUNT}, {quals}, main shape")
            if not int(got[0].sum()):
                raise AssertionError("B2 at the main shape emitted nothing")
    log(f"[kernels] B2 == plain, bitwise (emit, fwd and rc at every "
        f"position, flag), instantiations {list(VARIANTS)}, k in "
        f"{list(KS_SCAN)}, on ragged [2048, {READ_LEN}] batches with binned, "
        f"stress and uniform qualities ({n_emit:,} windows emitted, "
        f"{n_flag:,} reads flagged) and 28 thresholds swept around window "
        f"sums at k=9 ({swept:,} reads flagged), and at the counting "
        f"path's shape [{ROWS}, {READ_LEN}], k={K_COUNT}, full-length reads "
        f"with binned and stress qualities (max_abs_err {worst})")
    return worst


def make_genome(gen) -> torch.Tensor:
    """GENOME_LEN base indices 0..3 (into b"ACGT") on the card."""
    return torch.randint(0, 4, (GENOME_LEN,), generator=gen, device="cuda",
                         dtype=torch.uint8)


def draw_reads(genome: torch.Tensor, gen, rows: int):
    """One (seq, qual, lengths, has_qual) batch drawn on the card: reads of
    READ_LEN bases from either strand of the genome with SUB_RATE
    substitutions, NovaSeq-binned qualities."""
    dev = genome.device
    L = READ_LEN

    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev)

    start = torch.randint(0, GENOME_LEN - L + 1, (rows, 1), generator=gen,
                          device=dev)
    idx = genome[start + torch.arange(L, device=dev)]
    minus = rand((rows, 1)) < 0.5  # reverse complement: 3 - index, flipped
    idx = torch.where(minus, 3 - idx.flip(1), idx)
    sub = rand((rows, L)) < SUB_RATE
    shift = torch.randint(1, 4, (rows, L), generator=gen, device=dev,
                          dtype=torch.uint8)
    idx = torch.where(sub, (idx + shift) & 3, idx)
    seq = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=dev)[
        idx.long()]
    u = rand((rows, L))
    edges = np.cumsum(QUAL_P)[:-1].tolist()
    pick = sum((u >= e).long() for e in edges)
    qual = torch.tensor(list(QUAL_BINS), dtype=torch.uint8, device=dev)[pick]
    return (seq, qual,
            torch.full((rows,), L, dtype=torch.int32, device=dev),
            torch.ones(rows, dtype=torch.bool, device=dev))


def reset_launches():
    from kmer_hasher_tpu_torch.ops import cuda_encode as b1
    from kmer_hasher_tpu_torch.ops import cuda_scan as b2

    b1.encode.launches = 0
    b2.scan.launches = 0


def read_launches():
    from kmer_hasher_tpu_torch.ops import cuda_encode as b1
    from kmer_hasher_tpu_torch.ops import cuda_scan as b2

    return b1.encode.launches, b2.scan.launches


def write_fastq(path: Path, batches, n_reads: int) -> None:
    """The first ``n_reads`` reads of the staged batches as 4-line FASTQ."""
    with open(path, "wb") as f:
        left = n_reads
        for seq, qual, _len, _hq in batches:
            s, q = seq[:left].cpu().numpy(), qual[:left].cpu().numpy()
            for i in range(s.shape[0]):
                f.write(b"@r\n" + s[i].tobytes() + b"\n+\n"
                        + q[i].tobytes() + b"\n")
            left -= s.shape[0]
            if left <= 0:
                return


def phase_main_counting(genome: torch.Tensor, batches):
    """The user's counting path on the card: the batch loop of
    count_kmers_fq_sh_rp over device-staged reads, flush, spectrum, depth;
    then the file entry with a checkpoint round trip."""
    from kmer_hasher_tpu_torch import api, counting
    from kmer_hasher_tpu_torch.utils import checkpoint

    k = K_COUNT
    n_reads = len(batches) * ROWS
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store = api.CountStore(k, counts_n=1, mode="sh")  # on the card
    stats = {}
    counting.count_batches(store, batches, k, min_q=MIN_Q,
                           exact_ll="hybrid", stats=stats)
    flagged = stats["flagged_reads"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spec = api.kmer_spectrum(store, 255)
    stretch = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device="cuda")[
        genome[DEPTH_AT: DEPTH_AT + DEPTH_LEN].long()]
    depth = api.seq_kmer_depth(store, stretch, k)
    torch.cuda.synchronize()
    b1_n, b2_n = read_launches()

    total = int(store.total_added.sum())
    if store.device.type != "cuda" or store.keys.device.type != "cuda":
        raise AssertionError("the store does not live on the card")
    if int(store.cnt.sum()) != total or total <= 0:
        raise AssertionError("counts do not sum to total_added")
    if spec.shape != (256,) or int(spec.sum()) != store.n_unique:
        raise AssertionError("the spectrum does not sum to n_unique")
    if not bool((store.keys[1:] > store.keys[:-1]).all()):
        raise AssertionError("the base table is not sorted and unique")
    # error k-mers pile up at counts 1-2; genomic ones around the kept
    # coverage: observations over the genome's distinct k-mers
    cover = total / GENOME_LEN
    lo = max(3, int(0.4 * cover))
    mode = lo + int(np.argmax(spec[lo:255]))
    if not 0.6 * cover <= mode <= 1.2 * cover:
        raise AssertionError(
            f"spectrum mode {mode} is not near the kept coverage "
            f"{cover:.1f}")
    windows = depth[:, : DEPTH_LEN - k + 1]
    if depth.shape != (1, DEPTH_LEN) or bool((windows == NA).any()):
        raise AssertionError("depth is NA on an N-free stretch")
    if not bool((depth[:, DEPTH_LEN - k + 1:] == NA).all()):
        raise AssertionError("depth is set where no window fits")
    med = float(windows.float().median())
    if not 0.6 * cover <= med <= 1.2 * cover:
        raise AssertionError(f"median depth {med} vs coverage {cover:.1f}")
    if b1_n < 1 or b2_n < 1:
        raise AssertionError(
            f"the counting path launched B1 {b1_n} and B2 {b2_n} times")
    tm = store.timings
    log(f"[main] counting: {len(batches)} batches x {ROWS:,} reads x "
        f"{READ_LEN} bases = {n_reads:,} reads, k={k}, min_q={MIN_Q}, "
        f"hybrid: {total:,} observations kept of "
        f"{n_reads * (READ_LEN - k + 1):,} windows, {store.n_unique:,} "
        f"distinct, {flagged:,} reads flagged and re-counted in f64, "
        f"{tm['tier_merges']} tier merges, {wall:.3f} s")
    log(f"[main] counting: spectrum(255) sums to n_unique, mode {mode} at "
        f"kept coverage {cover:.1f}; depth over {DEPTH_LEN:,} bases has no "
        f"NA, median {med:.0f}; B1 launches {b1_n}, B2 launches {b2_n}")

    with tempfile.TemporaryDirectory() as tmp:
        fq = Path(tmp) / "reads.fq"
        write_fastq(fq, batches, FILE_READS)
        # the file entry is a path of its own: its launches are counted
        # apart, before the check below runs the kernel again
        reset_launches()
        t0 = time.perf_counter()
        st = api.count_kmers_fq_sh_rp(str(fq), k=k, min_q=MIN_Q)
        torch.cuda.synchronize()
        t_file = time.perf_counter() - t0
        b1_file, b2_file = read_launches()
        if b2_file < 1:
            raise AssertionError("the file entry never launched B2")
        if st.device.type != "cuda":
            raise AssertionError("the file entry did not run on the card")
        want = api.CountStore(k)
        cut = [tuple(a[:FILE_READS - i * ROWS] for a in b)
               for i, b in enumerate(batches[: -(-FILE_READS // ROWS)])]
        counting.count_batches(want, cut, k, min_q=MIN_Q, exact_ll=True)
        ck = Path(tmp) / "store.npz"
        checkpoint.save_count_store(st, ck)
        back = checkpoint.load_count_store(ck)
        for other, what in ((want, "the staged batches"),
                            (back, "its checkpoint")):
            if not (torch.equal(st.keys, other.keys)
                    and torch.equal(st.cnt, other.cnt)
                    and (st.total_added == other.total_added).all()):
                raise AssertionError(f"file count differs from {what}")
    log(f"[main] count_kmers_fq_sh_rp of a {FILE_READS:,}-read FASTQ file "
        f"(pure-Python reader, pinned copies): {st.n_unique:,} distinct, "
        f"equal to the same reads staged on the card; checkpoint round "
        f"trip exact; {t_file:.3f} s; B1 launches {b1_file}, B2 launches "
        f"{b2_file}")
    launches = {"counting": (b1_n, b2_n), "file": (b1_file, b2_file)}
    return launches, {"wall": wall, "timings": dict(tm), "n_reads": n_reads,
                      "flagged": flagged}


def phase_hybrid_full_width(rng) -> int:
    """The hybrid filter with real flags at the counting path's width: the
    cell's binned qualities flag next to no read, so STRESS_BATCHES batches
    of [ROWS, READ_LEN] with stress qualities (window sums near the
    threshold) go through the loop in hybrid and in exact mode. Some reads
    must flag, the f64 re-scan must launch, and the two stores must be
    equal. Returns the number of f64 re-scan launches."""
    from kmer_hasher_tpu_torch import api, counting

    k = K_COUNT
    batches = []
    for _ in range(STRESS_BATCHES):
        seq, qual, lengths = scan_batch(rng, k, rows=ROWS, quals="stress")
        lengths[ROWS // 2:] = READ_LEN
        batches.append((seq, qual, lengths,
                        torch.ones(ROWS, dtype=torch.bool, device="cuda")))
    reset_launches()
    stats = {}
    hyb = counting.count_batches(api.CountStore(k), batches, k, min_q=MIN_Q,
                                 exact_ll="hybrid", stats=stats)
    torch.cuda.synchronize()
    rescans = read_launches()[1] - len(batches)
    exact = counting.count_batches(api.CountStore(k), batches, k,
                                   min_q=MIN_Q, exact_ll=True)
    flagged = stats["flagged_reads"]
    if flagged < 1 or rescans < 1:
        raise AssertionError(
            f"hybrid at full width: {flagged} reads flagged, {rescans} f64 "
            f"re-scans launched")
    if not (torch.equal(hyb.keys, exact.keys)
            and torch.equal(hyb.cnt, exact.cnt)
            and (hyb.total_added == exact.total_added).all()):
        raise AssertionError("hybrid differs from exact at full width")
    log(f"[main] hybrid at full width: {len(batches)} batches x {ROWS:,} "
        f"reads x {READ_LEN} with stress qualities: {flagged:,} reads "
        f"flagged, {rescans} f64 re-scans of the flagged rows launched, "
        f"{hyb.n_unique:,} distinct k-mers — equal to exact_ll=True")
    return rescans


def phase_card_vs_cpu_counting(genome: torch.Tensor, batches) -> None:
    """2 batches cut to 2,048 rows through all three likelihood modes and a
    two-source store, on the card and on the CPU: bitwise equal."""
    from kmer_hasher_tpu_torch import api, counting
    from kmer_hasher_tpu_torch.qll import Q_TO_LL

    k = K_COUNT
    cut = [tuple(a[:2048] for a in b) for b in batches[:2]]
    host = [tuple(a.cpu() for a in b) for b in cut]
    probe = torch.tensor(list(b"ACGT"), dtype=torch.uint8)[
        genome[:50_000].cpu().long()]
    stores = {}
    for mode in (True, False, "hybrid"):
        for dev, bs in (("cuda", cut), ("cpu", host)):
            st = api.CountStore(k, counts_n=2, device=dev)
            for source in (0, 1):
                counting.count_batches(st, bs[source:], k, min_q=MIN_Q,
                                       source=source, exact_ll=mode)
            stores[mode, dev] = st
        g, c = stores[mode, "cuda"], stores[mode, "cpu"]
        same = (torch.equal(g.keys.cpu(), c.keys)
                and torch.equal(g.cnt.cpu(), c.cnt)
                and (g.total_added == c.total_added).all()
                and g.counts_dict() == c.counts_dict()
                and (api.kmer_spectrum(g, 255)
                     == api.kmer_spectrum(c, 255)).all()
                and torch.equal(api.seq_kmer_depth(g, probe, k).cpu(),
                                api.seq_kmer_depth(c, probe, k)))
        if not same:
            raise AssertionError(f"exact_ll={mode!r}: card and CPU differ")
    e, h = stores[True, "cuda"], stores["hybrid", "cuda"]
    if not (torch.equal(e.keys, h.keys) and torch.equal(e.cnt, h.cnt)):
        raise AssertionError("hybrid differs from exact on the card")
    # host numpy batches of changing size reach the card through the two
    # reused sets of pinned staging buffers: five batches, so both are
    # overwritten while earlier copies are in flight
    sizes = (2048, 1500, 2048, 700, 1)
    staged = [tuple(a[:n] for a in cut[i % 2]) for i, n in enumerate(sizes)]
    from_host = [tuple(a.cpu().numpy() for a in b) for b in staged]
    g, c = (counting.count_batches(api.CountStore(k), bs, k, min_q=MIN_Q,
                                   exact_ll="hybrid")
            for bs in (from_host, staged))
    if not (torch.equal(g.keys, c.keys) and torch.equal(g.cnt, c.cnt)):
        raise AssertionError("host batches through pinned buffers differ "
                             "from the same reads staged on the card")
    min_ll = float(Q_TO_LL[33 + MIN_Q])
    fg, fc = (counting._fused_rp_batch(
        *b, k, 1, 0, min_ll, "hybrid", min_q_char=33 + MIN_Q)[3]
        for b in (cut[0], host[0]))
    if not torch.equal(fg.cpu(), fc):
        raise AssertionError("hybrid flags differ card vs CPU")
    # real flags are rare: drive the sweep (flagged rows compacted on the
    # device, re-counted in f64) with every 7th read flagged by hand
    swept = {}
    for dev, b in (("cuda", cut[0]), ("cpu", host[0])):
        flags = (torch.arange(b[0].shape[0], device=b[0].device) % 7) == 3
        st = api.CountStore(k, device=dev)
        n = counting._sweep_backlog(
            st, [(*b[:3], flags, counting.win_bucket(READ_LEN, k),
                  flags.sum())], k, 0, min_ll)
        swept[dev] = (st.flush(), n)
    want = api.CountStore(k)
    rows = torch.arange(3, cut[0][0].shape[0], 7, device="cuda")
    counting.count_batches(want, [tuple(a[rows] for a in cut[0])], k,
                           min_q=MIN_Q)
    g, c = swept["cuda"][0], swept["cpu"][0]
    if not (swept["cuda"][1] == swept["cpu"][1] == rows.numel()
            and torch.equal(g.keys, want.keys)
            and torch.equal(g.cnt, want.cnt)
            and torch.equal(g.keys.cpu(), c.keys)
            and torch.equal(g.cnt.cpu(), c.cnt)):
        raise AssertionError("the exact sweep of flagged reads differs")
    log(f"[card-vs-cpu] counting, 2 batches x 2,048 reads, two sources, "
        f"exact_ll in (True, False, 'hybrid'): keys, counts, counts_dict "
        f"({e.n_unique:,} k-mers), total_added, spectrum(255), depth over "
        f"50,000 bases and the hybrid flags ({int(fg.sum())} set) — "
        f"bitwise equal; hybrid == exact on the card; {len(sizes)} host "
        f"batches through the pinned staging buffers equal the same reads "
        f"staged; the f64 sweep of "
        f"{rows.numel()} hand-flagged reads equals their exact count on "
        f"both devices")


def device_busy_share(fn):
    """(host seconds, share of them in which the card ran a kernel or a
    copy) of ``fn``, from torch.profiler; share None if the trace holds no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = 0.0
    for e in prof.key_averages():
        busy_us += getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))
    return wall, (busy_us * 1e-6 / wall if busy_us > 0 else None)


def phase_times_counting(batches, card: str, main_stats: dict):
    from kmer_hasher_tpu_torch import api, counting
    from kmer_hasher_tpu_torch.ops import cuda_scan as b2
    from kmer_hasher_tpu_torch.qll import Q_TO_LL

    k = K_COUNT
    min_ll = float(Q_TO_LL[33 + MIN_Q])
    seq, qual, lengths, has_qual = batches[0]
    ms, plain_ms = {}, {}
    for name, kw in VARIANTS.items():
        ms[name] = cuda_ms(lambda: b2.scan(seq, qual, lengths, k, min_ll,
                                           **kw))
        plain_ms[name] = cuda_ms(
            lambda: b2.plain(seq, qual, lengths, k, min_ll, **kw),
            iters=2, warmup=1)
        log(f"[times] B2 ll_scan {name}, k={k}, [{ROWS} x {READ_LEN}]: "
            f"kernel {ms[name]:.4f} ms (CUDA events, mean of 20), plain "
            f"{plain_ms[name]:.4f} ms (mean of 2) | {card}")

    n_reads = len(batches) * ROWS

    def rate(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def e2e():
        st = api.CountStore(k)
        counting.count_batches(st, batches, k, min_q=MIN_Q,
                               exact_ll="hybrid")
        return st

    def fused():
        for b in batches:
            counting._fused_rp_batch(*b, k, 1, 0, min_ll, "hybrid",
                                     min_q_char=33 + MIN_Q,
                                     n_win=counting.win_bucket(READ_LEN, k))

    def fsm():
        for b in batches:
            b2.scan(*b[:3], k, min_ll, **VARIANTS["f32+flags"])

    for name, fn in (("FSM", fsm), ("FUSED", fused)):
        t = min(rate(fn), rate(fn))
        log(f"[times] counting {name}: {t:.3f} s for {n_reads:,} reads = "
            f"{n_reads / t:,.0f} reads/s ({t / len(batches) * 1e3:.2f} "
            f"ms/batch; best of 2) | {card}")
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = e2e()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, dict(st.timings)))
        del st
    runs.append((main_stats["wall"], main_stats["timings"]))
    t, tm = min(runs, key=lambda r: r[0])
    log(f"[times] counting E2E (loop + LSM store + sweep + fold): {t:.3f} s "
        f"for {n_reads:,} reads = {n_reads / t:,.0f} reads/s (best of 3: "
        f"{', '.join(f'{r[0]:.3f}' for r in runs)} s); tier merges "
        f"{tm['tier_merge_s']:.3f} s = {tm['tier_merge_s'] / t:.1%} of the "
        f"wall ({tm['tier_merges']} merges, {tm['tier_merge_rows']:,} rows "
        f"in), final fold {tm['fold_s']:.3f} s = {tm['fold_s'] / t:.1%} "
        f"| {card}")
    def window():
        st = api.CountStore(k)
        counting.count_batches(st, batches, k, min_q=MIN_Q, exact_ll="hybrid")

    # the whole 64-batch loop, twice: the first pass also pays for the
    # profiler's start; both are printed so the spread shows
    shares = [device_busy_share(window) for _ in range(2)]
    idle = ", ".join(
        "not measured (the trace holds no device time)" if busy is None
        else f"{1 - busy:.1%} of host {wall:.3f} s (device busy "
             f"{busy * wall:.3f} s)" for wall, busy in shares)
    log(f"[times] counting loop under torch.profiler, all {len(batches)} "
        f"batches, two passes: device idle share {idle} | {card}")
    return ms, plain_ms


def bound(bytes_moved: float, ops: float):
    """(least milliseconds the card could take, which limit binds)."""
    by, op = bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(by, op) * 1e3, "bytes" if by >= op else "operations"


def main() -> None:
    name, card = phase_device()
    phase_build()
    rng = np.random.default_rng(SEED)
    worst_b1 = phase_kernels(rng)
    worst_b2 = phase_kernels_scan(rng)
    seq = make_sequence(rng, SEQ_LEN)
    reset_launches()
    b1_index, _ = phase_main(seq)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    genome = make_genome(gen)
    batches = [draw_reads(genome, gen, ROWS) for _ in range(N_BATCHES)]
    torch.cuda.synchronize()
    launches, stats = phase_main_counting(genome, batches)
    launches["index"] = (b1_index, 0)
    by_path = [{p: launches[p][i] for p in ("index", "counting", "file")}
               for i in (0, 1)]
    swept = phase_hybrid_full_width(rng)
    phase_card_vs_cpu(seq)
    phase_card_vs_cpu_counting(genome, batches)
    b1_ms, b1_plain = phase_times(seq, card)
    b2_ms, b2_plain = phase_times_counting(batches, card, stats)
    # least time for the same work: every input byte read once, every output
    # byte written once; B1 does ~4 integer ops per base of each window, B2
    # ~60 float and integer ops per (read, position)
    n1 = 1 << 26
    b1_bound = bound(n1 * (1 + 8 + 1) + 4, n1 * 32 * 4)
    n2 = ROWS * READ_LEN
    b2_bound = bound(n2 * (2 + 1 + 8 + 8) + ROWS * (4 + 1) + 256 * 4,
                     n2 * 60)
    main_variant = "f32+flags"
    log(json.dumps({"kernels": [{
        "name": "B1 encode",
        "route": "cuda",
        "source": "kmer_hasher_tpu_torch/csrc/encode.cu",
        "replaces": "kmer_hasher_tpu/ops/pallas_encode.py:91",
        "launches": by_path[0]["index"],
        "launches_by_path": by_path[0],
        "max_abs_err": worst_b1,
        "ms": b1_ms,
        "plain_ms": b1_plain,
        "bound_ms": b1_bound[0],
        "bound_by": b1_bound[1],
        "library_ms": None,
    }, {
        "name": "B2 ll_scan",
        "route": "cuda",
        "source": "kmer_hasher_tpu_torch/csrc/ll_scan.cu",
        "replaces": "kmer_hasher_tpu/ops/pallas_scan.py:150",
        "launches": by_path[1]["counting"],
        "launches_by_path": by_path[1],
        "f64_rescans_at_full_width": swept,
        "max_abs_err": worst_b2,
        "ms": b2_ms[main_variant],
        "plain_ms": b2_plain[main_variant],
        "bound_ms": b2_bound[0],
        "bound_by": b2_bound[1],
        "library_ms": None,
        "instantiation": main_variant,
        "ms_by_instantiation": b2_ms,
        "plain_ms_by_instantiation": b2_plain,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
