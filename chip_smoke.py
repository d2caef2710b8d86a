#!/usr/bin/env python3
"""Smoke run of the PyTorch port's position-index path on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printing its own lines; any failure raises and the exit code
is nonzero:

1. device  — needs torch.cuda; prints the card and its power limit;
2. build   — compiles kmer_hasher_tpu_torch/csrc/*.cu with nvcc (sm_90a);
3. kernels — B1 against its plain PyTorch version on the card, bitwise,
             on a 2^26-byte sequence and a [256, 2^14] ragged batch;
4. main    — make_kmer_hash(k=32) of a 40,000,000-base sequence on the
             card, kmer_pos(2|8), the full pair drain, then a k=21 index
             and seq_kmer_pos with a 1,000,000-base query, with checks;
5. card vs CPU — k in {16, 21, 32} on a 2^22-base prefix, bitwise;
6. times   — B1 vs plain, build_index_arrays at 2^26, the full path.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Imports neither JAX nor kmer_hasher_tpu.
"""
import json
import statistics
import subprocess
import sys
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


def main() -> None:
    name, card = phase_device()
    phase_build()
    rng = np.random.default_rng(SEED)
    worst = phase_kernels(rng)
    seq = make_sequence(rng, SEQ_LEN)
    launches, _ = phase_main(seq)
    phase_card_vs_cpu(seq)
    ms, plain_ms = phase_times(seq, card)
    log(json.dumps({"kernels": [{
        "name": "B1 encode",
        "route": "cuda",
        "source": "kmer_hasher_tpu_torch/csrc/encode.cu",
        "replaces": "kmer_hasher_tpu/ops/pallas_encode.py:91",
        "launches": launches,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
