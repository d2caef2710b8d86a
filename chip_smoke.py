#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: the position-index path
(also sharded by key hash over 8 logical shards), the quality-filtered
counting path (also into 8 key-hash shards, in one process and over gloo
ranks that share the card), the per-base-threshold
entries, the sort-design probes of both rounds and the DMA probes, the
count store's spill regime with its ranged out-of-core fold, the
command line over the native reader, and the user scripts and measurement
entry points (bench, the counting probes, the examples), end to end.

    python3 chip_smoke.py          # from the root of a checkout

(``--rank SPEC RANK`` runs one rank of the sharded_procs, the
sharded_index_procs or the procs_devices phase; the phases start their
ranks so.)

Phases, each printing its own lines; any failure raises and the exit code
is nonzero:

1. device  — needs torch.cuda; prints the card and its power limit;
2. build   — compiles kmer_hasher_tpu_torch/csrc/*.cu with nvcc (sm_90a);
3. kernels — B1 (encode; also on the edges of its 4,096-window tiles:
             starts 1, 3 and 15 bytes off the 16-byte boundary, the counting
             batch [29,696, 151] with lengths 0, k-1, k, 151 and ragged from
             the card and from the host, rows of the tile -1, the tile and
             the tile +1, N at tile edges and in the halo, and the sharded
             index's build batches: 8 chunks of 2^23 of 40,000,000 bases
             and 8 of 16 of 40 bases, each with its halo, rows past the end
             with lengths <= 0), B2
             (quality-likelihood FSM, three
             instantiations; also on the edges of its warp tiling: rows no
             multiple of 32, rows shorter than, equal to and a multiple of
             its 16-position chunk, rows over one 512-position window, k = 1
             and k = 32) and B3 (merge path: sort-round shapes at 2^26,
             the five-key adversarial input, the count store's two-run
             shape with the implicit payload, edge shapes: pairs of the tile
             +-1, one key across tiles, one side empty across tiles, and
             payloads >= 2^31 at the last sort round) and the probe
             kernels P1-P4 (copy, copy from device-known offsets at granules
             1,024 / 8 / 1, rotation by device-known shifts; at the TPU
             probes' shapes and at 2^26 elements) against their plain
             PyTorch versions on the card, bitwise, at the shapes the main
             paths launch them with; the round-3 probe kernels P5-P8 (row
             windows copied in step order, also with write windows made to
             overlap, and rows no step writes on memory that held -1; a
             gather of 2 KB records; P2's copies through
             cp.async; a gather from a table in shared memory; at the TPU
             probes' shapes, at 2^26 elements and on edge inputs) the same
             way; the DMA probe kernels P9 (row windows copied in step order
             through a ring of shared-memory stages, and D2 with the offsets
             computed) and P10 (a per-lane lookup table) at the TPU probes'
             shapes, at 2^26 and on edge inputs, over the whole output; P1
             and P10 also one below, at and above their blocks' tiles and
             P10's rounds of tasks, and off the 16-byte boundary; Q1 and
             Q2 (the query's bounds and hit expansion) at the query cell's
             lengths, 10 kb, 100 kb and 1 Mb at k=21, every chunk of a drain
             of 4,096 rows, and timed beside their bound;
4. main (index) — make_kmer_hash(k=32) of a 40,000,000-base sequence,
             kmer_pos(2|8), the full pair drain, then a k=21 index and
             seq_kmer_pos with a 1,000,000-base query, with checks;
   main (sharded index) — ShardedKmerIndex(seq, 32, make_mesh(8)) of the
             same sequence (chunks of 2^23, one B1 launch a build):
             tables(2|8) and the full pair drain equal the single index's
             bitwise, each hash shard holds only its owners' keys,
             lookup_counts and positions_of of 4,096 sampled keys equal its
             lookup_range; a k=21 sharded index: seq_kmer_pos of the query
             in ascending blocks and kmer_pairs_sharded against a sharded
             index of the query stretch equal the single index's (B3 never
             launches);
   main (sharded index procs) — the same path over several processes:
             gloo ranks of this script (``--rank SPEC RANK``) sharing the
             card, each through ShardedKmerIndex(seq, 32, make_mesh(8,
             distributed=True)): 2 ranks on the 40,000,000 bases, then 4
             ranks on 2^22 + 1 bases (ranks 2 and 3 encode no window);
             each rank's sha256 digests of its tables, pair drain,
             lookups, query rows and cross-index pairs equal the single
             KmerIndex's, its hash and range shards the one-process 8-shard
             index's, timed before and after the ranks;
             the slowest rank's walls and each rank's exchange and gather
             seconds and bytes; launches counted in the ranks (path
             sharded_index_procs: B1 once a build and once a query on every
             rank, B3 never);
5. main (counting) — 64 batches x 29,696 reads x 151 bases drawn on the
             card from a 4,000,000-base genome (both strands, 0.5%
             substitutions, NovaSeq-binned qualities), k=21, min_q=20,
             exact_ll="hybrid", through the loop the file entry uses; then
             flush, kmer_spectrum, seq_kmer_depth in both semantics (the
             exact-C track also against the CPU), with checks; B3 runs once
             per two-run merge of the store; then, as a path of its own,
             count_kmers_fq_sh_rp of a 50,000-read FASTQ file with a
             checkpoint round trip; then count_kmers_fq_sh and
             count_kmers_fq of that file (the threshold path), equal to the
             CPU's stores; then 4 full-width batches with stress qualities,
             where hybrid flags reads and re-scans them in f64, against
             exact. Kernel launches are counted per path (index, counting,
             file, threshold, probes, spill, probes_r3,
             cli, probes_dma, sharded, sharded_index, sharded_procs,
             sharded_index_procs, bench, e2e, hybrid_probe,
             sharded_hybrid, large_pairs, counting_stress, multidevice,
             procs_devices, demo), set
             to 0 just before each (in the ranks: at their start) and read
             just after, and with them the rows B3 merged;
   main (sharded) — the counting cell's reads through
             ShardedCountStore(21, make_mesh(8)) by the same loop, then
             spectrum and depth: the union of the 8 shard tables equals the
             single store's table bitwise, each shard holds only its
             owners' keys, spectra, total_added and depth are equal; later,
             count_kmers_fq_sh_rp(mesh=make_mesh(8)) of the command-line
             phase's FASTQ file gives the same shards;
   main (multidevice) — the shard group over several devices of one
             process: the counting cell's first 8 batches (hybrid) and the
             index cell's first 2^22 bases (k=32 tables(2|4|8) with the
             full pair drain, the k=21 query) through make_mesh(8,
             devices=["cuda:0", "cpu"]), 4 shards on the card and 4 in
             host memory, each output bitwise the logical 8-shard group's
             on the card; launches counted (path multidevice) and per card
             (B1, B2 and B3 on the card's half; the CPU half runs the
             plain versions), the bytes that crossed devices, both groups'
             walls; with two or more cards, the full counting cell and the
             40,000,000-base index through every card in turns with the
             logical group, with each card's peak memory (with one card, a
             line that says it was not run); dryrun_multichip(8) on the
             visible cards and on the mixed group;
   main (probes) — python -m kmer_hasher_tpu_torch.probes.sort_probes at
             log_n 26 through its entry point: E1 (P1), E2 at three granules
             (P2), E3 (P3), E3b (P4), E4 and E5 (plain sorts);
   main (probes r3) — python -m kmer_hasher_tpu_torch.probes.sort_probes_r3
             at log_n 26 through its entry point: R1 and R5 (plain), R2 at
             512 and 8 rows (P5), R2b (P6), R4 (P8, beside P1), R3 at two
             granules (P7, beside P2);
   main (probes dma) — python -m kmer_hasher_tpu_torch.probes.dma_probes_r3
             at log_n 26 through its entry point: D1 at 512, 64 and 8 rows
             and D2 at 512 (P9, beside P5), D3 at 2^20 and 2^26 (P10,
             beside P1), D4 at 2^26 and 2^24 (plain networks, beside B3);
   main (cli) — the counting cell's reads written as one FASTQ file, then in
             a subprocess python -m kmer_hasher_tpu_torch count (-k 21
             --min-q 20 --ll-mode hybrid): the reader must be the native
             one, the saved table equal to the staged store's, bitwise;
             spectrum and depth of that file through main(argv); in
             subprocesses again, on the first 50,000 reads a run cut by
             --max-reads with --checkpoint-every under KMH_NATIVE_IO=0 (the
             pure-Python reader) and resumed with --resume under the native
             reader equals the uncut native run; index -k 32 / tables and
             index -k 21 / query through main(argv) on a FASTA of the
             sequence's first 4,000,000 bases equal the in-process results;
             in-process, with launches counted, the file entry over the
             same file (path cli), with its reads/s and the parse / copy /
             wait split;
   main (sharded procs) — the sharded count store over several
             processes: gloo ranks of this script (``--rank SPEC RANK``)
             sharing the card, each counting with device "cuda" through
             count_kmers_fq_sh_rp(mesh=make_mesh(8, distributed=True)),
             hybrid: route (b) on 2 ranks over the command-line phase's
             FASTQ cut in byte ranges, route (a) on 4 ranks over the
             50,000-read file cut into 4 gzip files, route (c) on 2 ranks
             over the 50,000-read file in lockstep with checkpoint_every;
             each against the one-process 8-shard store on the card (timed
             before and after the ranks): every rank's shards bitwise, the
             spectrum, n_unique and total_added as every rank reads them,
             and (c)'s checkpoint reloaded onto 8 shards; a rank's nonzero
             exit or timeout fails the run; launches counted in the ranks
             (path sharded_procs);
   main (procs devices) — the shard group over processes and several
             devices a process: 2 gloo ranks of this script sharing the
             card, each on make_mesh(8, distributed=True, devices=[2
             devices]): with ["cuda:0", "cuda:0"] a rank the command-line
             phase's FASTQ through route (c) (lockstep) and route (b)
             (byte ranges), hybrid, and the 40,000,000-base k=32 index with
             tables(2|8), the drain and the k=21 query; with ["cuda:0",
             "cpu"] a rank (every exchange crossing devices, the CPU half on
             the plain versions) the first 8 batches' reads and the first
             2^22 bases; every rank's shards, spectrum, total_added,
             n_unique, index shards, tables, drain and query rows against
             the one-process logical 8-shard group on the card, every shard
             on device_of(d); launches counted in the ranks, per step and
             per card (path procs_devices);
   main (spill) — the full-corpus regime through its entry point
             probes.spill_regime.run (the twin of the JAX package's
             tools/chip_probes/spill_regime.py): 244 batches x 29,696
             uniform-random 151-base reads, k=21, min_q=20, through
             _fused_rp_batch and add_run into CountStore(spill_bytes=1.5
             GiB); flush by the ranged fold (fold_budget_bytes = 3 GiB,
             that script's value), spectrum(10); at least 2 spills, 4
             ranges and 5e8 distinct k-mers, and the sliced exact control
             (a second store fed only the keys whose top 10 of 42 bits are
             zero equals the big table's prefix bitwise); B3 runs once
             per two-run merge and once per range round (range_rounds);
   main (tools) — the user scripts and measurement entry points of the
             port at their sources' defaults, each a path of its own:
             python -m kmer_hasher_tpu_torch.bench (2^25, k=32, chain 8;
             B1 32 launches), probes.e2e_device_bench in 3 modes x 3
             quality models (64 batches x 29,696 reads; hybrid == exact in
             distinct and total), probes.hybrid_probe (16,384 reads, chain
             8), probes.sharded_hybrid_bench (16 batches; hybrid == exact),
             examples.large_pairs (40 Mbp at 300 copies, streamed to the
             host and drained on the card with equal checksums; 1,000
             copies drained on the card: more than 2^31 pairs, as many rows
             as the counts' sum of c(c-1)/2, the chunk across pair 2^31
             equal to the CPU's from the index's arrays) and
             examples.counting_stress (200,000 reads through the file
             entry), examples.demo on a seeded 60,000-base directory (every
             figure equal to the same tour on the CPU; its kernels' calls,
             recorded in a run before, held against their plain versions).
             Before the main paths, B1-B3 are held against their plain
             versions at these scripts' shapes;
6. card vs CPU — index tables for k in {16, 21, 32}; the sharded index
             of the first 2^22 bases on 8 shards for the same k (shards,
             splitters, range shards, tables, pair drain); counting in all
             three likelihood modes and a two-source store; a spilled store
             (memory and disk), a ranged fold and a drop-mode
             count_kmers_fq, bitwise; the count verb with --device cpu on a
             small file; 8 shards spilling to memory and to files, and the
             8-shard checkpoint onto 8 shards and into one store;
7. times   — B1 (k=32 and k=21), B2 and B3 vs plain (B3 also beside
             torch.sort of the
             concatenated keys, the one library call that computes a
             merge), P1-P10 vs plain and vs one library call each where
             one exists,
             each kernel and library call also by its device time
             (torch.profiler) and its host time per call; P10, P1 and P6
             against their library calls in turns;
             build_index_arrays, the index path, the sharded index's
             build beside the single build in turns, its range partition,
             tables + drain and the device's idle share over a sharded
             build, one threshold_scan batch, and the counting rates E2E /
             FUSED / FSM with the share of tier merges, of the fold, and
             the device's idle share over the whole 64-batch loop; the
             counting cell through one store and through 8 shards in turns.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Imports neither JAX nor kmer_hasher_tpu.
"""
import hashlib
import json
import os
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
# Q1 and Q2 at the query cell's lengths: its shortest, median and longest
QUERY_LENS, QUERY_SUB_RATE = (10_000, 100_000, 1_000_000), 0.01
PREFIX = 1 << 22
KS_KERNEL = (1, 4, 16, 17, 21, 31, 32)
KS_EDGE = (1, 2, 15, 16, 17, 21, 31, 32)  # B1 on the edges of its tiling
# the counting cell: the device-side end-to-end configuration of the JAX
# package's tools/chip_probes/e2e_device_bench.py
N_BATCHES, ROWS, READ_LEN = 64, 29_696, 151
K_COUNT, MIN_Q = 21, 20
GENOME_LEN, SUB_RATE = 4_000_000, 0.005
QUAL_BINS, QUAL_P = b"F:,#", (0.88, 0.08, 0.02, 0.02)  # NovaSeq RTA3
DEPTH_AT, DEPTH_LEN = 1_000_000, 1_000_000
FILE_READS = 50_000
STRESS_BATCHES = 4
# B3's shapes: a sort round of 2^26 rows (2^11 runs of 2^15, then the last
# round's 2 runs of 2^25), and the count store's tier merge at the size of
# the counting cell's last merges
SORT_N, SORT_ROWS = 1 << 26, 1 << 11
FIVE_N = 1 << 22
STORE_A, STORE_B = 7_000_000, 4_000_000
SIGN = -(2 ** 63)
KS_SCAN = (5, 16, 17, 21, 31, 32)
# B2's edges (rows, L, k): rows no multiple of the warp's 32, rows shorter
# than a 16-position chunk, one position, a multiple of the chunk, rows over
# one 512-position window; k = 1 and k = 32
B2_EDGES = ((1, READ_LEN, K_COUNT), (33, READ_LEN, K_COUNT),
            (ROWS + 1, READ_LEN, K_COUNT), (64, 8, 5), (64, 1, 1),
            (64, 16, 9), (64, 32, 32), (96, 160, 21), (40, 600, 21),
            (35, 1100, 31), (256, READ_LEN, 1), (256, READ_LEN, 32))
VARIANTS = {  # B2's three instantiations, as cuda_scan.scan selects them
    "f32": dict(precision="fast"),
    "f32+flags": dict(precision="fast", return_flags=True,
                      min_q_char=33 + MIN_Q),
    "f64": dict(precision="exact"),
}
# the probes: the TPU scripts' size and the full-card size
PROBE_REF_LOG_N, PROBE_LOG_N = 24, 26
GATHER_REF_LOG_N = 22  # the TPU probe's index count for P8
CLI_MIN_READS = 500_000  # the file's size where the temporary directory is small
CLI_CUT_READS, CLI_CKPT_EVERY = 30_000, 16_384
CLI_REF_LEN = 4_000_000  # the index verbs' FASTA: holds the repeat and the query
# the spill regime of tools/chip_probes/spill_regime.py in the JAX package
SPILL_BATCHES, SPILL_BYTES, SPILL_FOLD_BUDGET = 244, 3 << 29, 3 << 30
SPILL_MIN_DISTINCT = 500_000_000
# the DMA probes: the TPU script's row counts per copy and its gather size
DMA_ROWS, DMA_GATHER_REF_LOG_N = (512, 64, 8), 20
DIRTY_P5 = "rows no step writes, dirty memory, R=100"  # a case of P5
# the sharded store: 8 logical shards; card vs CPU on a cut of the cell
SHARDS, SH_CPU_BATCHES, SH_CPU_ROWS, SH_SPILL = 8, 8, 4096, 1 << 20
SH_LOOKUPS = 4096  # keys the sharded index's lookups are held on
SH_CHUNK = 1 << (-(-SEQ_LEN // SHARDS) - 1).bit_length()  # its chunk, 2^23
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
    """Mean milliseconds per call between CUDA events, after a warm-up:
    the device's time where it is busy, the host's where a call's host work
    outlasts its kernels (``device_split`` says which)."""
    from kmer_hasher_tpu_torch.probes._common import events_ms

    for _ in range(warmup):
        fn()
    return events_ms(fn, iters)


# the probe rows that phase_times_turns times in turns, by (kernel, shape
# here) -> its shape there: their device and host figures are the turns'
TURN_SHAPES = {("P1", "ref"): "2^24", ("P1", "full"): "2^26",
               ("P6", "ref"): "4,096 records",
               ("P6", "full"): "131,072 records",
               ("P10", "ref"): "2^20", ("P10", "full"): "2^26"}


def device_split(fn, lib=None, iters: int = 20, key=None) -> dict:
    """Where a call's time goes, beside the events figure of cuda_ms:
    ``device_ms``, what one call ran on the card by torch.profiler's kernel
    durations (None where the trace holds no device time), and
    ``host_us_per_call``, the host's clock around ``iters`` calls with no
    synchronisation; ``library_device_ms`` of the library call ``lib`` the
    same way (None where there is none). Nothing for a probe row ``key``
    of TURN_SHAPES: the turns measure it, and it is profiled once."""
    from kmer_hasher_tpu_torch.probes._common import device_ms, host_us

    if key in TURN_SHAPES:
        return {}
    return {"device_ms": device_ms(fn, iters),
            "host_us_per_call": host_us(fn, iters),
            "library_device_ms": None if lib is None else device_ms(
                lib, iters)}


def split_txt(row: dict) -> str:
    """The device and host figures of a row, for its log line."""
    if "device_ms" not in row:
        return "; device and host in the [turns] lines"

    def ms(v):
        return "not measured" if v is None else f"{v:.4f} ms"

    txt = (f"; device {ms(row['device_ms'])}, host "
           f"{row['host_us_per_call']:.1f} us/call")
    if row["library_device_ms"] is not None:
        txt += f", library call on the device {ms(row['library_device_ms'])}"
    return txt


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
    from kmer_hasher_tpu_torch.parallel.sharded import chunk_rows

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
    # the edges of the kernel's tiling, from a generator of their own so
    # that the sequence and the reads below stay what the seed made them
    erng = np.random.default_rng(SEED + 9)
    tile = b1.TILE

    def n_at_tile_edges(a):
        """N at each tile's first and last byte and in the halo that the
        tile before reads."""
        flat = a.reshape(-1)
        for e in range(tile, flat.shape[0], tile):
            for d in (-1, 0, 1, 30):
                if e + d < flat.shape[0]:
                    flat[e + d] = ord("N")
        return a

    def bases(shape):
        return erng.choice(np.frombuffer(b"ACGTacgtN", np.uint8), size=shape,
                           p=[0.124] * 8 + [0.008])

    cb = torch.from_numpy(bases((ROWS, READ_LEN))).to(dev)
    cb_len = erng.integers(0, READ_LEN + 1, size=ROWS)
    around = {rl: torch.from_numpy(n_at_tile_edges(bases((64, rl)))).to(dev)
              for rl in (tile - 1, tile, tile + 1)}
    edge_1d = torch.from_numpy(n_at_tile_edges(bases(1 << 20))).to(dev)
    edges = 0
    for k in KS_EDGE:
        cb_len[:4] = (0, k - 1, k, READ_LEN)
        cases = [(f"[2^26 - 16] from byte offset {off}",
                  x[off: off + L - 16], L - 16 - 7) for off in (1, 3, 15)]
        cases += [("[29,696, 151], lengths 0, k-1, k, 151 and ragged, on "
                   "the card", cb, torch.from_numpy(cb_len).to(dev)),
                  ("[29,696, 151], the same lengths from the host", cb,
                   cb_len.astype(np.int32))]
        cases += [(f"[64, {rl}], N at the tile edges", xr,
                   torch.from_numpy(erng.integers(0, rl + 1, size=64)).to(
                       dev)) for rl, xr in around.items()]
        cases.append(("[2^20], N at the tile edges", edge_1d, (1 << 20) - 3))
        # the sharded index's build: 8 chunks with their halos, rows past
        # the end with lengths <= 0, the last rows' halos in the N padding
        for n, chunk in ((SEQ_LEN, SH_CHUNK), (40, 16)):
            rows, lengths = chunk_rows(x[:n], SHARDS, chunk, k, dev)
            cases.append((f"the sharded build's [{SHARDS}, {chunk} + halo] of "
                          f"{n:,} bases, lengths {lengths.tolist()}", rows,
                          lengths))
        # the build over processes or over the devices of one process:
        # each rank's or device's own rows of the batch, one past the end
        # with every length <= 0 (no window to find)
        no_windows = set()
        for P, n in sorted(set(IX_PROCS) | set(MD_SPREADS)):
            chunk = 1 << max(4, (-(-n // SHARDS) - 1).bit_length())
            for r in range(P):
                mine = range(r * SHARDS // P, (r + 1) * SHARDS // P)
                rows, lengths = chunk_rows(x[:n], SHARDS, chunk, k, dev, mine)
                what = (f"part {r} of {P}'s [{len(mine)}, {chunk} + halo] of "
                        f"{n:,} bases, lengths {lengths.tolist()}")
                cases.append((what, rows, lengths))
                if int(lengths.max()) < k:
                    no_windows.add(what)
        for what, inp, t in cases:
            key, valid = b1.encode(inp, k, t)
            pk, pv = b1.plain(inp, k, torch.as_tensor(t, device=dev))
            torch.cuda.synchronize()
            err = max(max_abs_err(key, pk), max_abs_err(valid, pv))
            worst = max(worst, err)
            if err or (not bool(valid.any()) and what not in no_windows):
                raise AssertionError(
                    f"B1 disagrees with its plain version: k={k}, {what}, "
                    f"max_abs_err={err}")
            edges += 1
        del key, valid, pk, pv
    log(f"[kernels] B1 == plain, bitwise, on the edges of its {tile}-window "
        f"tiles, k in {list(KS_EDGE)}: {edges} inputs: [2^26 - 16] from byte "
        f"offsets 1, 3 and 15 of its allocation; the counting batch "
        f"[29,696, 151] with lengths 0, k-1, k, 151 and ragged, from the "
        f"card and from the host; rows of {tile - 1}, {tile} and "
        f"{tile + 1} bytes; N at every tile's first and last byte and in "
        f"the halo; the sharded index's build batches ({SHARDS} chunks of "
        f"{SH_CHUNK:,} of {SEQ_LEN:,} bases and of 16 of 40 bases: lengths "
        f"<= 0, halos in the padding) and each rank's rows of them over "
        f"processes ({', '.join(f'{P} ranks on {n:,} bases' for P, n in IX_PROCS)}"
        f"; a rank past the end) and each device's over the devices of one "
        f"process ({', '.join(map(str, MD_PARTS))} devices on {PREFIX:,} "
        f"and {SEQ_LEN:,} bases) (max_abs_err {worst})")
    # the group over processes and devices gives B1 rank p's device i the
    # rows of shards p*D/P + i*D/(P*M) ...: MD_SPREADS' P*M-part rows
    pd_blocks = {(r * SHARDS // PD_P + i * SHARDS // (PD_P * PD_M),
                  SHARDS // (PD_P * PD_M))
                 for r in range(PD_P) for i in range(PD_M)}
    md_blocks = {(j * SHARDS // m, SHARDS // m) for m in MD_PARTS
                 for j in range(m)}
    if not (pd_blocks <= md_blocks and all(
            (PD_P * PD_M, n) in MD_SPREADS for n in (PREFIX, SEQ_LEN))):
        raise AssertionError("the (rank, device) rows of B1 are not among "
                             "the shapes checked above")
    log(f"[kernels] B1: the (rank, device) rows of the group over {PD_P} "
        f"processes x {PD_M} devices on {PREFIX:,} and {SEQ_LEN:,} bases "
        f"are the {PD_P * PD_M}-device parts checked above (the same "
        f"chunk_rows shards), not checked twice")
    # inputs shorter than a chunk or than k: rows of 1-17 bytes (several in
    # one chunk, each thread's row found by division), per-row lengths and
    # one length for every row; 1-D inputs of 1-20 bytes from byte offsets
    # 0, 3 and 15 (one chunk across both ends). Many have no valid window.
    srng = np.random.default_rng(SEED + 10)
    buf = torch.from_numpy(bases(1 << 15)).to(dev)
    short = []
    for rl in (1, 5, 15, 17):
        lens = srng.integers(0, rl + 1, size=1000)
        lens[0] = rl
        xr = buf[3: 3 + 1000 * rl].view(1000, rl)
        short += [(f"[1000, {rl}] from byte offset 3", xr, t)
                  for t in (lens, torch.from_numpy(lens).to(dev), rl)]
    short += [(f"[{n}] from byte offset {off}", buf[off: off + n], t)
              for n in range(1, 21) for off in (0, 3, 15)
              for t in (n, max(n - 2, 0))]
    for k in KS_EDGE:
        for what, inp, t in short:
            key, valid = b1.encode(inp, k, t)
            pk, pv = b1.plain(inp, k, torch.as_tensor(t, device=dev))
            torch.cuda.synchronize()
            err = max(max_abs_err(key, pk), max_abs_err(valid, pv))
            worst = max(worst, err)
            if err:
                raise AssertionError(
                    f"B1 disagrees with its plain version: k={k}, {what}, "
                    f"max_abs_err={err}")
    log(f"[kernels] B1 == plain, bitwise, on {len(short) * len(KS_EDGE)} "
        f"short inputs, k in {list(KS_EDGE)}: rows of 1, 5, 15 and 17 bytes "
        f"from byte offset 3 with per-row lengths from the host and the "
        f"card and one length for all; 1-D inputs of 1-20 bytes from byte "
        f"offsets 0, 3 and 15 (max_abs_err {worst})")
    return worst


def q2_sectors(lb, c, cum, m: int) -> int:
    """32-byte sectors of s_pos that the first ``m`` hit rows of (lb, c)
    read."""
    w = torch.repeat_interleave(torch.arange(c.shape[0], device=c.device),
                                c)[:m]
    g = torch.arange(m, device=c.device)
    j = lb[w] + g - (cum - c)[w]
    return int(torch.unique(j >> 3).numel())


def q1_sectors(s_key, n_valid: int, key, lb, c) -> int:
    """32-byte sectors of s_key that Q1's searches read: every probe of
    each window's lower-bound search (the kernel's own halving, replayed
    on the host) and the rows [lb, lb + c] that the gallop covers."""
    sk = s_key[:n_valid].cpu().numpy()
    q = (key ^ SIGN).cpu().numpy()
    lo = np.zeros(q.shape[0], np.int64)
    cnt = np.full(q.shape[0], n_valid, np.int64)
    probes = []
    while (cnt > 0).any():
        act = cnt > 0
        half = cnt >> 1
        mid = lo + half
        probes.append(mid[act] >> 2)
        less = act & (sk[np.minimum(mid, n_valid - 1)] < q)
        lo = np.where(less, mid + 1, lo)
        cnt = np.where(act, np.where(less, cnt - half - 1, half), 0)
    c_h, lb_h = c.cpu().numpy(), lb.cpu().numpy()
    hit = c_h > 0
    ends = np.minimum(lb_h[hit] + c_h[hit], n_valid - 1)
    probes += [lb_h[hit] >> 2, ends >> 2]
    return int(np.unique(np.concatenate(probes)).shape[0])


def phase_kernels_query(card: str) -> dict:
    """Q1 (the bounds) and Q2 (the hit expansion) of seq_kmer_pos against
    their plain versions on the same card tensors, bitwise, at the query
    cell's shapes: k=21 on SEQ_LEN bases with the 40-copy repeat, queries
    of QUERY_LENS bases with 1% substitutions across the repeat's start
    (the shortest with an N before its last window), every chunk of one
    drain and of 4,096-row drains. Then each timed per query length:
    events, device and host a call, the plain version, the library calls
    (two torch.searchsorted for Q1, the owner searchsorted for Q2), beside
    the bound: the bytes of the s_key or s_pos sectors read, the inputs and
    the rows written, over HBM_BYTES_PER_S."""
    from kmer_hasher_tpu_torch import api
    from kmer_hasher_tpu_torch.index import query as tq
    from kmer_hasher_tpu_torch.ops import cuda_encode as b1
    from kmer_hasher_tpu_torch.ops import cuda_query as qk
    from kmer_hasher_tpu_torch.ops import encode as enc

    rng = np.random.default_rng(SEED + 11)
    seq = make_sequence(rng, SEQ_LEN)
    k = 21
    idx = api.make_kmer_hash(seq, k, device="cuda")
    live = idx.s_key[: idx.n_valid]
    rows = {}
    for n in QUERY_LENS:
        at = REPEAT_AT - n // 2
        q = seq[at: at + n].copy()
        sub = (rng.random(n) < QUERY_SUB_RATE) & ((q | 0x20) != ord("n"))
        q[sub] = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                            size=int(sub.sum()))
        if n == QUERY_LENS[0]:
            q[-k - 1] = ord("N")
        x = torch.from_numpy(q).cuda()
        key, valid = b1.encode(x, k, n)
        drop = qk.trailing_drop(q, k, n)
        lb, c = qk.ranges(key, valid, idx.s_key, idx.n_valid, drop)
        lb0, c0, cum0 = tq._query_ranges(idx.s_key, idx.n_valid, x, k, n)
        cum = torch.cumsum(c, dim=0)
        total = int(cum[-1])
        bad = [] if torch.equal(lb, lb0) and torch.equal(c, c0) else ["Q1"]
        chunks = 0
        for cap in (max(total, 1), 1 << 12):
            for start in range(0, total, cap):
                m = min(cap, total - start)
                if not torch.equal(qk.hits(idx.s_pos, lb, c, cum, k, start, m),
                                   tq._hit_chunk(idx.s_pos, lb0, c0, cum0, k,
                                                 start, m)):
                    bad.append(f"Q2 rows [{start}, {start + m})")
                chunks += 1
        torch.cuda.synchronize()
        most = int(c.max())
        if bad or most < 40 or (n == QUERY_LENS[0]) != (drop >= 0):
            raise AssertionError(
                f"Q1/Q2 disagree with their plain versions on a {n:,}-base "
                f"query: {bad[:5]}; largest count {most}, dropped {drop}")
        log(f"[kernels] Q1 == plain and Q2 == plain, bitwise, on a {n:,}-base "
            f"k=21 query of {SEQ_LEN:,} indexed bases (1% substitutions, "
            f"{total:,} hit rows, counts up to {most}"
            f"{', the last window dropped' if drop >= 0 else ''}; "
            f"{chunks} Q2 chunks of {total:,} and of 4,096 rows)")
        # Q2 is timed on 2^20 rows at most: one chunk of a streamed drain
        m = min(total, 1 << 20)
        sk = enc.sortable_key(key)
        g = torch.arange(m, device=x.device)
        ranges = (lambda: qk.ranges(key, valid, idx.s_key, idx.n_valid,
                                    drop))
        hits = (lambda: qk.hits(idx.s_pos, lb, c, cum, k, 0, m))
        search2 = (lambda: (torch.searchsorted(live, sk),
                            torch.searchsorted(live, sk, right=True)))
        owner = (lambda: torch.searchsorted(cum, g, right=True))
        spanned = int(torch.searchsorted(cum, m - 1, right=True)) + 1
        q1_bytes = n * (8 + 1 + 16) + 32 * q1_sectors(
            idx.s_key, idx.n_valid, key, lb, c)
        q2_bytes = m * 8 + spanned * 16 + 32 * q2_sectors(lb, c, cum, m)
        for name, fn, plain, lib, moved in (
                ("Q1", ranges, lambda: qk.plain_ranges(
                    key, valid, idx.s_key, idx.n_valid, drop), search2,
                 q1_bytes),
                ("Q2", hits, lambda: qk.plain_hits(
                    idx.s_pos, lb, c, cum, k, 0, m), owner, q2_bytes)):
            ms, plain_ms, lib_ms = cuda_ms(fn), cuda_ms(plain), cuda_ms(lib)
            bound_ms, bound_by = bound(moved, 0)
            row = rows.setdefault(name, {})[f"{n:,} bases"] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bytes": moved, "rows": m, "windows": n,
                **device_split(fn, lib, iters=10)}
            log(f"[times] {name} on a {n:,}-base query ({m:,} rows): "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                f"{lib_ms:.4f} ms (CUDA events, mean of 20); bound "
                f"{bound_ms:.4f} ms ({moved / 1e6:.2f} MB){split_txt(row)} "
                f"| {card}")
        del key, valid, lb, c, lb0, c0, cum0, cum, g, sk
    return rows


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
    from kmer_hasher_tpu_torch.ops import cuda_query as qk

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
    q1, q2 = qk.ranges.launches, qk.hits.launches
    rows = api.seq_kmer_pos(idx, query, k)
    torch.cuda.synchronize()
    t_k21 = time.perf_counter() - t0
    q1, q2 = qk.ranges.launches - q1, qk.hits.launches - q2
    if (q1, q2) != (1, 1):
        raise AssertionError(f"seq_kmer_pos launched Q1 {q1} and Q2 {q2} "
                             f"times for {rows.shape[0]:,} rows")
    check_index(idx, seq, k)
    own = rows[:, 1].long() == rows[:, 0].long() - k + 1 + QUERY_AT
    want = int(valid_windows_np(query, k).sum())
    if int(own.sum()) != want:
        raise AssertionError(
            f"seq_kmer_pos: {int(own.sum())} query windows hit their own "
            f"position, want {want}")
    log(f"[main] k=21 make_kmer_hash + seq_kmer_pos of a {QUERY_LEN:,}-base "
        f"query: {rows.shape[0]:,} rows, all {want:,} valid query windows "
        f"hit their own position, {t_k21:.3f} s; Q1 {q1} launch, Q2 {q2}")
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


def phase_card_vs_cpu_sharded_index(seq: np.ndarray) -> None:
    """The sharded index of the first 2^22 bases on 8 shards on the card
    against the same on the CPU, bitwise: hash shards, splitters, range
    shards, tables(2|8), the pair drain."""
    from kmer_hasher_tpu_torch.parallel import ShardedKmerIndex, make_mesh

    pre = seq[:PREFIX]
    for k in (16, 21, 32):
        g = ShardedKmerIndex(pre, k, make_mesh(SHARDS))
        c = ShardedKmerIndex(pre, k, make_mesh(SHARDS, device="cpu"))
        tg, tc = g.tables(2 | 8), c.tables(2 | 8)
        pg = torch.cat([ch.cpu() for ch in g.iter_pair_chunks()])
        same = ((g.n_valid == c.n_valid).all()
                and torch.equal(g._rp_spl.cpu(), c._rp_spl)
                and all(torch.equal(a.s_key.cpu(), b.s_key)
                        and torch.equal(a.s_pos.cpu(), b.s_pos)
                        for a, b in zip(g.shards + g._range_partitioned(),
                                        c.shards + c._range_partitioned()))
                and all(torch.equal(tg[f].cpu(), tc[f])
                        for f in ("pos", "count"))
                and torch.equal(pg, torch.cat(list(c.iter_pair_chunks()))))
        if not same:
            raise AssertionError(f"k={k}: the sharded index differs card vs "
                                 f"CPU")
        log(f"[card-vs-cpu] sharded index, k={k}, 2^22 bases on {SHARDS} "
            f"shards: hash shards ({g.total_kmers:,} windows), splitters, "
            f"range shards, pos/count tables, {pg.shape[0]:,} pair rows — "
            f"bitwise equal")


def phase_times_sharded_index(seq: np.ndarray, card: str) -> None:
    """The sharded build and the single build of the index cell's
    sequence at k=32 in turns (single, sharded, sharded, single, single,
    sharded: medians of 3), the range partition's seconds, the tables(2|8)
    + drain wall of a fresh sharded index, and the device's idle share over
    a sharded build (torch.profiler). Records, not a claim."""
    from kmer_hasher_tpu_torch import api
    from kmer_hasher_tpu_torch.parallel import ShardedKmerIndex, make_mesh

    mesh = make_mesh(SHARDS)

    def build(kind):
        return (api.make_kmer_hash(seq, 32, device="cuda") if kind == "one"
                else ShardedKmerIndex(seq, 32, mesh))

    build("one"), build("shards")  # warm-up
    times = {"one": [], "shards": []}
    for kind in ("one", "shards", "shards", "one", "one", "shards"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ix = build(kind)
        torch.cuda.synchronize()
        times[kind].append(time.perf_counter() - t0)
        del ix
    sh = build("shards")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sh._range_partitioned()
    torch.cuda.synchronize()
    t_rp = time.perf_counter() - t0
    sh.drop_range_partition()
    t0 = time.perf_counter()
    sh.tables(2 | 8)
    n = sum(ch.shape[0] for ch in sh.iter_pair_chunks())
    torch.cuda.synchronize()
    t_tab = time.perf_counter() - t0
    del sh
    one = build("one")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    api.kmer_pos(one, 2 | 8)
    sum(ch.shape[0] for ch in one.iter_pair_chunks())
    torch.cuda.synchronize()
    t_one_tab = time.perf_counter() - t0
    del one
    h_wall, share, top = device_activities(lambda: build("shards"), top=6)
    med = {kind: statistics.median(v) for kind, v in times.items()}
    dev = ("not measured (the trace holds no device time)" if share is None
           else f"device busy {share * h_wall:.4f} s of host {h_wall:.4f} s, "
           f"idle {1 - share:.1%}")
    log(f"[times] sharded index, k=32, {SEQ_LEN:,} bases from the host: "
        f"ShardedKmerIndex on {SHARDS} shards median {med['shards']:.4f} s "
        f"({', '.join(f'{t:.4f}' for t in times['shards'])}), one "
        f"make_kmer_hash median {med['one']:.4f} s "
        f"({', '.join(f'{t:.4f}' for t in times['one'])}), in turns; range "
        f"partition {t_rp:.4f} s; tables(2|8) + drain of {n:,} pair rows "
        f"from a fresh index (range partition included) {t_tab:.4f} s, "
        f"of the single index {t_one_tab:.4f} s; over one sharded build "
        f"under torch.profiler {dev} | {card}")
    if top:
        log(f"[times] sharded index build, the device activities with the "
            f"most time: " + "; ".join(f"{name} x{n} {ms:.3f} ms"
                                       for name, n, ms in top) + f" | {card}")


def phase_times(seq: np.ndarray, card: str):
    from kmer_hasher_tpu_torch import api
    from kmer_hasher_tpu_torch.index.position_index import build_index_arrays
    from kmer_hasher_tpu_torch.ops import cuda_encode as b1

    L = 1 << 26
    x = torch.full((L,), ord("N"), dtype=torch.uint8)
    x[:SEQ_LEN] = torch.from_numpy(seq)
    x = x.cuda()
    rows = {}
    for k in (32, 21):
        ms = cuda_ms(lambda: b1.encode(x, k, SEQ_LEN))
        plain_ms = cuda_ms(lambda: b1.plain(x, k, SEQ_LEN))
        row = rows[f"2^26 bytes, k={k}"] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            **device_split(lambda: b1.encode(x, k, SEQ_LEN), iters=10)}
        log(f"[times] B1 encode, k={k}, 2^26 bytes: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms (CUDA events, mean of 20)"
            f"{split_txt(row)} | {card}")
    k = 32

    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = build_index_arrays(x, k, SEQ_LEN)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del out
    med = statistics.median(times[1:])
    log(f"[times] build_index_arrays, k=32, 2^26 windows: median "
        f"{med * 1e3:.3f} ms of 4 after a warm-up = {L / med:,.0f} k-mers/s "
        f"(window axis / time) | {card}")

    t0 = time.perf_counter()
    idx = api.make_kmer_hash(seq, k, device="cuda")
    n = sum(ch.shape[0] for ch in idx.iter_pair_chunks())
    torch.cuda.synchronize()
    full = time.perf_counter() - t0
    log(f"[times] make_kmer_hash(k=32) of {SEQ_LEN:,} bases from host + "
        f"drain of {n:,} pair rows: {full:.3f} s (warm) | {card}")
    return rows


def host_steps(fn, calls: int = 20) -> dict:
    """Where the host's time of a call of ``fn`` goes, in µs a call:
    torch.profiler's self CPU time of each PyTorch operator and CUDA
    runtime call over ``calls`` calls with no synchronisation (those of at
    least 1 µs, largest first), and under "outside them" the rest of the
    host's clock around the calls: Python, numpy, ctypes, and the
    profiler's own cost but for its trace buffer's set-up, which the first
    runtime call inside the loop pays and which is left out."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
    steps = {e.key: e.self_cpu_time_total / calls
             for e in prof.key_averages()
             if e.key not in ("cudaDeviceSynchronize", "cudaStreamSynchronize")}
    own = steps.pop("Activity Buffer Request", 0.0)
    out = {k: v for k, v in sorted(steps.items(), key=lambda kv: -kv[1])
           if v >= 1.0}
    out["outside them"] = wall * 1e6 / calls - own - sum(steps.values())
    return out


def phase_times_merge(cases: dict, card: str):
    """B3 per launch at the last sort round and at the store's shape,
    beside its plain version and the one library call that computes a
    merge of two sorted runs: ``torch.sort`` with indices of the
    concatenated keys (what the store's tier merge was before B3; stable
    for the sort round, whose payload is ascending within equal keys only
    through the sort's stability)."""
    from kmer_hasher_tpu_torch.ops import cuda_merge as b3

    out = {}
    for name, stable in (("last sort round", True), ("store", False)):
        keys, pay, bounds = cases[name]
        ms = cuda_ms(lambda: b3.merge(keys, pay, bounds), iters=10)
        plain_ms = cuda_ms(lambda: b3.plain(keys, pay, bounds), iters=2,
                           warmup=1)
        lib_ms = cuda_ms(lambda: torch.sort(keys, stable=stable), iters=5,
                         warmup=1)
        n = keys.shape[0]
        moved = n * (8 + 8 + 4 + (0 if pay is None else 4)) + 8 * len(bounds)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "rows": n, "bytes": moved, **device_split(
                         lambda: b3.merge(keys, pay, bounds),
                         lambda: torch.sort(keys, stable=stable), iters=5),
                     "host_steps_us": host_steps(
                         lambda: b3.merge(keys, pay, bounds))}
        lens = " + ".join(f"{int(d):,}" for d in np.diff(bounds))
        log(f"[times] B3 merge, {name} ({lens} rows, "
            f"{'implicit' if pay is None else '32-bit'} payload): "
            f"kernel {ms:.4f} ms (CUDA events, mean of 10) = "
            f"{moved / ms / 1e9:.3f} TB/s of {moved / 1e6:.1f} MB, plain "
            f"{plain_ms:.4f} ms (mean of 2), torch.sort of the concatenated "
            f"keys {lib_ms:.4f} ms (mean of 5){split_txt(out[name])} | "
            f"{card}")
        log(f"[times] B3 wrapper's host steps, {name}, us a call under "
            f"torch.profiler (20 calls): " + "; ".join(
                f"{k} {v:.1f}" for k, v in out[name]["host_steps_us"].items())
            + f" | {card}")
    return out


# -- the counting path ------------------------------------------------------

def scan_batch(rng, k: int, rows: int = 2048, quals: str = "binned",
               L: int = READ_LEN):
    """A ragged [rows, L] read batch on the card: mixed-case bases with N;
    lengths 0, k, k+1, full and random; binned, stress or uniform
    qualities."""
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
    lengths[:4] = (0, k, k + 1, L)[:rows]
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
    def sweep(rng, B, L=40, k=9):
        seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=(B, L))]
        lens = np.full(B, L, np.int32)
        flagged = 0
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
                                  f"threshold sweep, [{B} x {L}], {anchor} "
                                  f"+ {off}")
                    flagged += int(got[3].sum())
        return flagged

    swept = sweep(rng, 2048)
    if not swept:
        raise AssertionError("B2 threshold sweep flagged no read")
    # the shape the counting path launches: [ROWS, READ_LEN] full-length
    # reads, k=21 (928 one-warp blocks against 64 above)
    for quals in ("binned", "stress"):
        args = scan_batch(rng, K_COUNT, rows=ROWS, quals=quals)
        args[2][4:] = READ_LEN
        for name, kw in VARIANTS.items():
            got = compare(args, K_COUNT, min_ll, kw,
                          f"{name}, k={K_COUNT}, {quals}, main shape")
            if not int(got[0].sum()):
                raise AssertionError("B2 at the main shape emitted nothing")
    # the rows a device takes of a counting batch over several devices of
    # one process (ShardedCountStore.add_reads deals them in contiguous
    # blocks): every block of 2, 4 and 8, views into the batch at their row
    # offsets, from a generator of their own
    from kmer_hasher_tpu_torch.counting import _row_blocks

    seq, q, lengths = scan_batch(np.random.default_rng(SEED + 11), K_COUNT,
                                 rows=ROWS, quals="binned")
    lengths[4:] = READ_LEN
    batch = (seq, q, lengths, torch.ones_like(lengths, dtype=torch.bool))
    n_blocks = 0
    for m in MD_PARTS:
        for i, blk in enumerate(_row_blocks(batch, SHARDS, m)):
            for name, kw in VARIANTS.items():
                got = compare(blk[:3], K_COUNT, min_ll, kw,
                              f"{name}, block {i} of {m}, "
                              f"[{blk[0].shape[0]} x {READ_LEN}]")
                if not int(got[0].sum()):
                    raise AssertionError("B2 on a device's block emitted "
                                         "nothing")
            n_blocks += 1
    log(f"[kernels] B2 == plain, bitwise, all three instantiations, on "
        f"each device's block of a [{ROWS:,} x {READ_LEN}] counting batch "
        f"dealt over {', '.join(map(str, MD_PARTS))} devices ({n_blocks} "
        f"blocks of {', '.join(f'{ROWS // m:,}' for m in MD_PARTS)} rows), "
        f"k={K_COUNT}, binned qualities")
    del seq, q, lengths, batch
    # the (rank, device) blocks of the group over processes and devices:
    # the file's batches ([32,768 x 152], and the cut file's last of 8,192
    # rows) cut into PD_P rank blocks and each into PD_M device blocks, as
    # the lockstep route and a rank's own batches deal them
    pd_shapes = []
    for rows in (PD_FILE_ROWS, PD_CUT_LAST):
        seq, q, lengths = scan_batch(np.random.default_rng(SEED + 13),
                                     K_COUNT, rows=rows, quals="stress",
                                     L=PD_FILE_L)
        lengths[4:] = READ_LEN
        batch = (seq, q, lengths, torch.ones_like(lengths, dtype=torch.bool))
        for p, block in enumerate(_row_blocks(batch, SHARDS, PD_P)):
            for i, blk in enumerate(_row_blocks(block, SHARDS // PD_P, PD_M)):
                for name, kw in VARIANTS.items():
                    got = compare(blk[:3], K_COUNT, min_ll, kw,
                                  f"{name}, rank {p} device {i} of "
                                  f"[{rows} x {PD_FILE_L}]")
                    if not int(got[0].sum()):
                        raise AssertionError("B2 on a (rank, device) block "
                                             "emitted nothing")
                pd_shapes.append(tuple(blk[0].shape))
        del seq, q, lengths, batch
    log(f"[kernels] B2 == plain, bitwise, all three instantiations, on the "
        f"(rank, device) blocks of the group over {PD_P} processes x {PD_M} "
        f"devices: {len(pd_shapes)} blocks of shapes "
        f"{sorted(set(pd_shapes))}, k={K_COUNT}, stress qualities")
    # the edges of the warp tiling (32 reads a warp, chunks of 16 positions,
    # windows of 512): a generator of their own keeps the sequence and the
    # reads below what the seed has always made them
    erng = np.random.default_rng(SEED + 8)
    for rows, L, k in B2_EDGES:
        for quals in ("binned", "stress", "uniform"):
            args = scan_batch(erng, k, rows=rows, quals=quals, L=L)
            for name, kw in VARIANTS.items():
                compare(args, k, min_ll, kw,
                        f"{name}, [{rows} x {L}], k={k}, {quals}")
    swept_edge = sweep(erng, 33)
    edges = ", ".join(f"[{r} x {n}] k={k}" for r, n, k in B2_EDGES)
    log(f"[kernels] B2 == plain, bitwise, on the warp tiling's edges "
        f"[rows x L], k: {edges}, binned, stress and uniform qualities, "
        f"all three instantiations; "
        f"the threshold sweep on 33 rows flagged {swept_edge:,} reads")
    log(f"[kernels] B2 == plain, bitwise (emit, fwd and rc at every "
        f"position, flag), instantiations {list(VARIANTS)}, k in "
        f"{list(KS_SCAN)}, on ragged [2048, {READ_LEN}] batches with binned, "
        f"stress and uniform qualities ({n_emit:,} windows emitted, "
        f"{n_flag:,} reads flagged) and 28 thresholds swept around window "
        f"sums at k=9 ({swept:,} reads flagged), and at the counting "
        f"path's shape [{ROWS}, {READ_LEN}], k={K_COUNT}, full-length reads "
        f"with binned and stress qualities (max_abs_err {worst})")
    return worst


def rand64(gen, n: int) -> torch.Tensor:
    """n uniform int64 values on the card (every bit random)."""
    hi = torch.randint(-(1 << 31), 1 << 31, (n,), generator=gen,
                       device="cuda")
    lo = torch.randint(0, 1 << 32, (n,), generator=gen, device="cuda")
    return (hi << 32) | lo


def merge_cases(gen, rng) -> dict:
    """B3's inputs on the card, by name: (keys, payload or None, bounds).

    Sort-round shapes carry the k = 32 index payload, (invalid << 31) |
    position, with a tenth of the windows invalid (the all-ones key) and a
    few real all-G k-mers sharing that key; the five-key input is the JAX
    package's adversarial one (repeat-dominated keys, the all-ones key
    among them); the store shape is two runs of unique keys, about half of
    the shorter one's shared, with the implicit row-number payload."""
    from kmer_hasher_tpu_torch.ops import cuda_merge as b3
    from kmer_hasher_tpu_torch.probes._common import lex_sort

    i32_min = torch.iinfo(torch.int32).min

    def index_payload(n, invalid):
        pos = torch.arange(1, n + 1, dtype=torch.int32, device="cuda")
        return torch.where(invalid, pos | i32_min, pos)

    def runs(keys, pay, rows):
        n = keys.shape[0]
        k, p = lex_sort(keys.reshape(rows, -1), pay.reshape(rows, -1))
        return k.reshape(-1), p.reshape(-1), np.arange(0, n + 1, n // rows)

    cases = {}
    invalid = torch.rand(SORT_N, generator=gen, device="cuda") < 0.1
    keys = torch.where(invalid, SIGN ^ -1, rand64(gen, SORT_N))
    keys[torch.randint(0, SORT_N, (64,), generator=gen, device="cuda")] = (
        SIGN ^ -1)  # all-G 32-mers, valid where the draw left them so
    pay = index_payload(SORT_N, invalid)
    rows_len = SORT_N // SORT_ROWS
    cases[f"sort round, {SORT_ROWS} runs of {rows_len}"] = runs(
        keys, pay, SORT_ROWS)
    cases["last sort round"] = runs(keys, pay, 2)
    del keys, pay
    five = torch.from_numpy(np.array(
        [0, 1, 2 ** 63, 2 ** 64 - 1, 42], np.uint64).view(np.int64)
    ).cuda() ^ SIGN
    keys = five[torch.randint(0, 5, (FIVE_N,), generator=gen, device="cuda")]
    pay = index_payload(FIVE_N, keys == (SIGN ^ -1))[
        torch.randperm(FIVE_N, generator=gen, device="cuda")]
    cases[f"five keys, {FIVE_N // rows_len} runs of {rows_len}"] = runs(
        keys, pay, FIVE_N // rows_len)
    cases["five keys, last round"] = runs(keys, pay, 2)
    a = torch.unique(rand64(gen, STORE_A))
    shared = a[torch.randperm(a.shape[0], generator=gen,
                              device="cuda")[: STORE_B // 2]]
    b = torch.unique(torch.cat([shared, rand64(gen, STORE_B // 2)]))
    cases["store"] = (torch.cat([a, b]), None,
                      np.array([0, a.shape[0], a.shape[0] + b.shape[0]]))
    # ties in the payload's top bit at the last sort round: five keys, the
    # 32-bit payloads uniform, so half are >= 2^31 and order as unsigned
    keys = five[torch.randint(0, 5, (SORT_N,), generator=gen, device="cuda")]
    pay = torch.randint(-(1 << 31), 1 << 31, (SORT_N,), generator=gen,
                        device="cuda", dtype=torch.int32)
    cases["last sort round, five keys, payloads >= 2^31"] = runs(keys, pay, 2)
    del keys, pay
    # edge shapes from the host: empty runs, runs of 1, lengths that are no
    # multiple of the tile, pairs one below, at and above it, one key across
    # several tiles, one side empty across many; five keys (or one), both
    # payload forms
    vals = five.cpu().numpy()
    t = b3.TILE
    for name, lens in (("an empty run and a run of 1", (0, 1)),
                       ("a run and an empty run", (4097, 0)),
                       ("ragged", (2047, 2050, 6143, 1, 0, 0, 5, 70_001)),
                       ("pairs of the tile +-1", (t - 1, t, t + 1, t - 1,
                                                   t, t + 1)),
                       ("one key across tiles", (3 * t + 5, 2 * t + 7)),
                       ("A empty across tiles", (0, 9 * t + 1)),
                       ("B empty across tiles", (7 * t + 3, 0))):
        ks, ps = [], []
        for n in lens:
            k = (np.full(n, vals[3]) if name.startswith("one key") else
                 rng.choice(vals, size=n))
            q = rng.integers(0, 2 ** 32, size=n, dtype=np.uint64)
            order = np.lexsort((q, k))
            ks.append(k[order])
            ps.append(q[order].astype(np.uint32))
        keys = torch.from_numpy(np.concatenate(ks)).cuda()
        pay = torch.from_numpy(np.concatenate(ps).view(np.int32).copy())
        bounds = np.concatenate([[0], np.cumsum(lens)])
        cases[f"edge: {name}"] = (keys, pay.cuda(), bounds)
        cases[f"edge: {name}, implicit payload"] = (keys, None, bounds)
    return cases


def phase_kernels_merge(cases: dict) -> float:
    """B3 against its plain version on the same CUDA tensors, bitwise:
    merged keys and merged payload over every pair's span."""
    from kmer_hasher_tpu_torch.ops import cuda_merge as b3
    from kmer_hasher_tpu_torch.probes._common import unsigned_pay

    worst = 0.0
    for name, (keys, pay, bounds) in cases.items():
        got = b3.merge(keys, pay, bounds)
        want = b3.plain(keys, pay, bounds)
        torch.cuda.synchronize()
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        worst = max(worst, err)
        if err:
            raise AssertionError(f"B3 disagrees with its plain version: "
                                 f"{name}, max_abs_err={err}")
        if len(bounds) == 3 and keys.shape[0] > 1:
            # one pair: the output is one sorted run, checked on its own
            k, q = got[0], unsigned_pay(got[1])
            ok = (k[1:] > k[:-1]) | ((k[1:] == k[:-1]) & (q[1:] >= q[:-1]))
            if not bool(ok.all()):
                raise AssertionError(f"B3 output is not sorted: {name}")
        del got, want
    keys, _pay, bounds = cases["store"]
    log(f"[kernels] B3 == plain, bitwise (merged keys and payload), on "
        f"{len(cases)} inputs: {', '.join(cases)}; the store shape is "
        f"{bounds[1]:,} + {bounds[2] - bounds[1]:,} unique keys, "
        f"{keys.shape[0] - int(torch.unique(keys).shape[0]):,} of them in "
        f"both (max_abs_err {worst})")
    return worst


def phase_main_sharded_index(seq: np.ndarray):
    """The sharded position index on 8 logical shards, through the entries
    a user calls: ShardedKmerIndex(seq, 32, make_mesh(8)) of the index
    cell's sequence, tables(2|8) and the full pair drain, lookup_counts and
    positions_of of 4,096 sampled keys; a k=21 sharded index,
    seq_kmer_pos of the 1,000,000-base query, and kmer_pairs_sharded of it
    against a sharded index of the query stretch. Each is held bitwise
    against the single KmerIndex (built before the counts are set to 0).
    Launches counted (path sharded_index): B1 once a build and once a
    query, B3 never."""
    from kmer_hasher_tpu_torch import api
    from kmer_hasher_tpu_torch.index.query import kmer_pairs
    from kmer_hasher_tpu_torch.ops import encode as enc
    from kmer_hasher_tpu_torch.parallel import (ShardedKmerIndex,
                                                kmer_pairs_sharded, make_mesh,
                                                owner_hash)

    mesh = make_mesh(SHARDS)
    query = seq[QUERY_AT: QUERY_AT + QUERY_LEN]
    # the single indexes and their answers, before the counts are set to 0
    one = api.make_kmer_hash(seq, 32, device="cuda")
    one_tabs = api.kmer_pos(one, 2 | 8)
    one_pairs = torch.cat(list(one.iter_pair_chunks()))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)
    pick = torch.randint(0, one.n_valid, (SH_LOOKUPS,), generator=gen,
                         device="cuda")
    q = torch.unique(enc.sortable_key(one.s_key[pick]))
    lb, ub = one.lookup_range(q)
    hits = ub - lb
    g = torch.arange(int(hits.sum()), device="cuda")
    cum = torch.cumsum(hits, 0)
    w = torch.searchsorted(cum, g, right=True)
    one_positions = torch.sort(one.s_pos[lb[w] + g - (cum[w] - hits[w])]).values
    one21 = api.make_kmer_hash(seq, 21, device="cuda")
    one_rows = api.seq_kmer_pos(one21, query, 21)
    one_xpairs = kmer_pairs(one21, api.make_kmer_hash(query, 21,
                                                      device="cuda"))
    del one21
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    sh = ShardedKmerIndex(seq, 32, mesh)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    tabs = sh.tables(2 | 8)
    chunks = list(sh.iter_pair_chunks())
    counts = sh.lookup_counts(q)
    positions = sh.positions_of(q)
    sh21 = ShardedKmerIndex(seq, 21, mesh)
    blocks = list(sh21.iter_seq_kmer_pos(query, 21))
    shq = ShardedKmerIndex(query, 21, mesh)
    xpairs = kmer_pairs_sharded(sh21, shq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches("sharded_index")

    if sh.device.type != "cuda" or any(s.s_key.device.type != "cuda"
                                       for s in sh.shards):
        raise AssertionError("the sharded index does not live on the card")
    if sh.total_kmers != one.n_valid or sh.chunk != SH_CHUNK:
        raise AssertionError(f"sharded index: {sh.total_kmers} windows in "
                             f"chunks of {sh.chunk}, single {one.n_valid}")
    for d, s in enumerate(sh.shards):
        raw = enc.sortable_key(s.s_key)
        if not bool((owner_hash(*enc.split_hi_lo(raw), SHARDS) == d).all()):
            raise AssertionError(f"hash shard {d} holds another's keys")
    for f in ("pos", "count"):
        if not torch.equal(tabs[f], one_tabs[f]):
            raise AssertionError(f"sharded tables(2|8): {f} differs from the "
                                 f"single index's")
    drained = torch.cat(chunks)
    if not torch.equal(drained, one_pairs):
        raise AssertionError("the sharded pair drain differs from the single "
                             "index's")
    if not (torch.equal(counts.long(), hits)
            and torch.equal(positions, one_positions)):
        raise AssertionError("lookup_counts or positions_of differ from the "
                             "single index's lookup_range")
    rows = torch.cat(blocks)
    keys = (rows[:, 0].long() << 32) | rows[:, 1].long()
    if not (torch.equal(rows, one_rows) and bool((keys[1:] >= keys[:-1]).all())):
        raise AssertionError("sharded seq_kmer_pos differs from the single "
                             "index's, or its blocks do not ascend")
    if not torch.equal(xpairs, one_xpairs):
        raise AssertionError("kmer_pairs_sharded differs from kmer_pairs")
    builds, queries = 3, 1
    if launches[0] != builds + queries or launches[2]:
        raise AssertionError(
            f"the sharded index path launched B1 {launches[0]} times (want "
            f"one a build, {builds}, and one a query, {queries}) and B3 "
            f"{launches[2]} (want none)")
    log(f"[main] sharded index: ShardedKmerIndex(k=32, make_mesh({SHARDS})) "
        f"of {SEQ_LEN:,} bases, chunks of {sh.chunk:,}: shards of "
        f"{', '.join(f'{n:,}' for n in sh.n_valid)} windows, each holding "
        f"only keys whose owner_hash is its own; tables(2|8) "
        f"({sh.n_kmers:,} distinct) and the drain of {drained.shape[0]:,} "
        f"pair rows in {len(chunks)} chunks equal the single index's "
        f"bitwise; lookup_counts and positions_of of {q.shape[0]:,} "
        f"sampled keys ({positions.shape[0]:,} positions) equal its "
        f"lookup_range; k=21: seq_kmer_pos of the {QUERY_LEN:,}-base query, "
        f"{rows.shape[0]:,} rows in {len(blocks)} ascending blocks, and "
        f"kmer_pairs_sharded against the query stretch's sharded index, "
        f"{xpairs.shape[0]:,} rows, equal the single index's; build "
        f"{t_build:.3f} s, all {wall:.3f} s")
    log(f"[main] sharded index: B1 launches {launches[0]} = one a build "
        f"({builds}) + one a query ({queries}), "
        f"{B1_POSITIONS['sharded_index']:,} window starts encoded; B3 "
        f"launches {launches[2]}")
    return launches


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


def counted_wrappers():
    """The thirteen kernels' wrappers in the order B1, B2, B3, P1 ... P10."""
    from kmer_hasher_tpu_torch.ops import cuda_encode as b1
    from kmer_hasher_tpu_torch.ops import cuda_merge as b3
    from kmer_hasher_tpu_torch.ops import cuda_scan as b2
    from kmer_hasher_tpu_torch.probes import cuda_probes as cp
    from kmer_hasher_tpu_torch.probes import cuda_probes_dma as cpd
    from kmer_hasher_tpu_torch.probes import cuda_probes_r3 as cp3

    return (b1.encode, b2.scan, b3.merge, cp.copy, cp.dyn_copy, cp.roll_rows,
            cp.roll_flat, cp3.dyn_copy_2d, cp3.small_copy, cp3.async_copy,
            cp3.smem_gather, cpd.pipelined_copy, cpd.lane_gather)


# path -> the elements B3 merged there and the window starts B1 encoded
# there, read with the path's launches
B3_ROWS, B1_POSITIONS = {}, {}


def reset_launches():
    from kmer_hasher_tpu_torch.ops import cuda_encode as b1
    from kmer_hasher_tpu_torch.ops import cuda_merge as b3

    for w in counted_wrappers():
        w.launches = 0
    b3.merge.rows = 0
    b1.encode.positions = 0


def read_launches(path: str = None) -> tuple:
    """(B1, B2, B3, P1, ..., P10) launches since the last reset; with a
    main path's name, also B3's rows and B1's window starts since then into
    ``B3_ROWS[path]`` and ``B1_POSITIONS[path]``."""
    from kmer_hasher_tpu_torch.ops import cuda_encode as b1
    from kmer_hasher_tpu_torch.ops import cuda_merge as b3

    if path is not None:
        B3_ROWS[path] = b3.merge.rows
        B1_POSITIONS[path] = b1.encode.positions
    return tuple(w.launches for w in counted_wrappers())


def two_run_merges(store) -> int:
    """How often the store merged exactly two runs: its tier merges and
    its two-run folds. B3 runs once for each."""
    return store.timings["tier_merges"] + store.timings["fold_merges"]


def store_on_cpu(store):
    """A CPU store with the card store's base table."""
    from kmer_hasher_tpu_torch import api

    store.flush()
    c = api.CountStore(store.k, counts_n=store.counts_n, mode=store.mode,
                       prefix_bits=store.prefix_bits,
                       suffix_bits=store.suffix_bits, device="cpu")
    c.keys, c.cnt = store.keys.cpu(), store.cnt.cpu()
    return c


def write_fastq(path: Path, batches, n_reads: int) -> None:
    """The first ``n_reads`` reads of the staged batches as 4-line FASTQ:
    fixed-width records ("@r", bases, "+", qualities) laid out with numpy,
    a batch at a time."""
    head, mid = np.frombuffer(b"@r\n", np.uint8), np.frombuffer(b"\n+\n",
                                                                np.uint8)
    with open(path, "wb") as f:
        left = n_reads
        for seq, qual, _len, _hq in batches:
            s, q = seq[:left].cpu().numpy(), qual[:left].cpu().numpy()
            rows, width = s.shape
            rec = np.empty((rows, 3 + width + 3 + width + 1), np.uint8)
            rec[:, :3] = head
            rec[:, 3: 3 + width] = s
            rec[:, 3 + width: 6 + width] = mid
            rec[:, 6 + width: 6 + 2 * width] = q
            rec[:, -1] = ord("\n")
            f.write(rec.tobytes())
            left -= rows
            if left <= 0:
                return


def depth_probe_c(stretch: torch.Tensor, k: int) -> torch.Tensor:
    """The depth stretch with N gaps for the exact-C track: single Ns, a
    short run, an exactly-k region between two Ns (the next region starts
    with a stale register), and 300 random Ns over the last tenth."""
    x = stretch.clone()
    n = x.shape[0]
    at = [n // 5, 2 * n // 5, 2 * n // 5 + 1, 2 * n // 5 + 2,
          3 * n // 5, 3 * n // 5 + k + 1]
    x[torch.tensor(at, device=x.device)] = ord("N")
    g = torch.Generator(device=x.device)
    g.manual_seed(SEED)
    x[torch.randint(n - n // 10, n, (300,), generator=g,
                    device=x.device)] = ord("N")
    return x


def phase_main_counting(genome: torch.Tensor, batches, tmp: Path):
    """The user's counting path on the card: the batch loop of
    count_kmers_fq_sh_rp over device-staged reads, flush, spectrum, depth
    in both semantics; then the file entry with a checkpoint round trip.
    Writes the FASTQ file into ``tmp`` and returns its path too."""
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
    stretch_c = depth_probe_c(stretch, k)
    depth_c = api.seq_kmer_depth(store, stretch_c, k, semantics="c")
    torch.cuda.synchronize()
    n_main = read_launches("counting")
    b1_n, b2_n, b3_n = n_main[:3]

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
    # exact-C depth: before the first N column c holds window c+1 (the
    # reference's one-column shift); the whole track equals the CPU's
    first_n = DEPTH_LEN // 5
    if not torch.equal(depth_c[:, : first_n - k],
                       depth[:, 1: first_n - k + 1]):
        raise AssertionError("exact-C depth is not the shifted track")
    cpu_store = store_on_cpu(store)
    if not torch.equal(
            depth_c.cpu(),
            api.seq_kmer_depth(cpu_store, stretch_c.cpu(), k, semantics="c")):
        raise AssertionError("exact-C depth differs card vs CPU")
    if not torch.equal(depth.cpu(),
                       api.seq_kmer_depth(cpu_store, stretch.cpu(), k)):
        raise AssertionError("depth differs card vs CPU")
    del cpu_store
    tm = store.timings
    if b1_n < 1 or b2_n < 1 or b3_n < 1 or b3_n != two_run_merges(store):
        raise AssertionError(
            f"the counting path launched B1 {b1_n}, B2 {b2_n} and B3 "
            f"{b3_n} times; the store merged two runs "
            f"{two_run_merges(store)} times")
    log(f"[main] counting: {len(batches)} batches x {ROWS:,} reads x "
        f"{READ_LEN} bases = {n_reads:,} reads, k={k}, min_q={MIN_Q}, "
        f"hybrid: {total:,} observations kept of "
        f"{n_reads * (READ_LEN - k + 1):,} windows, {store.n_unique:,} "
        f"distinct, {flagged:,} reads flagged and re-counted in f64, "
        f"{tm['tier_merges']} tier merges, {wall:.3f} s")
    log(f"[main] counting: spectrum(255) sums to n_unique, mode {mode} at "
        f"kept coverage {cover:.1f}; depth over {DEPTH_LEN:,} bases has no "
        f"NA, median {med:.0f}; exact-C depth over the same stretch with "
        f"{int((stretch_c == ord('N')).sum())} Ns is the one-column-shifted "
        f"track before the first N and equals the CPU's everywhere "
        f"({int((depth_c != NA).sum()):,} columns written); B1 launches "
        f"{b1_n}, B2 launches {b2_n}, B3 launches {b3_n} = "
        f"{tm['tier_merges']} tier merges + {tm['fold_merges']} two-run "
        f"fold")

    fq = tmp / "reads.fq"
    write_fastq(fq, batches, FILE_READS)
    # the file entry is a path of its own: its launches are counted
    # apart, before the check below runs the kernel again
    reset_launches()
    t0 = time.perf_counter()
    st = api.count_kmers_fq_sh_rp(str(fq), k=k, min_q=MIN_Q)
    torch.cuda.synchronize()
    t_file = time.perf_counter() - t0
    n_file = read_launches("file")
    b1_file, b2_file, b3_file = n_file[:3]
    if b2_file < 1 or b3_file != two_run_merges(st):
        raise AssertionError(
            f"the file entry launched B2 {b2_file} and B3 {b3_file} times; "
            f"its store merged two runs {two_run_merges(st)} times")
    if st.device.type != "cuda":
        raise AssertionError("the file entry did not run on the card")
    if st.timings["reader"] != "native":
        raise AssertionError(
            f"the file entry read through the {st.timings['reader']} reader; "
            f"the native parser says: {native_build_error()}")
    want = api.CountStore(k)
    cut = [tuple(a[:FILE_READS - i * ROWS] for a in b)
           for i, b in enumerate(batches[: -(-FILE_READS // ROWS)])]
    counting.count_batches(want, cut, k, min_q=MIN_Q, exact_ll=True)
    ck = tmp / "store.npz"
    checkpoint.save_count_store(st, ck)
    back = checkpoint.load_count_store(ck)
    for other, what in ((want, "the staged batches"),
                        (back, "its checkpoint")):
        if not (torch.equal(st.keys, other.keys)
                and torch.equal(st.cnt, other.cnt)
                and (st.total_added == other.total_added).all()):
            raise AssertionError(f"file count differs from {what}")
    log(f"[main] count_kmers_fq_sh_rp of a {FILE_READS:,}-read FASTQ file "
        f"({st.timings['reader']} reader, uploads through pinned copies): "
        f"{st.n_unique:,} distinct, "
        f"equal to the same reads staged on the card; checkpoint round "
        f"trip exact; {t_file:.3f} s; B1 launches {b1_file}, B2 launches "
        f"{b2_file}, B3 launches {b3_file}")
    launches = {"counting": n_main, "file": n_file}
    return launches, fq, {"wall": wall, "timings": dict(tm),
                          "n_reads": n_reads, "flagged": flagged,
                          "store": store, "stretch": stretch, "depth": depth}


def native_build_error() -> str:
    from kmer_hasher_tpu_torch.io import native

    return native.build_error() or "no build error"


def phase_main_threshold(fq: Path):
    """The per-base-threshold entries on the card: count_kmers_fq_sh and
    count_kmers_fq (kmer_tree store) of the FASTQ file, each equal to the
    same call on the CPU, bitwise."""
    from kmer_hasher_tpu_torch import api

    k = K_COUNT
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = {name: getattr(api, name)(str(fq), k=k, min_q=MIN_Q)
            for name in ("count_kmers_fq_sh", "count_kmers_fq")}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches("threshold")
    merges = sum(two_run_merges(st) for st in card.values())
    if launches[2] < 1 or launches[2] != merges:
        raise AssertionError(
            f"the threshold entries launched B3 {launches[2]} times; their "
            f"stores merged two runs {merges} times")
    for name, g in card.items():
        if g.device.type != "cuda" or g.n_unique < 1:
            raise AssertionError(f"{name} did not count on the card")
        c = getattr(api, name)(str(fq), k=k, min_q=MIN_Q, device="cpu")
        if not (torch.equal(g.keys.cpu(), c.keys)
                and torch.equal(g.cnt.cpu(), c.cnt)
                and (g.total_added == c.total_added).all()
                and (api.kmer_spectrum(g, 255)
                     == api.kmer_spectrum(c, 255)).all()):
            raise AssertionError(f"{name}: card and CPU differ")
    sh, kt = card["count_kmers_fq_sh"], card["count_kmers_fq"]
    if not (sh.mode == "sh" and kt.mode == "ktree"
            and torch.equal(sh.keys, kt.keys)
            and api.kmer_spectrum(kt, 255)[0] > api.kmer_spectrum(sh, 255)[0]):
        raise AssertionError("the kmer_tree store does not hold the same "
                             "k-mers with its blocks' zero cells on top")
    log(f"[main] threshold: count_kmers_fq_sh and count_kmers_fq of the "
        f"{FILE_READS:,}-read FASTQ file, k={k}, min_q={MIN_Q}: "
        f"{int(sh.total_added.sum()):,} observations, {sh.n_unique:,} "
        f"distinct; keys, counts, total_added and spectrum(255) equal to "
        f"the CPU's, bitwise; the kmer_tree spectrum adds "
        f"{api.kmer_spectrum(kt, 255)[0]:,.0f} zero cells; {wall:.3f} s for "
        f"both; B1 launches {launches[0]}, B2 launches {launches[1]}, B3 "
        f"launches {launches[2]} (one per two-run merge)")
    return launches


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
    copy) of ``fn``, from torch.profiler's device activities, each counted
    once; share None if the trace holds no device time. (Summing
    ``key_averages()`` would count each kernel that a PyTorch operator
    launches twice, once under the operator and once as itself.)"""
    return device_activities(fn)[:2]


def device_activities(fn, top: int = 0):
    """:func:`device_busy_share`'s (host seconds, busy share) and the
    ``top`` device activities of ``fn`` with the most time, as (name cut to
    70 characters, calls, device ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_us = sum(us for _, us in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return (wall, busy_us * 1e-6 / wall if busy_us > 0 else None,
            [(name[:70], n, us * 1e-3) for name, (n, us) in ranked])


def phase_times_counting(batches, card: str, main_stats: dict):
    from kmer_hasher_tpu_torch import api, counting
    from kmer_hasher_tpu_torch.ops import cuda_scan as b2
    from kmer_hasher_tpu_torch.qll import Q_TO_LL

    k = K_COUNT
    min_ll = float(Q_TO_LL[33 + MIN_Q])
    seq, qual, lengths, has_qual = batches[0]
    b2_rows = {}
    for name, kw in VARIANTS.items():
        ms = cuda_ms(lambda: b2.scan(seq, qual, lengths, k, min_ll, **kw))
        plain_ms = cuda_ms(
            lambda: b2.plain(seq, qual, lengths, k, min_ll, **kw),
            iters=2, warmup=1)
        b2_rows[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                      **device_split(lambda: b2.scan(
                          seq, qual, lengths, k, min_ll, **kw))}
        log(f"[times] B2 ll_scan {name}, k={k}, [{ROWS} x {READ_LEN}]: "
            f"kernel {ms:.4f} ms (CUDA events, mean of 20), plain "
            f"{plain_ms:.4f} ms (mean of 2){split_txt(b2_rows[name])} | "
            f"{card}")

    from kmer_hasher_tpu_torch.ops import scan_iter

    thr_ms = cuda_ms(lambda: scan_iter.threshold_scan(
        seq, qual, lengths, k, 33 + MIN_Q), iters=2, warmup=1)
    log(f"[times] threshold_scan (a loop over positions in plain PyTorch; "
        f"the JAX package's is a lax.scan, not a kernel), k={k}, "
        f"[{ROWS} x {READ_LEN}]: {thr_ms:.4f} ms per batch (CUDA events, "
        f"mean of 2) | {card}")

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
        f"wall ({tm['tier_merges']} merges through B3, "
        f"{tm['tier_merge_rows']:,} rows in), final fold {tm['fold_s']:.3f} "
        f"s = {tm['fold_s'] / t:.1%} ({tm['fold_merges']} of "
        f"{tm['folds']} a two-run merge through B3) | {card}")
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
    return b2_rows


# -- the probes ---------------------------------------------------------------

def rand32(gen, shape) -> torch.Tensor:
    """Uniform 32-bit elements on the card, as the probes' int32."""
    return torch.randint(-(1 << 31), 1 << 31, shape, generator=gen,
                         device="cuda", dtype=torch.int32)


def probe_cases(gen) -> dict:
    """P1-P4's inputs on the card, by kernel and shape name. "ref" shapes
    are the TPU probes' (2^24 elements; 64 tiles; one [64, 128] tile with
    shift 5 or 777), "full" the full-card ones (2^26 elements; 2^26 / 2^13
    tiles from distinct offsets; as many tiles with a shift each, among them
    0, 1, N - 1, N and values above N and below 0)."""
    from kmer_hasher_tpu_torch.probes import cuda_probes as cp
    from kmer_hasher_tpu_torch.probes import sort_probes as sp

    n_ref, n_full = 1 << PROBE_REF_LOG_N, 1 << PROBE_LOG_N
    x = rand32(gen, (n_full,))
    cases = {"P1": {"ref": (x[:n_ref],), "full": (x,)}, "P2": {},
             "P3": {}, "P4": {}}
    # P1's edges: one below, at and above a block's tile on each path (the
    # 4-byte path's is a quarter), and views 4 and 8 bytes in
    tile = cp.COPY_TILE
    for n in (1, 3, 5, tile // 4 - 1, tile // 4 + 1, tile - 1, tile,
              tile + 1, 1000 * tile + 2, (1 << 20) + 3):
        for skew in (0, 1, 2):
            cases["P1"][f"n={n:,}, {4 * skew} bytes in"] = (
                x[skew: skew + n],)
    for g in sp.GRANULES:
        offs = sp.reference_offsets(n_ref, g)
        cases["P2"][f"ref, granule {g}"] = (
            x[:n_ref], torch.from_numpy(offs).cuda())
        offs = sp.spread_offsets(n_full, g, n_full // cp.CH)
        cases["P2"][f"full, granule {g}"] = (x, torch.from_numpy(offs).cuda())
    tile_n = sp.TILE[0] * sp.TILE[1]
    tiles = n_full // tile_n
    xt = x.reshape((tiles,) + sp.TILE)
    for name, unit, shift in (("P3", sp.TILE[0], sp.SHIFT_ROWS),
                              ("P4", tile_n, sp.SHIFT_FLAT)):
        sh = torch.randint(-3 * unit, 3 * unit, (tiles,), generator=gen,
                           device="cuda", dtype=torch.int32)
        sh[:8] = torch.tensor([0, 1, unit - 1, unit, unit + 1, 5 * unit + 3,
                               -1, -unit - 2], dtype=torch.int32)
        cases[name]["ref"] = (xt[0], torch.tensor(
            [shift], dtype=torch.int32, device="cuda"))
        cases[name]["full"] = (xt, sh)
    return cases


def probe_kernels():
    """name -> (wrapper, plain version)."""
    from kmer_hasher_tpu_torch.probes import cuda_probes as cp

    return {"P1": (cp.copy, cp.plain_copy),
            "P2": (cp.dyn_copy, cp.plain_dyn_copy),
            "P3": (cp.roll_rows, cp.plain_roll_rows),
            "P4": (cp.roll_flat, cp.plain_roll_flat)}


def phase_kernels_probes(cases: dict) -> dict:
    """P1-P4 against their plain versions on the same CUDA tensors,
    bitwise. Returns the worst max_abs_err by kernel."""
    worst = {}
    for name, (fn, plain) in probe_kernels().items():
        worst[name] = 0.0
        for shape, args in cases[name].items():
            got = fn(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            worst[name] = max(worst[name], err)
            if err or got.shape != want.shape:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version: {shape}, max_abs_err={err}")
            del got, want
        log(f"[kernels] {name} == plain, bitwise, on {len(cases[name])} "
            f"inputs: {', '.join(cases[name])} (max_abs_err {worst[name]})")
    return worst


def phase_main_probes():
    """The probe entry point as a user runs it, at log_n 26 on the card."""
    from kmer_hasher_tpu_torch.probes import _common, sort_probes

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sort_probes.run(PROBE_LOG_N)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches("probes")
    # every probe line is one check launch plus one timing's launches
    per = 1 + _common.calls_per_timing(torch.device("cuda"))
    want = (0, 0, 0, per, 2 * len(sort_probes.GRANULES) * per, per, per,
            0, 0, 0, 0, 0, 0)
    if launches != want:
        raise AssertionError(f"the probe entry launched (B1, B2, B3, P1, ..., "
                             f"P10) {launches}, want {want}")
    lines = 2 + 2 * len(res["E2"]) + 1 + len(res["E4"]) + len(res["E5"])
    log(f"[main] probes: sort_probes at log_n {PROBE_LOG_N} through its "
        f"entry point, {lines} lines, all ok (a probe that is not raises), "
        f"{wall:.3f} s; launches P1 "
        f"{launches[3]}, P2 {launches[4]} (3 granules x 2 tile counts), P3 "
        f"{launches[5]}, P4 {launches[6]}: per line 1 check + "
        f"{per - 1} timed")
    return launches


# -- the round-3 probes -------------------------------------------------------

def probe_r3_cases(gen) -> dict:
    """P5-P8's inputs on the card, by kernel and shape name. "ref" shapes
    are the TPU probes' (2^24 elements; 64 steps; 4,096 records; 2^22
    indices), "full" the full-card ones (2^26 elements, every window, record
    and tile once), the others edge inputs: write windows made to overlap,
    steps outside x, a view off the 16-byte boundary, indices outside the
    table."""
    from kmer_hasher_tpu_torch.probes import cuda_probes as cp
    from kmer_hasher_tpu_torch.probes import cuda_probes_r3 as cp3
    from kmer_hasher_tpu_torch.probes import sort_probes as sp
    from kmer_hasher_tpu_torch.probes import sort_probes_r3 as sp3

    def dev(a):
        return torch.from_numpy(np.asarray(a).astype(np.int32)).cuda()

    n_ref, n_full = 1 << PROBE_REF_LOG_N, 1 << PROBE_LOG_N
    x = rand32(gen, (n_full,))
    x2, x2_ref = x.reshape(-1, cp3.COLS), x[:n_ref].reshape(-1, cp3.COLS)
    rows_ref, rows_full = x2_ref.shape[0], x2.shape[0]
    rng = np.random.default_rng(SEED + 5)
    cases = {"P5": {}, "P6": {}, "P7": {}, "P8": {}}
    for r in sp3.ROWS_PER_COPY:
        cases["P5"][f"ref, R={r}"] = (x2_ref, dev(
            sp3.reference_row_offsets(rows_ref, r, sp3.REF_STEPS)), r)
        cases["P5"][f"full, R={r}"] = (x2, dev(
            sp3.spread_row_offsets(rows_full, r)), r)
        # the round-3 entry's other R2 line: the TPU's 64 steps on 2^26
        cases["P5"][f"full, 64 steps, R={r}"] = (x2, dev(
            sp3.reference_row_offsets(rows_full, r, sp3.REF_STEPS)), r)
    # the DMA entry runs P5 beside P9 at R = 64 as well
    cases["P5"]["full, R=64"] = (x2, dev(sp3.spread_row_offsets(
        rows_full, 64)), 64)
    # 4,096 steps of 512 rows inside 20,000 rows: about a hundred write
    # windows over every row; then chains one row apart and repeats
    cases["P5"]["overlapping, R=512"] = (x2_ref, dev(
        rng.integers(0, 20_000, size=4096)), 512)
    cases["P5"]["chains and repeats, R=130"] = (x2_ref, dev(
        np.concatenate([np.arange(3000) % 700, np.full(50, 77)])), 130)
    cases["P5"]["steps outside x, R=200"] = (x2_ref, dev(
        [0, 100, rows_ref - 200, -1, rows_ref - 199, 2 ** 31 - 1, 300,
         -2 ** 31, rows_ref, 150]), 200)
    # 40 windows of 100 rows in the first quarter leave most rows to no
    # step; the call comes right after a tensor of x's size full of -1 was
    # freed (see phase_kernels_probes_r3), so a row not written shows
    cases["P5"][DIRTY_P5] = (x2_ref, dev(
        rng.integers(0, rows_ref // 4 - 100, size=40)), 100)
    cases["P6"]["ref"] = (x2_ref, dev(sp3.reference_row_offsets(
        rows_ref, cp3.SMALL_ROWS, sp3.REF_RECORDS)))
    cases["P6"]["full"] = (x2, dev(sp3.spread_row_offsets(
        rows_full, cp3.SMALL_ROWS)))
    cases["P6"]["records outside x"] = (x2_ref, dev(
        [0, rows_ref - 4, rows_ref - 3, -1, 5, 2 ** 31 - 1, -2 ** 31, 6, 6]))
    for g in sp3.GRANULES:
        cases["P7"][f"ref, granule {g}"] = (x[:n_ref], dev(
            sp.reference_offsets(n_ref, g)))
        cases["P7"][f"full, granule {g}"] = (x, dev(
            sp.spread_offsets(n_full, g, n_full // cp.CH)))
    off1 = x[1: n_ref + 1]  # a view off the 16-byte boundary
    cases["P7"]["a view off the 16-byte boundary"] = (off1, dev(
        np.concatenate([[0, n_ref - cp.CH, 1, 2, 3],
                        sp.reference_offsets(n_ref, 1)])))
    tab = rand32(gen, (cp3.TABLE // cp3.COLS, cp3.COLS))
    for name, n in (("ref", 1 << GATHER_REF_LOG_N), ("full", n_full)):
        cases["P8"][name] = (tab, torch.randint(
            0, cp3.TABLE, (n // cp3.COLS, cp3.COLS), generator=gen,
            device="cuda", dtype=torch.int32))
    idx = torch.randint(-5000, 5000, (1 << 16,), generator=gen,
                        device="cuda", dtype=torch.int32)
    idx[:6] = torch.tensor([0, 1023, 1024, -1, 2 ** 31 - 1, -2 ** 31],
                           dtype=torch.int32)
    cases["P8"]["indices outside the table"] = (tab, idx)
    return cases


def probe_r3_kernels():
    """name -> (wrapper, plain version)."""
    from kmer_hasher_tpu_torch.probes import cuda_probes_r3 as cp3

    return {"P5": (cp3.dyn_copy_2d, cp3.plain_dyn_copy_2d),
            "P6": (cp3.small_copy, cp3.plain_small_copy),
            "P7": (cp3.async_copy, cp3.plain_async_copy),
            "P8": (cp3.smem_gather, cp3.plain_smem_gather)}


def phase_kernels_probes_r3(cases: dict) -> dict:
    """P5-P8 against their plain versions on the same CUDA tensors,
    bitwise; P5's reference and overlapping inputs also against numpy's
    loop over row numbers. Returns the worst max_abs_err by kernel."""
    from kmer_hasher_tpu_torch.probes import cuda_probes as cp
    from kmer_hasher_tpu_torch.probes import cuda_probes_r3 as cp3
    from kmer_hasher_tpu_torch.probes import sort_probes_r3 as sp3

    worst = {}
    overlaps = {}
    for name, (fn, plain) in probe_r3_kernels().items():
        worst[name] = 0.0
        for shape, args in cases[name].items():
            if shape == DIRTY_P5:  # the caching allocator hands this out
                dirty = torch.full_like(args[0], -1)
                del dirty
            got = fn(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            worst[name] = max(worst[name], err)
            if err or got.shape != want.shape:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version: {shape}, max_abs_err={err}")
            if name == "P5":
                x, offs, r = args
                src = sp3.sequential_source_rows(
                    x.shape[0], offs.cpu().numpy(), r)
                live = torch.from_numpy(src >= 0).cuda()
                rows = torch.from_numpy(np.maximum(src, 0)).cuda()
                if not (torch.equal(got[live], x[rows[live]])
                        and not bool(got[~live].any())):
                    raise AssertionError(
                        f"P5 disagrees with numpy's loop: {shape}")
                steps = int(((offs >= 0) & (offs <= x.shape[0] - r)).sum())
                overlaps[shape] = (int(live.sum()), steps * r)
            del got, want
        log(f"[kernels] {name} == plain, bitwise, on {len(cases[name])} "
            f"inputs: {', '.join(cases[name])} (max_abs_err {worst[name]})")
    log("[kernels] P5 == numpy's loop in step order as well; rows written "
        "of the rows its steps cover (fewer where write windows overlap): "
        + "; ".join(f"{shape}: {a:,} of {b:,}"
                    for shape, (a, b) in overlaps.items()))
    if not overlaps["ref, R=512"][0] < overlaps["ref, R=512"][1]:
        raise AssertionError("the TPU probe's 64 windows of 512 rows were "
                             "expected to overlap")
    if not overlaps[DIRTY_P5][0] < cases["P5"][DIRTY_P5][0].shape[0] // 2:
        raise AssertionError("the dirty-memory case was meant to leave most "
                             "rows to no step")
    # what no plain version takes: offsets outside x give zeros, as in P2
    x, n = cases["P7"]["ref, granule 1"][0], 1 << PROBE_REF_LOG_N
    offs = torch.tensor([-5, n - 100, 2 ** 31 - 1, -2 ** 31, 7],
                        dtype=torch.int32, device="cuda")
    got = cp3.async_copy(x, offs).reshape(-1, cp.CH)
    if not (torch.equal(got, cp.dyn_copy(x, offs).reshape(-1, cp.CH))
            and torch.equal(got[0, 5:], x[: cp.CH - 5])
            and not bool(got[0, :5].any()) and not bool(got[2:4].any())
            and torch.equal(got[1, :100], x[n - 100:])
            and not bool(got[1, 100:].any())
            and torch.equal(got[4], x[7: 7 + cp.CH])):
        raise AssertionError("P7 with offsets outside x: not zeros outside, "
                             "x inside, as P2 gives")
    log("[kernels] P7 with offsets outside [0, n - CH]: zeros where the "
        "window leaves x, equal to P2's output")
    return worst


def phase_main_probes_r3():
    """The round-3 probe entry point as a user runs it, at log_n 26."""
    from kmer_hasher_tpu_torch.probes import _common, sort_probes_r3

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sort_probes_r3.run(PROBE_LOG_N)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches("probes_r3")
    timed = _common.calls_per_timing(torch.device("cuda"))
    per = 1 + timed  # a probe line: one check launch plus one timing's
    n_r2 = 2 * len(sort_probes_r3.ROWS_PER_COPY)
    n_r3 = 2 * len(sort_probes_r3.GRANULES)
    # R4 times P1 beside P8, R3 times P2 beside P7 (no check launch)
    want = (0, 0, 0, 2 * timed, n_r3 * timed, 0, 0,
            n_r2 * per, 2 * per, n_r3 * per, 2 * per, 0, 0)
    if launches != want:
        raise AssertionError(f"the round-3 probe entry launched (B1, B2, B3, "
                             f"P1, ..., P10) {launches}, want {want}")
    lines = (len(res["R1"]) + len(res["R5"]) + n_r2 + 2 + len(res["R4"])
             + n_r3)
    log(f"[main] probes r3: sort_probes_r3 at log_n {PROBE_LOG_N} through "
        f"its entry point, {lines} lines, all ok (a probe that is not "
        f"raises), {wall:.3f} s; launches P5 {launches[7]}, P6 "
        f"{launches[8]}, P7 {launches[9]}, P8 {launches[10]} (per line 1 "
        f"check + {timed} timed), and beside them P1 {launches[3]}, P2 "
        f"{launches[4]}")
    return launches


def phase_times_probes_r3(cases: dict, card: str) -> dict:
    """P5-P8 per launch at the reference and full shapes, beside the plain
    version and, where one PyTorch call computes the same function, that
    call with its index built beforehand: the row gather (P6), the element
    gather (P7, as for P2), ``tab.reshape(-1)[idx]`` (P8). P5's order of
    steps has no such call."""
    from kmer_hasher_tpu_torch.probes import cuda_probes as cp
    from kmer_hasher_tpu_torch.probes import cuda_probes_r3 as cp3
    from kmer_hasher_tpu_torch.probes import sort_probes_r3 as sp3

    def library(name, args):
        if name == "P6":
            recs = args[0].reshape(-1, cp3.SMALL_ROWS * cp3.COLS)
            idx = args[1].long() // cp3.SMALL_ROWS
            if bool((args[1] % cp3.SMALL_ROWS).any()):  # not on a record
                rows = (args[1].long()[:, None] + torch.arange(
                    cp3.SMALL_ROWS, device="cuda")).reshape(-1)
                return lambda: args[0][rows]
            return lambda: recs[idx]
        if name == "P7":
            idx = (args[1].long()[:, None] + torch.arange(
                cp.CH, device="cuda")).reshape(-1)
            return lambda: args[0][idx]
        if name == "P8":
            flat, idx = args[0].reshape(-1), args[1].long()
            return lambda: flat[idx]
        return None

    out = {}
    for name, (fn, plain) in probe_r3_kernels().items():
        out[name] = {}
        for shape, args in cases[name].items():
            if not shape.startswith(("ref", "full")):
                continue
            big = args[0].numel() > 1 << 25 or name == "P8" and (
                args[1].numel() > 1 << 25)
            ms = cuda_ms(lambda: fn(*args), iters=20 if big else 200)
            plain_ms = cuda_ms(lambda: plain(*args), iters=2, warmup=1)
            lib = library(name, args)
            lib_ms = None if lib is None else cuda_ms(
                lib, iters=10 if big else 100)
            split = device_split(lambda: fn(*args), lib,
                                 iters=10 if big else 50, key=(name, shape))
            if name == "P5":
                x, offs, r = args
                src = sp3.sequential_source_rows(
                    x.shape[0], offs.cpu().numpy(), r)
                # the rows that stand are read once; the whole output
                # (zeros included) is written once
                moved = 512 * int((src >= 0).sum()) + 4 * x.numel() + (
                    4 * offs.numel())
            elif name == "P6":
                moved = (4 + 2 * 2048) * args[1].numel()
            elif name == "P7":
                moved = 2 * 4 * args[1].numel() * cp.CH + 4 * args[1].numel()
            else:
                moved = 2 * 4 * args[1].numel() + 4 * cp3.TABLE
            b_ms, b_by = bound(moved, 0)
            out[name][shape] = {"ms": ms, "plain_ms": plain_ms,
                                "library_ms": lib_ms, "bytes": moved,
                                "bound_ms": b_ms, "bound_by": b_by, **split}
            extra = ""
            if name == "P6":
                extra = (f" = {args[1].numel() / ms / 1e3:.1f} M "
                         f"transfers/s")
            elif name == "P8":
                extra = f" = {ms * 1e6 / args[1].numel():.4f} ns/element"
            lib_txt = ("no library call" if lib_ms is None
                       else f"library call {lib_ms:.4f} ms")
            log(f"[times] {name}, {shape}: kernel {ms:.4f} ms = "
                f"{moved / ms / 1e9:.3f} TB/s of {moved / 1e6:.3f} MB"
                f"{extra} (bound {b_ms:.4f} ms), plain {plain_ms:.4f} ms, "
                f"{lib_txt} (CUDA events){split_txt(split)} | {card}")
    return out


def p5_losses(launches: dict, times: dict, card: str) -> dict:
    """P5's loss per path: its launches there, by the shape each ran, times
    that shape's gap to its bound (device times, events where the trace
    holds none). The round-3 entry's R2 lines run the TPU's 64 steps and
    every window at R = 512 and 8 on 2^26 elements, a check launch and one
    timing each; the DMA entry runs P5 beside P9 over every window at R =
    512 (twice), 64 and 8, one timing each."""
    from kmer_hasher_tpu_torch.probes import _common, dma_probes_r3
    from kmer_hasher_tpu_torch.probes import sort_probes_r3 as sp3

    timed = _common.calls_per_timing(torch.device("cuda"))
    runs = {p: {} for p in PATHS}
    for r in sp3.ROWS_PER_COPY:
        for shape in (f"full, 64 steps, R={r}", f"full, R={r}"):
            runs["probes_r3"][shape] = 1 + timed
    for r, _ in dma_probes_r3.COPY_PROBES:
        shape = f"full, R={r}"
        runs["probes_dma"][shape] = runs["probes_dma"].get(shape, 0) + timed
    for p in PATHS:
        if sum(runs[p].values()) != launches[p]:
            raise AssertionError(f"P5 launched {launches[p]} times on {p}, "
                                 f"its shapes there add up to {runs[p]}")
    gap = {shape: (t["device_ms"] or t["ms"]) - t["bound_ms"]
           for shape, t in times.items()}
    loss = {p: sum(n * gap[s] for s, n in runs[p].items()) for p in PATHS}
    log("[launches] P5 per path: launches x the gap to the bound of the "
        "shape each ran (device times) = " + "; ".join(
            f"{p} " + " + ".join(f"{n} x {gap[s]:.4f} ({s})"
                                 for s, n in runs[p].items())
            + f" = {loss[p]:.2f} ms" for p in PATHS if launches[p])
        + f"; in all {sum(loss.values()):.2f} ms | {card}")
    return loss


# -- the command line -----------------------------------------------------------

def run_cli(argv, env=None, what=""):
    """``python -m kmer_hasher_tpu_torch <argv>`` in a subprocess from the
    checkout's root: (its last stdout line as JSON where it is JSON, all of
    stdout, seconds). A nonzero exit raises with the output's end."""
    cmd = [sys.executable, "-m", "kmer_hasher_tpu_torch"] + [
        str(a) for a in argv]
    full_env = dict(os.environ, PYTHONPATH=str(ROOT))
    full_env.update(env or {})
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, env=full_env, capture_output=True,
                         text=True, timeout=900)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(
            f"{' '.join(cmd)} exited with {res.returncode}:\n"
            f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    lines = res.stdout.strip().splitlines()
    try:
        info = json.loads(lines[-1]) if lines else None
    except ValueError:
        info = None
    log(f"[main] cli: {what or argv[0]}: {secs:.1f} s in a subprocess"
        + (f": {lines[-1][:300]}" if info is not None else ""))
    return info, res.stdout, secs


def same_store(a, b) -> bool:
    return (torch.equal(a.keys.cpu(), b.keys.cpu())
            and torch.equal(a.cnt.cpu(), b.cnt.cpu())
            and bool((a.total_added == b.total_added).all()))


def write_fasta(path: Path, name: str, seq: np.ndarray, width: int = 80):
    """One record, ``width`` bases a line, laid out with numpy."""
    n = seq.shape[0]
    full = n // width
    body = np.empty((full, width + 1), np.uint8)
    body[:, :width] = seq[: full * width].reshape(full, width)
    body[:, width] = ord("\n")
    with open(path, "wb") as f:
        f.write(f">{name}\n".encode())
        f.write(body.tobytes())
        if n % width:
            f.write(seq[full * width:].tobytes() + b"\n")


def main_cli(argv):
    """The command line's ``main(argv)`` in this process: (its last stdout
    line as JSON where it is JSON, all of stdout)."""
    import contextlib
    import io

    from kmer_hasher_tpu_torch import __main__ as cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main([str(a) for a in argv])
    lines = out.getvalue().strip().splitlines()
    try:
        return (json.loads(lines[-1]) if lines else None), out.getvalue()
    except ValueError:
        return None, out.getvalue()


def phase_main_cli(seq: np.ndarray, batches, main: dict, tmp: Path,
                   card: str):
    """The command line in subprocesses, then the file entry in-process
    with launches counted: see the module docstring."""
    import shutil

    from kmer_hasher_tpu_torch import api
    from kmer_hasher_tpu_torch.utils import checkpoint

    k = K_COUNT
    n_all = len(batches) * ROWS
    rec_bytes = 7 + 2 * READ_LEN
    free = shutil.disk_usage(tmp).free
    # the FASTQ and the saved store must fit beside it
    n_reads = n_all if free > 3 * n_all * rec_bytes else CLI_MIN_READS
    fq, fq50 = tmp / "reads.fq", tmp / "reads50k.fq"
    t0 = time.perf_counter()
    write_fastq(fq, batches, n_reads)
    write_fastq(fq50, batches, FILE_READS)
    log(f"[main] cli: wrote {n_reads:,} of the counting cell's {n_all:,} "
        f"reads as FASTQ ({fq.stat().st_size / 1e6:.1f} MB"
        + ("" if n_reads == n_all else
           f"; the temporary directory has only {free / 1e9:.1f} GB free")
        + f") and the first {FILE_READS:,} as a second file, "
        f"{time.perf_counter() - t0:.1f} s")
    staged = main["store"]
    if n_reads != n_all:
        from kmer_hasher_tpu_torch import counting

        cut = [tuple(a[:n_reads - i * ROWS] for a in b)
               for i, b in enumerate(batches[: -(-n_reads // ROWS)])]
        staged = counting.count_batches(api.CountStore(k), cut, k,
                                        min_q=MIN_Q, exact_ll="hybrid")
    count = ["-k", k, "--min-q", MIN_Q, "--ll-mode", "hybrid"]

    # count in a subprocess at the cell's size; spectrum and depth of the
    # store it saved through main(argv) here
    info, _, t_count = run_cli(["count", fq, *count, "-o", tmp / "store.npz"],
                               what=f"count of {n_reads:,} reads")
    if info["reader"] != "native":
        raise AssertionError(f"the count verb read through {info['reader']}")
    saved = checkpoint.load_count_store(tmp / "store.npz")
    if not same_store(saved, staged) or info["distinct"] != staged.n_unique:
        raise AssertionError("the count verb's saved table differs from the "
                             "store built from the same reads staged on the "
                             "card")
    _, out = main_cli(["spectrum", tmp / "store.npz", "--max-count", 255])
    spec = api.kmer_spectrum(staged, 255)
    want = "".join(f"{c}\t{int(v)}\n" for c, v in enumerate(spec) if v)
    if out != want:
        raise AssertionError("the spectrum verb's lines differ from "
                             "kmer_spectrum of the staged store")
    write_fasta(tmp / "stretch.fa", "stretch", main["stretch"].cpu().numpy())
    main_cli(["depth", tmp / "store.npz", tmp / "stretch.fa", "-k", k, "-o",
              tmp / "depth.npy"])
    if n_reads == n_all and not np.array_equal(
            np.load(tmp / "depth.npy"), main["depth"].cpu().numpy()):
        raise AssertionError("the depth verb's track differs from "
                             "seq_kmer_depth in-process")
    log(f"[main] cli: count -> {saved.n_unique:,} distinct, reader native; "
        f"the saved table equals the staged store's, bitwise; spectrum "
        f"prints kmer_spectrum's {len(want.splitlines())} nonzero bins; "
        f"depth of {DEPTH_LEN:,} bases equals the in-process track")
    del saved

    # both readers and resume on the first 50,000 reads: the pure-Python
    # reader counts a run cut by --max-reads, the native reader resumes it
    info, _, _ = run_cli(
        ["count", fq50, *count, "--max-reads", CLI_CUT_READS,
         "--checkpoint-every", CLI_CKPT_EVERY, "--batch-rows", 8192,
         "--no-pack", "-o", tmp / "ck.npz"], env={"KMH_NATIVE_IO": "0"},
        what="count, KMH_NATIVE_IO=0, cut by --max-reads")
    cur = checkpoint.load_progress(tmp / "ck.npz")
    if info["reader"] != "python" or cur["reads_done"] != CLI_CUT_READS or (
            cur["done"]):
        raise AssertionError(f"the cut run read through {info['reader']} and "
                             f"left the cursor {cur}")
    info, _, _ = run_cli(
        ["count", fq50, *count, "--resume", tmp / "ck.npz",
         "--checkpoint-every", CLI_CKPT_EVERY, "-o", tmp / "ck.npz"],
        what="count --resume")
    resumed = checkpoint.load_count_store(tmp / "ck.npz")
    cur = checkpoint.load_progress(tmp / "ck.npz")
    # in this process: the file entry over the same 50,000 reads (this run
    # also warms the path up for the timed one below)
    t1 = time.perf_counter()
    un = api.count_kmers_fq_sh_rp(str(fq50), k=k, min_q=MIN_Q,
                                  exact_ll="hybrid")
    torch.cuda.synchronize()
    t_50 = time.perf_counter() - t1
    if not (info["reader"] == "native" and cur["done"]
            and cur["reads_done"] == FILE_READS and same_store(resumed, un)):
        raise AssertionError("the run cut under the pure-Python reader and "
                             "resumed under the native one differs from the "
                             "uncut native run")
    log(f"[main] cli: on the first {FILE_READS:,} reads a run cut at "
        f"{CLI_CUT_READS:,} reads under KMH_NATIVE_IO=0 (reader python, "
        f"--no-pack accepted) and resumed under the native reader equals the "
        f"uncut native run ({un.n_unique:,} distinct), bitwise")
    del resumed, un

    # index / tables / query through main(argv) on a prefix of the sequence
    # (the 40,000,000-base index path itself is phase 4)
    ref = seq[:CLI_REF_LEN]
    query = seq[QUERY_AT: QUERY_AT + QUERY_LEN]
    write_fasta(tmp / "ref.fa", "chr", ref)
    write_fasta(tmp / "query.fa", "query", query)
    info, _ = main_cli(["index", tmp / "ref.fa", "-k", 32, "-o",
                        tmp / "i32.npz"])
    main_cli(["tables", tmp / "i32.npz", "--opt-flag", 2 | 8, "-o",
              tmp / "tab"])
    idx = api.make_kmer_hash(ref, 32)
    tabs = api.kmer_pos(idx, 2 | 8)
    if (info["positions"], info["distinct"], info["pairs"]) != (
            idx.n_valid, idx.n_kmers, idx.total_pairs):
        raise AssertionError(f"index -k 32 says {info}")
    for name in ("pos", "count"):
        if not np.array_equal(np.load(tmp / f"tab.{name}.npy"),
                              tabs[name].cpu().numpy()):
            raise AssertionError(f"tables: {name} differs from kmer_pos")
    n_pos, n_distinct = idx.n_valid, idx.n_kmers
    del idx, tabs
    main_cli(["index", tmp / "ref.fa", "-k", 21, "-o", tmp / "i21.npz"])
    info, _ = main_cli(["query", tmp / "i21.npz", tmp / "query.fa", "-k", 21,
                        "-o", tmp / "hits.npy"])
    rows = api.seq_kmer_pos(api.make_kmer_hash(ref, 21), query, 21)
    if info["hits"] != rows.shape[0] or rows.shape[0] < 1 or (
            not np.array_equal(np.load(tmp / "hits.npy"),
                               rows.cpu().numpy())):
        raise AssertionError("query: rows differ from seq_kmer_pos")
    log(f"[main] cli: index -k 32 + tables of a FASTA of the sequence's "
        f"first {CLI_REF_LEN:,} bases ({n_pos:,} positions, {n_distinct:,} "
        f"distinct): pos and count equal kmer_pos(2|8) in-process; index -k "
        f"21 + query of {QUERY_LEN:,} bases: {rows.shape[0]:,} rows equal "
        f"seq_kmer_pos")
    del rows

    # the file entry in-process: launches counted, the reading timed
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = api.count_kmers_fq_sh_rp(str(fq), k=k, min_q=MIN_Q,
                                  exact_ll="hybrid")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches("cli")
    tm = st.timings
    if tm["reader"] != "native":
        raise AssertionError(f"the file entry read through {tm['reader']}: "
                             f"{native_build_error()}")
    if not same_store(st, staged):
        raise AssertionError("the file entry's store differs from the "
                             "staged store")
    if (launches[1] < -(-n_reads // 32_768) or launches[2] < 1
            or launches[2] != two_run_merges(st)):
        raise AssertionError(f"the file entry launched B2 {launches[1]} and "
                             f"B3 {launches[2]} times")
    del st
    staged_rate = main["n_reads"] / main["wall"]
    log(f"[times] file entry count_kmers_fq_sh_rp of {n_reads:,} reads "
        f"({fq.stat().st_size / 1e6:.1f} MB FASTQ), native reader, hybrid: "
        f"{wall:.3f} s = {n_reads / wall:,.0f} reads/s; producer thread busy "
        f"parsing and padding {tm['parse_s']:.3f} s, consumer waiting for it "
        f"{tm['wait_s']:.3f} s, staging and enqueueing the copies "
        f"{tm['copy_s']:.3f} s, {tm['h2d_bytes'] / tm['file_reads']:.1f} "
        f"bytes/read to the card; the same reads staged on the card: "
        f"{main['wall']:.3f} s = {staged_rate:,.0f} reads/s; the "
        f"{FILE_READS:,}-read file {t_50:.3f} s; the count verb in a "
        f"subprocess, start to exit, {t_count:.1f} s; B2 launches "
        f"{launches[1]}, B3 launches {launches[2]} | {card}")
    return launches, {"wall": wall, "reads": n_reads,
                      "timings": {k_: v for k_, v in tm.items()
                                  if not isinstance(v, str)}}


def phase_card_vs_cpu_cli(fq50: Path, tmp: Path) -> None:
    """The count verb on a small file with --device cpu and on the card:
    the same JSON line and the same saved table."""
    import contextlib
    import io

    from kmer_hasher_tpu_torch import __main__ as cli
    from kmer_hasher_tpu_torch.utils import checkpoint

    infos = {}
    for dev in ("cuda", "cpu"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(["count", str(fq50), "-k", str(K_COUNT), "--min-q",
                      str(MIN_Q), "--ll-mode", "hybrid", "--max-reads",
                      "4000", "-o", str(tmp / f"cli-{dev}.npz"), "--device",
                      dev])
        infos[dev] = json.loads(out.getvalue().strip().splitlines()[-1])
        infos[dev].pop("out")
    g, c = (checkpoint.load_count_store(tmp / f"cli-{dev}.npz", device="cpu")
            for dev in ("cuda", "cpu"))
    if infos["cuda"] != infos["cpu"] or not same_store(g, c) or (
            g.n_unique < 1):
        raise AssertionError(f"count --device cpu differs from the card: "
                             f"{infos}")
    log(f"[card-vs-cpu] cli: count of 4,000 reads with --device cuda and "
        f"--device cpu: the same JSON line ({infos['cpu']['distinct']:,} "
        f"distinct, reader {infos['cpu']['reader']}) and the same saved "
        f"table, bitwise")


# -- the spill regime ---------------------------------------------------------

def phase_main_spill(card: str):
    """The full-corpus spill regime through its entry point,
    ``probes.spill_regime.run`` (see the module docstring), with its
    checks held here as well."""
    from kmer_hasher_tpu_torch import api
    from kmer_hasher_tpu_torch.probes import spill_regime

    k = K_COUNT
    n_reads = SPILL_BATCHES * ROWS
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    r = spill_regime.run(SPILL_BATCHES, k, SPILL_BYTES, ROWS,
                         SPILL_FOLD_BUDGET, MIN_Q)
    launches = read_launches("spill")
    peak = torch.cuda.max_memory_allocated()
    store, control, loop_tm = r["store"], r["control"], r["loop_timings"]
    t_loop, t_fold, t_spec, spec = (r["loop_s"], r["fold_s"],
                                    r["spectrum_s"], r["spectrum"])

    tm = store.timings
    distinct, total = store.n_unique, int(store.total_added.sum())
    n0, same = spill_regime.control_prefix_equal(store, control)
    if not same:
        raise AssertionError(
            f"sliced exact control: the big table's prefix ({n0:,} rows) "
            f"differs from the control store ({control.n_unique:,} rows)")
    if loop_tm["spills"] < 2 or tm["ranged_folds"] != 1 or tm["ranges"] < 4:
        raise AssertionError(
            f"not the spill regime: {loop_tm['spills']} spills in the loop, "
            f"{tm['ranged_folds']} ranged folds, {tm['ranges']} ranges")
    if distinct < SPILL_MIN_DISTINCT:
        raise AssertionError(f"{distinct:,} distinct k-mers, want at least "
                             f"{SPILL_MIN_DISTINCT:,}")
    if not (store.keys.is_cuda and int(store.cnt.sum()) == total
            and bool((store.keys[1:] > store.keys[:-1]).all())
            and spec.shape == (11,) and int(spec.sum()) == distinct
            and (spec == api.kmer_spectrum(store, 10)).all()):
        raise AssertionError("the folded table is not a sorted unique table "
                             "on the card that sums to total_added")
    merges = two_run_merges(store) + two_run_merges(control)
    rounds = tm["range_rounds"] + control.timings["range_rounds"]
    if (launches[1] != SPILL_BATCHES or launches[2] != merges + rounds
            or tm["range_rounds"] < 1):
        raise AssertionError(
            f"the spill path launched B2 {launches[1]} and B3 {launches[2]} "
            f"times; its stores merged two runs {merges} times and ran "
            f"{rounds} range rounds")
    log(f"[main] spill: {SPILL_BATCHES} batches x {ROWS:,} uniform-random "
        f"reads x {READ_LEN} = {n_reads:,} reads, k={k}, min_q={MIN_Q}, f32 "
        f"filter, spill_bytes {SPILL_BYTES >> 20} MiB, fold budget "
        f"{SPILL_FOLD_BUDGET >> 20} MiB: {total:,} observations, "
        f"{distinct:,} distinct; count loop {t_loop:.3f} s = "
        f"{n_reads / t_loop:,.0f} reads/s with {loop_tm['spills']} spills "
        f"({loop_tm['spill_s']:.3f} s, {loop_tm['spilled_rows']:,} rows) and "
        f"{loop_tm['tier_merges']} tier merges "
        f"({loop_tm['tier_merge_s']:.3f} s); fold {t_fold:.3f} s: "
        f"{tm['spills'] - loop_tm['spills']} more runs to the host "
        f"({tm['spill_s'] - loop_tm['spill_s']:.3f} s), then {tm['ranges']} "
        f"key ranges, {tm['fold_merges']} two-run merges, "
        f"{tm['range_rounds']} range rounds; spectrum(10) "
        f"{t_spec:.3f} s, head {spec[:4].astype(np.int64).tolist()}; "
        f"{n_reads / (t_loop + t_fold):,.0f} reads/s loop + fold; peak "
        f"device memory {peak / 2 ** 30:.2f} GiB | {card}")
    log(f"[main] spill: sliced exact control: the {n0:,} rows of the big "
        f"table below 2^32 (1/1024 of the key space) equal the control "
        f"store bitwise; B2 launches {launches[1]}, B3 launches "
        f"{launches[2]} = {two_run_merges(store)} two-run merges of the big "
        f"store (tier {tm['tier_merges']}, fold {tm['fold_merges']}) + "
        f"{tm['range_rounds']} range rounds of its ranged fold + "
        f"{two_run_merges(control)} two-run merges and "
        f"{control.timings['range_rounds']} range rounds of the control")
    return launches


def phase_card_vs_cpu_spill(batches, fq: Path, tmp: Path) -> None:
    """A spilled store (to memory and to files), a ranged fold forced by a
    small fold budget, and a drop-mode count_kmers_fq, each on the card and
    on the CPU: bitwise equal."""
    from kmer_hasher_tpu_torch import api, counting

    k = K_COUNT
    cut = [tuple(a[:4096] for a in b) for b in batches[:8]]
    host = [tuple(a.cpu() for a in b) for b in cut]
    seen = []
    for how in ("memory", "disk", "ranged"):
        got = {}
        for dev, bs in (("cuda", cut), ("cpu", host)):
            st = api.CountStore(
                k, spill_bytes=2 << 20, device=dev,
                spill_dir=str(tmp / f"spill-{dev}") if how == "disk" else None,
                fold_budget_bytes=4 << 20 if how == "ranged" else None)
            counting.count_batches(st, bs, k, min_q=MIN_Q, exact_ll=True)
            got[dev] = st
        g, c = got["cuda"], got["cpu"]
        tm = g.timings
        same = (torch.equal(g.keys.cpu(), c.keys)
                and torch.equal(g.cnt.cpu(), c.cnt)
                and (g.total_added == c.total_added).all()
                and (api.kmer_spectrum(g, 255)
                     == api.kmer_spectrum(c, 255)).all())
        if not same or tm["spills"] < 2 or (
                tm["ranged_folds"] != int(how == "ranged")) or (
                how == "ranged" and tm["ranges"] < 4):
            raise AssertionError(
                f"spill to {how}: card and CPU differ, or the card store "
                f"did not spill as meant: {tm}")
        if how == "disk" and list(tmp.glob("spill-*/kmh_spill_*")):
            raise AssertionError("spill files were left behind")
        seen.append(f"{how} ({tm['spills']} spills, {tm['ranges']} "
                    f"ranges, {tm['fold_merges']} two-run fold merges, "
                    f"{tm['range_rounds']} range rounds, {g.n_unique:,} "
                    f"k-mers)")
    drop = {dev: api.count_kmers_fq(
        str(fq), k=k, min_q=MIN_Q, max_mem_gb=1, max_reads=10_000,
        budget_semantics="drop", device=dev) for dev in ("cuda", "cpu")}
    g, c = drop["cuda"], drop["cpu"]
    if not (g.keys.is_cuda and g._admit_frozen and g.n_unique > 0
            and torch.equal(g.keys.cpu(), c.keys)
            and torch.equal(g.cnt.cpu(), c.cnt)
            and (g.total_added == c.total_added).all()
            and (g._admitted == c._admitted).all()
            and g.n_alloc_blocks() == len(g._admitted) == g._budget_blocks
            and (api.kmer_spectrum(g, 255)
                 == api.kmer_spectrum(c, 255)).all()):
        raise AssertionError("drop-mode count_kmers_fq: card and CPU differ")
    log(f"[card-vs-cpu] spill, 8 batches x 4,096 reads, spill_bytes 2 MiB: "
        f"{'; '.join(seen)}; drop-mode count_kmers_fq of 10,000 reads with a "
        f"1 GiB budget ({g._budget_blocks} blocks admitted, then frozen; "
        f"{g.n_unique:,} k-mers kept, {int(g.total_added.sum()):,} "
        f"observations) — keys, counts, total_added and spectrum(255) "
        f"bitwise equal card vs CPU")


def phase_times_probes(cases: dict, card: str) -> dict:
    """P1-P4 per launch at every shape, beside the plain version and one
    library call: ``copy_`` into a tensor that exists (P1), the gather with
    its index built beforehand (P2; P3/P4 at the full shape), ``torch.roll``
    with the shift read back from the card (P3/P4, one tile)."""
    from kmer_hasher_tpu_torch.probes import cuda_probes as cp
    from kmer_hasher_tpu_torch.probes import sort_probes as sp

    def library(name, shape, args):
        x = args[0]
        if name == "P1":
            out = torch.empty_like(x)
            return lambda: out.copy_(x)
        if name == "P2":
            idx = (args[1].long()[:, None] + torch.arange(
                cp.CH, device="cuda")).reshape(-1)
            return lambda: x[idx]
        if shape == "ref":
            if name == "P3":
                return lambda: torch.roll(x, int(args[1]), 0)
            return lambda: torch.roll(x.reshape(-1), int(args[1]))
        n = sp.TILE[0] * sp.TILE[1]
        e = args[1].long() * (sp.TILE[1] if name == "P3" else 1)
        idx = (torch.arange(n, device="cuda") - e[:, None]) % n
        flat = x.reshape(-1, n)
        return lambda: torch.gather(flat, 1, idx)

    out = {}
    for name, (fn, plain) in probe_kernels().items():
        out[name] = {}
        for shape, args in cases[name].items():
            if not shape.startswith(("ref", "full")):
                continue
            big = args[0].numel() > 1 << 20
            ms = cuda_ms(lambda: fn(*args), iters=20 if big else 200)
            plain_ms = cuda_ms(lambda: plain(*args), iters=2, warmup=1)
            lib = library(name, shape, args)
            lib_ms = cuda_ms(lib, iters=10 if big else 100)
            split = device_split(lambda: fn(*args), lib,
                                 iters=10 if big else 50, key=(name, shape))
            if name == "P2":
                tiles = args[1].numel()
                moved = 2 * 4 * tiles * cp.CH + 4 * tiles
            elif name == "P1":
                moved = 2 * 4 * args[0].numel()
            else:
                moved = 2 * 4 * args[0].numel() + 4 * args[1].numel()
            b_ms, b_by = bound(moved, 0)
            out[name][shape] = {"ms": ms, "plain_ms": plain_ms,
                                "library_ms": lib_ms, "bytes": moved,
                                "bound_ms": b_ms, "bound_by": b_by, **split}
            log(f"[times] {name}, {shape}: kernel {ms:.4f} ms = "
                f"{moved / ms / 1e9:.3f} TB/s of {moved / 1e6:.3f} MB "
                f"(bound {b_ms:.4f} ms), plain {plain_ms:.4f} ms, library "
                f"call {lib_ms:.4f} ms (CUDA events){split_txt(split)} | "
                f"{card}")
    return out


# -- the DMA probes P9, P10 -----------------------------------------------------

def probe_dma_cases(gen) -> dict:
    """P9's and P10's inputs on the card, by kernel and shape name. "ref"
    shapes are the TPU probes' (2^24 elements, the permutation of the
    windows at 512, 64 and 8 rows; 2^20 indices), "full" the full-card ones
    (2^26 elements), "static" D2 (offsets computed, not read), the others
    edge inputs: overlapping write windows, steps outside x, one step, D2 on
    rows that R does not divide, indices outside the table."""
    from kmer_hasher_tpu_torch.probes import cuda_probes_dma as cpd
    from kmer_hasher_tpu_torch.probes import cuda_probes_r3 as cp3
    from kmer_hasher_tpu_torch.probes import dma_probes_r3 as dp

    def dev(a):
        return torch.from_numpy(np.asarray(a).astype(np.int32)).cuda()

    n_ref, n_full = 1 << PROBE_REF_LOG_N, 1 << PROBE_LOG_N
    x = rand32(gen, (n_full,))
    x2, x2_ref = x.reshape(-1, cp3.COLS), x[:n_ref].reshape(-1, cp3.COLS)
    rows_ref, rows_full = x2_ref.shape[0], x2.shape[0]
    rng = np.random.default_rng(SEED + 6)
    cases = {"P9": {}, "P10": {}}
    for r in DMA_ROWS:
        cases["P9"][f"ref, R={r}"] = (x2_ref, dev(
            dp.window_offsets(rows_ref, r)), r)
        cases["P9"][f"full, R={r}"] = (x2, dev(
            dp.window_offsets(rows_full, r)), r)
    cases["P9"]["static, ref, R=512"] = (x2_ref, None, 512)
    cases["P9"]["static, full, R=512"] = (x2, None, 512)
    cases["P9"]["overlapping, R=512"] = (x2_ref, dev(
        rng.integers(0, 20_000, size=4096)), 512)
    cases["P9"]["steps outside x, R=200"] = (x2_ref, dev(
        [0, 100, rows_ref - 200, -1, rows_ref - 199, 2 ** 31 - 1, 300,
         -2 ** 31, rows_ref, 150]), 200)
    cases["P9"]["T=1"] = (x2_ref, dev([0]), rows_ref)
    cases["P9"]["static T=1"] = (x2_ref, None, rows_ref)
    cases["P9"]["static, R=777"] = (x2_ref, None, 777)
    tab = rand32(gen, (cpd.TABLE_ROWS, cp3.COLS))
    for name, n in (("ref", 1 << DMA_GATHER_REF_LOG_N), ("full", n_full)):
        cases["P10"][name] = (tab, torch.randint(
            0, cpd.TABLE_ROWS, (n // cp3.COLS, cp3.COLS), generator=gen,
            device="cuda", dtype=torch.int32))
    idx = torch.randint(-5000, 5000, (1 << 9, cp3.COLS), generator=gen,
                        device="cuda", dtype=torch.int32)
    idx[0, :6] = torch.tensor([0, 1023, 1024, -1, 2 ** 31 - 1, -2 ** 31],
                              dtype=torch.int32)
    cases["P10"]["indices outside the table"] = (tab, idx)
    # P10's edges: rows one below, at and above a task, a round of tasks
    # over the row groups (one block an SM, four column slabs) and several,
    # indices outside the table in the last row too; a table that starts
    # 4 bytes into a tensor
    task = cpd.LANE_TASK
    rnd = task * (torch.cuda.get_device_properties(0).multi_processor_count
                  // 4)
    for rows in (1, 7, task - 1, task + 1, rnd - 1, rnd, rnd + 1,
                 8193, 1 << 16):
        idx = torch.randint(-3, cpd.TABLE_ROWS + 3, (rows, cp3.COLS),
                            generator=gen, device="cuda", dtype=torch.int32)
        idx[-1, -4:] = torch.tensor([-2 ** 31, 2 ** 31 - 1, 1024, 1023],
                                    dtype=torch.int32)
        cases["P10"][f"rows={rows:,}"] = (tab, idx)
    flat = rand32(gen, (cpd.TABLE_ROWS * cp3.COLS + 1,))
    cases["P10"]["a table 4 bytes in, rows=8,193"] = (
        flat[1:].view(cpd.TABLE_ROWS, cp3.COLS), idx[:8193])
    return cases


def probe_dma_kernels():
    """name -> (wrapper, plain version)."""
    from kmer_hasher_tpu_torch.probes import cuda_probes_dma as cpd

    return {"P9": (cpd.pipelined_copy, cpd.plain_pipelined_copy),
            "P10": (cpd.lane_gather, cpd.plain_lane_gather)}


def p9_source_rows(x, offs, r) -> np.ndarray:
    """numpy's loop over P9's steps on row numbers (D2's offsets where
    ``offs`` is None): per output row the x row that stands, -1 for none."""
    from kmer_hasher_tpu_torch.probes import sort_probes_r3 as sp3

    offs_h = (np.arange(x.shape[0] // r, dtype=np.int64) * r
              if offs is None else offs.cpu().numpy())
    return sp3.sequential_source_rows(x.shape[0], offs_h, r)


def phase_kernels_probes_dma(cases: dict) -> dict:
    """P9 and P10 against their plain versions on the same CUDA tensors,
    bitwise over the whole output; P9 also against numpy's loop over row
    numbers and, with the offsets read, against P5. Returns the worst
    max_abs_err by kernel."""
    from kmer_hasher_tpu_torch.probes import cuda_probes_r3 as cp3

    worst = {}
    for name, (fn, plain) in probe_dma_kernels().items():
        worst[name] = 0.0
        for shape, args in cases[name].items():
            got = fn(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            worst[name] = max(worst[name], err)
            if err or got.shape != want.shape:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version: {shape}, max_abs_err={err}")
            if name == "P9":
                x, offs, r = args
                src = p9_source_rows(x, offs, r)
                live = torch.from_numpy(src >= 0).cuda()
                rows = torch.from_numpy(np.maximum(src, 0)).cuda()
                if not (torch.equal(got[live], x[rows[live]])
                        and not bool(got[~live].any())):
                    raise AssertionError(
                        f"P9 disagrees with numpy's loop: {shape}")
                if offs is not None and not torch.equal(
                        got, cp3.dyn_copy_2d(x, offs, r)):
                    raise AssertionError(f"P9 disagrees with P5: {shape}")
            else:
                tab, idx = args
                ok = (idx >= 0) & (idx < tab.shape[0])
                if bool(got[~ok].any()):
                    raise AssertionError("P10 read outside its table")
            del got, want
        log(f"[kernels] {name} == plain, bitwise over the whole output, on "
            f"{len(cases[name])} inputs: {', '.join(cases[name])} "
            f"(max_abs_err {worst[name]})"
            + ("; equal to numpy's loop in step order as well, and to P5 "
               "where the offsets are read" if name == "P9"
               else "; 0 for every index outside [0, 1024)"))
    return worst


def phase_main_probes_dma():
    """The DMA probe entry point as a user runs it, at log_n 26."""
    from kmer_hasher_tpu_torch.probes import _common, dma_probes_r3

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = dma_probes_r3.run(PROBE_LOG_N)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches("probes_dma")
    timed = _common.calls_per_timing(torch.device("cuda"))
    per = 1 + timed  # a line: one check launch plus one timing's
    n_copy = len(dma_probes_r3.COPY_PROBES)
    # D1/D2 time P5 beside P9, D3 P1 beside P10, D4 runs B3 (check + timed)
    want = (0, 0, 2 * per, 2 * timed, 0, 0, 0, n_copy * timed, 0, 0, 0,
            n_copy * per, 2 * per)
    if launches != want:
        raise AssertionError(f"the DMA probe entry launched (B1, B2, B3, "
                             f"P1, ..., P10) {launches}, want {want}")
    lines = sum(len(v) for v in res.values())
    log(f"[main] probes dma: dma_probes_r3 at log_n {PROBE_LOG_N} through "
        f"its entry point, {lines} lines, all ok (a probe that is not "
        f"raises), {wall:.3f} s; launches P9 {launches[11]}, P10 "
        f"{launches[12]} (per line 1 check + {timed} timed), and beside them "
        f"P5 {launches[7]}, P1 {launches[3]}, B3 {launches[2]}")
    return launches


def phase_times_probes_dma(cases: dict, card: str) -> dict:
    """P9 and P10 per launch at the reference, full and D2 shapes, beside
    the plain version, P5 (P9) or P1's copy of the indices (P10), and one
    PyTorch call that computes the same function with its int64 index
    ready: the gather and scatter of whole windows (P9, where the windows
    tile x), ``torch.gather`` along the table's rows (P10)."""
    from kmer_hasher_tpu_torch.probes import cuda_probes as cp
    from kmer_hasher_tpu_torch.probes import cuda_probes_dma as cpd
    from kmer_hasher_tpu_torch.probes import cuda_probes_r3 as cp3

    def library(name, args):
        if name == "P10":
            tab, idx64 = args[0], args[1].long()
            return lambda: torch.gather(tab, 0, idx64)
        x, offs, r = args
        steps = x.shape[0] // r
        rd = (torch.arange(steps, device="cuda") if offs is None
              else offs.long() // r)
        wr = torch.flip(rd, [0])
        blocks = x.reshape(steps, -1)
        out = torch.empty_like(blocks)

        def f():
            out[wr] = blocks[rd]
        return f

    out = {}
    for name, (fn, plain) in probe_dma_kernels().items():
        out[name] = {}
        for shape, args in cases[name].items():
            if not shape.startswith(("ref", "full", "static, ref",
                                     "static, full")):
                continue
            big = args[0].numel() > 1 << 25 or args[1] is not None and (
                args[1].numel() > 1 << 25)
            ms = cuda_ms(lambda: fn(*args), iters=20 if big else 200)
            plain_ms = cuda_ms(lambda: plain(*args), iters=1, warmup=1)
            lib = library(name, args)
            lib_ms = cuda_ms(lib, iters=10 if big else 100)
            row = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   **device_split(lambda: fn(*args), lib,
                                  iters=10 if big else 50,
                                  key=(name, shape))}
            if name == "P9":
                x, offs, r = args
                offs5 = (cpd.static_offsets(x.shape[0], r, x.device)
                         if offs is None else offs)
                row["p5_ms"] = cuda_ms(lambda: cp3.dyn_copy_2d(x, offs5, r),
                                       iters=20 if big else 200)
                # the rows that stand are read once, the whole output is
                # written once, the offsets (none for D2) read once
                moved = (512 * int((p9_source_rows(x, offs, r) >= 0).sum())
                         + 4 * x.numel()
                         + (0 if offs is None else 4 * offs.numel()))
                extra = (f"; P5 {row['p5_ms']:.4f} ms for the same call "
                         f"(both write zeros only to rows no step owns)")
            else:
                idx = args[1]
                row["copy_ms"] = cuda_ms(lambda: cp.copy(idx),
                                         iters=20 if big else 200)
                moved = 8 * idx.numel() + 4 * cpd.TABLE_ROWS * cp3.COLS
                extra = (f" = {ms * 1e6 / idx.numel():.4f} ns/element; P1's "
                         f"copy of the indices {row['copy_ms']:.4f} ms: "
                         f"{row['copy_ms'] / ms:.1%} of its rate")
            b_ms, b_by = bound(moved, 0)
            row.update(bytes=moved, bound_ms=b_ms, bound_by=b_by)
            out[name][shape] = row
            log(f"[times] {name}, {shape}: kernel {ms:.4f} ms = "
                f"{moved / ms / 1e9:.3f} TB/s of {moved / 1e6:.3f} MB "
                f"(bound {b_ms:.4f} ms), plain {plain_ms:.4f} ms, library "
                f"call {lib_ms:.4f} ms{extra} (CUDA events)"
                f"{split_txt(row)} | {card}")
    return out


def phase_times_turns(p_times: dict) -> list:
    """P10, P1 and P6 against their library calls in turns (kernel, call,
    call, kernel; 5 pairs by CUDA events, 3 by device time; medians) at
    the TPU probes' and the full shapes, P10 also over one row: the verdict
    of "slower than a PyTorch call" rests on these device times. Their
    device and host figures go into the rows of ``p_times`` that
    TURN_SHAPES names. The rows, trimmed for the kernels' JSON line."""
    from kmer_hasher_tpu_torch.probes import turns

    keep = ("ms", "device_ms", "host_us_per_call")
    rows = [{"probe": r["probe"], "shape": r["shape"],
             "library_call": r["library_call"],
             **{who: {k: r[who][k] for k in keep}
                for who in ("kernel", "library")}}
            for r in turns.run()]
    there = {(r["probe"], r["shape"]): r for r in rows}
    for (name, shape), theirs in TURN_SHAPES.items():
        r = there[(name, theirs)]
        p_times[name][shape].update(
            device_ms=r["kernel"]["device_ms"],
            host_us_per_call=r["kernel"]["host_us_per_call"],
            library_device_ms=r["library"]["device_ms"])
    return rows


# -- the sharded count store ----------------------------------------------------

def sharded_union_is(st, single) -> bool:
    """Every shard sorted, unique and holding only its own keys, and the
    shard tables merged equal to the single store's, bitwise."""
    from kmer_hasher_tpu_torch.parallel import owner_of_keys

    st.flush()
    single.flush()
    for d, s in enumerate(st.shards):
        if not (bool((s.keys[1:] > s.keys[:-1]).all())
                and bool((owner_of_keys(s.keys, st.n_shards) == d).all())):
            return False
    keys = torch.cat([s.keys for s in st.shards])
    order = torch.sort(keys)
    return (torch.equal(order.values, single.keys) and torch.equal(
        torch.cat([s.cnt for s in st.shards])[order.indices], single.cnt)
        and bool((st.total_added == single.total_added).all()))


def same_shards(a, b) -> bool:
    return a.n_shards == b.n_shards and all(
        torch.equal(x.keys.cpu(), y.keys.cpu())
        and torch.equal(x.cnt.cpu(), y.cnt.cpu())
        for x, y in zip(a.shards, b.shards)) and bool(
            (a.total_added == b.total_added).all())


def sharded_merges(st) -> int:
    tm = st.shard_timings()
    return tm["tier_merges"] + tm["fold_merges"]


def phase_main_sharded(batches, main: dict):
    """The counting cell's reads through ShardedCountStore(21,
    make_mesh(8)) by the loop the file entry uses, then spectrum and depth:
    the union of the shard tables equals the single store of the counting
    phase bitwise, every shard holds only its owners' keys, spectra,
    total_added and depth are equal. Launches counted (path sharded)."""
    from kmer_hasher_tpu_torch import api, counting
    from kmer_hasher_tpu_torch.parallel import ShardedCountStore, make_mesh

    k = K_COUNT
    single = main["store"]
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = ShardedCountStore(k, make_mesh(SHARDS))
    stats = {}
    counting.count_batches(st, batches, k, min_q=MIN_Q, exact_ll="hybrid",
                           stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spec = api.kmer_spectrum(st, 255)
    depth = api.seq_kmer_depth(st, main["stretch"], k)
    torch.cuda.synchronize()
    launches = read_launches("sharded")
    if st.device.type != "cuda" or any(s.keys.device.type != "cuda"
                                       for s in st.shards):
        raise AssertionError("the sharded store does not live on the card")
    if not sharded_union_is(st, single):
        raise AssertionError("the 8 shard tables differ from the single "
                             "store's table")
    if not np.array_equal(spec, api.kmer_spectrum(single, 255)):
        raise AssertionError("the sharded spectrum differs")
    if not torch.equal(depth, main["depth"]):
        raise AssertionError("seq_kmer_depth through the sharded lookup "
                             "differs")
    merges = sharded_merges(st)
    if (launches[1] < len(batches) or launches[2] != merges or merges < 1
            or launches[0] < 1):
        raise AssertionError(f"the sharded path launched B1 {launches[0]}, "
                             f"B2 {launches[1]} and B3 {launches[2]} times; "
                             f"its shards merged two runs {merges} times")
    tm = st.shard_timings()
    log(f"[main] sharded: {len(batches)} batches x {ROWS:,} reads through "
        f"ShardedCountStore({k}, make_mesh({SHARDS})), hybrid "
        f"({stats.get('flagged_reads', 0):,} reads re-counted in f64): "
        f"shards of {', '.join(f'{n:,}' for n in st.n_unique)} distinct; "
        f"their union equals the single store's {single.n_unique:,}-row "
        f"table bitwise, each shard holds only keys whose owner_hash is "
        f"its own; spectrum(255), total_added and the depth track over "
        f"{DEPTH_LEN:,} bases equal; {wall:.3f} s; {st.timings['routes']} "
        f"routings; B1 launches {launches[0]}, B2 {launches[1]}, B3 "
        f"{launches[2]} = {tm['tier_merges']} tier merges + "
        f"{tm['fold_merges']} two-run folds over the shards")
    return launches, {"store": st, "wall": wall}


def phase_main_sharded_file(fq: Path, n_reads: int, staged, n_all: int,
                            single_wall: float, card: str) -> None:
    """count_kmers_fq_sh_rp(fq, mesh=make_mesh(8)) on the command-line
    phase's FASTQ file: the same shard tables as the staged sharded store
    (or, where the file holds fewer reads, the same table as one store of
    the file)."""
    from kmer_hasher_tpu_torch import api
    from kmer_hasher_tpu_torch.parallel import make_mesh

    k = K_COUNT
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = api.count_kmers_fq_sh_rp(str(fq), k=k, min_q=MIN_Q,
                                  exact_ll="hybrid", mesh=make_mesh(SHARDS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    if st.timings["reader"] != "native":
        raise AssertionError(f"the sharded file entry read through "
                             f"{st.timings['reader']}")
    if n_reads == n_all:
        ok, what = same_shards(st, staged), "the staged sharded store"
    else:
        ok = sharded_union_is(st, api.count_kmers_fq_sh_rp(
            str(fq), k=k, min_q=MIN_Q, exact_ll="hybrid"))
        what = "one store of the same file"
    if not ok or launches[2] != sharded_merges(st):
        raise AssertionError(f"the sharded file entry differs from {what}, "
                             f"or launched B3 {launches[2]} times")
    tm = st.timings
    log(f"[main] sharded: count_kmers_fq_sh_rp(mesh=make_mesh({SHARDS})) of "
        f"{n_reads:,} reads ({fq.stat().st_size / 1e6:.1f} MB FASTQ, "
        f"native reader) equals {what}, shard by shard; {wall:.3f} s = "
        f"{n_reads / wall:,.0f} reads/s (one store: {single_wall:.3f} s); "
        f"parser busy {tm['parse_s']:.3f} s, waiting {tm['wait_s']:.3f} s, "
        f"routing {tm['route_s']:.3f} s; B2 launches {launches[1]}, B3 "
        f"{launches[2]} | {card}")
    return st, wall


# -- the shard group over several devices of one process ----------------------

MD_BATCHES = 8  # the counting cell's first batches through the mixed group
MD_MIXED = ("cuda:0", "cpu")  # crosses devices on a one-card machine
# the index builds a device of the group's takes part in: the mixed group's
# 2^22-base prefix, and the 40,000,000-base index over every card (2, 4 or
# 8 of them, as many as divide 8)
MD_PARTS = (2, 4, 8)
MD_SPREADS = tuple((m, n) for n in (PREFIX, SEQ_LEN) for m in MD_PARTS)
# the group over processes and devices: PD_P gloo ranks of PD_M devices
# each, sharing the card; the repeated layout runs the full cells, the
# mixed one the cut of the multidevice phase (MD_BATCHES, PREFIX)
PD_P, PD_M = 2, 2
PD_LAYOUTS = {"repeated": ("cuda:0", "cuda:0"), "mixed": ("cuda:0", "cpu")}
PD_FILE_ROWS, PD_FILE_L = 32_768, 152  # the file entry's batches
PD_CUT_LAST = MD_BATCHES * ROWS % PD_FILE_ROWS  # the cut file's last batch


def spread_wrappers():
    """B1, B2 and B3, the kernels of the spread group's path, whose wrappers
    count their launches per card in ``by_device``."""
    return counted_wrappers()[:3]


def reset_by_device() -> None:
    for w in spread_wrappers():
        w.by_device = {}


def read_by_device() -> list:
    """[B1, B2, B3] launches per card index since the last reset."""
    return [dict(w.by_device) for w in spread_wrappers()]


def same_store_shards(a, b) -> bool:
    a.flush()
    b.flush()
    return all(torch.equal(x.keys.cpu(), y.keys.cpu())
               and torch.equal(x.cnt.cpu(), y.cnt.cpu())
               for x, y in zip(a.shards, b.shards)) and bool(
                   (a.total_added == b.total_added).all())


def same_index_on(a, b) -> bool:
    """Two sharded indexes' hash shards, bitwise, wherever they live."""
    return all(torch.equal(x.s_key.cpu(), y.s_key.cpu())
               and torch.equal(x.s_pos.cpu(), y.s_pos.cpu())
               for x, y in zip(a.shards, b.shards))


def spread_path(mesh, batches, seq, query):
    """The path through one shard group: the batches counted by the file
    entry's loop into ShardedCountStore(21, mesh), hybrid; the k=32 index
    of ``seq`` with tables(2|4|8), the full pair drain among them; the k=21
    index and
    seq_kmer_pos of ``query``. Returns its outputs and its wall."""
    from kmer_hasher_tpu_torch import counting
    from kmer_hasher_tpu_torch.parallel import (ShardedCountStore,
                                                ShardedKmerIndex)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = ShardedCountStore(K_COUNT, mesh)
    counting.count_batches(st, batches, K_COUNT, min_q=MIN_Q,
                           exact_ll="hybrid")
    torch.cuda.synchronize()
    t_count = time.perf_counter() - t0
    ix = ShardedKmerIndex(seq, 32, mesh)
    tabs = ix.tables(2 | 4 | 8)  # 4: the full pair drain
    ix21 = ShardedKmerIndex(seq, 21, mesh)
    rows = ix21.seq_kmer_pos(query, 21)
    torch.cuda.synchronize()
    return {"store": st, "index": ix, "tabs": tabs, "rows": rows, "count_s": t_count,
            "wall": time.perf_counter() - t0,
            "bytes": sum(x.timings.get(key, 0) for x in (st, ix, ix21)
                         for key in ("exchange_bytes", "gather_bytes"))}


def spread_equal(got: dict, want: dict) -> bool:
    return (same_store_shards(got["store"], want["store"])
            and same_index_on(got["index"], want["index"])
            and all(torch.equal(got["tabs"][f].cpu(), want["tabs"][f].cpu())
                    for f in ("pos", "pair.pos", "count"))
            and torch.equal(got["rows"].cpu(), want["rows"].cpu()))


def phase_main_multidevice(seq: np.ndarray, batches, card: str):
    """The shard group over several devices of one process, through the
    entries a user calls: the counting cell's first 8 batches and the index
    cell's first 2^22 bases (k=32 tables(2|8) and full drain, the k=21
    query) through make_mesh(8, devices=["cuda:0", "cpu"]), 4 shards on
    the card and 4 in host memory, each output bitwise the logical 8-shard
    group's on the card (run first, not counted). Launches counted (path
    multidevice) and per card: B1 and B2 on the card's half, B3 as often
    as the card's shards merged two runs. With two or more cards, the full
    counting cell and the 40,000,000-base index through every card (as many
    as divide 8), in turns with the logical group, with each card's peak
    memory; with one, a line that says so. Then dryrun_multichip on the
    visible cards and on the mixed group."""
    from kmer_hasher_tpu_torch.multichip import dryrun_multichip
    from kmer_hasher_tpu_torch.parallel import make_mesh

    prefix = seq[:PREFIX]
    query = seq[QUERY_AT: QUERY_AT + QUERY_LEN]
    head = batches[:MD_BATCHES]
    logical = spread_path(make_mesh(SHARDS), head, prefix, query)
    reset_launches()
    reset_by_device()
    torch.cuda.reset_peak_memory_stats(0)
    mixed = spread_path(make_mesh(SHARDS, devices=list(MD_MIXED)), head,
                        prefix, query)
    launches = read_launches("multidevice")
    per_card = read_by_device()
    peak = torch.cuda.max_memory_allocated(0)
    st = mixed["store"]
    kinds = [s.keys.device.type for s in st.shards]
    if kinds != [torch.device(d).type for d in MD_MIXED
                 for _ in range(SHARDS // len(MD_MIXED))]:
        raise AssertionError(f"the mixed group's shards lie on {kinds}")
    if not spread_equal(mixed, logical):
        raise AssertionError("the group over cuda:0 and cpu differs from the "
                             "logical 8-shard group")
    merges = sum(s.timings["tier_merges"] + s.timings["fold_merges"]
                 for s in st.shards[: SHARDS // 2])
    b1, b2, b3 = (c.get(0, 0) for c in per_card)
    if (b1 < 3 or b2 < MD_BATCHES or b3 != merges or merges < 1
            or launches[:3] != (b1, b2, b3) or mixed["bytes"] <= 0):
        raise AssertionError(
            f"the mixed group launched B1 / B2 / B3 {launches[:3]} times, on "
            f"card 0 {b1} / {b2} / {b3}; its card shards merged two runs "
            f"{merges} times; {mixed['bytes']} bytes crossed devices")
    log(f"[main] multidevice: make_mesh({SHARDS}, devices={list(MD_MIXED)}) "
        f"(shards 0-3 on the card, 4-7 in host memory): {MD_BATCHES} "
        f"batches x {ROWS:,} reads, hybrid, shards of "
        f"{', '.join(f'{n:,}' for n in st.n_unique)} distinct; the k=32 "
        f"index of {PREFIX:,} bases, tables(2|4|8) with its "
        f"{mixed['tabs']['pair.pos'].shape[0]:,}-row pair drain; the k=21 query, {mixed['rows'].shape[0]:,} rows: all "
        f"bitwise the logical 8-shard group's on the card; {mixed['wall']:.3f} "
        f"s (counting {mixed['count_s']:.3f} s), logical "
        f"{logical['wall']:.3f} s (counting {logical['count_s']:.3f} s); "
        f"card 0 peak {peak / 2 ** 30:.2f} GiB | {card}")
    log(f"[main] multidevice: launches per card (the CPU half runs the "
        f"plain versions): B1 {per_card[0]}, B2 {per_card[1]}, B3 "
        f"{per_card[2]} = the card shards' {merges} two-run merges; "
        f"{mixed['bytes']:,} bytes crossed devices (exchanges and gathers)")
    n = torch.cuda.device_count()
    m = max(c for c in (1, 2, 4, 8) if c <= n)
    out = {"mixed": {"devices": list(MD_MIXED), "batches": MD_BATCHES,
                     "index_bases": PREFIX, "wall_s": mixed["wall"],
                     "logical_wall_s": logical["wall"],
                     "count_s": mixed["count_s"],
                     "logical_count_s": logical["count_s"],
                     "launches_by_card": per_card,
                     "bytes_crossed": mixed["bytes"],
                     "card0_peak_bytes": peak},
           "visible_cards": n}
    del mixed, logical
    if m >= 2:
        out["all_cards"] = phase_all_cards(seq, batches, query, m, card)
    else:
        log(f"[main] multidevice: the all-cards form (8 shards over every "
            f"card) was not run: {n} card visible, and a spread over cards "
            f"needs two or more; no copy from card to card ran")
        out["all_cards"] = None
    cards = [f"cuda:{i}" for i in range(m)]
    out["dryrun"] = [dryrun_multichip(SHARDS, devices=d)
                     for d in (cards, list(MD_MIXED))]
    log(f"[main] multidevice: dryrun_multichip({SHARDS}) on {cards} and on "
        f"{list(MD_MIXED)}: {out['dryrun'][0]['line']}")
    return launches, out


def phase_all_cards(seq: np.ndarray, batches, query, m: int, card: str):
    """The full counting cell and the 40,000,000-base index through 8
    shards over ``m`` cards, in turns with the logical group on card 0
    (logical, spread, logical, spread), each card's peak memory per turn;
    the spread outputs bitwise the logical's, B1 / B2 / B3 launched on
    every card."""
    from kmer_hasher_tpu_torch.parallel import make_mesh

    cards = [f"cuda:{i}" for i in range(m)]
    walls = {"logical": [], "spread": []}
    peaks = {"logical": [], "spread": []}
    for turn in range(2):
        for name, mesh in (("logical", make_mesh(SHARDS)),
                           ("spread", make_mesh(SHARDS, devices=cards))):
            for i in range(m):
                torch.cuda.reset_peak_memory_stats(i)
            reset_by_device()
            got = spread_path(mesh, batches, seq, query)
            walls[name].append(got["wall"])
            peaks[name].append([torch.cuda.max_memory_allocated(i)
                                for i in range(m)])
            if name == "logical":
                want = got
                continue
            per_card = read_by_device()
            if not spread_equal(got, want):
                raise AssertionError(f"the group over {cards} differs from "
                                     f"the logical group")
            if not all(c.get(i, 0) >= 1 for c in per_card for i in range(m)):
                raise AssertionError(f"a card launched no B1 / B2 / B3: "
                                     f"{per_card}")
            log(f"[main] multidevice: all cards, turn {turn}: "
                f"{len(batches)} batches and {len(seq):,} bases through "
                f"make_mesh({SHARDS}, devices={cards}) equal the logical "
                f"group; wall {got['wall']:.3f} s (logical "
                f"{want['wall']:.3f} s); peak GiB per card "
                f"{[round(b / 2 ** 30, 2) for b in peaks['spread'][-1]]} "
                f"(logical {[round(b / 2 ** 30, 2) for b in peaks['logical'][-1]]}); "
                f"launches per card B1 {per_card[0]}, B2 {per_card[1]}, B3 "
                f"{per_card[2]}; {got['bytes']:,} bytes crossed | {card}")
            del got, want
    return {"cards": cards, "walls_s": walls, "peak_bytes": peaks}


# -- the sharded count store over several processes ----------------------------

PROCS_TIMEOUT = 300  # seconds one spawn of ranks may take
PROCS_CKPT_EVERY = 32_768  # route (c): one checkpoint a batch, and the last


def rank_worker(spec_path: str, rank: int) -> None:
    """One gloo rank of ``phase_main_sharded_procs`` (``chip_smoke.py
    --rank SPEC RANK``): counts its route through count_kmers_fq_sh_rp on
    a group over the processes, on the card, with the kernels' launches
    counted from 0; writes its own shards' tables and prints one JSON
    line."""
    from kmer_hasher_tpu_torch import api
    from kmer_hasher_tpu_torch.parallel import make_mesh

    from kmer_hasher_tpu_torch import counting

    spec = json.loads(Path(spec_path).read_text())
    if spec.get("kind") == "index":
        return index_rank_worker(spec, rank)
    if spec.get("kind") == "procs_devices":
        return pd_rank_worker(spec, rank)
    info = api.init_distributed(spec["rdzv"], world_size=spec["P"],
                                rank=rank)
    mesh = make_mesh(SHARDS, distributed=True)
    alone = None
    if spec.get("parse_alone"):  # route (b): this rank's range, parse only
        size = os.path.getsize(spec["path"])
        rng = (size * rank // spec["P"], size * (rank + 1) // spec["P"])
        got: dict = {}
        mesh.barrier()
        t0 = time.perf_counter()
        n = sum(len(b[2]) for b in counting._iter_file_batches(
            spec["path"], None, 0, counting._rows_per_rank(None, mesh), got,
            byte_range=rng))
        alone = {"wall": time.perf_counter() - t0,
                 "parse_s": got["parse_s"], "reads": n}
    kw = {}
    if spec.get("ckpt"):
        kw = dict(checkpoint_every=PROCS_CKPT_EVERY,
                  checkpoint_path=spec["ckpt"])
    reset_launches()
    torch.cuda.synchronize()
    mesh.barrier()
    t0 = time.perf_counter()
    st = api.count_kmers_fq_sh_rp(spec["path"], k=K_COUNT, min_q=MIN_Q,
                                  exact_ll="hybrid", mesh=mesh, **kw)
    torch.cuda.synchronize()
    mesh.barrier()
    wall = time.perf_counter() - t0
    from kmer_hasher_tpu_torch.ops import cuda_encode as b1
    from kmer_hasher_tpu_torch.ops import cuda_merge as b3

    launches = read_launches()
    rec = {"rank": rank, "info": info, "wall": wall, "parse_alone": alone,
           "shard_timings": st.shard_timings(),
           "device": str(st.device), "launches": list(launches),
           "b3_rows": b3.merge.rows, "b1_positions": b1.encode.positions,
           "timings": {k: v for k, v in st.timings.items()
                       if not isinstance(v, str)},
           "reader": st.timings["reader"],
           "merges": sharded_merges(st),
           "spectrum": st.spectrum(255).tolist(),
           "total_added": st.total_added.tolist(),
           "n_unique": st.n_unique.tolist()}
    np.savez(Path(spec["out"]) / f"r{rank}.npz", **{
        f"{c}{d}": t.cpu().numpy()
        for d, s in zip(mesh.local_shards, st.shards)
        for c, t in (("k", s.keys), ("c", s.cnt))})
    mesh.barrier()
    print(json.dumps(rec), flush=True)


def spawn_ranks(P: int, path, tmp: Path, name: str, ckpt=None,
                parse_alone: bool = False, extra: dict = None) -> list:
    """P ranks of this script on the card over gloo (``--rank``); every
    rank must exit 0 within PROCS_TIMEOUT, else every rank is killed and
    this raises. ``extra`` goes into the ranks' spec as it is. Returns
    (each rank's record, its tables' file, the seconds from the spawn to
    the last exit)."""
    out = tmp / f"procs_{name}"
    out.mkdir()
    spec = out / "spec.json"
    spec.write_text(json.dumps({
        "P": P, "path": [str(p) for p in path] if isinstance(path, list)
        else str(path), "out": str(out), "ckpt": ckpt and str(ckpt),
        "parse_alone": parse_alone,
        "rdzv": f"file://{out / 'rendezvous'}", **(extra or {})}))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--rank", str(spec),
         str(r)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(P)]
    res = []
    try:
        for p in procs:
            res.append(p.communicate(timeout=PROCS_TIMEOUT))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError(f"ranks {name}: the {P} ranks did not finish "
                             f"in {PROCS_TIMEOUT} s")
    secs = time.perf_counter() - t0
    bad = [f"rank {r} exited with {p.returncode}:\n{o[-1000:]}\n{e[-3000:]}"
           for r, (p, (o, e)) in enumerate(zip(procs, res))
           if p.returncode != 0]
    if bad:
        raise AssertionError(f"ranks {name}: " + "\n".join(bad))
    recs = [json.loads(o.strip().splitlines()[-1]) for o, _e in res]
    return [(rec, out / f"r{rec['rank']}.npz") for rec in recs], secs


def procs_tables_equal(ranks, single) -> bool:
    """Every rank's shards equal the one-process store's, bitwise, and the
    ranks cover the D shards once."""
    seen = []
    for _rec, f in ranks:
        with np.load(f) as z:
            for name in z.files:
                if name[0] != "k":
                    continue
                d = int(name[1:])
                seen.append(d)
                s = single.shards[d]
                if not (np.array_equal(z[name], s.keys.cpu().numpy())
                        and np.array_equal(z[f"c{d}"], s.cnt.cpu().numpy())):
                    return False
    return sorted(seen) == list(range(single.n_shards))


def phase_main_sharded_procs(fq: Path, fq50: Path, single_big, single_wall,
                             tmp: Path, card: str):
    """The sharded count store over several processes: gloo ranks of this
    script, each on the card (``device="cuda"``), through
    count_kmers_fq_sh_rp(mesh=make_mesh(8, distributed=True)), hybrid, k=21:
    route (b) on 2 ranks over the command-line phase's FASTQ (each rank
    parses its byte range), route (a) on 4 ranks over the 50,000-read file
    cut into 4 gzip files, route (c) on 2 ranks over the 50,000-read file
    with checkpoint_every. Each against the one-process 8-shard store on
    the card, timed in turns around it where it is not the file phase's:
    every rank's shards bitwise, the spectrum and total_added as every rank
    reads them, and for (c) the checkpoint reloaded onto 8 shards. B2 and
    B3 must have launched in every rank (path sharded_procs, counted in the
    ranks from 0 and summed)."""
    import gzip

    from kmer_hasher_tpu_torch import api, counting
    from kmer_hasher_tpu_torch.parallel import make_mesh
    from kmer_hasher_tpu_torch.utils import checkpoint

    def one(path):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = api.count_kmers_fq_sh_rp(
            [str(p) for p in path] if isinstance(path, list) else str(path),
            k=K_COUNT, min_q=MIN_Q, exact_ll="hybrid",
            mesh=make_mesh(SHARDS))
        torch.cuda.synchronize()
        return st, time.perf_counter() - t0

    lines = fq50.read_bytes().splitlines(keepends=True)
    parts = []
    for i in range(4):
        part = tmp / f"reads50k.{i}.fq.gz"
        part.write_bytes(gzip.compress(b"".join(
            lines[4 * (i * FILE_READS // 4):4 * ((i + 1) * FILE_READS // 4)]),
            compresslevel=1))
        parts.append(part)
    # the parser alone in this process over the whole file and over its
    # first half at a rank's batch size, for route (b)'s ranks, which each
    # parse their half alone (both at once) before they count
    parse_one = []
    for rows, rng in ((None, None), (-(-counting._batch_rows(None) // 2),
                                     (0, fq.stat().st_size // 2))):
        got: dict = {}
        t0 = time.perf_counter()
        for _b in counting._iter_file_batches(str(fq), None, 0, rows, got,
                                              byte_range=rng):
            pass
        parse_one.append(time.perf_counter() - t0)
    ck = tmp / "procs_ckpt.npz"
    runs = (("b", 2, fq, None), ("a", 4, parts, None), ("c", 2, fq50, ck))
    total = [0] * len(counted_wrappers())
    b3_rows = b1_positions = 0
    summary = {}
    for route, P, path, ckpt in runs:
        if route == "b":
            single, before = single_big, single_wall
        else:
            single, before = one(path)
        ranks, spawn_s = spawn_ranks(P, path, tmp, route, ckpt,
                                     parse_alone=route == "b")
        after = one(path)[1]
        recs = [r for r, _f in ranks]
        want_spec = single.spectrum(255).tolist()
        want_total = single.total_added.tolist()
        if not procs_tables_equal(ranks, single):
            raise AssertionError(f"sharded_procs route ({route}): the ranks' "
                                 f"shards differ from the one-process store")
        for rec in recs:
            if (rec["spectrum"] != want_spec
                    or rec["total_added"] != want_total
                    or rec["n_unique"] != single.n_unique.tolist()
                    or rec["device"].split(":")[0] != "cuda"
                    or rec["reader"] != "native"):
                raise AssertionError(
                    f"sharded_procs route ({route}), rank {rec['rank']}: "
                    f"spectrum, total_added, n_unique, device or reader "
                    f"differ ({rec['device']}, {rec['reader']})")
            n = rec["launches"]
            if n[1] < 1 or n[2] < 1 or n[2] != rec["merges"]:
                raise AssertionError(
                    f"sharded_procs route ({route}), rank {rec['rank']}: B2 "
                    f"launched {n[1]} and B3 {n[2]} times; its shards merged "
                    f"two runs {rec['merges']} times")
            total = [a + b for a, b in zip(total, n)]
            b3_rows += rec["b3_rows"]
            b1_positions += rec["b1_positions"]
        if ckpt is not None:
            back = checkpoint.load_count_store(ckpt, mesh=make_mesh(SHARDS))
            prog = checkpoint.load_progress(ckpt)
            if not (same_shards(back, single) and prog["done"]
                    and prog["reads_done"] == FILE_READS):
                raise AssertionError(f"sharded_procs route (c): the "
                                     f"checkpoint reloaded differs ({prog})")
        wall = max(r["wall"] for r in recs)
        summary[route] = {"P": P, "wall": wall, "spawn_s": spawn_s,
                          "one_process_s": [before, after],
                          "ranks": [{key: r["timings"].get(key, 0) for key in (
                              "parse_s", "exchange_s", "exchange_bytes",
                              "exchanges", "file_reads", "wait_s", "copy_s",
                              "route_s")}
                              | {"b2": r["launches"][1],
                                 "b3": r["launches"][2],
                                 "tier_merge_s":
                                     r["shard_timings"]["tier_merge_s"],
                                 "parse_alone": r["parse_alone"]}
                              for r in recs]}
        if route == "b":
            summary[route]["parse_one_process"] = parse_one
        what = {"b": f"{fq.stat().st_size / 1e6:.1f} MB FASTQ cut in byte "
                     f"ranges",
                "a": f"{FILE_READS:,} reads in 4 gzip files dealt to the "
                     f"ranks",
                "c": f"the {FILE_READS:,}-read FASTQ in lockstep, "
                     f"checkpoint every {PROCS_CKPT_EVERY:,} reads, reloaded "
                     f"onto 8 shards equal"}[route]
        log(f"[main] sharded_procs: route ({route}), {P} gloo ranks on the "
            f"card, 8 shards, {what}: every rank's shards, spectrum(255) and "
            f"total_added equal the one-process store's; wall {wall:.3f} s "
            f"(slowest rank, count only; spawn to exit {spawn_s:.1f} s); "
            f"one process, 8 shards, in turns: {before:.3f} s before, "
            f"{after:.3f} s after; "
            + ("" if route != "b" else
               f"the parser alone in one process: the whole file "
               f"{parse_one[0]:.3f} s, its first half {parse_one[1]:.3f} s; ")
            + "; ".join(
                f"rank {r['rank']}: parse {r['timings'].get('parse_s', 0):.3f}"
                f" s, waiting {r['timings'].get('wait_s', 0):.3f} s, "
                f"{r['timings']['file_reads']:,} reads, exchange "
                f"{r['timings']['exchange_s']:.3f} s / "
                f"{r['timings']['exchange_bytes'] / 1e6:.1f} MB over "
                f"{r['timings']['exchanges']} exchanges, routing "
                f"{r['timings']['route_s']:.3f} s, tier merges "
                f"{r['shard_timings']['tier_merge_s']:.3f} s, B2 "
                f"{r['launches'][1]}, B3 {r['launches'][2]}"
                + ("" if r["parse_alone"] is None else
                   f", its range parsed alone first {r['parse_alone']['wall']:.3f}"
                   f" s") for r in recs)
            + f" | {card}")
    B3_ROWS["sharded_procs"] = b3_rows
    B1_POSITIONS["sharded_procs"] = b1_positions
    return tuple(total), summary


# the sharded index over processes: (ranks, bases) of each spawn. 2^22 + 1
# bases make chunks of 2^20 whose fifth holds one base, so ranks 2 and 3
# of 4 encode no window
IX_PROCS = ((2, SEQ_LEN), (4, PREFIX + 1))
IX_BUILDS, IX_QUERIES = 3, 1  # B1 launches a rank: k=32, k=21, query


class Digest:
    """sha256 of tensors' bytes in the order given, however they are cut
    into chunks, with the rows counted."""

    def __init__(self):
        self.h, self.rows = hashlib.sha256(), 0

    def add(self, t: torch.Tensor) -> "Digest":
        self.h.update(t.detach().cpu().contiguous().numpy().tobytes())
        self.rows += int(t.shape[0])
        return self

    def value(self) -> str:
        return f"{self.rows}:{self.h.hexdigest()[:32]}"


def digest(*tensors) -> str:
    d = Digest()
    for t in tensors:
        d.add(t)
    return d.value()


def shard_digests(shards) -> list:
    return [digest(s.s_key, s.s_pos) for s in shards]


def index_rank_worker(spec: dict, rank: int) -> None:
    """One gloo rank of ``phase_main_sharded_index_procs`` (``chip_smoke.py
    --rank SPEC RANK`` with ``"kind": "index"``): the index cell's path
    through ShardedKmerIndex on make_mesh(8, distributed=True) on the card,
    each step timed between barriers, every output digested, launches
    counted from 0; prints one JSON line."""
    from kmer_hasher_tpu_torch import api
    from kmer_hasher_tpu_torch.parallel import (ShardedKmerIndex,
                                                kmer_pairs_sharded, make_mesh)
    from kmer_hasher_tpu_torch.ops import cuda_encode as b1
    from kmer_hasher_tpu_torch.ops import cuda_merge as b3

    info = api.init_distributed(spec["rdzv"], world_size=spec["P"],
                                rank=rank)
    seq = np.load(spec["seq"])
    q = torch.from_numpy(np.load(spec["q"])).cuda()
    query = seq[QUERY_AT: QUERY_AT + QUERY_LEN]
    mesh = make_mesh(SHARDS, distributed=True)
    walls, dig = {}, {}

    def step(name, fn):
        return timed(walls, name, fn, mesh)

    reset_launches()
    sh = step("build", lambda: ShardedKmerIndex(seq, 32, mesh))
    step("range_partition", sh._range_partitioned)

    def tables_and_drain():
        tabs = sh.tables(2 | 8)
        pairs = Digest()
        for chunk in sh.iter_pair_chunks():
            pairs.add(chunk)
        return tabs, pairs

    tabs, pairs = step("tables_drain", tables_and_drain)
    dig.update(pos=digest(tabs["pos"]), count=digest(tabs["count"]),
               pairs=pairs.value(), hash_shards=shard_digests(sh.shards),
               range_shards=shard_digests(sh._range_partitioned()))
    del tabs
    dig["lookup"] = digest(step("lookups", lambda: sh.lookup_counts(q)))
    dig["positions"] = digest(step("positions", lambda: sh.positions_of(q)))
    timings = {"k32": dict(sh.timings)}
    n_valid, device = sh.n_valid.tolist(), str(sh.device)
    sh.drop_range_partition()
    del sh
    sh21 = step("build_k21", lambda: ShardedKmerIndex(seq, 21, mesh))
    rows = Digest()
    for blk in step("seq_kmer_pos", lambda: list(
            sh21.iter_seq_kmer_pos(query, 21))):
        rows.add(blk)
    dig["seq_kmer_pos"] = rows.value()
    shq = ShardedKmerIndex(query, 21, mesh)
    dig["kmer_pairs"] = digest(step("kmer_pairs", lambda: kmer_pairs_sharded(
        sh21, shq)))
    timings.update(k21=dict(sh21.timings), query=dict(shq.timings))
    del sh21, shq
    launches = read_launches()
    rec = {"rank": rank, "info": info, "local": list(mesh.local_shards),
           "device": device, "n_valid": n_valid, "walls": walls,
           "digests": dig, "launches": list(launches),
           "b3_rows": b3.merge.rows, "b1_positions": b1.encode.positions,
           "timings": timings}
    mesh.barrier()
    print(json.dumps(rec), flush=True)


def timed(walls: dict, name: str, fn, mesh=None):
    """``fn()``, its seconds from a synchronised card (and, with ``mesh``,
    a barrier of its ranks) to its work's end into ``walls[name]``."""
    torch.cuda.synchronize()
    if mesh is not None:
        mesh.barrier()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    walls[name] = time.perf_counter() - t0
    return out


def one_process_index(seq: np.ndarray) -> tuple:
    """The one-process 8-shard index of ``seq`` on the card and its walls:
    build, range partition, tables(2|8) + drain."""
    from kmer_hasher_tpu_torch.parallel import ShardedKmerIndex, make_mesh

    walls = {}
    sh = timed(walls, "build", lambda: ShardedKmerIndex(seq, 32,
                                                        make_mesh(SHARDS)))
    timed(walls, "range_partition", sh._range_partitioned)
    timed(walls, "tables_drain", lambda: (sh.tables(2 | 8), sum(
        c.shape[0] for c in sh.iter_pair_chunks())))
    return sh, walls


def index_answers(seq: np.ndarray, tmp: Path) -> tuple:
    """The answers the ranks are held to: the single KmerIndex's tables,
    pair drain, lookups of SH_LOOKUPS sampled keys (written for the ranks
    with the sequence), k=21 query rows and cross-index pairs, digested.
    Returns (the digests, the ranks' input files)."""
    from kmer_hasher_tpu_torch import api
    from kmer_hasher_tpu_torch.index.query import kmer_pairs
    from kmer_hasher_tpu_torch.ops import encode as enc

    query = seq[QUERY_AT: QUERY_AT + QUERY_LEN]
    one = api.make_kmer_hash(seq, 32, device="cuda")
    tabs = api.kmer_pos(one, 2 | 8)
    pairs = Digest()
    for chunk in one.iter_pair_chunks():
        pairs.add(chunk)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 12)
    pick = torch.randint(0, one.n_valid, (SH_LOOKUPS,), generator=gen,
                         device="cuda")
    q = torch.unique(enc.sortable_key(one.s_key[pick]))
    lb, ub = one.lookup_range(q)
    hits = ub - lb
    g = torch.arange(int(hits.sum()), device="cuda")
    cum = torch.cumsum(hits, 0)
    w = torch.searchsorted(cum, g, right=True)
    positions = torch.sort(one.s_pos[lb[w] + g - (cum[w] - hits[w])]).values
    want = {"pos": digest(tabs["pos"]), "count": digest(tabs["count"]),
            "pairs": pairs.value(), "lookup": digest(hits.to(torch.int32)),
            "positions": digest(positions)}
    del one, tabs
    one21 = api.make_kmer_hash(seq, 21, device="cuda")
    want["seq_kmer_pos"] = digest(api.seq_kmer_pos(one21, query, 21))
    want["kmer_pairs"] = digest(kmer_pairs(one21, api.make_kmer_hash(
        query, 21, device="cuda")))
    del one21
    files = {"seq": str(tmp / f"ix_seq_{seq.shape[0]}.npy"),
             "q": str(tmp / f"ix_q_{seq.shape[0]}.npy")}
    np.save(files["seq"], seq)
    np.save(files["q"], q.cpu().numpy())
    return want, files


def phase_main_sharded_index_procs(seq: np.ndarray, card: str):
    """The sharded position index over several processes: gloo ranks of
    this script sharing the card (``--rank`` with ``"kind": "index"``), each
    through ShardedKmerIndex(seq, 32, make_mesh(8, distributed=True)),
    tables(2|8) and the full pair drain, lookup_counts and positions_of of
    4,096 sampled keys, a k=21 index with seq_kmer_pos of the
    1,000,000-base query and kmer_pairs_sharded against a sharded index of
    the query stretch: 2 ranks on the index cell's 40,000,000 bases (chunks
    0-4 hold windows: rank 0's four chunks 33,554,432 bases, rank 1's
    6,445,568), then 4 ranks on 2^22 + 1 bases (ranks 2 and 3 encode
    none). Every rank's digests must equal the single KmerIndex's,
    computed here, and
    its hash and range shards the one-process 8-shard index's, which is
    timed before and after the ranks. B1 launches once a build and once a
    query on every rank, B3 never (path sharded_index_procs, counted in the
    ranks from 0 and summed)."""
    total = [0] * len(counted_wrappers())
    b3_rows = b1_positions = 0
    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        for P, n in IX_PROCS:
            part = seq[:n]
            want, files = index_answers(part, Path(tmp))
            sh, before = one_process_index(part)
            want_hash = shard_digests(sh.shards)
            want_range = shard_digests(sh._range_partitioned())
            want_nv = sh.n_valid.tolist()
            del sh
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            ranks, spawn_s = spawn_ranks(P, files["seq"], Path(tmp),
                                         f"index{P}", extra=dict(
                                             files, kind="index"))
            after = one_process_index(part)[1]
            torch.cuda.empty_cache()
            recs = [r for r, _f in ranks]
            seen = []
            for rec in recs:
                r, dig = rec["rank"], rec["digests"]
                bad = [key for key in want if dig[key] != want[key]]
                for i, d in enumerate(rec["local"]):
                    seen.append(d)
                    if dig["hash_shards"][i] != want_hash[d]:
                        bad.append(f"hash shard {d}")
                    if dig["range_shards"][i] != want_range[d]:
                        bad.append(f"range shard {d}")
                if rec["n_valid"] != want_nv:
                    bad.append("n_valid")
                if rec["device"].split(":")[0] != "cuda":
                    bad.append(f"device {rec['device']}")
                if bad:
                    raise AssertionError(
                        f"sharded_index_procs, {P} ranks, rank {r}: "
                        f"{', '.join(bad)} differ from the single index's")
                got = rec["launches"]
                if got[0] != IX_BUILDS + IX_QUERIES or got[2]:
                    raise AssertionError(
                        f"sharded_index_procs, {P} ranks, rank {r}: B1 "
                        f"launched {got[0]} times (want one a build, "
                        f"{IX_BUILDS}, and one a query, {IX_QUERIES}), B3 "
                        f"{got[2]} times (want none)")
                total = [a + b for a, b in zip(total, got)]
                b3_rows += rec["b3_rows"]
                b1_positions += rec["b1_positions"]
            if sorted(seen) != list(range(SHARDS)):
                raise AssertionError(f"sharded_index_procs: the {P} ranks "
                                     f"own shards {sorted(seen)}")
            slow = {key: max(r["walls"][key] for r in recs)
                    for key in recs[0]["walls"]}
            per_rank = [{
                "rank": r["rank"], "local": r["local"], "walls": r["walls"],
                "b1": r["launches"][0], "b3": r["launches"][2],
                **{f"{name}_{key}": r["timings"][name].get(key, 0)
                   for name in ("k32", "k21", "query")
                   for key in ("exchange_s", "exchange_bytes", "gather_s",
                               "gather_bytes", "exchanges", "gathers")}}
                for r in recs]
            summary[f"P{P}"] = {"bases": n, "slowest": slow,
                                "spawn_s": spawn_s,
                                "one_process": [before, after],
                                "ranks": per_rank}
            log(f"[main] sharded_index_procs: {P} gloo ranks on the card, "
                f"ShardedKmerIndex(k=32, make_mesh({SHARDS}, "
                f"distributed=True)) of {n:,} bases: every rank's tables(2|8), "
                f"pair drain ({recs[0]['digests']['pairs'].split(':')[0]} "
                f"rows), lookup_counts and positions_of of the sampled keys, "
                f"k=21 seq_kmer_pos of the {QUERY_LEN:,}-base query and "
                f"kmer_pairs_sharded against its index equal the single "
                f"index's (sha256), its hash and range shards the "
                f"one-process 8-shard index's; slowest "
                f"rank: build {slow['build']:.4f} s, range partition "
                f"{slow['range_partition']:.4f} s, tables + drain "
                f"{slow['tables_drain']:.4f} s, k=21 build "
                f"{slow['build_k21']:.4f} s, seq_kmer_pos "
                f"{slow['seq_kmer_pos']:.4f} s, kmer_pairs_sharded "
                f"{slow['kmer_pairs']:.4f} s (spawn to exit {spawn_s:.1f} s); "
                f"one process, 8 shards, in turns: build "
                f"{before['build']:.4f} / {after['build']:.4f} s, range "
                f"partition {before['range_partition']:.4f} / "
                f"{after['range_partition']:.4f} s, tables + drain "
                f"{before['tables_drain']:.4f} / {after['tables_drain']:.4f}"
                f" s (before / after); "
                + "; ".join(
                    f"rank {r['rank']} (shards {r['local'][0]}-"
                    f"{r['local'][-1]}): k=32 index exchange "
                    f"{r['k32_exchange_s']:.4f} s / "
                    f"{r['k32_exchange_bytes'] / 1e6:.1f} MB sent over "
                    f"{r['k32_exchanges']}, gather {r['k32_gather_s']:.4f} s"
                    f" / {r['k32_gather_bytes'] / 1e6:.1f} MB received over "
                    f"{r['k32_gathers']}; k=21 exchange "
                    f"{r['k21_exchange_bytes'] / 1e6:.1f} MB, gather "
                    f"{r['k21_gather_bytes'] / 1e6:.1f} MB; B1 {r['b1']}, "
                    f"B3 {r['b3']}" for r in per_rank)
                + f" | {card}")
    B3_ROWS["sharded_index_procs"] = b3_rows
    B1_POSITIONS["sharded_index_procs"] = b1_positions
    return tuple(total), summary


# -- the shard group over processes and several devices a process ------------

def pd_rank_worker(spec: dict, rank: int) -> None:
    """One gloo rank of ``phase_main_procs_devices`` (``chip_smoke.py
    --rank SPEC RANK`` with ``"kind": "procs_devices"``): on
    make_mesh(8, distributed=True, devices=spec["devices"]), the counting
    file through route (c) (KMH_HOST_SLICE=0, lockstep) and route (b)
    (byte ranges), hybrid, then the k=32 ShardedKmerIndex of the
    sequence with tables(2|8) and the full pair drain and the k=21 index
    with seq_kmer_pos of the query; each step timed between barriers and
    its launches counted from 0, in all and per card; every output
    digested, each route's shards written; prints one JSON line."""
    from kmer_hasher_tpu_torch import api
    from kmer_hasher_tpu_torch.parallel import ShardedKmerIndex, make_mesh

    info = api.init_distributed(spec["rdzv"], world_size=spec["P"],
                                rank=rank)
    torch.set_num_threads(spec["threads"])
    devices = spec["devices"]
    from kmer_hasher_tpu_torch.ops import cuda_encode as b1
    from kmer_hasher_tpu_torch.ops import cuda_merge as b3

    walls, launches, per_card, timings, rec = {}, {}, {}, {}, {}
    moved = {"b3_rows": 0, "b1_positions": 0}

    def step(name, fn, mesh):
        reset_launches()
        reset_by_device()
        out = timed(walls, name, fn, mesh)
        launches[name] = list(read_launches()[:3])
        per_card[name] = read_by_device()
        moved["b3_rows"] += b3.merge.rows
        moved["b1_positions"] += b1.encode.positions
        return out

    for route, env in (("c", "0"), ("b", "1")):
        mesh = make_mesh(SHARDS, distributed=True, devices=devices)
        before = os.environ.get("KMH_HOST_SLICE")
        os.environ["KMH_HOST_SLICE"] = env
        try:
            st = step(route, lambda: api.count_kmers_fq_sh_rp(
                spec["path"], k=K_COUNT, min_q=MIN_Q, exact_ll="hybrid",
                mesh=mesh), mesh)
        finally:
            if before is None:
                del os.environ["KMH_HOST_SLICE"]
            else:
                os.environ["KMH_HOST_SLICE"] = before
        on_card = [s for s in st.shards if s.device.type == "cuda"]
        rec[route] = {
            "spectrum": st.spectrum(255).tolist(),
            "total_added": st.total_added.tolist(),
            "n_unique": st.n_unique.tolist(),
            "placed": [[str(s.device), s.keys.device.type,
                        str(mesh.device_of(d))]
                       for d, s in zip(mesh.local_shards, st.shards)],
            "card_merges": sum(s.timings["tier_merges"]
                               + s.timings["fold_merges"] for s in on_card),
            "reads": st.timings["file_reads"]}
        timings[route] = {k: v for k, v in st.timings.items()
                          if not isinstance(v, str)}
        np.savez(Path(spec["out"]) / f"r{rank}_{route}.npz", **{
            f"{c}{d}": t.cpu().numpy()
            for d, s in zip(mesh.local_shards, st.shards)
            for c, t in (("k", s.keys), ("c", s.cnt))})
        del st
    seq = np.load(spec["seq"])
    query = seq[QUERY_AT: QUERY_AT + QUERY_LEN]
    mesh = make_mesh(SHARDS, distributed=True, devices=devices)

    def index32():
        ix = ShardedKmerIndex(seq, 32, mesh)
        tabs = ix.tables(2 | 8)
        pairs = Digest()
        for chunk in ix.iter_pair_chunks():
            pairs.add(chunk)
        return ix, tabs, pairs

    ix, tabs, pairs = step("index_k32", index32, mesh)
    rec["index"] = {
        "hash_shards": shard_digests(ix.shards),
        "range_shards": shard_digests(ix._range_partitioned()),
        "pos": digest(tabs["pos"]), "count": digest(tabs["count"]),
        "pairs": pairs.value(), "n_valid": ix.n_valid.tolist(),
        "placed": [[s.s_key.device.type, str(mesh.device_of(d))]
                   for d, s in zip(mesh.local_shards, ix.shards)]}
    timings["index_k32"] = dict(ix.timings)
    del ix, tabs
    def query21():
        ix21 = ShardedKmerIndex(seq, 21, mesh)
        rows = Digest()
        for blk in ix21.iter_seq_kmer_pos(query, 21):
            rows.add(blk)
        return ix21, rows

    ix21, rows = step("query_k21", query21, mesh)
    rec["index"]["seq_kmer_pos"] = rows.value()
    timings["query_k21"] = dict(ix21.timings)
    del ix21
    mesh.barrier()
    print(json.dumps({"rank": rank, "info": info, "local": list(
        mesh.local_shards), "devices": [str(d) for d in mesh.devices],
        "walls": walls, "launches": launches, "per_card": per_card,
        "timings": timings, **moved, **rec}), flush=True)


def pd_references(path: Path, seq: np.ndarray, store=None) -> dict:
    """What the ranks are held to: the one-process logical 8-shard group
    on the card, its store of ``path`` (``store`` where it is counted
    already; else counted here and timed) and its index of ``seq`` (the
    k=32 index's shard digests, tables(2|8) and drain, the k=21 query's
    rows; timed)."""
    from kmer_hasher_tpu_torch import api
    from kmer_hasher_tpu_torch.parallel import ShardedKmerIndex, make_mesh

    walls = {}
    if store is None:
        store = timed(walls, "count", lambda: api.count_kmers_fq_sh_rp(
            str(path), k=K_COUNT, min_q=MIN_Q, exact_ll="hybrid",
            mesh=make_mesh(SHARDS)))
    ix = timed(walls, "index_k32", lambda: ShardedKmerIndex(seq, 32,
                                                            make_mesh(SHARDS)))
    tabs = ix.tables(2 | 8)
    pairs = Digest()
    for chunk in ix.iter_pair_chunks():
        pairs.add(chunk)
    want = {"hash_shards": shard_digests(ix.shards),
            "range_shards": shard_digests(ix._range_partitioned()),
            "pos": digest(tabs["pos"]), "count": digest(tabs["count"]),
            "pairs": pairs.value(), "n_valid": ix.n_valid.tolist()}
    del ix, tabs
    ix21 = ShardedKmerIndex(seq, 21, make_mesh(SHARDS))
    want["seq_kmer_pos"] = digest(ix21.seq_kmer_pos(
        seq[QUERY_AT: QUERY_AT + QUERY_LEN], 21))
    del ix21
    torch.cuda.empty_cache()
    return {"store": store, "index": want, "walls": walls}


def phase_main_procs_devices(fq: Path, full_store, full_wall: float,
                             batches, seq: np.ndarray, tmp: Path, card: str):
    """The shard group over processes and several devices a process: PD_P
    gloo ranks of this script sharing the card (``--rank`` with ``"kind":
    "procs_devices"``), each on make_mesh(8, distributed=True,
    devices=[2 devices]), in two layouts. "repeated", ["cuda:0", "cuda:0"]
    a rank: the full cells, the counting cell's 1,900,544 reads of the
    command-line phase's FASTQ through route (c) and route (b), and the
    40,000,000-base k=32 index with tables(2|8), the drain and the k=21
    query. "mixed", ["cuda:0", "cpu"] a rank, every exchange crossing
    devices and the CPU half running the plain versions: the multidevice
    phase's cut, the first MD_BATCHES batches' reads and the first
    PREFIX bases. Each rank's shards, spectrum(255), total_added and
    n_unique equal the one-process logical 8-shard group's on the card
    (for the full file, the file phase's store, counted in ``full_wall``
    seconds), its index shards, tables,
    drain and query rows too (sha256); every shard lies on device_of(d).
    B1 launches once a card device a build and once a query, B2 on the
    card devices' blocks, B3 as often as the card shards merged two runs
    (path procs_devices, counted in the ranks from 0 and summed)."""
    total = [0] * 3
    b3_rows = b1_positions = 0
    summary = {}
    seq_path = tmp / "pd_seq.npy"
    for layout, devices in PD_LAYOUTS.items():
        if layout == "mixed":
            path, part, store = tmp / "pd_cut.fq", seq[:PREFIX], None
            write_fastq(path, batches[:MD_BATCHES], MD_BATCHES * ROWS)
        else:
            path, part, store = fq, seq, full_store
        ref = pd_references(path, part, store)
        if store is not None:
            ref["walls"]["count"] = full_wall
        np.save(seq_path, part)
        torch.cuda.synchronize()
        ranks, spawn_s = spawn_ranks(PD_P, path, tmp, f"pd_{layout}", extra={
            "kind": "procs_devices", "devices": list(devices),
            "seq": str(seq_path),
            "threads": max(1, len(os.sched_getaffinity(0)) // PD_P)})
        single = ref["store"]
        want_spec = single.spectrum(255).tolist()
        recs = [r for r, _f in ranks]
        n_card = sum(torch.device(d).type == "cuda" for d in devices)
        for rec in recs:
            r, bad = rec["rank"], []
            for route in ("c", "b"):
                got = rec[route]
                if (got["spectrum"] != want_spec
                        or got["total_added"] != single.total_added.tolist()
                        or got["n_unique"] != single.n_unique.tolist()):
                    bad.append(f"route ({route}) spectrum / total_added / "
                               f"n_unique")
                if any(own != where or kind != torch.device(where).type
                       for own, kind, where in got["placed"]):
                    bad.append(f"route ({route}) placement {got['placed']}")
                n = rec["launches"][route]
                if n[1] < n_card or n[2] != got["card_merges"]:
                    bad.append(f"route ({route}) launches B2 {n[1]}, B3 "
                               f"{n[2]} (the card shards merged two runs "
                               f"{got['card_merges']} times)")
            ix = rec["index"]
            bad += [key for key in ("pos", "count", "pairs", "n_valid",
                                    "seq_kmer_pos") if ix[key] != ref[
                                        "index"][key]]
            for i, d in enumerate(rec["local"]):
                if ix["hash_shards"][i] != ref["index"]["hash_shards"][d]:
                    bad.append(f"hash shard {d}")
                if ix["range_shards"][i] != ref["index"]["range_shards"][d]:
                    bad.append(f"range shard {d}")
            if any(kind != torch.device(where).type
                   for kind, where in ix["placed"]):
                bad.append(f"index placement {ix['placed']}")
            b1 = (rec["launches"]["index_k32"][0],
                  rec["launches"]["query_k21"][0])
            if b1 != (n_card, n_card + 1):
                bad.append(f"B1 launched {b1} times in the k=32 build and "
                           f"in the k=21 build and query, want one a card "
                           f"device a build ({n_card}) and one for the "
                           f"query on the home card")
            if bad:
                raise AssertionError(f"procs_devices, {layout}, rank {r}: "
                                     f"{'; '.join(bad)}")
            for name, n in rec["launches"].items():
                total = [a + b for a, b in zip(total, n)]
            b3_rows += rec["b3_rows"]
            b1_positions += rec["b1_positions"]
        for route in ("c", "b"):
            if not procs_tables_equal([(rec, f.parent / f"r{rec['rank']}_"
                                        f"{route}.npz") for rec, f in ranks],
                                      single):
                raise AssertionError(f"procs_devices, {layout}, route "
                                     f"({route}): the ranks' shards differ "
                                     f"from the one-process group's")
        slow = {key: max(r["walls"][key] for r in recs)
                for key in recs[0]["walls"]}
        per_rank = [{"rank": r["rank"], "devices": r["devices"],
                     "walls": r["walls"], "launches": r["launches"],
                     "per_card": r["per_card"],
                     **{f"{step}_{key}": r["timings"][step].get(key, 0)
                        for step in r["timings"]
                        for key in ("exchange_bytes", "gather_bytes",
                                    "exchange_s", "gather_s")}}
                    for r in recs]
        summary[layout] = {"devices": list(devices), "spawn_s": spawn_s,
                           "slowest": slow, "reads": recs[0]["c"]["reads"],
                           "bases": int(part.shape[0]),
                           "one_process_s": ref["walls"],
                           "ranks": per_rank}
        log(f"[main] procs_devices: {layout}, {PD_P} gloo ranks on the card, "
            f"make_mesh({SHARDS}, distributed=True, devices="
            f"{list(devices)}) a rank: {recs[0]['c']['reads']:,} reads "
            f"through route (c) (lockstep) and route (b) (byte ranges), "
            f"hybrid; the k=32 index of {part.shape[0]:,} bases, "
            f"tables(2|8) and the drain; the k=21 query: every rank's "
            f"shards, spectrum(255), total_added, n_unique, index shards, "
            f"tables, drain and query rows equal the one-process logical "
            f"8-shard group's, every shard on device_of(d); slowest rank: "
            + ", ".join(f"{k} {v:.3f} s" for k, v in slow.items())
            + f" (spawn to exit {spawn_s:.1f} s); one process, logical: "
            + ", ".join(f"{k} {v:.3f} s" for k, v in ref["walls"].items())
            + "; " + "; ".join(
                f"rank {r['rank']}: "
                + ", ".join(f"{step} exchange "
                            f"{r[f'{step}_exchange_bytes'] / 1e6:.1f} MB / "
                            f"gather {r[f'{step}_gather_bytes'] / 1e6:.1f} MB"
                            for step in ("c", "b", "index_k32", "query_k21"))
                + ", launches B1/B2/B3 per card "
                + ", ".join(f"{step} {r['per_card'][step]}"
                            for step in r["per_card"])
                for r in per_rank)
            + f" | {card}")
        del ref, single
        torch.cuda.empty_cache()
    B3_ROWS["procs_devices"] = b3_rows
    B1_POSITIONS["procs_devices"] = b1_positions
    return tuple(total) + (0,) * (len(counted_wrappers()) - 3), summary


def phase_card_vs_cpu_sharded(batches, tmp: Path) -> None:
    """8 shards on the card against 8 on the CPU: a spill budget below one
    run, to memory and to files; an 8-shard checkpoint round trip, and its
    load into one store against one CPU store of the same reads."""
    from kmer_hasher_tpu_torch import api, counting
    from kmer_hasher_tpu_torch.parallel import ShardedCountStore, make_mesh
    from kmer_hasher_tpu_torch.utils import checkpoint

    k = K_COUNT
    cut = [tuple(a[:SH_CPU_ROWS] for a in b) for b in batches[:SH_CPU_BATCHES]]
    on_cpu = [tuple(a.cpu() for a in b) for b in cut]
    ref = ShardedCountStore(k, make_mesh(SHARDS, device="cpu"))
    counting.count_batches(ref, on_cpu, k, min_q=MIN_Q, exact_ll="hybrid")
    one = api.CountStore(k, device="cpu")
    counting.count_batches(one, on_cpu, k, min_q=MIN_Q, exact_ll="hybrid")
    spills = {}
    for where, spill_dir in (("memory", None), ("files", tmp / "sh-spill")):
        st = ShardedCountStore(k, make_mesh(SHARDS), spill_bytes=SH_SPILL,
                               spill_dir=None if spill_dir is None
                               else str(spill_dir))
        counting.count_batches(st, cut, k, min_q=MIN_Q, exact_ll="hybrid")
        spills[where] = st.shard_timings()["spills"]
        if not spills[where] or not same_shards(st, ref):
            raise AssertionError(f"the sharded store spilled to {where} "
                                 f"{spills[where]} times and differs from "
                                 f"the CPU's")
        if spill_dir is not None and any(spill_dir.iterdir()):
            raise AssertionError("spill files left after the fold")
    p = tmp / "sharded.npz"
    checkpoint.save_count_store(st, p)
    back = checkpoint.load_count_store(p, mesh=make_mesh(SHARDS))
    whole = checkpoint.load_count_store(p)
    if not (same_shards(back, ref) and back.device.type == "cuda"
            and torch.equal(whole.keys.cpu(), one.keys)
            and torch.equal(whole.cnt.cpu(), one.cnt)):
        raise AssertionError("the 8-shard checkpoint round trip differs")
    log(f"[card-vs-cpu] sharded, {SH_CPU_BATCHES} batches x "
        f"{SH_CPU_ROWS:,} reads, 8 shards: spill_bytes {SH_SPILL:,} (below "
        f"one run) to memory ({spills['memory']} spills) and to files "
        f"({spills['files']}), the shard tables equal the CPU's bitwise; the "
        f"8-shard checkpoint restores onto 8 shards on the card and folds "
        f"into one store equal to one CPU store of the reads")


def phase_times_sharded(batches, card: str, sharded_wall: float) -> None:
    """The counting cell through one store and through 8 shards, in turns
    (one, shards, shards, one) in this call, with the host seconds of the
    routing and of the tier merges and the device's busy time under
    torch.profiler. No claim: the two are put side by side."""
    from kmer_hasher_tpu_torch import api, counting
    from kmer_hasher_tpu_torch.parallel import ShardedCountStore, make_mesh

    k = K_COUNT
    n_reads = len(batches) * ROWS

    def make(kind):
        return (api.CountStore(k) if kind == "one"
                else ShardedCountStore(k, make_mesh(SHARDS)))

    runs = {"one": [], "shards": []}
    for kind in ("one", "shards", "shards", "one"):
        st = make(kind)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        counting.count_batches(st, batches, k, min_q=MIN_Q, exact_ll="hybrid")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tm = st.timings if kind == "one" else dict(
            st.shard_timings(), route_s=st.timings["route_s"])
        runs[kind].append((wall, tm))
        del st
    busy = {}
    for kind in ("one", "shards"):
        def window():
            counting.count_batches(make(kind), batches, k, min_q=MIN_Q,
                                   exact_ll="hybrid")
        busy[kind] = device_busy_share(window)
    for kind, label in (("one", "one CountStore"),
                        ("shards", f"ShardedCountStore, {SHARDS} shards")):
        wall, tm = min(runs[kind], key=lambda r: r[0])
        h_wall, share = busy[kind]
        dev = ("not measured (the trace holds no device time)"
               if share is None else f"device busy {share * h_wall:.3f} s of "
               f"host {h_wall:.3f} s, idle {1 - share:.1%}")
        log(f"[times] counting cell through {label}: {wall:.3f} s = "
            f"{n_reads / wall:,.0f} reads/s (in turns: "
            f"{', '.join(f'{r[0]:.3f}' for r in runs[kind])} s"
            + ("" if kind == "one" else f"; the main path's {sharded_wall:.3f}"
               f" s") + f"); tier merges {tm['tier_merges']} taking "
            f"{tm['tier_merge_s']:.3f} s of host clock, final folds "
            f"{tm['fold_s']:.3f} s"
            + (f", routing {tm['route_s']:.3f} s" if "route_s" in tm else "")
            + f"; under torch.profiler {dev} | {card}")


# -- the user scripts and measurement entry points ---------------------------

def phase_kernels_tools() -> dict:
    """B1, B2 and B3 against their plain versions on the same CUDA tensors,
    bitwise, at the shapes the user scripts give them, on inputs their own
    generators draw: B1 on bench's 2^25 bases and large_pairs' 40 Mbp
    chromosome padded as KmerIndex pads it (k=32); B2, all three
    instantiations, on e2e_device_bench's [29,696, 152] batches of each
    quality model, hybrid_probe's [16,384, 151] batches of each model and
    counting_stress's [32,768, 152] file batch (k=21); B3 on the count
    store's two-run merges of e2e runs (one run with one, four runs' union
    with four). Returns the worst error by kernel."""
    from kmer_hasher_tpu_torch import bench
    from kmer_hasher_tpu_torch.examples import large_pairs
    from kmer_hasher_tpu_torch.ops import cuda_encode as b1
    from kmer_hasher_tpu_torch.ops import cuda_merge as b3
    from kmer_hasher_tpu_torch.ops import cuda_scan as b2
    from kmer_hasher_tpu_torch.probes import e2e_device_bench as e2e
    from kmer_hasher_tpu_torch.probes import hybrid_probe as hp
    from kmer_hasher_tpu_torch.qll import Q_TO_LL

    dev = torch.device("cuda")
    worst = {"B1": 0.0, "B2": 0.0, "B3": 0.0}
    held = []

    def hold(name, got, want, what):
        torch.cuda.synchronize()
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        worst[name] = max(worst[name], err)
        if err or len(got) != len(want):
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"{what}, max_abs_err={err}")
        held.append(f"{name} {what}")

    x = bench.make_sequence(1 << 25, dev)
    hold("B1", b1.encode(x, 32, x.shape[0]), b1.plain(x, 32, x.shape[0]),
         "bench [2^25], k=32")
    seq = large_pairs.make_sequence(40.0, 1000)
    x = torch.full((1 << (len(seq) - 1).bit_length(),), ord("N"),
                   dtype=torch.uint8, device=dev)
    x[: len(seq)] = torch.from_numpy(seq).to(dev)
    hold("B1", b1.encode(x, 32, len(seq)), b1.plain(x, 32, len(seq)),
         f"large_pairs [2^26] ({len(seq):,} bases), k=32")
    del x
    k, min_ll = K_COUNT, float(Q_TO_LL[33 + MIN_Q])
    batches = [(f"e2e [{ROWS}, 152] {q}",
                e2e.make_batches(1, ROWS, READ_LEN, quals=q)[0])
               for q in e2e.QUALS]
    rng = np.random.default_rng(0)
    batches += [(f"hybrid_probe [16384, 151] {m}",
                 hp.make_batch(rng, 16384, m)) for m in hp.MODELS]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 11)
    rows = 1 << 15
    batches.append((f"counting_stress [{rows}, 152] stress",
                    e2e.draw_batch(gen, rows, READ_LEN, "stress", dev)
                    + (torch.full((rows,), READ_LEN, dtype=torch.int32,
                                  device=dev),)))
    for what, b in batches:
        for name, kw in VARIANTS.items():
            hold("B2", b2.scan(*b[:3], k, min_ll, **kw),
                 b2.plain(*b[:3], k, min_ll, **kw), f"{what}, {name}")
    staged = e2e.make_batches(8, ROWS, READ_LEN, quals="stress")
    runs = [r[0] for r in e2e.build_runs(staged, k, "fast")]
    for what, a, b in (("one e2e run with one", runs[0], runs[1]),
                       ("four e2e runs' union with four",
                        torch.unique(torch.cat(runs[:4])),
                        torch.unique(torch.cat(runs[4:])))):
        keys = torch.cat([a, b])
        bounds = np.array([0, a.shape[0], keys.shape[0]])
        hold("B3", b3.merge(keys, None, bounds), b3.plain(keys, None, bounds),
             f"the store's two-run merge, {what} "
             f"({a.shape[0]:,} + {b.shape[0]:,} rows)")
    log(f"[kernels] at the user scripts' shapes, bitwise: "
        + "; ".join(held) + f" (max_abs_err {worst})")
    return worst


# the demo twin's directory: test.fa, test.fastq.gz and repeat_40.fq
DEMO_BASES, DEMO_READS, DEMO_READ_LEN, DEMO_REPEATS = 60_000, 2_000, 150, 40
DEMO_REPEAT_AT = 40_000  # an ACTGG stretch that 100 of the reads cover


def write_demo_data(d: Path) -> None:
    """The three files the demo reads, from SEED + 14: one 60,000-base
    record; 2,000 reads of 150 bases drawn from it with 0.5% substitutions
    at Q30-Q40, the first 100 over an ACTGG stretch in it, gzipped; 40
    ACTGG repeat reads of 200 bases at Q30-Q40."""
    import gzip

    rng = np.random.default_rng(SEED + 14)
    bases = np.frombuffer(b"ACGT", np.uint8)
    seq = bases[rng.integers(0, 4, DEMO_BASES)]
    seq[DEMO_REPEAT_AT:DEMO_REPEAT_AT + 600] = np.frombuffer(b"ACTGG" * 120,
                                                             np.uint8)
    text = seq.tobytes().decode()
    (d / "test.fa").write_text(">demo seeded\n" + "\n".join(
        text[i:i + 80] for i in range(0, DEMO_BASES, 80)) + "\n")
    recs = []
    for i in range(DEMO_READS):
        a = (DEMO_REPEAT_AT + 4 * i if i < 100
             else int(rng.integers(0, DEMO_BASES - DEMO_READ_LEN)))
        r = seq[a:a + DEMO_READ_LEN].copy()
        sub = rng.random(DEMO_READ_LEN) < 0.005
        r[sub] = bases[rng.integers(0, 4, int(sub.sum()))]
        q = rng.integers(33 + 30, 33 + 41, DEMO_READ_LEN).astype(np.uint8)
        recs.append(b"@r%d\n%s\n+\n%s\n" % (i, r.tobytes(), q.tobytes()))
    (d / "test.fastq.gz").write_bytes(gzip.compress(b"".join(recs)))
    rep = []
    for i in range(DEMO_REPEATS):
        r = (b"ACTGG" * 45)[i % 5: i % 5 + 200]
        q = rng.integers(33 + 30, 33 + 41, len(r)).astype(np.uint8)
        rep.append(b"@rep%d\n%s\n+\n%s\n" % (i, r, q.tobytes()))
    (d / "repeat_40.fq").write_bytes(b"".join(rep))


def record_calls(fn):
    """``fn()`` with every call of the B1, B2 and B3 wrappers on CUDA
    tensors recorded (the wrappers still run, and count): (its result,
    [(kernel, the inputs cloned, keywords, the outputs)])."""
    from kmer_hasher_tpu_torch.ops import cuda_encode as b1
    from kmer_hasher_tpu_torch.ops import cuda_merge as b3
    from kmer_hasher_tpu_torch.ops import cuda_scan as b2

    calls = []
    real = [(b1, "encode", "B1"), (b2, "scan", "B2"), (b3, "merge", "B3")]

    def recorder(wrapper, name):
        def call(*args, **kw):
            held = [a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args]
            out = wrapper(*args, **kw)
            if args[0].is_cuda:
                calls.append((name, held, kw, out))
            return out
        # the wrapper counts through its module's name, which now names
        # this function: share its counters
        call.__dict__ = wrapper.__dict__
        return call

    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _n in real]
    for (mod, attr, name), (_m, _a, wrapper) in zip(real, saved):
        setattr(mod, attr, recorder(wrapper, name))
    try:
        out = fn()
    finally:
        for mod, attr, wrapper in saved:
            setattr(mod, attr, wrapper)
    return out, calls


def hold_recorded(calls) -> dict:
    """Each recorded call's outputs against its kernel's plain version on
    the same inputs, bitwise. Returns the worst error by kernel and the
    calls' shapes."""
    from kmer_hasher_tpu_torch.ops import cuda_encode as b1
    from kmer_hasher_tpu_torch.ops import cuda_merge as b3
    from kmer_hasher_tpu_torch.ops import cuda_scan as b2

    worst = {"B1": 0.0, "B2": 0.0, "B3": 0.0}
    shapes = {"B1": set(), "B2": set(), "B3": set()}
    for name, args, kw, out in calls:
        if name == "B1":
            x, k, t = args
            if not np.isscalar(t):
                t = torch.as_tensor(np.asarray(t.cpu() if isinstance(
                    t, torch.Tensor) else t), device=x.device)
            want = b1.plain(x, k, t)
        elif name == "B2":
            want = b2.plain(*args, **kw)
        else:
            want = b3.plain(*args, **kw)
        torch.cuda.synchronize()
        err = max(max_abs_err(g, w) for g, w in zip(out, want)
                  if isinstance(g, torch.Tensor))
        worst[name] = max(worst[name], err)
        shapes[name].add(tuple(args[0].shape))
        if err or len(out) != len(want):
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on the demo's input {tuple(args[0].shape)}"
                                 f", max_abs_err={err}")
    return {"worst": worst, "shapes": {n: sorted(v) for n, v in
                                       shapes.items()},
            "calls": len(calls)}


def phase_main_tools(card: str):
    """The user scripts and measurement entry points at their sources'
    defaults, each a path of its own with its launches counted: bench
    (2^25, k=32), e2e_device_bench (3 modes x 3 quality models, 64 batches
    x 29,696 reads), hybrid_probe (B = 16,384, chain 8), sharded_hybrid_bench
    (16 batches; hybrid == exact is its own check), large_pairs (40 Mbp,
    300 copies streamed to the host and drained on the card, then 1,000
    copies drained on the card: more than 2^31 pairs, the rows drained
    against the counts, the chunk that crosses pair 2^31 against the same
    chunk from the index's arrays on the CPU), counting_stress (200,000
    reads through the file entry) and the demo (a seeded 60,000-base
    directory; its kernels' calls held against their plain versions in a
    run before, its figures against the same tour on the CPU). Returns
    (launches by path, the scripts' records)."""
    from kmer_hasher_tpu_torch import bench
    from kmer_hasher_tpu_torch.examples import counting_stress, large_pairs
    from kmer_hasher_tpu_torch.index.position_index import _pair_chunk
    from kmer_hasher_tpu_torch.ops.sort import clamp_chunk_capacity
    from kmer_hasher_tpu_torch.probes import e2e_device_bench as e2e
    from kmer_hasher_tpu_torch.probes import hybrid_probe, sharded_hybrid_bench

    launches, records = {}, {}

    def path(name, fn):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        launches[name] = read_launches(name)
        log(f"[main] tools: path {name} took {time.perf_counter() - t0:.1f} "
            f"s, launches B1 {launches[name][0]}, B2 {launches[name][1]}, "
            f"B3 {launches[name][2]}")
        if not any(launches[name][:3]):
            raise AssertionError(f"path {name} launched no kernel")
        return out

    rec = path("bench", lambda: bench.main([]))
    records["bench"] = {key: rec[key] for key in
                        ("metric", "value", "unit", "vs_baseline", "chain_s")}
    if launches["bench"][:3] != (32, 0, 0):
        raise AssertionError(f"bench launched {launches['bench'][:3]}, want "
                             f"B1 32 (4 chains of 8 builds)")

    def e2e_all():
        return {f"{mode}/{quals}": e2e.run(mode=mode, quals=quals)
                for quals in e2e.QUALS for mode in e2e.MODES}

    records["e2e"] = path("e2e", e2e_all)
    for quals in e2e.QUALS:
        h, x = records["e2e"][f"hybrid/{quals}"], records["e2e"][
            f"exact/{quals}"]
        if (h["distinct"], h["total"]) != (x["distinct"], x["total"]):
            raise AssertionError(f"e2e {quals}: hybrid differs from exact")
    if not (launches["e2e"][1] and launches["e2e"][2]):
        raise AssertionError("e2e launched no B2 or no B3")

    records["hybrid_probe"] = rec = path("hybrid_probe",
                                         lambda: hybrid_probe.main([]))
    for model, m in rec["models"].items():
        if m["flags"]["hybrid"] == 0 and m["acc"]["hybrid"] != m["acc"][
                "fast"]:
            raise AssertionError(f"hybrid_probe {model}: no read flagged, "
                                 f"yet hybrid's runs differ from fast's")
    if launches["hybrid_probe"][:3] != (0, 3 * 3 * 4 * 8, 0):
        raise AssertionError(f"hybrid_probe launched "
                             f"{launches['hybrid_probe'][:3]}")

    records["sharded_hybrid"] = path(
        "sharded_hybrid", lambda: sharded_hybrid_bench.main([]))
    if not (launches["sharded_hybrid"][1] and launches["sharded_hybrid"][2]):
        raise AssertionError("sharded_hybrid launched no B2 or no B3")

    def pairs():
        host = large_pairs.main([])
        dev = large_pairs.main(["--drain-on-device"])
        if (host["streamed"], host["checksum"]) != (dev["streamed"],
                                                    dev["checksum"]):
            raise AssertionError("large_pairs: the host and the device "
                                 "drains disagree")
        big = large_pairs.run(40.0, 1000, 1 << 62, True)
        return host, dev, big

    host, dev, big = path("large_pairs", pairs)
    idx = big.pop("index")
    counts = idx.counts().cpu().numpy().astype(np.int64)
    want = int((counts * (counts - 1) // 2).sum())
    total = big["total_pairs"]
    if not (big["streamed"] == total == want and total > 2 ** 31):
        raise AssertionError(
            f"large_pairs, 1,000 copies: {big['streamed']:,} rows drained, "
            f"total_pairs {total:,}, the counts give {want:,}")
    cap = clamp_chunk_capacity(large_pairs.CHUNK, total)
    start = (1 << 31) // cap * cap
    n = min(cap, total - start)
    on_card = _pair_chunk(idx.s_pos, idx.i_col, idx.m, idx.cum_m,
                          idx.n_valid, start, n).cpu()
    on_cpu = _pair_chunk(idx.s_pos.cpu(), idx.i_col.cpu(), idx.m.cpu(),
                         idx.cum_m.cpu(), idx.n_valid, start, n)
    if not (torch.equal(on_card, on_cpu) and start <= 2 ** 31 < start + n
            and bool((on_cpu[:, 1] < on_cpu[:, 2]).all())):
        raise AssertionError("large_pairs: the chunk across pair 2^31 "
                             "differs between the card and the CPU")
    del idx
    log(f"[main] tools: large_pairs, 1,000 copies: {total:,} pairs "
        f"(> 2^31) drained on the card = the counts' sum of c(c-1)/2; the "
        f"chunk of rows [{start:,}, {start + n:,}) across pair 2^31 equals "
        f"the CPU's from the index's arrays")
    records["large_pairs"] = {"300 copies, host": host,
                              "300 copies, device": dev,
                              "1000 copies, device": big}
    if launches["large_pairs"][:3] != (3, 0, 0):
        raise AssertionError(f"large_pairs launched "
                             f"{launches['large_pairs'][:3]}, want B1 3")

    rec = path("counting_stress", lambda: counting_stress.main([]))
    store = rec.pop("store")
    merges = two_run_merges(store)
    if not (store.keys.is_cuda and rec["distinct"] == store.n_unique > 0
            and int(store.cnt.sum()) == rec["total"]
            and bool((store.keys[1:] > store.keys[:-1]).all())):
        raise AssertionError("counting_stress: the table is not a sorted "
                             "unique table on the card")
    if not (launches["counting_stress"][1] >= 7
            and launches["counting_stress"][2] == merges >= 1):
        raise AssertionError(
            f"counting_stress launched B2 {launches['counting_stress'][1]} "
            f"and B3 {launches['counting_stress'][2]} times; the store "
            f"merged two runs {merges} times")
    records["counting_stress"] = rec

    # the demo twin on a seeded directory: first its kernels' calls held
    # against their plain versions (not counted), then the path, then the
    # same tour on the CPU, figure by figure
    from kmer_hasher_tpu_torch.examples import demo

    with tempfile.TemporaryDirectory() as d:
        write_demo_data(Path(d))
        _rec, calls = record_calls(lambda: demo.main(["--data", d]))
        held = hold_recorded(calls)
        log(f"[kernels] at the demo's shapes, bitwise: {held['calls']} "
            f"calls, inputs {held['shapes']} (max_abs_err {held['worst']})")
        rec = path("demo", lambda: demo.main(["--data", d]))
        on_cpu = demo.main(["--data", d, "--device", "cpu"])
    differ = [key for key in rec if key != "card" and rec[key] != on_cpu[key]]
    if differ or not (rec["distinct"] > 0 and rec["in_both"] > 0):
        raise AssertionError(f"demo: the card's figures {differ} differ "
                             f"from the CPU's, or nothing was counted")
    if not (launches["demo"][0] and launches["demo"][1]):
        raise AssertionError(f"demo launched {launches['demo'][:3]}")
    log(f"[main] tools: demo on {DEMO_BASES:,} bases, {DEMO_READS:,} reads "
        f"and {DEMO_REPEATS} repeat reads: every figure equals the same tour "
        f"on the CPU ({len(rec) - 1} figures) | {card}")
    records["demo"] = dict(rec, kernels=held)
    return launches, records


def merge_peak_factor(case) -> float:
    """Peak device bytes of one two-run ``merge_runs`` at the store shape
    over the bytes of its inputs (keys and one counter)."""
    from kmer_hasher_tpu_torch.index import count_store as cs

    keys, _pay, bounds = case
    na = int(bounds[1])
    runs = [(keys[:na].clone(), torch.ones((na, 1), dtype=torch.int64,
                                           device="cuda")),
            (keys[na:].clone(), torch.ones((keys.shape[0] - na, 1),
                                           dtype=torch.int64, device="cuda"))]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = cs.merge_runs(runs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return 1 + peak / (16 * keys.shape[0])


def bound(bytes_moved: float, ops: float):
    """(least milliseconds the card could take, which limit binds)."""
    by, op = bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(by, op) * 1e3, "bytes" if by >= op else "operations"


PATHS = ("index", "counting", "file", "threshold",
         "probes", "spill", "probes_r3", "cli", "probes_dma", "sharded",
         "sharded_index", "sharded_procs", "sharded_index_procs", "bench",
         "e2e", "hybrid_probe", "sharded_hybrid", "large_pairs",
         "counting_stress", "multidevice", "procs_devices", "demo")
# the paths whose B3 launches are rounds of a merge sort (32-bit payload),
# not two-run merges of the count store (implicit payload)
SORT_ROUND_PATHS = ("probes_dma",)


def main() -> None:
    name, card = phase_device()
    phase_build()
    rng = np.random.default_rng(SEED)
    worst_b1 = phase_kernels(rng)
    q_rows = phase_kernels_query(card)
    worst_b2 = phase_kernels_scan(rng)
    # B3's inputs draw from generators of their own, so the sequence and
    # the reads below stay what the seed has always made them
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    cases = merge_cases(gen, np.random.default_rng(SEED + 3))
    worst_b3 = phase_kernels_merge(cases)
    cases = {n: cases[n] for n in ("last sort round", "store")}
    gen_p = torch.Generator(device="cuda")
    gen_p.manual_seed(SEED + 4)
    p_cases = probe_cases(gen_p)
    worst_p = phase_kernels_probes(p_cases)
    gen_r3 = torch.Generator(device="cuda")
    gen_r3.manual_seed(SEED + 5)
    r3_cases = probe_r3_cases(gen_r3)
    worst_p.update(phase_kernels_probes_r3(r3_cases))
    gen_dma = torch.Generator(device="cuda")
    gen_dma.manual_seed(SEED + 6)
    dma_cases = probe_dma_cases(gen_dma)
    worst_p.update(phase_kernels_probes_dma(dma_cases))
    worst_tools = phase_kernels_tools()
    worst_b1 = max(worst_b1, worst_tools["B1"])
    worst_b2 = max(worst_b2, worst_tools["B2"])
    worst_b3 = max(worst_b3, worst_tools["B3"])
    seq = make_sequence(rng, SEQ_LEN)
    reset_launches()
    _, t_k32 = phase_main(seq)
    launches = {"index": read_launches("index")}
    if launches["index"][2]:
        raise AssertionError("the index path launched B3")
    launches["sharded_index"] = phase_main_sharded_index(seq)
    launches["sharded_index_procs"], ix_procs = \
        phase_main_sharded_index_procs(seq, card)
    gen.manual_seed(SEED)
    genome = make_genome(gen)
    batches = [draw_reads(genome, gen, ROWS) for _ in range(N_BATCHES)]
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        more, fq, stats = phase_main_counting(genome, batches, Path(tmp))
        launches.update(more)
        launches["sharded"], sh_stats = phase_main_sharded(batches, stats)
        launches["multidevice"], md_stats = phase_main_multidevice(
            seq, batches, card)
        launches["threshold"] = phase_main_threshold(fq)
        phase_card_vs_cpu_spill(batches, fq, Path(tmp))
        launches["cli"], cli_stats = phase_main_cli(seq, batches, stats,
                                                    Path(tmp), card)
        sh_big, sh_big_wall = phase_main_sharded_file(
            Path(tmp) / "reads.fq", cli_stats["reads"],
            sh_stats.pop("store"), len(batches) * ROWS, cli_stats["wall"],
            card)
        launches["sharded_procs"], procs_stats = phase_main_sharded_procs(
            Path(tmp) / "reads.fq", Path(tmp) / "reads50k.fq", sh_big,
            sh_big_wall, Path(tmp), card)
        launches["procs_devices"], pd_stats = phase_main_procs_devices(
            Path(tmp) / "reads.fq", sh_big, sh_big_wall, batches, seq,
            Path(tmp), card)
        del sh_big
        phase_card_vs_cpu_cli(Path(tmp) / "reads50k.fq", Path(tmp))
        phase_card_vs_cpu_sharded(batches, Path(tmp))
    for key in ("store", "stretch", "depth"):
        del stats[key]
    launches["probes"] = phase_main_probes()
    launches["probes_r3"] = phase_main_probes_r3()
    launches["probes_dma"] = phase_main_probes_dma()
    launches["spill"] = phase_main_spill(card)
    more, tools = phase_main_tools(card)
    launches.update(more)
    demo_worst = tools["demo"]["kernels"]["worst"]
    worst_b1 = max(worst_b1, demo_worst["B1"])
    worst_b2 = max(worst_b2, demo_worst["B2"])
    worst_b3 = max(worst_b3, demo_worst["B3"])
    by_path = [{p: launches[p][i] for p in PATHS}
               for i in range(len(counted_wrappers()))]
    b3_rows = {p: B3_ROWS[p] for p in PATHS}
    swept = phase_hybrid_full_width(rng)
    phase_card_vs_cpu(seq)
    phase_card_vs_cpu_sharded_index(seq)
    phase_card_vs_cpu_counting(genome, batches)
    b1_rows = phase_times(seq, card)
    phase_times_sharded_index(seq, card)
    b3_times = phase_times_merge(cases, card)
    log(f"[times] merge_runs of two runs at the store shape peaks at "
        f"{merge_peak_factor(cases['store']):.2f} x its inputs' bytes in "
        f"device memory (the store's fold budget assumes 5) | {card}")
    del cases
    p_times = phase_times_probes(p_cases, card)
    del p_cases
    p_times.update(phase_times_probes_r3(r3_cases, card))
    del r3_cases
    p_times.update(phase_times_probes_dma(dma_cases, card))
    del dma_cases
    turns = phase_times_turns(p_times)
    b2_rows = phase_times_counting(batches, card, stats)
    phase_times_sharded(batches, card, sh_stats["wall"])
    # least time for the same work: every input byte read once, every output
    # byte written once; B1 does ~30 integer ops per window (two funnel
    # shifts, the row's end, the length) and ~2 per base it packs, B2
    # ~60 float and integer ops per (read, position), B3 about log2(rows) +
    # 13 comparisons per row (two binary searches and the serial merge)
    n1 = 1 << 26
    b1_bound = bound(n1 * (1 + 8 + 1), n1 * 32)
    n2 = ROWS * READ_LEN
    b2_bound = bound(n2 * (2 + 1 + 8 + 8) + ROWS * (4 + 1) + 256 * 4,
                     n2 * 60)
    b3_bound = {shape: bound(t["bytes"], t["rows"] * (
        int(t["rows"]).bit_length() + 13)) for shape, t in b3_times.items()}
    # B3's loss per path: the rows it merged there times the gap to the
    # bound per row of the shape it merges there, the device time of
    # phase_times_merge: sort rounds on SORT_ROUND_PATHS, two-run merges of
    # the count store everywhere else
    gap = {shape: ((t["device_ms"] or t["ms"]) - b3_bound[shape][0])
           / t["rows"] for shape, t in b3_times.items()}
    b3_loss = {p: b3_rows[p] * gap["last sort round" if p in SORT_ROUND_PATHS
                                   else "store"] for p in PATHS}
    log(f"[launches] B3 per path: launches / rows merged / rows x the gap "
        f"to the bound a row of the shape merged there (store "
        f"{gap['store'] * 1e9:.2f} ps, sort round "
        f"{gap['last sort round'] * 1e9:.2f} ps; device times) = "
        + "; ".join(f"{p} {by_path[2][p]} / {b3_rows[p]:,} / "
                    f"{b3_loss[p]:.1f} ms" for p in PATHS if by_path[2][p])
        + f"; in all {sum(b3_loss.values()):.1f} ms | {card}")
    # B1's loss per path: the window starts it encoded there times the gap
    # to the bound per window start at 2^26, k=32 (device times)
    b1_main = b1_rows["2^26 bytes, k=32"]
    b1_gap = ((b1_main["device_ms"] or b1_main["ms"]) - b1_bound[0]) / n1
    b1_loss = {p: B1_POSITIONS[p] * b1_gap for p in PATHS}
    log(f"[launches] B1 per path: launches / window starts / window starts "
        f"x the gap to the bound at 2^26, k=32 ({b1_gap * 1e9:.2f} ps) = "
        + "; ".join(f"{p} {by_path[0][p]} / {B1_POSITIONS[p]:,} / "
                    f"{b1_loss[p]:.2f} ms" for p in PATHS if by_path[0][p])
        + f"; in all {sum(b1_loss.values()):.2f} ms | {card}")
    p5_loss = p5_losses(by_path[7], p_times["P5"], card)
    main_variant = "f32+flags"
    main_shape = "store"  # what the counting path gives B3
    log(json.dumps({"kernels": [{
        "name": "B1 encode",
        "route": "cuda",
        "source": "kmer_hasher_tpu_torch/csrc/encode.cu",
        "replaces": "kmer_hasher_tpu/ops/pallas_encode.py:91",
        "launches": by_path[0]["index"],
        "launches_by_path": by_path[0],
        "max_abs_err": worst_b1,
        "positions_by_path": {p: B1_POSITIONS[p] for p in PATHS},
        "loss_ms_by_path": b1_loss,
        "ms": b1_main["ms"],
        "plain_ms": b1_main["plain_ms"],
        "bound_ms": b1_bound[0],
        "bound_by": b1_bound[1],
        "library_ms": None,
        "shape": "2^26 bytes, k=32",
        "by_shape": {shape: dict(t, bound_ms=b1_bound[0],
                                 bound_by=b1_bound[1])
                     for shape, t in b1_rows.items()},
    }, {
        "name": "B2 ll_scan",
        "route": "cuda",
        "source": "kmer_hasher_tpu_torch/csrc/ll_scan.cu",
        "replaces": "kmer_hasher_tpu/ops/pallas_scan.py:150",
        "launches": by_path[1]["counting"],
        "launches_by_path": by_path[1],
        "f64_rescans_at_full_width": swept,
        "max_abs_err": worst_b2,
        "ms": b2_rows[main_variant]["ms"],
        "plain_ms": b2_rows[main_variant]["plain_ms"],
        "bound_ms": b2_bound[0],
        "bound_by": b2_bound[1],
        "library_ms": None,
        "instantiation": main_variant,
        "shape": main_variant,
        "by_shape": {name: dict(t, bound_ms=b2_bound[0], bound_by=b2_bound[1])
                     for name, t in b2_rows.items()},
    }, {
        "name": "B3 merge_path",
        "route": "cuda",
        "source": "kmer_hasher_tpu_torch/csrc/merge_path.cu",
        "replaces": "kmer_hasher_tpu/ops/merge_sort.py:260",
        "launches": by_path[2]["counting"],
        "launches_by_path": by_path[2],
        "rows_by_path": b3_rows,
        "loss_ms_by_path": b3_loss,
        "max_abs_err": worst_b3,
        "ms": b3_times[main_shape]["ms"],
        "plain_ms": b3_times[main_shape]["plain_ms"],
        "bound_ms": b3_bound[main_shape][0],
        "bound_by": b3_bound[main_shape][1],
        "library_ms": b3_times[main_shape]["library_ms"],
        "shape": main_shape,
        "by_shape": {shape: dict(t, bound_ms=b3_bound[shape][0],
                                 bound_by=b3_bound[shape][1])
                     for shape, t in b3_times.items()},
    }] + [dict({
        "name": title,
        "route": "cuda",
        "source": f"kmer_hasher_tpu_torch/csrc/{source}",
        "replaces": f"tools/chip_probes/sort_probes.py:{line}",
        "launches": by_path[i]["probes"],
        "launches_by_path": by_path[i],
        "max_abs_err": worst_p[name],
        "shape": shape,
        "by_shape": p_times[name],
    }, **{key: p_times[name][shape][key] for key in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        for i, (name, title, source, line, shape) in enumerate((
            ("P1", "P1 probe_copy", "probe_copy.cu", 41, "full"),
            ("P2", "P2 probe_dyn_copy", "probe_dyn_copy.cu", 69,
             "full, granule 1"),
            ("P3", "P3 probe_roll (rows)", "probe_roll.cu", 112, "full"),
            ("P4", "P4 probe_roll (flat)", "probe_roll.cu", 135, "full"),
        ), start=3)] + [dict({
        "name": title,
        "route": "cuda",
        "source": f"kmer_hasher_tpu_torch/csrc/{source}",
        "replaces": f"tools/chip_probes/sort_probes_r3.py:{line}",
        "launches": by_path[i]["probes_r3"],
        "launches_by_path": by_path[i],
        "max_abs_err": worst_p[name],
        "shape": shape,
        "by_shape": p_times[name],
        **({"loss_ms_by_path": p5_loss} if name == "P5" else {}),
    }, **{key: p_times[name][shape][key] for key in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        for i, (name, title, source, line, shape) in enumerate((
            ("P5", "P5 probe_dyn_copy_2d", "probe_dyn_copy_2d.cu", 86,
             "full, R=512"),
            ("P6", "P6 probe_small_copy", "probe_small_copy.cu", 139, "full"),
            ("P7", "P7 probe_async_copy", "probe_async_copy.cu", 190,
             "full, granule 1"),
            ("P8", "P8 probe_smem_gather", "probe_smem_gather.cu", 232,
             "full"),
        ), start=7)] + [dict({
        "name": title,
        "route": "cuda",
        "source": f"kmer_hasher_tpu_torch/csrc/{source}",
        "replaces": f"tools/chip_probes/dma_probes_r3.py:{line}",
        "launches": by_path[i]["probes_dma"],
        "launches_by_path": by_path[i],
        "max_abs_err": worst_p[name],
        "shape": shape,
        "by_shape": p_times[name],
    }, **{key: p_times[name][shape][key] for key in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        for i, (name, title, source, line, shape) in enumerate((
            ("P9", "P9 probe_pipelined_copy", "probe_pipelined_copy.cu", 44,
             "full, R=512"),
            ("P10", "P10 probe_lane_gather", "probe_lane_gather.cu", 117,
             "full"),
        ), start=11)], "turns": turns, "file_entry": cli_stats,
        "sharded_procs": procs_stats, "sharded_index_procs": ix_procs,
        "tools": tools, "multidevice": md_stats,
        "procs_devices": pd_stats, "query_kernels": q_rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:  # one rank of the sharded_procs phase
        rank_worker(sys.argv[2], int(sys.argv[3]))
    else:
        main()
