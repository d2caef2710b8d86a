"""The CUDA kernels B1, B2, B3, Q1, Q2 and P1–P10 against their plain
PyTorch versions, and the paths through them against the CPU, on the card.

Needs a CUDA device: marked ``cuda`` and skipped (visibly) without one.
Imports neither JAX nor kmer_hasher_tpu, so it runs on a machine with
only PyTorch:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from kmer_hasher_tpu_torch import api
from kmer_hasher_tpu_torch import counting
from kmer_hasher_tpu_torch.index import count_store
from kmer_hasher_tpu_torch.ops import cuda_encode, cuda_merge, cuda_scan
from kmer_hasher_tpu_torch.probes import (cuda_probes, cuda_probes_dma,
                                          cuda_probes_r3, dma_probes_r3,
                                          sort_probes, sort_probes_r3)
from kmer_hasher_tpu_torch.probes._common import lex_sort, unsigned_pay
from kmer_hasher_tpu_torch.qll import Q_TO_LL

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch.cuda.is_available() is false")
    return torch.device("cuda")


def random_seq(rng, L, n_runs=8):
    seq = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), size=L)
    for _ in range(n_runs):
        a = int(rng.integers(0, L))
        seq[a: a + int(rng.integers(1, 41))] = ord("N")
    return seq


@pytest.mark.parametrize("k", [1, 4, 16, 17, 21, 31, 32])
def test_b1_kernel_matches_plain(cuda, k):
    rng = np.random.default_rng(k)
    L = 1 << 16
    seq = torch.from_numpy(random_seq(rng, L)).to(cuda)
    before = cuda_encode.encode.launches
    key, valid = cuda_encode.encode(seq, k, L - 5)
    torch.cuda.synchronize()
    assert cuda_encode.encode.launches == before + 1
    pk, pv = cuda_encode.plain(seq, k, L - 5)
    assert torch.equal(key, pk) and torch.equal(valid, pv)


@pytest.mark.parametrize("k", [4, 21, 32])
def test_b1_kernel_batch_matches_plain(cuda, k):
    rng = np.random.default_rng(50 + k)
    B, L = 64, 1 << 10
    seq = torch.from_numpy(
        np.stack([random_seq(rng, L, 2) for _ in range(B)])).to(cuda)
    lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
    lengths[:3] = (L, 0, k)
    lens = torch.from_numpy(lengths).to(cuda)
    key, valid = cuda_encode.encode(seq, k, lens)
    pk, pv = cuda_encode.plain(seq, k, lens)
    assert torch.equal(key, pk) and torch.equal(valid, pv)


KS_EDGE = [1, 2, 15, 16, 17, 31, 32]
TILE = cuda_encode.TILE


def n_at_tile_edges(seq, L):
    """N at every tile's first and last byte and in the next tile's halo
    (the 31 bytes after a tile that its last windows read)."""
    for e in range(TILE, L, TILE):
        for d in (-1, 0, 1, 30):
            if 0 <= e + d < L:
                seq[e + d] = ord("N")
    return seq


@pytest.mark.parametrize("off", [1, 3, 15])
@pytest.mark.parametrize("k", KS_EDGE)
def test_b1_unaligned_start_matches_plain(cuda, k, off):
    """A 1-D view at byte offset 1, 3 or 15 of its allocation, with N at
    the tile edges; a length short of the end, and the whole."""
    rng = np.random.default_rng(10 * k + off)
    L = 3 * TILE + 77
    buf = np.full(L + 32, ord("N"), np.uint8)
    buf[off: off + L] = n_at_tile_edges(random_seq(rng, L, 4), L)
    seq = torch.from_numpy(buf).to(cuda)[off: off + L]
    assert seq.data_ptr() % 16 == off
    for tl in (L - 5, L):
        key, valid = cuda_encode.encode(seq, k, tl)
        pk, pv = cuda_encode.plain(seq, k, tl)
        assert torch.equal(key, pk) and torch.equal(valid, pv)
        assert bool(valid.any())


@pytest.mark.parametrize("how", ["list", "numpy", "cpu tensor",
                                 "cuda int64"])
@pytest.mark.parametrize("k", KS_EDGE)
def test_b1_counting_batch_matches_plain(cuda, k, how):
    """The counting batch's shape [29,696, 151], per-row lengths 0, k-1,
    k, 151 and random, given every way a caller gives them."""
    rng = np.random.default_rng(700 + k)
    B, L = 29_696, 151
    seq = rng.choice(np.frombuffer(b"ACGTacgtN", np.uint8), size=(B, L))
    lengths = rng.integers(0, L + 1, size=B)
    lengths[:4] = (0, k - 1, k, L)
    true_len = {"list": lengths.tolist(), "numpy": lengths.astype(np.int32),
                "cpu tensor": torch.from_numpy(lengths),
                "cuda int64": torch.from_numpy(lengths).to(cuda)}[how]
    x = torch.from_numpy(seq).to(cuda)
    key, valid = cuda_encode.encode(x, k, true_len)
    pk, pv = cuda_encode.plain(x, k, torch.from_numpy(lengths).to(cuda))
    assert torch.equal(key, pk) and torch.equal(valid, pv)


@pytest.mark.parametrize("row_len", [TILE - 1, TILE, TILE + 1])
@pytest.mark.parametrize("k", KS_EDGE)
def test_b1_rows_around_the_tile_match_plain(cuda, k, row_len):
    """Rows one below, at and one above the kernel's tile, with N at the
    tile edges, per-row lengths and one length for every row."""
    rng = np.random.default_rng(800 + k + row_len)
    B = 5
    flat = n_at_tile_edges(random_seq(rng, B * row_len, 6), B * row_len)
    x = torch.from_numpy(flat.reshape(B, row_len)).to(cuda)
    lengths = np.array([row_len, 0, k - 1, k, row_len - 3])
    for tl in (torch.from_numpy(lengths).to(cuda), row_len - 2):
        key, valid = cuda_encode.encode(x, k, tl)
        pk, pv = cuda_encode.plain(x, k, tl)
        assert torch.equal(key, pk) and torch.equal(valid, pv)


@pytest.mark.parametrize("L", [1, 5, 15, 17])
@pytest.mark.parametrize("k", [1, 16, 32])
def test_b1_short_rows_match_plain(cuda, k, L):
    """Rows shorter than a 16-byte chunk or than k: several rows in one
    chunk, the row found by division on every thread; from an aligned
    start and from byte offset 3, with per-row lengths (0, k - 1, k, L and
    random) and with one length for every row."""
    rng = np.random.default_rng(900 + 40 * k + L)
    B = 1000
    flat = random_seq(rng, B * L + 3, 20)
    lengths = rng.integers(0, L + 1, size=B)
    lengths[:4] = (0, min(k - 1, L), min(k, L), L)
    for off in (0, 3):
        x = torch.from_numpy(flat).to(cuda)[off: off + B * L].view(B, L)
        assert x.data_ptr() % 16 == off
        for tl in (lengths, torch.from_numpy(lengths).to(cuda), L, L - 1):
            key, valid = cuda_encode.encode(x, k, tl)
            pk, pv = cuda_encode.plain(x, k, torch.as_tensor(tl, device=cuda))
            assert torch.equal(key, pk) and torch.equal(valid, pv)


@pytest.mark.parametrize("off", [0, 3, 15])
@pytest.mark.parametrize("k", [1, 16, 32])
def test_b1_short_stream_matches_plain(cuda, k, off):
    """1-D inputs of 1 to 20 bytes at byte offset 0, 3 or 15: one chunk
    across both ends of the stream, inputs shorter than k; the whole
    length and two bytes short of it."""
    rng = np.random.default_rng(950 + 20 * k + off)
    buf = torch.from_numpy(random_seq(rng, 64, 1)).to(cuda)
    for n in range(1, 21):
        seq = buf[off: off + n]
        assert seq.data_ptr() % 16 == off
        for tl in (n, max(n - 2, 0)):
            key, valid = cuda_encode.encode(seq, k, tl)
            pk, pv = cuda_encode.plain(seq, k, tl)
            assert torch.equal(key, pk) and torch.equal(valid, pv), (n, tl)


def test_b1_and_trailing_mask_never_wait_for_the_card(cuda):
    """With a scalar length, or per-row lengths from the host, neither B1's
    wrapper nor drop_trailing_mask makes the host wait for the stream:
    PyTorch's sync debug mode raises on any synchronising call."""
    from kmer_hasher_tpu_torch.ops import encode as enc

    rng = np.random.default_rng(990)
    seq = torch.from_numpy(random_seq(rng, 5000)).to(cuda)
    batch = seq[:4800].view(32, 150)
    lengths = rng.integers(0, 151, size=32).astype(np.int32)
    cuda_encode.encode(seq, 21, 4990)  # built and loaded beforehand
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        key, valid = cuda_encode.encode(seq, 21, 4990)
        bkey, bvalid = cuda_encode.encode(batch, 21, lengths)
        mask = enc.drop_trailing_mask(seq, 21, 4990)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(mask.cpu(), enc.drop_trailing_mask(seq.cpu(), 21,
                                                          4990))
    pk, pv = cuda_encode.plain(batch, 21, torch.from_numpy(lengths).to(cuda))
    assert torch.equal(bkey, pk) and torch.equal(bvalid, pv)


def test_b1_rejects_non_contiguous(cuda):
    seq = torch.zeros((8, 64), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        cuda_encode.encode(seq.t(), 4, torch.full((64,), 8, device=cuda))


@pytest.mark.parametrize("k", [16, 21, 32])
def test_index_on_card_matches_cpu(cuda, k):
    rng = np.random.default_rng(900 + k)
    seq = random_seq(rng, 5000)
    seq[3000:3400] = seq[1000:1400]  # a repeat: real pairs
    before = cuda_encode.encode.launches
    g = api.make_kmer_hash(seq, k, device=cuda)
    assert cuda_encode.encode.launches > before
    c = api.make_kmer_hash(seq, k, device="cpu")
    for name in ("s_key", "s_pos", "starts", "seg_ids", "cum_m"):
        assert torch.equal(getattr(g, name).cpu(), getattr(c, name)), name
    tg, tc = api.kmer_pos(g, 15), api.kmer_pos(c, 15)
    assert tg["kmer"] == tc["kmer"]
    for f in ("pos", "pair.pos", "count"):
        assert torch.equal(tg[f].cpu(), tc[f]), f
    if k <= 31:
        q = seq[900:1500]
        assert torch.equal(api.seq_kmer_pos(g, q, k).cpu(),
                           api.seq_kmer_pos(c, q, k))


# the query path on the card (Q1, Q2): a seeded index of several Mbp with a
# 40-copy tandem repeat, so that a window's count reaches 40
QUERY_REF_LEN, QUERY_REPEAT_AT, QUERY_UNIT = 4_000_000, 1_000_000, 5000
_query_indexes = {}


def query_ref() -> np.ndarray:
    if "seq" not in _query_indexes:
        rng = np.random.default_rng(2200)
        seq = random_seq(rng, QUERY_REF_LEN, n_runs=100)
        unit = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=QUERY_UNIT)
        seq[QUERY_REPEAT_AT: QUERY_REPEAT_AT + QUERY_UNIT * 40] = np.tile(
            unit, 40)
        _query_indexes["seq"] = seq
    return _query_indexes["seq"]


def query_index(dev, k, seq=None):
    """(card index, CPU index) of ``seq`` (the 4 Mbp reference by
    default), built once a module."""
    key = (k, None if seq is None else seq.tobytes())
    if key not in _query_indexes:
        seq = query_ref() if seq is None else seq
        _query_indexes[key] = (api.make_kmer_hash(seq, k, device=dev),
                               api.make_kmer_hash(seq, k, device="cpu"))
    return _query_indexes[key]


def mutated(rng, seq, at, n, rate=0.01):
    """seq[at: at + n] with substitutions at ``rate`` (never at an N)."""
    q = seq[at: at + n].copy()
    sub = (rng.random(n) < rate) & ((q | 0x20) != ord("n"))
    q[sub] = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=int(sub.sum()))
    return q


def check_query_kernels(g, c, q, k, capacity=1 << 20):
    """Q1 and Q2 on the card bitwise against ``_query_ranges`` and
    ``_hit_chunk`` on the same card tensors, chunk by chunk; then the
    chunks of the card's drain, with one Q1 launch and one Q2 launch a
    chunk, and ``seq_kmer_pos`` on the card, one Q2 launch for all rows,
    against the CPU path. Returns (largest count, rows)."""
    from kmer_hasher_tpu_torch.index import query as tq
    from kmer_hasher_tpu_torch.ops import cuda_query, sort

    n = q.shape[0]
    x = torch.from_numpy(q).to(g.device)
    lb0, c0, cum0 = tq._query_ranges(g.s_key, g.n_valid, x, k, n)
    lb, cnt, cum = tq._card_ranges(g.s_key, g.n_valid, q, x, k)
    assert torch.equal(lb, lb0) and torch.equal(cnt, c0)
    assert torch.equal(cum, cum0)
    total = int(cum0[-1])
    cap = sort.clamp_chunk_capacity(capacity, total)
    for start in range(0, total, cap):
        m = min(cap, total - start)
        assert torch.equal(cuda_query.hits(g.s_pos, lb, cnt, cum, k, start, m),
                           tq._hit_chunk(g.s_pos, lb0, c0, cum0, k, start, m))
    r0, h0 = cuda_query.ranges.launches, cuda_query.hits.launches
    chunks = list(api.iter_seq_kmer_pos_chunks(g, q, k, capacity))
    assert cuda_query.ranges.launches == r0 + 1
    assert cuda_query.hits.launches == h0 + -(-total // cap)
    assert len(chunks) == max(1, -(-total // cap))
    want = api.seq_kmer_pos(c, q, k)
    assert torch.equal(torch.cat(chunks).cpu(), want)
    h0 = cuda_query.hits.launches
    assert torch.equal(api.seq_kmer_pos(g, q, k).cpu(), want)
    assert cuda_query.hits.launches == h0 + (total > 0)  # one chunk
    return int(c0.max()), total


@pytest.mark.parametrize("capacity", [1 << 20, 1 << 12])
@pytest.mark.parametrize("n", [10_000, 100_000, 1_000_000])
def test_query_kernels_at_the_cell_lengths(cuda, n, capacity):
    """k=21, 1% substitutions, each query across the repeat's start; with
    chunks of 4,096 rows a window's rows are split across chunks."""
    g, c = query_index(cuda, 21)
    assert g.s_key.shape[0] > g.n_valid
    rng = np.random.default_rng(n)
    q = mutated(rng, query_ref(), QUERY_REPEAT_AT - n // 2, n)
    most, total = check_query_kernels(g, c, q, 21, capacity)
    assert most >= 40 and total > n // 2


@pytest.mark.parametrize("k", [1, 15, 16, 17, 31])
def test_query_kernels_across_k(cuda, k):
    """N runs and an N just before the last window (the quirk drops it)."""
    rng = np.random.default_rng(2300 + k)
    if k == 1:  # four keys: a short reference and query keep rows few
        seq = random_seq(rng, 2000, n_runs=3)
        g, c = query_index(cuda, k, seq)
        q = mutated(rng, seq, 500, 60)
    else:
        g, c = query_index(cuda, k)
        q = mutated(rng, query_ref(), QUERY_REPEAT_AT - 20_000, 60_000)
        q[100:130] = ord("N")
    q[-k - 1] = ord("N")
    most, total = check_query_kernels(g, c, q, k)
    assert total > 0


def edge_query(case, k):
    ref = query_ref()
    at = QUERY_REPEAT_AT + 7
    if case == "N runs":
        q = ref[at: at + 20_000].copy()
        for a in (0, 999, 5000, 19_990):
            q[a: a + 7] = ord("N")
        return q
    if case == "N before the last window":
        q = ref[at: at + 5000].copy()
        q[-k - 1] = ord("n")
        return q
    if case == "k+1 bases":
        return ref[at: at + k + 1].copy()
    if case == "k+1 bases after an N":
        q = ref[at: at + k + 1].copy()
        q[0] = ord("N")
        return q
    if case == "no hits":
        return np.random.default_rng(2400).choice(
            np.frombuffer(b"ACGT", np.uint8), size=5000)
    return np.full(5000, ord("N"), dtype=np.uint8)  # all N


@pytest.mark.parametrize("case", ["N runs", "N before the last window",
                                  "k+1 bases", "k+1 bases after an N",
                                  "no hits", "all N"])
def test_query_kernels_on_edge_queries(cuda, case):
    g, c = query_index(cuda, 21)
    most, total = check_query_kernels(g, c, edge_query(case, 21), 21)
    if case in ("no hits", "all N", "k+1 bases after an N"):
        assert total == 0
    else:
        assert total > 0


def test_query_lone_chunk_is_returned_as_is(cuda, monkeypatch):
    from kmer_hasher_tpu_torch.index import query as tq
    from kmer_hasher_tpu_torch.ops import cuda_query

    g, c = query_index(cuda, 21)
    q = mutated(np.random.default_rng(2500), query_ref(), 2_000_000, 50_000)
    made, cats = [], []
    chunk, cat = tq._card_hit_chunk, torch.cat
    monkeypatch.setattr(tq, "_card_hit_chunk",
                        lambda *a: made.append(chunk(*a)) or made[-1])
    monkeypatch.setattr(torch, "cat",
                        lambda *a, **kw: cats.append(1) or cat(*a, **kw))
    r0, h0 = cuda_query.ranges.launches, cuda_query.hits.launches
    rows = api.seq_kmer_pos(g, q, 21)
    assert len(made) == 1 and not cats
    assert rows.data_ptr() == made[0].data_ptr()
    assert (cuda_query.ranges.launches, cuda_query.hits.launches) == (
        r0 + 1, h0 + 1)
    assert cuda_query.ranges.by_device[rows.device.index] >= 1
    assert rows.dtype == torch.int32 and rows.is_contiguous()
    monkeypatch.undo()
    assert torch.equal(rows.cpu(), api.seq_kmer_pos(c, q, 21))


def test_query_wrappers_never_wait_for_the_card(cuda):
    from kmer_hasher_tpu_torch.index import query as tq
    from kmer_hasher_tpu_torch.ops import cuda_query

    g, _ = query_index(cuda, 21)
    q = query_ref()[3_000_000: 3_100_000]
    x = torch.from_numpy(q).to(cuda)
    key, valid = cuda_encode.encode(x, 21, q.shape[0])
    lb, cnt, cum = tq._card_ranges(g.s_key, g.n_valid, q, x, 21)
    w0 = cuda_query.ranges.windows
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lb2, c2 = cuda_query.ranges(key, valid, g.s_key, g.n_valid, -1)
        rows = cuda_query.hits(g.s_pos, lb, cnt, cum, 21, 0, 5000)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert cuda_query.ranges.windows == w0 + q.shape[0]
    assert torch.equal(lb2, lb) and torch.equal(c2, cnt)
    assert torch.equal(rows, tq._hit_chunk(g.s_pos, lb, cnt, cum, 21, 0,
                                           5000))


def test_query_wrappers_raise_on_the_card(cuda):
    from kmer_hasher_tpu_torch.ops import cuda_query

    key = torch.zeros(64, dtype=torch.int64, device=cuda)
    valid = torch.ones(64, dtype=torch.bool, device=cuda)
    s_key = torch.zeros(128, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        cuda_query.ranges(key[::2], valid[::2], s_key, 8, -1)
    with pytest.raises(ValueError):
        cuda_query.ranges(key, valid, s_key.cpu(), 8, -1)
    pos = torch.zeros(128, dtype=torch.int32, device=cuda)
    cum = torch.arange(1, 65, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        cuda_query.hits(pos[::2], key, key, cum, 4, 0, 8)


def read_batch(rng, k, B=300, L=151, quals="binned"):
    """A ragged batch: lengths 0, k, k+1, full and random."""
    seq = rng.choice(np.frombuffer(b"ACGTacgtN", np.uint8), size=(B, L))
    if quals == "binned":
        q = rng.choice(np.frombuffer(b"F:,#", np.uint8), size=(B, L),
                       p=[0.88, 0.08, 0.02, 0.02])
    else:
        q = (33 + rng.integers(0, 42, size=(B, L))).astype(np.uint8)
    lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
    lengths[:4] = (0, k, k + 1, L)[:B]
    return seq, q, lengths


@pytest.mark.parametrize("quals", ["binned", "uniform"])
@pytest.mark.parametrize("variant", ["exact", "fast", "flags"])
@pytest.mark.parametrize("k", [5, 16, 17, 21, 31, 32])
def test_b2_kernel_matches_plain(cuda, k, variant, quals):
    rng = np.random.default_rng(31 * k)
    args = [torch.from_numpy(a).to(cuda) for a in read_batch(rng, k,
                                                             quals=quals)]
    kw = dict(precision="exact" if variant == "exact" else "fast",
              return_flags=variant == "flags",
              min_q_char=53 if variant == "flags" else None)
    before = cuda_scan.scan.launches
    got = cuda_scan.scan(*args, k, float(Q_TO_LL[53]), **kw)
    torch.cuda.synchronize()
    assert cuda_scan.scan.launches == before + 1
    want = cuda_scan.plain(*args, k, float(Q_TO_LL[53]), **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# the edges of B2's tiling (rows, L, k): 32 reads a warp, chunks of 16
# positions, windows of 512 positions; k = 1 and k = 32
B2_EDGES = [(1, 151, 21), (33, 151, 21), (29_697, 151, 21), (64, 8, 5),
            (64, 1, 1), (64, 16, 9), (64, 32, 32), (96, 160, 21),
            (40, 600, 21), (35, 1100, 31), (256, 151, 1), (256, 151, 32)]


@pytest.mark.parametrize("variant", ["exact", "fast", "flags"])
@pytest.mark.parametrize("rows,L,k", B2_EDGES)
def test_b2_kernel_matches_plain_on_the_tiling_edges(cuda, rows, L, k,
                                                      variant):
    rng = np.random.default_rng(rows + 7 * L + k)
    args = [torch.from_numpy(a).to(cuda)
            for a in read_batch(rng, k, B=rows, L=L, quals="uniform")]
    kw = dict(precision="exact" if variant == "exact" else "fast",
              return_flags=variant == "flags",
              min_q_char=53 if variant == "flags" else None)
    got = cuda_scan.scan(*args, k, float(Q_TO_LL[53]), **kw)
    want = cuda_scan.plain(*args, k, float(Q_TO_LL[53]), **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("quals", ["low", "constant"])
def test_b2_flags_near_the_threshold(cuda, quals):
    """Thresholds swept around achievable window sums, so that comparisons
    land inside the tracked error band: the error lanes of kernel and plain
    version agree bitwise; with one constant quality every window sum sits
    on the threshold and reads do flag."""
    from kmer_hasher_tpu_torch.ops.scan_iter import ll_table_f32

    k = 9
    rng = np.random.default_rng(1)
    B, L = 256, 40
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=(B, L))]
    if quals == "low":
        qual = (33 + rng.integers(2, 11, size=(B, L))).astype(np.uint8)
    else:
        qual = np.full((B, L), 33 + 40, np.uint8)
    sums = np.sort(np.lib.stride_tricks.sliding_window_view(
        ll_table_f32()[qual].astype(np.float64), k + 1, axis=1
    ).sum(-1).ravel())
    args = [torch.from_numpy(a).to(cuda)
            for a in (seq, qual, np.full(B, L, np.int32))]
    n_flagged = 0
    for anchor in (sums[sums.size // 6], sums[sums.size // 2]):
        for off in (-3e-6, -2.5e-6, 0.0, 1.5e-6, 2e-6, 2.5e-6, 3e-6):
            got = cuda_scan.scan(*args, k, float(anchor + off),
                                 precision="fast", return_flags=True)
            want = cuda_scan.plain(*args, k, float(anchor + off),
                                   precision="fast", return_flags=True)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
            n_flagged += int(got[3].sum())
    assert n_flagged > 0 or quals == "low"


def test_b2_rejects_what_it_does_not_take(cuda):
    seq = torch.zeros((8, 64), dtype=torch.uint8, device=cuda)
    lens = torch.full((8,), 64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        cuda_scan.scan(seq.t()[:8], seq, lens, 5, -0.01)
    with pytest.raises(TypeError):
        cuda_scan.scan(seq.int(), seq, lens, 5, -0.01)
    with pytest.raises(ValueError):
        cuda_scan.scan(seq, seq, lens[:3], 5, -0.01)
    with pytest.raises(ValueError):
        cuda_scan.scan(seq, seq, lens.cpu(), 5, -0.01)


@pytest.mark.parametrize("exact_ll", [True, False, "hybrid"])
def test_counting_on_card_matches_cpu(cuda, exact_ll):
    k = 21
    rng = np.random.default_rng(5)
    seq, qual, lengths = read_batch(rng, k, B=2000)
    has_qual = np.arange(2000) % 50 != 7
    stores = []
    for dev in (cuda, "cpu"):
        st = api.CountStore(k, counts_n=2, device=dev)
        b1, b2 = cuda_encode.encode.launches, cuda_scan.scan.launches
        counting.count_batches(st, [(seq, qual, lengths, has_qual)] * 2, k,
                               source=1, exact_ll=exact_ll)
        if dev == cuda:
            assert cuda_scan.scan.launches > b2
            assert cuda_encode.encode.launches > b1
        stores.append(st)
    g, c = stores
    assert g.counts_dict() == c.counts_dict()
    np.testing.assert_array_equal(g.total_added, c.total_added)
    np.testing.assert_array_equal(api.kmer_spectrum(g, 50),
                                  api.kmer_spectrum(c, 50))
    probe = seq[3]
    assert torch.equal(api.seq_kmer_depth(g, probe, k).cpu(),
                       api.seq_kmer_depth(c, probe, k))


def test_counting_calls_share_one_copy_stream(cuda):
    """Every ``count_batches`` call on a card uploads on the card's one copy
    stream, so that a later call reuses the batch blocks that an earlier
    one freed: counting the same batches again allocates nothing anew."""
    k = 21
    rng = np.random.default_rng(6)
    seq, qual, lengths = read_batch(rng, k, B=2000)
    batches = [(seq, qual, lengths, np.ones(2000, bool))] * 3
    assert counting._copy_stream(cuda) is counting._copy_stream(cuda)
    tables = []
    for i in range(3):
        st = api.CountStore(k, device=cuda)
        counting.count_batches(st, batches, k)
        tables.append(st.counts_dict())
        del st
        torch.cuda.synchronize()
        if i == 1:
            allocs = torch.cuda.memory_stats(cuda)["num_device_alloc"]
    assert torch.cuda.memory_stats(cuda)["num_device_alloc"] == allocs
    assert tables[0] == tables[1] == tables[2]


SIGN = np.uint64(1 << 63)
SORT_N = 1 << 26  # the last round of a 2^26-row sort: two runs of 2^25
FIVE_KEYS =np.array([0, 1, 2 ** 63, 2 ** 64 - 1, 42], np.uint64)


def sorted_runs(rng, lens, dup, flagged=True):
    """Flat (sortable int64 keys, int32 payload lane, bounds) of runs each
    sorted by (key, unsigned payload); ``dup`` draws from five keys, the
    all-ones key among them; ``flagged`` sets bit 31 on a third of the
    payloads, as the k = 32 index payload does."""
    ks, ps = [], []
    for n in lens:
        k = (rng.choice(FIVE_KEYS, size=n) if dup else
             rng.integers(0, 2 ** 64 - 1, size=n, dtype=np.uint64))
        p = rng.integers(0, 2 ** 31, size=n, dtype=np.uint64)
        if flagged:
            p[::3] |= np.uint64(1 << 31)
        order = np.lexsort((p, k))
        ks.append(k[order])
        ps.append(p[order].astype(np.uint32))
    keys = torch.from_numpy((np.concatenate(ks) ^ SIGN).view(np.int64))
    pay = torch.from_numpy(np.concatenate(ps).view(np.int32).copy())
    return keys, pay, np.concatenate([[0], np.cumsum(lens)])


B3_SHAPES = {
    "one pair, unequal": (70_001, 33_000),
    "many short pairs": (5, 0, 0, 0, 1, 1, 2049, 3, 1, 4096, 2048, 2048),
    "an empty run and a run of 1": (0, 1),
    "A empty": (0, 5000),
    "B empty": (5000, 0),
    "64 equal runs": (4096,) * 64,
    "not a multiple of the tile": (2047, 2050, 6143, 1),
    "pairs of the tile +-1": (cuda_merge.TILE - 1, cuda_merge.TILE,
                              cuda_merge.TILE + 1, cuda_merge.TILE - 1,
                              cuda_merge.TILE, cuda_merge.TILE + 1),
    "A empty across tiles": (0, 9 * cuda_merge.TILE + 1),
    "B empty across tiles": (7 * cuda_merge.TILE + 3, 0),
}


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("shape", sorted(B3_SHAPES))
def test_b3_kernel_matches_plain(cuda, shape, dup, implicit):
    rng = np.random.default_rng(len(shape) + 2 * dup)
    keys, pay, bounds = sorted_runs(rng, B3_SHAPES[shape], dup)
    keys = keys.to(cuda)
    pay = None if implicit else pay.to(cuda)
    before = cuda_merge.merge.launches
    got = cuda_merge.merge(keys, pay, bounds)
    torch.cuda.synchronize()
    assert cuda_merge.merge.launches == before + 1
    want = cuda_merge.plain(keys, pay, bounds)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("implicit", [False, True])
def test_b3_one_key_across_tiles(cuda, implicit):
    """A run of one repeated key (the all-ones k-mer's) over several tiles
    on both sides: every tile boundary falls inside the run, and ties go
    by payload, A's first; the wrapper counts one merge and its rows."""
    rng = np.random.default_rng(17)
    lens = (3 * cuda_merge.TILE + 5, 2 * cuda_merge.TILE + 7)
    keys = torch.full((sum(lens),), 2 ** 63 - 1, dtype=torch.int64)
    pay = torch.from_numpy(np.concatenate([np.sort(rng.integers(
        0, 2 ** 32, size=n, dtype=np.uint64)).astype(np.uint32)
        for n in lens]).view(np.int32).copy())
    bounds = np.concatenate([[0], np.cumsum(lens)])
    keys = keys.to(cuda)
    pay = None if implicit else pay.to(cuda)
    launches, rows = cuda_merge.merge.launches, cuda_merge.merge.rows
    got = cuda_merge.merge(keys, pay, bounds)
    assert cuda_merge.merge.launches == launches + 1
    assert cuda_merge.merge.rows == rows + sum(lens)
    want = cuda_merge.plain(keys, pay, bounds)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_b3_payloads_above_2_31_at_the_last_sort_round(cuda):
    """The 2^26 sort round's last merge with five keys and uniform 32-bit
    payloads: half of them are >= 2^31 and must order as unsigned."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(26)
    n = 1 << 26
    five = torch.from_numpy((FIVE_KEYS ^ SIGN).view(np.int64)).to(cuda)
    keys = five[torch.randint(0, 5, (n,), generator=gen, device=cuda)]
    pay = torch.randint(-(1 << 31), 1 << 31, (n,), generator=gen,
                        device=cuda, dtype=torch.int32)
    k2, p2 = lex_sort(keys.reshape(2, -1), pay.reshape(2, -1))
    keys, pay = k2.reshape(-1), p2.reshape(-1)
    del k2, p2
    bounds = (0, n // 2, n)
    got = cuda_merge.merge(keys, pay, bounds)
    want = cuda_merge.plain(keys, pay, bounds)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((unsigned_pay(got[1]) >= 2 ** 31).any())


SORT_ROUND_INPUTS = ("index payload", "five keys", "one key", "A before B",
                     "B before A")


def sort_round_input(gen, dev, kind):
    """(keys, payload) of 2^26 rows as two sorted runs of 2^25 (the last
    round of a 2^26-row sort): random keys with a tenth of the windows
    invalid and the k = 32 index payload, (invalid << 31) | position;
    five keys with that payload shuffled; the all-ones key alone with
    uniform 32-bit payloads, so the payload orders every row; random keys
    whose every A row sorts before every B row, and the same runs swapped."""
    n = SORT_N
    ones = 2 ** 63 - 1  # the raw all-ones pattern (all-G, invalid), sortable
    i32 = dict(generator=gen, device=dev, dtype=torch.int32)
    rand64 = ((torch.randint(-(1 << 31), 1 << 31, (n,), generator=gen,
                             device=dev) << 32)
              | torch.randint(0, 1 << 32, (n,), generator=gen, device=dev))
    pos = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    if kind in ("index payload", "five keys"):
        if kind == "index payload":
            invalid = torch.rand(n, generator=gen, device=dev) < 0.1
            keys = torch.where(invalid, ones, rand64)
        else:
            five = torch.from_numpy((FIVE_KEYS ^ SIGN).view(np.int64)).to(dev)
            keys = five[torch.randint(0, 5, (n,), generator=gen, device=dev)]
            invalid = keys == ones
        pay = torch.where(invalid, pos | torch.iinfo(torch.int32).min, pos)
        if kind == "five keys":
            pay = pay[torch.randperm(n, generator=gen, device=dev)]
    elif kind == "one key":
        keys = torch.full((n,), ones, dtype=torch.int64, device=dev)
        pay = torch.randint(-(1 << 31), 1 << 31, (n,), **i32)
    else:
        k, p = lex_sort(rand64, torch.randint(-(1 << 31), 1 << 31, (n,),
                                              **i32))
        if kind == "B before A":
            k, p = k.roll(n // 2), p.roll(n // 2)
        return k, p
    k, p = lex_sort(keys.reshape(2, -1), pay.reshape(2, -1))
    return k.reshape(-1), p.reshape(-1)


@pytest.mark.parametrize("kind", SORT_ROUND_INPUTS)
def test_b3_at_the_sort_round_shape_matches_plain(cuda, kind):
    """B3 with an explicit payload at a sort round's shape, 2 x 2^25 rows,
    against its plain version on the card: one launch, the same keys and
    payloads, one run sorted by (key, unsigned payload)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(SORT_ROUND_INPUTS.index(kind))
    keys, pay = sort_round_input(gen, cuda, kind)
    bounds = (0, SORT_N // 2, SORT_N)
    before = cuda_merge.merge.launches
    got = cuda_merge.merge(keys, pay, bounds)
    assert cuda_merge.merge.launches == before + 1
    want = cuda_merge.plain(keys, pay, bounds)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    del want
    k, q = got[0], unsigned_pay(got[1])
    assert bool(((k[1:] > k[:-1])
                 | ((k[1:] == k[:-1]) & (q[1:] >= q[:-1]))).all())


def test_b3_rejects_what_it_does_not_take(cuda):
    k = torch.zeros(64, dtype=torch.int64, device=cuda)
    p = torch.zeros(64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        cuda_merge.merge(k[::2], None, (0, 16, 32))
    with pytest.raises(ValueError):
        cuda_merge.merge(k, p.cpu(), (0, 32, 64))
    with pytest.raises(TypeError):
        cuda_merge.merge(k.int(), p, (0, 32, 64))
    with pytest.raises(ValueError):
        cuda_merge.merge(k, p, (0, 32, 63))


@pytest.mark.parametrize("counts_n", [1, 3])
def test_two_run_store_merge_on_card_matches_cpu(cuda, counts_n):
    rng = np.random.default_rng(counts_n)
    pool = np.unique(rng.integers(-2 ** 63, 2 ** 63 - 1, size=60_000))
    runs = []
    for n in (40_000, 25_000):
        keys = np.sort(rng.choice(pool, size=n, replace=False))
        cnt = rng.integers(0, 1000, size=(n, counts_n))
        runs.append((torch.from_numpy(keys), torch.from_numpy(cnt)))
    before = cuda_merge.merge.launches
    g = count_store.merge_runs([(k.to(cuda), c.to(cuda)) for k, c in runs])
    assert cuda_merge.merge.launches == before + 1
    c = count_store.merge_runs(runs)
    assert torch.equal(g[0].cpu(), c[0]) and torch.equal(g[1].cpu(), c[1])
    assert int(g[1].sum()) == sum(int(r[1].sum()) for r in runs)


def threshold_file(tmp_path, rng, k):
    seq, qual, lengths = read_batch(rng, k, B=700, quals="uniform")
    has_qual = np.arange(700) % 9 != 4
    path = tmp_path / "reads.fq"
    with open(path, "wb") as f:
        for i in range(700):
            s, q = seq[i, :lengths[i]], qual[i, :lengths[i]]
            if has_qual[i] and lengths[i]:
                f.write(b"@r\n" + s.tobytes() + b"\n+\n" + q.tobytes()
                        + b"\n")
            elif lengths[i]:
                f.write(b">r\n" + s.tobytes() + b"\n")
    return str(path), seq[3]


@pytest.mark.parametrize("entry", ["count_kmers_fq", "count_kmers_fq_sh"])
def test_threshold_entries_on_card_match_cpu(cuda, entry, tmp_path,
                                             monkeypatch):
    k = 11
    monkeypatch.setattr(counting, "BATCH_ROWS", 100)  # several tier merges
    path, probe = threshold_file(tmp_path, np.random.default_rng(2), k)
    before = cuda_merge.merge.launches
    g = getattr(api, entry)(path, k=k, min_q=12, device=cuda)
    assert cuda_merge.merge.launches == (
        before + g.timings["tier_merges"] + g.timings["fold_merges"])
    assert g.timings["tier_merges"] >= 2
    c = getattr(api, entry)(path, k=k, min_q=12, device="cpu")
    assert torch.equal(g.keys.cpu(), c.keys)
    assert torch.equal(g.cnt.cpu(), c.cnt)
    np.testing.assert_array_equal(api.kmer_spectrum(g, 50),
                                  api.kmer_spectrum(c, 50))
    for semantics in ("intent", "c"):
        assert torch.equal(
            api.seq_kmer_depth(g, probe, k, semantics=semantics).cpu(),
            api.seq_kmer_depth(c, probe, k, semantics=semantics))


# -- the probe kernels P1-P4 ---------------------------------------------------

def rand32(rng, shape):
    return torch.from_numpy(rng.integers(
        0, 2 ** 32, size=shape, dtype=np.uint32).view(np.int32))


# a block of P1 copies _T elements on the 16-byte path, _T / 4 on the
# 4-byte path
_T = cuda_probes.COPY_TILE


@pytest.mark.parametrize("n", [
    1 << 20, (1 << 20) + 3, 5, 1, 3, 4, _T // 4 - 1, _T // 4, _T // 4 + 1,
    _T - 1, _T, _T + 1, 2 * _T + 5, 1000 * _T - 1, 1000 * _T + 2,
    (1 << 24) + 7])
@pytest.mark.parametrize("skew", [0, 1, 2])
def test_p1_kernel_matches_plain(cuda, n, skew):
    """16-byte path, the n % 4 tail, and views that start 4 and 8 bytes into
    a tensor (no 16-byte alignment: the 4-byte path); n one below, at and
    above a block's tile of each path, and many tiles."""
    x = rand32(np.random.default_rng(n), n + skew).to(cuda)[skew:]
    before = cuda_probes.copy.launches
    got = cuda_probes.copy(x)
    torch.cuda.synchronize()
    assert cuda_probes.copy.launches == before + 1
    assert torch.equal(got, cuda_probes.plain_copy(x))
    assert got.data_ptr() != x.data_ptr()


@pytest.mark.parametrize("granule", [1024, 8, 1])
def test_p2_kernel_matches_plain(cuda, granule):
    n = 1 << 20
    x = rand32(np.random.default_rng(granule), n).to(cuda)
    for offs in (sort_probes.reference_offsets(n, granule),
                 sort_probes.spread_offsets(n, granule, n // cuda_probes.CH),
                 np.array([0, n - cuda_probes.CH, 1, 2, 3, 5], np.int32)):
        offs = torch.from_numpy(offs).to(cuda)
        before = cuda_probes.dyn_copy.launches
        got = cuda_probes.dyn_copy(x, offs)
        torch.cuda.synchronize()
        assert cuda_probes.dyn_copy.launches == before + 1
        assert torch.equal(got, cuda_probes.plain_dyn_copy(x, offs))


def test_p2_reads_nothing_outside_x(cuda):
    """An offset outside [0, n - CH] is the caller's error; the kernel still
    reads no element outside x: those come out 0."""
    n = 2 * cuda_probes.CH
    x = rand32(np.random.default_rng(0), n).to(cuda)
    offs = torch.tensor([n - 5, -3], dtype=torch.int32, device=cuda)
    got = cuda_probes.dyn_copy(x, offs).cpu().reshape(2, -1)
    torch.cuda.synchronize()
    assert torch.equal(got[0, :5], x[-5:].cpu()) and not got[0, 5:].any()
    assert not got[1, :3].any()
    assert torch.equal(got[1, 3:], x[: cuda_probes.CH - 3].cpu())


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("tile", [(64, 128), (8, 16), (1, 4)])
def test_p3_p4_kernel_matches_plain(cuda, tile, flat):
    rng = np.random.default_rng(tile[0] + flat)
    n = tile[0] * tile[1]
    shifts = np.concatenate([
        [0, 1, n - 1, n, n + 3, -1, -n - 5, 2 ** 31 - 1, -2 ** 31, 5, 777],
        rng.integers(-3 * n, 3 * n, size=200)]).astype(np.int32)
    x = rand32(rng, (len(shifts),) + tile).to(cuda)
    sh = torch.from_numpy(shifts).to(cuda)
    fn, plain = ((cuda_probes.roll_flat, cuda_probes.plain_roll_flat) if flat
                 else (cuda_probes.roll_rows, cuda_probes.plain_roll_rows))
    before = fn.launches
    got = fn(x, sh)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(got, plain(x, sh))
    one = fn(x[3], sh[3:4])  # a single tile, as the TPU probe ran it
    assert torch.equal(one, got[3])


def test_probes_reject_what_they_do_not_take(cuda):
    x = torch.zeros((4, 64, 128), dtype=torch.int32, device=cuda)
    sh = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        cuda_probes.copy(x.float())
    with pytest.raises(ValueError):
        cuda_probes.copy(x.transpose(1, 2))
    with pytest.raises(ValueError):
        cuda_probes.roll_rows(x, sh.cpu())
    with pytest.raises(ValueError):  # 3 elements: no multiple of 4
        cuda_probes.roll_flat(x[:, :1, :3].contiguous(), sh)
    with pytest.raises(ValueError):  # a tile above 32 KB
        cuda_probes.roll_flat(x.reshape(2, 128, 128), sh[:2])
    with pytest.raises(ValueError):
        cuda_probes.dyn_copy(x.reshape(-1), sh.cpu())


def test_probe_entry_point_on_the_card(cuda, capsys):
    res = sort_probes.run(20, device=cuda)
    out = capsys.readouterr().out
    assert out.count("ok=True") == 14 and "ok=False" not in out
    assert res["E1"]["gbs"] > 0


# -- spill, the ranged fold and drop on the card -------------------------------

def spill_batches(seed, k, n_batches=8, size=40_000):
    rng = np.random.default_rng(seed)
    top = (1 << (2 * k)) - 1
    pool = rng.integers(0, top, size=100_000, dtype=np.uint64, endpoint=True)
    pool[0] = top
    for b in range(n_batches):
        idx = rng.integers(0, len(pool), size=size)
        idx[0] = 0
        yield torch.from_numpy(pool[idx].view(np.int64)), b % 2


@pytest.mark.parametrize("how", ["memory", "disk", "ranged"])
@pytest.mark.parametrize("k", [21, 32])
def test_spilled_store_on_card_matches_cpu(cuda, k, how, tmp_path,
                                           monkeypatch):
    """A card store that spills (through the pinned staging buffers, several
    chunks per run) and rejoins, one run at a time or by key range, equals
    the CPU's store and an eager card store, bitwise."""
    monkeypatch.setattr(count_store, "_STAGE_BYTES", 1 << 16)
    if how == "ranged":
        monkeypatch.setenv("KMH_FOLD_BUDGET_BYTES", str(1 << 20))
    stores = []
    for dev in (cuda, "cpu"):
        st = api.CountStore(
            k, counts_n=2, spill_bytes=1 << 20, device=dev,
            spill_dir=str(tmp_path / str(dev)) if how == "disk" else None)
        st.run_build_size = 1 << 15
        before = cuda_merge.merge.launches
        for raw, source in spill_batches(k, k):
            st.add_kmers(raw, torch.ones_like(raw, dtype=torch.bool),
                         source=source, defer=True)
        assert st.timings["spills"] >= 2
        st.flush()
        tm = st.timings
        assert tm["ranged_folds"] == int(how == "ranged")
        if how == "ranged":
            assert tm["ranges"] >= 4
            assert tm["range_rounds"] >= tm["ranges"]
        if dev == cuda:
            assert st.keys.is_cuda and cuda_merge.merge.launches == (
                before + tm["tier_merges"] + tm["fold_merges"]
                + tm["range_rounds"])
        stores.append(st)
    g, c = stores
    eager = api.CountStore(k, counts_n=2, device=cuda)
    for raw, source in spill_batches(k, k):
        eager.add_kmers(raw, torch.ones_like(raw, dtype=torch.bool),
                        source=source)
    for other in (c, eager):
        assert torch.equal(g.keys.cpu(), other.keys.cpu())
        assert torch.equal(g.cnt.cpu(), other.cnt.cpu())
        np.testing.assert_array_equal(g.total_added, other.total_added)
    assert not list(tmp_path.glob("*/kmh_spill_*"))


def test_range_pass_on_card_stays_within_the_fold_budget(cuda,
                                                         monkeypatch):
    """A ranged fold of six overlapping spilled runs of 2,000,000 rows,
    each range's six slices merged in one pass of three B3 rounds: the
    pass adds at most the fold budget to the card's allocated bytes, B3
    runs ``range_rounds`` times, and the table is bitwise an unspilled
    card store's."""
    budget = 64 << 20
    rng = np.random.default_rng(27)
    pool = np.unique(rng.integers(-2 ** 63, 2 ** 63 - 1, size=6_000_000,
                                  dtype=np.int64))
    st = api.CountStore(32, spill_bytes=0, fold_budget_bytes=budget,
                        device=cuda)
    plain = api.CountStore(32, device=cuda)
    for _ in range(6):
        keys = torch.from_numpy(np.sort(rng.choice(pool, 2_000_000,
                                                   replace=False)))
        cnt = torch.from_numpy(rng.integers(1, 50, size=(2_000_000, 1)))
        for store in (st, plain):
            store.add_run(keys, cnt, int(cnt.sum()))
    plain.flush()
    assert len(st._spilled) == 6 and not st._runs
    grown = []
    merge_range = count_store.CountStore._merge_range

    def measured(self, parts):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = merge_range(self, parts)
        torch.cuda.synchronize()
        grown.append(torch.cuda.max_memory_allocated() - held)
        return out

    monkeypatch.setattr(count_store.CountStore, "_merge_range", measured)
    before = cuda_merge.merge.launches
    st.flush()
    tm = st.timings
    assert tm["ranged_folds"] == 1 and tm["ranges"] == len(grown) >= 4
    assert tm["fold_merges"] == 0 and tm["range_rounds"] == 3 * tm["ranges"]
    assert cuda_merge.merge.launches == before + tm["range_rounds"]
    assert 0 < max(grown) <= budget
    assert torch.equal(st.keys, plain.keys) and torch.equal(st.cnt, plain.cnt)


def test_store_without_spill_launches_b3_per_two_run_merge(cuda):
    """A store with no ``spill_bytes`` never enters the range pass: its
    tier merges and its fold launch B3 once per two-run merge."""
    st = api.CountStore(21, counts_n=2, device=cuda)
    st.run_build_size = 1 << 15
    before = cuda_merge.merge.launches
    for raw, source in spill_batches(21, 21):
        st.add_kmers(raw, torch.ones_like(raw, dtype=torch.bool),
                     source=source, defer=True)
    st.flush()
    tm = st.timings
    assert tm["tier_merges"] >= 2 and tm["folds"] == 1
    assert tm["spills"] == tm["ranged_folds"] == tm["range_rounds"] == 0
    assert cuda_merge.merge.launches == (
        before + tm["tier_merges"] + tm["fold_merges"])


def test_drop_store_on_card_matches_cpu(cuda, tmp_path):
    rng = np.random.default_rng(8)
    path, _probe = threshold_file(tmp_path, rng, 11)
    kw = dict(mode="ktree", prefix_bits=10, suffix_bits=12,
              max_size_bytes=300 * (4 << 12), budget_semantics="drop")
    stores = [api.count_kmers_fq(path, k=11, min_q=12,
                                 store=api.CountStore(11, device=dev, **kw))
              for dev in (cuda, "cpu")]
    g, c = stores
    assert g.keys.is_cuda and g._admit_frozen and g.n_alloc_blocks() == 300
    assert torch.equal(g.keys.cpu(), c.keys) and torch.equal(g.cnt.cpu(), c.cnt)
    np.testing.assert_array_equal(g.total_added, c.total_added)
    np.testing.assert_array_equal(g._admitted, c._admitted)
    np.testing.assert_array_equal(api.kmer_spectrum(g, 50),
                                  api.kmer_spectrum(c, 50))


# -- the round-3 probes P5-P8 and the command line on the card -----------------

def dev32(a, dev):
    return torch.from_numpy(np.asarray(a).view(np.int32).copy()).to(dev)


@pytest.mark.parametrize("case", ["ref 512", "ref 8", "overlap", "chain",
                                  "odd r", "outside", "spread"])
def test_p5_kernel_matches_plain(cuda, case):
    """P5 equals the sequential plain version bitwise, with write windows
    that overlap (the TPU probe's own 64 steps of 512 rows do), chains of
    windows one row apart, repeats, R off the kernel's 128-row chunk, and
    steps whose window lies outside x."""
    rng = np.random.default_rng(55)
    rows = 1 << 12
    x = rng.integers(0, 2 ** 32, size=(rows, 128), dtype=np.uint32)
    r, offs = {
        "ref 512": (512, sort_probes_r3.reference_row_offsets(rows, 512, 64)),
        "ref 8": (8, sort_probes_r3.reference_row_offsets(rows, 8, 64)),
        "overlap": (300, rng.integers(0, 1200, size=500)),
        "chain": (130, np.arange(400) % 350),
        "odd r": (1, rng.integers(0, 64, size=300)),
        "outside": (200, np.array([0, 100, 3897, -1, 3896, 2 ** 31 - 1, 300,
                                   -2 ** 31, 4096, 150])),
        "spread": (8, sort_probes_r3.spread_row_offsets(rows, 8)),
    }[case]
    xs, os_ = dev32(x, cuda), torch.from_numpy(
        np.asarray(offs).astype(np.int32)).to(cuda)
    before = cuda_probes_r3.dyn_copy_2d.launches
    got = cuda_probes_r3.dyn_copy_2d(xs, os_, r)
    torch.cuda.synchronize()
    assert cuda_probes_r3.dyn_copy_2d.launches == before + 1
    want = cuda_probes_r3.plain_dyn_copy_2d(xs, os_, r)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), cuda_probes_r3.dyn_copy_2d(
        xs.cpu(), os_.cpu(), r))
    if case != "outside":
        assert bool(got.any())


@pytest.mark.parametrize("rows", [33, 4096, 5000])
def test_p5_writes_zeros_on_dirty_memory(cuda, rows):
    """Rows no step writes come out zero though the output is not
    zero-filled: each call comes right after a tensor of the same size full
    of -1 was freed, so the caching allocator hands that block out again.
    Three windows of rows // 7 rows leave rows unowned; no step at all
    leaves every row so."""
    rng = np.random.default_rng(rows)
    x = dev32(rng.integers(0, 2 ** 32, size=(rows, 128), dtype=np.uint32),
              cuda)
    r = rows // 7
    offs = rng.integers(0, rows - r + 1, size=3).astype(np.int32)
    assert (sort_probes_r3.sequential_source_rows(rows, offs, r) < 0).any()
    offs = torch.from_numpy(offs).to(cuda)
    for o in (offs, offs[:0]):
        dirty = torch.full_like(x, -1)
        del dirty
        got = cuda_probes_r3.dyn_copy_2d(x, o, r)
        torch.cuda.synchronize()
        assert torch.equal(got, cuda_probes_r3.plain_dyn_copy_2d(x, o, r))
    assert not bool(got.any())


@pytest.mark.parametrize("n_rec", [1, 7, 8, 4096, 10_001])
def test_p6_kernel_matches_plain(cuda, n_rec):
    rng = np.random.default_rng(66)
    rows = 1 << 13
    x = dev32(rng.integers(0, 2 ** 32, size=(rows, 128), dtype=np.uint32),
              cuda)
    offs = rng.integers(0, rows - 3, size=n_rec).astype(np.int32)
    offs[:3] = (0, rows - 4, rows - 3)[: min(3, n_rec)]  # the last: outside
    offs[-1] = -1 if n_rec > 4 else offs[-1]
    offs = torch.from_numpy(offs).to(cuda)
    before = cuda_probes_r3.small_copy.launches
    got = cuda_probes_r3.small_copy(x, offs)
    torch.cuda.synchronize()
    assert cuda_probes_r3.small_copy.launches == before + 1
    assert torch.equal(got, cuda_probes_r3.plain_small_copy(x, offs))


@pytest.mark.parametrize("granule", [1024, 8, 1])
def test_p7_kernel_matches_plain_and_p2(cuda, granule):
    rng = np.random.default_rng(77)
    n = 1 << 20
    x = dev32(rng.integers(0, 2 ** 32, size=n, dtype=np.uint32), cuda)
    offs = np.concatenate([
        sort_probes.reference_offsets(n, granule),
        sort_probes.spread_offsets(n, granule, n // cuda_probes.CH),
        np.array([0, n - cuda_probes.CH, 1, 2, 3, -5, n - 100, 2 ** 31 - 1],
                 np.int32)])
    offs = torch.from_numpy(offs).to(cuda)
    before = cuda_probes_r3.async_copy.launches
    got = cuda_probes_r3.async_copy(x, offs)
    torch.cuda.synchronize()
    assert cuda_probes_r3.async_copy.launches == before + 1
    assert torch.equal(got, cuda_probes.dyn_copy(x, offs))  # P2, edges too
    inside = (offs >= 0) & (offs <= n - cuda_probes.CH)
    assert torch.equal(
        got.reshape(-1, cuda_probes.CH)[inside],
        cuda_probes_r3.plain_async_copy(x, offs[inside]).reshape(
            -1, cuda_probes.CH))
    # a view off the 16-byte boundary: every window takes the 4-byte copies
    assert torch.equal(cuda_probes_r3.async_copy(x[1:], offs[:64]),
                       cuda_probes_r3.plain_async_copy(x[1:], offs[:64]))


@pytest.mark.parametrize("n", [4, 128, 1 << 12, (1 << 20) + 4, 1 << 22])
def test_p8_kernel_matches_plain(cuda, n):
    rng = np.random.default_rng(88)
    tab = dev32(rng.integers(0, 2 ** 32, size=(8, 128), dtype=np.uint32),
                cuda)
    idx = rng.integers(0, 1024, size=n).astype(np.int32)
    idx[:: 97] = rng.integers(-2 ** 31, 2 ** 31, size=len(idx[:: 97]))
    idx[:4] = (0, 1023, 1024, -1)
    idx = torch.from_numpy(idx).to(cuda)
    before = cuda_probes_r3.smem_gather.launches
    got = cuda_probes_r3.smem_gather(tab, idx)
    torch.cuda.synchronize()
    assert cuda_probes_r3.smem_gather.launches == before + 1
    assert torch.equal(got, cuda_probes_r3.plain_smem_gather(tab, idx))
    assert got[2].item() == 0 and got[3].item() == 0
    assert got[1].item() == tab.reshape(-1)[1023].item()


def test_r3_probes_reject_what_they_do_not_take(cuda):
    x = torch.zeros((64, 128), dtype=torch.int32, device=cuda)
    offs = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        cuda_probes_r3.dyn_copy_2d(x, offs.cpu(), 8)
    with pytest.raises(ValueError):
        cuda_probes_r3.dyn_copy_2d(x.t().contiguous().t(), offs, 8)
    with pytest.raises(TypeError):
        cuda_probes_r3.small_copy(x.float(), offs)
    with pytest.raises(ValueError):
        cuda_probes_r3.async_copy(x.reshape(-1), offs.cpu())
    with pytest.raises(ValueError):  # 3 indices: no multiple of 4
        cuda_probes_r3.smem_gather(x[:8], offs[:3])
    with pytest.raises(ValueError):
        cuda_probes_r3.smem_gather(x[:8], offs.cpu())


def test_r3_probe_entry_point_on_the_card(cuda, capsys):
    res = sort_probes_r3.run(20, device=cuda)
    out = capsys.readouterr().out
    assert out.count("ok=True") == 17 and "ok=False" not in out
    assert res["R2"][0]["ref"]["rows_written"] < 64 * 512


def test_cli_count_on_card_matches_cpu(cuda, tmp_path, capsys):
    """The count verb on the card (uploads through the pinned buffers) and
    with --device cpu: one store."""
    import json

    from kmer_hasher_tpu_torch import __main__ as cli
    from kmer_hasher_tpu_torch.utils import checkpoint

    rng = np.random.default_rng(99)
    path, _probe = threshold_file(tmp_path, rng, 11)
    infos = {}
    for dev in ("cuda", "cpu"):
        capsys.readouterr()
        cli.main(["count", path, "-k", "11", "--min-q", "12", "--ll-mode",
                  "hybrid", "--batch-rows", "100", "-o",
                  str(tmp_path / f"{dev}.npz"), "--device", dev])
        infos[dev] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        infos[dev].pop("out")
    assert infos["cuda"] == infos["cpu"]
    g, c = (checkpoint.load_count_store(tmp_path / f"{dev}.npz", device="cpu")
            for dev in ("cuda", "cpu"))
    assert g.n_unique > 0 and torch.equal(g.keys, c.keys)
    assert torch.equal(g.cnt, c.cnt)


# -- the DMA probes P9, P10 and the sharded store on the card -------------------

@pytest.mark.parametrize("case", ["tpu 512", "tpu 64", "tpu 8", "static 512",
                                  "static 8", "static odd", "overlap",
                                  "outside", "one step", "odd r", "small"])
def test_p9_kernel_matches_plain(cuda, case):
    """P9 (and D2, offs=None) equals the sequential plain version bitwise:
    the TPU probe's permutations at 512, 64 and 8 rows over 2^24 elements,
    D2 with rows that R divides and does not, overlapping write windows,
    steps outside x, one step, R off the 32-row chunk, a tiny x."""
    rng = np.random.default_rng(99)
    rows = 1 << 17
    x = dev32(rng.integers(0, 2 ** 32, size=(rows, 128), dtype=np.uint32),
              cuda)
    r, offs = {
        "tpu 512": (512, dma_probes_r3.window_offsets(rows, 512)),
        "tpu 64": (64, dma_probes_r3.window_offsets(rows, 64)),
        "tpu 8": (8, dma_probes_r3.window_offsets(rows, 8)),
        "static 512": (512, None),
        "static 8": (8, None),
        "static odd": (777, None),
        "overlap": (100, rng.integers(0, 3000, size=2000)),
        "outside": (200, np.array([0, 100, rows - 200, -1, rows - 199,
                                   2 ** 31 - 1, 300, -2 ** 31, rows, 150])),
        "one step": (rows, np.array([0])),
        "odd r": (45, rng.integers(0, 5000, size=3000)),
        "small": (3, np.array([0, 1, 2, 0])),
    }[case]
    if case == "small":
        x = x[:5]
    os_ = None if offs is None else torch.from_numpy(
        np.asarray(offs).astype(np.int32)).to(cuda)
    before = cuda_probes_dma.pipelined_copy.launches
    got = cuda_probes_dma.pipelined_copy(x, os_, r)
    torch.cuda.synchronize()
    assert cuda_probes_dma.pipelined_copy.launches == before + 1
    want = cuda_probes_dma.plain_pipelined_copy(x, os_, r)
    assert torch.equal(got, want)
    if os_ is not None:
        assert torch.equal(got, cuda_probes_r3.dyn_copy_2d(x, os_, r))


# P10 deals tasks of LANE_TASK rows round robin over 33 row groups on an
# H100 (132 SMs, one block each, 4 column slabs)
_R, _GR = cuda_probes_dma.LANE_TASK, 132 // 4


@pytest.mark.parametrize("rows", [
    1, 7, 512, 8192, 8193, 1 << 16, _R - 1, _R, _R + 1, _GR * _R - 1,
    _GR * _R, _GR * _R + 1, 2 * _GR * _R + 3, 32 * _GR * _R + 1])
@pytest.mark.parametrize("skew", [0, 1])
def test_p10_kernel_matches_plain(cuda, rows, skew):
    """Rows one below, at and above a task, one round of tasks over the
    row groups and several; indices outside the table at both ends; with
    skew the table starts 4 bytes into a tensor (no bulk copies)."""
    rng = np.random.default_rng(1010)
    tab = dev32(rng.integers(0, 2 ** 32, size=1024 * 128 + skew,
                             dtype=np.uint32), cuda)[skew:].reshape(1024, 128)
    idx = rng.integers(0, 1024, size=(rows, 128)).astype(np.int32)
    idx.reshape(-1)[:: 89] = rng.integers(-2 ** 31, 2 ** 31,
                                          size=len(idx.reshape(-1)[:: 89]))
    idx[0, :4] = (0, 1023, 1024, -1)
    idx[-1, -4:] = (-2 ** 31, 2 ** 31 - 1, 1024, 1023)
    idx = torch.from_numpy(idx).to(cuda)
    before = cuda_probes_dma.lane_gather.launches
    got = cuda_probes_dma.lane_gather(tab, idx)
    torch.cuda.synchronize()
    assert cuda_probes_dma.lane_gather.launches == before + 1
    assert torch.equal(got, cuda_probes_dma.plain_lane_gather(tab, idx))
    assert got[0, 2].item() == 0 and got[0, 3].item() == 0
    assert got[0, 1].item() == tab[1023, 1].item()


def test_dma_probes_reject_what_they_do_not_take(cuda):
    x = torch.zeros((64, 128), dtype=torch.int32, device=cuda)
    offs = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        cuda_probes_dma.pipelined_copy(x, offs.cpu(), 8)
    with pytest.raises(ValueError):
        cuda_probes_dma.pipelined_copy(x.t().contiguous().t(), None, 8)
    with pytest.raises(TypeError):
        cuda_probes_dma.pipelined_copy(x.float(), None, 8)
    tab = torch.zeros((1024, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        cuda_probes_dma.lane_gather(tab, x.cpu())
    with pytest.raises(ValueError):
        cuda_probes_dma.lane_gather(tab[:, :64].contiguous(), x)


def test_dma_probe_entry_point_on_the_card(cuda, capsys):
    before = (cuda_probes_dma.pipelined_copy.launches,
              cuda_probes_dma.lane_gather.launches)
    res = dma_probes_r3.run(20, device=cuda)
    out = capsys.readouterr().out
    assert out.count("ok=True") == 8 and "ok=False" not in out
    assert len(res["D1"]) == 3 and len(res["D2"]) == 1
    assert cuda_probes_dma.pipelined_copy.launches > before[0]
    assert cuda_probes_dma.lane_gather.launches > before[1]


@pytest.mark.parametrize("spill", [None, "memory", "disk"])
def test_sharded_store_on_card_matches_cpu(cuda, spill, tmp_path):
    """Eight logical shards on the card against the same store on the CPU
    and against one store: tables shard by shard, spectra, total_added;
    with a spill budget below one run, to memory and to files; and the
    checkpoint round trip onto 8 shards and into one store."""
    from kmer_hasher_tpu_torch.parallel import (ShardedCountStore,
                                                make_mesh)
    from kmer_hasher_tpu_torch.utils import checkpoint

    rng = np.random.default_rng(808)
    kw = {} if spill is None else {"spill_bytes": 8192}
    if spill == "disk":
        kw["spill_dir"] = str(tmp_path)
    stores = {dev: ShardedCountStore(21, make_mesh(8, device=dev), **kw)
              for dev in ("cuda", "cpu")}
    one = api.CountStore(21, device="cuda")
    batches = []
    for _ in range(6):
        rows, L = 2048, 151
        seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (rows, L))]
        qual = rng.integers(66, 74, (rows, L)).astype(np.uint8)
        batches.append((seq, qual, np.full(rows, L, np.int32),
                        np.ones(rows, bool)))
    for dev, st in stores.items():
        counting.count_batches(st, batches, 21, min_q=20, exact_ll="hybrid")
    counting.count_batches(one, batches, 21, min_q=20, exact_ll="hybrid")
    g, c = stores["cuda"], stores["cpu"]
    for a, b in zip(g.shards, c.shards):
        assert torch.equal(a.keys.cpu(), b.keys) and torch.equal(
            a.cnt.cpu(), b.cnt)
    keys = torch.cat([s.keys for s in g.shards])
    order = torch.sort(keys)
    assert torch.equal(order.values, one.keys)
    assert torch.equal(torch.cat([s.cnt for s in g.shards])[order.indices],
                       one.cnt)
    assert one.n_unique > 100_000 and g.timings["routes"] >= 6
    assert np.array_equal(g.spectrum(100), one.spectrum(100))
    assert np.array_equal(g.total_added, one.total_added)
    if spill is not None:
        assert g.shard_timings()["spills"] > 0
    p = tmp_path / "sh.npz"
    checkpoint.save_count_store(g, p)
    back = checkpoint.load_count_store(p, mesh=make_mesh(8, device="cuda"))
    assert all(torch.equal(a.keys, b.keys) for a, b in zip(back.shards,
                                                           g.shards))
    whole = checkpoint.load_count_store(p, device="cuda")
    assert torch.equal(whole.keys, one.keys) and torch.equal(whole.cnt,
                                                             one.cnt)


@pytest.mark.parametrize("k", [11, 16, 21, 32])  # k < 11: 10^9 pair rows
def test_sharded_index_on_card_matches_cpu(cuda, k):
    """The sharded index on 8 logical shards on the card against the same
    on the CPU: hash shards, splitters, range shards, tables, pair chunks,
    lookups, seq_kmer_pos and kmer_pairs_sharded, bitwise; one B1 launch a
    build."""
    from kmer_hasher_tpu_torch.parallel import (ShardedKmerIndex,
                                                kmer_pairs_sharded,
                                                make_mesh)

    rng = np.random.default_rng(900 + k)
    seq = random_seq(rng, 300_000, 40)
    seq[50_000:60_000] = seq[10_000:20_000]
    ix = {}
    for dev in ("cuda", "cpu"):
        before = cuda_encode.encode.launches
        ix[dev] = ShardedKmerIndex(seq, k, make_mesh(8, device=dev))
        assert cuda_encode.encode.launches == before + (dev == "cuda")
    g, c = ix["cuda"], ix["cpu"]
    assert (g.n_valid == c.n_valid).all() and g.total_kmers > 200_000
    for a, b in zip(g.shards, c.shards):
        assert a.s_key.is_cuda
        assert torch.equal(a.s_key.cpu(), b.s_key)
        assert torch.equal(a.s_pos.cpu(), b.s_pos)
    tg, tc = g.tables(15), c.tables(15)
    assert torch.equal(g._rp_spl.cpu(), c._rp_spl)
    assert tg["kmer"] == tc["kmer"]
    for f in ("pos", "pair.pos", "count"):
        assert torch.equal(tg[f].cpu(), tc[f]), f
    assert torch.equal(torch.cat(list(g.iter_pair_chunks(1 << 12))).cpu(),
                       tc["pair.pos"])
    q = c.shards[3].s_key[::7] ^ torch.iinfo(torch.int64).min
    assert torch.equal(g.lookup_counts(q).cpu(), c.lookup_counts(q))
    assert torch.equal(g.positions_of(q, 256).cpu(), c.positions_of(q, 256))
    if k <= 31:
        query = seq[40_000:70_000]
        assert torch.equal(g.seq_kmer_pos(query, k, 1 << 12).cpu(),
                           c.seq_kmer_pos(query, k, 1 << 12))
        bg = ShardedKmerIndex(query, k, g.mesh)
        bc = ShardedKmerIndex(query, k, c.mesh)
        assert torch.equal(kmer_pairs_sharded(g, bg, 1 << 12).cpu(),
                           kmer_pairs_sharded(c, bc, 1 << 12))


@pytest.mark.parametrize("k", [1, 2, 16, 17, 21, 31, 32])
def test_b1_sharded_build_rows(cuda, k):
    """B1 on the sharded build's batch: D rows of chunk + halo bytes that
    overlap by the halo, lengths from the host, some zero or negative (the
    chunks past the end), the last rows' halos in the N padding."""
    from kmer_hasher_tpu_torch.parallel.sharded import chunk_rows

    rng = np.random.default_rng(70 + k)
    for L, D, Lc in ((40, 8, 16), (5_000, 8, 1024), (70_000, 8, 16_384),
                     (9_000, 3, 4096)):
        seq = torch.from_numpy(random_seq(rng, L, 2))
        rows, lengths = chunk_rows(seq, D, Lc, k, cuda)
        assert rows.shape == (D, Lc + max(1, k - 1))
        assert (lengths <= 0).any() or L > (D - 1) * Lc
        key, valid = cuda_encode.encode(rows, k, lengths)
        pk, pv = cuda_encode.plain(rows, k, torch.from_numpy(lengths).to(
            cuda))
        assert torch.equal(key, pk) and torch.equal(valid, pv)
        assert not valid[torch.from_numpy(lengths <= 0).to(cuda)].any()


RANK_WORKER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from kmer_hasher_tpu_torch import api
from kmer_hasher_tpu_torch.parallel import make_mesh
rdzv, rank, fq, out = sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5]
api.init_distributed(rdzv, world_size=2, rank=rank)
mesh = make_mesh(8, distributed=True)
st = api.count_kmers_fq_sh_rp(fq, k=21, min_q=20, exact_ll="hybrid",
                              mesh=mesh, batch_rows=1024)
rec = {"device": str(st.device), "spectrum": st.spectrum(100).tolist(),
       "total": st.total_added.tolist(), "reads": st.timings["file_reads"]}
np.savez(out + f".r{rank}.npz", **{
    f"{c}{d}": t.cpu().numpy() for d, s in zip(mesh.local_shards, st.shards)
    for c, t in (("k", s.keys), ("c", s.cnt))})
print(json.dumps(rec))
"""


def test_two_ranks_on_the_card_match_one_process(cuda, tmp_path):
    """Two gloo ranks sharing the card count one FASTQ by byte ranges
    (route (b)) into 8 shards: every shard, the spectrum and total_added
    equal the one-process store on the card."""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    from kmer_hasher_tpu_torch.parallel import make_mesh

    rng = np.random.default_rng(911)
    rows, L = 6000, 151
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (rows, L))]
    qual = rng.integers(35, 74, (rows, L)).astype(np.uint8)
    fq = tmp_path / "r.fq"
    fq.write_bytes(b"".join(b"@r%d\n%s\n+\n%s\n" % (
        i, seq[i].tobytes(), qual[i].tobytes()) for i in range(rows)))
    repo = pathlib.Path(__file__).resolve().parent.parent
    (tmp_path / "w.py").write_text(RANK_WORKER)
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "w.py"), str(repo),
         f"file://{tmp_path / 'rdzv'}", str(r), str(fq),
         str(tmp_path / "out")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=dict(os.environ))
        for r in range(2)]
    try:
        res = [p.communicate(timeout=300) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("the ranks did not finish in 300 s")
    for p, (o, e) in zip(procs, res):
        assert p.returncode == 0, e[-3000:]
    one = api.count_kmers_fq_sh_rp(str(fq), k=21, min_q=20,
                                   exact_ll="hybrid", mesh=make_mesh(8),
                                   batch_rows=1024)
    recs = [json.loads(o.strip().splitlines()[-1]) for o, _e in res]
    assert sum(r["reads"] for r in recs) == rows
    for r in recs:
        assert r["device"].startswith("cuda")
        assert r["spectrum"] == one.spectrum(100).tolist()
        assert r["total"] == one.total_added.tolist()
    for rank in range(2):
        with np.load(tmp_path / f"out.r{rank}.npz") as z:
            for d in range(4 * rank, 4 * rank + 4):
                assert np.array_equal(z[f"k{d}"],
                                      one.shards[d].keys.cpu().numpy())
                assert np.array_equal(z[f"c{d}"],
                                      one.shards[d].cnt.cpu().numpy())


INDEX_RANK_WORKER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from kmer_hasher_tpu_torch import api
from kmer_hasher_tpu_torch.parallel import ShardedKmerIndex, make_mesh
rdzv, rank, seq_path, out = sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5]
api.init_distributed(rdzv, world_size=2, rank=rank)
seq = np.load(seq_path)
ix = ShardedKmerIndex(seq, 21, make_mesh(8, distributed=True))
tabs = ix.tables(15)
rows = ix.seq_kmer_pos(seq[40_000:70_000], 21, 1 << 12)
rec = {"device": str(ix.device), "kmer": tabs["kmer"],
       "n_valid": ix.n_valid.tolist()}
np.savez(out + f".r{rank}.npz", rows=rows.cpu().numpy(), **{
    f: tabs[f].cpu().numpy() for f in ("pos", "pair.pos", "count")}, **{
    f"{c}{d}": t.cpu().numpy() for d, s in zip(ix.mesh.local_shards, ix.shards)
    for c, t in (("k", s.s_key), ("p", s.s_pos))})
print(json.dumps(rec))
"""


def test_two_ranks_build_the_sharded_index_on_the_card(cuda, tmp_path):
    """Two gloo ranks sharing the card build the sharded index of 70,000
    bases on 8 shards (chunks of 2^14: rank 1's first chunk ends the
    sequence, its other three lie past the end): every rank's hash shards
    equal the one-process index's on the card, and every rank reads its
    tables(15) and a query's rows."""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    from kmer_hasher_tpu_torch.parallel import ShardedKmerIndex, make_mesh

    seq = random_seq(np.random.default_rng(912), 70_000, 2)
    np.save(tmp_path / "seq.npy", seq)
    repo = pathlib.Path(__file__).resolve().parent.parent
    (tmp_path / "w.py").write_text(INDEX_RANK_WORKER)
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "w.py"), str(repo),
         f"file://{tmp_path / 'rdzv'}", str(r), str(tmp_path / "seq.npy"),
         str(tmp_path / "out")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=dict(os.environ))
        for r in range(2)]
    try:
        res = [p.communicate(timeout=300) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("the ranks did not finish in 300 s")
    for p, (o, e) in zip(procs, res):
        assert p.returncode == 0, e[-3000:]
    one = ShardedKmerIndex(seq, 21, make_mesh(8))
    want = one.tables(15)
    rows = one.seq_kmer_pos(seq[40_000:70_000], 21, 1 << 12).cpu().numpy()
    recs = [json.loads(o.strip().splitlines()[-1]) for o, _e in res]
    for rank, r in enumerate(recs):
        assert r["device"].startswith("cuda")
        assert r["kmer"] == want["kmer"]
        assert r["n_valid"] == one.n_valid.tolist()
        with np.load(tmp_path / f"out.r{rank}.npz") as z:
            assert np.array_equal(z["rows"], rows)
            for f in ("pos", "pair.pos", "count"):
                assert np.array_equal(z[f], want[f].cpu().numpy()), f
            for d in range(4 * rank, 4 * rank + 4):
                assert np.array_equal(z[f"k{d}"],
                                      one.shards[d].s_key.cpu().numpy())
                assert np.array_equal(z[f"p{d}"],
                                      one.shards[d].s_pos.cpu().numpy())


def _spread_case(devices, tmp_path):
    """Counting batches and a sequence through 8 shards spread over
    ``devices`` and through 8 shards on the card, with B1 / B2 / B3
    launches counted per card over the spread group's build and count.
    Returns (spread store, logical store, spread index, logical index, the
    launches per card of each kernel)."""
    from kmer_hasher_tpu_torch.parallel import (ShardedCountStore,
                                                ShardedKmerIndex,
                                                make_mesh)

    rng = np.random.default_rng(1515)
    batches = []
    for _ in range(4):
        rows, L = 2053, 151  # padded to a multiple of 8 before dealing
        seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (rows, L))]
        qual = rng.integers(66, 74, (rows, L)).astype(np.uint8)
        low = rng.random((rows, L)) < 0.02  # borderline reads for hybrid
        qual[low] = rng.integers(35, 45, int(low.sum())).astype(np.uint8)
        batches.append((seq, qual, np.full(rows, L, np.int32),
                        np.ones(rows, bool)))
    seq = random_seq(rng, 300_000, 40)
    seq[50_000:60_000] = seq[10_000:20_000]
    wrappers = (cuda_encode.encode, cuda_scan.scan, cuda_merge.merge)
    for w in wrappers:
        w.by_device = {}
    spread = make_mesh(8, devices=devices)
    st = ShardedCountStore(21, spread)
    counting.count_batches(st, batches, 21, min_q=20, exact_ll="hybrid")
    st.flush()
    ix = ShardedKmerIndex(seq, 32, spread)
    per_card = [dict(w.by_device) for w in wrappers]
    logical = make_mesh(8, device="cuda")
    one = ShardedCountStore(21, logical)
    counting.count_batches(one, batches, 21, min_q=20, exact_ll="hybrid")
    return st, one, ix, ShardedKmerIndex(seq, 32, logical), per_card


def _assert_spread_equals_logical(st, one, ix, ixl, tmp_path):
    from kmer_hasher_tpu_torch.parallel import make_mesh
    from kmer_hasher_tpu_torch.utils import checkpoint

    st.flush()
    one.flush()
    for d, (a, b) in enumerate(zip(st.shards, one.shards)):
        assert a.keys.device == st.mesh.device_of(d)
        assert torch.equal(a.keys.cpu(), b.keys.cpu())
        assert torch.equal(a.cnt.cpu(), b.cnt.cpu())
    assert np.array_equal(st.spectrum(100), one.spectrum(100))
    assert np.array_equal(st.total_added, one.total_added)
    q = torch.cat([s.keys for s in one.shards])[::11] ^ torch.iinfo(
        torch.int64).min
    assert torch.equal(st.lookup(q).cpu(), one.lookup(q).cpu())
    p = tmp_path / "spread.npz"
    checkpoint.save_count_store(st, p)
    back = checkpoint.load_count_store(p, mesh=make_mesh(8, device="cuda"))
    assert all(torch.equal(a.keys, b.keys) for a, b in zip(back.shards,
                                                           one.shards))
    for d, (a, b) in enumerate(zip(ix.shards, ixl.shards)):
        assert a.s_key.device == ix.mesh.device_of(d)
        assert torch.equal(a.s_key.cpu(), b.s_key.cpu())
        assert torch.equal(a.s_pos.cpu(), b.s_pos.cpu())
    tg, tl = ix.tables(15), ixl.tables(15)
    assert tg["kmer"] == tl["kmer"]
    for f in ("pos", "pair.pos", "count"):
        assert tg[f].device == ix.mesh.device
        assert torch.equal(tg[f].cpu(), tl[f].cpu()), f
    q = ixl.shards[5].s_key[::7] ^ torch.iinfo(torch.int64).min
    assert torch.equal(ix.lookup_counts(q).cpu(), ixl.lookup_counts(q).cpu())
    assert torch.equal(ix.positions_of(q, 256).cpu(),
                       ixl.positions_of(q, 256).cpu())


def test_card_and_cpu_group_equals_the_logical_group(cuda, tmp_path):
    """8 shards over ["cuda:0", "cpu"] (4 on the card, 4 in host memory)
    against 8 logical shards on the card: store tables shard by shard,
    spectrum, lookups, the checkpoint, the index's shards, tables and
    lookups, bitwise; the card's half launches B1, B2 and B3."""
    st, one, ix, ixl, per_card = _spread_case(["cuda:0", "cpu"], tmp_path)
    assert [s.keys.device.type for s in st.shards] == ["cuda"] * 4 + [
        "cpu"] * 4
    assert one.n_unique.sum() > 100_000
    assert st.timings["exchange_bytes"] > 0
    _assert_spread_equals_logical(st, one, ix, ixl, tmp_path)
    b1, b2, b3 = per_card
    assert b1.get(0, 0) >= 1 and b2.get(0, 0) >= 4 and b3.get(0, 0) >= 1


def test_every_card_group_equals_the_logical_group(cuda, tmp_path):
    """8 shards over every visible card (as many as divide 8) against 8
    logical shards on one card, bitwise; B1, B2 and B3 launch on every
    card."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more cards; {n} visible")
    m = max(c for c in (1, 2, 4, 8) if c <= n)
    cards = [f"cuda:{i}" for i in range(m)]
    st, one, ix, ixl, per_card = _spread_case(cards, tmp_path)
    _assert_spread_equals_logical(st, one, ix, ixl, tmp_path)
    for name, counts in zip(("B1", "B2", "B3"), per_card):
        assert all(counts.get(i, 0) >= 1 for i in range(m)), (name, counts)
