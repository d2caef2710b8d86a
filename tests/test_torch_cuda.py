"""The CUDA kernels B1 and B2 against their plain PyTorch versions, and
the paths through them against the CPU, on the card.

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
from kmer_hasher_tpu_torch.ops import cuda_encode, cuda_scan
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


def read_batch(rng, k, B=300, L=151, quals="binned"):
    """A ragged batch: lengths 0, k, k+1, full and random."""
    seq = rng.choice(np.frombuffer(b"ACGTacgtN", np.uint8), size=(B, L))
    if quals == "binned":
        q = rng.choice(np.frombuffer(b"F:,#", np.uint8), size=(B, L),
                       p=[0.88, 0.08, 0.02, 0.02])
    else:
        q = (33 + rng.integers(0, 42, size=(B, L))).astype(np.uint8)
    lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
    lengths[:4] = (0, k, k + 1, L)
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
