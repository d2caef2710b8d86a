"""B1's CUDA kernel against its plain PyTorch version, on the card.

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
from kmer_hasher_tpu_torch.ops import cuda_encode

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
