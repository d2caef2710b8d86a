"""Each plain reference of ``port_bench/reference`` against the port at a
tiny size on the CPU. The test imports both; the references import
nothing of the program."""
from __future__ import annotations

import ast

import numpy as np
import pytest
import torch

from conftest import ROOT

CPU = torch.device("cpu")
REFS = sorted((ROOT / "port_bench" / "reference").glob("*.py"))


def ref(name):
    from port_bench.run import load_module

    return load_module(ROOT / "port_bench" / "reference" / f"{name}.py",
                       "port_bench.reference")


@pytest.mark.parametrize("path", REFS, ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "flax",
                                           "kmer_hasher_tpu",
                                           "kmer_hasher_tpu_torch"), n


def test_frozen_table_is_the_reference_table():
    from kmer_hasher_tpu_torch.qll import Q_TO_LL, derive_q_to_ll

    from port_bench.reference import common

    table = np.array(common.q_to_ll())
    assert np.array_equal(table, Q_TO_LL)
    # the formula agrees but for the last bits, which the filter needs
    assert np.allclose(table, derive_q_to_ll(), rtol=0, atol=1e-14)


def reads(seed, quals, rows=400, k=21):
    from port_bench import gen

    cfg = {"read_len": 151, "batch_rows": rows, "col_multiple": 8,
           "genome_len": 30_000, "batches": 2, "sub_rate": 0.005,
           "qual_bins": "F:,#", "qual_shares": [0.88, 0.08, 0.02, 0.02],
           "k": k, "min_q": 20, "max_count": 1000}
    if quals == "stress":  # phred 30-40 with 2% at 2-19: borderline sums
        cfg["qual_bins"] = "".join(chr(33 + q) for q in
                                   list(range(30, 41)) + list(range(2, 20)))
        cfg["qual_shares"] = [0.98 / 11] * 11 + [0.02 / 18] * 18
    return cfg, gen.read_batches(cfg, seed, CPU)


@pytest.mark.parametrize("k", [21, 31])
@pytest.mark.parametrize("quals", ["binned", "stress"])
def test_counting_reference_against_the_port(quals, k):
    from kmer_hasher_tpu_torch import api, counting

    cfg, batches = reads(11 + k, quals, k=k)
    store = api.CountStore(k, counts_n=1, mode="sh", device=CPU)
    counting.count_batches(store, batches, k, min_q=20, exact_ll="hybrid")
    got = store.counts_dict()
    keys, cnt = ref("wgs151_k21").count_table(batches, cfg, CPU)
    assert len(keys) > 1000
    assert dict(zip(keys.tolist(), cnt.tolist())) == {
        kk: v[0] for kk, v in got.items()}
    assert np.array_equal(ref("wgs151_k21").spectrum(cnt, 1000),
                          api.kmer_spectrum(store, 1000))


def test_counting_reference_forward_only_differs():
    cfg, batches = reads(5, "binned")
    r = ref("wgs151_k21")
    a = r.count_table(batches, cfg, CPU)
    b = r.count_table(batches, cfg, CPU, canonical=False)
    assert a[0].shape != b[0].shape or not np.array_equal(a[0], b[0])


def sequence(seed, n=60_000):
    from port_bench import gen

    cfg = {"seq_len": n, "alphabet": "ACGTacgt", "n_run_every": 4_000,
           "n_run_max": 119, "n_run_tail": 200, "repeat_at": 10_000,
           "repeat_unit": 300, "repeat_copies": 12}
    return gen.chromosome(cfg, seed, CPU)


@pytest.mark.parametrize("k", [5, 21, 32])
def test_index_reference_against_the_port(k):
    from kmer_hasher_tpu_torch import api

    seq = sequence(k)
    ix = api.make_kmer_hash(seq, k, device=CPU)
    t = api.kmer_pos(ix, 14)
    r = ref("chr21_k32").index_tables(seq, k, CPU)
    assert np.array_equal(t["pos"].numpy(), r["pos"])
    assert np.array_equal(t["count"].numpy(), r["count"])
    assert np.array_equal(t["pair.pos"].numpy(), r["pair.pos"])
    assert r["pair.pos"].shape[0] > 0


def test_index_trailing_window_quirk():
    from kmer_hasher_tpu_torch import api

    seq = np.frombuffer(b"ACGTNACGTTGCAN" + b"ACGTA", np.uint8).copy()
    r = ref("chr21_k32").index_tables(seq, 5, CPU)
    t = api.kmer_pos(api.make_kmer_hash(seq, 5, device=CPU), 10)
    assert np.array_equal(t["pos"].numpy(), r["pos"])
    assert 15 not in r["pos"][:, 1]  # the last window follows an N


@pytest.mark.parametrize("k", [11, 21, 31])
def test_query_reference_against_the_port(k):
    from kmer_hasher_tpu_torch import api

    from port_bench import gen

    seq = sequence(100 + k)
    traffic = {"pool": 16, "strata": 4, "min_len": 50, "max_len": 20_000,
               "sub_rate": 0.01}
    queries = gen.query_pool(seq, traffic, 7, CPU)
    ix = api.make_kmer_hash(seq, k, device=CPU)
    want = ref("chr21_k21").query_hits(seq, queries, k, CPU)
    total = 0
    for q, w in zip(queries, want):
        got = api.seq_kmer_pos(ix, q, k).numpy()
        assert np.array_equal(got, w)
        total += w.shape[0]
    assert total > 0
