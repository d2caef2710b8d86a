"""The port's user scripts and measurement entry points against the JAX
package's: ``kmer_hasher_tpu_torch.bench`` (``bench.py``), the probes
``e2e_device_bench``, ``hybrid_probe``, ``sharded_hybrid_bench`` and
``spill_regime`` (``tools/chip_probes/``), the examples ``large_pairs`` and
``counting_stress`` (``examples/``), and ``read_fastx_padded`` /
``derive_q_to_ll``. The JAX scripts are loaded from their files, never
edited; the inputs are made by numpy from a seed, and every comparison is
exact. On the CPU the JAX tools take their CPU paths (the f32 / hybrid /
f64 ``ll_scan``, not the Pallas kernel), as the port's take their kernels'
plain versions."""
import importlib.util
import json
import os
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_hasher_tpu import api as japi
from kmer_hasher_tpu import qll as jqll
from kmer_hasher_tpu.io import fastx as jfx
from kmer_hasher_tpu_torch import bench, counting, qll
from kmer_hasher_tpu_torch import io as tio
from kmer_hasher_tpu_torch.examples import counting_stress as cst
from kmer_hasher_tpu_torch.examples import large_pairs as lp
from kmer_hasher_tpu_torch.index.count_store import CountStore
from kmer_hasher_tpu_torch.probes import e2e_device_bench as e2e
from kmer_hasher_tpu_torch.probes import hybrid_probe as hp
from kmer_hasher_tpu_torch.probes import sharded_hybrid_bench as shb
from kmer_hasher_tpu_torch.probes import spill_regime as sr

REPO = pathlib.Path(__file__).resolve().parent.parent
K = 21
READ_LEN = 151


def load_tool(rel: str):
    """A JAX script loaded from its file under a name of its own (its
    ``__main__`` block does not run)."""
    path = REPO / rel
    spec = importlib.util.spec_from_file_location(
        "jax_tool_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


# -- read_fastx_padded, derive_q_to_ll ----------------------------------------

@pytest.mark.parametrize("text,max_records", [
    (">s1\nACGTNNAC\nacgt\n>s2\nGG\n", None),
    ("@r1\nACGTACGTAA\n+\nFFFF:,#FFF\n@r2\nNNACG\n+\nFFFFF\n@r3\nAC\n+\nFF\n",
     None),
    ("@r1\nACGTACGTAA\n+\nFFFF:,#FFF\n@r2\nNNACG\n+\nFFFFF\n@r3\nAC\n+\nFF\n",
     2),
])
def test_read_fastx_padded_equals_jax(tmp_path, text, max_records):
    p = tmp_path / "r.fx"
    p.write_text(text)
    got = tio.read_fastx_padded(str(p), max_records)
    want = jfx.read_fastx_padded(str(p), max_records)
    for name in ("seq", "qual", "lengths", "has_qual"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b)
    assert "read_fastx_padded" in tio.__all__


def test_derive_q_to_ll_equals_jax():
    got, want = qll.derive_q_to_ll(), jqll.derive_q_to_ll()
    assert got.dtype == np.float64 and got.shape == (256,)
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


# -- bench --------------------------------------------------------------------

def test_bench_json_line(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_LOG_L", "12")
    monkeypatch.setenv("BENCH_CHAIN", "2")
    monkeypatch.setenv("BENCH_ITERS", "1")
    rec = bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert list(out) == ["metric", "value", "unit", "vs_baseline"]
    assert out["metric"] == "kmers indexed/s/chip (k=32, L=2^12, cpu)"
    assert out["unit"] == "kmers/s" and out["value"] > 0
    assert out["vs_baseline"] == round(
        out["value"] / bench.BASELINE_KMERS_PER_S, 3)
    # the accumulator: every build's n_valid and first sorted key
    seq = bench.make_sequence(1 << 12, torch.device("cpu"))
    assert rec["acc"] == int(bench.chain(seq, 32, 2))
    from kmer_hasher_tpu_torch.index.position_index import build_index_arrays
    s = seq.clone()
    want = torch.zeros((), dtype=torch.int64)  # int64 sums wrap
    for i in range(2):
        s[i] = b"ACGT"[i % 4]
        s_key, _p, n_valid, _st, _sg = build_index_arrays(s, 32, 1 << 12)
        want = want + n_valid + s_key[0]
    assert rec["acc"] == int(want)


def test_bench_caps_the_length_on_the_cpu(monkeypatch):
    monkeypatch.setattr(bench, "CPU_MAX_LOG_L", 11)
    rec = bench.run(k=21, log_l=25, n_chain=1, iters=1, device="cpu")
    assert rec["metric"] == "kmers indexed/s/chip (k=21, L=2^11, cpu)"


def test_bench_error_record():
    """Run as a module without a card, it prints the bench_error record on
    its one line and exits 1."""
    no_card()
    res = subprocess.run(
        [sys.executable, "-m", "kmer_hasher_tpu_torch.bench"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 1, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"] == "bench_error" and out["value"] == 0
    assert out["vs_baseline"] == 0 and "is_available" in out["unit"]


# -- e2e_device_bench ---------------------------------------------------------

E2E_ROWS, E2E_BATCHES = 48, 2


def numpy_batches(quals: str, seed: int, n=E2E_BATCHES, rows=E2E_ROWS):
    """(seq, qual, lengths, has_qual) numpy batches of one quality model at
    the port's padded width: N past the read length."""
    rng = np.random.default_rng(seed)
    L = e2e.padded_width(READ_LEN)
    out = []
    for _ in range(n):
        seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (rows, L))]
        seq[:, READ_LEN:] = ord("N")
        if quals == "stress":
            q = rng.integers(63, 74, (rows, L)).astype(np.uint8)
            low = rng.random((rows, L)) < 0.02
            q[low] = rng.integers(35, 53, int(low.sum())).astype(np.uint8)
        elif quals == "binned":
            q = rng.choice(np.frombuffer(b"F:,#", np.uint8), (rows, L),
                           p=[0.88, 0.08, 0.02, 0.02])
        else:
            q = rng.integers(35, 74, (rows, L)).astype(np.uint8)
        out.append((seq, q, np.full(rows, READ_LEN, np.int32),
                    np.ones(rows, bool)))
    return out


@pytest.fixture(scope="module")
def jax_e2e():
    return load_tool("tools/chip_probes/e2e_device_bench.py")


def assert_same_store(t, j):
    assert t.counts_dict() == j.counts_dict()
    assert t.n_unique == j.n_unique
    assert int(t.total_added.sum()) == int(np.asarray(j.total_added).sum())
    np.testing.assert_array_equal(t.spectrum(40), japi.kmer_spectrum(j, 40))


@pytest.mark.parametrize("quals", e2e.QUALS)
@pytest.mark.parametrize("mode", e2e.MODES)
def test_e2e_store_and_e2e_equal_jax(jax_e2e, mode, quals):
    """STORE (add_run over prebuilt runs) and E2E (count_batches) against
    the JAX tool's run_store_only and run_e2e on the same batches."""
    seed = e2e.QUALS.index(quals)
    nb = numpy_batches(quals, seed)
    tb = [tuple(torch.from_numpy(a) for a in b) for b in nb]
    jb = [tuple(jnp.asarray(a) for a in b) for b in nb]
    got = e2e.run_e2e(tb, K, mode)
    want = jax_e2e.run_e2e(jb, K, mode, read_len=READ_LEN)
    assert_same_store(got, want)
    got_s = e2e.run_store_only(e2e.build_runs(tb, K, mode), K)
    want_s = jax_e2e.run_store_only(
        jax_e2e.build_runs(jb, K, mode, read_len=READ_LEN), K)
    assert_same_store(got_s, want_s)
    if quals == "uniform":  # phred 2-40 at min_q 20: next to nothing emits
        assert got.n_unique < 100
    else:
        assert got.n_unique > 1000


@pytest.mark.parametrize("quals", e2e.QUALS)
def test_e2e_batches_on_the_device(quals):
    """make_batches: the port's width, N past the read length, each model's
    alphabet; the same seed gives the same batches."""
    a = e2e.make_batches(2, 40, READ_LEN, quals=quals, device="cpu")
    b = e2e.make_batches(2, 40, READ_LEN, quals=quals, device="cpu")
    assert len(a) == 2
    for (s, q, ln, hq), (s2, q2, _l, _h) in zip(a, b):
        assert s.shape == q.shape == (40, 152) and s.dtype == torch.uint8
        assert torch.equal(s, s2) and torch.equal(q, q2)
        assert bool((s[:, READ_LEN:] == ord("N")).all())
        assert set(s[:, :READ_LEN].unique().tolist()) <= set(b"ACGT")
        assert bool((ln == READ_LEN).all()) and bool(hq.all())
        vals = set(q.unique().tolist())
        if quals == "binned":
            assert vals <= set(b"F:,#")
        else:
            assert min(vals) >= 35 and max(vals) <= 73
    assert not torch.equal(a[0][0], a[1][0])
    with pytest.raises(ValueError):
        e2e.make_batches(1, 8, READ_LEN, quals="flat", device="cpu")


def test_e2e_run_prints_every_stage(capsys):
    rec = e2e.run(2, K, READ_LEN, rows=32, mode="hybrid", quals="stress",
                  device="cpu")
    out = capsys.readouterr().out
    for name in ("FSM", "FUSED", "STORE", "E2E"):
        assert re.search(rf"^{name}: warm .* reads/s", out, re.M), name
        assert rec["stages"][name]["warm_s"] > 0
    line = [ln for ln in out.splitlines() if ln.startswith("E2E_DEVICE ")]
    assert json.loads(line[0][len("E2E_DEVICE "):]) == rec
    assert rec["bytes_per_read"] == 2 * 152 + 5 and rec["reads"] == 64
    assert rec["distinct"] > 0 and rec["total"] >= rec["distinct"]
    assert e2e.default_rows(151, 21) == 29_696


# -- hybrid_probe -------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_hp():
    return load_tool("tools/chip_probes/hybrid_probe.py")


def test_hybrid_probe_acc_and_flags_equal_jax(jax_hp):
    """Each model's batch (drawn in the JAX tool's order from one rng) is
    bitwise the JAX tool's; the chained accumulator and the flag count of
    every mode equal the JAX chained(fsm) at B = 256, chain 2."""
    B, chain = 256, 2
    rng_t, rng_j = np.random.default_rng(0), np.random.default_rng(0)
    for model in hp.MODELS:
        tb = hp.make_batch(rng_t, B, model, "cpu")
        jb = jax_hp.make_batch(rng_j, B, model)
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for mode in hp.MODES:
            acc, nflag = hp.chained(tb, mode, chain)
            j_acc, j_flag = jax_hp.chained(mode, chain)(*jb)
            assert int(acc) == int(j_acc), (model, mode)
            assert int(nflag) == int(j_flag), (model, mode)


def test_hybrid_probe_run_reports_the_flag_rate(capsys):
    rec = hp.run(32, 1, device="cpu")
    out = capsys.readouterr().out
    for model in hp.MODELS:
        m = rec["models"][model]
        assert set(m["reads_per_s"]) == set(hp.MODES)
        assert m["p"] == m["flagged"] / 32
        t_eff = (1 / m["reads_per_s"]["hybrid"]
                 + m["p"] / m["reads_per_s"]["exact"])
        assert m["effective_hybrid_reads_per_s"] == pytest.approx(1 / t_eff)
        assert re.search(rf"{model}\s+flag rate p=", out)
    line = [ln for ln in out.splitlines() if ln.startswith("HYBRID_PROBE ")]
    assert json.loads(line[0][len("HYBRID_PROBE "):]) == rec


def test_head_hi_of_an_empty_run_is_dead():
    assert hp.head_hi(torch.zeros(0, dtype=torch.int64)) == hp.DEAD_HI


# -- sharded_hybrid_bench -----------------------------------------------------

def test_sharded_hybrid_equals_exact_and_jax(capsys):
    """The port's hybrid store equals its exact store, and both the JAX
    tool's store (exact, on its one-device mesh) on the same batches."""
    jax_shb = load_tool("tools/chip_probes/sharded_hybrid_bench.py")
    rows, nw = 40, counting.win_bucket(READ_LEN, K)
    nb = numpy_batches("stress", 7, n=2, rows=rows)
    lengths = torch.full((rows,), READ_LEN, dtype=torch.int32)
    has_qual = torch.ones(rows, dtype=torch.bool)
    tb = [tuple(torch.from_numpy(a) for a in b[:2]) for b in nb]
    hyb = shb.run_store(tb, lengths, has_qual, K, nw, "hybrid")
    ex = shb.run_store(tb, lengths, has_qual, K, nw, "exact")
    assert shb.same_store(hyb, ex)
    jb = [tuple(jnp.asarray(a) for a in b[:2]) for b in nb]
    want = jax_shb.run(jb, jnp.asarray(nb[0][2]), jnp.asarray(nb[0][3]), K,
                       nw, "exact")
    assert int(ex.peek_n_unique()) == int(want.peek_n_unique()) > 1000
    np.testing.assert_array_equal(ex.spectrum(5), np.asarray(want.spectrum(5)))
    rec = shb.run(2, K, rows=32, device="cpu")
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("SHARDED_HYBRID ")]
    assert json.loads(line[0][len("SHARDED_HYBRID "):]) == rec
    assert rec["hybrid_eq_exact"] is True and rec["reads"] == 64


# -- spill_regime -------------------------------------------------------------

def test_spill_regime_control_equals_the_prefix(capsys, monkeypatch):
    """At a tiny spill budget: runs spill, the fold goes by key range, the
    control slice equals the big table's prefix, and the table equals an
    unspilled store's over the same runs. The fold budget reaches the
    stores as their keyword (a variable set to a budget that never ranges
    is neither read nor changed)."""
    monkeypatch.setenv("KMH_FOLD_BUDGET_BYTES", str(1 << 60))
    rec = sr.run(n_batches=4, k=K, spill_bytes=20_000, rows=48,
                 fold_budget=100_000, device="cpu")
    assert os.environ["KMH_FOLD_BUDGET_BYTES"] == str(1 << 60)
    assert rec["store"].fold_budget_bytes == 100_000
    out = capsys.readouterr().out
    assert rec["control_ok"] and rec["control_rows"] > 0
    assert rec["loop_spills"] >= 2 and rec["ranged_folds"] == 1
    assert "bitwise-equal=True" in out and "SPILL_REGIME " in out
    plain = CountStore(K, device="cpu")
    lengths = torch.full((48,), READ_LEN, dtype=torch.int32)
    has_qual = torch.ones(48, dtype=torch.bool)
    for i in range(4):
        gen = torch.Generator()
        gen.manual_seed(1000 + i)
        seq, qual = e2e.draw_batch(gen, 48, READ_LEN, "stress",
                                   torch.device("cpu"))
        plain.add_run(*counting._fused_rp_batch(
            seq, qual, lengths, has_qual, K, 1, 0,
            float(qll.Q_TO_LL[53]), "fast", min_q_char=53,
            n_win=counting.win_bucket(READ_LEN, K))[:3])
    plain.flush()
    assert torch.equal(rec["store"].keys, plain.keys)
    assert torch.equal(rec["store"].cnt, plain.cnt)
    assert rec["distinct"] == plain.n_unique


def test_spill_control_slice_is_the_run_prefix():
    keys = torch.tensor([0, 5, (1 << 32) - 1, 1 << 32, 1 << 40]) ^ sr.SIGN
    cnt = torch.tensor([[1], [2], [3], [4], [5]])
    k, c, n = sr.control_slice(keys, cnt)
    assert torch.equal(k, keys[:3]) and torch.equal(c, cnt[:3]) and n == 6


# -- large_pairs --------------------------------------------------------------

def test_large_pairs_equals_jax():
    """The port's example, both drains, at 0.12 Mbp and 20 copies, against
    the JAX KmerIndex of the same sequence: windows, distinct k-mers, total
    pairs, rows streamed, and the XOR of column x over the pair table. Row
    j of the sorted index is the x of m_j pairs, so that XOR is the XOR of
    the positions whose m_j is odd (computed from the JAX index's arrays:
    streaming through the JAX index compiles for minutes on a CPU)."""
    from kmer_hasher_tpu.index import KmerIndex as JaxIndex

    seq = lp.make_sequence(0.12, 20)
    j = JaxIndex(seq, 32)
    nv = j.n_valid
    s_pos, m = np.asarray(j.s_pos)[:nv], np.asarray(j.m)[:nv]
    want = int(np.bitwise_xor.reduce(s_pos[m % 2 == 1].astype(np.int64),
                                     initial=0))
    total = j.total_pairs
    assert total == int(m.astype(np.int64).sum()) > 900_000
    for drain in ([], ["--drain-on-device"]):
        rec = lp.main(["--mbp", "0.12", "--copies", "20", "--device", "cpu"]
                      + drain)
        assert (rec["windows"], rec["distinct"], rec["total_pairs"]) == (
            nv, j.n_kmers, total)
        assert rec["streamed"] == total and rec["checksum"] == want


def test_large_pairs_drains_agree_over_many_chunks(monkeypatch, capsys):
    """Chunks of 2^14 rows, a stop part-way: both drains stream the same
    rows and XOR to the checksum of the pair table's first rows."""
    monkeypatch.setattr(lp, "CHUNK", 1 << 14)
    argv = ["--mbp", "0.03", "--copies", "5", "--max-stream-pairs", "40000",
            "--device", "cpu"]
    host = lp.main(argv)
    dev = lp.main(argv + ["--drain-on-device"])
    idx = lp.run(0.03, 5, 1, device="cpu")["index"]
    rows = idx.pair_table().numpy()
    n = -(-40_000 // (1 << 14)) * (1 << 14)
    assert host["streamed"] == dev["streamed"] == n < rows.shape[0]
    want = int(np.bitwise_xor.reduce(rows[:n, 1].astype(np.int64)))
    assert host["checksum"] == dev["checksum"] == want
    for n in (0, 1, 5, 6, 1023):
        x = torch.arange(7, 7 + n) * 2654435761 % (1 << 31)
        assert int(lp.xor_all(x)) == int(np.bitwise_xor.reduce(
            x.numpy(), initial=0))
    with pytest.raises(ValueError):
        lp.make_sequence(0.001, 2)


def test_pair_rows_past_2_31_match_a_walk_over_the_segments():
    """A pair table longer than 2^32 rows (a 100-base unit 10,000 times:
    100 k-mers of about 10,000 positions, 5.0e9 pairs): rows from just
    below 2^31, past 2^32 and at the end, as the chunk iterator computes
    them, against a walk over the segments on the host."""
    from kmer_hasher_tpu_torch.index.position_index import KmerIndex, _pair_chunk
    from kmer_hasher_tpu_torch.ops.sort import clamp_chunk_capacity

    unit = np.random.default_rng(5).choice(np.frombuffer(b"ACGT", np.uint8),
                                           100)
    idx = KmerIndex(np.tile(unit, 10_000), 32, device="cpu")
    counts = idx.counts().numpy().astype(np.int64)
    total = idx.total_pairs
    assert total == int((counts * (counts - 1) // 2).sum()) > 2 ** 32
    assert clamp_chunk_capacity(lp.CHUNK, total) == lp.CHUNK
    pos = idx.s_pos[: idx.n_valid].numpy().astype(np.int64)
    seg_start = np.concatenate([[0], np.cumsum(counts)])
    seg_pairs = np.concatenate([[0], np.cumsum(counts * (counts - 1) // 2)])

    def walk(g):
        s = int(np.searchsorted(seg_pairs, g, side="right")) - 1
        c, local = int(counts[s]), g - int(seg_pairs[s])
        p = pos[seg_start[s]: seg_start[s] + c]
        r = 0
        while local >= c - 1 - r:
            local -= c - 1 - r
            r += 1
        return (s + 1, int(p[r]), int(p[r + 1 + local]))

    for start in (2 ** 31 - 5, 2 ** 32 + 7, total - 4):
        rows = _pair_chunk(idx.s_pos, idx.i_col, idx.m, idx.cum_m,
                           idx.n_valid, start, 4)
        assert [tuple(r) for r in rows.tolist()] == [
            walk(g) for g in range(start, start + 4)], start


# -- counting_stress ----------------------------------------------------------

@pytest.mark.parametrize("binned", [False, True])
def test_counting_stress_reads_and_table_equal_jax(tmp_path, binned):
    """The port's FASTQ bytes are the JAX script's; the store it counts
    equals the JAX count_kmers_fq_sh_rp on that file, fast and hybrid."""
    jax_cs = load_tool("examples/counting_stress.py")
    a, b = tmp_path / "port.fq", tmp_path / "jax.fq"
    cst.make_reads(str(a), 120, READ_LEN, binned=binned)
    jax_cs.make_reads(str(b), 120, READ_LEN, binned=binned)
    assert a.read_bytes() == b.read_bytes()
    for flags, exact_ll in (([], False), (["--ll-mode", "hybrid"], "hybrid")):
        rec = cst.main(["--reads", "120", "--keep", str(a), "--report-every",
                        "0", "--device", "cpu"] + flags
                       + (["--binned-quals"] if binned else []))
        want = japi.count_kmers_fq_sh_rp(str(a), k=K, min_q=20,
                                         exact_ll=exact_ll)
        assert rec["store"].counts_dict() == want.counts_dict()
        assert rec["total"] == int(np.asarray(want.total_added).sum())
        assert rec["distinct"] == want.n_unique > 1000


def test_counting_stress_temporary_file_is_removed(capsys):
    rec = cst.main(["--reads", "30", "--report-every", "0", "--sources", "2",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    path = re.search(r"-> (\S+)", out).group(1)
    assert not os.path.exists(path)
    assert rec["reads"] == 60 and rec["store"].counts_n == 2
    tot = rec["store"].total_added
    assert tot[0] == tot[1] > 0
