"""The port's sharded position index over several processes: 2 and 4 gloo
ranks on the CPU, started as subprocesses, each building
``ShardedKmerIndex(seq, k, make_mesh(D, device="cpu", distributed=True))``
of the same sequence, against the port's one-process ``ShardedKmerIndex``
on ``make_mesh(D, device="cpu")`` and the single ``KmerIndex``, bitwise,
and for k = 21 and 32 on the mixed sequence against the JAX package's
``ShardedKmerIndex`` on the 8-device CPU mesh (``conftest.py``): every
rank's hash and range shards, ``n_valid`` and the splitters as every rank
reads them, ``tables(15)`` and the pair chunks, ``lookup_counts`` and
``positions_of``, the blocks of ``iter_seq_kmer_pos`` and of
``iter_kmer_pairs_sharded_chunks`` (at 16 rows a shard a round, so the
streams take many rounds), ``kmer_pairs_sharded`` and its ``max_pairs``
raise, and the range partition dropped and rebuilt.

The inputs are ``test_torch_sharded_index.py``'s: the mixed sequence, the
quirk sequence, 40 bases on 8 shards (chunks past the end, a halo longer
than a chunk at k > 17) and the repeat-rich sequence. On 2 ranks of 8
shards the mixed sequence's chunk 3 ends on rank 0 and its windows read
their halo from rank 1's chunk 4; on 4 ranks rank 3 owns no window.

One spawn per process count runs every case (one worker script, each
case's results written to files, one JSON record a rank and case); each
case is then one test. ``test_torch_distributed.spawn`` starts the ranks:
a spawn that outlives its SPAWN_TIMEOUT has every rank killed and fails
its tests."""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import kmer_hasher_tpu  # noqa: F401  (x64, the JAX package's setting)
from kmer_hasher_tpu.parallel import ShardedKmerIndex as JShardedKmerIndex
from kmer_hasher_tpu.parallel import iter_kmer_pairs_sharded_chunks as jiter
from kmer_hasher_tpu.parallel import make_mesh as jmake_mesh
from kmer_hasher_tpu_torch.index import KmerIndex
from kmer_hasher_tpu_torch.index.query import kmer_pairs, seq_kmer_pos
from kmer_hasher_tpu_torch.ops import encode as enc
from kmer_hasher_tpu_torch.parallel import (ShardedKmerIndex,
                                            iter_kmer_pairs_sharded_chunks,
                                            make_mesh)
from kmer_hasher_tpu_torch.parallel import sharded as tsp

from test_torch_distributed import spawn
from test_torch_sharded_index import (KS, LONG, REPEAT, mixed_seq,
                                      quirk_seq, short_seq)

REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"
REPEAT_B = "ACTGG" * 40 + "A" + "ACGTACGTAA" * 10
C = 16  # rows a shard a round of every stream: many rounds


def as_u8(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), np.uint8).copy()


def inputs_of(name: str, k: int):
    """(sequence, query of seq_kmer_pos, the second index's sequence)."""
    if name == "repeat":
        return as_u8(REPEAT), as_u8(REPEAT[:80]), as_u8(REPEAT_B)
    if name == "short":
        seq = short_seq()
        return seq, seq, seq
    seq = mixed_seq() if name == "mixed" else quirk_seq(k)
    other = quirk_seq(k) if name == "mixed" else mixed_seq()
    query = np.concatenate([seq[100:700], np.frombuffer(b"N", np.uint8),
                            seq[1450:1900]])
    return seq, query, other


# (input, k, D); every case on 2 and on 4 ranks
CASES = ([("mixed", k, 8) for k in KS] + [("quirk", k, 8) for k in (5, 21, 32)]
         + [("short", k, 8) for k in (5, 16, 21, 32)]
         + [("mixed", k, 4) for k in (5, 21, 32)] + [("repeat", 5, 8)])
JAX_CASES = [("mixed", 21, 8), ("mixed", 32, 8)]
# the range partition dropped and rebuilt, and the build under the merge
# sort (its row length cut to 16, so a few hundred rows reach B3's rounds)
REBUILD = [("mixed", 21, 8), ("mixed", 32, 4), ("repeat", 5, 8)]
PS = (2, 4)


def case_id(case) -> str:
    return "{}_k{}_d{}".format(*case)


def caps(case):
    """(rows a shard a round of the query and cross-index streams, rows a
    chunk of the pair table): C and C, but 64 and 4,096 for the repeat,
    whose streams would otherwise take tens of thousands of rounds."""
    return (64, 1 << 12) if case[0] == "repeat" else (C, C)


WORKER = r'''
import json, os, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
torch.set_num_threads(1)
from kmer_hasher_tpu_torch import api
from kmer_hasher_tpu_torch.parallel import (ShardedKmerIndex,
                                            iter_kmer_pairs_sharded_chunks,
                                            kmer_pairs_sharded,
                                            make_hierarchical_mesh, make_mesh)
from kmer_hasher_tpu_torch.parallel import sharded as tsp

rdzv, P, rank, spec_path = sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
info = api.init_distributed(rdzv, world_size=P, rank=rank)
assert info["process_index"] == rank and info["process_count"] == P, info
spec = json.loads(open(spec_path).read())
out = spec["out"]


def cat(blocks, cols):
    return (torch.cat(blocks) if blocks
            else torch.zeros((0, cols), dtype=torch.int32)).numpy()


def same(a, b):
    return all(torch.equal(x.s_key, y.s_key) and torch.equal(x.s_pos, y.s_pos)
               for x, y in zip(a, b))


def same_tables(a, b):
    return a["kmer"] == b["kmer"] and all(
        torch.equal(a[f], b[f]) for f in ("pos", "pair.pos", "count"))


for case in spec["cases"]:
    name, k, D = case["name"], case["k"], case["D"]
    load = lambda key: np.load(case[key])
    mesh = make_mesh(D, device="cpu", distributed=True)
    t = ShardedKmerIndex(load("seq"), k, mesh)
    rec = {"local": list(mesh.local_shards), "n_valid": t.n_valid.tolist(),
           "chunk": t.chunk, "total_kmers": t.total_kmers}
    arrays = {}
    for d, s in zip(mesh.local_shards, t.shards):
        arrays[f"hk{d}"], arrays[f"hp{d}"] = s.s_key.numpy(), s.s_pos.numpy()
    rp = t._range_partitioned()
    arrays["spl"] = t._rp_spl.numpy()
    for d, s in zip(mesh.local_shards, rp):
        arrays[f"rk{d}"], arrays[f"rp{d}"] = s.s_key.numpy(), s.s_pos.numpy()
    tabs = t.tables(15)
    rec["kmer"] = tabs["kmer"]
    for f in ("pos", "pair.pos", "count"):
        arrays[f] = tabs[f].numpy()
    rec["n_kmers"], rec["total_pairs"] = t.n_kmers, t.total_pairs
    chunks = list(t.iter_pair_chunks(capacity=case["pair_C"]))
    rec["pair_chunks"] = [c.shape[0] for c in chunks]
    arrays["pair_chunks"] = cat(chunks, 3)
    q = torch.from_numpy(load("q"))
    arrays["lookup"] = t.lookup_counts(q).numpy()
    arrays["positions"] = t.positions_of(q, max_hits_per_shard=case["C"]).numpy()
    arrays["position0"] = t.positions_of(q[:1]).numpy()
    if k <= 31:
        blocks = list(t.iter_seq_kmer_pos(load("query"), k,
                                          max_hits_per_shard=case["C"]))
        rec["skp_blocks"] = [b.shape[0] for b in blocks]
        rec["merge_peak"] = t._merge_peak_rows
        arrays["skp"] = cat(blocks, 2)
        arrays["skp_whole"] = t.seq_kmer_pos(load("query"), k).numpy()
    b = ShardedKmerIndex(load("other"), k, mesh)
    blocks = list(iter_kmer_pairs_sharded_chunks(t, b, capacity=case["C"]))
    rec["pair_blocks"] = [x.shape[0] for x in blocks]
    rec["pairs_peak"] = tsp._PAIRS_STREAM_STATS["peak_rows"]
    arrays["pairs"] = cat(blocks, 2)
    whole = kmer_pairs_sharded(t, b)
    arrays["pairs_whole"] = whole.numpy()
    rec["max_pairs_raised"] = None
    if whole.shape[0]:
        try:
            kmer_pairs_sharded(t, b, capacity=case["C"],
                               max_pairs=whole.shape[0] - 1)
            rec["max_pairs_raised"] = False
        except MemoryError:
            rec["max_pairs_raised"] = True
        rec["max_pairs_exact"] = int(kmer_pairs_sharded(
            t, b, max_pairs=whole.shape[0]).shape[0])
    if case["rebuild"]:
        t.drop_range_partition()
        cleared = t._rp is None and t._rp_stats is None
        rec["rebuilt_equal"] = cleared and same_tables(t.tables(15), tabs)
    rec["timings"] = t.timings
    np.savez(os.path.join(out, f"{case['id']}.r{rank}.npz"), **arrays)
    with open(os.path.join(out, f"{case['id']}.r{rank}.json"), "w") as f:
        json.dump(rec, f)

# groups: a one-process group is not the process group of the same size,
# and the hierarchical group over processes routes as the flat one
seq = np.load(spec["groups_seq"])
flat = ShardedKmerIndex(seq, 21, make_mesh(8, device="cpu", distributed=True))
one = ShardedKmerIndex(seq, 21, make_mesh(8, device="cpu"))
hier_mesh = make_hierarchical_mesh(2, 4, device="cpu", distributed=True)
hier = ShardedKmerIndex(seq, 21, hier_mesh)
rec = {"same_one": tsp._same_group(flat.mesh, one.mesh),
       "same_flat": tsp._same_group(flat.mesh, make_mesh(
           8, device="cpu", distributed=True)),
       "hier_shape": list(hier_mesh.shape),
       "hier_local": list(hier_mesh.local_shards),
       "hier_procs": hier_mesh.process_count,
       "hier_same_shards": same(hier.shards, flat.shards),
       "hier_n_valid": hier.n_valid.tolist(),
       "hier_tables": same_tables(hier.tables(15), flat.tables(15))}
for a, b, key in ((flat, one, "raised_flat_one"), (one, flat, "raised_one_flat")):
    try:
        kmer_pairs_sharded(a, b)
        rec[key] = None
    except ValueError as e:
        rec[key] = str(e)
with open(os.path.join(out, f"groups.r{rank}.json"), "w") as f:
    json.dump(rec, f)
print("WORKER_OK", rank, json.dumps(info))
'''


def queries_of(one: KmerIndex, k: int) -> np.ndarray:
    """Every window's raw key of the single index, unique, plus keys absent
    from it, as int64."""
    raw = np.unique(enc.sortable_key(one.s_key[: one.n_valid]).numpy()
                    .view(np.uint64))
    absent = np.array([0, 2 ** 63 - 1, 2 ** 64 - 1], np.uint64)
    if k < 32:
        absent = absent & np.uint64((1 << (2 * k)) - 1)
    return np.concatenate([raw, absent]).view(np.int64)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Each case's inputs as .npy files the ranks load."""
    d = tmp_path_factory.mktemp("inputs")
    cases = []
    for case in CASES:
        name, k, D = case
        seq, query, other = inputs_of(name, k)
        one = KmerIndex(seq, k, device=CPU)
        paths = {}
        for key, arr in (("seq", seq), ("query", query), ("other", other),
                         ("q", queries_of(one, k))):
            paths[key] = str(d / f"{case_id(case)}.{key}.npy")
            np.save(paths[key], arr)
        cases.append(dict(paths, id=case_id(case), name=name, k=k, D=D,
                          rebuild=case in REBUILD, C=caps(case)[0],
                          pair_C=caps(case)[1]))
    groups_seq = d / "groups.npy"
    np.save(groups_seq, mixed_seq())
    return {"cases": cases, "groups_seq": str(groups_seq)}


@pytest.fixture(scope="module")
def runs(files, tmp_path_factory):
    """P -> the ranks' output directory, one spawn per process count."""
    res = {}
    for P in PS:
        out = tmp_path_factory.mktemp(f"ranks{P}")
        env = dict(os.environ, OMP_NUM_THREADS="1")
        spawn(out, P, {"out": str(out), **files}, WORKER, env)
        res[P] = out
    return res


def rank_results(out: Path, case, P: int):
    """Every rank's (JSON record, arrays)."""
    res = []
    for r in range(P):
        rec = json.loads((out / f"{case_id(case)}.r{r}.json").read_text())
        with np.load(out / f"{case_id(case)}.r{r}.npz") as z:
            res.append((rec, {f: z[f] for f in z.files}))
    return res


ORACLES = {}


def oracle(case):
    """(one-process sharded index, single index, inputs) of a case, with
    the answers the ranks are held to, computed once."""
    if case not in ORACLES:
        name, k, D = case
        seq, query, other = inputs_of(name, k)
        t = ShardedKmerIndex(seq, k, make_mesh(D, device=CPU))
        one = KmerIndex(seq, k, device=CPU)
        q = torch.from_numpy(queries_of(one, k))
        b = ShardedKmerIndex(other, k, make_mesh(D, device=CPU))
        cs, cp = caps(case)
        o = {"t": t, "one": one, "tables": t.tables(15),
             "single_tables": one.tables(15), "q": q,
             "pair_chunks": list(t.iter_pair_chunks(capacity=cp)),
             "pairs": list(iter_kmer_pairs_sharded_chunks(t, b, capacity=cs)),
             "pairs_peak": tsp._PAIRS_STREAM_STATS["peak_rows"],
             "single_pairs": kmer_pairs(one, KmerIndex(other, k, device=CPU)),
             "query": query, "other": other, "seq": seq}
        lb, ub = one.lookup_range(q)
        o["lookup"] = (ub - lb).to(torch.int32)
        o["positions"] = torch.sort(torch.cat([
            one.s_pos[a:b_] for a, b_ in zip(lb.tolist(), ub.tolist())])).values
        if k <= 31:
            o["skp"] = list(t.iter_seq_kmer_pos(query, k,
                                                max_hits_per_shard=cs))
            o["merge_peak"] = t._merge_peak_rows
            o["single_skp"] = seq_kmer_pos(one, query, k)
        ORACLES[case] = o
    return ORACLES[case]


def eq(got: np.ndarray, want) -> bool:
    want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    return got.dtype == want.dtype and np.array_equal(got, want)


def cat(blocks, cols: int) -> torch.Tensor:
    return (torch.cat(blocks) if blocks
            else torch.zeros((0, cols), dtype=torch.int32))


ALL = [pytest.param(P, case, id=f"P{P}-{case_id(case)}")
       for P in PS for case in CASES]


@pytest.mark.parametrize("P,case", ALL)
def test_hash_shards_and_n_valid(runs, P, case):
    """Each rank owns shards p*D/P ... (p+1)*D/P - 1, equal to the
    one-process index's; every rank reads the D shard sizes, which add up
    to the single index's windows."""
    o = oracle(case)
    t, D = o["t"], case[2]
    seen = []
    for r, (rec, z) in enumerate(rank_results(runs[P], case, P)):
        assert rec["local"] == list(range(r * D // P, (r + 1) * D // P))
        assert rec["n_valid"] == t.n_valid.tolist()
        assert (rec["chunk"], rec["total_kmers"]) == (t.chunk, o["one"].n_valid)
        for d in rec["local"]:
            seen.append(d)
            assert eq(z[f"hk{d}"], t.shards[d].s_key), f"shard {d}"
            assert eq(z[f"hp{d}"], t.shards[d].s_pos), f"shard {d}"
    assert sorted(seen) == list(range(D))


@pytest.mark.parametrize("P,case", ALL)
def test_splitters_and_range_shards(runs, P, case):
    """Every rank holds the one-process splitters, and its own range
    shards equal the one-process ones."""
    t = oracle(case)["t"]
    rp = t._range_partitioned()
    for rec, z in rank_results(runs[P], case, P):
        assert eq(z["spl"], t._rp_spl)
        for d in rec["local"]:
            assert eq(z[f"rk{d}"], rp[d].s_key), f"range shard {d}"
            assert eq(z[f"rp{d}"], rp[d].s_pos), f"range shard {d}"


@pytest.mark.parametrize("P,case", ALL)
def test_tables_and_pair_chunks(runs, P, case):
    """tables(15) on every rank equal the one-process and the single
    index's; the pair chunks of 16 rows come in the one-process chunks."""
    o = oracle(case)
    want, single = o["tables"], o["single_tables"]
    for rec, z in rank_results(runs[P], case, P):
        assert rec["kmer"] == want["kmer"] == single["kmer"]
        for f in ("pos", "pair.pos", "count"):
            assert eq(z[f], want[f]) and eq(z[f], single[f]), f
        assert (rec["n_kmers"], rec["total_pairs"]) == (
            o["one"].n_kmers, o["one"].total_pairs)
        assert rec["pair_chunks"] == [c.shape[0] for c in o["pair_chunks"]]
        assert eq(z["pair_chunks"], cat(o["pair_chunks"], 3))


@pytest.mark.parametrize("P,case", ALL)
def test_lookups(runs, P, case):
    """lookup_counts and positions_of (16 hits a shard a round) of every
    key of the sequence and of absent keys equal the single index's
    lookup_range, on every rank."""
    o = oracle(case)
    first = o["one"].lookup_range(o["q"][:1])
    for _rec, z in rank_results(runs[P], case, P):
        assert eq(z["lookup"], o["lookup"])
        assert eq(z["positions"], o["positions"])
        assert eq(z["position0"], torch.sort(
            o["one"].s_pos[int(first[0][0]):int(first[1][0])]).values)


SKP = [p for p in ALL if p.values[1][1] <= 31]


@pytest.mark.parametrize("P,case", SKP)
def test_seq_kmer_pos_blocks(runs, P, case):
    """The query's rows in the one-process blocks (16 hits a shard a round,
    bounded buffers), concatenated the single index's seq_kmer_pos."""
    o = oracle(case)
    for rec, z in rank_results(runs[P], case, P):
        assert rec["skp_blocks"] == [b.shape[0] for b in o["skp"]]
        assert rec["merge_peak"] == o["merge_peak"] <= 3 * case[2] * caps(
            case)[0]
        assert eq(z["skp"], cat(o["skp"], 2))
        assert eq(z["skp_whole"], o["single_skp"])
    if case == ("repeat", 5, 8):
        assert len(o["skp"]) > 1


@pytest.mark.parametrize("P,case", ALL)
def test_kmer_pairs_sharded_blocks(runs, P, case):
    """iter_kmer_pairs_sharded_chunks at 16 rows in the one-process blocks,
    kmer_pairs_sharded the single index's kmer_pairs, and max_pairs one
    short raises on every rank."""
    o = oracle(case)
    for rec, z in rank_results(runs[P], case, P):
        assert rec["pair_blocks"] == [b.shape[0] for b in o["pairs"]]
        assert rec["pairs_peak"] == o["pairs_peak"]
        assert eq(z["pairs"], cat(o["pairs"], 2))
        assert eq(z["pairs_whole"], o["single_pairs"])
        n = o["single_pairs"].shape[0]
        assert rec["max_pairs_raised"] is (True if n else None)
        if n:
            assert rec["max_pairs_exact"] == n
    if case in (("repeat", 5, 8), ("short", 21, 8)):
        assert len(o["pairs"]) > 1


@pytest.mark.parametrize("P,case", [pytest.param(P, c, id=f"P{P}-{case_id(c)}")
                                    for P in PS for c in REBUILD])
def test_rebuild(runs, P, case):
    """drop_range_partition, then tables(15) again: the same tables on
    every rank."""
    for rec, _z in rank_results(runs[P], case, P):
        assert rec["rebuilt_equal"]


@pytest.mark.parametrize("P,case", [pytest.param(P, c, id=f"P{P}-{case_id(c)}")
                                    for P in PS for c in JAX_CASES])
def test_equal_jax_sharded_index(runs, P, case):
    """The ranks' shards, splitters, tables, query blocks and cross-index
    pair blocks against the JAX ShardedKmerIndex on the 8-device CPU
    mesh."""
    name, k, D = case
    o = oracle(case)
    j = JShardedKmerIndex(o["seq"], k, jmake_mesh(D))
    jb = JShardedKmerIndex(o["other"], k, jmake_mesh(D))
    r_hi, r_lo, r_pos, nv = j._range_partitioned()
    jtabs = j.tables(15)

    def jraw(hi, lo):
        return ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
                | np.asarray(lo).astype(np.uint64))

    def raw(sortable):
        return (sortable ^ np.int64(-(2 ** 63))).view(np.uint64)

    jspl = jraw(*j._rp_spl)
    jskp = np.asarray(j.seq_kmer_pos(o["query"], k)) if k <= 31 else None
    jpairs = [np.asarray(b) for b in jiter(j, jb, capacity=C)]
    for rec, z in rank_results(runs[P], case, P):
        assert rec["n_valid"] == np.asarray(j.n_valid).tolist()
        for d in rec["local"]:
            n = int(j.n_valid[d])
            assert np.array_equal(raw(z[f"hk{d}"]),
                                  jraw(j.s_hi[d, :n], j.s_lo[d, :n]))
            assert np.array_equal(z[f"hp{d}"], np.asarray(j.s_pos[d, :n]))
            n = int(nv[d])
            assert np.array_equal(raw(z[f"rk{d}"]),
                                  jraw(r_hi[d, :n], r_lo[d, :n]))
            assert np.array_equal(z[f"rp{d}"], np.asarray(r_pos[d, :n]))
        assert np.array_equal(raw(z["spl"]), jspl)
        assert rec["kmer"] == jtabs["kmer"]
        for f in ("pos", "pair.pos", "count"):
            assert np.array_equal(z[f], np.asarray(jtabs[f])), f
        if jskp is not None:
            assert np.array_equal(z["skp_whole"], jskp)
        assert rec["pair_blocks"] == [b.shape[0] for b in jpairs]
        assert np.array_equal(z["pairs"], np.concatenate(jpairs))


@pytest.mark.parametrize("P", PS)
def test_routes_and_gathers_are_timed(runs, P):
    """Every rank's index sent rows to other ranks and received gathered
    rows, and says so in ``timings``."""
    case = ("mixed", 31, 8)
    for rec, _z in rank_results(runs[P], case, P):
        tm = rec["timings"]
        assert tm["routes"] == 2  # the build, the range partition
        assert tm["exchanges"] == tm["routes"]
        assert tm["exchange_bytes"] > 0 and tm["exchange_s"] > 0
        assert tm["gathers"] > 0 and tm["gather_bytes"] > 0
        assert tm["gather_s"] > 0


@pytest.mark.parametrize("P", PS)
def test_halo_across_a_rank_boundary(runs, P):
    """Windows that start in a rank's last chunk and end in the next rank's
    first chunk (their halo read from the whole host sequence) are in the
    index, at their global positions, on both process counts."""
    case = ("mixed", 32, 8)
    t = oracle(case)["t"]
    per = 8 // P
    pos = torch.cat([s.s_pos for s in t.shards])
    for r in range(P - 1):
        end = (r + 1) * per * t.chunk  # the last base of rank r's chunks
        if end >= LONG:
            continue
        crossing = (pos > end - 31) & (pos <= end)
        assert int(crossing.sum()) > 0
    got = torch.cat([torch.from_numpy(z["pos"][:, 1]) for _r, z in
                     rank_results(runs[P], case, P)[:1]])
    assert torch.equal(torch.sort(got).values, torch.sort(pos).values)


def test_a_rank_without_windows(runs):
    """On 4 ranks of 8 shards the 3,000-base sequence's chunks 6 and 7
    (rank 3's) lie past its end: rank 3 encodes no window, yet takes its
    part in every exchange and gather: its hash shards hold the windows
    other ranks routed to it, and it reads every table."""
    for case, local in ((("mixed", 31, 8), [6, 7]), (("mixed", 21, 4), [3])):
        rec, z = rank_results(runs[4], case, 4)[3]
        assert rec["local"] == local and local[0] * rec["chunk"] >= LONG
        held = np.concatenate([z[f"hp{d}"] for d in local])
        assert held.size and held.max() <= local[0] * rec["chunk"]
        assert rec["timings"]["exchanges"] == 2
        assert rec["timings"]["gathers"] > 0
        assert eq(z["pos"], oracle(case)["single_tables"]["pos"])


@pytest.mark.parametrize("P", PS)
def test_group_layouts(runs, P):
    """_same_group tells a one-process group from the process group of the
    same size, and kmer_pairs_sharded across them raises on every rank;
    two process groups of one layout are the same; the hierarchical group
    over processes (2 x 4) spreads its shards as the flat one and gives
    the same index."""
    seen = []
    for r in range(P):
        rec = json.loads((runs[P] / f"groups.r{r}.json").read_text())
        assert rec["same_one"] is False and rec["same_flat"] is True
        assert "same mesh" in rec["raised_flat_one"]
        assert "same mesh" in rec["raised_one_flat"]
        assert rec["hier_shape"] == [2, 4] and rec["hier_procs"] == P
        assert rec["hier_local"] == list(range(r * 8 // P, (r + 1) * 8 // P))
        assert rec["hier_same_shards"] and rec["hier_tables"]
        seen.append(rec["hier_n_valid"])
    one = ShardedKmerIndex(mixed_seq(), 21, make_mesh(8, device=CPU))
    assert seen == [one.n_valid.tolist()] * P
