"""The port's shard group over processes *and* several devices a process
(``make_mesh(8, distributed=True, devices=[...])``, the JAX mesh over
several hosts with several chips each): 2 gloo ranks on the CPU, started
as subprocesses, each spreading its 4 shards over 2 devices, against the
port's one-process ``make_mesh(8, device="cpu")`` group and the JAX
package on the 8-device CPU mesh (``conftest.py``), bitwise.

Two layouts, one spawn each, every case in it: "split", ``["cpu",
torch.device("cpu", 0)]`` a rank, two devices that compare unequal, so
every copy between them is counted and each shard's store records its own
device; and "repeated", ``["cpu", "cpu"]``. (A CPU tensor reports ``cpu``
whatever index it was made with, so a shard's place is read from its
store's recorded device and its tensors' device type.)

The cases: the exchange alone, two sources a rank in (rank, source)
order; ``count_batches`` with a rank of no rows; ``add_batch`` and
``add_run``; route (b), byte ranges of one FASTQ (k 21 and 32, fast /
exact / hybrid), with lookups and ``seq_kmer_depth`` on the sharded store
in both semantics; route (c), lockstep (a multi-line FASTQ, and a plain
FASTQ with ``KMH_HOST_SLICE=0``); route (a), three gzip files dealt to the
ranks; checkpoints saved by the ranks and loaded by either package, and
both packages' files loaded onto the ranks; the sharded index (tables,
pair chunks, lookups, positions, ``seq_kmer_pos`` blocks, cross-index
pair blocks and ``kmer_pairs_sharded``). Also, without a spawn, the
layout on a faked group of processes and the rows the lockstep route
deals to each (rank, device)."""
import gzip
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import kmer_hasher_tpu  # noqa: F401  (x64, the JAX package's setting)
from kmer_hasher_tpu import api as japi
from kmer_hasher_tpu.index.count_store import CountStore as JCountStore
from kmer_hasher_tpu.parallel import ShardedCountStore as JShardedCountStore
from kmer_hasher_tpu.parallel import ShardedKmerIndex as JShardedKmerIndex
from kmer_hasher_tpu.parallel import make_mesh as jmake_mesh
from kmer_hasher_tpu.utils import checkpoint as jckpt
from kmer_hasher_tpu_torch import api, counting
from kmer_hasher_tpu_torch.index import KmerIndex
from kmer_hasher_tpu_torch.index.query import kmer_pairs, seq_kmer_pos
from kmer_hasher_tpu_torch.parallel import (ShardedCountStore,
                                            ShardedKmerIndex,
                                            iter_kmer_pairs_sharded_chunks,
                                            make_mesh)
from kmer_hasher_tpu_torch.parallel import distributed as tdist
from kmer_hasher_tpu_torch.parallel import mesh as tmesh
from kmer_hasher_tpu_torch.utils import checkpoint as tckpt

from test_torch_distributed import (assert_matches, assert_same_tables,
                                    fastq_bytes, jax_store, jax_tables,
                                    mode_arg, multiline_fastq, one_process,
                                    port_tables, raw_u64, rank_results,
                                    read_batch, spawn)
from test_torch_distributed_index import cat, inputs_of, queries_of
from test_torch_distributed_index import eq as same

CPU = "cpu"
D, P, M = 8, 2, 2
MIN_Q = 0  # test_torch_distributed's: the f32 filter flags reads at q0
ROWS = 256
N_MAIN = 1200
LAYOUTS = {"split": [CPU, [CPU, 0]], "repeated": [CPU, CPU]}
EXCHANGE_ROWS = [[37, 0], [13, 21]]  # [rank][source]
EMPTY_OWNERS = (2, 5)
ROUTE_B = [(k, mode) for k in (21, 32) for mode in ("fast", "exact",
                                                      "hybrid")]
INDEX_CASES = [("mixed", 21), ("mixed", 32), ("quirk", 21), ("short", 5)]
JAX_INDEX = [("mixed", 21), ("mixed", 32)]
C = 16  # rows a shard a round of the index's streams
ADD_K = 32


def as_device(d):
    return torch.device(*d) if isinstance(d, list) else torch.device(d)


WORKER = r'''
import json, os, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
torch.set_num_threads(1)
from kmer_hasher_tpu_torch import api, counting
from kmer_hasher_tpu_torch.parallel import (ShardedCountStore,
                                            ShardedKmerIndex,
                                            iter_kmer_pairs_sharded_chunks,
                                            kmer_pairs_sharded, make_mesh)
from kmer_hasher_tpu_torch.utils import checkpoint

rdzv, P, rank, spec_path = sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
info = api.init_distributed(rdzv, world_size=P, rank=rank)
spec = json.loads(open(spec_path).read())
out = spec["out"]
DEVICES = [torch.device(*d) if isinstance(d, list) else torch.device(d)
           for d in spec["devices"]]
queries = torch.from_numpy(np.load(spec["queries"]))


def mesh():
    return make_mesh(spec["D"], distributed=True, devices=DEVICES)


def placed(m, shard_devices, tensor_devices):
    """Every local shard where device_of puts it: its recorded device, and
    its tensors' device type."""
    return all(dev == m.device_of(d) and all(t.type == dev.type for t in ts)
               for d, dev, ts in zip(m.local_shards, shard_devices,
                                     tensor_devices))


def save(name, arrays, rec):
    np.savez(os.path.join(out, f"{name}.r{rank}.npz"), **arrays)
    with open(os.path.join(out, f"{name}.r{rank}.json"), "w") as f:
        json.dump(rec, f)


def report(name, st, **extra):
    """Every collective read of the store, then this rank's own tables."""
    rec = dict(extra)
    rec["n_unique"] = st.n_unique.tolist()
    rec["total_added"] = st.total_added.tolist()
    rec["peek"] = st.peek_n_unique()
    rec["spectrum"] = st.spectrum(300).tolist()
    rec["lookup"] = st.lookup(queries).tolist()
    rec["local"] = list(st.mesh.local_shards)
    rec["placed"] = placed(st.mesh, [s.device for s in st.shards],
                           [(s.keys.device, s.cnt.device) for s in st.shards])
    rec["home"] = str(st.device)
    rec["timings"] = {k: v for k, v in st.timings.items()
                      if isinstance(v, (int, float))}
    rec["reader"] = st.timings.get("reader")
    save(name, {**{f"k{d}": s.keys.numpy() for d, s in zip(
        st.mesh.local_shards, st.shards)}, **{f"c{d}": s.cnt.numpy()
        for d, s in zip(st.mesh.local_shards, st.shards)}}, rec)


def count(path, case, **kw):
    env = case.get("env", {})
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return api.count_kmers_fq_sh_rp(
            path, k=case["k"], min_q=spec["min_q"], exact_ll=case["mode"],
            mesh=mesh(), batch_rows=spec["rows"], **kw)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cat(blocks, cols):
    return (torch.cat(blocks) if blocks
            else torch.zeros((0, cols), dtype=torch.int32)).numpy()


for case in spec["cases"]:
    name, kind = case["name"], case["kind"]
    if kind == "exchange":
        m = mesh()
        owners, vals = [], []
        for s, n in enumerate(case["rows"][rank]):
            g = np.random.default_rng(100 + 10 * rank + s)
            choices = [d for d in range(spec["D"]) if d not in case["empty"]]
            owners.append(torch.from_numpy(g.choice(choices, n)).to(
                torch.int64).to(DEVICES[s]))
            vals.append((torch.arange(n, dtype=torch.int64) + 1000 * rank
                         + 100 * s).to(DEVICES[s]))
        pairs = [torch.stack([v * 3, -v], 1) for v in vals]
        stats = {}
        pieces = m.exchange(owners, vals, pairs, by_rank=True, stats=stats)
        whole = m.exchange(owners, vals, pairs)
        one_source = m.exchange(torch.cat([o.cpu() for o in owners]),
                                torch.cat([v.cpu() for v in vals]),
                                by_rank=True)
        arrays = {}
        for d, per_src, cat_d, one in zip(m.local_shards, pieces, whole,
                                           one_source):
            for rs, (v, pr) in enumerate(per_src):
                arrays[f"v{d}_{rs}"] = v.numpy()
                arrays[f"p{d}_{rs}"] = pr.numpy()
            arrays[f"v{d}"], arrays[f"p{d}"] = cat_d[0].numpy(), cat_d[1].numpy()
            arrays[f"one{d}"] = np.concatenate([p[0].numpy() for p in one])
        save(name, arrays, {"local": list(m.local_shards),
                            "n_pieces": [len(p) for p in pieces],
                            "n_one": [len(p) for p in one_source],
                            "bytes": stats["exchange_bytes"]})
    elif kind == "loop":
        with np.load(case["batch"] + f".r{rank}.npz") as z:
            batch = tuple(z[n] for n in ("seq", "qual", "lengths", "hq"))
        st = ShardedCountStore(21, mesh())
        stats = {}
        counting.count_batches(st, [batch], 21, min_q=spec["min_q"],
                               exact_ll="hybrid", stats=stats)
        report(name, st, flagged=stats["flagged_reads"])
    elif kind == "add":
        st = ShardedCountStore(case["k"], mesh(), counts_n=2)
        with np.load(case["adds"] + f".r{rank}.npz") as z:
            raw, valid = torch.from_numpy(z["raw"]), torch.from_numpy(z["valid"])
            run_raw, run_cnt = z["run_raw"], z["run_cnt"]
        st.add_batch(raw, valid, source=0)
        keys = torch.from_numpy(run_raw) ^ (-(2 ** 63))
        order = torch.argsort(keys)
        cnt = torch.zeros((keys.shape[0], 2), dtype=torch.int64)
        cnt[:, 1] = torch.from_numpy(run_cnt)
        st.add_run(keys[order], cnt[order], int(run_cnt.sum()), source=1)
        report(name, st)
    elif kind == "count":
        st = count(case["path"], case)
        rec = {}
        if case.get("depth"):
            for sem in ("intent", "c"):
                for i, s in enumerate(case["depth"]):
                    rec[f"depth_{sem}_{i}"] = api.seq_kmer_depth(
                        st, np.frombuffer(s.encode(), np.uint8), case["k"],
                        semantics=sem).tolist()
        report(name, st, **rec)
    elif kind == "save":
        st = count(case["path"], case)
        checkpoint.save_count_store(st, case["file"])
        report(name, st, saved=os.path.exists(case["file"]))
    elif kind == "load":
        st = checkpoint.load_count_store(case["file"], mesh=mesh())
        report(name, st)
    elif kind == "index":
        k = case["k"]
        load = lambda key: np.load(case[key])
        m = mesh()
        t = ShardedKmerIndex(load("seq"), k, m)
        rec = {"local": list(m.local_shards), "n_valid": t.n_valid.tolist(),
               "chunk": t.chunk, "total_kmers": t.total_kmers}
        arrays = {}
        for d, s in zip(m.local_shards, t.shards):
            arrays[f"hk{d}"], arrays[f"hp{d}"] = s.s_key.numpy(), s.s_pos.numpy()
        rp = t._range_partitioned()
        for d, s in zip(m.local_shards, rp):
            arrays[f"rk{d}"], arrays[f"rp{d}"] = s.s_key.numpy(), s.s_pos.numpy()
        rec["placed"] = placed(m, [m.device_of(d) for d in m.local_shards],
                               [(s.s_key.device, s.s_pos.device,
                                 r.s_key.device, r.s_pos.device)
                                for s, r in zip(t.shards, rp)])
        arrays["spl"] = t._rp_spl.numpy()
        tabs = t.tables(15)
        rec["kmer"] = tabs["kmer"]
        for f in ("pos", "pair.pos", "count"):
            arrays[f] = tabs[f].numpy()
        chunks = list(t.iter_pair_chunks(capacity=case["C"]))
        rec["pair_chunks"] = [c.shape[0] for c in chunks]
        arrays["pair_chunks"] = cat(chunks, 3)
        q = torch.from_numpy(load("q"))
        arrays["lookup"] = t.lookup_counts(q).numpy()
        arrays["positions"] = t.positions_of(q, max_hits_per_shard=case["C"]).numpy()
        if k <= 31:
            blocks = list(t.iter_seq_kmer_pos(load("query"), k,
                                              max_hits_per_shard=case["C"]))
            rec["skp_blocks"] = [b.shape[0] for b in blocks]
            arrays["skp"] = cat(blocks, 2)
        b = ShardedKmerIndex(load("other"), k, m)
        blocks = list(iter_kmer_pairs_sharded_chunks(t, b, capacity=case["C"]))
        rec["pair_blocks"] = [x.shape[0] for x in blocks]
        arrays["pairs"] = cat(blocks, 2)
        arrays["pairs_whole"] = kmer_pairs_sharded(t, b).numpy()
        rec["timings"] = t.timings
        save(name, arrays, rec)
    else:
        raise ValueError(kind)
print("WORKER_OK", rank, json.dumps(info))
'''


def add_inputs(rank: int):
    """A rank's add_batch rows (raw 32-mers, the all-G key among them; rank
    1 adds none) and add_run run (unique raw keys with counts)."""
    rng = np.random.default_rng(32 + rank)
    pool = rng.integers(0, 2 ** 64, 300, np.uint64)
    pool[:3] = [2 ** 64 - 1, 0, 2 ** 63]
    n = 0 if rank == 1 else 400
    raw = pool[rng.integers(0, pool.size, n)]
    valid = rng.random(n) < 0.9
    run_raw = np.unique(pool[rng.integers(0, pool.size, 120)])
    run_cnt = rng.integers(1, 5, run_raw.size).astype(np.int64)
    return raw.view(np.int64), valid, run_raw.view(np.int64), run_cnt


def depth_reads(path: Path):
    """Sequences the depth tracks are read on: the first two reads of the
    file, and the first read with an N run and its tail."""
    lines = path.read_bytes().split(b"\n")
    a, b = lines[1].decode(), lines[5].decode()
    return [a, b, a[:30] + "NNNNN" + a[30:] + b[:40]]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The files, the queries, the checkpoints and the index inputs every
    case shares."""
    d = tmp_path_factory.mktemp("inputs")
    f = {"dir": d, "main": d / "main.fq", "multi": d / "multi.fq",
         "gz": [d / f"part{i}.fq.gz" for i in range(3)]}
    f["main"].write_bytes(fastq_bytes(1, N_MAIN))
    f["multi"].write_bytes(multiline_fastq(3, 300))
    for i, (p, n) in enumerate(zip(f["gz"], (400, 250, 150))):
        p.write_bytes(gzip.compress(fastq_bytes(10 + i, n, "fasta")))
    single = one_process(f["main"], 21, "hybrid")
    keys = torch.cat([s.keys for s in single.shards])[::5] ^ -(2 ** 63)
    q = torch.cat([keys, torch.tensor([0, 7, 12345], dtype=torch.int64)])
    np.save(d / "queries.npy", q.numpy())
    f["queries"] = q
    jckpt.save_count_store(jax_store(f["main"], 21, "exact"), d / "jax8.npz")
    tckpt.save_count_store(single, d / "port8.npz")
    for r in range(P):
        seq, qual, lengths, hq = read_batch(500 + r, [300, 0][r])
        np.savez(d / f"loop.r{r}.npz", seq=seq, qual=qual, lengths=lengths,
                 hq=hq)
        raw, valid, run_raw, run_cnt = add_inputs(r)
        np.savez(d / f"add.r{r}.npz", raw=raw, valid=valid, run_raw=run_raw,
                 run_cnt=run_cnt)
    f["index"] = []
    for name, k in INDEX_CASES:
        seq, query, other = inputs_of(name, k)
        paths = {}
        for key, arr in (("seq", seq), ("query", query), ("other", other),
                         ("q", queries_of(KmerIndex(seq, k, device=CPU), k))):
            paths[key] = str(d / f"{name}_k{k}.{key}.npy")
            np.save(paths[key], arr)
        f["index"].append(dict(paths, name=f"ix_{name}_k{k}", kind="index",
                               k=k, C=C))
    f["depth"] = depth_reads(f["main"])
    return f


def cases_for(f: dict, out: Path) -> list:
    main, gz = str(f["main"]), [str(p) for p in f["gz"]]
    cases = [{"name": "exchange", "kind": "exchange", "rows": EXCHANGE_ROWS,
              "empty": list(EMPTY_OWNERS)},
             {"name": "loop", "kind": "loop", "batch": str(f["dir"] / "loop")},
             {"name": "add", "kind": "add", "k": ADD_K,
              "adds": str(f["dir"] / "add")}]
    cases += [{"name": f"b_k{k}_{mode}", "kind": "count", "path": main,
               "k": k, "mode": mode_arg(mode),
               "depth": f["depth"] if (k, mode) == (21, "hybrid") else None}
              for k, mode in ROUTE_B]
    cases += [
        {"name": "c_multiline", "kind": "count", "path": str(f["multi"]),
         "k": 21, "mode": "hybrid"},
        {"name": "c_plain_k32", "kind": "count", "path": main, "k": 32,
         "mode": False, "env": {"KMH_HOST_SLICE": "0"}},
        {"name": "a_gzip_k21", "kind": "count", "path": gz, "k": 21,
         "mode": "hybrid"},
        {"name": "a_gzip_k32", "kind": "count", "path": gz, "k": 32,
         "mode": True},
        {"name": "save", "kind": "save", "path": main, "k": 21,
         "mode": "hybrid", "file": str(out / "ranks.npz")},
        {"name": "load_jax", "kind": "load", "file": str(f["dir"] / "jax8.npz")},
        {"name": "load_port", "kind": "load",
         "file": str(f["dir"] / "port8.npz")},
    ]
    return cases + f["index"]


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """layout -> (output directory, cases by name), one spawn a layout."""
    res = {}
    for layout, devices in LAYOUTS.items():
        out = tmp_path_factory.mktemp(f"ranks_{layout}")
        cases = cases_for(inputs, out)
        spec = {"D": D, "min_q": MIN_Q, "rows": ROWS, "out": str(out),
                "devices": devices,
                "queries": str(inputs["dir"] / "queries.npy"),
                "cases": cases}
        env = dict(os.environ, OMP_NUM_THREADS="1", KMH_NATIVE_IO="1")
        spawn(out, P, spec, WORKER, env)
        res[layout] = (out, {c["name"]: c for c in cases})
    return res


def store_results(runs, layout: str, name: str):
    """(every rank's record, the D shard tables), each rank's shards where
    its devices put them."""
    out, _cases = runs[layout]
    recs, tables = rank_results(out, name, P)
    for r, rec in enumerate(recs):
        assert rec["local"] == list(range(r * D // P, (r + 1) * D // P))
        assert rec["placed"], f"rank {r}: a shard off its device"
        assert rec["home"] == str(as_device(LAYOUTS[layout][0]))
    return recs, tables


LAYOUT_IDS = list(LAYOUTS)


@pytest.mark.parametrize("layout", LAYOUT_IDS)
def test_exchange_two_sources_a_rank(runs, layout):
    """Every rank sends one source a device (one of them empty on rank 0,
    two owners empty everywhere): each local shard receives the P*M
    pieces in (rank, source) order, as one process's exchange of the four
    sources in that order gives them; one source a rank is made up to M
    with empty ones; the bytes sent to the other rank and copied to the
    other device are counted."""
    out, _cases = runs[layout]
    owners, vals = {}, {}
    for r in range(P):
        for s, n in enumerate(EXCHANGE_ROWS[r]):
            g = np.random.default_rng(100 + 10 * r + s)
            choices = [d for d in range(D) if d not in EMPTY_OWNERS]
            owners[r, s] = g.choice(choices, n)
            vals[r, s] = np.arange(n) + 1000 * r + 100 * s
    order = [(r, s) for r in range(P) for s in range(M)]
    v = [torch.from_numpy(vals[rs]).to(torch.int64) for rs in order]
    one = make_mesh(D, device=CPU, devices=[CPU] * 4).exchange(
        [torch.from_numpy(owners[rs]).to(torch.int64) for rs in order], v,
        [torch.stack([x * 3, -x], 1) for x in v])
    devs = [as_device(d) for d in LAYOUTS[layout]]
    # where a source's tensors really lie: a CPU tensor drops the index
    src_devs = [torch.empty(0, device=d).device for d in devs]
    for r in range(P):
        rec = json.loads((out / f"exchange.r{r}.json").read_text())
        assert rec["n_pieces"] == [P * M] * (D // P)
        assert rec["n_one"] == [P * M] * (D // P)
        mine = rec["local"]
        sent = 8 * M * (D // P) * (P - 1)
        for s in range(M):
            to_other = ~np.isin(owners[r, s], mine)
            sent += 24 * int(to_other.sum())
            for d in mine:  # rows to my shards on the other device
                if devs[(d - mine[0]) * M // len(mine)] != src_devs[s]:
                    sent += 24 * int((owners[r, s] == d).sum())
        assert rec["bytes"] == sent
        with np.load(out / f"exchange.r{r}.npz") as z:
            for d in mine:
                assert np.array_equal(z[f"v{d}"], one[d][0].numpy())
                assert np.array_equal(z[f"p{d}"], one[d][1].numpy())
                assert np.array_equal(z[f"one{d}"], one[d][0].numpy())
                for i, rs in enumerate(order):
                    want = vals[rs][owners[rs] == d]
                    assert np.array_equal(z[f"v{d}_{i}"], want)
    if layout == "repeated":  # nothing crosses devices
        rec = json.loads((out / "exchange.r0.json").read_text())
        assert rec["bytes"] == 8 * M * (D // P) + 24 * int(
            sum((~np.isin(owners[0, s], range(4))).sum() for s in range(M)))


@pytest.mark.parametrize("layout", LAYOUT_IDS)
def test_count_batches_with_an_empty_rank(runs, inputs, layout):
    """``count_batches`` on each rank with its own batch, rank 1's of no
    rows (its adds are empty turns in the exchanges): the one-process store
    of both batches, ``flagged_reads`` summed over the ranks, and the JAX
    store of the same batch."""
    recs, tables = store_results(runs, layout, "loop")
    single = ShardedCountStore(21, make_mesh(D, device=CPU))
    stats = {}
    batch = read_batch(500, 300)
    counting.count_batches(single, [batch], 21, min_q=MIN_Q,
                           exact_ll="hybrid", stats=stats)
    assert_matches(recs, tables, single, inputs["queries"])
    assert stats["flagged_reads"] > 0
    assert all(r["flagged"] == stats["flagged_reads"] for r in recs)
    j = JShardedCountStore(21, jmake_mesh(D))
    pad = -len(batch[2]) % D
    seq, qual, lengths, hq = (np.concatenate([a, np.full((pad, *a.shape[1:]),
                                                         fill, a.dtype)])
                              for a, fill in zip(batch, (78, 0, 0, False)))
    from kmer_hasher_tpu.qll import Q_TO_LL

    j.add_reads(seq, qual, lengths, hq, float(Q_TO_LL[33 + MIN_Q]),
                precision="exact", with_noq=bool((~hq & (lengths > 21)).any()),
                min_q_char=33 + MIN_Q,
                n_win=counting.win_bucket(lengths.max(), 21), with_q=True)
    assert_same_tables(tables, jax_tables(j))


@pytest.mark.parametrize("layout", LAYOUT_IDS)
def test_add_batch_and_add_run(runs, inputs, layout):
    """``add_batch`` (raw 32-mers with the all-G key; rank 1 adds no rows)
    and ``add_run`` (a sorted run with counts, source 1) on every rank:
    the one-process store of both ranks' adds, and the JAX store given the
    same observations through its ``add_batch``."""
    recs, tables = store_results(runs, layout, "add")
    single = ShardedCountStore(ADD_K, make_mesh(D, device=CPU), counts_n=2)
    j = JShardedCountStore(ADD_K, jmake_mesh(D), counts_n=2)
    adds = [add_inputs(r) for r in range(P)]
    for r, (raw, valid, run_raw, run_cnt) in enumerate(adds):
        single.add_batch(torch.from_numpy(raw), torch.from_numpy(valid))
    for raw, valid, run_raw, run_cnt in adds:
        keys = torch.from_numpy(run_raw) ^ -(2 ** 63)
        order = torch.argsort(keys)
        cnt = torch.zeros((keys.shape[0], 2), dtype=torch.int64)
        cnt[:, 1] = torch.from_numpy(run_cnt)
        single.add_run(keys[order], cnt[order], int(run_cnt.sum()), source=1)

    def jadd(raw, valid, source):
        pad = -raw.size % D
        raw = np.concatenate([raw, np.zeros(pad, np.int64)]).view(np.uint64)
        valid = np.concatenate([valid, np.zeros(pad, bool)])
        j.add_batch((raw >> np.uint64(32)).astype(np.uint32).reshape(D, -1),
                    raw.astype(np.uint32).reshape(D, -1),
                    valid.reshape(D, -1), source=source)

    jadd(np.concatenate([a[0] for a in adds]),
         np.concatenate([a[1] for a in adds]), 0)
    expanded = np.concatenate([np.repeat(a[2], a[3]) for a in adds])
    jadd(expanded, np.ones(expanded.size, bool), 1)
    assert_matches(recs, tables, single, inputs["queries"], j)
    assert any((t[0] == np.uint64(2 ** 64 - 1)).any() for t in tables)


@pytest.mark.parametrize("layout", LAYOUT_IDS)
@pytest.mark.parametrize("k,mode", ROUTE_B)
def test_route_b_byte_ranges(runs, inputs, layout, k, mode):
    """One plain FASTQ, each rank parsing only its byte range and dealing
    its batches to its devices: the one-process store and the JAX store;
    rows crossed to the other rank, and in the split layout to the other
    device."""
    recs, tables = store_results(runs, layout, f"b_k{k}_{mode}")
    assert_matches(recs, tables, one_process(inputs["main"], k,
                                             mode_arg(mode)),
                   inputs["queries"], jax_store(inputs["main"], k, mode))
    reads = [r["timings"]["file_reads"] for r in recs]
    assert sum(reads) == N_MAIN and max(reads) < N_MAIN
    assert all(r["timings"]["exchange_bytes"] > 0 for r in recs)


@pytest.mark.parametrize("semantics", ["intent", "c"])
@pytest.mark.parametrize("layout", LAYOUT_IDS)
def test_depth_on_the_sharded_store(runs, inputs, layout, semantics):
    """``seq_kmer_depth`` on the store over the ranks (every rank's lookup
    a collective): the one-process group's, the single store's and the
    JAX single store's track, in both semantics."""
    recs, _tables = store_results(runs, layout, "b_k21_hybrid")
    logical = one_process(inputs["main"], 21, "hybrid")
    single = api.count_kmers_fq_sh_rp(str(inputs["main"]), k=21,
                                      min_q=MIN_Q, exact_ll="hybrid",
                                      device=CPU, batch_rows=ROWS)
    j = japi.count_kmers_fq_sh_rp(str(inputs["main"]), k=21, min_q=MIN_Q,
                                  exact_ll=True)
    assert isinstance(j, JCountStore)
    for i, s in enumerate(inputs["depth"]):
        seq = np.frombuffer(s.encode(), np.uint8).copy()
        want = api.seq_kmer_depth(single, seq, 21, semantics=semantics)
        assert torch.equal(api.seq_kmer_depth(logical, seq, 21,
                                              semantics=semantics), want)
        assert np.array_equal(np.asarray(japi.seq_kmer_depth(
            j, s, 21, semantics=semantics)), want.numpy())
        assert int((want > 0).sum()) > 0
        for rec in recs:
            assert rec[f"depth_{semantics}_{i}"] == want.tolist()


LOCKSTEP = [("c_multiline", "multi", 21, "hybrid", False),
            ("c_plain_k32", "main", 32, False, True)]


@pytest.mark.parametrize("layout", LAYOUT_IDS)
@pytest.mark.parametrize("name,src,k,mode,with_jax", LOCKSTEP)
def test_route_c_lockstep(runs, inputs, layout, name, src, k, mode,
                          with_jax):
    """Lockstep: a multi-line FASTQ (with FASTA records), and a plain one
    with ``KMH_HOST_SLICE=0``: every rank reads every record and each of
    its devices counts its block of every batch; the one-process store,
    and for the plain file the JAX store."""
    recs, tables = store_results(runs, layout, name)
    path = inputs[src]
    assert_matches(recs, tables, one_process(path, k, mode),
                   inputs["queries"],
                   jax_store(path, k, "fast" if mode is False else mode)
                   if with_jax else None)
    n = N_MAIN if src == "main" else 300
    assert [r["timings"]["file_reads"] for r in recs] == [n] * P


@pytest.mark.parametrize("layout", LAYOUT_IDS)
@pytest.mark.parametrize("k,mode", [(21, "hybrid"), (32, True)])
def test_route_a_gzip_files(runs, inputs, layout, k, mode):
    """Three gzip files dealt to the ranks, each rank's batches dealt to its
    devices: the one-process store and the JAX store."""
    recs, tables = store_results(runs, layout, f"a_gzip_k{k}")
    assert_matches(recs, tables, one_process(inputs["gz"], k, mode),
                   inputs["queries"],
                   jax_store(inputs["gz"], k, "exact"))
    assert sorted(r["timings"]["file_reads"] for r in recs) == [400, 400]


@pytest.mark.parametrize("layout", LAYOUT_IDS)
def test_checkpoint_saved_by_ranks_loads_in_both_packages(runs, inputs,
                                                          layout):
    """The ranks' collective save (each shard taken to the host from its
    device) loads onto the one-process group, into one store and onto the
    JAX mesh."""
    out, _cases = runs[layout]
    recs, tables = store_results(runs, layout, "save")
    assert all(r["saved"] for r in recs)
    single = one_process(inputs["main"], 21, "hybrid")
    assert_matches(recs, tables, single, inputs["queries"])
    p = out / "ranks.npz"
    back = tckpt.load_count_store(p, mesh=make_mesh(D, device=CPU))
    assert_same_tables(port_tables(back), port_tables(single))
    assert back.total_added.tolist() == single.total_added.tolist()
    whole = tckpt.load_count_store(p, device=CPU)
    assert whole.n_unique == int(single.n_unique.sum())
    j = jckpt.load_count_store(p, mesh=jmake_mesh(D))
    assert_same_tables(jax_tables(j), port_tables(single))
    assert np.asarray(j.total_added).tolist() == single.total_added.tolist()


@pytest.mark.parametrize("layout", LAYOUT_IDS)
@pytest.mark.parametrize("name", ["load_jax", "load_port"])
def test_checkpoints_load_onto_the_ranks(runs, inputs, layout, name):
    """The JAX package's and the one-process group's 8-shard files onto
    the ranks: each rank installs its shards, each on its own device."""
    recs, tables = store_results(runs, layout, name)
    assert_matches(recs, tables, one_process(inputs["main"], 21, "hybrid"),
                   inputs["queries"], jax_store(inputs["main"], 21, "exact"))


# -- the sharded index --------------------------------------------------------

INDEX_ORACLES = {}


def index_oracle(name: str, k: int):
    if (name, k) not in INDEX_ORACLES:
        seq, query, other = inputs_of(name, k)
        t = ShardedKmerIndex(seq, k, make_mesh(D, device=CPU))
        one = KmerIndex(seq, k, device=CPU)
        b = ShardedKmerIndex(other, k, make_mesh(D, device=CPU))
        q = torch.from_numpy(queries_of(one, k))
        lb, ub = one.lookup_range(q)
        o = {"t": t, "one": one, "tables": t.tables(15),
             "single": one.tables(15),
             "pair_chunks": list(t.iter_pair_chunks(capacity=C)),
             "pairs": list(iter_kmer_pairs_sharded_chunks(t, b, capacity=C)),
             "single_pairs": kmer_pairs(one, KmerIndex(other, k, device=CPU)),
             "lookup": (ub - lb).to(torch.int32),
             "positions": torch.sort(torch.cat([
                 one.s_pos[a:z] for a, z in zip(lb.tolist(), ub.tolist())]
             )).values, "seq": seq, "query": query, "other": other}
        if k <= 31:
            o["skp"] = list(t.iter_seq_kmer_pos(query, k,
                                                max_hits_per_shard=C))
            o["single_skp"] = seq_kmer_pos(one, query, k)
        INDEX_ORACLES[name, k] = o
    return INDEX_ORACLES[name, k]


def index_results(runs, layout: str, name: str, k: int):
    out, _cases = runs[layout]
    res = []
    for r in range(P):
        stem = f"ix_{name}_k{k}.r{r}"
        rec = json.loads((out / f"{stem}.json").read_text())
        with np.load(out / f"{stem}.npz") as z:
            res.append((rec, {f: z[f] for f in z.files}))
        assert rec["local"] == list(range(r * D // P, (r + 1) * D // P))
        assert rec["placed"], f"rank {r}: a shard off its device"
    return res


@pytest.mark.parametrize("layout", LAYOUT_IDS)
@pytest.mark.parametrize("name,k", INDEX_CASES)
def test_index_shards_and_tables(runs, layout, name, k):
    """Each device encodes its own rows (the short input's rank 1 holds
    only chunks past the end) and every rank's hash and range shards, the
    splitters' answers, tables(15) and the pair chunks equal the
    one-process index's and the single index's."""
    o = index_oracle(name, k)
    t, rp = o["t"], o["t"]._range_partitioned()
    for rec, z in index_results(runs, layout, name, k):
        assert rec["n_valid"] == t.n_valid.tolist()
        assert (rec["chunk"], rec["total_kmers"]) == (t.chunk, o["one"].n_valid)
        for d in rec["local"]:
            assert same(z[f"hk{d}"], t.shards[d].s_key), f"hash shard {d}"
            assert same(z[f"hp{d}"], t.shards[d].s_pos), f"hash shard {d}"
            assert same(z[f"rk{d}"], rp[d].s_key), f"range shard {d}"
            assert same(z[f"rp{d}"], rp[d].s_pos), f"range shard {d}"
        assert same(z["spl"], t._rp_spl)
        assert rec["kmer"] == o["tables"]["kmer"] == o["single"]["kmer"]
        for f in ("pos", "pair.pos", "count"):
            assert same(z[f], o["tables"][f]) and same(z[f], o["single"][f])
        assert rec["pair_chunks"] == [c.shape[0] for c in o["pair_chunks"]]
        assert same(z["pair_chunks"], cat(o["pair_chunks"], 3))
        tm = rec["timings"]
        assert tm["exchanges"] == 2 and tm["gathers"] > 0


@pytest.mark.parametrize("layout", LAYOUT_IDS)
@pytest.mark.parametrize("name,k", INDEX_CASES)
def test_index_queries_and_pair_streams(runs, layout, name, k):
    """lookup_counts, positions_of (16 hits a shard a round), the
    seq_kmer_pos blocks and the cross-index pair blocks in the one-process
    blocks, and kmer_pairs_sharded the single index's kmer_pairs."""
    o = index_oracle(name, k)
    for rec, z in index_results(runs, layout, name, k):
        assert same(z["lookup"], o["lookup"])
        assert same(z["positions"], o["positions"])
        if k <= 31:
            assert rec["skp_blocks"] == [b.shape[0] for b in o["skp"]]
            assert same(z["skp"], cat(o["skp"], 2))
            assert same(z["skp"], o["single_skp"])
        assert rec["pair_blocks"] == [b.shape[0] for b in o["pairs"]]
        assert same(z["pairs"], cat(o["pairs"], 2))
        assert same(z["pairs_whole"], o["single_pairs"])


@pytest.mark.parametrize("layout", LAYOUT_IDS)
@pytest.mark.parametrize("name,k", JAX_INDEX)
def test_index_equals_the_jax_index(runs, layout, name, k):
    """The ranks' hash shards, tables and query rows against the JAX
    ShardedKmerIndex on the 8-device CPU mesh."""
    o = index_oracle(name, k)
    j = JShardedKmerIndex(o["seq"], k, jmake_mesh(D))
    jtabs = j.tables(15)
    for rec, z in index_results(runs, layout, name, k):
        assert rec["n_valid"] == np.asarray(j.n_valid).tolist()
        for d in rec["local"]:
            n = int(j.n_valid[d])
            want = ((np.asarray(j.s_hi[d, :n]).astype(np.uint64)
                     << np.uint64(32)) | np.asarray(j.s_lo[d, :n]))
            assert np.array_equal(raw_u64(z[f"hk{d}"]), want)
            assert np.array_equal(z[f"hp{d}"], np.asarray(j.s_pos[d, :n]))
        assert rec["kmer"] == jtabs["kmer"]
        for f in ("pos", "pair.pos", "count"):
            assert np.array_equal(z[f], np.asarray(jtabs[f])), f
        if k <= 31:
            assert np.array_equal(z["skp"],
                                  np.asarray(j.seq_kmer_pos(o["query"], k)))


# -- without a spawn ------------------------------------------------------------

def fake_ranks(monkeypatch, rank: int, n_devices) -> None:
    """A process group of P faked for the mesh, as rank ``rank`` sees it;
    ``n_devices`` is what the ranks' allgather of their device counts
    reports."""
    monkeypatch.setattr(tmesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(tdist, "process_count", lambda: P)
    monkeypatch.setattr(tdist, "process_index", lambda: rank)
    monkeypatch.setattr(tdist, "allgather", lambda v: np.array(
        [[c] for c in n_devices], np.int64))


def faked_group(monkeypatch, rank: int, devices, n_devices=None):
    """``make_mesh(D, distributed=True, devices=devices)`` as rank ``rank``
    of P sees it (every rank naming ``len(devices)`` devices unless
    ``n_devices`` says otherwise)."""
    fake_ranks(monkeypatch, rank, n_devices or [len(devices)] * P)
    return make_mesh(D, distributed=True, devices=devices)


@pytest.mark.parametrize("rank", [0, 1])
def test_device_of_on_a_process_layout(monkeypatch, rank):
    """Rank p's shards p*4 ... p*4 + 3 in blocks of 2 over its own two
    devices: shard 4's and 5's device is rank 1's first, 6's and 7's its
    second; another rank's shard raises."""
    g = faked_group(monkeypatch, rank, [CPU, torch.device(CPU, 0)])
    first = 4 * rank
    assert g.local_shards == range(first, first + 4)
    assert [g.device_of(d) for d in g.local_shards] == (
        [torch.device(CPU)] * 2 + [torch.device(CPU, 0)] * 2)
    assert [g.shards_on(i) for i in range(M)] == [
        range(first, first + 2), range(first + 2, first + 4)]
    assert g.device == torch.device(CPU) and g.distributed and g.multi_device
    other = 4 * (1 - rank)
    with pytest.raises(ValueError, match="not this process's"):
        g.device_of(other)
    st = ShardedCountStore(21, g)  # each local shard on its own device
    assert [s.device for s in st.shards] == [g.device_of(d)
                                             for d in g.local_shards]


def test_process_layout_refusals(monkeypatch):
    """M must divide a rank's D/P shards, and every rank must name as many
    devices; the hierarchical group takes both spreads."""
    with pytest.raises(ValueError, match="4 shards a process do not split "
                                         "evenly over 3 devices"):
        faked_group(monkeypatch, 0, [CPU] * 3)
    with pytest.raises(ValueError, match="evenly over 8 devices"):
        faked_group(monkeypatch, 0, [CPU] * 8)
    with pytest.raises(ValueError, match="every rank must name as many"):
        faked_group(monkeypatch, 1, [CPU] * 2, n_devices=[4, 2])
    fake_ranks(monkeypatch, 1, [2, 2])
    h = tmesh.make_hierarchical_mesh(2, 4, distributed=True,
                                     devices=[CPU, torch.device(CPU, 0)])
    assert (h.shape, h.local_shards) == ((2, 4), range(4, 8))
    assert [h.device_of(d) for d in (4, 5, 6, 7)] == (
        [torch.device(CPU)] * 2 + [torch.device(CPU, 0)] * 2)


@pytest.mark.parametrize("rank", [0, 1])
def test_lockstep_rows_nest_per_rank_and_device(rank):
    """Route (c): a 253-row batch padded once to 256, then rank p's block,
    then each of its two devices' blocks with no second padding: rank p's
    device i holds block 2p + i of the padded batch cut into 4, the rows
    the JAX mesh of 2 hosts x 2 chips gives each chip."""
    class Group:
        process_count, process_index, size = P, rank, D
        local_shards = range(rank * D // P, (rank + 1) * D // P)

    batch = read_batch(7, 253)
    (mine,) = [b[:4] for b in counting._lockstep_rows([batch], Group)]
    got = counting._row_blocks(mine, len(Group.local_shards), M)
    want = counting._row_blocks(batch, D, P * M)[rank * M: rank * M + M]
    assert [b[2].shape[0] for b in got] == [64, 64]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert np.array_equal(a, b)
    if rank == 1:  # the padding's empty rows at the end of the last block
        assert (got[1][2][-3:] == 0).all() and not got[1][3][-3:].any()
