"""The port's sharded count store over several processes: 2 and 4 gloo
ranks on the CPU, started as subprocesses, against the port's one-process
``ShardedCountStore`` on ``make_mesh(8, device="cpu")`` and the JAX
package's on the 8-device CPU mesh (``conftest.py``), bitwise: every
shard's keys and counts, ``total_added``, ``n_unique``, the spectrum and
lookups, as every rank reads them.

One spawn per process count runs every case of that count (one worker
script, each case's results written to files, one JSON line a rank); each
case is then one test. The cases: the exchange alone; route (b), byte
ranges of one plain FASTQ (k 21 and 32, fast / exact / hybrid) and of a
FASTA without qualities; a multi-line FASTQ, which goes to lockstep (c);
route (a), three gzip files dealt to the ranks, with
``KMH_FILE_PARTITION`` unset, "0" and "1"; a short list of plain files,
sliced file by file; route (c): a lone gzip file (warned about once),
``max_reads`` with checkpoints, then ``skip_reads`` from the reloaded
checkpoint; spill to one directory that every rank shares; sharded
checkpoints saved by the ranks and loaded by either package, and a JAX
checkpoint loaded onto the ranks."""
import gzip
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import kmer_hasher_tpu  # noqa: F401  (x64, the JAX package's setting)
from kmer_hasher_tpu import api as japi
from kmer_hasher_tpu.parallel import make_mesh as jmake_mesh
from kmer_hasher_tpu.utils import checkpoint as jckpt
from kmer_hasher_tpu_torch import api
from kmer_hasher_tpu_torch.parallel import ShardedCountStore, make_mesh
from kmer_hasher_tpu_torch.utils import checkpoint as tckpt

REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"
D = 8
READ_LEN = 151
MIN_Q = 0  # the f32 filter flags reads of these qualities at q0
ROWS = 256  # reads per batch: the ranks read different numbers of batches
N_MAIN = 2400
CUT = 1000  # the run cut by max_reads, resumed by skip_reads
CKPT_EVERY = 300
SPAWN_TIMEOUT = 300  # seconds a spawn may take before every rank is killed
SIGN = -(2 ** 63)

ROUTE_B = [(k, mode) for k in (21, 32) for mode in ("fast", "exact",
                                                      "hybrid")]
EXCHANGE_ROWS = {2: [37, 0], 4: [50, 0, 13, 1]}
LOOP_ROWS = {2: [300, 0], 4: [300, 0, 120, 45]}  # count_batches, a batch a rank
EMPTY_OWNERS = (2, 5)  # no rank routes a row to these shards


def read_batch(seed: int, rows: int):
    """Reads as ``test_torch_sharded.read_batch`` makes them, 40-151
    bases: 1% N, borderline-rich qualities, 5% of rows without
    qualities."""
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, (rows, READ_LEN))].copy()
    seq[rng.random(seq.shape) < 0.01] = ord("N")
    lengths = rng.integers(40, READ_LEN + 1, rows).astype(np.int32)
    qual = rng.integers(35, 74, (rows, READ_LEN)).astype(np.uint8)
    low = rng.random(qual.shape) < 0.1
    qual[low] = rng.integers(33, 40, int(low.sum())).astype(np.uint8)
    has_qual = rng.random(rows) >= 0.05
    return seq, qual, lengths, has_qual


def fastq_bytes(seed: int, rows: int, no_qual: str = "qual") -> bytes:
    """4-line FASTQ of ``read_batch``'s reads. The rows without qualities
    become records with 'I' qualities (``no_qual="qual"``), FASTA records
    (``"fasta"``), or are dropped from a FASTA-only file (``"only"``:
    every read a FASTA record)."""
    seq, qual, lengths, hq = read_batch(seed, rows)
    out = []
    for i in range(rows):
        n = int(lengths[i])
        s = seq[i, :n].tobytes()
        if no_qual == "only" or (no_qual == "fasta" and not hq[i]):
            out.append(b">r%d\n%s\n" % (i, s))
        else:
            q = qual[i, :n].tobytes() if hq[i] else b"I" * n
            out.append(b"@r%d\n%s\n+\n%s\n" % (i, s, q))
    return b"".join(out)


def multiline_fastq(seed: int, rows: int) -> bytes:
    """Sequence and quality split over two lines each, every tenth record
    a FASTA record without qualities."""
    seq, qual, lengths, _hq = read_batch(seed, rows)
    out = []
    for i in range(rows):
        n = int(lengths[i])
        s, q = seq[i, :n].tobytes(), qual[i, :n].tobytes()
        h = n // 2
        if i % 10 == 3:
            out.append(b">m%d\n%s\n%s\n" % (i, s[:h], s[h:]))
        else:
            out.append(b"@m%d\n%s\n%s\n+\n%s\n%s\n" % (i, s[:h], s[h:],
                                                        q[:h], q[h:]))
    return b"".join(out)


WORKER = r'''
import json, os, sys, warnings
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
torch.set_num_threads(1)
from kmer_hasher_tpu_torch import api
from kmer_hasher_tpu_torch.index.count_store import CountStore
from kmer_hasher_tpu_torch.parallel import ShardedCountStore, make_mesh
from kmer_hasher_tpu_torch.utils import checkpoint

rdzv, P, rank, spec_path = sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
info = api.init_distributed(rdzv, world_size=P, rank=rank)
assert info["process_index"] == rank and info["process_count"] == P, info
spec = json.loads(open(spec_path).read())
out = spec["out"]
queries = torch.from_numpy(np.load(spec["queries"]))


def mesh():
    return make_mesh(spec["D"], device="cpu", distributed=True)


def report(name, st, **extra):
    """Every collective read of the store, then this rank's own tables."""
    rec = dict(extra)
    rec["n_unique"] = st.n_unique.tolist()
    rec["total_added"] = st.total_added.tolist()
    rec["peek"] = st.peek_n_unique()
    rec["spectrum"] = st.spectrum(300).tolist()
    rec["lookup"] = st.lookup(queries).tolist()
    rec["local"] = list(st.mesh.local_shards)
    rec["timings"] = {k: v for k, v in st.timings.items()
                      if isinstance(v, (int, float))}
    rec["shard_timings"] = st.shard_timings()
    rec["reader"] = st.timings.get("reader")
    np.savez(os.path.join(out, f"{name}.r{rank}.npz"), **{
        f"k{d}": s.keys.numpy() for d, s in zip(st.mesh.local_shards,
                                                st.shards)}, **{
        f"c{d}": s.cnt.numpy() for d, s in zip(st.mesh.local_shards,
                                               st.shards)})
    with open(os.path.join(out, f"{name}.r{rank}.json"), "w") as f:
        json.dump(rec, f)


def count(path, case, **kw):
    env = case.get("env", {})
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            st = api.count_kmers_fq_sh_rp(
                path, k=case["k"], min_q=spec["min_q"],
                exact_ll=case["mode"], mesh=mesh(),
                batch_rows=spec["rows"], **kw)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    n_warn = sum(issubclass(w.category, RuntimeWarning) for w in caught)
    return st, n_warn


for case in spec["cases"]:
    name, kind = case["name"], case["kind"]
    if kind == "exchange":
        g = np.random.default_rng(100 + rank)
        n = case["rows"][rank]
        choices = [d for d in range(spec["D"]) if d not in case["empty"]]
        owner = torch.from_numpy(g.choice(choices, n)).to(torch.int64)
        vals = torch.arange(n, dtype=torch.int64) + 1000 * rank
        pairs = torch.stack([vals * 3, -vals], 1)
        m = mesh()
        pieces = m.exchange(owner, vals, pairs, by_rank=True)
        whole = m.exchange(owner, vals, pairs)
        arrays = {}
        for d, per_rank, cat in zip(m.local_shards, pieces, whole):
            for r, (v, pr) in enumerate(per_rank):
                arrays[f"v{d}_{r}"] = v.numpy()
                arrays[f"p{d}_{r}"] = pr.numpy()
            arrays[f"v{d}"] = cat[0].numpy()
            arrays[f"p{d}"] = cat[1].numpy()
        np.savez(os.path.join(out, f"{name}.r{rank}.npz"), **arrays)
        with open(os.path.join(out, f"{name}.r{rank}.json"), "w") as f:
            json.dump({"local": list(m.local_shards)}, f)
    elif kind == "loop":
        from kmer_hasher_tpu_torch import counting
        with np.load(case["batch"] + f".r{rank}.npz") as z:
            batch = tuple(z[n] for n in ("seq", "qual", "lengths", "hq"))
        st = ShardedCountStore(21, mesh())
        stats = {}
        counting.count_batches(st, [batch], 21, min_q=spec["min_q"],
                               exact_ll="hybrid", stats=stats)
        report(name, st, flagged=stats["flagged_reads"])
    elif kind == "count":
        st, n_warn = count(case["path"], case)
        report(name, st, warnings=n_warn)
    elif kind == "warn_twice":
        w1 = count(case["path"], case)[1]
        st, w2 = count(case["path"], case)
        report(name, st, warnings=[w1, w2])
    elif kind == "cut_resume":
        ck = case["ckpt"]
        part, _ = count(case["path"], case, max_reads=case["cut"],
                        checkpoint_every=case["every"], checkpoint_path=ck)
        prog = checkpoint.load_progress(ck)
        back = checkpoint.load_count_store(ck, mesh=mesh())
        report(name + "_part", back, progress=prog)
        st, _ = count(case["path"], case, store=back,
                      skip_reads=case["cut"])
        report(name, st)
    elif kind == "spill":
        # one store's runs spilled to the shared directory, listed by every
        # rank before any rank reads its back
        one = CountStore(21, spill_bytes=1, spill_dir=case["dir"],
                         device="cpu")
        g = torch.Generator().manual_seed(rank)
        for _ in range(3):
            keys = torch.unique(torch.randint(-2 ** 62, 2 ** 62, (64,),
                                              generator=g))
            one.add_run(keys, torch.ones((keys.shape[0], 1),
                                         dtype=torch.int64), 64)
        one_mesh = mesh()
        one_mesh.barrier()
        names = sorted(os.listdir(case["dir"]))
        one_mesh.barrier()
        n_one = one.n_unique
        one_mesh.barrier()
        st = ShardedCountStore(case["k"], mesh(), spill_bytes=case["bytes"],
                               spill_dir=case["dir"])
        st, _ = count(case["path"], case, store=st)
        st.mesh.barrier()  # every rank has folded its spilled runs
        report(name, st, left=sorted(os.listdir(case["dir"])),
               pid=os.getpid(), spilled=names, one_spills=one.timings[
                   "spills"], n_one=n_one)
    elif kind == "save":
        st, _ = count(case["path"], case)
        checkpoint.save_count_store(st, case["file"])
        report(name, st, saved=os.path.exists(case["file"]))
    elif kind == "load":
        st = checkpoint.load_count_store(case["file"], mesh=mesh())
        report(name, st)
    else:
        raise ValueError(kind)
print("WORKER_OK", rank, json.dumps(info))
'''


def spawn(tmp: Path, P: int, spec: dict, worker: str = WORKER,
          env: dict = None) -> list:
    """P gloo ranks running ``worker`` over ``spec``'s cases, in ``env``
    (by default this process's, one OpenMP thread and the native reader);
    every rank must exit 0 within SPAWN_TIMEOUT seconds, or every rank is
    killed and the test fails. Returns each rank's stdout."""
    (tmp / "worker.py").write_text(worker)
    (tmp / "spec.json").write_text(json.dumps(spec))
    rdzv = f"file://{tmp / 'rendezvous'}"
    if env is None:
        env = dict(os.environ, OMP_NUM_THREADS="1", KMH_NATIVE_IO="1")
    procs = [subprocess.Popen(
        [sys.executable, str(tmp / "worker.py"), str(REPO), rdzv, str(P),
         str(r), str(tmp / "spec.json")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for r in range(P)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=SPAWN_TIMEOUT)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"the {P} ranks did not finish in {SPAWN_TIMEOUT} s")
    bad = [f"rank {r} exited with {rc}:\n{out[-1000:]}\n{err[-3000:]}"
           for r, (rc, out, err) in enumerate(outs)
           if rc != 0 or "WORKER_OK" not in out]
    assert not bad, "\n".join(bad)
    return [o[1] for o in outs]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The files, the one-process oracles and the queries every case
    shares."""
    d = tmp_path_factory.mktemp("inputs")
    f = {"main": d / "main.fq", "fasta": d / "reads.fa",
         "multi": d / "multi.fq",
         "gz": [d / f"part{i}.fq.gz" for i in range(3)]}
    f["main"].write_bytes(fastq_bytes(1, N_MAIN))
    f["fasta"].write_bytes(fastq_bytes(2, 600, "only"))
    f["multi"].write_bytes(multiline_fastq(3, 400))
    for i, (p, n) in enumerate(zip(f["gz"], (800, 500, 300))):
        p.write_bytes(gzip.compress(fastq_bytes(10 + i, n, "fasta")))
    single = one_process(f["main"], 21, True)
    keys = torch.cat([s.keys for s in single.shards])[::5] ^ SIGN
    q = torch.cat([keys, torch.tensor([0, 7, 12345], dtype=torch.int64)])
    np.save(d / "queries.npy", q.numpy())
    # a JAX sharded checkpoint for the ranks to load
    j = japi.count_kmers_fq_sh_rp(str(f["main"]), k=21, min_q=MIN_Q,
                                  exact_ll=True, mesh=jmake_mesh(D))
    jckpt.save_count_store(j, d / "jax8.npz")
    f.update(dir=d, queries=q, jax_main=j)
    return f


ONE_PROCESS = {}


def one_process(path, k: int, mode, **kw) -> ShardedCountStore:
    """The port's one-process 8-shard store of ``path`` (a file or list),
    kept for the module."""
    key = (str(path), k, str(mode), tuple(sorted(kw.items())))
    if key not in ONE_PROCESS:
        paths = [str(p) for p in path] if isinstance(path, list) else str(
            path)
        ONE_PROCESS[key] = api.count_kmers_fq_sh_rp(
            paths, k=k, min_q=MIN_Q, exact_ll=mode,
            mesh=make_mesh(D, device=CPU), batch_rows=ROWS, **kw)
    return ONE_PROCESS[key]


JAX = {}


def jax_store(path, k: int, mode):
    """The JAX package's store of ``path`` on the 8-device CPU mesh
    (hybrid is exact, bitwise, so it shares exact's)."""
    mode = True if mode in ("exact", "hybrid") else False
    key = (str(path), k, mode)
    if key not in JAX:
        paths = [str(p) for p in path] if isinstance(path, list) else str(
            path)
        JAX[key] = japi.count_kmers_fq_sh_rp(
            paths, k=k, min_q=MIN_Q, exact_ll=mode, mesh=jmake_mesh(D))
    return JAX[key]


def mode_arg(mode):
    return {"fast": False, "exact": True}.get(mode, mode)


def cases_for(P: int, f: dict, out: Path) -> list:
    main, gz = str(f["main"]), [str(p) for p in f["gz"]]
    for r, rows in enumerate(LOOP_ROWS[P]):
        seq, qual, lengths, hq = read_batch(500 + r, rows)
        np.savez(out / f"loop.r{r}.npz", seq=seq, qual=qual,
                 lengths=lengths, hq=hq)
    cases = [{"name": "exchange", "kind": "exchange",
              "rows": EXCHANGE_ROWS[P], "empty": list(EMPTY_OWNERS)},
             {"name": "loop", "kind": "loop", "batch": str(out / "loop")}]
    cases += [{"name": f"b_k{k}_{mode}", "kind": "count", "path": main,
               "k": k, "mode": mode_arg(mode)} for k, mode in ROUTE_B]
    cases += [
        {"name": "b_fasta", "kind": "count", "path": str(f["fasta"]),
         "k": 21, "mode": False},
        {"name": "c_multiline", "kind": "count", "path": str(f["multi"]),
         "k": 21, "mode": "hybrid"},
        {"name": "c_gzip", "kind": "warn_twice", "path": gz[0], "k": 21,
         "mode": "hybrid"},
        {"name": "a_gzip", "kind": "count", "path": gz, "k": 21,
         "mode": "hybrid"},
        {"name": "spill", "kind": "spill", "path": main, "k": 21,
         "mode": True, "bytes": 4096, "dir": str(out / "spill")},
    ]
    if P == 2:
        cases += [
            {"name": "b_python", "kind": "count", "path": main, "k": 21,
             "mode": "hybrid", "env": {"KMH_NATIVE_IO": "0"}},
            {"name": "a_gzip_fp0", "kind": "count", "path": gz, "k": 21,
             "mode": True, "env": {"KMH_FILE_PARTITION": "0"}},
            {"name": "a_gzip_fp1", "kind": "count", "path": gz, "k": 21,
             "mode": True, "env": {"KMH_FILE_PARTITION": "1"}},
            {"name": "c_cut", "kind": "cut_resume", "path": main, "k": 21,
             "mode": "hybrid", "cut": CUT, "every": CKPT_EVERY,
             "ckpt": str(out / "cut.npz")},
            {"name": "save", "kind": "save", "path": main, "k": 21,
             "mode": "hybrid", "file": str(out / "ranks.npz")},
            {"name": "load_jax", "kind": "load",
             "file": str(f["dir"] / "jax8.npz")},
        ]
    else:
        cases += [{"name": "a_plain_list", "kind": "count",
                   "path": [main, str(f["fasta"])], "k": 21, "mode": True}]
    return cases


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """P -> (output directory, cases by name, the ranks' stdout), one
    spawn per process count."""
    res = {}
    for P in (2, 4):
        out = tmp_path_factory.mktemp(f"ranks{P}")
        (out / "spill").mkdir()
        cases = cases_for(P, inputs, out)
        spec = {"D": D, "min_q": MIN_Q, "rows": ROWS, "out": str(out),
                "queries": str(inputs["dir"] / "queries.npy"),
                "cases": cases}
        stdout = spawn(out, P, spec)
        res[P] = (out, {c["name"]: c for c in cases}, stdout)
    return res


def rank_results(out: Path, name: str, P: int):
    """(every rank's JSON record, the D shard tables as (raw uint64 keys,
    int64 counts))."""
    recs, tables = [], [None] * D
    for r in range(P):
        recs.append(json.loads((out / f"{name}.r{r}.json").read_text()))
        with np.load(out / f"{name}.r{r}.npz") as z:
            for d in recs[-1]["local"]:
                tables[d] = (raw_u64(z[f"k{d}"]), z[f"c{d}"])
    assert all(t is not None for t in tables)
    return recs, tables


def raw_u64(sortable: np.ndarray) -> np.ndarray:
    return (sortable ^ np.int64(SIGN)).view(np.uint64)


def port_tables(st):
    st.flush()
    return [(raw_u64(s.keys.numpy()), s.cnt.numpy()) for s in st.shards]


def jax_tables(st):
    n = np.asarray(st.n_unique)
    hi, lo, cnt = (np.asarray(a) for a in (st.u_hi, st.u_lo, st.cnt))
    raw = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return [(raw[d, : n[d]], cnt[d, : n[d]].astype(np.int64))
            for d in range(len(n))]


def assert_same_tables(a, b):
    assert len(a) == len(b) == D
    for d, ((ka, ca), (kb, cb)) in enumerate(zip(a, b)):
        assert np.array_equal(ka, kb), f"shard {d}: keys differ"
        assert np.array_equal(ca, cb), f"shard {d}: counts differ"


def assert_matches(recs, tables, single, queries, jax=None):
    """The ranks' tables and every rank's collective reads against the
    one-process store (and the JAX store where given)."""
    assert_same_tables(tables, port_tables(single))
    want_lookup = single.lookup(queries).tolist()
    for rec in recs:
        assert rec["n_unique"] == single.n_unique.tolist()
        assert rec["total_added"] == single.total_added.tolist()
        assert rec["peek"] == int(single.n_unique.sum())
        assert rec["spectrum"] == single.spectrum(300).tolist()
        assert rec["lookup"] == want_lookup
    if jax is not None:
        assert_same_tables(tables, jax_tables(jax))
        assert recs[0]["total_added"] == np.asarray(
            jax.total_added).tolist()
        assert recs[0]["n_unique"] == np.asarray(jax.n_unique).tolist()


@pytest.mark.parametrize("P", [2, 4])
def test_exchange_alone(runs, P):
    """Empty buckets, a rank with no rows: each local shard receives every
    rank's rows for it in rank order, as one process's exchange of the
    ranks' rows, one after the other, gives them."""
    out, cases, _ = runs[P]
    rows = cases["exchange"]["rows"]
    owners, vals = [], []
    for r in range(P):
        g = np.random.default_rng(100 + r)
        choices = [d for d in range(D) if d not in EMPTY_OWNERS]
        owners.append(g.choice(choices, rows[r]))
        vals.append(np.arange(rows[r]) + 1000 * r)
    v = torch.from_numpy(np.concatenate(vals)).to(torch.int64)
    one = make_mesh(D, device=CPU).exchange(
        torch.from_numpy(np.concatenate(owners)).to(torch.int64), v,
        torch.stack([v * 3, -v], 1))
    seen = set()
    for r in range(P):
        rec = json.loads((out / f"exchange.r{r}.json").read_text())
        assert rec["local"] == list(range(r * D // P, (r + 1) * D // P))
        with np.load(out / f"exchange.r{r}.npz") as z:
            for d in rec["local"]:
                seen.add(d)
                assert np.array_equal(z[f"v{d}"], one[d][0].numpy())
                assert np.array_equal(z[f"p{d}"], one[d][1].numpy())
                for s in range(P):
                    mine = np.sort(vals[s][owners[s] == d])
                    assert np.array_equal(z[f"v{d}_{s}"], mine)
                    if not rows[s] or d in EMPTY_OWNERS:
                        assert z[f"v{d}_{s}"].size == 0
    assert seen == set(range(D))


@pytest.mark.parametrize("P", [2, 4])
def test_count_batches_with_an_empty_rank(runs, inputs, P):
    """``count_batches`` on every rank with its own batch, one rank's of no
    rows (its add is an empty turn in the exchange): the one-process store
    of all the batches, and ``flagged_reads`` summed over the ranks."""
    from kmer_hasher_tpu_torch import counting

    out, _cases, _ = runs[P]
    recs, tables = rank_results(out, "loop", P)
    single = ShardedCountStore(21, make_mesh(D, device=CPU))
    stats = {}
    counting.count_batches(single, [read_batch(500 + r, n) for r, n in
                                    enumerate(LOOP_ROWS[P]) if n],
                           21, min_q=MIN_Q, exact_ll="hybrid", stats=stats)
    assert_matches(recs, tables, single, inputs["queries"])
    assert stats["flagged_reads"] > 0
    assert all(r["flagged"] == stats["flagged_reads"] for r in recs)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("k,mode", ROUTE_B)
def test_route_b_byte_ranges(runs, inputs, P, k, mode):
    """One plain FASTQ, each rank parsing only its byte range (the ranks'
    reads add up to the file's, none reads it all), equal to one process
    and to the JAX store."""
    out, _cases, _ = runs[P]
    recs, tables = rank_results(out, f"b_k{k}_{mode}", P)
    single = one_process(inputs["main"], k, mode_arg(mode))
    assert_matches(recs, tables, single, inputs["queries"],
                   jax_store(inputs["main"], k, mode))
    reads = [r["timings"]["file_reads"] for r in recs]
    assert sum(reads) == N_MAIN and max(reads) < N_MAIN
    assert all(r["timings"]["exchanges"] > 0 for r in recs)
    assert all(r["timings"]["exchange_bytes"] > 0 for r in recs)
    # the ranks' byte ranges start inside records, not on their starts
    data = inputs["main"].read_bytes()
    ends = np.cumsum([len(ln) + 1 for ln in data.split(b"\n")[:-1]])
    starts = {0} | set(ends[3::4].tolist())  # every record is 4 lines
    assert len(starts) == N_MAIN + 1
    cuts = [len(data) * p // P for p in range(1, P)]
    assert not any(c in starts for c in cuts)


def test_route_b_through_the_python_reader(runs, inputs):
    """``KMH_NATIVE_IO=0``: the byte ranges through the pure-Python range
    reader."""
    out, _cases, _ = runs[2]
    recs, tables = rank_results(out, "b_python", 2)
    assert_matches(recs, tables, one_process(inputs["main"], 21, "hybrid"),
                   inputs["queries"])
    assert all(r["reader"] == "python" for r in recs)
    reads = [r["timings"]["file_reads"] for r in recs]
    assert sum(reads) == N_MAIN and max(reads) < N_MAIN


@pytest.mark.parametrize("P", [2, 4])
def test_route_b_fasta_without_qualities(runs, inputs, P):
    """Records without qualities (the encoder's rows), by byte range."""
    out, _cases, _ = runs[P]
    recs, tables = rank_results(out, "b_fasta", P)
    assert_matches(recs, tables, one_process(inputs["fasta"], 21, False),
                   inputs["queries"], jax_store(inputs["fasta"], 21, "fast"))
    assert sum(r["timings"]["file_reads"] for r in recs) == 600


@pytest.mark.parametrize("P", [2, 4])
def test_multiline_fastq_goes_lockstep(runs, inputs, P):
    """A multi-line FASTQ (with FASTA records in it) cannot be cut by
    bytes: every rank reads every record and counts its own rows."""
    out, _cases, _ = runs[P]
    recs, tables = rank_results(out, "c_multiline", P)
    assert_matches(recs, tables, one_process(inputs["multi"], 21, "hybrid"),
                   inputs["queries"])
    assert [r["timings"]["file_reads"] for r in recs] == [400] * P


@pytest.mark.parametrize("P", [2, 4])
def test_route_a_gzip_files_dealt_to_ranks(runs, inputs, P):
    """Three gzip files: each rank parses only the files dealt to it
    (greedy by size; on 4 ranks one rank gets none)."""
    out, _cases, _ = runs[P]
    recs, tables = rank_results(out, "a_gzip", P)
    assert_matches(recs, tables, one_process(inputs["gz"], 21, "hybrid"),
                   inputs["queries"], jax_store(inputs["gz"], 21, "hybrid"))
    reads = sorted(r["timings"]["file_reads"] for r in recs)
    assert reads == ([800, 800] if P == 2 else [0, 300, 500, 800])
    assert all(r["warnings"] == 0 for r in recs)


@pytest.mark.parametrize("fp,reads", [("0", [1600, 1600]),
                                      ("1", [800, 800])])
def test_route_a_file_partition_switch(runs, inputs, fp, reads):
    """``KMH_FILE_PARTITION=0`` counts the list file by file (each a lone
    gzip file: lockstep); "1" deals the files out."""
    out, _cases, _ = runs[2]
    recs, tables = rank_results(out, f"a_gzip_fp{fp}", 2)
    assert_matches(recs, tables, one_process(inputs["gz"], 21, True),
                   inputs["queries"])
    assert sorted(r["timings"]["file_reads"] for r in recs) == reads


def test_route_a_short_plain_list_is_sliced(runs, inputs):
    """Two plain files on four ranks: fewer files than ranks and no gzip,
    so each file is cut into byte ranges in turn."""
    out, _cases, _ = runs[4]
    recs, tables = rank_results(out, "a_plain_list", 4)
    lst = [inputs["main"], inputs["fasta"]]
    assert_matches(recs, tables, one_process(lst, 21, True),
                   inputs["queries"])
    reads = [r["timings"]["file_reads"] for r in recs]
    assert sum(reads) == N_MAIN + 600 and max(reads) < 600 + N_MAIN // 2


@pytest.mark.parametrize("P", [2, 4])
def test_route_c_lone_gzip_warns_once(runs, inputs, P):
    out, _cases, _ = runs[P]
    recs, tables = rank_results(out, "c_gzip", P)
    assert_matches(recs, tables, one_process(inputs["gz"][0], 21, "hybrid"),
                   inputs["queries"])
    assert all(r["warnings"] == [1, 0] for r in recs)
    assert [r["timings"]["file_reads"] for r in recs] == [800] * P


def test_route_c_checkpoints_and_resume(runs, inputs):
    """max_reads with checkpoint_every: the progress record counts every
    rank's reads, the checkpoint reloads onto the ranks equal to one
    process's cut run; skip_reads from it completes the file, equal to
    one process and to the JAX store."""
    out, _cases, _ = runs[2]
    recs, tables = rank_results(out, "c_cut_part", 2)
    assert all(r["progress"] == {"path": str(inputs["main"]),
                                 "reads_done": CUT, "done": False}
               for r in recs)
    assert_matches(recs, tables, one_process(inputs["main"], 21, "hybrid",
                                             max_reads=CUT),
                   inputs["queries"])
    recs, tables = rank_results(out, "c_cut", 2)
    assert_matches(recs, tables, one_process(inputs["main"], 21, "hybrid"),
                   inputs["queries"], inputs["jax_main"])


@pytest.mark.parametrize("P", [2, 4])
def test_spill_to_one_shared_directory(runs, inputs, P):
    """Every rank's shards spill to files in one directory and rejoin them
    at the fold: the tables are unchanged and no file is left."""
    out, _cases, _ = runs[P]
    recs, tables = rank_results(out, "spill", P)
    assert_matches(recs, tables, one_process(inputs["main"], 21, True),
                   inputs["queries"], inputs["jax_main"])
    assert all(r["shard_timings"]["spills"] >= 4 for r in recs)
    assert all(r["left"] == [] for r in recs)
    # every rank's spill files side by side in the one directory, each
    # named by its process, none overwritten by another rank's
    names = recs[0]["spilled"]
    assert all(r["spilled"] == names for r in recs)
    assert all(r["n_one"] == 192 and r["one_spills"] >= 1 for r in recs)
    mine = [[n for n in names if n.startswith(f"kmh_spill_{r['pid']}_")]
            for r in recs]
    assert [len(m) for m in mine] == [r["one_spills"] for r in recs]
    assert sum(len(m) for m in mine) == len(names)


def test_checkpoint_saved_by_ranks_loads_in_both_packages(runs, inputs):
    out, _cases, _ = runs[2]
    recs, tables = rank_results(out, "save", 2)
    assert all(r["saved"] for r in recs)  # on disk when any rank returns
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


def test_jax_checkpoint_loads_onto_ranks(runs, inputs):
    out, _cases, _ = runs[2]
    recs, tables = rank_results(out, "load_jax", 2)
    assert_matches(recs, tables, one_process(inputs["main"], 21, True),
                   inputs["queries"], inputs["jax_main"])


def test_group_over_processes_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh(D, device=CPU, distributed=True)
    assert api.init_distributed()["process_count"] == 1
    assert api.host_read_slice(7) == slice(0, 7)
