"""The port stands alone: no module of kmer_hasher_tpu_torch, and not
chip_smoke.py, imports JAX or the JAX package; and its entry points run on
the card unless the caller asks for the CPU."""
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

PROBE = r"""
import importlib, pkgutil, sys
import kmer_hasher_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from kmer_hasher_tpu_torch import api
idx = api.make_kmer_hash("ACGTTGCANNACGTTGCAGG" * 5, 5, device="cpu")
assert api.kmer_pos(idx, 15)["count"].sum() == idx.n_valid
assert len(api.seq_kmer_pos(idx, "TTGCAGGACGT", 5)) > 0
# a CPU counting run through every new module: reader, FSM, store,
# spectrum, depth, checkpoint, progress meter
import pathlib, tempfile
from kmer_hasher_tpu_torch.utils import checkpoint, metrics
with tempfile.TemporaryDirectory() as d:
    fq = pathlib.Path(d, "r.fq")
    fq.write_text("".join(f"@r{i}\n{'ACGTTGCAGGAC' * 4}\n+\n{'F' * 48}\n"
                          for i in range(6)))
    for mode in (True, False, "hybrid"):
        st = api.count_kmers_fq_sh_rp(str(fq), k=11, exact_ll=mode,
                                      report_every=4, device="cpu")
        assert st.n_unique > 0
    assert api.kmer_spectrum(st, 30).sum() == st.n_unique
    assert api.seq_kmer_depth(st, "ACGTTGCAGGAC" * 2, 11).max() > 0
    checkpoint.save_count_store(st, pathlib.Path(d, "st.npz"))
    st2 = checkpoint.load_count_store(pathlib.Path(d, "st.npz"), device="cpu")
    assert st2.counts_dict() == st.counts_dict()
    assert metrics.most_common_kmer(st)["count"] > 0
    assert api.count_kmers(["ACGTTGCAGG"], 5, device="cpu").n_unique > 0
    # the per-base-threshold entries and the exact-C depth
    for entry in (api.count_kmers_fq, api.count_kmers_fq_sh):
        th = entry(str(fq), k=11, min_q=20, device="cpu")
        assert th.n_unique > 0
    assert api.seq_kmer_depth(th, "ACGTTGCAGGAC" * 2 + "N" + "ACGTTGCAGGA",
                              11, semantics="c").max() > 0
# B3's plain version through its caller, the count store's two-run merge
import os
import torch
from kmer_hasher_tpu_torch.index import count_store
one = torch.ones((3, 1), dtype=torch.int64)
keys, cnt = count_store.merge_runs(((torch.tensor([1, 4, 9]), one),
                                    (torch.tensor([4, 5]), one[:2])))
assert keys.tolist() == [1, 4, 5, 9] and cnt[:, 0].tolist() == [1, 2, 1, 1]
assert "kmer_hasher_tpu_torch.ops.cuda_merge" in sys.modules
# the probe entry on the CPU, a store that spills to memory and to disk
# and folds by key range, and a drop-mode store
import contextlib, io
from kmer_hasher_tpu_torch.probes import sort_probes
with contextlib.redirect_stdout(io.StringIO()) as out:
    sort_probes.main(["14", "--device", "cpu"])
assert out.getvalue().count("ok=True") == 14, out.getvalue()
os.environ["KMH_FOLD_BUDGET_BYTES"] = "2048"
raw = torch.arange(3000, dtype=torch.int64) * 977 % 2003
with tempfile.TemporaryDirectory() as d:
    for spill_dir in (None, d):
        sp = api.CountStore(9, spill_bytes=1024, spill_dir=spill_dir,
                            device="cpu")
        sp.run_build_size = 256
        for part in raw.split(500):
            sp.add_kmers(part, torch.ones(500, dtype=torch.bool), defer=True)
        assert sp.timings["spills"] >= 2
        assert sp.n_unique == 2003 and sp.timings["ranged_folds"] == 1
    assert not os.listdir(d)
del os.environ["KMH_FOLD_BUDGET_BYTES"]
dr = api.CountStore(4, mode="ktree", prefix_bits=4, suffix_bits=4,
                    max_size_bytes=128, budget_semantics="drop", device="cpu")
dr.add_kmers(torch.tensor([0x12, 0x25, 0x31, 0x13]), torch.ones(4, dtype=torch.bool))
assert sorted(dr.counts_dict()) == [0x12, 0x13, 0x25] and dr._admit_frozen
for name in ("probes.sort_probes", "probes.cuda_probes", "probes._common"):
    assert "kmer_hasher_tpu_torch." + name in sys.modules, name
# the round-3 probe entry on the CPU, the command line (every verb) over the
# native reader where it builds, and the parameter types
from kmer_hasher_tpu_torch.probes import sort_probes_r3
with contextlib.redirect_stdout(io.StringIO()) as out:
    sort_probes_r3.main(["17", "--device", "cpu"])
assert out.getvalue().count("ok=True") == 17, out.getvalue()
from kmer_hasher_tpu_torch import __main__ as cli, params
from kmer_hasher_tpu_torch.io import native
assert params.RpParams.from_r_vector([21, 20, 20, 1, -1, 0, 1, 0]).k == 21
with tempfile.TemporaryDirectory() as d:
    d = pathlib.Path(d)
    (d / "ref.fa").write_text(">s\n" + "ACGTTGCAGGACTTGACCAT" * 6 + "\n")
    (d / "r.fq").write_text("".join(
        f"@r{i}\n{'ACGTTGCAGGACTTGACCAT' * 3}\n+\n{'I' * 60}\n"
        for i in range(5)))
    with contextlib.redirect_stdout(io.StringIO()) as out, \
            contextlib.redirect_stderr(io.StringIO()):
        cpu = ["--device", "cpu"]
        cli.main(["index", str(d / "ref.fa"), "-k", "9", "-o",
                  str(d / "i.npz")] + cpu)
        cli.main(["tables", str(d / "i.npz"), "-o", str(d / "t")] + cpu)
        cli.main(["query", str(d / "i.npz"), str(d / "ref.fa"), "-k", "9",
                  "-o", str(d / "q.npy")] + cpu)
        cli.main(["count", str(d / "r.fq"), "-k", "11", "--ll-mode", "hybrid",
                  "-o", str(d / "s.npz")] + cpu)
        cli.main(["spectrum", str(d / "s.npz")] + cpu)
        cli.main(["depth", str(d / "s.npz"), str(d / "ref.fa"), "-k", "11",
                  "-o", str(d / "d.npy")] + cpu)
    assert '"reader": "%s"' % native.reader_name() in out.getvalue()
    if native.available():
        assert len(native.read_fastx(str(d / "r.fq"))) == 5
for name in ("__main__", "params", "io.native", "probes.sort_probes_r3",
             "probes.cuda_probes_r3"):
    assert "kmer_hasher_tpu_torch." + name in sys.modules, name
# the DMA probe entry on the CPU; the sharded store through mesh=, its
# checkpoint both ways, and count --mesh
from kmer_hasher_tpu_torch.probes import dma_probes_r3
with contextlib.redirect_stdout(io.StringIO()) as out:
    dma_probes_r3.main(["16", "--device", "cpu"])
assert out.getvalue().count("ok=True") == 8, out.getvalue()
from kmer_hasher_tpu_torch.parallel import make_mesh
with tempfile.TemporaryDirectory() as d:
    d = pathlib.Path(d)
    (d / "r.fq").write_text("".join(
        f"@r{i}\n{'ACGTTGCAGGACTTGACCAT' * 3}\n+\n{'I' * 60}\n"
        for i in range(5)))
    mesh = make_mesh(4, device="cpu")
    sh = api.count_kmers_fq_sh_rp(str(d / "r.fq"), k=11, exact_ll="hybrid",
                                  mesh=mesh)
    checkpoint.save_count_store(sh, d / "sh.npz")
    back = checkpoint.load_count_store(d / "sh.npz", mesh=mesh)
    assert (back.n_unique == sh.n_unique).all() and sh.n_unique.sum() > 0
    one = checkpoint.load_count_store(d / "sh.npz", device="cpu")
    assert one.n_unique == sh.n_unique.sum()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        cli.main(["count", str(d / "r.fq"), "-k", "11", "--mesh", "4",
                  "-o", str(d / "c.npz"), "--device", "cpu"])
    assert '"shards": [' in out.getvalue()
# the sharded position index on 4 CPU shards, its tables and queries
from kmer_hasher_tpu_torch.parallel import (ShardedKmerIndex,
                                            kmer_pairs_sharded)
six = ShardedKmerIndex("ACGTTGCANNACGTTGCAGG" * 5, 5, make_mesh(4, device="cpu"))
assert six.total_kmers == idx.n_valid
assert (six.tables(15)["pos"] == api.kmer_pos(idx, 15)["pos"]).all()
assert len(six.seq_kmer_pos("TTGCAGGACGT", 5)) > 0
assert kmer_pairs_sharded(six, six).shape[0] > 0
for name in ("probes.dma_probes_r3", "probes.cuda_probes_dma",
             "parallel.mesh", "parallel.sharded"):
    assert "kmer_hasher_tpu_torch." + name in sys.modules, name
# several processes: one process is rank 0 of 1 and reads every record
assert api.init_distributed()["process_count"] == 1
assert api.host_read_slice(10) == slice(0, 10)
assert "kmer_hasher_tpu_torch.parallel.distributed" in sys.modules
# the index's gathers are identities in one process; its routes: the build,
# the range partition, the pairs' partition with its own splitters
from kmer_hasher_tpu_torch.parallel import distributed, make_hierarchical_mesh
hm = make_hierarchical_mesh(2, 2, device="cpu")
parts = [torch.arange(n) for n in (3, 0, 2, 1)]
assert hm.gather_shards(parts, [3, 0, 2, 1]) == parts
assert distributed.all_gather_rows(parts[0], [3])[0] is parts[0]
assert six.timings["routes"] == 3 and six.timings["gathers"] == 0
import chip_smoke  # the smoke script's own imports (it runs only as main)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith(("jax.", "jaxlib"))
             or n == "kmer_hasher_tpu" or n.startswith("kmer_hasher_tpu."))
assert not bad, bad
print("ok")
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_sources_name_no_jax():
    # imports inside functions run only when called: read every one
    sources = list((REPO / "kmer_hasher_tpu_torch").rglob("*.py"))
    assert len(sources) >= 20
    names = {p.name for p in sources}
    assert {"sort.py", "cuda_merge.py", "cuda_probes.py",
            "sort_probes.py", "cuda_probes_r3.py", "sort_probes_r3.py",
            "__main__.py", "params.py", "native.py", "dma_probes_r3.py",
            "cuda_probes_dma.py", "mesh.py", "sharded.py",
            "distributed.py", "bench.py", "e2e_device_bench.py",
            "hybrid_probe.py", "sharded_hybrid_bench.py", "spill_regime.py",
            "large_pairs.py", "counting_stress.py", "demo.py"} <= names
    for path in sources + [REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert not mod.startswith(("jax", "kmer_hasher_tpu.")), (
                    path, line)
                assert mod != "kmer_hasher_tpu", (path, line)


def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default device works")


def entry(name: str):
    """A module of the port by its name under the package."""
    import importlib

    return importlib.import_module("kmer_hasher_tpu_torch." + name)


CALLS = {
    "make_kmer_hash": lambda api, ck, p: api.make_kmer_hash("ACGT" * 20, 5),
    "make_kmer_hash_many": lambda api, ck, p: api.make_kmer_hash_many(
        ["ACGT" * 20], 5),
    "KmerIndex": lambda api, ck, p: api.KmerIndex("ACGT" * 20, 5),
    "KmerIndex.build_many": lambda api, ck, p: api.KmerIndex.build_many(
        ["ACGT" * 20], 5),
    "CountStore": lambda api, ck, p: api.CountStore(5),
    "count_kmers": lambda api, ck, p: api.count_kmers(["ACGT" * 20], 5),
    "count_kmers_fq_sh_rp": lambda api, ck, p: api.count_kmers_fq_sh_rp(
        p["fq"], k=5),
    "count_kmers_fq": lambda api, ck, p: api.count_kmers_fq(p["fq"], k=5),
    "count_kmers_fq_sh": lambda api, ck, p: api.count_kmers_fq_sh(
        p["fq"], k=5),
    "probes.sort_probes.run": lambda api, ck, p: __import__(
        "kmer_hasher_tpu_torch.probes.sort_probes", fromlist=["run"]).run(14),
    "probes.sort_probes.main": lambda api, ck, p: __import__(
        "kmer_hasher_tpu_torch.probes.sort_probes",
        fromlist=["main"]).main(["14"]),
    "probes.sort_probes_r3.run": lambda api, ck, p: __import__(
        "kmer_hasher_tpu_torch.probes.sort_probes_r3",
        fromlist=["run"]).run(17),
    "probes.sort_probes_r3.main": lambda api, ck, p: __import__(
        "kmer_hasher_tpu_torch.probes.sort_probes_r3",
        fromlist=["main"]).main(["17"]),
    "probes.dma_probes_r3.run": lambda api, ck, p: __import__(
        "kmer_hasher_tpu_torch.probes.dma_probes_r3",
        fromlist=["run"]).run(16),
    "probes.dma_probes_r3.main": lambda api, ck, p: __import__(
        "kmer_hasher_tpu_torch.probes.dma_probes_r3",
        fromlist=["main"]).main(["16"]),
    "parallel.make_mesh": lambda api, ck, p: __import__(
        "kmer_hasher_tpu_torch.parallel", fromlist=["make_mesh"]).make_mesh(2),
    "parallel.ShardedKmerIndex": lambda api, ck, p: __import__(
        "kmer_hasher_tpu_torch.parallel",
        fromlist=["ShardedKmerIndex", "make_mesh"]).ShardedKmerIndex(
            "ACGT" * 20, 5, __import__("kmer_hasher_tpu_torch.parallel",
                                       fromlist=["make_mesh"]).make_mesh(2)),
    "parallel.make_hierarchical_mesh": lambda api, ck, p: __import__(
        "kmer_hasher_tpu_torch.parallel",
        fromlist=["make_hierarchical_mesh"]).make_hierarchical_mesh(2, 2),
    "cli count --mesh": lambda api, ck, p: __import__(
        "kmer_hasher_tpu_torch.__main__", fromlist=["main"]).main(
            ["count", p["fq"], "-k", "5", "--mesh", "2", "-o",
             str(p["store"]) + ".out"]),
    "cli count": lambda api, ck, p: __import__(
        "kmer_hasher_tpu_torch.__main__", fromlist=["main"]).main(
            ["count", p["fq"], "-k", "5", "-o", str(p["store"]) + ".out"]),
    "cli spectrum": lambda api, ck, p: __import__(
        "kmer_hasher_tpu_torch.__main__", fromlist=["main"]).main(
            ["spectrum", str(p["store"])]),
    "cli tables": lambda api, ck, p: __import__(
        "kmer_hasher_tpu_torch.__main__", fromlist=["main"]).main(
            ["tables", str(p["index"]), "-o", str(p["index"]) + ".t"]),
    "bench.main": lambda api, ck, p: entry("bench").main([]),
    "probes.e2e_device_bench.main": lambda api, ck, p: entry(
        "probes.e2e_device_bench").main([]),
    "probes.e2e_device_bench.run": lambda api, ck, p: entry(
        "probes.e2e_device_bench").run(1, rows=8),
    "probes.hybrid_probe.main": lambda api, ck, p: entry(
        "probes.hybrid_probe").main(["8", "1"]),
    "probes.hybrid_probe.run": lambda api, ck, p: entry(
        "probes.hybrid_probe").run(8, 1),
    "probes.sharded_hybrid_bench.main": lambda api, ck, p: entry(
        "probes.sharded_hybrid_bench").main([]),
    "probes.sharded_hybrid_bench.run": lambda api, ck, p: entry(
        "probes.sharded_hybrid_bench").run(1, rows=8),
    "probes.spill_regime.main": lambda api, ck, p: entry(
        "probes.spill_regime").main([]),
    "probes.spill_regime.run": lambda api, ck, p: entry(
        "probes.spill_regime").run(2, rows=8),
    "examples.large_pairs.main": lambda api, ck, p: entry(
        "examples.large_pairs").main(["--mbp", "0.01", "--copies", "1"]),
    "examples.counting_stress.main": lambda api, ck, p: entry(
        "examples.counting_stress").main(["--reads", "4", "--keep",
                                          p["fq"]]),
    "examples.demo.main": lambda api, ck, p: entry("examples.demo").main(
        ["--data", str(p["index"].parent)]),
    "load_index": lambda api, ck, p: ck.load_index(p["index"]),
    "load_count_store": lambda api, ck, p: ck.load_count_store(p["store"]),
    "index_from_numpy": lambda api, ck, p: ck.index_from_numpy(
        5, 80, [0], [1], [1], 1),
    "count_store_from_numpy": lambda api, ck, p: ck.count_store_from_numpy(
        {"k": 5, "counts_n": 1}, [0], [1], [[1]], [1]),
}


@pytest.mark.parametrize("entry", sorted(CALLS))
def test_default_device_is_the_card(entry, tmp_path):
    """Called without ``device`` where there is no card, every entry point
    raises resolve_device's error: it does not run on the CPU instead."""
    no_card()
    from kmer_hasher_tpu_torch import api
    from kmer_hasher_tpu_torch.utils import checkpoint as ck

    fq = tmp_path / "r.fq"
    fq.write_text("@r\nACGTTGCAGGACGT\n+\nFFFFFFFFFFFFFF\n")
    paths = {"fq": str(fq), "index": tmp_path / "i.npz",
             "store": tmp_path / "s.npz"}
    ck.save_index(api.make_kmer_hash("ACGT" * 20, 5, device="cpu"),
                  paths["index"])
    ck.save_count_store(api.count_kmers(["ACGT" * 20], 5, device="cpu"),
                        paths["store"])
    with pytest.raises(RuntimeError, match="is_available"):
        CALLS[entry](api, ck, paths)
