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
    assert len(sources) >= 18
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
