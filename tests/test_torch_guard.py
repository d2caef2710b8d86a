"""The port stands alone: no module of kmer_hasher_tpu_torch imports JAX
or the JAX package."""
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

PROBE = r"""
import importlib, pkgutil, sys
import kmer_hasher_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from kmer_hasher_tpu_torch import api
idx = api.make_kmer_hash("ACGTTGCANNACGTTGCAGG" * 5, 5)
assert api.kmer_pos(idx, 15)["count"].sum() == idx.n_valid
assert len(api.seq_kmer_pos(idx, "TTGCAGGACGT", 5)) > 0
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
    for path in (REPO / "kmer_hasher_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert not mod.startswith(("jax", "kmer_hasher_tpu.")), (
                    path, line)
                assert mod != "kmer_hasher_tpu", (path, line)
