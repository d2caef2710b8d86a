"""The port's command line (``python -m kmer_hasher_tpu_torch``) against the
JAX package's, each through its ``main(argv)`` on the same generated files
with ``--device cpu``: equal JSON fields, equal ``.npy`` tables and text,
stores and indexes that load across the packages, resume equal to an uncut
run. All outputs are integers or bytes: no tolerance."""
import json
import os

import numpy as np
import pytest

from kmer_hasher_tpu import __main__ as jcli
from kmer_hasher_tpu.utils import checkpoint as jckpt
from kmer_hasher_tpu_torch import __main__ as tcli
from kmer_hasher_tpu_torch import counting as tcount
from kmer_hasher_tpu_torch.utils import checkpoint as tckpt

K = 13
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def restored_environment():
    """The JAX package's CLI sets KMH_BATCH_ROWS and KMH_PACK_UPLOAD for its
    process (the port's passes arguments): put the environment back after
    each test."""
    names = ("KMH_BATCH_ROWS", "KMH_PACK_UPLOAD", "KMH_NATIVE_IO")
    saved = {n: os.environ.get(n) for n in names}
    yield
    for n, v in saved.items():
        if v is None:
            os.environ.pop(n, None)
        else:
            os.environ[n] = v


def _fill(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A reference FASTA (multi-line, N runs, a repeat so pairs exist), a
    query FASTA and two FASTQ files of reads of it."""
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(13)
    unit = _fill(rng, 90)
    g = _fill(rng, 700) + "NNNN" + unit * 3 + _fill(rng, 500) + "n" + _fill(
        rng, 400)
    (d / "ref.fa").write_text(
        ">chr1 a reference\n" + "\n".join(g[i: i + 70]
                                          for i in range(0, len(g), 70))
        + "\n>chr2\nACGT\n")
    (d / "query.fa").write_text(">q\n" + g[650:1100] + "\n")
    for name, n in (("a.fq", 330), ("b.fq", 120)):
        lines = []
        for i in range(n):
            a = int(rng.integers(0, len(g) - 100))
            s = g[a: a + int(rng.integers(K - 3, 101))]
            q = rng.integers(24, 42, size=len(s))
            q[rng.random(len(s)) < 0.04] = 5
            lines.append(f"@{name}{i}\n{s}\n+\n"
                         f"{''.join(chr(33 + int(x)) for x in q)}\n")
        (d / name).write_text("".join(lines))
    return d


def run(cli, argv, capsys):
    """(the last stdout line as JSON or text, all of stdout)."""
    capsys.readouterr()
    cli.main([str(a) for a in argv])
    out = capsys.readouterr().out
    last = out.strip().splitlines()[-1] if out.strip() else ""
    try:
        return json.loads(last), out
    except ValueError:
        return last, out


def both(argv_of, capsys):
    """Run the JAX CLI and the port's (with --device cpu) on argv_of(tag);
    their JSON lines with the ``out`` field removed, and the port's extra
    fields apart."""
    j, j_out = run(jcli, argv_of("jax"), capsys)
    t, t_out = run(tcli, argv_of("torch") + CPU, capsys)
    return j, t, j_out, t_out


def test_index_tables_query_equal_the_jax_cli(data, capsys):
    def strip(info):
        return {k: v for k, v in info.items() if k != "out"}

    j, t, _, _ = both(lambda tag: ["index", data / "ref.fa", "-k", K, "-o",
                                   data / f"{tag}.idx.npz"], capsys)
    assert strip(j) == strip(t) and j["pairs"] > 0 and j["distinct"] > 1000
    both(lambda tag: ["tables", data / f"{tag}.idx.npz", "-o",
                      data / f"{tag}.tab"], capsys)
    for name in ("pos", "pair_pos", "count"):
        a = np.load(data / f"jax.tab.{name}.npy")
        b = np.load(data / f"torch.tab.{name}.npy")
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (data / "jax.tab.kmer.txt").read_text() == (
        data / "torch.tab.kmer.txt").read_text()
    # --opt-flag / --max-pairs, and each package reading the other's index
    both(lambda tag: ["tables", data / f"{'torch' if tag == 'jax' else 'jax'}"
                      ".idx.npz", "--opt-flag", 6, "--max-pairs", 100000,
                      "-o", data / f"{tag}.x"], capsys)
    assert not (data / "torch.x.count.npy").exists()
    for name in ("pos", "pair_pos"):
        assert np.array_equal(np.load(data / f"jax.x.{name}.npy"),
                              np.load(data / f"torch.x.{name}.npy"))
        assert np.array_equal(np.load(data / f"jax.x.{name}.npy"),
                              np.load(data / f"jax.tab.{name}.npy"))
    j, t, _, _ = both(lambda tag: ["query", data / "jax.idx.npz",
                                   data / "query.fa", "-k", K, "-o",
                                   data / f"{tag}.hits.npy"], capsys)
    assert j["hits"] == t["hits"] > 400
    assert np.array_equal(np.load(data / "jax.hits.npy"),
                          np.load(data / "torch.hits.npy"))


@pytest.mark.parametrize("mode", ["exact", "fast", "hybrid"])
def test_count_spectrum_depth_equal_the_jax_cli(data, mode, capsys):
    def count(tag):
        return ["count", data / "a.fq", data / "b.fq", "-k", K, "--min-q", 20,
                "--source-n", 2, "--ll-mode", mode, "--batch-rows", 128,
                "-o", data / f"{tag}.{mode}.npz"]

    j, t, _, _ = both(count, capsys)
    assert t.pop("reader") in ("native", "python")
    j.pop("out"), t.pop("out")
    assert j == t and j["distinct"] > 500 and min(j["total_added"]) > 0
    # each package's spectrum and depth of the other's store
    other = {"jax": "torch", "torch": "jax"}
    _, _, j_out, t_out = both(lambda tag: [
        "spectrum", data / f"{other[tag]}.{mode}.npz", "--max-count", 30],
        capsys)
    assert j_out == t_out and len(j_out.splitlines()) > 2
    for sem in ("intent", "c"):
        j, t, _, _ = both(lambda tag: [
            "depth", data / f"{other[tag]}.{mode}.npz", data / "ref.fa",
            "-k", K, "--semantics", sem, "-o", data / f"{tag}.{sem}.npy"],
            capsys)
        assert j["shape"] == t["shape"] == [2, 1875]
        a, b = (np.load(data / f"{tag}.{sem}.npy") for tag in other)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert (a > 0).any()
    a, b = (ck.load_count_store(data / f"{tag}.{mode}.npz", **kw)
            for ck, tag, kw in ((jckpt, "torch", {}),
                                (tckpt, "jax", {"device": "cpu"})))
    assert a.counts_dict() == b.counts_dict()


def test_no_pack_python_reader_and_single_source_flags(data, capsys,
                                                      monkeypatch):
    """--no-pack, KMH_NATIVE_IO=0, --source, --max-reads, --partition-files,
    --report-every: the same stores as the JAX CLI's, and the JSON line
    says which reader ran. --no-pack is accepted and changes nothing: the
    port has one upload form."""
    def count(extra, files=("a.fq",)):
        return lambda tag: (["count"] + [data / f for f in files] + [
            "-k", K, "--ll-mode", "hybrid", "-o", data / f"{tag}.f.npz"]
            + extra)

    base, t0, _, _ = both(count([]), capsys)
    assert "packed" not in t0
    j, t, _, _ = both(count(["--no-pack"]), capsys)
    assert j["distinct"] == t["distinct"] == t0["distinct"]
    assert j["most_common"] == t["most_common"] == base["most_common"]
    monkeypatch.setenv("KMH_NATIVE_IO", "0")
    t, _ = run(tcli, count([])("torch") + CPU, capsys)
    assert t["reader"] == "python"
    assert (t["distinct"], t["total_added"]) == (base["distinct"],
                                                 base["total_added"])
    monkeypatch.delenv("KMH_NATIVE_IO")
    j, t, _, _ = both(count(["--source-n", 3, "--source", 2, "--max-reads",
                             200, "--report-every", 100]), capsys)
    assert j["total_added"] == t["total_added"] and j["total_added"][2] > 0
    assert j["total_added"][:2] == [0, 0]
    j, t, _, _ = both(count(["--partition-files", "--min-q", 10],
                            files=("a.fq", "b.fq")), capsys)
    assert (j["distinct"], j["total_added"], j["most_common"]) == (
        t["distinct"], t["total_added"], t["most_common"])
    with pytest.raises(SystemExit):
        tcli.main([str(a) for a in count(
            ["--partition-files", "--max-reads", 5])("torch")] + CPU)
    with pytest.raises(SystemExit):
        tcli.main([str(a) for a in count(
            ["--partition-files", "--source-n", 2],
            files=("a.fq", "b.fq"))("torch")] + CPU)


def test_resume_equals_an_uncut_run(data, capsys):
    """--checkpoint-every with --max-reads cuts a run; --resume continues
    it mid-file (cursor case 1), skips a file the cursor marks done (case
    2), and refuses a cursor that matches no input (case 3). The resumed
    store equals the uncut run's and the JAX CLI's resumed store."""
    def argv(tag, extra, files=("a.fq", "b.fq"), out="ck"):
        return ["count"] + [data / f for f in files] + [
            "-k", K, "--ll-mode", "hybrid", "--batch-rows", 64,
            "-o", data / f"{tag}.{out}.npz"] + extra

    whole, t_whole, _, _ = both(lambda tag: [
        "count", data / "a.fq", data / "b.fq", "-k", K, "--ll-mode", "hybrid",
        "-o", data / f"{tag}.whole.npz"], capsys)
    cut = ["--checkpoint-every", 100, "--max-reads", 150]
    both(lambda tag: argv(tag, cut, files=("a.fq",)), capsys)
    for ck, tag in ((jckpt, "jax"), (tckpt, "torch")):
        cur = ck.load_progress(data / f"{tag}.ck.npz")
        assert cur["reads_done"] == 150 and cur["done"] is False
        assert cur["path"] == str(data / "a.fq")
    # each package resumes the OTHER's checkpoint
    (data / "jax.ck.npz").rename(data / "swap.npz")
    (data / "torch.ck.npz").rename(data / "jax.ck.npz")
    (data / "swap.npz").rename(data / "torch.ck.npz")
    j, t, _, _ = both(lambda tag: argv(tag, [
        "--resume", data / f"{tag}.ck.npz", "--checkpoint-every", 100]),
        capsys)
    for got in (j, t):
        assert (got["distinct"], got["total_added"], got["most_common"]) == (
            whole["distinct"], whole["total_added"], whole["most_common"])
    a = tckpt.load_count_store(data / "torch.ck.npz", device="cpu")
    b = tckpt.load_count_store(data / "torch.whole.npz", device="cpu")
    assert a.counts_dict() == b.counts_dict()
    assert tckpt.load_progress(data / "torch.ck.npz") == {
        "path": str(data / "b.fq"), "reads_done": 120, "done": True}
    # case 2: the cursor marks b.fq done, nothing is counted again
    t, _ = run(tcli, argv("torch", ["--resume", data / "torch.ck.npz"],
                          out="again") + CPU, capsys)
    assert t["total_added"] == whole["total_added"]
    assert tckpt.load_progress(data / "torch.again.npz") is None
    # case 3: the cursor's file is not among the inputs
    with pytest.raises(SystemExit, match="matches none"):
        tcli.main([str(x) for x in argv(
            "torch", ["--resume", data / "torch.ck.npz"],
            files=("a.fq",), out="never")] + CPU)
    with pytest.raises(SystemExit, match="matches none"):
        jcli.main([str(x) for x in argv(
            "jax", ["--resume", data / "jax.ck.npz"], files=("a.fq",),
            out="never")])


def test_same_file_and_the_flags_that_are_not_ported(data, tmp_path,
                                                     monkeypatch):
    assert tcli._same_file("x.fq", "x.fq")
    assert tcli._same_file(str(data / "a.fq"), str(data / "." / "a.fq"))
    monkeypatch.chdir(data)
    assert tcli._same_file("a.fq", str(data / "a.fq"))
    assert not tcli._same_file("a.fq", "b.fq")
    assert tcli._same_file("missing.fq", str(data / "missing.fq"))
    assert not tcli._same_file("missing.fq", "other.fq")
    # every flag is ported now: --mesh counts into logical shards, whose
    # file folds into the store that counting without it saves
    count = ["count", str(data / "a.fq"), "-k", str(K), "-o"]
    tcli.main(count + [str(tmp_path / "one.npz")] + CPU)
    one = tckpt.load_count_store(tmp_path / "one.npz", device="cpu")
    for extra in (["--mesh", "4"], ["--mesh", "4", "--mesh-slices", "2"]):
        tcli.main(count + [str(tmp_path / "s.npz")] + extra + CPU)
        got = tckpt.load_count_store(tmp_path / "s.npz", device="cpu")
        assert got.counts_dict() == one.counts_dict()
    with pytest.raises(SystemExit, match="not divisible"):
        tcli.main(count + [str(tmp_path / "s.npz"), "--mesh", "4",
                           "--mesh-slices", "3"] + CPU)
    assert not hasattr(tcount, "MESH_NOT_PORTED")
    (tmp_path / "none.fa").write_text("")
    with pytest.raises(SystemExit, match="no sequences"):
        tcli.main(["index", str(tmp_path / "none.fa"), "-k", "5", "-o",
                   str(tmp_path / "i.npz")] + CPU)


def test_every_verb_defaults_to_the_card(data, tmp_path):
    """Without --device every verb that computes asks for the card: where
    there is none it raises, it does not run on the CPU instead."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default device works")
    st, ix = tmp_path / "s.npz", tmp_path / "i.npz"
    tcli.main(["count", str(data / "b.fq"), "-k", str(K), "-o", str(st)] + CPU)
    tcli.main(["index", str(data / "query.fa"), "-k", "9", "-o", str(ix)]
              + CPU)
    for argv in (["index", data / "query.fa", "-k", 9, "-o", tmp_path / "x"],
                 ["tables", ix, "-o", tmp_path / "x"],
                 ["query", ix, data / "query.fa", "-k", 9, "-o",
                  tmp_path / "x"],
                 ["count", data / "b.fq", "-k", K, "-o", tmp_path / "x"],
                 ["spectrum", st],
                 ["depth", st, data / "query.fa", "-k", K, "-o",
                  tmp_path / "x"]):
        with pytest.raises(RuntimeError, match="is_available"):
            tcli.main([str(a) for a in argv])
