"""Command-line interface: ``python -m kmer_hasher_tpu_torch <cmd> ...``
(PyTorch port of ``kmer_hasher_tpu/__main__.py``: the same verbs, flags,
JSON lines and output files).

  index    build a position index from FASTA and save it
  tables   dump kmer/pos/pair.pos/count tables from a saved index
  query    cross-sequence dot-plot hits (seq.kmer.pos)
  count    quality-filtered canonical counting over FASTQ/FASTA files
  spectrum count histogram from a saved store
  depth    per-position depth track of a sequence against a saved store

Every verb that computes takes ``--device`` and runs on the card
(``cuda``) unless ``--device cpu`` is given; with no card the default
raises. Saved indexes and stores are the JAX package's files: either
package's CLI loads the other's. ``count`` adds to its JSON line which
reader parsed the files (``reader``: ``native`` or ``python``). ``count
--mesh N`` counts into N key-hash shards and saves the sharded kind: on the
one device, or with ``--mesh-devices M`` (M dividing N) over M devices, N/M
shards on each (the first M cards for ``--device cuda``, else M copies of
the device given; the JAX CLI's ``--mesh N`` is a mesh over N devices).
``--mesh-slices S`` lays the shards out as S slices, which changes no
result. ``--resume`` of such a file with ``--mesh N`` restores the shards,
and ``spectrum`` / ``depth`` read it folded into one store.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _read_first_seq(path: str) -> str:
    from .io import fastx, native

    read = native.read_fastx if native.available() else fastx.read_fastx
    recs = read(path, 1)
    if not recs:
        raise SystemExit(f"no sequences in {path}")
    return recs[0][1].decode()


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


def cmd_index(a):
    from .api import make_kmer_hash
    from .utils import checkpoint as ckpt

    idx = make_kmer_hash(_read_first_seq(a.fasta), a.k, device=a.device)
    ckpt.save_index(idx, a.out)
    print(json.dumps({"k": idx.k, "seq_len": idx.seq_len,
                      "positions": idx.n_valid, "distinct": idx.n_kmers,
                      "pairs": idx.total_pairs, "out": a.out}))


def cmd_tables(a):
    from .utils import checkpoint as ckpt

    idx = ckpt.load_index(a.index, device=a.device)
    t = idx.tables(a.opt_flag, max_pairs=a.max_pairs)
    for name, arr in t.items():
        if arr is None:
            continue
        out = f"{a.out_prefix}.{name.replace('.', '_')}"
        if name == "kmer":
            with open(out + ".txt", "w") as f:
                f.write("\n".join(arr) + "\n")
        else:
            np.save(out + ".npy", _host(arr))
        print(f"wrote {out}", file=sys.stderr)


def cmd_query(a):
    from .index.query import seq_kmer_pos
    from .utils import checkpoint as ckpt

    idx = ckpt.load_index(a.index, device=a.device)
    m = _host(seq_kmer_pos(idx, _read_first_seq(a.fasta), a.k))
    np.save(a.out, m)
    print(json.dumps({"hits": int(m.shape[0]), "out": a.out}))


def _same_file(a: str, b: str) -> bool:
    """Whether two CLI paths name the same input file (the resume cursor
    stores the path string the original run was given, which may differ
    lexically — './f.fq' vs 'f.fq', or a different cwd)."""
    if a == b:
        return True
    try:
        return os.path.samefile(a, b)
    except OSError:
        return os.path.abspath(a) == os.path.abspath(b)


def _count_info(store, out: str, mesh) -> dict:
    from .utils.metrics import most_common_kmer

    info = {"distinct": int(np.asarray(store.n_unique).sum()),
            "total_added": np.asarray(store.total_added).tolist(),
            "out": out}
    if mesh is None:
        info["most_common"] = most_common_kmer(store)
    else:
        info["shards"] = np.asarray(store.n_unique).tolist()
    info["reader"] = store.timings.get("reader")
    return info


def _mesh_devices(a):
    """The devices ``--mesh-devices M`` names: the first M cards for a
    card named without its index, else M copies of ``--device``."""
    if not a.mesh_devices:
        return None
    import torch

    m = a.mesh_devices
    if a.mesh % m:
        raise SystemExit(f"--mesh {a.mesh} is not divisible by "
                         f"--mesh-devices {m}")
    dev = torch.device(a.device)
    if dev.type == "cuda" and dev.index is None:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if seen < m:
            raise SystemExit(f"--mesh-devices {m} asks for {m} cards; "
                             f"{seen} are visible")
        return [torch.device("cuda", i) for i in range(m)]
    return [dev] * m


def _mesh(a):
    """The shard group ``--mesh`` / ``--mesh-slices`` / ``--mesh-devices``
    ask for, or None."""
    if not a.mesh:
        if a.mesh_devices:
            raise SystemExit("--mesh-devices needs --mesh")
        return None
    from .parallel.mesh import make_hierarchical_mesh, make_mesh

    devices = _mesh_devices(a)
    if a.mesh_slices:
        if a.mesh % a.mesh_slices:
            raise SystemExit(f"--mesh {a.mesh} is not divisible by "
                             f"--mesh-slices {a.mesh_slices}")
        return make_hierarchical_mesh(a.mesh_slices, a.mesh // a.mesh_slices,
                                      device=a.device, devices=devices)
    return make_mesh(a.mesh, device=a.device, devices=devices)


def cmd_count(a):
    from .api import count_kmers_fq_sh_rp
    from .utils import checkpoint as ckpt

    exact_ll = {"exact": True, "fast": False, "hybrid": "hybrid"}[a.ll_mode]
    mesh = _mesh(a)
    store = None
    progress = None
    if a.resume:
        store = ckpt.load_count_store(a.resume, mesh=mesh, device=a.device)
        progress = ckpt.load_progress(a.resume)
        if progress:
            print(f"resuming after {progress['reads_done']} reads of "
                  f"{progress['path']}", file=sys.stderr)
    if a.partition_files:
        if a.resume or a.checkpoint_every or a.max_reads is not None:
            raise SystemExit("--partition-files excludes --resume/"
                             "--checkpoint-every/--max-reads")
        if a.source is None and a.source_n > 1:
            raise SystemExit("--partition-files counts every file under "
                             "ONE source: give --source explicitly with "
                             "--source-n > 1")
        store = count_kmers_fq_sh_rp(
            a.files if len(a.files) > 1 else a.files[0], k=a.k,
            min_q=a.min_q, source_n=a.source_n, source=a.source or 0,
            report_every=a.report_every, exact_ll=exact_ll, mesh=mesh,
            batch_rows=a.batch_rows or None, device=a.device)
        ckpt.save_count_store(store, a.out)
        print(json.dumps(_count_info(store, a.out, mesh)))
        return
    counted_any = False
    for i, path in enumerate(a.files):
        skip = 0
        if progress:
            if not _same_file(progress.get("path", ""), path):
                continue  # earlier file: already fully counted in the store
            if progress.get("done"):
                progress = None
                continue  # this file is fully counted in the store
            skip = int(progress["reads_done"])
            progress = None
        source = a.source if a.source is not None else min(
            i, a.source_n - 1)
        store = count_kmers_fq_sh_rp(
            path, k=a.k, min_q=a.min_q, source_n=a.source_n, source=source,
            max_reads=a.max_reads, store=store,
            report_every=a.report_every, exact_ll=exact_ll, mesh=mesh,
            skip_reads=skip, checkpoint_every=a.checkpoint_every,
            checkpoint_path=(a.out if a.checkpoint_every else None),
            batch_rows=a.batch_rows or None, device=a.device)
        counted_any = True
    if progress is not None:
        # a cursor left after the loop matched none of the given files:
        # every input was skipped as "already counted"
        raise SystemExit(
            f"resume cursor points at {progress['path']!r}, which matches "
            f"none of the given input files — refusing to skip everything")
    if not (a.checkpoint_every and counted_any):
        # with --checkpoint-every the counting loop already wrote the final
        # atomic checkpoint (incl. the resume cursor) to OUT
        ckpt.save_count_store(store, a.out)
    print(json.dumps(_count_info(store, a.out, mesh)))


def cmd_spectrum(a):
    from .utils import checkpoint as ckpt

    store = ckpt.load_count_store(a.store, device=a.device)
    spec = store.spectrum(a.max_count)
    for count, n in enumerate(spec):
        if n:
            print(f"{count}\t{int(n)}")


def cmd_depth(a):
    from .counting import seq_kmer_depth
    from .utils import checkpoint as ckpt

    store = ckpt.load_count_store(a.store, device=a.device)
    d = _host(seq_kmer_depth(store, _read_first_seq(a.fasta), a.k,
                             semantics=a.semantics))
    np.save(a.out, d)
    print(json.dumps({"shape": list(d.shape), "out": a.out}))


def main(argv=None):
    p = argparse.ArgumentParser(prog="kmer_hasher_tpu_torch",
                                description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    def verb(name, fn, **kw):
        s = sub.add_parser(name, **kw)
        s.add_argument("--device", default="cuda",
                       help="where to compute: cuda (default; raises where "
                            "there is no card) or cpu")
        s.set_defaults(fn=fn)
        return s

    s = verb("index", cmd_index, help="build + save a position index")
    s.add_argument("fasta")
    s.add_argument("-k", type=int, required=True)
    s.add_argument("-o", "--out", required=True)

    s = verb("tables", cmd_tables, help="dump kmer.pos tables")
    s.add_argument("index")
    s.add_argument("--opt-flag", type=int, default=15)
    s.add_argument("--max-pairs", type=int, default=None)
    s.add_argument("-o", "--out-prefix", required=True)

    s = verb("query", cmd_query, help="seq.kmer.pos dot-plot hits")
    s.add_argument("index")
    s.add_argument("fasta")
    s.add_argument("-k", type=int, required=True)
    s.add_argument("-o", "--out", required=True)

    s = verb("count", cmd_count, help="canonical quality-filtered counting")
    s.add_argument("files", nargs="+")
    s.add_argument("-k", type=int, required=True)
    s.add_argument("--min-q", type=int, default=20)
    s.add_argument("--source-n", type=int, default=1)
    s.add_argument("--source", type=int, default=None,
                   help="fixed source index (default: file order)")
    s.add_argument("--max-reads", type=int, default=None)
    s.add_argument("--ll-mode", choices=["exact", "fast", "hybrid"],
                   default="exact",
                   help="likelihood filter: exact f64 (bit-parity), fast "
                        "f32, or hybrid (bitwise-exact at about fast speed)")
    s.add_argument("--mesh", type=int, default=None,
                   help="count into N key-hash shards (on the one device "
                        "unless --mesh-devices spreads them) and save the "
                        "sharded store")
    s.add_argument("--mesh-devices", type=int, default=None,
                   help="with --mesh: spread the N shards over M devices, "
                        "N/M on each: the first M cards for --device cuda, "
                        "else M copies of --device")
    s.add_argument("--mesh-slices", type=int, default=None,
                   help="with --mesh: lay the N shards out as this many "
                        "slices (routed flat: the same result)")
    s.add_argument("--resume", default=None,
                   help="existing store to keep accumulating into; if it "
                        "holds a progress cursor (--checkpoint-every), "
                        "counting resumes mid-file after the last "
                        "checkpointed read")
    s.add_argument("--checkpoint-every", type=int, default=None,
                   help="atomically checkpoint the store + resume cursor "
                        "to OUT every N reads")
    s.add_argument("--report-every", type=int, default=None)
    s.add_argument("--batch-rows", type=int, default=None,
                   help="reads per device batch (default: KMH_BATCH_ROWS "
                        "in the environment, else 32768)")
    s.add_argument("--no-pack", action="store_true",
                   help="accepted for parity with the JAX package's "
                        "command line and ignored: batches go to the device "
                        "as padded byte planes")
    s.add_argument("--partition-files", action="store_true",
                   help="count all FILES in one call under a single "
                        "source. Excludes --resume/--checkpoint-every/"
                        "--max-reads and per-file source assignment")
    s.add_argument("-o", "--out", required=True)

    s = verb("spectrum", cmd_spectrum,
             help="count histogram of a saved store")
    s.add_argument("store")
    s.add_argument("--max-count", type=int, default=10000)

    s = verb("depth", cmd_depth, help="per-position depth track")
    s.add_argument("store")
    s.add_argument("fasta")
    s.add_argument("-k", type=int, required=True)
    s.add_argument("-o", "--out", required=True)
    s.add_argument("--semantics", choices=["intent", "c"],
                   default="intent",
                   help="'c' reproduces the reference's depth loop "
                        "byte-for-byte incl. its column shift and "
                        "stale-register windows (PARITY.md)")

    a = p.parse_args(argv)
    a.fn(a)


if __name__ == "__main__":
    main()
