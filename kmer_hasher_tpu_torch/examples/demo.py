"""End-to-end tour of the port on a directory of sequence files, the port's
twin of the JAX package's ``examples/demo.py``.

    python -m kmer_hasher_tpu_torch.examples.demo --data DIR [--device cpu]

``DIR`` holds ``test.fa`` (one record of at least 31,000 bases: the query
is ``seq[30000:31000]``), ``test.fastq.gz`` and ``repeat_40.fq``, as the
reference's bundled data does. Every capability of the original R
extension runs through the port's API on ``--device`` (the card by
default): the index and its dot-plot tables, the streamed pairs, a
cross-sequence query, ``kmer.pairs``, forward-strand multi-source
counting, the quality-filtered canonical counting of the two FASTQ files
into two sources with its spectra, both depth semantics, a batched index
build, a checkpoint round trip in a temporary directory, and the sharded
index on 8 shards of one device (the JAX script's multi-chip section,
which needs two or more devices there), its query equal to the single
index's. Prints the card line, the JAX script's lines and ``demo
complete``; ``main`` returns the figures.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional

import numpy as np
import torch

from .. import api
from ..index.position_index import resolve_device
from ..io import read_fastx
from ..parallel import ShardedKmerIndex, make_mesh
from ..probes._common import card_line
from ..utils import checkpoint as ckpt
from ..utils.metrics import most_common_kmer

NA = -(2 ** 31)
SHARDS = 8


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", required=True,
                    help="directory with test.fa, test.fastq.gz and "
                         "repeat_40.fq")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rec = {"card": card_line(dev)}
    print(rec["card"], flush=True)
    print(f"backend: {dev.type}, devices: "
          f"{torch.cuda.device_count() if dev.type == 'cuda' else 1}")

    # --- position index + dot-plot tables (make.kmer.hash / kmer.pos) ------
    name, seq_b, _ = read_fastx(os.path.join(args.data, "test.fa"))[0]
    seq = seq_b.decode()
    idx = api.make_kmer_hash(seq, k=8, device=dev)
    t = api.kmer_pos(idx, opt_flag=1 | 2 | 8)
    top = int(torch.argmax(t["count"]))
    rec.update(name=name, seq_len=len(seq), n_kmers=idx.n_kmers,
               positions=int(t["pos"].shape[0]), pairs=idx.total_pairs,
               most_frequent=t["kmer"][top],
               most_frequent_count=int(t["count"].max()))
    print(f"\n[{name}] {len(seq)} bp, k=8: {idx.n_kmers} distinct k-mers, "
          f"{rec['positions']} positions, {idx.total_pairs} dot-plot pairs")
    print(f"  most frequent: {rec['most_frequent']} "
          f"x{rec['most_frequent_count']}")

    # streamed pair table (the reference runs out of memory here on big
    # inputs)
    rec["streamed"] = sum(int(c.shape[0])
                          for c in idx.iter_pair_chunks(capacity=1 << 21))
    print(f"  streamed {rec['streamed']} (i,x,y) pair rows in chunks")

    # --- cross-sequence query (seq.kmer.pos) --------------------------------
    idx16 = api.make_kmer_hash(seq, k=16, device=dev)
    query = seq[30000:31000]
    m = api.seq_kmer_pos(idx16, query, k=16)
    rec["query_hits"] = int(m.shape[0])
    print(f"\nseq.kmer.pos: {rec['query_hits']} (i,j) hits of a 1 kb query "
          f"at k=16")

    # --- two-index pairs (kmer.pairs, crash-free) ---------------------------
    p = api.kmer_pairs(api.make_kmer_hash(seq[:5000], 12, device=dev),
                       api.make_kmer_hash(seq[2500:7500], 12, device=dev))
    rec["kmer_pairs"] = int(p.shape[0])
    print(f"kmer.pairs: {rec['kmer_pairs']} cross-index position pairs")

    # --- forward-strand multi-source counting (count.kmers) -----------------
    st = api.count_kmers([seq[:10000], seq[10000:20000]], k=11, source=0,
                         source_n=2, device=dev)
    st = api.count_kmers([seq[20000:30000]], k=11, source=1, source_n=2,
                         store=st)
    rec["count_kmers_distinct"] = st.n_unique
    print(f"\ncount.kmers: {st.n_unique} distinct 11-mers across 2 sources")

    # --- flagship quality-filtered canonical counting (count.kmers.fq.sh.rp)
    store = api.count_kmers_fq_sh_rp(
        os.path.join(args.data, "test.fastq.gz"), k=21, min_q=20,
        source_n=2, source=0, report_every=1000, device=dev)
    store = api.count_kmers_fq_sh_rp(
        os.path.join(args.data, "repeat_40.fq"), k=21, min_q=20, source_n=2,
        source=1, store=store)
    spec = api.kmer_spectrum(store, max_count=100)
    mc = most_common_kmer(store)
    rec.update(distinct=store.n_unique, singletons=int(spec[1]),
               most_common=mc["kmer"], most_common_count=mc["count"])
    print(f"count.kmers.fq.sh.rp: {store.n_unique} distinct canonical "
          f"21-mers; singletons={int(spec[1])}; most common {mc['kmer']} "
          f"x{mc['count']}")

    # combination spectrum: k-mers present in both sources vs either
    both = api.kmer_spectrum_n(store, 50, comb=[3], comb_inner=[1],
                               source_min=[1, 1])
    rec["in_both"] = int(both[0].sum())
    print(f"kmer.spec.sh.n: {rec['in_both']} 21-mers present in BOTH "
          f"sources")

    # --- depth track (seq.kmer.depth.sh) ------------------------------------
    read0 = read_fastx(os.path.join(args.data, "test.fastq.gz"))[0][1]
    d = api.seq_kmer_depth(store, read0.decode(), k=21)
    row = d[0]
    rec.update(depth_valid=int((row != NA).sum()),
               depth_max=int(row[row != NA].max()))
    print(f"seq.kmer.depth: read 0 depth track, {rec['depth_valid']} valid "
          f"columns, max depth {rec['depth_max']}")

    # --- exact-C depth semantics + batched index construction ---------------
    d_c = api.seq_kmer_depth(store, read0.decode(), k=21, semantics="c")
    rec["depth_c_written"] = int((d_c[0] != NA).sum())
    print(f"seq.kmer.depth semantics='c': byte-exact reference track, "
          f"{rec['depth_c_written']} written columns (note the one-column "
          "shift the C code applies)")
    contigs = [seq[i:i + 3000] for i in range(0, 12000, 3000)]
    idxs = api.make_kmer_hash_many(contigs, k=12, device=dev)
    rec.update(many=len(idxs), many_distinct=sum(ix.n_kmers for ix in idxs))
    print(f"make_kmer_hash_many: {len(idxs)} contigs indexed in one batched "
          f"build, {rec['many_distinct']} distinct 12-mers total")

    # --- save / restore -----------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "kmh_store.npz")
        ckpt.save_count_store(store, path)
        store2 = ckpt.load_count_store(path, device=dev)
    if not np.array_equal(api.kmer_spectrum(store2, 100), spec):
        raise AssertionError("the checkpoint's spectrum differs")
    print("checkpoint round-trip OK")

    # --- sharded index (the JAX script's multi-chip section) ----------------
    mesh = make_mesh(SHARDS, device=dev)
    sidx = ShardedKmerIndex(seq, k=16, mesh=mesh)
    sm = sidx.seq_kmer_pos(query, k=16)
    if not torch.equal(sm, m):
        raise AssertionError("sharded query must match single-device")
    rec["sharded_kmers"] = sidx.total_kmers
    print(f"sharded index over {mesh.size} shards on {dev.type}: "
          f"{sidx.total_kmers} k-mers routed by hash, sharded query "
          "identical to single-device")
    print("\ndemo complete", flush=True)
    return rec


if __name__ == "__main__":
    main()
