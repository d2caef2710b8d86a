"""Sharding (PyTorch port of ``kmer_hasher_tpu/parallel/``).

:mod:`.mesh` gives the shard group that stands where the JAX package has a
device mesh: D shards on one device, spread over several devices of one
process (``make_mesh(D, devices=[...])``, the JAX mesh's device list), or
spread over the processes of a ``torch.distributed`` group
(:mod:`.distributed`: ``init_distributed``, ``host_read_slice`` and the
host collectives; gloo by default, several ranks may share one card), or
both at once (``make_mesh(D, distributed=True, devices=[...])``: each
rank's shards over its own devices). :mod:`.sharded` holds
``owner_hash``, the sharded count store, which counts in one process or
over several (``count_kmers_fq_sh_rp(mesh=make_mesh(D, distributed=True))``
and its three routes over files), and the sharded position index
(``ShardedKmerIndex``, ``iter_kmer_pairs_sharded_chunks``,
``kmer_pairs_sharded``), also in one process or over several
(``ShardedKmerIndex(seq, k, make_mesh(D, distributed=True))``: every rank
holds the whole sequence and builds its own shards, and every table and
query gives every rank the one-process answer).
"""
from .distributed import host_read_slice, init_distributed
from .mesh import ShardGroup, make_hierarchical_mesh, make_mesh
from .sharded import (ShardedCountStore, ShardedKmerIndex,
                      iter_kmer_pairs_sharded_chunks, kmer_pairs_sharded,
                      owner_hash, owner_of_keys)

__all__ = ["ShardGroup", "make_mesh", "make_hierarchical_mesh",
           "init_distributed", "host_read_slice",
           "ShardedCountStore", "ShardedKmerIndex",
           "iter_kmer_pairs_sharded_chunks", "kmer_pairs_sharded",
           "owner_hash", "owner_of_keys"]
