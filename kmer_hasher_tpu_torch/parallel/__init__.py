"""Sharding (PyTorch port of ``kmer_hasher_tpu/parallel/``).

:mod:`.mesh` gives the shard group that stands where the JAX package has a
device mesh: D logical shards in one process, on one device. :mod:`.sharded`
holds ``owner_hash``, the sharded count store and the sharded position
index (``ShardedKmerIndex``, ``iter_kmer_pairs_sharded_chunks``,
``kmer_pairs_sharded``). Several processes over ``torch.distributed``
(``distributed.py``) are not ported yet.
"""
from .mesh import ShardGroup, make_hierarchical_mesh, make_mesh
from .sharded import (ShardedCountStore, ShardedKmerIndex,
                      iter_kmer_pairs_sharded_chunks, kmer_pairs_sharded,
                      owner_hash, owner_of_keys)

__all__ = ["ShardGroup", "make_mesh", "make_hierarchical_mesh",
           "ShardedCountStore", "ShardedKmerIndex",
           "iter_kmer_pairs_sharded_chunks", "kmer_pairs_sharded",
           "owner_hash", "owner_of_keys"]
