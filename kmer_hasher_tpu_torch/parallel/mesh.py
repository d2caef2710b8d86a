"""Shard groups: where the JAX package has a device mesh
(``kmer_hasher_tpu/parallel/mesh.py``), the port has D logical shards in
one process, on one device.

The JAX mesh's one axis ("shard") is key-space sharding: every k-mer has an
owner shard, and batches are routed to their owners by ``all_to_all``. Here
the shards live side by side on one device, and the exchange that routes
keys to their owners is a local regrouping (:meth:`ShardGroup.exchange`):
one stable sort by owner, the D bucket sizes read back once, and each
shard's bucket cut out at its exact length. The results are the JAX mesh's:
the same keys land in the same shard.

A group of one process per shard over ``torch.distributed`` would put its
all-to-all behind the same method; it is not built.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..index.position_index import resolve_device


class ShardGroup:
    """D logical shards on ``device``. ``size`` is D, ``shape`` the layout
    it was asked for ((D,), or (slices, shards per slice)), ``device`` where
    every shard's tensors live."""

    def __init__(self, n_shards: int, device="cuda",
                 shape: Optional[Sequence[int]] = None):
        n_shards = int(n_shards)
        if n_shards < 1:
            raise ValueError("a shard group needs at least one shard")
        self.size = n_shards
        self.shape = tuple(shape) if shape is not None else (n_shards,)
        self.axis_names = ("shard",) if len(self.shape) == 1 else (
            "dcn", "ici")
        self.device = resolve_device(device)

    def __repr__(self) -> str:
        return (f"ShardGroup(size={self.size}, shape={self.shape}, "
                f"device={self.device})")

    def exchange(self, owner: torch.Tensor, *cols: torch.Tensor
                 ) -> List[Tuple[torch.Tensor, ...]]:
        """Route rows to their owners: for each shard d, the rows of every
        column whose ``owner`` is d, in their order (a stable regrouping, so
        a sorted column stays sorted within each shard). One readback: the
        D bucket sizes."""
        order = torch.sort(owner, stable=True).indices
        sizes = torch.bincount(owner, minlength=self.size).tolist()
        if len(sizes) != self.size:
            raise ValueError("an owner lies outside the group")
        parts = [torch.split(c[order], sizes) for c in cols]
        return [tuple(p[d] for p in parts) for d in range(self.size)]


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> ShardGroup:
    """A flat group of ``n_devices`` shards (one if None) on ``device``."""
    return ShardGroup(1 if n_devices is None else n_devices, device)


def make_hierarchical_mesh(n_slices: int,
                           chips_per_slice: Optional[int] = None,
                           device="cuda") -> ShardGroup:
    """``n_slices`` x ``chips_per_slice`` (one if None) shards, routed flat.
    The JAX package routes such a mesh in two stages, slices first over DCN
    and then within a slice over ICI, to move cross-slice traffic in large
    blocks; the shard a key lands in is the flat owner either way (slice
    ``owner // per_slice``, then ``owner % per_slice`` within it), so the
    two-stage routing changes no result and one exchange does the same."""
    per = 1 if chips_per_slice is None else int(chips_per_slice)
    if n_slices < 1 or per < 1:
        raise ValueError("slices and shards per slice must be at least 1")
    return ShardGroup(n_slices * per, device, shape=(n_slices, per))
