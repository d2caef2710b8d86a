"""Shard groups: where the JAX package has a device mesh
(``kmer_hasher_tpu/parallel/mesh.py``), the port has D shards, on one
device or spread over several devices in one process, or spread over the
processes of a ``torch.distributed`` group.

The JAX mesh's one axis ("shard") is key-space sharding: every k-mer has an
owner shard, and batches are routed to their owners by ``all_to_all``. In
one process on one device the D shards live side by side, and the exchange
that routes keys to their owners is a local regrouping
(:meth:`ShardGroup.exchange`): one stable sort by owner, the D bucket sizes
read back once, and each shard's bucket cut out at its exact length. The
results are the JAX mesh's: the same keys land in the same shard.

Over several devices in one process (``make_mesh(D, devices=[...])``, the
JAX mesh's device list): M devices, M dividing D, device i holding the
contiguous block of shards ``i*D/M ... (i+1)*D/M - 1`` (the JAX mesh's
device order). ``device`` is then the group's home: where inputs arrive
and collected results land. The exchange takes one source or one per
device and copies each bucket to its owner's device; every shard receives
its pieces in source order, so its tables equal the one-device group's.

The process form (``make_mesh(D, distributed=True)``, after
:func:`.distributed.init_distributed`): P processes, each owning the D/P
shards ``p*D/P ... (p+1)*D/P - 1`` (the JAX mesh's process-major device
order), on the device it names. The same method then sends every rank its
rows by ``all_to_all_single``: first the bucket sizes, then each column
with exact split sizes (no capacity padding), staged through pinned host
memory. Every rank must call it the same number of times, also with no
rows, or the ranks wait on each other for ever. :meth:`ShardGroup.gather_shards`
gives every rank all D shards' tensors (the JAX package's ``_host_read``),
under the same rule. A group over processes and several devices at once
is not supported yet.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..index.position_index import resolve_device
from . import distributed


class ShardGroup:
    """D shards. ``size`` is D, ``shape`` the layout it was asked for
    ((D,), or (slices, shards per slice)), ``device`` the home device:
    where this process's inputs arrive and collected results land, and
    where its shards live unless ``devices`` spreads them. ``devices`` (M
    devices, M dividing D; a device may repeat) puts shard d on
    ``devices[d * M // D]`` (:meth:`device_of`, :meth:`shards_on`); the
    home then defaults to ``devices[0]``. With ``processes`` the group
    spans the default process group: ``process_count`` P (which must
    divide D), ``process_index`` this rank, ``local_shards`` the range of
    shards it owns; without, one process owns all D."""

    def __init__(self, n_shards: int, device=None,
                 shape: Optional[Sequence[int]] = None,
                 processes: bool = False, devices=None):
        n_shards = int(n_shards)
        if n_shards < 1:
            raise ValueError("a shard group needs at least one shard")
        self.size = n_shards
        self.shape = tuple(shape) if shape is not None else (n_shards,)
        self.axis_names = ("shard",) if len(self.shape) == 1 else (
            "dcn", "ici")
        if devices is not None:
            if processes:
                raise ValueError("a shard group over processes takes no "
                                 "devices= yet: one device per process")
            devices = tuple(_indexed(d) for d in devices)
            if not devices or n_shards % len(devices):
                raise ValueError(f"{n_shards} shards do not split evenly "
                                 f"over {len(devices)} devices")
        if devices is None:
            self.device = resolve_device("cuda" if device is None else device)
            self.devices = (self.device,)
        else:
            self.device = devices[0] if device is None else _indexed(device)
            self.devices = devices
        if processes and not dist.is_initialized():
            raise RuntimeError("a shard group over processes needs the "
                               "default process group: call "
                               "init_distributed first")
        P = distributed.process_count() if processes else 1
        if n_shards % P:
            raise ValueError(f"{n_shards} shards do not split evenly over "
                             f"{P} processes")
        self.process_count = P
        self.process_index = distributed.process_index() if processes else 0
        per = n_shards // P
        self.local_shards = range(self.process_index * per,
                                  (self.process_index + 1) * per)

    def __repr__(self) -> str:
        procs = (f", processes={self.process_count}"
                 if self.process_count > 1 else "")
        devs = (f", devices=[{', '.join(map(str, self.devices))}]"
                if self.multi_device else "")
        return (f"ShardGroup(size={self.size}, shape={self.shape}, "
                f"device={self.device}{devs}{procs})")

    @property
    def distributed(self) -> bool:
        """True where the shards are spread over several processes."""
        return self.process_count > 1

    @property
    def multi_device(self) -> bool:
        """True where ``devices`` spreads the shards over several devices
        of this process (also where they repeat one device)."""
        return len(self.devices) > 1

    def device_of(self, d: int) -> torch.device:
        """The device shard d lives on."""
        return self.devices[d * len(self.devices) // self.size]

    def shards_on(self, i: int) -> range:
        """The shards this process holds on its i-th device: a contiguous
        block of ``local_shards``."""
        per = len(self.local_shards) // len(self.devices)
        first = self.local_shards.start + i * per
        return range(first, first + per)

    # -- host collectives (identities in one process) -------------------------
    def allgather(self, values) -> np.ndarray:
        """Every rank's int64 vector, [P, n] in rank order."""
        if not self.distributed:
            return np.asarray(values, np.int64).reshape(1, -1).copy()
        return distributed.allgather(values)

    def all_sum(self, values) -> np.ndarray:
        """The int64 vector summed over the ranks."""
        if not self.distributed:
            return np.asarray(values, np.int64).reshape(-1).copy()
        return distributed.all_sum(values)

    def barrier(self) -> None:
        if self.distributed:
            distributed.barrier()

    # -- routing ---------------------------------------------------------------
    def exchange(self, owner, *cols, by_rank: bool = False,
                 stats: Optional[dict] = None) -> list:
        """Route rows to their owners: for each shard d this process owns,
        the rows of every column whose ``owner`` is d, from every source in
        source order, each source's in their order (a stable regrouping, so
        a column sorted in every source stays sorted within each source's
        piece). With ``by_rank`` each shard's entry is a list of such column
        tuples, one per source, instead of their concatenation.

        A source is ``owner`` and the columns, one tensor each. In one
        process they may instead be lists of equal length, one source each
        (over several devices: one a device, in device order); over
        processes every rank is one source.

        In one process: one readback a source, its D bucket sizes; over
        several devices each bucket is then copied to its owner's device.
        Over processes: the sizes go to their owners by one
        ``all_to_all_single``, then each column by one more with exact
        splits, through host memory. ``stats`` gains ``exchanges``,
        ``exchange_s`` and ``exchange_bytes`` (the bytes sent to other
        ranks or copied to other devices) over processes and over several
        devices."""
        t0 = time.perf_counter()
        if isinstance(owner, (list, tuple)):
            sources = [(o, *(c[i] for c in cols)) for i, o in enumerate(owner)]
        else:
            sources = [(owner, *cols)]
        if not self.distributed:
            out, sent = self._regroup(sources)
        else:
            if len(sources) != 1:
                raise ValueError("over processes every rank is one source")
            owner, *cols = sources[0]
            out, sent = self._all_to_all(*self._by_owner(owner), cols)
        if stats is not None and (self.distributed or self.multi_device):
            stats["exchanges"] = stats.get("exchanges", 0) + 1
            stats["exchange_s"] = stats.get("exchange_s", 0.0) + (
                time.perf_counter() - t0)
            stats["exchange_bytes"] = stats.get("exchange_bytes", 0) + sent
        if by_rank:
            return out
        return [pieces[0] if len(pieces) == 1 else tuple(
            torch.cat([p[i] for p in pieces]) for i in range(len(pieces[0])))
            for pieces in out]

    def _by_owner(self, owner: torch.Tensor) -> Tuple[torch.Tensor, List[int]]:
        """(the stable order of the rows by owner, the D bucket sizes read
        back)."""
        order = torch.sort(owner, stable=True).indices
        sizes = torch.bincount(owner, minlength=self.size).tolist()
        if len(sizes) != self.size:
            raise ValueError("an owner lies outside the group")
        return order, sizes

    def _regroup(self, sources: list):
        """The one-process form of :meth:`exchange`: (for each shard a list
        over sources of column tuples, on the shard's device; bytes copied
        to another device)."""
        out: List[list] = [[] for _ in range(self.size)]
        sent = 0
        for owner, *cols in sources:
            order, sizes = self._by_owner(owner)
            parts = [torch.split(c[order], sizes) for c in cols]
            wait = set()
            for d in range(self.size):
                piece = tuple(p[d] for p in parts)
                if self.multi_device:
                    dev = self.device_of(d)
                    sent += sum(_nbytes(t) for t in piece if t.device != dev)
                    wait.update(t.device for t in piece
                                if _to_host_async(t, dev))
                    piece = tuple(t.to(dev, non_blocking=True) for t in piece)
                out[d].append(piece)
            _land(wait)
        return out, sent

    def gather_shards(self, local: Sequence[torch.Tensor],
                      rows: Sequence[int], stats: Optional[dict] = None
                      ) -> List[torch.Tensor]:
        """Every shard's tensor, the D of them in shard order, on every
        rank: ``local`` holds this rank's, one for each of ``local_shards``
        (of one dtype and one shape past the first axis on every rank, also
        where a shard has no rows); ``rows`` are the D lengths, which every
        rank must know. Other ranks' rows come through pinned host memory
        onto the group's device; this rank's own are returned as given. In
        one process on one device, ``list(local)``; over several devices,
        each tensor on the home device. ``stats`` gains ``gathers``,
        ``gather_s`` and ``gather_bytes`` (the bytes this rank received
        from other ranks or copied from other devices)."""
        local = list(local)
        if not (self.distributed or self.multi_device):
            return local
        t0 = time.perf_counter()
        if self.multi_device:
            home = self.device
            got = sum(_nbytes(t) for t in local if t.device != home)
            wait = {t.device for t in local if _to_host_async(t, home)}
            out = [t.to(home, non_blocking=True) for t in local]
            _land(wait)
        else:
            out, got = self._all_gather(local, rows)
        if stats is not None:
            stats["gathers"] = stats.get("gathers", 0) + 1
            stats["gather_s"] = stats.get("gather_s", 0.0) + (
                time.perf_counter() - t0)
            stats["gather_bytes"] = stats.get("gather_bytes", 0) + got
        return out

    def _all_gather(self, local: List[torch.Tensor], rows: Sequence[int]):
        """The process form of :meth:`gather_shards`: (the D tensors, bytes
        received from other ranks)."""
        P, me = self.process_count, self.process_index
        per = self.size // P
        rows = [int(n) for n in rows]
        dtype = local[0].dtype
        blocks = distributed.all_gather_rows(
            _to_host(torch.cat(local)),
            [sum(rows[r * per:(r + 1) * per]) for r in range(P)],
            pin_memory=self.device.type == "cuda")
        out, got = [], 0
        for r, blk in enumerate(blocks):
            if r == me:
                out.extend(local)
                continue
            got += blk.numel() * blk.element_size()
            out.extend(torch.split(_from_host(blk, dtype, self.device),
                                   rows[r * per:(r + 1) * per]))
        return out, got

    def _all_to_all(self, order: torch.Tensor, sizes: List[int],
                    cols: Sequence[torch.Tensor]):
        """The process form of :meth:`exchange`: (for each local shard a
        list over sending ranks of column tuples, bytes sent to others)."""
        P, me = self.process_count, self.process_index
        per = self.size // P
        send = torch.tensor(sizes, dtype=torch.int64)
        recv = torch.empty_like(send)  # [P, per]: rank r's rows for my shards
        dist.all_to_all_single(recv, send)
        recv = recv.view(P, per)
        send_rows = [sum(sizes[q * per:(q + 1) * per]) for q in range(P)]
        recv_rows = recv.sum(1).tolist()
        sent = 8 * per * (P - 1)
        out_cols = []
        for c in cols:
            src = c[order]
            row = int(np.prod(src.shape[1:])) * src.element_size()
            sent += row * (sum(send_rows) - send_rows[me])
            host = _to_host(src)
            got = torch.empty((sum(recv_rows), *src.shape[1:]),
                              dtype=host.dtype,
                              pin_memory=self.device.type == "cuda")
            dist.all_to_all_single(got, host, recv_rows, send_rows)
            out_cols.append(_from_host(got, c.dtype, self.device))
        # rank r's block holds its rows for my shards in shard order
        bounds = np.concatenate([[0], np.cumsum(recv.reshape(-1).numpy())])
        pieces = [[tuple(col[bounds[r * per + i]:bounds[r * per + i + 1]]
                         for col in out_cols) for r in range(P)]
                  for i in range(per)]
        return pieces, sent


def _indexed(device) -> torch.device:
    """``device`` resolved (a card asked for where there is none raises),
    a card named without its index given the current one's."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev``: without a host wait, except for a copy from a card
    to host memory, which the host may read at once after it."""
    return t.to(dev, non_blocking=not _to_host_async(t, dev))


def device_blocks(mesh: "ShardGroup") -> List[Tuple[torch.device, range]]:
    """For each of this process's devices of ``mesh``, in device order:
    the device and the positions in ``local_shards`` of the shards on it
    (one entry, all of them, for a group on one device)."""
    base = mesh.local_shards.start
    return [(dev, range(r.start - base, r.stop - base))
            for dev, r in ((dev, mesh.shards_on(i))
                           for i, dev in enumerate(mesh.devices))]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _to_host_async(t: torch.Tensor, dev: torch.device) -> bool:
    """Whether ``t.to(dev, non_blocking=True)`` is a copy from a card to
    host memory, which the host must wait for before it reads it."""
    return t.is_cuda and dev.type == "cpu" and t.numel() > 0


def _land(cards) -> None:
    """Wait for the copies to host memory that the current streams of
    ``cards`` have queued."""
    for dev in cards:
        torch.cuda.current_stream(dev).synchronize()


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous host tensor gloo can send: device rows copied
    to pinned memory, bool viewed as bytes."""
    t = t.contiguous()
    if t.dtype == torch.bool:
        t = t.view(torch.uint8)
    if t.device.type == "cpu":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _from_host(t: torch.Tensor, dtype: torch.dtype, device) -> torch.Tensor:
    """A received host tensor (pinned where ``device`` is a card) on
    ``device``, in ``dtype``."""
    if dtype == torch.bool:
        t = t.view(torch.bool)
    return t.to(device, non_blocking=True)


def make_mesh(n_devices: Optional[int] = None, device=None,
              distributed: bool = False, devices=None) -> ShardGroup:
    """A flat group of ``n_devices`` shards (one if None) on ``device``
    (the card, by default); with ``devices``, spread over those devices
    (shard d on ``devices[d * M // D]``, the home ``device`` defaulting to
    ``devices[0]``); with ``distributed``, spread over the default process
    group's ranks (:func:`.distributed.init_distributed` first). The two
    spreads do not combine yet."""
    return ShardGroup(1 if n_devices is None else n_devices, device,
                      processes=distributed, devices=devices)


def make_hierarchical_mesh(n_slices: int,
                           chips_per_slice: Optional[int] = None,
                           device=None,
                           distributed: bool = False,
                           devices=None) -> ShardGroup:
    """``n_slices`` x ``chips_per_slice`` (one if None) shards, routed flat;
    with ``devices`` or ``distributed``, spread over those devices or the
    default process group's ranks as :func:`make_mesh` spreads them (the
    JAX package builds its hierarchical mesh from ``jax.devices()``, which
    span the processes). The JAX package routes such a mesh in two stages,
    slices first over DCN and then within a slice over ICI, to move
    cross-slice traffic in large blocks; the shard a key lands in is the
    flat owner either way (slice ``owner // per_slice``, then ``owner %
    per_slice`` within it), so the two-stage routing changes no result and
    one exchange does the same."""
    per = 1 if chips_per_slice is None else int(chips_per_slice)
    if n_slices < 1 or per < 1:
        raise ValueError("slices and shards per slice must be at least 1")
    return ShardGroup(n_slices * per, device, shape=(n_slices, per),
                      processes=distributed, devices=devices)
