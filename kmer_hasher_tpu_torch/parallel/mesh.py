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
under the same rule.

The two spreads combine (``make_mesh(D, distributed=True, devices=[...])``,
the JAX mesh over several hosts with several chips each): ``devices`` is
then each rank's own list of M devices (every rank names M of them, M
dividing D/P; the devices may differ from rank to rank), and rank p holds
its D/P shards on them in contiguous blocks. The exchange takes one source
a device on every rank; a shard receives its pieces in (rank, source)
order and lands on its own device.
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
    where its shards live unless ``devices`` spreads them. With
    ``processes`` the group spans the default process group:
    ``process_count`` P (which must divide D), ``process_index`` this
    rank, ``local_shards`` the range of shards it owns; without, one
    process owns all D. ``devices`` (M devices of this process, M dividing
    its D/P shards; a device may repeat) puts this process's shards on
    them in contiguous blocks (:meth:`device_of`, :meth:`shards_on`); the
    home then defaults to ``devices[0]``. Over processes every rank names
    as many devices, each its own."""

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
            devices = tuple(_indexed(d) for d in devices)
            if not devices:
                raise ValueError(f"{n_shards} shards do not split evenly "
                                 f"over 0 devices")
        if devices is None:
            # indexed, so that a shard's tensors compare equal to it
            self.device = _indexed("cuda" if device is None else device)
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
        per, M = n_shards // P, len(self.devices)
        if per % M:
            raise ValueError(f"{per} shards{' a process' if P > 1 else ''} "
                             f"do not split evenly over {M} devices")
        if P > 1:  # the exchange sends M sources from every rank
            got = distributed.allgather([M])[:, 0]
            if (got != M).any():
                raise ValueError(f"the ranks name {got.tolist()} devices: "
                                 f"every rank must name as many")
        self.process_count = P
        self.process_index = distributed.process_index() if processes else 0
        self.local_shards = range(self.process_index * per,
                                  (self.process_index + 1) * per)
        self._pin = any(d.type == "cuda" for d in (self.device,
                                                   *self.devices))

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
        """The device shard d lives on: by its place in ``local_shards``.
        Raises for a shard another process holds."""
        i = d - self.local_shards.start
        if not 0 <= i < len(self.local_shards):
            raise ValueError(
                f"shard {d} is not this process's: it holds shards "
                f"{self.local_shards.start}-{self.local_shards.stop - 1}")
        return self.devices[i * len(self.devices) // len(self.local_shards)]

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
        on its device, the rows of every column whose ``owner`` is d, from
        every source in source order, each source's in their order (a
        stable regrouping, so a column sorted in every source stays sorted
        within each source's piece). With ``by_rank`` each shard's entry is
        a list of such column tuples, one per source, instead of their
        concatenation.

        A source is ``owner`` and the columns, one tensor each; they may
        instead be lists of equal length, one source each (over several
        devices: one a device, in device order). Over processes every rank
        sends M sources (M the number of its devices: fewer are made up
        with empty ones), and the sources are those of every rank in
        (rank, source) order.

        In one process: one readback a source, its D bucket sizes; over
        several devices each bucket is then copied to its owner's device.
        Over processes: the sizes go to their owners by one
        ``all_to_all_single``, then each column by one more with exact
        splits, through host memory, and on to each of the rank's devices
        once (a shard's pieces are views of the column on its device).
        ``stats`` gains ``exchanges``, ``exchange_s`` and
        ``exchange_bytes`` (the bytes sent to other ranks or copied to
        other devices) over processes and over several devices."""
        t0 = time.perf_counter()
        if isinstance(owner, (list, tuple)):
            sources = [(o, *(c[i] for c in cols)) for i, o in enumerate(owner)]
        else:
            sources = [(owner, *cols)]
        if not self.distributed:
            out, sent = self._regroup(sources)
        else:
            out, sent = self._all_to_all(sources)
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
        rank, on the home device: ``local`` holds this rank's, one for each
        of ``local_shards`` on its device (of one dtype and one shape past
        the first axis on every rank, also where a shard has no rows);
        ``rows`` are the D lengths, which every rank must know. Other
        ranks' rows come through pinned host memory; this rank's own are
        returned as given where they lie on the home device, else copied
        there. In one process on one device, ``list(local)``. ``stats``
        gains ``gathers``, ``gather_s`` and ``gather_bytes`` (the bytes
        this rank received from other ranks or copied from other
        devices)."""
        local = list(local)
        if not (self.distributed or self.multi_device):
            return local
        t0 = time.perf_counter()
        home = self.device
        got = sum(_nbytes(t) for t in local if t.device != home)
        wait = {t.device for t in local if _to_host_async(t, home)}
        out = [t.to(home, non_blocking=True) for t in local]
        _land(wait)
        if self.distributed:
            out, received = self._all_gather(local, out, rows)
            got += received
        if stats is not None:
            stats["gathers"] = stats.get("gathers", 0) + 1
            stats["gather_s"] = stats.get("gather_s", 0.0) + (
                time.perf_counter() - t0)
            stats["gather_bytes"] = stats.get("gather_bytes", 0) + got
        return out

    def _all_gather(self, local: List[torch.Tensor],
                    mine: List[torch.Tensor], rows: Sequence[int]):
        """The process form of :meth:`gather_shards`: (the D tensors, this
        rank's ``mine`` among them, bytes received from other ranks)."""
        P, me = self.process_count, self.process_index
        per = self.size // P
        rows = [int(n) for n in rows]
        dtype = local[0].dtype
        blocks = distributed.all_gather_rows(
            _host_cat(local), [sum(rows[r * per:(r + 1) * per])
                               for r in range(P)], pin_memory=self._pin)
        out, got = [], 0
        for r, blk in enumerate(blocks):
            if r == me:
                out.extend(mine)
                continue
            got += blk.numel() * blk.element_size()
            out.extend(torch.split(_from_host(blk, dtype, self.device),
                                   rows[r * per:(r + 1) * per]))
        return out, got

    def _all_to_all(self, sources: list):
        """The process form of :meth:`exchange`: (for each local shard a
        list over (sending rank, its source) of column tuples on the
        shard's device, bytes sent to others or copied to another
        device)."""
        P, me = self.process_count, self.process_index
        per, M = self.size // P, len(self.devices)
        if len(sources) > M:
            raise ValueError(f"over processes a rank sends at most one "
                             f"source a device: {len(sources)} sources, "
                             f"{M} devices")
        sources = sources + [  # made up to M, as every rank sends M
            tuple(c[:0].to(self.device) for c in sources[0])
            for _ in range(M - len(sources))]
        ordered = [self._by_owner(s[0]) for s in sources]
        # [P, M, per]: the rows source s sends to each shard of rank q
        send = torch.tensor([[sizes[q * per:(q + 1) * per]
                              for _order, sizes in ordered]
                             for q in range(P)], dtype=torch.int64)
        recv = torch.empty_like(send)  # rank r's source s's rows a shard
        dist.all_to_all_single(recv.view(-1), send.view(-1))
        send_rows = send.sum((1, 2)).tolist()
        recv_rows = recv.sum((1, 2)).tolist()
        sent = 8 * M * per * (P - 1)
        # where each source's rows for rank q start, in its sorted order
        starts = [np.concatenate([[0], np.cumsum(sizes)])[::per]
                  for _order, sizes in ordered]
        bounds = np.concatenate([[0], np.cumsum(recv.reshape(-1).numpy())])
        blocks = device_blocks(self)
        out_cols = []
        for j in range(1, len(sources[0])):
            srcs = [s[j][o] for s, (o, _z) in zip(sources, ordered)]
            row = int(np.prod(srcs[0].shape[1:])) * srcs[0].element_size()
            sent += row * (sum(send_rows) - send_rows[me])
            for s, src in enumerate(srcs):  # rows to my shards elsewhere
                for dev, mine in blocks:
                    if src.device != dev:
                        sent += row * int(send[me, s, mine.start:mine.stop]
                                          .sum())
            # in (destination rank, source) order; one source is in it
            host = _to_host(srcs[0]) if M == 1 else _host_cat(
                [src[int(starts[s][q]):int(starts[s][q + 1])]
                 for q in range(P) for s, src in enumerate(srcs)])
            got = torch.empty((sum(recv_rows), *host.shape[1:]),
                              dtype=host.dtype, pin_memory=self._pin)
            dist.all_to_all_single(got, host, recv_rows, send_rows)
            # the column once on each of this rank's devices
            out_cols.append({dev: _from_host(got, srcs[0].dtype, dev)
                             for dev in dict.fromkeys(self.devices)})
        # received: rank r's source s's rows for my shard i at
        # (r*M + s)*per + i
        first = self.local_shards.start
        return [[tuple(col[self.device_of(first + i)][
            int(bounds[rs * per + i]):int(bounds[rs * per + i + 1])]
            for col in out_cols) for rs in range(P * M)]
            for i in range(per)], sent


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


def _host_cat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Tensors of one dtype, on any devices, concatenated in order as one
    host tensor gloo can send: each run of tensors on one device joined
    there and copied once."""
    runs: List[list] = []
    for t in tensors:
        if runs and runs[-1][0].device == t.device:
            runs[-1].append(t)
        else:
            runs.append([t])
    host = [_to_host(torch.cat(r)) for r in runs]
    return host[0] if len(host) == 1 else torch.cat(host)


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
    group's ranks (:func:`.distributed.init_distributed` first). With both,
    rank p's D/P shards are spread over its own ``devices`` in contiguous
    blocks (every rank names M devices, M dividing D/P), as the JAX mesh
    over several hosts spreads each host's shards over its chips."""
    return ShardGroup(1 if n_devices is None else n_devices, device,
                      processes=distributed, devices=devices)


def make_hierarchical_mesh(n_slices: int,
                           chips_per_slice: Optional[int] = None,
                           device=None,
                           distributed: bool = False,
                           devices=None) -> ShardGroup:
    """``n_slices`` x ``chips_per_slice`` (one if None) shards, routed flat;
    with ``devices``, ``distributed`` or both, spread over those devices,
    the default process group's ranks or each rank's devices as
    :func:`make_mesh` spreads them (the
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
