"""Several processes (PyTorch port of
``kmer_hasher_tpu/parallel/distributed.py``).

The JAX package wires its hosts into one runtime with
``jax.distributed.initialize``; the port wires its processes into one
``torch.distributed`` process group. Every process runs the same program,
parses only its own part of the input and owns D/P of the D hash shards of a
shard group made with ``make_mesh(D, distributed=True)``; runs reach their
owners by an all-to-all (:meth:`..parallel.mesh.ShardGroup.exchange`).

The backend is gloo by default: it is the one backend that can put several
ranks on one card (NCCL refuses two ranks on one device). Every collective
here runs on host tensors, and the exchange stages device rows through
pinned host memory, so nothing relies on a backend's support for CUDA
tensors. NCCL has never been run with this package.

With no process group (or a group of one) every helper is the identity of
one process: rank 0 of 1, the gather and the sum return their input.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: str = "gloo") -> dict:
    """Join the default process group (a no-op for one process, or where
    the group exists already). ``init_method`` is the rendezvous
    (``tcp://host:port`` or ``file:///path``), ``world_size`` the number of
    processes and ``rank`` this one's index; with only ``init_method`` the
    size and rank come from the environment (``env://``). A failed
    rendezvous raises. Returns a summary for logging, the JAX function's:
    ``process_index``, ``process_count``, ``local_devices`` (the cards this
    process sees, or 1, the host, where it sees none) and
    ``global_devices`` (their sum over the processes: ranks that share one
    card count it once each). A shard group over the processes that also
    spreads each rank's shards over several devices
    (``make_mesh(D, distributed=True, devices=[...])``) takes each rank's
    ``devices`` as that rank's own: its local devices, which other ranks
    may name too where they share a card."""
    if not dist.is_initialized():
        if world_size is not None and int(world_size) > 1:
            dist.init_process_group(backend, init_method=init_method,
                                    world_size=int(world_size),
                                    rank=int(rank))
        elif init_method is not None:
            dist.init_process_group(backend, init_method=init_method)
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {
        "process_index": process_index(),
        "process_count": process_count(),
        "local_devices": local,
        "global_devices": int(all_sum([local])[0]),
    }


def process_index() -> int:
    """This process's rank in the default group; 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The default group's size; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def host_read_slice(n_records: int) -> slice:
    """The record range this process should read: a contiguous split of
    ``n_records`` over the processes, the JAX function's formula."""
    p = process_index()
    n = process_count()
    per = -(-n_records // n)
    return slice(p * per, min((p + 1) * per, n_records))


def allgather(values: Sequence[int]) -> np.ndarray:
    """Every process's int64 vector (of one length on all), [P, n] in
    rank order."""
    t = torch.as_tensor(np.asarray(values, np.int64).reshape(-1))
    if process_count() == 1:
        return t.numpy()[None].copy()
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def all_sum(values: Sequence[int]) -> np.ndarray:
    """The int64 vector summed over the processes."""
    t = torch.as_tensor(np.asarray(values, np.int64).reshape(-1)).clone()
    if process_count() > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.numpy()


def barrier() -> None:
    """Wait until every process has come here."""
    if process_count() > 1:
        dist.barrier()


def all_gather_rows(t: torch.Tensor, rows: Sequence[int],
                    pin_memory: bool = False) -> List[torch.Tensor]:
    """Every process receives every process's host tensor ``t`` (``rows[r]``
    rows on rank r, the rest of its shape and its dtype the same
    everywhere, a dtype gloo can send: bool viewed as bytes first) as a
    list in rank order: the JAX package's ``_host_read`` of a sharded
    array. One broadcast of exact length from each rank that holds rows,
    so no rank pads its rows to another's length. ``pin_memory`` receives
    into pinned memory (for a copy on to a card). In one process,
    ``[t]``."""
    if process_count() == 1:
        return [t]
    t = t.contiguous()
    me = process_index()
    out = []
    for r in range(process_count()):
        buf = t if r == me else torch.empty(
            (int(rows[r]), *t.shape[1:]), dtype=t.dtype,
            pin_memory=pin_memory)
        if rows[r]:
            dist.broadcast(buf, src=r)
        out.append(buf)
    return out


def gather_rows(t: torch.Tensor, rows: Sequence[int]
                ) -> Optional[List[torch.Tensor]]:
    """Rank 0 receives every process's host tensor ``t`` (``rows[r]`` rows
    on rank r, the rest of its shape and its dtype the same everywhere) as
    a list in rank order; the other ranks get None. Point-to-point sends,
    so no rank pads its rows to another's length."""
    t = t.contiguous()
    p = process_index()
    if p != 0:
        if rows[p]:
            dist.send(t, dst=0)
        return None
    out = [t]
    for r in range(1, process_count()):
        buf = torch.empty((int(rows[r]), *t.shape[1:]), dtype=t.dtype)
        if rows[r]:
            dist.recv(buf, src=r)
        out.append(buf)
    return out
