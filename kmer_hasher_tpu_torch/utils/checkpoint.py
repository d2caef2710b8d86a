"""Position-index persistence (PyTorch port of the index part of
``kmer_hasher_tpu/utils/checkpoint.py``).

The file format is the JAX package's, byte for byte in meaning: one
``.npz`` with a JSON meta blob (magic, version, kind, k, seq_len, n_valid)
and ``s_hi`` / ``s_lo`` (uint32) and ``s_pos`` (int32) trimmed to the
live prefix. An index saved by either package loads in the other.

Count-store checkpoints come with the counting path.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..index.position_index import KmerIndex, resolve_device
from ..ops import encode as enc

_MAGIC = "kmer_hasher_tpu"
_VERSION = 1


def save_index(index: KmerIndex, path) -> None:
    n = index.n_valid
    meta = {
        "magic": _MAGIC, "version": _VERSION, "kind": "kmer_index",
        "k": index.k, "seq_len": index.seq_len, "n_valid": n,
    }
    raw = enc.sortable_key(index.s_key[:n]).cpu().numpy()
    np.savez_compressed(
        path, meta=json.dumps(meta),
        s_hi=(raw.view(np.uint64) >> np.uint64(32)).astype(np.uint32),
        s_lo=raw.view(np.uint64).astype(np.uint32),
        s_pos=index.s_pos[:n].cpu().numpy().astype(np.int32),
    )


def index_from_numpy(k: int, seq_len: int, s_hi, s_lo, s_pos, n_valid: int,
                     device="cpu") -> KmerIndex:
    """An index on ``device`` from the JAX package's sorted arrays: uint32
    ``s_hi`` / ``s_lo`` and int32 ``s_pos``, full-axis or trimmed, of which
    the first ``n_valid`` rows are live."""
    dev = resolve_device(device)
    raw = ((np.asarray(s_hi).astype(np.uint64) << np.uint64(32))
           | np.asarray(s_lo).astype(np.uint64)).view(np.int64)
    s_key = enc.sortable_key(torch.from_numpy(raw).to(dev))
    pos = torch.from_numpy(np.asarray(s_pos).astype(np.int32)).to(dev)
    return KmerIndex.from_sorted(k, seq_len, s_key, pos, int(n_valid))


def load_index(path, device="cpu") -> KmerIndex:
    """Restore a position index without re-encoding the sequence. The
    arrays are padded to the JAX loader's power-of-two axis."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("magic") != _MAGIC or meta.get("kind") != "kmer_index":
            raise ValueError(f"{path} is not a kmer_hasher_tpu index")
        n = int(meta["n_valid"])
        cap = 1 << max(6, (n - 1).bit_length()) if n > 1 else 64
        s_hi = np.zeros(cap, np.uint32)
        s_lo = np.zeros(cap, np.uint32)
        s_pos = np.zeros(cap, np.int32)
        s_hi[:n] = z["s_hi"]
        s_lo[:n] = z["s_lo"]
        s_pos[:n] = z["s_pos"]
    return index_from_numpy(int(meta["k"]), int(meta["seq_len"]), s_hi,
                            s_lo, s_pos, n, device=device)
