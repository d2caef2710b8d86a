"""kmer_hasher_tpu_torch — the PyTorch/CUDA port of kmer_hasher_tpu.

The same k-mer position index (k <= 32, 2-bit packed), tables, streamed
dot-plot pairs and cross-sequence queries, in PyTorch on the CPU or on an
NVIDIA Hopper GPU. The JAX package ``kmer_hasher_tpu`` stays the reference
the port is held against; this package imports neither it nor JAX.

Public API lives in :mod:`kmer_hasher_tpu_torch.api`. Every entry takes an
explicit ``device``; a CUDA device runs the hand-written kernels under
``csrc/`` and never falls back to the CPU.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
