"""kmer_hasher_tpu_torch — the PyTorch/CUDA port of kmer_hasher_tpu.

The same k-mer position index (k <= 32, 2-bit packed), tables, streamed
dot-plot pairs and cross-sequence queries, and the quality-likelihood
filtered, canonical, multi-source FASTQ counting path with its count
store, spectra and depth track, in PyTorch on an NVIDIA Hopper GPU or on
the CPU. The JAX package ``kmer_hasher_tpu`` stays the reference
the port is held against; this package imports neither it nor JAX.

Public API lives in :mod:`kmer_hasher_tpu_torch.api`. Every entry takes a
``device`` and runs on the card (``"cuda"``) unless the caller asks for
the CPU; a CUDA device runs the hand-written kernels under ``csrc/`` and
never falls back to the CPU.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
