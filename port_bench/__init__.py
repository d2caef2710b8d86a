"""The benchmark of ``kmer_hasher_tpu_torch`` on NVIDIA cards (see
``README.md``). Nothing here imports JAX or the JAX package."""
