"""Design probes of the port: small programs that ask the card one question
each and print one line per answer (PyTorch ports of the JAX package's
``tools/chip_probes``).

:mod:`.cuda_probes` holds the wrappers of the first round's hand-written
kernels (P1 copy, P2 copy from device-known offsets, P3/P4 rotation by a
device-known shift), :mod:`.sort_probes` the entry point that runs them
beside the plain row and flat sorts: ``python -m
kmer_hasher_tpu_torch.probes.sort_probes``. :mod:`.cuda_probes_r3` holds the
third round's (P5 row windows copied in step order, P6 a gather of 2 KB
records, P7 P2's copies through ``cp.async``, P8 a gather from a table in
shared memory), :mod:`.sort_probes_r3` their entry point: ``python -m
kmer_hasher_tpu_torch.probes.sort_probes_r3``. :mod:`.cuda_probes_dma` holds
the DMA round's (P9 row windows in step order through a ring of bulk
copies, P10 a per-lane lookup table), :mod:`.dma_probes_r3` their entry
point: ``python -m kmer_hasher_tpu_torch.probes.dma_probes_r3``.

:mod:`.turns` times P1, P10 and P6 against their library calls in turns,
by device time and host time as well as by CUDA events (``python -m
kmer_hasher_tpu_torch.probes.turns``).
"""
