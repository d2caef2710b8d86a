"""Design probes of the port: small programs that ask the card one question
each and print one line per answer (PyTorch ports of the JAX package's
``tools/chip_probes``).

:mod:`.cuda_probes` holds the hand-written kernels' wrappers (P1 copy, P2
copy from device-known offsets, P3/P4 rotation by a device-known shift),
:mod:`.sort_probes` the entry point that runs them beside the plain row and
flat sorts: ``python -m kmer_hasher_tpu_torch.probes.sort_probes``.
"""
