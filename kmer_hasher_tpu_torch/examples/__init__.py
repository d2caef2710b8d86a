"""User scripts of the port, twins of the JAX package's ``examples/``, run
as modules (nothing runs at import):

    python -m kmer_hasher_tpu_torch.examples.large_pairs [--device cpu]
    python -m kmer_hasher_tpu_torch.examples.counting_stress [--device cpu]
    python -m kmer_hasher_tpu_torch.examples.demo --data DIR [--device cpu]

:mod:`.large_pairs` indexes a ~40 Mbp chromosome with a tandem repeat at
k=32 and streams its dot-plot pair table in chunks; :mod:`.counting_stress`
writes seeded FASTQ reads and counts them through the flagship file entry;
:mod:`.demo` tours every capability on a directory holding ``test.fa``,
``test.fastq.gz`` and ``repeat_40.fq``.
"""
