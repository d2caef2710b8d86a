"""The port's pure-Python FASTA/FASTQ reader against the JAX package's, on
the same files: records, batches and padded batches are equal."""
import gzip

import numpy as np
import pytest

from kmer_hasher_tpu.io import fastx as jfx
from kmer_hasher_tpu_torch.io import fastx as tfx

FASTA = (">s1 first sequence\nACGTNNACGT\nacgtacgt\n\n>s2\nGGGG\n>\nTT\n"
         ">s4 empty\n")
FASTQ4 = ("@r1 desc\nACGTACGTAA\n+\nFFFF:,#FFF\n@r2\nNNACG\n+r2\nFFFFF\n"
          "@r3\nACGT\n+\nFF\n@r4\n\n+\n\n")
FASTQ_MULTI = ("@m1\nACGTAC\nGTAA\n+\nFFFF:\n,#FFF\n@m2\nAC\nGT\n+\nFFFF\n"
               "@m3\nACGTT\n")
CRLF = "@c1\r\nACGT\r\n+\r\nFFFF\r\n"


def write(tmp_path, name, text, gz=False):
    p = tmp_path / name
    if gz:
        with gzip.open(p, "wb") as f:
            f.write(text.encode())
    else:
        p.write_bytes(text.encode())
    return str(p)


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("name,text", [
    ("a.fa", FASTA), ("b.fq", FASTQ4), ("c.fq", FASTQ_MULTI),
    ("d.fq", CRLF), ("e.fq", "")])
def test_records_equal_jax_reader(tmp_path, name, text, gz):
    """The JAX package's pure-Python records, but for one: FASTQ4 ends in an
    empty read, whose empty quality line that reader takes for a header and
    makes a record of (C4); the port reads it as the read's quality, as kseq
    and both packages' native readers do."""
    p = write(tmp_path, name + (".gz" if gz else ""), text, gz)
    want = jfx.read_fastx_py(p)
    if text == FASTQ4:
        assert want[-1] == ("", b"", None)
        want = want[:-1]
    assert tfx.read_fastx(p) == want
    assert tfx.read_fastx(p, max_records=2) == jfx.read_fastx_py(p, 2)
    assert (list(tfx.iter_fastx(p, batch_size=2))
            == [want[i: i + 2] for i in range(0, len(want), 2)])
    assert (list(tfx.iter_fastx(p, batch_size=2, max_records=3))
            == list(jfx.iter_fastx(p, batch_size=2, max_records=3)))


def test_missing_and_short_qualities_become_none(tmp_path):
    recs = tfx.read_fastx(write(tmp_path, "b.fq", FASTQ4))
    assert [r[0] for r in recs[:3]] == ["r1", "r2", "r3"]
    # r3's short quality line swallows the next header, as in kseq
    assert recs[0][2] == b"FFFF:,#FFF" and recs[2][2] is None
    recs = tfx.read_fastx(write(tmp_path, "c.fq", FASTQ_MULTI))
    assert recs[0][1] == b"ACGTACGTAA" and recs[0][2] == b"FFFF:,#FFF"
    assert recs[2] == ("m3", b"ACGTT", None)  # truncated tail


def test_unknown_leader_byte_raises(tmp_path):
    with pytest.raises(ValueError):
        tfx.read_fastx(write(tmp_path, "x.txt", "hello\n"))


@pytest.mark.parametrize("multiple", [1, 8])
def test_pad_records_equal(tmp_path, multiple):
    recs = tfx.read_fastx(write(tmp_path, "b.fq", FASTQ4 + FASTQ_MULTI))
    t = tfx.pad_records(recs, pad_to_multiple=multiple)
    j = jfx.pad_records(recs, pad_to_multiple=multiple)
    for f in ("seq", "qual", "lengths", "has_qual"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), f)
        assert getattr(t, f).dtype == getattr(j, f).dtype
    assert t.n_reads == j.n_reads == len(recs)
