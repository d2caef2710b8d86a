"""Per cent of the traced index jobs' host seconds inside
``kmh.index.build`` (inclusive): ``make_kmer_hash`` from the upload through
B1, the sort and the group statistics, which the job's synchronise ends.
The inside complement of ``table_copy_share`` (``port_bench/spans.py``)."""

from port_bench.spans import jobs_share


def read(ctx):
    return jobs_share(ctx, "host_s", "kmh.index.build")
