"""Per cent of the traced window in which the card was idle and no
program span (``kmh.*``) was open: the harness's own code between and
around the calls into the program, such as the copies of a job's outputs
to the host (``port_bench/spans.py``)."""

from port_bench.spans import OUTSIDE, window_share


def read(ctx):
    return window_share(ctx, "idle_s", lambda n: n == OUTSIDE)
