"""Seconds from the start of the process to the first timed job: CUDA
start-up, loading or building the port's kernels and C++ parser, the
inputs made from the seed, and the traffic's warm jobs (host clock)."""


def read(ctx):
    return ctx["setup_s"]
