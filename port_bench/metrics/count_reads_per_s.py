"""Reads of all counting jobs completed in the window over the window's
seconds (host clock). A job counts the cell's whole read set into a fresh
store and copies the table and spectrum to the host."""


def read(ctx):
    reads = sum(j.get("reads", 0) for j in ctx["jobs"])
    return reads / ctx["window_s"] if reads else None
