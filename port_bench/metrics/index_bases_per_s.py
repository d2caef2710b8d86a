"""Bases of all index jobs completed in the window over the window's
seconds (host clock). A job indexes the whole sequence and copies its
tables and pair stream to the host."""


def read(ctx):
    if ctx["traffic"]["kind"] != "index":
        return None
    bases = sum(j["bases"] for j in ctx["jobs"])
    return bases / ctx["window_s"] if bases else None
