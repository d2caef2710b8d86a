"""Query bases answered in the window over the window's seconds (host
clock): one client in a closed loop, each query's hits copied to the host
before the next is sent."""


def read(ctx):
    if ctx["traffic"]["kind"] != "query":
        return None
    bases = sum(j["bases"] for j in ctx["jobs"])
    return bases / ctx["window_s"] if bases else None
