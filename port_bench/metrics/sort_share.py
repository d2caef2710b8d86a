"""Per cent of the traced index jobs' host seconds that the device spent in
sort kernels (names matching ``PATTERNS``: cub's radix sorts and PyTorch's
sorts, as ``torch.sort`` runs them for the build)."""

PATTERNS = [r"(?i)sort"]


def read(ctx):
    tr = ctx.get("trace")
    wall = sum(j["wall_s"] for j in ctx.get("trace_jobs") or [])
    if tr is None or wall <= 0 or not tr.device:
        return None
    return 100.0 * tr.device_s(PATTERNS) / wall
