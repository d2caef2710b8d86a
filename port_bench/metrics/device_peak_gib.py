"""``torch.cuda.max_memory_allocated()`` over the window, in GiB, after
``reset_peak_memory_stats()`` at the end of set-up: what set-up keeps
allocated (the query cell's index) counts. Not measured off a card."""


def read(ctx):
    peak = ctx.get("peak_bytes")
    return peak / 2 ** 30 if peak else None
