"""Median of the system's ``decode_tick`` spans (fenced on the caches)."""


def read(ctx):
    v = [sp.duration_s for sp in ctx.spans.get("decode_tick", [])]
    m = ctx.median(v)
    return None if m is None else m * 1e3
