"""Median over the window's waves of the host clock around a wave's
prefill, from a synchronize to a synchronize."""


def read(ctx):
    m = ctx.median(ctx.window.get("prefill_s", []))
    return None if m is None else m * 1e3
