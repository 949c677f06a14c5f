"""Generated tokens that reached the host in the window, over the
window's seconds (prefills inside the window count as time)."""


def read(ctx):
    w = ctx.window
    return w["tokens"] / w["seconds"] if w["tokens"] else None
