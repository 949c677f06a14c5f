"""Model FLOPs of the window's served tokens (``bench/counts.py``) over
the window's seconds, as a share of the H100's dense bf16 peak."""


def read(ctx):
    w = ctx.window
    if not w["flops"]:
        return None
    return 100.0 * w["flops"] / w["seconds"] / ctx.counts.PEAK_BF16_FLOPS
