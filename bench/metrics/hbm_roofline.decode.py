"""The decode steps' share of the H100's memory roofline in the profiled
stretch: the least time their bytes could take over the device time of
everything launched inside the harness's ``bench.decode_step`` range
(kernels, copies and sets; a replayed CUDA graph's, attributed through
its launch, included). The bytes are a floor counted from shapes by the
model module: each step reads every layer's weights once
(``sz["layers"][i]["step_bytes"]``) and the head (``sz["head_bytes"]``),
and each of its rows, idle lanes included, reads and writes its
recurrent state once (``lane_bytes``), over 3.35 TB/s. Nothing is read
where a layer lacks those counts."""

DECODE_RANGE = "bench.decode_step"


def read(ctx):
    if ctx.trace is None or ctx.work is None or "head_bytes" not in ctx.sz:
        return None
    layers = ctx.sz["layers"]
    if not all("step_bytes" in la and "lane_bytes" in la for la in layers):
        return None
    seconds, launches = ctx.trace.kernel_seconds(lambda name: True, within=DECODE_RANGE)
    steps, rows = ctx.work
    if launches == 0 or seconds <= 0 or steps == 0:
        return None
    nbytes = (steps * (sum(la["step_bytes"] for la in layers) + ctx.sz["head_bytes"])
              + rows * sum(la["lane_bytes"] for la in layers))
    return 100.0 * nbytes / ctx.counts.PEAK_HBM_BYTES / seconds
