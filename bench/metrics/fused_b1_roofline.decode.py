"""The fused BitLinear kernel's share of its roofline in the decode
steps of the profiled stretch: the least time their launches could take
(their bytes, counted once from shapes by ``bench/counts.py``, over the
H100's 3.35 TB/s; no operation term, since NVIDIA publishes no b1 rate)
over the time the trace gives them. A prefill's launches are left out:
only those made inside the harness's ``bench.decode_step`` range count.
Nothing is read when those launches do not match the steps counted."""

DECODE_RANGE = "bench.decode_step"


def _fused(name: str) -> bool:
    return "BitLinearOut" in name or "fused_bnn_kernel" in name


def read(ctx):
    if ctx.trace is None or ctx.work is None:
        return None
    seconds, launches = ctx.trace.kernel_seconds(_fused, within=DECODE_RANGE)
    want, nbytes = ctx.counts.fused_window(ctx.sz, *ctx.work)
    if launches == 0 or launches != want:
        return None
    return 100.0 * nbytes / ctx.counts.PEAK_HBM_BYTES / seconds
