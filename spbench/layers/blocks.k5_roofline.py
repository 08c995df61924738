"""blocks.k5_roofline: K5 (`analyze_blocks_kernel`, csrc/motion_search.cu)
as a share of its roofline: the least time the P analysis of the traced
batches' P frames needs (both frames' pixels and the outputs,
spbench/work/roofline.py) over K5's summed device time in the traced
`Encoder.encode_batch` calls, in %."""

from spbench.work.roofline import analysis_work, is_p, least_seconds


def read(drv, trace, ctx):
    if trace is None or not ctx.cuda:
        return None
    t = trace.device_seconds("Encoder.encode_batch", "analyze_blocks_kernel")
    n = sum(is_p(p) for p in drv.traced_payloads())
    if t <= 0 or not n:
        return None
    return 100 * least_seconds(*analysis_work(n, drv.h, drv.w)) / t
