"""coder.k2_roofline: K2 (`decode_kernel`, csrc/sections.cu) as a share of
its roofline: the least time the traced batches' sections need (bytes
and operations the format fixes, spbench/work/roofline.py) over K2's
summed device time in the traced `Decoder.decode_batch` calls, in %."""

from spbench.work.roofline import least_seconds, sections_work


def read(drv, trace, ctx):
    if trace is None or not ctx.cuda:
        return None
    t = trace.device_seconds("Decoder.decode_batch", "decode_kernel")
    if t <= 0:
        return None
    return 100 * least_seconds(*sections_work(drv.traced_payloads())) / t
